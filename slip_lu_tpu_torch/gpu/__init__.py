"""CUDA execution paths: the fused exact solve (factor_fused.py, kernels
in ../csrc) and its host glue (backslash_fused.py); the dense exact solve
(factor.py, solve.py, fused.py) and its host glue (backslash_cuda.py);
and the planner layers copied from the JAX package's tpu/ (bounds,
schedule*)."""
