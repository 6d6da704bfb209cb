"""CUDA execution path: the fused exact solve (factor_fused.py, kernels
in ../csrc), its host glue (backslash_fused.py), and the planner
layers copied from the JAX package's tpu/ (bounds, schedule*)."""
