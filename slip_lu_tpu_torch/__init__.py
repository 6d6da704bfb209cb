"""slip_lu_tpu_torch — the exact sparse solver on PyTorch and CUDA.

The port of ``slip_lu_tpu`` (JAX on a TPU) to one NVIDIA H100: exact
solution of sparse Ax = b by roundoff-error-free (REF/IPGE) LU. The host
layers (orderings, symbolic schedule, chunk streams, the Python-int
oracle) are copies of the JAX package's numpy code, so that importing
this package never imports jax; the kernels of the fused exact solve
(``backend="cuda-fused"``) and of the dense one (``backend="cuda"``) are
CUDA C++ for sm_90a (``csrc/``), each beside a plain PyTorch version that
runs on the CPU.

Public API: read_triplet, read_dense, matrix_copy, analyze, backslash,
factor_cuda and factorize_solve_cuda (the dense device path),
check_solution, Kind, Type, Options, Ordering, Pivot, the errors,
last_stats.
"""

from .analyze import Analysis, analyze
from .backslash import backslash
from .convert import matrix_copy
from .errors import (SlipError, SlipIncorrectError, SlipIncorrectInputError,
                     SlipInfo, SlipLimbOverflowError, SlipPanicError,
                     SlipSingularError)
from .gpu.backslash_cuda import factor_cuda, factorize_solve_cuda
from .io import read_dense, read_triplet
from .matrix import Kind, SlipMatrix, Type
from .options import Options, Ordering, Pivot
from .solve import check_solution
from .stats import last_stats

__version__ = "0.1.0"

__all__ = [
    "Analysis", "analyze", "backslash", "factor_cuda",
    "factorize_solve_cuda", "matrix_copy", "SlipError",
    "SlipIncorrectError", "SlipIncorrectInputError", "SlipInfo",
    "SlipLimbOverflowError", "SlipPanicError", "SlipSingularError",
    "read_dense", "read_triplet", "Kind", "SlipMatrix", "Type", "Options",
    "Ordering", "Pivot", "check_solution", "last_stats",
]
