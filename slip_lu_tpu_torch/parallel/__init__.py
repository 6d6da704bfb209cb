"""The sharded fused exact solve over ``torch.distributed`` ranks.

Counterpart of the fused part of ``slip_lu_tpu/parallel``: the chunk
streams partitioned over the ranks by row owner (``stream_shard_fused``),
kernels K6 and K7 and the chunk loop with its int32 all-reduces
(``factor_fused_shard``), and the host driver (``driver_fused``). One
process a rank; the caller initialises the process group (NCCL on cards,
gloo on the CPU) and every rank calls
``factorize_solve_cuda_fused_sharded`` with the same arguments.
"""

from .driver_fused import factorize_solve_cuda_fused_sharded, plan_sharded
from .factor_fused_shard import fused_sharded_solve

__all__ = ["factorize_solve_cuda_fused_sharded", "plan_sharded",
           "fused_sharded_solve"]
