"""The ranks of the sharded path: a ``torch.distributed`` process group.

Counterpart of ``slip_lu_tpu/parallel/shard.py`` for the fused sharded
solve. The reference's 1-D device mesh (axis ``"rows"``) becomes a process
group, one process a rank: NCCL on CUDA cards (a rank's device is
``cuda:<local rank>``), gloo on the CPU. The caller initialises the group
(``torch.distributed.init_process_group``); ``group=None`` means the
default group. There is no single-rank mode without a group: every helper
raises when none is initialised.

Row ownership is cyclic over the ranks, as over the mesh's devices, and
every collective is an int32 sum, so results are bit-identical at every
world size.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def _require_group() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "the sharded path needs an initialised torch.distributed process "
            "group: call torch.distributed.init_process_group (NCCL on CUDA "
            "cards, gloo on the CPU) in every rank's process first")


def world_size(group=None) -> int:
    """The number of ranks of ``group`` (None: the default group)."""
    _require_group()
    return dist.get_world_size(group)


def rank(group=None) -> int:
    """This process's rank in ``group``."""
    _require_group()
    return dist.get_rank(group)


def rank_device(device, group=None) -> torch.device:
    """This rank's device: ``device`` as given when it names an index or
    the CPU, else ``cuda:<local rank>`` (``LOCAL_RANK`` as launchers set
    it, or the global rank modulo the visible cards)."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    idx = int(local) if local is not None else \
        dist.get_rank() % torch.cuda.device_count()
    return torch.device("cuda", idx)


def psum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks in place (an int32 all-reduce) and return
    it: the reference's ``lax.psum`` over the mesh axes."""
    _require_group()
    if t.dtype != torch.int32:
        raise ValueError(f"psum: the sharded path sums int32, not {t.dtype}")
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    psum.calls += 1
    return t


psum.calls = 0
