"""Between-segment glue for the adaptive-width factor stream.

Counterpart of ``slip_lu_tpu/tpu/relift.py``. The factor stream runs as
width segments (``backslash_fused.plan_segments``): IPGE values at
elimination level L need only ~L/n of the final limb width, so early
chunks run at narrower widths. At a segment boundary the tables move to
the next width:

  * value table and SMT (two's-complement rows): sign extension,
    ``widen_tc`` / ``widen_val`` (plain tensor code);
  * GT (Hensel inverses of the pivots' odd parts mod 2**(16*WI)): a
    residue mod a smaller modulus does not sign-extend; it is re-lifted
    by Newton doubling x <- x*(2 - d*x), ceil(log2(WIn/WIo)) steps, in
    kernel K4 (``csrc/relift.cu:relift_gt_kernel``). ``relift_gt_ref``
    beside it is the plain version.

The wrapper takes the plain version for CPU tensors only; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..ops import device_limbs as dl
from . import _build

_I32 = torch.int32


def widen_tc(x: torch.Tensor, W_old: int, W_new: int) -> torch.Tensor:
    """Sign-extend [R, >=W_old] two's-complement limb rows to [R, W_new]
    (columns past W_old are ignored)."""
    if W_new == W_old and x.shape[1] == W_old:
        return x
    fill = torch.where(x[:, W_old - 1:W_old] >= 0x8000, 0xFFFF, 0).to(_I32)
    return torch.cat([x[:, :W_old], fill.expand(-1, W_new - W_old)], dim=1)


def widen_val(val: torch.Tensor, W_old: int, W_new: int) -> torch.Tensor:
    """The value table [E8, W_old] at the next segment's width. The port
    keeps one layout (rows of W limbs), so this is ``widen_tc``."""
    return widen_tc(val, W_old, W_new)


def newton_steps(WIo: int, WIn: int) -> int:
    """Doublings from WIo to at least WIn limbs (the reference's count)."""
    steps, w = 0, WIo
    while w < WIn:
        w *= 2
        steps += 1
    return steps


def _check_args(SMT, GT_old, TZ, W8, WIo):
    n8 = SMT.shape[0]
    for name, t in (("SMT", SMT), ("GT_old", GT_old), ("TZ", TZ)):
        if (t.device != SMT.device or t.dtype != _I32
                or not t.is_contiguous() or t.shape[0] != n8):
            raise ValueError(f"relift_gt: {name} must be a contiguous int32 "
                             f"tensor of {n8} rows on {SMT.device}")
    if SMT.shape[1] < W8 or GT_old.shape[1] != WIo or TZ.shape[1] != 8:
        raise ValueError(
            f"relift_gt: SMT {tuple(SMT.shape)}, GT_old "
            f"{tuple(GT_old.shape)}, TZ {tuple(TZ.shape)} do not fit "
            f"W8={W8}, WIo={WIo}")


def relift_gt_ref(SMT: torch.Tensor, GT_old: torch.Tensor, TZ: torch.Tensor,
                  W8: int, WIo: int, WIn: int) -> torch.Tensor:
    """Plain version of ``relift_gt`` (any device), the reference's
    ``_relift_kernel`` with every row on the batch axis."""
    if WIn <= WIo:
        return GT_old[:, :WIn].contiguous()
    rho = SMT[:, :W8].T.long()                              # [W8, R]
    tz = TZ[:, :1].T.long()                                 # [1, R]
    d = dl.shr_bits(dl.sign_extend(rho, WIn), tz)           # odd part
    # residues mod the smaller modulus zero-extend: they are the low limbs
    # of the wider inverse's Newton seed, not signed values
    xo = GT_old[:, :WIo].T.long()
    x = torch.cat([xo, torch.zeros_like(xo[:1]).expand(WIn - WIo, -1)])
    for _ in range(newton_steps(WIo, WIn)):
        u = dl.two_minus_mod(dl.mul_mod(x, d, WIn))
        x = dl.mul_mod(x, u, WIn)
    return x.T.to(_I32).contiguous()


def relift_gt(SMT: torch.Tensor, GT_old: torch.Tensor, TZ: torch.Tensor,
              W8: int, WIo: int, WIn: int) -> torch.Tensor:
    """[n8, WIo] inverse table -> [n8, WIn], exact mod 2**(16*WIn) (K4).

    SMT must already be at the new segment's width (>= W8 columns). Rows
    whose seed is no inverse (zero rows, rows written after an overflow)
    go through the same Newton steps, bit for bit as the reference.
    WIn <= WIo truncates and launches nothing."""
    if WIn <= WIo:
        return GT_old[:, :WIn].contiguous()
    if SMT.device.type == "cpu":
        return relift_gt_ref(SMT, GT_old, TZ, W8, WIo, WIn)
    if SMT.device.type != "cuda":
        raise ValueError(f"relift_gt: tensors must lie on the CPU (plain "
                         f"version) or on a CUDA device, not {SMT.device}")
    _check_args(SMT, GT_old, TZ, W8, WIo)
    lib = _build.library().lib
    out = torch.empty((SMT.shape[0], WIn), dtype=_I32, device=SMT.device)
    stream = torch.cuda.current_stream(SMT.device).cuda_stream
    rc = lib.slip_relift_gt(SMT.data_ptr(), GT_old.data_ptr(), TZ.data_ptr(),
                            out.data_ptr(), SMT.shape[0], SMT.shape[1], W8,
                            WIo, WIn, newton_steps(WIo, WIn), stream)
    _build.check(rc, "relift_gt")
    relift_gt.launches += 1
    return out


relift_gt.launches = 0
