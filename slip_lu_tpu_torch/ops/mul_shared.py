"""Kernel K5: a batch of magnitudes times one shared magnitude.

Replaces ``slip_lu_tpu/ops/pallas_kernels.py:_mul_shared_kernel``
(launched by ``mul_shared_digits_pallas``): for B magnitudes of La limbs
and one shared magnitude of Ls limbs, (|a[b]| * |shared|) mod 2**(16*D)
with every carry resolved, as D clean 16-bit limbs. That is the TPU
kernel's output after its digit fold (``pallas_kernels.py:144``), bit for
bit. ``ops/matarith.py`` sends every shared multiply with one shared value
here: rho x M, the exact division by a Hensel inverse, the Hensel
doubling steps and the TOL pivot tests.

The TPU kernel splits limbs into 8-bit digits and multiplies by the
shared operand's Toeplitz matrix in f32 on the matrix unit, which caps La
at 257 digits. Neither exists here: the kernel (``csrc/mul_shared.cu``)
sums 16-bit limb products in int64 columns, exact at any width this path
reaches. ``mul_shared_limbs_ref`` beside it is the plain version: the same
column sums as shifted multiply-adds (no integer convolution or einsum,
which PyTorch does not implement on CUDA), so it runs on any device.

The wrapper takes the plain version for CPU tensors only; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..gpu import _build
from . import device_limbs as dl

_I32 = torch.int32
_I64 = torch.int64
_LIMB_MAX = 0xFFFF


def mul_shared_limbs_ref(a: torch.Tensor, shared: torch.Tensor, D: int
                         ) -> torch.Tensor:
    """Plain version of ``mul_shared_limbs`` (any device).

    a [..., La] and shared [..., Ls] (batch dims broadcast; a 1-D shared
    is one value for every row) of clean limbs -> [..., D] int32 limbs of
    (|a| * |shared|) mod 2**(16*D)."""
    a64, s64 = a.to(_I64), shared.to(_I64)
    La, Ls = a.shape[-1], shared.shape[-1]
    batch = torch.broadcast_shapes(a.shape[:-1], shared.shape[:-1])
    acc = torch.zeros(batch + (D,), dtype=_I64, device=a.device)
    for j in range(min(Ls, D)):
        n = min(La, D - j)
        acc[..., j:j + n] += a64[..., :n] * s64[..., j:j + 1]
    flat = acc.reshape(-1, D).T                       # limb-major [D, B]
    out = dl.carry_normalize(flat, min(La, Ls) * _LIMB_MAX * _LIMB_MAX)
    return out.T.to(_I32).reshape(batch + (D,))


def _check_args(a: torch.Tensor, shared: torch.Tensor, D: int) -> None:
    if a.dtype != _I32 or a.ndim != 2 or not a.is_contiguous():
        raise ValueError(f"mul_shared: a must be a contiguous [B, La] int32 "
                         f"tensor, not {a.dtype} {tuple(a.shape)}")
    if (shared.dtype != _I32 or shared.ndim != 1
            or not shared.is_contiguous() or shared.device != a.device):
        raise ValueError(f"mul_shared: shared must be a contiguous 1-D int32 "
                         f"tensor on {a.device}, not {shared.dtype} "
                         f"{tuple(shared.shape)} on {shared.device}")
    if D < 1 or a.shape[1] < 1 or shared.shape[0] < 1:
        raise ValueError(f"mul_shared: empty operand or D={D}")


def mul_shared_limbs(a: torch.Tensor, shared: torch.Tensor, D: int
                     ) -> torch.Tensor:
    """[B, La] limbs times one shared [Ls] -> [B, D] limbs mod 2**(16*D)
    (K5). Limbs must be clean (0..65535), as every caller's are."""
    if a.device.type == "cpu":
        return mul_shared_limbs_ref(a, shared, D)
    if a.device.type != "cuda":
        raise ValueError(f"mul_shared: tensors must lie on the CPU (plain "
                         f"version) or on a CUDA device, not {a.device}")
    _check_args(a, shared, D)
    out = torch.empty((a.shape[0], D), dtype=_I32, device=a.device)
    if a.shape[0] == 0:
        return out
    lib = _build.library().lib
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.slip_mul_shared(a.data_ptr(), shared.data_ptr(), out.data_ptr(),
                             a.shape[0], a.shape[1], shared.shape[0], D,
                             stream)
    _build.check(rc, "mul_shared")
    mul_shared_limbs.launches += 1
    return out


mul_shared_limbs.launches = 0
