"""Multi-limb two's-complement arithmetic on torch tensors.

The plain PyTorch counterpart of ``slip_lu_tpu/ops/pallas_limbs.py`` and
of ``tpu/factor_fused.py:_signed_terms`` (kernel table entry K1). The
CUDA kernels carry the same functions as warp-cooperative ``__device__``
routines in ``csrc/limbs.cuh``; these tensor versions are what the
streams' plain versions (``gpu/factor_fused.py``) run on, on the CPU in
the tests and on the card when the kernels are checked against them.

Representation: residues mod 2**(16*D) as D limbs of 16 bits, limb-major
``[D, B]`` int64 tensors (the batch on the last axis), limb values in
0..65535. A residue reads as signed through its top limb's bit 15.

Products are exact column sums of 16-bit limb products in int64 (below
2**44 for widths up to 2048 limbs), so there are no byte planes: the
TPU kernel split limbs into bytes only because its matrix unit works in
f32. A signed product biases its signed column sums to nonnegative
values that sum to a multiple of 2**(16*D), which leaves the residue
unchanged, then resolves carries exactly as ``carry_normalize`` does.
"""

from __future__ import annotations

import torch

MASK16 = 0xFFFF
_I64 = torch.int64


def shift_rows_up(x: torch.Tensor, k: int) -> torch.Tensor:
    """out[i] = x[i-k], zero-fill at the bottom (static k); keeps length."""
    if k == 0:
        return x
    if k >= x.shape[0]:
        return torch.zeros_like(x)
    return torch.cat([torch.zeros_like(x[:k]), x[:-k]])


def carry_normalize(acc: torch.Tensor, max_val: int) -> torch.Tensor:
    """Resolve limb values in [0, max_val] to clean 16-bit limbs mod
    2**(16*D); the dropped top carry is the modular reduction.

    Value-halving passes bring every limb to digit + carry with carry in
    {0, 1}; a Kogge-Stone generate/propagate prefix then resolves ripple
    chains in log2(D) steps (the reference's construction)."""
    d = acc.shape[0]
    v = acc
    bound = max_val
    while bound > 2 * MASK16 + 1:
        v = (v & MASK16) + shift_rows_up(v >> 16, 1)
        bound = MASK16 + (bound >> 16) + 1
    s = v & MASK16
    g = v >> 16
    p = (s == MASK16).to(v.dtype)
    dist = 1
    while dist < d:
        g = g | (p & shift_rows_up(g, dist))
        p = p & shift_rows_up(p, dist)
        dist *= 2
    return (s + shift_rows_up(g, 1)) & MASK16


def _columns(a: torch.Tensor, b: torch.Tensor, D: int) -> torch.Tensor:
    """Column sums c[k] = sum_{i+j=k} a[i]*b[j] for k < D -> [D, B]."""
    Wa, B = a.shape
    Wb = b.shape[0]
    acc = torch.zeros((D, B), dtype=_I64, device=a.device)
    for i in range(min(Wa, D)):
        n = min(Wb, D - i)
        acc[i:i + n] += a[i] * b[:n]
    return acc


def mul_mod(a: torch.Tensor, b: torch.Tensor, D: int) -> torch.Tensor:
    """Unsigned product (a * b) mod 2**(16*D) of clean limbs -> [D, B]."""
    Wb = b.shape[0]
    return carry_normalize(_columns(a, b, D), min(a.shape[0], Wb)
                           * MASK16 * MASK16)


def _signed_top(x: torch.Tensor) -> torch.Tensor:
    """Limbs with the top one read as signed: sum x[i]*2**(16i) is the
    residue's signed value."""
    top = x[-1:] - ((x[-1:] >> 15) << 16)
    return torch.cat([x[:-1], top])


_BIAS = 1 << 46          # above any signed column sum's magnitude


def normalize_signed(c: torch.Tensor) -> torch.Tensor:
    """Signed column sums (|c| < 2**46) -> clean limbs mod 2**(16*D).

    Adds BIAS*2**16 at every limb and subtracts BIAS at every limb but the
    first: the net is BIAS*2**(16*D), zero mod 2**(16*D), and every limb
    becomes nonnegative."""
    bias = torch.full_like(c[:, :1], _BIAS << 16)
    bias[1:] -= _BIAS
    return carry_normalize(c + bias, (_BIAS << 17))


def signed_mul_mod(a: torch.Tensor, b: torch.Tensor, D: int
                   ) -> torch.Tensor:
    """Signed product of two residues (each read as signed at its own
    width) mod 2**(16*D) -> [D, B]. Replaces the reference's unsigned
    product plus ``_signed_terms`` corrections."""
    return normalize_signed(_columns(_signed_top(a), _signed_top(b), D))


def signed_mul_sub_mod(t: torch.Tensor, m: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, D: int) -> torch.Tensor:
    """(t*m - a*b) mod 2**(16*D), every operand signed at its width."""
    c = _columns(_signed_top(t), _signed_top(m), D) \
        - _columns(_signed_top(a), _signed_top(b), D)
    return normalize_signed(c)


def sub_mod(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x - y) mod 2**(16*D) on clean limbs, via complement + carry."""
    one0 = torch.zeros_like(x)
    one0[0] = 1
    return carry_normalize(x + (MASK16 - y) + one0, 2 * MASK16 + 1)


def two_minus_mod(x: torch.Tensor) -> torch.Tensor:
    """(2 - x) mod 2**(16*D): the Newton-iteration complement."""
    three0 = torch.zeros_like(x)
    three0[0] = 3
    return carry_normalize((MASK16 - x) + three0, MASK16 + 3)


def sign_fill(top_limb: torch.Tensor) -> torch.Tensor:
    """[1, B] -> 0x0000 / 0xFFFF per lane from a limb's sign bit."""
    return (top_limb >> 15) * MASK16


def fits_in(x: torch.Tensor, W: int) -> torch.Tensor:
    """[1, B] bool: does the residue x hold a signed value that fits in W
    limbs (rows >= W all equal the sign fill of row W-1)?"""
    fill = sign_fill(x[W - 1:W])
    return torch.all(x[W:] == fill, dim=0, keepdim=True)


def sign_extend(x: torch.Tensor, D: int) -> torch.Tensor:
    """[W, B] -> [D, B]: two's-complement extension (D >= W), or the
    residue mod 2**(16*D) (D < W)."""
    W = x.shape[0]
    if D <= W:
        return x[:D]
    return torch.cat([x, sign_fill(x[W - 1:W]).expand(D - W, -1)])


def trailing_zero_bits(x: torch.Tensor) -> torch.Tensor:
    """[1, B] trailing-zero bit count of residues [D, B] (16*D + 16 for
    zero, as the reference's)."""
    D = x.shape[0]
    nz = x != 0
    limb_idx = torch.where(nz.any(0, keepdim=True),
                           nz.to(_I64).argmax(0, keepdim=True),
                           torch.full_like(x[:1], D))
    low = torch.gather(torch.cat([x, torch.zeros_like(x[:1])]), 0, limb_idx)
    lowbit = low & -low
    tz16 = torch.where(lowbit != 0,
                       torch.log2(lowbit.clamp(min=1).double()).round()
                       .to(x.dtype), torch.full_like(low, 16))
    return 16 * limb_idx + tz16


def shr_bits(x: torch.Tensor, tz: torch.Tensor) -> torch.Tensor:
    """Arithmetic right shift of residues [D, B] by per-lane bit counts
    tz [1, B]: the full-width residue of floor(x / 2**tz) (sign fill)."""
    D, B = x.shape
    fill = sign_fill(x[-1:])
    ext = torch.cat([x, fill.expand(D + 1, -1)])        # [2D+1, B]
    q = (tz >> 4).clamp(max=D)
    r = tz & 15
    rows = torch.arange(D, device=x.device)[:, None] + q
    m = torch.gather(ext, 0, rows)
    nxt = torch.gather(ext, 0, rows + 1)
    return ((m >> r) | ((nxt << (16 - r)) & MASK16)) & MASK16


def inv16(d: torch.Tensor) -> torch.Tensor:
    """Newton inverse mod 2**16 of odd values."""
    x = d & MASK16
    for _ in range(4):
        x = (x * (2 - d * x)) & MASK16
    return x


def inverse_mod(d: torch.Tensor, D: int) -> torch.Tensor:
    """Inverse mod 2**(16*D) of odd residues d [>= D, B] -> [D, B]:
    inv16, then Newton doubling x <- x*(2 - d*x) (the reference's
    ``_lift_phase``). The inverse is unique, so any exact lift agrees."""
    x = inv16(d[0:1])
    w = 1
    while w < D:
        w2 = min(2 * w, D)
        u = two_minus_mod(mul_mod(d[:w2], x, w2))
        x = mul_mod(x, u, w2)
        w = w2
    return x


def is_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.all(x == 0, dim=0, keepdim=True)
