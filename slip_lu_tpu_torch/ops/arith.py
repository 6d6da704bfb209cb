"""Fixed-width multi-limb integer arithmetic on torch tensors.

Port of ``slip_lu_tpu/ops/arith.py``: the sequential (scan) reference ops
and the helpers that ``matarith`` and the dense factorization import.

Representation, as in the JAX package: little-endian base-2**16 limbs in
int32 ``[..., W]`` tensors (batch dims lead), plus a separate sign tensor
(int32 in {-1, 0, +1}). Products are 8-bit digit convolutions, exact
division is Jebelean's word-serial algorithm from the least significant
limb. The JAX package's ``lax.scan`` loops are Python loops over the limb
axis here: these ops are the exact reference the tests hold the
vectorized ones to, not the hot path.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

LIMB_BITS = 16
LIMB_BASE = 1 << LIMB_BITS
MASK = LIMB_BASE - 1
_I32 = torch.int32


# ---------------------------------------------------------------------------
# carry/borrow propagation
# ---------------------------------------------------------------------------

def carry_normalize(acc: torch.Tensor, base_bits: int = LIMB_BITS
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Propagate carries over the last axis of a nonnegative accumulator.

    Returns (digits < 2**base_bits, final_carry). acc entries must be < 2**31.
    """
    mask = (1 << base_bits) - 1
    carry = torch.zeros_like(acc[..., 0])
    digs = []
    for i in range(acc.shape[-1]):
        tot = acc[..., i] + carry
        carry = tot >> base_bits
        digs.append(tot & mask)
    return torch.stack(digs, dim=-1), carry


def _borrow_subtract(a: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a - b limbwise with borrow; requires a >= b for a clean final borrow 0.

    Returns (diff_limbs, final_borrow)."""
    a, b = torch.broadcast_tensors(a, b)
    borrow = torch.zeros_like(a[..., 0])
    digs = []
    for i in range(a.shape[-1]):
        d = a[..., i] - b[..., i] - borrow
        borrow = (d < 0).to(a.dtype)
        digs.append(d + (borrow << LIMB_BITS))
    return torch.stack(digs, dim=-1), borrow


def _pad_to(a: torch.Tensor, w: int) -> torch.Tensor:
    """Zero-extend (or cut) the last axis to w limbs."""
    cur = a.shape[-1]
    if cur == w:
        return a
    if cur > w:
        return a[..., :w]
    return F.pad(a, (0, w - cur))


# ---------------------------------------------------------------------------
# magnitude add / sub / compare
# ---------------------------------------------------------------------------

def mag_add(a: torch.Tensor, b: torch.Tensor, out_w: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """|a| + |b| -> (mag [..., out_w], overflow_flag [...])."""
    w = max(a.shape[-1], b.shape[-1])
    s = _pad_to(a, w) + _pad_to(b, w)
    digs, carry = carry_normalize(s)
    if out_w >= w:
        out = _pad_to(digs, out_w)
        if out_w > w:
            out = out.clone()
            out[..., w] += carry
            carry = torch.zeros_like(carry)
        return out, carry != 0
    dropped = torch.any(digs[..., out_w:] != 0, dim=-1) | (carry != 0)
    return digs[..., :out_w], dropped


def mag_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a| - |b| assuming |a| >= |b| (undefined otherwise)."""
    w = max(a.shape[-1], b.shape[-1])
    digs, _ = _borrow_subtract(_pad_to(a, w), _pad_to(b, w))
    return digs


def mag_cmp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic compare of magnitudes: -1, 0, +1 (int32, batched)."""
    w = max(a.shape[-1], b.shape[-1])
    diff = torch.sign(_pad_to(a, w) - _pad_to(b, w)).to(_I32)
    # most significant nonzero difference wins: scan from the high limb
    acc = torch.zeros_like(diff[..., 0])
    for i in range(w - 1, -1, -1):
        acc = torch.where(acc != 0, acc, diff[..., i])
    return acc


def mag_is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(a == 0, dim=-1)


# ---------------------------------------------------------------------------
# multiplication: 8-bit digit convolution
# ---------------------------------------------------------------------------

def _to_digits(a: torch.Tensor) -> torch.Tensor:
    """[..., W] 16-bit limbs -> [..., 2W] 8-bit digits (little-endian)."""
    lo = a & 0xFF
    hi = a >> 8
    return torch.stack([lo, hi], dim=-1).reshape(*a.shape[:-1],
                                                 2 * a.shape[-1])


def _from_digits(d: torch.Tensor) -> torch.Tensor:
    """[..., 2W] normalized 8-bit digits -> [..., W] 16-bit limbs."""
    return d[..., 0::2] + (d[..., 1::2] << 8)


def mag_mul(a: torch.Tensor, b: torch.Tensor, out_w: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """|a| * |b| -> (mag [..., out_w], overflow_flag [...]).

    Schoolbook 8-bit digit convolution: partial products <= 255**2 and
    accumulation chains of <= 2*(Wa+Wb) terms stay far below 2**31.
    """
    da = _to_digits(a)                      # [..., 2Wa]
    db = _to_digits(b)                      # [..., 2Wb]
    La, Lb = da.shape[-1], db.shape[-1]
    L = La + Lb
    db_pad = _pad_to(db, L)
    bshape = torch.broadcast_shapes(da.shape[:-1], db.shape[:-1])
    acc = torch.zeros(bshape + (L,), dtype=_I32, device=a.device)
    for j in range(La):
        # zeros roll around harmlessly
        acc = acc + da[..., j, None] * torch.roll(db_pad, j, dims=-1)
    digs, _ = carry_normalize(acc, base_bits=8)  # carry ends 0: L is wide enough
    limbs = _from_digits(digs)               # [..., (La+Lb)/2]
    w = limbs.shape[-1]
    if out_w >= w:
        return _pad_to(limbs, out_w), torch.zeros(limbs.shape[:-1],
                                                  dtype=torch.bool,
                                                  device=a.device)
    dropped = torch.any(limbs[..., out_w:] != 0, dim=-1)
    return limbs[..., :out_w], dropped


# ---------------------------------------------------------------------------
# exact division (Jebelean, least-significant-first)
# ---------------------------------------------------------------------------

def _mulmod16(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x * y) mod 2**16 for 16-bit values without int32 overflow."""
    lo = (x & 0xFF) * y                      # <= 2**24
    hi = (((x >> 8) * y) & 0xFF) << 8        # masked before shift
    return (lo + hi) & MASK


def inv16(d0: torch.Tensor) -> torch.Tensor:
    """Inverse of an odd 16-bit value mod 2**16 (Newton-Hensel lifting)."""
    x = d0  # correct to 3 bits (d*d == 1 mod 8 for odd d)
    for _ in range(3):  # 3 -> 6 -> 12 -> 24 bits
        t = (2 - _mulmod16(d0, x)) & MASK
        x = _mulmod16(x, t)
    return x


def log2_pow2(p: torch.Tensor) -> torch.Tensor:
    """Exact log2 of int32 powers of two below 2**16 (0 for p = 0).

    The JAX package takes a float32 log2 and rounds it. Here the value's
    float32 exponent field is read instead: a power of two converts to
    float32 exactly, so its biased exponent minus 127 is the log, with no
    rounding anywhere."""
    exp = (p.to(torch.float32).view(torch.int32) >> 23) - 127
    return torch.clamp(exp, min=0).to(p.dtype)


def trailing_zero_bits(d: torch.Tensor) -> torch.Tensor:
    """Trailing zero bits of a nonzero magnitude [..., W] -> int32 [...]."""
    nz = (d != 0).to(_I32)
    idx = torch.argmax(nz, dim=-1).to(_I32)            # first nonzero limb
    v = torch.gather(d, -1, idx[..., None].long())[..., 0]
    return idx * LIMB_BITS + log2_pow2(v & (-v))


def mag_shr_bits(a: torch.Tensor, nbits) -> torch.Tensor:
    """Right-shift a magnitude by a dynamic bit count (>= 0)."""
    W = a.shape[-1]
    nbits = torch.as_tensor(nbits, dtype=_I32, device=a.device)
    limb_shift = nbits // LIMB_BITS
    s = nbits % LIMB_BITS
    pos = torch.arange(W, dtype=_I32, device=a.device)
    idx = pos + limb_shift[..., None] if limb_shift.ndim else pos + limb_shift
    shape = a.shape[:-1] + (W,)
    valid = idx < W
    cur = torch.gather(a, -1, torch.broadcast_to(
        torch.clamp(idx, 0, W - 1), shape).long())
    cur = torch.where(valid, cur, 0)
    nxt = torch.gather(a, -1, torch.broadcast_to(
        torch.clamp(idx + 1, 0, W - 1), shape).long())
    nxt = torch.where(idx + 1 < W, nxt, 0)
    s_ = s[..., None] if s.ndim else s
    return ((cur >> s_) | ((nxt << (LIMB_BITS - s_)) & MASK)) & MASK


def mag_shl_bits_static(a: torch.Tensor, nbits: int) -> torch.Tensor:
    """Left-shift a magnitude by a *static* bit count, widening the array."""
    W = a.shape[-1]
    limb_shift, s = divmod(nbits, LIMB_BITS)
    out_w = W + limb_shift + (1 if s else 0)
    shifted = torch.zeros(a.shape[:-1] + (out_w,), dtype=_I32,
                          device=a.device)
    if s == 0:
        shifted[..., limb_shift:limb_shift + W] = a
        return shifted
    shifted[..., limb_shift:limb_shift + W] += (a << s) & MASK
    shifted[..., limb_shift + 1:limb_shift + 1 + W] += a >> (LIMB_BITS - s)
    return shifted


def _scalar_mul16(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """16-bit scalar q [...] times magnitude d [..., W] -> [..., W+1]."""
    W = d.shape[-1]
    lo = (q & 0xFF)[..., None] * d           # <= 2**24
    hi = (q >> 8)[..., None] * d             # <= 2**24
    acc = torch.zeros(torch.broadcast_shapes(lo.shape[:-1], d.shape[:-1])
                      + (W + 1,), dtype=_I32, device=d.device)
    acc[..., :W] += lo
    acc[..., :W] += (hi & 0xFF) << 8
    acc[..., 1:] += hi >> 8
    digs, _ = carry_normalize(acc)
    return digs  # carry is 0: q*d < 2**(16(W+1))


def div_precompute(d: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Precompute for exact division by magnitude d (shared divisor).

    Returns (d_odd, inv0, tz): d right-shifted to odd, the mod-2**16 inverse
    of its low limb, and the shift amount. d must be nonzero.
    """
    tz = trailing_zero_bits(d)
    d_odd = mag_shr_bits(d, tz)
    return d_odd, inv16(d_odd[..., 0]), tz


def mag_divexact(a: torch.Tensor, d_odd: torch.Tensor, inv0: torch.Tensor,
                 tz: torch.Tensor, out_w: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact |a| / |d| via Jebelean word-serial division.

    Preconditions: d = d_odd << tz divides a exactly (IPGE guarantees this).
    Returns (quotient [..., out_w], nonexact_or_overflow_flag [...]). The
    flag fires if the division was not exact or the quotient needs more
    than out_w limbs.
    """
    Wa = a.shape[-1]
    r = mag_shr_bits(a, tz)
    d_pad = _pad_to(d_odd, Wa)
    qs, bad = [], None
    for _ in range(out_w):
        q_t = _mulmod16(r[..., 0], inv0)
        prod = _scalar_mul16(q_t, d_pad)            # [..., Wa+1]
        r_ext = _pad_to(r, Wa + 1)
        diff, borrow = _borrow_subtract(r_ext, prod)
        r = diff[..., 1:]
        qs.append(q_t)
        bad = borrow != 0 if bad is None else bad | (borrow != 0)
    q = torch.stack(qs, dim=-1)
    fin = torch.any(r != 0, dim=-1)
    return q, fin if bad is None else fin | bad


# ---------------------------------------------------------------------------
# signed operations (sign tensors: int32 in {-1, 0, +1})
# ---------------------------------------------------------------------------

def signed_mul(sa, ma, sb, mb, out_w: int):
    """(sa,ma) * (sb,mb) -> (sign, mag, overflow)."""
    mag, ovf = mag_mul(ma, mb, out_w)
    return sa * sb, mag, ovf


def signed_add(sa, ma, sb, mb, out_w: int):
    """(sa,ma) + (sb,mb) -> (sign, mag, overflow). Branchless over batch."""
    added, add_ovf = mag_add(ma, mb, out_w)
    c = mag_cmp(ma, mb)
    w = max(ma.shape[-1], mb.shape[-1])
    ma_p, mb_p = _pad_to(ma, w), _pad_to(mb, w)
    big = torch.where((c >= 0)[..., None], ma_p, mb_p)
    small = torch.where((c >= 0)[..., None], mb_p, ma_p)
    diff = _pad_to(mag_sub(big, small), out_w)
    sign_diff = torch.where(c == 0, 0, torch.where(c > 0, sa, sb))
    opposite = sa * sb < 0
    sign = torch.where(opposite, sign_diff, torch.where(sa != 0, sa, sb))
    mag = torch.where(opposite[..., None], diff, added)
    ovf = torch.where(opposite, False, add_ovf)
    # result zero -> sign 0
    sign = torch.where(mag_is_zero(mag), 0, sign)
    return sign, mag, ovf


def signed_sub(sa, ma, sb, mb, out_w: int):
    return signed_add(sa, ma, -sb, mb, out_w)


def signed_divexact(s_num, m_num, s_den, d_odd, inv0, tz, out_w: int):
    """(s_num,m_num) / signed divisor (s_den, d_odd<<tz), exact."""
    q, bad = mag_divexact(m_num, d_odd, inv0, tz, out_w)
    sign = s_num * s_den
    sign = torch.where(mag_is_zero(q), 0, sign)
    return sign, q, bad
