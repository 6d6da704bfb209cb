"""Vectorized limb arithmetic for the dense exact solve, on torch tensors.

Port of ``slip_lu_tpu/ops/matarith.py``. The hot multiplies of REF LU
have a shared operand: the pivot rho_k scaling every entry, the pivot row
times pivot column outer product, and the exact division by rho_{k-1}
(one truncated multiply by the divisor's Hensel inverse). Each
elimination step is a handful of whole-tensor operations:

  * shared multiply   : kernel K5 (``ops/mul_shared.py``,
    ``csrc/mul_shared.cu``) for one shared value on a CUDA device, its
    plain version on the CPU;
  * outer product     : a float64 matrix product with the row operand's
    Toeplitz matrix (exact, see ``mul_outer``);
  * exact division    : one truncated shared multiply by the divisor's
    Hensel inverse mod 2**(16*check_w);
  * carry propagation : value-halving passes and a Kogge-Stone prefix
    (``normalize_unsigned``), fixed depth, no host round trip.

The JAX package splits limbs into 8-bit digits before every shared
multiply because its matrix unit works in f32; K5 and its plain version
take 16-bit limbs directly (int64 column sums), so the digit split stays
only where this module multiplies through a float matrix product
(``mul_outer``). Values, flags and shapes at every public function equal
the JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import mul_shared as _k5
from .arith import (LIMB_BITS, MASK, _from_digits, _pad_to, _to_digits,
                    inv16, log2_pow2)

_I32 = torch.int32


def _shift_up(x: torch.Tensor, k: int) -> torch.Tensor:
    """out[..., i] = x[..., i-k], zero-filled: a carry moving up k places."""
    return F.pad(x[..., :-k], (k, 0))


# ---------------------------------------------------------------------------
# carry propagation
# ---------------------------------------------------------------------------

def normalize(acc: torch.Tensor, base_bits: int = LIMB_BITS
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve carries/borrows of an int32 digit accumulator.

    Entries may exceed the base or be negative (borrows). Returns
    (digits in [0, 2**base_bits), carry_out) where carry_out collects
    everything that flowed past the top digit (0 for in-range results,
    negative if the represented value was negative). The loop runs until
    no carry is left, so it reads a flag back from the device every pass;
    the dense path uses ``normalize_unsigned`` instead.
    """
    mask = (1 << base_bits) - 1
    out = torch.zeros_like(acc[..., 0])
    while bool(torch.any((acc >> base_bits) != 0)):
        car = acc >> base_bits           # arithmetic shift: handles borrows
        acc = (acc & mask) + _shift_up(car, 1)
        out = out + car[..., -1]
    return acc, out


def normalize_unsigned(acc: torch.Tensor, base_bits: int = LIMB_BITS
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-depth carry resolution for NONNEGATIVE accumulators.

    Value-halving passes bring every carry into {0,1}, then a Kogge-Stone
    generate/propagate prefix scan resolves worst-case ripple chains
    exactly. int32 inputs up to 2**31-1 are handled.
    """
    mask = (1 << base_bits) - 1
    d = acc.shape[-1]
    v = acc
    out_carry = torch.zeros_like(acc[..., 0])
    # 2^31 -> <= base + 2^(31-2*bits) ... : 4 passes reach carry <= 1 for
    # base_bits >= 8
    passes = 1
    bound = (1 << 31) - 1
    while bound > (1 << base_bits):
        bound = mask + (bound >> base_bits)
        passes += 1
    for _ in range(passes):
        car = v >> base_bits
        out_carry = out_carry + car[..., -1]
        v = (v & mask) + _shift_up(car, 1)
    # v in [0, 2**base_bits]; fold to digits + single-bit generate
    s = v & mask
    g = v >> base_bits
    p = (s == mask).to(acc.dtype)
    dist = 1
    while dist < d:
        g = g | (p & _shift_up(g, dist))
        p = p & _shift_up(p, dist)
        dist *= 2
    # composed g[i] = carry out of position i; its top entry leaves the
    # array (counted once here, propagation through the top included)
    out_carry = out_carry + g[..., -1]
    return (s + _shift_up(g, 1)) & mask, out_carry


def mag_shr_bits_vec(a: torch.Tensor, nbits) -> torch.Tensor:
    """Right-shift magnitudes by per-entry bit counts: a barrel shifter.

    log2 passes of static slices and selects. nbits broadcasts over a's
    batch dims; values in [0, 16*W).
    """
    w = a.shape[-1]
    nb = torch.broadcast_to(torch.as_tensor(nbits, dtype=_I32,
                                            device=a.device), a.shape[:-1])
    limb_shift = nb // LIMB_BITS
    # limb-granularity shift, powers of two
    step = 1
    while step < w:
        take = ((limb_shift & step) != 0)[..., None]
        a = torch.where(take, F.pad(a[..., step:], (0, step)), a)
        step *= 2
    # bit-granularity shift within limbs, powers of two (1, 2, 4, 8)
    s = nb % LIMB_BITS
    for bit in (1, 2, 4, 8):
        take = ((s & bit) != 0)[..., None]
        nxt = F.pad(a[..., 1:], (0, 1))
        shifted = ((a >> bit) | ((nxt << (LIMB_BITS - bit)) & MASK)) & MASK
        a = torch.where(take, shifted, a)
    return a


def trailing_zero_bits_vec(d: torch.Tensor) -> torch.Tensor:
    """Trailing zero bits of nonzero magnitudes [..., W] -> int32 [...].

    Gather-free: the first nonzero limb is selected with a prefix-all-zero
    mask; its within-limb trailing zeros come from the isolated lowest set
    bit. The JAX package takes a float32 log2 there (exact for powers of
    two below 2**16); ``log2_pow2`` is exact by construction.
    """
    nz = (d != 0).to(_I32)
    before = torch.cumsum(nz, dim=-1, dtype=_I32) - nz  # nonzero limbs below
    first = nz * (before == 0)                           # one-hot first
    idx = torch.sum(first * torch.arange(d.shape[-1], dtype=_I32,
                                         device=d.device), dim=-1).to(_I32)
    v = torch.sum(first * d, dim=-1).to(_I32)
    return idx * LIMB_BITS + log2_pow2(v & (-v))


def truncate_mag(m: torch.Tensor, out_w: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Truncate a limb magnitude to out_w limbs, flagging dropped nonzeros."""
    w = m.shape[-1]
    if out_w >= w:
        return _pad_to(m, out_w), torch.zeros(m.shape[:-1], dtype=torch.bool,
                                              device=m.device)
    return m[..., :out_w], torch.any(m[..., out_w:] != 0, dim=-1)


# ---------------------------------------------------------------------------
# vectorized compare / add / sub (no scans)
# ---------------------------------------------------------------------------

def mag_cmp_vec(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic magnitude compare -> {-1, 0, +1}, fully vectorized.

    The sign at the most significant differing limb is selected with a
    suffix-any mask built from a reversed cumulative sum.
    """
    w = max(a.shape[-1], b.shape[-1])
    ap, bp = _pad_to(a, w), _pad_to(b, w)
    diff = torch.sign(ap - bp).to(_I32)
    neq = (diff != 0).to(_I32)
    # first_from_top[i] = 1 iff limb i differs and no higher limb does
    any_above = torch.cumsum(neq.flip(-1), dim=-1, dtype=_I32).flip(-1) - neq
    first = neq * (any_above == 0)
    return torch.sum(diff * first, dim=-1).to(_I32)


def mag_add_vec(a: torch.Tensor, b: torch.Tensor, out_w: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """|a| + |b| -> (mag [..., out_w], overflow_flag)."""
    w = max(a.shape[-1], b.shape[-1])
    digs, car = normalize_unsigned(_pad_to(a, w) + _pad_to(b, w))
    if out_w > w:
        out = _pad_to(digs, out_w).clone()
        out[..., w] += car
        return out, torch.zeros(digs.shape[:-1], dtype=torch.bool,
                                device=a.device)
    out, dropped = truncate_mag(digs, out_w)
    return out, dropped | (car != 0)


def mag_sub_vec(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a| - |b| assuming |a| >= |b| (undefined otherwise).

    Borrow-free: a - b = a + complement(b) + 1 (mod 2**16W), all terms
    nonnegative, so the static carry resolver applies; the end-around
    carry (exactly 1 when a >= b) is dropped by the mod.
    """
    w = max(a.shape[-1], b.shape[-1])
    acc = _pad_to(a, w) + (MASK - _pad_to(b, w))
    acc[..., 0] += 1
    digs, _ = normalize_unsigned(acc)
    return digs


def signed_add_vec(sa, ma, sb, mb, out_w: int):
    """(sa,ma) + (sb,mb) -> (sign, mag, overflow), vectorized."""
    added, add_ovf = mag_add_vec(ma, mb, out_w)
    c = mag_cmp_vec(ma, mb)
    w = max(ma.shape[-1], mb.shape[-1])
    ma_p, mb_p = _pad_to(ma, w), _pad_to(mb, w)
    big = torch.where((c >= 0)[..., None], ma_p, mb_p)
    small = torch.where((c >= 0)[..., None], mb_p, ma_p)
    diff, diff_ovf = truncate_mag(mag_sub_vec(big, small), out_w)
    sign_diff = torch.where(c == 0, 0, torch.where(c > 0, sa, sb))
    opposite = sa * sb < 0
    sign = torch.where(opposite, sign_diff, torch.where(sa != 0, sa, sb))
    mag = torch.where(opposite[..., None], diff, added)
    ovf = torch.where(opposite, diff_ovf, add_ovf)
    sign = torch.where(torch.all(mag == 0, dim=-1), 0, sign)
    return sign, mag, ovf


def signed_sub_vec(sa, ma, sb, mb, out_w: int):
    return signed_add_vec(sa, ma, -sb, mb, out_w)


# ---------------------------------------------------------------------------
# shared-operand multiplication (kernel K5)
# ---------------------------------------------------------------------------

def _toeplitz(shared_dig: torch.Tensor, l_in: int, d_out: int
              ) -> torch.Tensor:
    """Band matrix T[..., u, d] = shared_dig[..., d-u] (0 outside).

    Gather-free tile/reshape construction: pad s to length L, tile it
    l_in times, and reshape with row length L-1 -- row u is then s
    rotated right by u (u*(L-1) = -u mod L), which is exactly the Toeplitz
    band as long as the zero padding covers the wrap-around
    (L >= ls + l_in - 1 and L > d_out).
    """
    ls = shared_dig.shape[-1]
    L = max(d_out + 1, ls + l_in)
    batch = shared_dig.shape[:-1]
    hp = F.pad(shared_dig, (0, L - ls))
    flat = hp.repeat((1,) * len(batch) + (l_in,))[..., : l_in * (L - 1)]
    return flat.reshape(batch + (l_in, L - 1))[..., :d_out]


def _conv_shared_limbs(a: torch.Tensor, shared: torch.Tensor,
                       out_w: int) -> torch.Tensor:
    """(|a| * |shared|) mod 2**(16*out_w), normalized limbs [..., out_w].

    The JAX package's ``_conv_shared_limbs`` (which takes digits) without
    the digit split. One shared value (1-D ``shared``) goes to kernel K5,
    the TPU kernel's own condition without its La <= 257 cap (that cap
    exists only because the TPU's matrix unit works in f32): on a CUDA
    device the kernel runs, on the CPU its plain version. A batch of
    shared operands (broadcast against a) takes the plain version, whose
    shifted multiply-adds run on any device.
    """
    la = a.shape[-1]
    if shared.ndim == 1:
        flat = a.reshape(-1, la).contiguous()
        limbs = _k5.mul_shared_limbs(flat, shared.contiguous(), out_w)
        return limbs.reshape(a.shape[:-1] + (out_w,))
    return _k5.mul_shared_limbs_ref(a, shared, out_w)


def mul_shared(a: torch.Tensor, shared: torch.Tensor, out_w: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """|a| * |shared| for a batch a [..., Wa] and one shared value [Ws].

    Exact full-width product, then truncated to out_w with overflow flag.
    """
    limbs = _conv_shared_limbs(a, shared, a.shape[-1] + shared.shape[-1])
    return truncate_mag(limbs, out_w)


def mul_shared_mod(a: torch.Tensor, shared: torch.Tensor, out_w: int
                   ) -> torch.Tensor:
    """(|a| * |shared|) mod 2**(16*out_w): truncated product."""
    return _conv_shared_limbs(a, shared, out_w)


def mul_outer(col: torch.Tensor, row: torch.Tensor, out_w: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Outer product of magnitudes: col [R, Wc] x row [C, Wr] -> [R, C, out_w].

    out[r, c] = col[r] * row[c]: the digits of col times the Toeplitz
    matrices of row's digits, one matrix product. PyTorch has no integer
    matrix product on CUDA, so it runs in float64, which is exact here:
    every digit is <= 255, so every product and every partial sum is an
    integer of at most Lc * 255**2 < 2**53.
    """
    dc = _to_digits(col)                   # [R, Lc]
    dr = _to_digits(row)                   # [C, Lr]
    lc, lr = dc.shape[-1], dr.shape[-1]
    t = _toeplitz(dr, lc, lc + lr)         # [C, Lc, D]
    C, _, D = t.shape
    acc = dc.double() @ t.double().permute(1, 0, 2).reshape(lc, C * D)
    acc = acc.to(_I32).reshape(dc.shape[0], C, D)
    digs, _ = normalize_unsigned(acc, 8)
    return truncate_mag(_from_digits(digs), out_w)


def signed_mul_shared(sa, ma, s_shared, m_shared, out_w: int):
    mag, ovf = mul_shared(ma, m_shared, out_w)
    sign = sa * s_shared
    sign = torch.where(torch.all(mag == 0, dim=-1), 0, sign)
    return sign, mag, ovf


def signed_mul_outer(s_col, m_col, s_row, m_row, out_w: int):
    mag, ovf = mul_outer(m_col, m_row, out_w)
    sign = s_col[:, None] * s_row[None, :]
    sign = torch.where(torch.all(mag == 0, dim=-1), 0, sign)
    return sign, mag, ovf


# ---------------------------------------------------------------------------
# exact division: Hensel (2-adic) inverse + one truncated multiply
# ---------------------------------------------------------------------------

def _mod_sub_from_two(v: torch.Tensor) -> torch.Tensor:
    """(2 - v) mod 2**(16*W) for a magnitude v [..., W].

    Complement form: 2 - v = complement(v) + 3 (mod 2**16W), nonnegative
    throughout, so the static carry resolver applies.
    """
    comp = MASK - v
    comp[..., 0] += 3
    digs, _ = normalize_unsigned(comp)     # dropped carry == mod
    return digs


def hensel_inv(d_odd: torch.Tensor, out_w: int) -> torch.Tensor:
    """Inverse of an odd magnitude mod 2**(16*out_w) by Newton lifting.

    Each iteration doubles the correct width: x <- x*(2 - d*x). O(log W)
    small truncated multiplies (two K5 launches each), computed once per
    elimination step and amortized over every entry's division.
    """
    x = inv16(d_odd[..., :1])
    w = 1
    while w < out_w:
        w = min(2 * w, out_w)
        d_t = d_odd[..., :w] if d_odd.shape[-1] >= w else _pad_to(d_odd, w)
        dx = mul_shared_mod(d_t, x, w)
        x = mul_shared_mod(_pad_to(x, w), _mod_sub_from_two(dx), w)
    return x


def div_precompute_hensel(d: torch.Tensor, check_w: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inverse mod 2**(16*check_w) of the odd part, trailing-zero bits)."""
    tz = trailing_zero_bits_vec(d)
    d_odd = mag_shr_bits_vec(d, tz)
    return hensel_inv(d_odd, check_w), tz


def divexact_shared(a: torch.Tensor, inv: torch.Tensor, tz: torch.Tensor,
                    out_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact |a| / |d| given inv = odd(d)^-1 mod 2**(16*check_w).

    check_w (= inv width) must be >= the numerator width so the true
    quotient is representable mod 2**(16*check_w); then
    q = (a >> tz) * inv mod 2**(16*check_w) is exact. Returns
    (q [..., out_w], overflow flag = quotient needs > out_w limbs).
    Requires the division to be exact, which IPGE guarantees.
    """
    r = mag_shr_bits_vec(a, tz)
    q_full = mul_shared_mod(r, inv, inv.shape[-1])
    return truncate_mag(q_full, out_w)


def signed_divexact_shared(s_num, m_num, s_den, inv, tz, out_w: int):
    q, bad = divexact_shared(m_num, inv, tz, out_w)
    sign = s_num * s_den
    sign = torch.where(torch.all(q == 0, dim=-1), 0, sign)
    return sign, q, bad


# ---------------------------------------------------------------------------
# pairwise multiplication (per-entry operands)
# ---------------------------------------------------------------------------

def _pairwise_conv(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Full digit convolution per entry: [E, La] x [E, Lb] -> [E, La+Lb-1].

    The JAX package runs E independent small convolutions as one grouped
    convolution; PyTorch has no integer convolution on CUDA, so this is
    Lb shifted multiply-adds (exact: sums <= min(La, Lb) * 255**2).
    """
    e, la = da.shape
    lb = db.shape[-1]
    out = torch.zeros((e, la + lb - 1), dtype=_I32, device=da.device)
    for j in range(lb):
        out[:, j:j + la] += da * db[:, j:j + 1]
    return out


def mul_pairwise(a: torch.Tensor, b: torch.Tensor, out_w: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """|a[e]| * |b[e]| per entry -> (mag [E, out_w], overflow flag [E])."""
    acc = F.pad(_pairwise_conv(_to_digits(a), _to_digits(b)), (0, 1))
    digs, _ = normalize_unsigned(acc, 8)   # even digit count
    return truncate_mag(_from_digits(digs), out_w)


def mul_pairwise_mod(a: torch.Tensor, b: torch.Tensor, out_w: int
                     ) -> torch.Tensor:
    """(|a[e]| * |b[e]|) mod 2**(16*out_w) per entry."""
    acc = _pad_to(_pairwise_conv(_to_digits(a), _to_digits(b)), 2 * out_w)
    digs, _ = normalize_unsigned(acc, 8)
    return _from_digits(digs)


def divexact_gathered(a: torch.Tensor, inv: torch.Tensor, tz: torch.Tensor,
                      out_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact |a[e]| / |d[e]| with per-entry Hensel inverses.

    inv [E, check_w]: odd(d[e])^-1 mod 2**(16*check_w); tz [E]: trailing
    zero bits of each d[e]. Same contract as divexact_shared, pairwise.
    """
    r = mag_shr_bits_vec(a, tz)
    q_full = mul_pairwise_mod(r, inv, inv.shape[-1])
    return truncate_mag(q_full, out_w)
