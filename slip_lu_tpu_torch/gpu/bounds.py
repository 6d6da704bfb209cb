"""IPGE bit-growth bounds -> fixed limb width W.

The reference never needs this: GMP integers grow on demand, and the user
guide only cites the polynomial Hadamard-type bound (SURVEY.md section 6).
On TPU the width must be static, so we compute the bound up front:

every entry of L, U, every pivot rho_k, and every intermediate IPGE value
x_i^(t) is (+/-) a minor of the integerized matrix A (IPGE theory), hence
bounded by the Hadamard product bound prod_j ||A(:,j)||_2 over any column
subset — and since nonzero integer columns have norm >= 1, the full-column
product bounds every minor. For the solve, Cramer's rule bounds the scaled
solution x_hat by the same product with one column replaced by b.
"""

from __future__ import annotations

import math
from typing import Iterable

from ..matrix import SlipMatrix
from ..ops.limbs import LIMB_BITS

_GUARD_BITS = 18  # sign/rounding slack on top of the analytic bound


def _log2_colnorm_bits(col_vals: Iterable[int]) -> float:
    """log2 of the 2-norm of an integer column (0 for empty/zero columns)."""
    s = 0
    for v in col_vals:
        s += v * v
    if s == 0:
        return 0.0
    # exact-ish log2 of a big int: bit_length plus a float correction
    b = s.bit_length()
    top = s >> max(0, b - 53)
    return 0.5 * (math.log2(max(top, 1)) + max(0, b - 53))


def hadamard_bits(A: SlipMatrix) -> int:
    """Bits bounding |any minor| of a CSC x MPZ matrix (>=1)."""
    total = 0.0
    for col in range(A.n):
        vals = [int(A.x[idx]) for idx in range(int(A.p[col]), int(A.p[col + 1]))]
        total += _log2_colnorm_bits(vals)
    return max(1, math.ceil(total))


def rhs_bits(b_ints) -> int:
    """Bits of the largest |b| entry column norm (Cramer replacement)."""
    mx = 0.0
    ncols = b_ints.shape[1] if b_ints.ndim == 2 else 1
    for c in range(ncols):
        col = b_ints[:, c] if b_ints.ndim == 2 else b_ints
        mx = max(mx, _log2_colnorm_bits(int(v) for v in col))
    return max(1, math.ceil(mx))


def _input_width(values) -> int:
    """Limbs needed to store the widest input in TWO'S COMPLEMENT (>= 1).

    Sign-aware: +2**31 needs 3 limbs, not 2 — clamped widths below this
    would make the host-side packing wrap silently before the device
    could flag anything."""
    bits = 1
    for v in values:
        v = int(v)
        b = (v if v >= 0 else ~v).bit_length() + 1
        if b > bits:
            bits = b
    return -(-bits // LIMB_BITS)


def factor_width(A: SlipMatrix, max_limbs=None, hbits=None) -> int:
    """Limb width W for factorization values (L, U, rhos, intermediates)."""
    bits = (hadamard_bits(A) if hbits is None else hbits) + _GUARD_BITS
    W = -(-bits // LIMB_BITS)
    if max_limbs is not None:
        # max_limbs caps the (possibly pessimistic) analytic bound, but W
        # can never go below what the input entries themselves need —
        # packing would fail before the device could flag anything
        W = max(min(W, max_limbs),
                _input_width(A.x[idx] for idx in range(int(A.p[A.n]))))
    return max(2, W)


def solve_width(A: SlipMatrix, b_ints, W_factor: int, n: int, max_limbs=None,
                hbits=None) -> int:
    """Limb width for the substitution phase.

    Covers rho_{n-1} * y (forward result times determinant, <= 2H + R bits
    since y and x_hat are minors of [A|b] <= 2^(H+R) and det <= 2^H) and
    every back-substitution partial sum (+ log2 n accumulation slack).
    """
    H = hadamard_bits(A) if hbits is None else hbits
    bits = 2 * H + rhs_bits(b_ints) + max(1, n).bit_length() + _GUARD_BITS
    W = -(-bits // LIMB_BITS)
    if max_limbs is not None:
        W = max(min(W, max_limbs), _input_width(b_ints.reshape(-1)))
    return max(W, W_factor + 1)


def widen_widths(W: int, Ws: int, W_full: int, Ws_full: int):
    """Next (W, Ws) on the widen-and-retry ladder.

    Doubles each width, capped at the UNCLAMPED analytic bound (W_full /
    Ws_full, from factor_width/solve_width with max_limbs=None) — beyond
    that bound overflow is mathematically impossible, so returns None if
    the current widths already cover it (an overflow there means a broken
    invariant, not an undersized budget).
    """
    if W >= W_full and Ws >= Ws_full:
        return None
    W2 = W if W >= W_full else min(2 * W, W_full)
    Ws2 = Ws if Ws >= Ws_full else min(max(2 * Ws, 2 * W2 + 2), Ws_full)
    return W2, max(Ws2, W2 + 1)
