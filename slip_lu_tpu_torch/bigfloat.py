"""Arbitrary-precision binary floating point (the framework's MPFR equivalent).

The reference links against MPFR and exposes matrices of type SLIP_MPFR
(reference: SLIP_gmp.c mpfr wrappers; slip_expand_mpfr_array.c). This module
provides the same capability natively on Python ints: a ``BigFloat`` is an
exact dyadic rational ``mantissa * 2**exponent`` whose mantissa carries at
most ``prec`` significant bits. All conversions in/out are exact except the
final rounding to ``prec`` bits, which honors the four rounding modes of
:class:`slip_lu_tpu.options.RoundMode`.

Because every BigFloat is exactly representable as a Fraction, the conversion
chain fp64 <-> bigfloat <-> mpq <-> mpz used by the matrix-copy engine
(reference: slip_cast_array.c) is exact wherever the reference's is.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Union

from .options import RoundMode

Number = Union[int, float, Fraction, "BigFloat"]


@dataclasses.dataclass(frozen=True)
class BigFloat:
    """value == mantissa * 2**exponent, |mantissa| < 2**prec, normalized.

    Zero is (0, 0). The mantissa is odd-or-zero after normalization so the
    representation is canonical (equal values compare equal).
    """

    mantissa: int
    exponent: int
    prec: int = 128

    # ---- constructors -----------------------------------------------------

    @staticmethod
    def from_int(v: int, prec: int = 128, round_mode: RoundMode = RoundMode.NEAREST) -> "BigFloat":
        return BigFloat.from_fraction(Fraction(v), prec, round_mode)

    @staticmethod
    def from_float(v: float, prec: int = 128, round_mode: RoundMode = RoundMode.NEAREST) -> "BigFloat":
        if v != v or v in (float("inf"), float("-inf")):
            raise ValueError(f"non-finite value {v!r} cannot become a BigFloat")
        # float -> Fraction is exact (binary fp is dyadic)
        return BigFloat.from_fraction(Fraction(v), prec, round_mode)

    @staticmethod
    def from_fraction(v: Fraction, prec: int = 128,
                      round_mode: RoundMode = RoundMode.NEAREST) -> "BigFloat":
        """Round an exact rational to `prec` significant bits."""
        if v == 0:
            return BigFloat(0, 0, prec)
        num, den = v.numerator, v.denominator
        neg = num < 0
        num = abs(num)
        # Find e such that mantissa = round(num/den * 2**-e) has exactly
        # `prec` bits: nbits(num/den) ~ num.bit_length() - den.bit_length().
        e = num.bit_length() - den.bit_length() - prec
        # Scale: target = num * 2**-e / den
        if e >= 0:
            q, r = divmod(num, den << e)
            rden = den << e
        else:
            q, r = divmod(num << (-e), den)
            rden = den
        # q may have prec or prec+1 bits; fix up to exactly <= prec bits.
        if q.bit_length() > prec:
            # shift right by one, folding the dropped bit into the remainder
            e += 1
            dropped = q & 1
            q >>= 1
            r = r + dropped * rden  # remainder now out of 2*rden
            rden <<= 1
        m = _round_mantissa(q, r, rden, neg, round_mode)
        if m.bit_length() > prec:  # rounding carried out (e.g. 0.111.. -> 1.0)
            m >>= 1
            e += 1
        return BigFloat._normalized(-m if neg else m, e, prec)

    @staticmethod
    def _normalized(m: int, e: int, prec: int) -> "BigFloat":
        if m == 0:
            return BigFloat(0, 0, prec)
        while m % 2 == 0:
            m //= 2
            e += 1
        return BigFloat(m, e, prec)

    # ---- conversions ------------------------------------------------------

    def to_fraction(self) -> Fraction:
        """Exact value."""
        if self.exponent >= 0:
            return Fraction(self.mantissa << self.exponent)
        return Fraction(self.mantissa, 1 << (-self.exponent))

    def to_float(self) -> float:
        f = self.to_fraction()
        return f.numerator / f.denominator

    def to_int_round(self, round_mode: RoundMode = RoundMode.NEAREST) -> int:
        f = self.to_fraction()
        q, r = divmod(f.numerator, f.denominator)  # floor division
        if r == 0:
            return q
        if round_mode == RoundMode.DOWN:
            return q
        if round_mode == RoundMode.UP:
            return q + 1
        if round_mode == RoundMode.ZERO:
            return q if f >= 0 else q + 1
        # NEAREST (ties to even)
        twice = 2 * r
        if twice > f.denominator or (twice == f.denominator and q % 2 == 1):
            return q + 1
        return q

    # ---- arithmetic (exact; callers re-round via from_fraction) -----------

    def __eq__(self, other: object) -> bool:
        if isinstance(other, BigFloat):
            return self.mantissa == other.mantissa and self.exponent == other.exponent
        if isinstance(other, (int, Fraction)):
            return self.to_fraction() == other
        if isinstance(other, float):
            return self.to_fraction() == Fraction(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.to_fraction())

    def __bool__(self) -> bool:
        return self.mantissa != 0

    def __neg__(self) -> "BigFloat":
        return BigFloat(-self.mantissa, self.exponent, self.prec)

    def __abs__(self) -> "BigFloat":
        return BigFloat(abs(self.mantissa), self.exponent, self.prec)

    def __lt__(self, other: "BigFloat") -> bool:
        return self.to_fraction() < _as_fraction(other)

    def __le__(self, other: "BigFloat") -> bool:
        return self.to_fraction() <= _as_fraction(other)

    def __repr__(self) -> str:
        return f"BigFloat({self.mantissa}*2**{self.exponent}, prec={self.prec})"


def _round_mantissa(q: int, r: int, rden: int, neg: bool, mode: RoundMode) -> int:
    """Round |value| = q + r/rden (0 <= r < rden) to an integer mantissa."""
    if r == 0:
        return q
    if mode == RoundMode.ZERO:
        return q
    if mode == RoundMode.UP:
        return q if neg else q + 1
    if mode == RoundMode.DOWN:
        return q + 1 if neg else q
    # NEAREST, ties to even
    twice = 2 * r
    if twice > rden or (twice == rden and q % 2 == 1):
        return q + 1
    return q


def _as_fraction(v: Number) -> Fraction:
    if isinstance(v, BigFloat):
        return v.to_fraction()
    if isinstance(v, float):
        return Fraction(v)
    return Fraction(v)
