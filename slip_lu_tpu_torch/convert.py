"""Matrix conversion engine: any {kind} x {type} -> any {kind} x {type}.

Reference parity: ``SLIP_matrix_copy.c`` (~900 lines: the full 15x15
conversion matrix), ``slip_cast_array.c`` / ``slip_cast_matrix.c`` (typed
array casts with rounding modes and int64 bounds), and the integerization
routines ``slip_expand_double_array.c`` / ``slip_expand_mpfr_array.c`` /
``slip_expand_mpq_array.c`` (scale a fractional array to integers, recording
the factor in ``scale``).

Semantics: a SlipMatrix represents the exact values ``x[k] / scale``.
Conversions preserve the represented values exactly, except when the target
entry type is lossy (FP64, MPFR at finite prec, INT64), in which case entries
are rounded per ``options.round``. Integerization here is *exact for every
input* (scale = lcm of denominators; for doubles/bigfloats that is a power of
two), which subsumes the reference's dyadic x 2**52 expansion without its
precision cliff.

Duplicate triplet entries are summed (CSparse convention).
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Any, List, Optional

import numpy as np

from .bigfloat import BigFloat
from .errors import SlipIncorrectInputError
from .matrix import Kind, SlipMatrix, Type, value_array
from .options import Options, RoundMode

_INT64_MIN = -(2 ** 63)
_INT64_MAX = 2 ** 63 - 1


# ---------------------------------------------------------------------------
# scalar casts
# ---------------------------------------------------------------------------

def to_fraction(v: Any, t: Type) -> Fraction:
    """Exact rational value of one stored entry (before scale division)."""
    if t == Type.MPZ or t == Type.INT64:
        return Fraction(int(v))
    if t == Type.MPQ:
        return v if isinstance(v, Fraction) else Fraction(v)
    if t == Type.MPFR:
        return v.to_fraction()
    # FP64
    f = float(v)
    if f != f or f in (float("inf"), float("-inf")):
        raise SlipIncorrectInputError(f"non-finite fp64 entry {f!r}")
    return Fraction(f)


def round_fraction_to_int(f: Fraction, mode: RoundMode) -> int:
    """Round an exact rational to an integer per the rounding mode."""
    q, r = divmod(f.numerator, f.denominator)  # floor
    if r == 0:
        return q
    if mode == RoundMode.DOWN:
        return q
    if mode == RoundMode.UP:
        return q + 1
    if mode == RoundMode.ZERO:
        return q if f >= 0 else q + 1
    twice = 2 * r
    if twice > f.denominator or (twice == f.denominator and q % 2 == 1):
        return q + 1
    return q


def from_fraction(f: Fraction, t: Type, prec: int, mode: RoundMode) -> Any:
    """Convert an exact rational to a single entry of type t (rounding if lossy)."""
    if t == Type.MPQ:
        return f
    if t == Type.MPZ:
        if f.denominator != 1:
            raise SlipIncorrectInputError(
                f"non-integer value {f} cannot become MPZ without expansion")
        return f.numerator
    if t == Type.MPFR:
        return BigFloat.from_fraction(f, prec, mode)
    if t == Type.FP64:
        return np.float64(f.numerator / f.denominator)
    # INT64: round then bounds-check (reference: slip_cast_array.c int64 path)
    v = round_fraction_to_int(f, mode)
    if not (_INT64_MIN <= v <= _INT64_MAX):
        raise SlipIncorrectInputError(f"value {f} overflows int64")
    return np.int64(v)


# ---------------------------------------------------------------------------
# array-level type conversion (reference: slip_cast_array + slip_expand_*)
# ---------------------------------------------------------------------------

def _fractions_of(x: np.ndarray, t: Type, scale: Fraction) -> List[Fraction]:
    """Represented (original) values: stored / scale, exactly."""
    flat = x.ravel()
    inv = 1 / scale
    return [to_fraction(v, t) * inv for v in flat]


def expand_to_integers(fracs: List[Fraction]):
    """Integerize: find minimal positive s with f*s integral for all f.

    Reference parity: slip_expand_double_array.c (dyadic), slip_expand_
    mpfr_array.c, slip_expand_mpq_array.c (lcm of denominators) — unified
    here because every source type reduces to exact rationals.
    Returns (list_of_ints, scale_fraction).
    """
    s = 1
    for f in fracs:
        s = s * f.denominator // math.gcd(s, f.denominator)  # lcm
    return [int(f * s) for f in fracs], Fraction(s)


def convert_values(x: np.ndarray, src_t: Type, scale: Fraction, dst_t: Type,
                   prec: int, mode: RoundMode):
    """Convert a value array between entry types.

    Returns (new_array_flat, new_scale). The represented values are
    preserved exactly for MPZ/MPQ targets, rounded for MPFR/FP64/INT64.
    """
    shape = x.shape
    fracs = _fractions_of(x, src_t, scale)
    if dst_t == Type.MPZ:
        ints, new_scale = expand_to_integers(fracs)
        out = np.empty(len(ints), dtype=object)
        out[:] = ints
        return out.reshape(shape), new_scale
    out = value_array(dst_t, len(fracs), prec)
    for k, f in enumerate(fracs):
        out[k] = from_fraction(f, dst_t, prec, mode)
    return out.reshape(shape), Fraction(1)


# ---------------------------------------------------------------------------
# kind conversions (performed in the source entry type, exactly)
# ---------------------------------------------------------------------------

def _add(a: Any, b: Any, t: Type, prec: int) -> Any:
    """Sum two entries of the same type (for triplet duplicates)."""
    if t == Type.MPFR:
        return BigFloat.from_fraction(a.to_fraction() + b.to_fraction(), prec)
    if t == Type.INT64:
        return np.int64(int(a) + int(b))
    if t == Type.FP64:
        return np.float64(float(a) + float(b))
    return a + b


def _is_zero(v: Any, t: Type) -> bool:
    if t == Type.MPFR:
        return not bool(v)
    return v == 0


def triplet_to_csc(A: SlipMatrix) -> SlipMatrix:
    """Triplet -> CSC with sorted rows; duplicate entries are summed."""
    order = np.lexsort((A.i, A.j))
    entries = {}
    seq = []
    for k in order:
        key = (int(A.j[k]), int(A.i[k]))
        if key in entries:
            entries[key] = _add(entries[key], A.x[k], A.type, A.prec)
        else:
            entries[key] = A.x[k]
            seq.append(key)
    p = np.zeros(A.n + 1, dtype=np.int64)
    rows, vals = [], []
    for (col, row) in seq:
        p[col + 1] += 1
        rows.append(row)
        vals.append(entries[(col, row)])
    np.cumsum(p, out=p)  # reference parity: slip_cumsum.c
    out = SlipMatrix(Kind.CSC, A.type, A.m, A.n, p=p,
                     i=np.asarray(rows, dtype=np.int64),
                     x=_pack(vals, A.type, A.prec), scale=A.scale, prec=A.prec)
    return out


def csc_to_triplet(A: SlipMatrix) -> SlipMatrix:
    nz = A.nnz()
    j = np.zeros(nz, dtype=np.int64)
    for col in range(A.n):
        j[A.p[col]:A.p[col + 1]] = col
    return SlipMatrix(Kind.TRIPLET, A.type, A.m, A.n,
                      i=A.i[:nz].copy(), j=j, x=A.x[:nz].copy(),
                      scale=A.scale, prec=A.prec)


def csc_to_dense(A: SlipMatrix) -> SlipMatrix:
    out = SlipMatrix.allocate(Kind.DENSE, A.type, A.m, A.n, prec=A.prec)
    out.scale = A.scale
    for col in range(A.n):
        for idx in range(int(A.p[col]), int(A.p[col + 1])):
            out.x[int(A.i[idx]), col] = A.x[idx]
    return out


def dense_to_csc(A: SlipMatrix) -> SlipMatrix:
    """Dense -> CSC, dropping explicit zeros."""
    p = np.zeros(A.n + 1, dtype=np.int64)
    rows, vals = [], []
    for col in range(A.n):
        for row in range(A.m):
            v = A.x[row, col]
            if not _is_zero(v, A.type):
                rows.append(row)
                vals.append(v)
                p[col + 1] += 1
    np.cumsum(p, out=p)
    return SlipMatrix(Kind.CSC, A.type, A.m, A.n, p=p,
                      i=np.asarray(rows, dtype=np.int64) if rows else np.zeros(0, np.int64),
                      x=_pack(vals, A.type, A.prec), scale=A.scale, prec=A.prec)


def _pack(vals, t: Type, prec: int) -> np.ndarray:
    if t == Type.INT64:
        return np.asarray(vals, dtype=np.int64) if len(vals) else np.zeros(0, np.int64)
    if t == Type.FP64:
        return np.asarray(vals, dtype=np.float64) if len(vals) else np.zeros(0, np.float64)
    out = np.empty(len(vals), dtype=object)
    for k, v in enumerate(vals):
        out[k] = v
    return out


def _convert_kind(A: SlipMatrix, kind: Kind) -> SlipMatrix:
    if A.kind == kind:
        return A
    if A.kind == Kind.TRIPLET:
        csc = triplet_to_csc(A)
    elif A.kind == Kind.DENSE:
        csc = dense_to_csc(A)
    else:
        csc = A
    if kind == Kind.CSC:
        return csc
    if kind == Kind.TRIPLET:
        return csc_to_triplet(csc)
    return csc_to_dense(csc)


# ---------------------------------------------------------------------------
# the public entry point (reference: SLIP_matrix_copy)
# ---------------------------------------------------------------------------

def matrix_copy(A: SlipMatrix, kind: Kind, type_: Type,
                options: Optional[Options] = None) -> SlipMatrix:
    """Deep-copy A into any target kind x type (the 15x15 matrix_copy).

    Reference parity: SLIP_matrix_copy.c — this one function covers all
    225 (kind,type) -> (kind,type) pairs. The represented values
    (stored/scale) are preserved exactly for exact targets and rounded per
    options.round for FP64/MPFR/INT64 targets.
    """
    options = options or Options()
    A.check()
    B = _convert_kind(A, kind)
    if B is A:
        # ensure a genuine copy even for same-kind same-type requests
        B = SlipMatrix(A.kind, A.type, A.m, A.n,
                       p=None if A.p is None else A.p.copy(),
                       i=None if A.i is None else A.i.copy(),
                       j=None if A.j is None else A.j.copy(),
                       x=None if A.x is None else A.x.copy(),
                       scale=A.scale, prec=A.prec)
    if B.type == type_ and (type_ != Type.MPFR or B.prec == options.prec):
        B.check()
        return B
    new_x, new_scale = convert_values(B.x, B.type, B.scale, type_,
                                      options.prec, options.round)
    B.x = new_x
    B.scale = new_scale
    B.type = type_
    B.prec = options.prec
    B.check()
    return B
