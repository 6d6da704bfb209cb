"""The polymorphic sparse/dense matrix object.

Reference parity: ``SLIP_matrix`` (reference: SLIP_LU/Include/SLIP_LU.h
~l.150-450; SLIP_matrix_allocate.c / SLIP_matrix_free.c / SLIP_matrix_nnz.c /
SLIP_matrix_check.c). A matrix is a {kind} x {type} pair:

  kind in {CSC, TRIPLET, DENSE}        (reference: SLIP_kind)
  type in {MPZ, MPQ, MPFR, INT64, FP64} (reference: SLIP_type)

giving the same 15 combinations. Value storage:

  MPZ   -> numpy object array of Python int        (GMP mpz_t equivalent)
  MPQ   -> numpy object array of fractions.Fraction (mpq_t equivalent)
  MPFR  -> numpy object array of BigFloat           (mpfr_t equivalent)
  INT64 -> numpy int64 array
  FP64  -> numpy float64 array

``scale`` is the exact rational factor recorded by integerization
(reference: the mpq_t ``scale`` member; see slip_expand_*_array.c):
``stored_values == original_values * scale``. Identity scale is 1.

Memory management notes: the reference's allocate/free pair and shallow
flags exist to manage C ownership (SLIP_matrix_allocate.c ~l.50 onward);
in this framework numpy/GC owns storage, so ``free`` is a no-op kept only
for API parity, and "shallow" corresponds to passing arrays without copy.
"""

from __future__ import annotations

import dataclasses
import enum
from fractions import Fraction
from typing import Any, Optional

import numpy as np

from .bigfloat import BigFloat
from .errors import SlipIncorrectInputError
from .options import Options


class Kind(enum.IntEnum):
    """Storage kinds (reference: SLIP_kind enum)."""

    CSC = 0
    TRIPLET = 1
    DENSE = 2


class Type(enum.IntEnum):
    """Entry types (reference: SLIP_type enum)."""

    MPZ = 0     # exact integers (Python int)
    MPQ = 1     # exact rationals (Fraction)
    MPFR = 2    # arbitrary-precision binary float (BigFloat)
    INT64 = 3
    FP64 = 4


def _zero(t: Type, prec: int = 128) -> Any:
    if t == Type.MPZ:
        return 0
    if t == Type.MPQ:
        return Fraction(0)
    if t == Type.MPFR:
        return BigFloat(0, 0, prec)
    if t == Type.INT64:
        return np.int64(0)
    return np.float64(0.0)


def value_array(t: Type, n: int, prec: int = 128) -> np.ndarray:
    """Allocate a zero-filled value array of length n for entry type t.

    Reference parity: slip_create_mpz_array.c / slip_create_mpq_array.c /
    slip_create_mpfr_array.c (and plain calloc for int64/fp64).
    """
    if t == Type.INT64:
        return np.zeros(n, dtype=np.int64)
    if t == Type.FP64:
        return np.zeros(n, dtype=np.float64)
    arr = np.empty(n, dtype=object)
    z = _zero(t, prec)
    arr[:] = [z] * n
    return arr


@dataclasses.dataclass
class SlipMatrix:
    """Kind x Type polymorphic matrix (reference: SLIP_matrix struct).

    CSC:     p[n+1] column pointers, i[nnz] row indices, x[nnz] values.
    TRIPLET: i[nz] rows, j[nz] cols, x[nz] values.
    DENSE:   x is an (m, n) 2-D array (row index first).
    """

    kind: Kind
    type: Type
    m: int
    n: int
    p: Optional[np.ndarray] = None        # int64[n+1], CSC only
    i: Optional[np.ndarray] = None        # int64[nnz] (CSC) or int64[nz] (triplet)
    j: Optional[np.ndarray] = None        # int64[nz], triplet only
    x: Optional[np.ndarray] = None        # values; 2-D (m,n) for DENSE
    scale: Fraction = Fraction(1)
    prec: int = 128                       # significant bits for MPFR entries

    # ---- constructors (reference: SLIP_matrix_allocate.c) -----------------

    @staticmethod
    def allocate(kind: Kind, type_: Type, m: int, n: int, nzmax: int = 0,
                 prec: int = 128) -> "SlipMatrix":
        if m < 0 or n < 0 or nzmax < 0:
            raise SlipIncorrectInputError(f"bad dimensions m={m} n={n} nzmax={nzmax}")
        A = SlipMatrix(kind=kind, type=type_, m=m, n=n, prec=prec)
        if kind == Kind.CSC:
            A.p = np.zeros(n + 1, dtype=np.int64)
            A.i = np.zeros(nzmax, dtype=np.int64)
            A.x = value_array(type_, nzmax, prec)
        elif kind == Kind.TRIPLET:
            A.i = np.zeros(nzmax, dtype=np.int64)
            A.j = np.zeros(nzmax, dtype=np.int64)
            A.x = value_array(type_, nzmax, prec)
        else:  # DENSE
            A.x = value_array(type_, m * n, prec).reshape(m, n)
        return A

    @staticmethod
    def from_csc(m: int, n: int, p, i, x, type_: Type,
                 scale: Fraction = Fraction(1), prec: int = 128) -> "SlipMatrix":
        A = SlipMatrix(Kind.CSC, type_, m, n,
                       p=np.asarray(p, dtype=np.int64),
                       i=np.asarray(i, dtype=np.int64),
                       x=_coerce_values(x, type_, prec),
                       scale=Fraction(scale), prec=prec)
        A.check()
        return A

    @staticmethod
    def from_triplet(m: int, n: int, i, j, x, type_: Type,
                     scale: Fraction = Fraction(1), prec: int = 128) -> "SlipMatrix":
        A = SlipMatrix(Kind.TRIPLET, type_, m, n,
                       i=np.asarray(i, dtype=np.int64),
                       j=np.asarray(j, dtype=np.int64),
                       x=_coerce_values(x, type_, prec),
                       scale=Fraction(scale), prec=prec)
        A.check()
        return A

    @staticmethod
    def from_dense(x, type_: Type, scale: Fraction = Fraction(1),
                   prec: int = 128) -> "SlipMatrix":
        arr = np.asarray(x, dtype=object) if type_ in (Type.MPZ, Type.MPQ, Type.MPFR) \
            else np.asarray(x, dtype=np.int64 if type_ == Type.INT64 else np.float64)
        if arr.ndim == 1:
            arr = arr.reshape(-1, 1)
        if arr.ndim != 2:
            raise SlipIncorrectInputError(f"dense input must be 1-D or 2-D, got ndim={arr.ndim}")
        m, n = arr.shape
        A = SlipMatrix(Kind.DENSE, type_, m, n, x=arr, scale=Fraction(scale), prec=prec)
        A.check()
        return A

    # ---- basic queries ----------------------------------------------------

    def nnz(self) -> int:
        """Number of stored entries (reference: SLIP_matrix_nnz.c)."""
        if self.kind == Kind.CSC:
            return int(self.p[self.n])
        if self.kind == Kind.TRIPLET:
            return len(self.i)
        return self.m * self.n

    @property
    def shape(self):
        return (self.m, self.n)

    # ---- validation (reference: SLIP_matrix_check.c) ----------------------

    def check(self, option: Optional[Options] = None) -> None:
        """Validate structural invariants; raise SlipIncorrectInputError if bad.

        Mirrors SLIP_matrix_check.c: dimensions nonnegative, column pointers
        monotone starting at 0, indices in range, consistent array lengths,
        value dtype matching declared type. At option.print_level > 0,
        pretty-prints the matrix like the reference does.
        """
        if self.m < 0 or self.n < 0:
            raise SlipIncorrectInputError(f"negative dimension ({self.m}, {self.n})")
        if self.scale <= 0:
            raise SlipIncorrectInputError(f"scale must be positive, got {self.scale}")
        if self.kind == Kind.CSC:
            if self.p is None or self.i is None or self.x is None:
                raise SlipIncorrectInputError("CSC matrix missing p/i/x")
            if len(self.p) != self.n + 1:
                raise SlipIncorrectInputError(f"p has length {len(self.p)}, expected n+1={self.n + 1}")
            if self.p[0] != 0:
                raise SlipIncorrectInputError("p[0] != 0")
            if np.any(np.diff(self.p) < 0):
                raise SlipIncorrectInputError("column pointers not monotone")
            nz = int(self.p[self.n])
            if len(self.i) < nz or len(self.x) < nz:
                raise SlipIncorrectInputError("i/x shorter than p[n]")
            if nz > 0 and (self.i[:nz].min() < 0 or self.i[:nz].max() >= self.m):
                raise SlipIncorrectInputError("row index out of range")
        elif self.kind == Kind.TRIPLET:
            if self.i is None or self.j is None or self.x is None:
                raise SlipIncorrectInputError("triplet matrix missing i/j/x")
            if not (len(self.i) == len(self.j) == len(self.x)):
                raise SlipIncorrectInputError("triplet arrays of unequal length")
            if len(self.i) > 0:
                if self.i.min() < 0 or self.i.max() >= self.m:
                    raise SlipIncorrectInputError("triplet row index out of range")
                if self.j.min() < 0 or self.j.max() >= self.n:
                    raise SlipIncorrectInputError("triplet col index out of range")
        else:
            if self.x is None or self.x.ndim != 2 or self.x.shape != (self.m, self.n):
                raise SlipIncorrectInputError("dense x must have shape (m, n)")
        _check_value_types(self.x, self.type)
        if option is not None and option.print_level > 0:
            print(self.pretty(option.print_level))

    # ---- printing ---------------------------------------------------------

    def pretty(self, level: int = 1) -> str:
        kinds = {Kind.CSC: "CSC", Kind.TRIPLET: "triplet", Kind.DENSE: "dense"}
        types = {Type.MPZ: "mpz", Type.MPQ: "mpq", Type.MPFR: "mpfr",
                 Type.INT64: "int64", Type.FP64: "fp64"}
        head = (f"SlipMatrix {kinds[self.kind]} x {types[self.type]}: "
                f"{self.m}-by-{self.n}, nnz={self.nnz()}, scale={self.scale}")
        if level < 2:
            return head
        lines = [head]
        limit = None if level >= 3 else 20
        if self.kind == Kind.CSC:
            count = 0
            for col in range(self.n):
                for idx in range(int(self.p[col]), int(self.p[col + 1])):
                    lines.append(f"  ({int(self.i[idx])},{col}) = {self.x[idx]}")
                    count += 1
                    if limit and count >= limit:
                        lines.append("  ...")
                        return "\n".join(lines)
        elif self.kind == Kind.TRIPLET:
            for idx in range(min(len(self.i), limit or len(self.i))):
                lines.append(f"  ({int(self.i[idx])},{int(self.j[idx])}) = {self.x[idx]}")
            if limit and len(self.i) > limit:
                lines.append("  ...")
        else:
            lines.append(str(self.x if limit is None else self.x[:5, :5]))
        return "\n".join(lines)

    # ---- API-parity no-op (GC owns memory) --------------------------------

    def free(self) -> None:
        """Reference parity with SLIP_matrix_free; storage is GC-managed."""
        self.p = self.i = self.j = self.x = None


def _coerce_values(x, type_: Type, prec: int) -> np.ndarray:
    if type_ == Type.INT64:
        return np.asarray(x, dtype=np.int64)
    if type_ == Type.FP64:
        return np.asarray(x, dtype=np.float64)
    arr = np.empty(len(x), dtype=object)
    for k, v in enumerate(x):
        arr[k] = _coerce_scalar(v, type_, prec)
    return arr


def _coerce_scalar(v: Any, type_: Type, prec: int) -> Any:
    if type_ == Type.MPZ:
        if isinstance(v, (int, np.integer)):
            return int(v)
        raise SlipIncorrectInputError(f"MPZ entry must be an integer, got {type(v).__name__}")
    if type_ == Type.MPQ:
        if isinstance(v, Fraction):
            return v
        if isinstance(v, (int, np.integer)):
            return Fraction(int(v))
        if isinstance(v, float):
            return Fraction(v)
        raise SlipIncorrectInputError(f"MPQ entry must be Fraction/int/float, got {type(v).__name__}")
    # MPFR
    if isinstance(v, BigFloat):
        return v
    if isinstance(v, (int, np.integer)):
        return BigFloat.from_int(int(v), prec)
    if isinstance(v, float):
        return BigFloat.from_float(v, prec)
    if isinstance(v, Fraction):
        return BigFloat.from_fraction(v, prec)
    raise SlipIncorrectInputError(f"MPFR entry must be BigFloat/num, got {type(v).__name__}")


def _check_value_types(x: Optional[np.ndarray], t: Type) -> None:
    if x is None:
        return
    if t == Type.INT64 and x.dtype != np.int64:
        raise SlipIncorrectInputError(f"INT64 matrix with dtype {x.dtype}")
    if t == Type.FP64 and x.dtype != np.float64:
        raise SlipIncorrectInputError(f"FP64 matrix with dtype {x.dtype}")
    if t in (Type.MPZ, Type.MPQ, Type.MPFR) and x.dtype != object:
        raise SlipIncorrectInputError(f"{t.name} matrix must use object storage, got {x.dtype}")
