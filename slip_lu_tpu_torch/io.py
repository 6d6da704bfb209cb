"""Matrix and RHS text I/O in the reference's ExampleMats format.

Reference parity: the Demo helpers ``SLIP_tripread`` / ``SLIP_read_dense``
(reference: SLIP_LU/Demo/demos.h and Demo helper sources): a matrix file is
triplet text — first line ``m n nnz``, then nnz lines ``i j x`` — and an RHS
file is dense text — first line ``m n``, then m*n values row-major. Indices
in the reference corpus are 1-based; this reader auto-detects 0- vs 1-based
(like SuiteSparse readers: if any index equals m or n, it must be 1-based;
if any equals 0 it must be 0-based; default 1-based for corpus parity).

Values are parsed exactly: integer tokens become MPZ, rational ``p/q``
tokens become MPQ, decimal/float tokens become FP64.
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional, TextIO, Union

import numpy as np

from .errors import SlipIncorrectInputError
from .matrix import Kind, SlipMatrix, Type


def _tokenize(f: TextIO) -> List[List[str]]:
    rows = []
    for line in f:
        line = line.split("%")[0].split("#")[0].strip()
        if line:
            rows.append(line.split())
    return rows


def _classify(tokens: List[str]) -> Type:
    saw_rational = saw_float = False
    for t in tokens:
        if "/" in t:
            saw_rational = True
        elif any(c in t for c in ".eE") and not t.lstrip("+-").isdigit():
            saw_float = True
    if saw_rational:
        return Type.MPQ
    if saw_float:
        return Type.FP64
    return Type.MPZ


def _parse_value(tok: str, t: Type):
    if t == Type.MPQ:
        return Fraction(tok)
    if t == Type.FP64:
        return float(tok)
    return int(tok)


def read_triplet(path_or_file: Union[str, TextIO], one_based: Optional[bool] = None) -> SlipMatrix:
    """Read a triplet matrix file (reference: SLIP_tripread). Returns CSC."""
    if isinstance(path_or_file, str):
        with open(path_or_file) as f:
            rows = _tokenize(f)
    else:
        rows = _tokenize(path_or_file)
    if not rows or len(rows[0]) < 3:
        raise SlipIncorrectInputError("triplet file missing 'm n nnz' header")
    m, n, nnz = int(rows[0][0]), int(rows[0][1]), int(rows[0][2])
    body = rows[1:]
    if len(body) < nnz:
        raise SlipIncorrectInputError(f"expected {nnz} entries, file has {len(body)}")
    body = body[:nnz]
    val_type = _classify([r[2] for r in body]) if body else Type.MPZ
    ii = np.array([int(r[0]) for r in body], dtype=np.int64)
    jj = np.array([int(r[1]) for r in body], dtype=np.int64)
    xx = [_parse_value(r[2], val_type) for r in body]
    if one_based is None:
        if len(ii) == 0:
            one_based = True
        elif ii.max() >= m + 1 or jj.max() >= n + 1:
            raise SlipIncorrectInputError("index out of range for both 0- and 1-based")
        elif (ii == 0).any() or (jj == 0).any():
            one_based = False
        else:
            one_based = True  # corpus default
    if one_based:
        ii = ii - 1
        jj = jj - 1
    from .convert import triplet_to_csc

    T = SlipMatrix.from_triplet(m, n, ii, jj, xx, val_type)
    return triplet_to_csc(T)


def read_dense(path_or_file: Union[str, TextIO]) -> SlipMatrix:
    """Read a dense matrix/RHS file (reference: SLIP_read_dense)."""
    if isinstance(path_or_file, str):
        with open(path_or_file) as f:
            rows = _tokenize(f)
    else:
        rows = _tokenize(path_or_file)
    if not rows or len(rows[0]) < 2:
        raise SlipIncorrectInputError("dense file missing 'm n' header")
    m, n = int(rows[0][0]), int(rows[0][1])
    toks: List[str] = [t for r in rows[1:] for t in r]
    if len(toks) < m * n:
        raise SlipIncorrectInputError(f"expected {m * n} values, file has {len(toks)}")
    toks = toks[: m * n]
    val_type = _classify(toks) if toks else Type.MPZ
    vals = [_parse_value(t, val_type) for t in toks]
    arr = np.empty((m, n), dtype=object if val_type != Type.FP64 else np.float64)
    k = 0
    for r in range(m):
        for c in range(n):
            arr[r, c] = vals[k]
            k += 1
    return SlipMatrix.from_dense(arr, val_type)


def write_triplet(A: SlipMatrix, path: str, one_based: bool = True) -> None:
    """Write a matrix as triplet text in the reference's format."""
    from .convert import matrix_copy

    T = matrix_copy(A, Kind.TRIPLET, A.type)
    off = 1 if one_based else 0
    with open(path, "w") as f:
        f.write(f"{T.m} {T.n} {len(T.i)}\n")
        for k in range(len(T.i)):
            f.write(f"{int(T.i[k]) + off} {int(T.j[k]) + off} {T.x[k]}\n")


def write_dense(A: SlipMatrix, path: str) -> None:
    from .convert import matrix_copy

    D = matrix_copy(A, Kind.DENSE, A.type)
    with open(path, "w") as f:
        f.write(f"{D.m} {D.n}\n")
        for r in range(D.m):
            f.write(" ".join(str(D.x[r, c]) for c in range(D.n)) + "\n")
