"""Exact rational solve from a REF LU factorization.

Reference parity: ``SLIP_LU_solve.c`` plus its helpers (reference:
slip_permute_b.c, slip_forward_sub.c — the dense-RHS IPGE forward
substitution with history, slip_matrix_mul.c — scale by rho_{n-1},
slip_back_sub.c — exact integer back substitution dividing by the U
diagonal, slip_permute_x.c, slip_matrix_div.c — undo the integerization
scales, and slip_check_solution.c — the term-by-term rational oracle).

Pipeline, exactly as the reference's:
  1. b' = P b                  (rows permuted into pivot order)
  2. y  = REF_forward_sub(L, rhos, b')   with y[k] frozen at level k
  3. y *= rho_{n-1}            (= determinant of the scaled matrix)
  4. xhat = back_sub(U, y)     (all divisions exact integers)
  5. x = Q (xhat / rho_{n-1})  as exact rationals
  6. x *= A.scale / b.scale    (undo integerization of both sides)
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional

import numpy as np

from .convert import matrix_copy, to_fraction
from .errors import SlipIncorrectError, SlipIncorrectInputError
from .factorize import Factorization, _exact_div
from .matrix import Kind, SlipMatrix, Type
from .options import Options


def forward_sub(F: Factorization, v: List[List[int]]) -> None:
    """In-place REF forward substitution on dense columns (pivot-order rows).

    v[t][c] is RHS row t (pivot order), column c. On return v[t][c] is the
    level-t frozen IPGE value (matches U's freeze convention). Reference:
    slip_forward_sub.c (HOT LOOP #2 in SURVEY.md section 3.1).
    """
    n = F.n
    nrhs = len(v[0]) if n else 0
    rho = F.rho
    h = [[-1] * nrhs for _ in range(n)]
    for k in range(n):
        Lk = F.Lcols[k]
        for c in range(nrhs):
            # history: bring v[k] to its freeze level k
            if v[k][c] != 0 and h[k][c] < k - 1:
                v[k][c] = _exact_div(v[k][c] * rho(k - 1), rho(h[k][c]))
            h[k][c] = k - 1
            if v[k][c] == 0:
                continue
            vk = v[k][c]
            for i, lik in Lk:
                t = int(F.pinv[i])
                if t == k:
                    continue  # pivot row itself
                if v[t][c] != 0 and h[t][c] < k - 1:
                    v[t][c] = _exact_div(v[t][c] * rho(k - 1), rho(h[t][c]))
                v[t][c] = _exact_div(rho(k) * v[t][c] - lik * vk, rho(k - 1))
                h[t][c] = k


def back_sub(F: Factorization, v: List[List[int]]) -> None:
    """In-place exact back substitution with U (pivot-order rows).

    Solves U xhat = v; every division by U's diagonal (= rhos) is exact.
    Reference: slip_back_sub.c.
    """
    n = F.n
    nrhs = len(v[0]) if n else 0
    for j in range(n - 1, -1, -1):
        Uj = F.Ucols[j]
        diag = F.rhos[j]
        for c in range(nrhs):
            v[j][c] = _exact_div(v[j][c], diag)
        for r, urj in Uj:
            if r == j:
                continue
            for c in range(nrhs):
                if v[j][c] != 0:
                    v[r][c] -= urj * v[j][c]


def solve(F: Factorization, b: SlipMatrix,
          options: Optional[Options] = None) -> SlipMatrix:
    """Exact solve A x = b given a REF LU of A. Returns DENSE x MPQ x.

    b may be any kind x type; it is converted to DENSE x MPZ internally
    (reference: SLIP_LU_solve.c requires dense mpz RHS). The returned x
    satisfies (A_original) x == (b_original) exactly, where *_original are
    the represented values stored/scale of each matrix.
    """
    options = options or Options()
    n = F.n
    if b.m != n:
        raise SlipIncorrectInputError(f"b has {b.m} rows, matrix has {n}")
    bz = matrix_copy(b, Kind.DENSE, Type.MPZ, options)
    nrhs = bz.n

    # 1. permute rows into pivot order  [slip_permute_b.c]
    v: List[List[int]] = [[int(bz.x[int(F.row_perm[k]), c]) for c in range(nrhs)]
                          for k in range(n)]
    # 2. REF forward substitution  [slip_forward_sub.c]
    forward_sub(F, v)
    # 3. scale by the determinant rho_{n-1}  [slip_matrix_mul.c]
    det = F.rho(n - 1)
    for t in range(n):
        for c in range(nrhs):
            v[t][c] *= det
    # 4. exact back substitution  [slip_back_sub.c]
    back_sub(F, v)
    # 5. rationalize and undo the column permutation  [slip_permute_x.c]
    # 6. undo integerization scales  [slip_matrix_div.c]
    factor = F.scale / bz.scale
    x = SlipMatrix.allocate(Kind.DENSE, Type.MPQ, n, nrhs)
    for k in range(n):
        orig_col = int(F.q[k])
        for c in range(nrhs):
            x.x[orig_col, c] = Fraction(v[k][c], det) * factor
    return x


def check_solution(A: SlipMatrix, x: SlipMatrix, b: SlipMatrix,
                   options: Optional[Options] = None) -> None:
    """Verify A x == b exactly in rational arithmetic.

    Reference parity: slip_check_solution.c — the package's own end-to-end
    oracle, enabled by options.check. Raises SlipIncorrectError on any
    mismatching entry (reference returns SLIP_INCORRECT).
    """
    options = options or Options()
    Ac = matrix_copy(A, Kind.CSC, A.type, options)
    inv_a = 1 / Ac.scale
    inv_b = 1 / b.scale
    inv_x = 1 / x.scale
    bd = matrix_copy(b, Kind.DENSE, b.type, options)
    xd = matrix_copy(x, Kind.DENSE, x.type, options)
    m, nrhs = bd.m, bd.n
    acc = [[Fraction(0)] * nrhs for _ in range(m)]
    for col in range(Ac.n):
        for idx in range(int(Ac.p[col]), int(Ac.p[col + 1])):
            row = int(Ac.i[idx])
            aval = to_fraction(Ac.x[idx], Ac.type) * inv_a
            for c in range(nrhs):
                xv = to_fraction(xd.x[col, c], xd.type) * inv_x
                if xv:
                    acc[row][c] += aval * xv
    for r in range(m):
        for c in range(nrhs):
            bv = to_fraction(bd.x[r, c], bd.type) * inv_b
            if acc[r][c] != bv:
                raise SlipIncorrectError(
                    f"A*x != b at ({r},{c}): {acc[r][c]} vs {bv}")
    if options.print_level >= 1:
        print("check_solution: A*x == b verified exactly")
