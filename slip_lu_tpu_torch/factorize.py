"""Host-side exact left-looking REF (roundoff-error-free) LU factorization.

This is the framework's bit-exact oracle and reference-parity core
(reference: SLIP_LU/Source/SLIP_LU_factorize.c — the k-loop driver;
slip_ref_triangular_solve.c — the REF sparse triangular solve with IPGE and
history updates; slip_reach.c / slip_dfs.c — the CSparse-style nonzero
pattern reach; slip_get_pivot.c and friends — the six pivot schemes).

Arbitrary precision comes from Python ints (the reference uses GMP mpz_t).
The factorization computes PAQ = LDU in the REF sense:

    L(:,k) holds x_i^{(k)} for the not-yet-pivotal rows of column q[k]
           (diagonal entry = rho_k),
    U(k,:) holds x_j^{(j')} frozen at each row's own pivot level,
    rhos[k] = the k-th pivot (rho_{-1} := 1), and
    PAQ == L * diag(1 / (rho_{k-1} * rho_k)) * U   exactly.

Every division below is provably exact (integer result) by IPGE theory;
`_exact_div` asserts this in debug builds.

IPGE recurrences used (SURVEY.md section 3.2):
  history:  x_i^{(t)}   = x_i^{(s)} * rho_{t-1} / rho_{s-1}     (skipped levels)
  IPGE:     x_i^{(j+1)} = (rho_j * x_i^{(j)} - L(i,j) * x_j^{(j)}) / rho_{j-1}
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import numpy as np

from .analyze import Analysis
from .errors import (SlipIncorrectInputError, SlipPanicError, SlipSingularError)
from .matrix import Kind, SlipMatrix, Type
from .options import Options, Pivot

_EXACT_CHECK = True  # assert every IPGE division is exact (cheap vs mpz ops)


def _exact_div(a: int, b: int) -> int:
    """Exact integer division (reference: mpz_divexact)."""
    if _EXACT_CHECK and a % b != 0:
        raise SlipPanicError(f"inexact IPGE division {a} / {b}")
    return a // b


@dataclasses.dataclass
class Factorization:
    """Result of REF LU: PAQ = L D U (reference: L, U, rhos, pinv outputs).

    Lcols[k]  : list of (original_row, value) — column k of L, including the
                pivot row whose value is rhos[k]; values are level-k IPGE.
    Ucols[k]  : list of (pivot_order_row, value) — column k of U, row indices
                in pivot order (j' = pinv[original_row]); includes the
                diagonal (k, rhos[k]).
    rhos      : pivot sequence, len n.
    pinv      : original row -> pivot order, len n.
    row_perm  : pivot order -> original row, len n.
    q         : column permutation used (from Analysis).
    scale     : the integerization scale of the factorized matrix.
    """

    n: int
    Lcols: List[List[Tuple[int, int]]]
    Ucols: List[List[Tuple[int, int]]]
    rhos: List[int]
    pinv: np.ndarray
    row_perm: np.ndarray
    q: np.ndarray
    scale: Fraction

    def rho(self, t: int) -> int:
        return 1 if t < 0 else self.rhos[t]

    def lnz(self) -> int:
        return sum(len(c) for c in self.Lcols)

    def unz(self) -> int:
        return sum(len(c) for c in self.Ucols)

    def L_matrix(self) -> SlipMatrix:
        """Export L as CSC x MPZ with original row indices (reference layout)."""
        return _cols_to_csc(self.n, self.Lcols)

    def U_matrix_pivot_rows(self) -> SlipMatrix:
        """Export U as CSC x MPZ with rows in pivot order."""
        return _cols_to_csc(self.n, self.Ucols)


def _cols_to_csc(n: int, cols: List[List[Tuple[int, int]]]) -> SlipMatrix:
    p = np.zeros(n + 1, dtype=np.int64)
    rows: List[int] = []
    vals: List[int] = []
    for k, col in enumerate(cols):
        ordered = sorted(col)
        p[k + 1] = p[k] + len(ordered)
        for r, v in ordered:
            rows.append(r)
            vals.append(v)
    x = np.empty(len(vals), dtype=object)
    x[:] = vals
    return SlipMatrix(Kind.CSC, Type.MPZ, n, n, p=p,
                      i=np.asarray(rows, dtype=np.int64) if rows else np.zeros(0, np.int64),
                      x=x)


# ---------------------------------------------------------------------------
# nonzero-pattern reach (reference: slip_reach.c / slip_dfs.c)
# ---------------------------------------------------------------------------

def _reach(Lcols: List[List[Tuple[int, int]]], pinv: np.ndarray,
           a_rows: List[int]) -> List[int]:
    """Rows reachable from A-column pattern through the graph of L.

    Node i's successors are the rows of L(:, pinv[i]) when i is pivotal
    (pinv[i] >= 0); non-pivotal nodes are leaves. Nonrecursive DFS like the
    reference's CSparse-derived cs_reach/cs_dfs.
    """
    visited = set()
    out: List[int] = []
    for s in a_rows:
        if s in visited:
            continue
        stack: List[Tuple[int, int]] = [(s, 0)]
        visited.add(s)
        while stack:
            node, child_idx = stack.pop()
            jp = int(pinv[node])
            children = Lcols[jp] if jp >= 0 else []
            advanced = False
            while child_idx < len(children):
                child = children[child_idx][0]
                child_idx += 1
                if child not in visited:
                    visited.add(child)
                    stack.append((node, child_idx))
                    stack.append((child, 0))
                    advanced = True
                    break
            if not advanced:
                out.append(node)
    return out


# ---------------------------------------------------------------------------
# pivot selection (reference: slip_get_pivot.c + scheme files)
# ---------------------------------------------------------------------------

def _choose_pivot(cands: List[Tuple[int, int]], diag_row: int,
                  options: Options) -> int:
    """Pick the pivot row among (original_row, value) candidates.

    Deterministic tie-break: smallest original row index. Schemes per
    Options.Pivot docstring; reference: slip_get_smallest_pivot.c /
    slip_get_largest_pivot.c / slip_get_nonzero_pivot.c / slip_get_pivot.c.
    """
    scheme = options.pivot
    diag = next((v for r, v in cands if r == diag_row), None)

    def smallest() -> Tuple[int, int]:
        return min(cands, key=lambda rv: (abs(rv[1]), rv[0]))

    def largest() -> Tuple[int, int]:
        return min(cands, key=lambda rv: (-abs(rv[1]), rv[0]))

    if scheme == Pivot.FIRST_NONZERO:
        return min(r for r, _ in cands)
    if scheme == Pivot.DIAGONAL:
        return diag_row if diag is not None else smallest()[0]
    if scheme == Pivot.SMALLEST:
        return smallest()[0]
    if scheme == Pivot.LARGEST:
        return largest()[0]
    tol = Fraction(options.tol)
    if scheme == Pivot.TOL_SMALLEST:
        if diag is not None and Fraction(abs(diag)) * tol <= abs(smallest()[1]):
            return diag_row
        return smallest()[0]
    if scheme == Pivot.TOL_LARGEST:
        if diag is not None and Fraction(abs(diag)) >= Fraction(abs(largest()[1])) * tol:
            return diag_row
        return largest()[0]
    raise SlipIncorrectInputError(f"unknown pivot scheme {scheme!r}")


# ---------------------------------------------------------------------------
# the factorization driver (reference: SLIP_LU_factorize.c)
# ---------------------------------------------------------------------------

def factorize(A: SlipMatrix, analysis: Analysis,
              options: Optional[Options] = None,
              fixed_r: Optional[np.ndarray] = None,
              max_steps: Optional[int] = None) -> Factorization:
    """Left-looking REF LU of a CSC x MPZ matrix: PAQ = LDU.

    Raises SlipSingularError if some column has no eligible pivot
    (reference returns SLIP_SINGULAR).

    fixed_r, when given, pins the pivot ROW of every step (fixed_r[k] =
    original row index) instead of running the pivot scheme — the exact
    host twin of the device schedules' pinned sequences. Raises
    SlipSingularError at the first pinned pivot that is exactly zero
    (the device paths use this as the truth oracle for their ambiguous
    sing-with-overflow flag state).

    max_steps, when given, stops after that many elimination steps and
    returns the PARTIAL factorization (Lcols/Ucols/rhos of the first
    max_steps columns; row_perm/-1 beyond) — the device drivers' cheap
    value-aware width probe (IPGE entry widths grow ~linearly with
    level, so a truncated run extrapolates the full width).
    """
    options = options or Options()
    options.validate()
    if A.kind != Kind.CSC or A.type != Type.MPZ:
        raise SlipIncorrectInputError("factorize requires a CSC x MPZ matrix "
                                      "(use convert.matrix_copy first)")
    if A.m != A.n:
        raise SlipIncorrectInputError(f"matrix must be square, got {A.m}x{A.n}")
    n = A.n
    q = np.asarray(analysis.q, dtype=np.int64)
    if len(q) != n or sorted(int(v) for v in q) != list(range(n)):
        raise SlipIncorrectInputError("analysis.q is not a permutation of 0..n-1")

    Lcols: List[List[Tuple[int, int]]] = []
    Ucols: List[List[Tuple[int, int]]] = []
    rhos: List[int] = []
    pinv = np.full(n, -1, dtype=np.int64)
    row_perm = np.full(n, -1, dtype=np.int64)

    def rho(t: int) -> int:
        return 1 if t < 0 else rhos[t]

    n_run = n if max_steps is None else min(n, max_steps)
    for k in range(n_run):
        col = int(q[k])
        a_rows = [int(A.i[idx]) for idx in range(int(A.p[col]), int(A.p[col + 1]))]
        a_vals = {int(A.i[idx]): int(A.x[idx])
                  for idx in range(int(A.p[col]), int(A.p[col + 1]))}

        # (1) pattern = reach of A(:,col) in the graph of L  [slip_reach.c]
        pattern = _reach(Lcols, pinv, a_rows)
        # (2) topological processing order: pivotal nodes by increasing
        #     pivot level, non-pivotal last  [pattern sort in ref t-solve]
        pattern.sort(key=lambda r: (int(pinv[r]) if pinv[r] >= 0 else n))

        # (3) scatter the A column
        x: Dict[int, int] = {r: a_vals.get(r, 0) for r in pattern}
        h: Dict[int, int] = {r: -1 for r in pattern}

        # (4) IPGE + history updates over pivotal pattern nodes
        ucol: List[Tuple[int, int]] = []
        for j in pattern:
            jp = int(pinv[j])
            if jp < 0:
                break  # non-pivotal tail (sorted last)
            if x[j] != 0 and h[j] < jp - 1:
                x[j] = _exact_div(x[j] * rho(jp - 1), rho(h[j]))
            h[j] = jp - 1
            if x[j] != 0:
                ucol.append((jp, x[j]))  # U(jp, k), frozen at level jp
                for i, lij in Lcols[jp]:
                    if i == j:
                        continue  # the pivot row of column jp itself
                    if x[i] != 0 and h[i] < jp - 1:
                        x[i] = _exact_div(x[i] * rho(jp - 1), rho(h[i]))
                    x[i] = _exact_div(rho(jp) * x[i] - lij * x[j], rho(jp - 1))
                    h[i] = jp

        # (5) final history: bring non-pivotal entries to level k
        cands: List[Tuple[int, int]] = []
        for i in pattern:
            if pinv[i] >= 0:
                continue
            if x[i] != 0 and h[i] < k - 1:
                x[i] = _exact_div(x[i] * rho(k - 1), rho(h[i]))
            if x[i] != 0:
                cands.append((i, x[i]))

        # (6) pivot  [slip_get_pivot.c]
        if not cands:
            err = SlipSingularError(
                f"column {col} (k={k}) has no eligible pivot")
            err.k = k                 # step index, for block repair
            # unpivoted rows at the failure (the left null space of the
            # leading block is supported on these; schedule_subtree's
            # block repair pairs the dependent column with one of them)
            err.free_rows = [i for i in range(n) if pinv[i] < 0]
            raise err
        if fixed_r is not None:
            piv_row = int(fixed_r[k])
            if all(i != piv_row for i, _ in cands):
                err = SlipSingularError(
                    f"pinned pivot row {piv_row} is exactly zero at k={k}")
                err.k = k
                raise err
        else:
            piv_row = _choose_pivot(cands, diag_row=col, options=options)
        piv_val = x[piv_row]

        # (7) bookkeeping
        rhos.append(piv_val)
        pinv[piv_row] = k
        row_perm[k] = piv_row
        ucol.append((k, piv_val))  # U(k,k) = rho_k
        Ucols.append(ucol)
        Lcols.append([(i, v) for i, v in cands])  # includes pivot row

        if options.print_level >= 2:
            print(f"  k={k} col={col} pivot_row={piv_row} rho={piv_val} "
                  f"|L(:,k)|={len(cands)} |U(:,k)|={len(ucol)}")

    if options.print_level >= 1:
        lnz = sum(len(c) for c in Lcols)
        unz = sum(len(c) for c in Ucols)
        print(f"REF LU done: n={n} lnz={lnz} unz={unz} "
              f"det-bits={abs(rhos[-1]).bit_length()}")

    return Factorization(n=n, Lcols=Lcols, Ucols=Ucols, rhos=rhos,
                         pinv=pinv, row_perm=row_perm, q=q, scale=A.scale)
