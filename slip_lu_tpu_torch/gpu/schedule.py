"""Host symbolic pass: static sparse IPGE schedules for the device.

The reference discovers sparsity dynamically per column (reach/DFS inside
slip_ref_triangular_solve.c, reference: slip_reach.c / slip_dfs.c) because
pivoting with row swaps changes the pattern as it goes. A TPU kernel needs
static shapes, so this pass fixes the pivot sequence *symbolically*
(SURVEY.md §7 design stance): a maximum transversal puts nonzeros on the
diagonal, a fill-reducing ordering is applied, and symbolic right-looking
elimination with diagonal pivots then yields

  * the complete fill pattern of L+U (every value-array slot, static),
  * per-step padded index arrays: the pivot column's rows, the pivot row's
    columns, the update tile, and each participant's *history level* (the
    last step that touched it — IPGE's history bookkeeping, reference: the
    h[] vector of slip_ref_triangular_solve.c, is static because the
    pattern is static),
  * forward-substitution schedules (which RHS rows each step touches and
    their history levels) and back-substitution schedules.

Exact cancellation can zero a scheduled pivot at runtime (the analogue of
SLIP finding no eligible pivot); the device flags it and the driver falls
back to the full-pivoting dense kernel. Any pivot sequence is *exact* —
only fill quality and bit growth differ — and the scheduled sequence
matches the oracle's Pivot.DIAGONAL choice on the permuted matrix, which
is what the parity tests assert.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..errors import SlipIncorrectInputError, SlipSingularError
from ..matrix import Kind, SlipMatrix


def max_transversal(A: SlipMatrix,
                    prefer: Optional[np.ndarray] = None) -> np.ndarray:
    """Row permutation r with A[r[j], j] != 0 for all j (maximum matching).

    Augmenting-path bipartite matching (the role of a zero-free diagonal
    pass; the reference relies on the user's matrix/pivoting instead).
    `prefer` (optional, length n) names a preferred row per column — the
    true diagonal under the fill ordering — claimed in a first pass;
    without it the matching drifts off-diagonal and symbolic fill
    explodes on matrices whose natural pivots ARE the diagonal.
    Raises SlipSingularError if the matrix is structurally singular.
    """
    if A.kind != Kind.CSC:
        raise SlipIncorrectInputError("max_transversal requires CSC")
    n = A.n
    if A.m != n:
        raise SlipIncorrectInputError("square matrix required")
    rows_of_col: List[List[int]] = [
        [int(A.i[idx]) for idx in range(int(A.p[c]), int(A.p[c + 1]))
         if A.x[idx] != 0]
        for c in range(n)
    ]
    match_row = np.full(n, -1, dtype=np.int64)   # row -> col
    match_col = np.full(n, -1, dtype=np.int64)   # col -> row
    if prefer is not None:
        for c in range(n):
            pr = int(prefer[c])
            if 0 <= pr < n and match_row[pr] < 0 and pr in rows_of_col[c]:
                match_row[pr] = c
                match_col[c] = pr

    def augment(c: int, seen: np.ndarray) -> bool:
        for r in rows_of_col[c]:
            if not seen[r]:
                seen[r] = True
                if match_row[r] < 0 or augment(int(match_row[r]), seen):
                    match_row[r] = c
                    match_col[c] = r
                    return True
        return False

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 2 * n + 100))
    try:
        for c in range(n):
            if match_col[c] >= 0:
                continue
            if not augment(c, np.zeros(n, dtype=bool)):
                raise SlipSingularError(
                    "matrix is structurally singular (no full transversal)")
    finally:
        sys.setrecursionlimit(old_limit)
    return match_col  # r[j] = row matched to column j


@dataclasses.dataclass
class SparseSchedule:
    """Static device schedule for one factorization (+ substitution)."""
    n: int
    nnz: int                     # pattern entries of L+U including fill
    row_of: np.ndarray           # [E] row index of each value slot
    col_of: np.ndarray           # [E] column index of each value slot
    init_pos: np.ndarray         # [nnz(A)] slot of each original A entry
    # factorization schedule (pads point at slot E = dummy)
    rmax: int
    cmax: int
    col_pos: np.ndarray          # [n, Rmax] slots of (i,k), i>k
    col_hist: np.ndarray         # [n, Rmax] history index (h+1; 0 = fresh)
    row_pos: np.ndarray          # [n, Cmax] slots of (k,j), j>k
    row_hist: np.ndarray         # [n, Cmax]
    diag_pos: np.ndarray         # [n]
    diag_hist: np.ndarray        # [n]
    tile_pos: np.ndarray         # [n, Rmax, Cmax]
    tile_hist: np.ndarray        # [n, Rmax, Cmax]
    # forward substitution: per step the L-column slots and the RHS rows
    fwd_hist: np.ndarray         # [n, Rmax] history of RHS row i at step k
    fwd_xk_hist: np.ndarray      # [n] history of RHS row k at step k
    # back substitution: U-column slots per step (above-diagonal)
    bwd_pos: np.ndarray          # [n, Umax]
    bwd_row: np.ndarray          # [n, Umax] target RHS row (pad n)
    umax: int
    lnz: int
    unz: int


def build_schedule(A: SlipMatrix, q: np.ndarray,
                   fixed_r: Optional[np.ndarray] = None
                   ) -> Tuple[SparseSchedule, np.ndarray]:
    """Symbolic elimination of A[:, q] with transversal diagonal pivots.

    Returns (schedule, row_perm) where row_perm[k] is the original row of
    A pivoting step k (so B = A[row_perm][:, q] has the pivots on its
    diagonal). The oracle run with Pivot.DIAGONAL on B chooses the same
    pivot sequence — the parity anchor for the sparse device path.

    fixed_r pins the row sequence instead of computing a transversal —
    the cancellation-repair path passes the host oracle's actual
    row_perm, whose pivots are guaranteed nonzero (they are the oracle's
    IPGE pivots), so the rebuilt schedule cannot cancel.
    """
    if A.kind != Kind.CSC:
        raise SlipIncorrectInputError("build_schedule requires CSC")
    n = A.n
    q = np.asarray(q, dtype=np.int64)
    # permuted pattern B = A[r][:, q] with nonzero diagonal
    Aq = _permute_cols(A, q)
    r = (np.asarray(fixed_r, dtype=np.int64) if fixed_r is not None
         else max_transversal(Aq, prefer=q))
    rinv = np.empty(n, dtype=np.int64)
    rinv[r] = np.arange(n)
    # pattern[j] = set of rows of column j of B
    pattern: List[set] = [set() for _ in range(n)]
    entries_A: List[Tuple[int, int]] = []  # (B-row, B-col) per original slot
    for c in range(n):
        for idx in range(int(Aq.p[c]), int(Aq.p[c + 1])):
            br = int(rinv[int(Aq.i[idx])])
            pattern[c].add(br)
            entries_A.append((br, c))
    # symbolic right-looking elimination with diagonal pivots
    cols_of_row: List[set] = [set() for _ in range(n)]
    for c in range(n):
        for i in pattern[c]:
            cols_of_row[i].add(c)
    hist: dict = {}
    slot: dict = {}
    row_of: List[int] = []
    col_of: List[int] = []

    def get_slot(i: int, j: int) -> int:
        key = (i, j)
        s = slot.get(key)
        if s is None:
            s = len(row_of)
            slot[key] = s
            row_of.append(i)
            col_of.append(j)
        return s

    for c in range(n):
        for i in sorted(pattern[c]):
            get_slot(i, c)

    steps_col: List[List[int]] = []
    steps_row: List[List[int]] = []
    steps_tile: List[List[List[int]]] = []
    steps_col_h: List[List[int]] = []
    steps_row_h: List[List[int]] = []
    steps_tile_h: List[List[List[int]]] = []
    diag_pos = np.zeros(n, dtype=np.int32)
    diag_hist = np.zeros(n, dtype=np.int32)
    fwd_hist_list: List[List[int]] = []
    fwd_xk_hist = np.zeros(n, dtype=np.int32)
    rhs_hist = np.zeros(n, dtype=np.int64)  # history level+1 of RHS row i

    for k in range(n):
        if k not in pattern[k]:
            raise SlipSingularError(
                "transversal failed to place a diagonal entry")
        rk = sorted(i for i in pattern[k] if i > k)
        ck = sorted(j for j in cols_of_row[k] if j > k)
        diag_pos[k] = get_slot(k, k)
        diag_hist[k] = hist.get((k, k), 0)
        steps_col.append([get_slot(i, k) for i in rk])
        steps_col_h.append([hist.get((i, k), 0) for i in rk])
        steps_row.append([get_slot(k, j) for j in ck])
        steps_row_h.append([hist.get((k, j), 0) for j in ck])
        tile = []
        tile_h = []
        for i in rk:
            trow = []
            trow_h = []
            for j in ck:
                trow.append(get_slot(i, j))
                trow_h.append(hist.get((i, j), 0))
                # fill-in: (i,j) joins the pattern
                if i not in pattern[j]:
                    pattern[j].add(i)
                    cols_of_row[i].add(j)
                hist[(i, j)] = k + 1          # updated to level k
            tile.append(trow)
            tile_h.append(trow_h)
        steps_tile.append(tile)
        steps_tile_h.append(tile_h)
        for i in rk:
            hist[(i, k)] = k                   # L values fixed at level k-1
        for j in ck:
            hist[(k, j)] = k                   # U values fixed at level k-1
        hist[(k, k)] = k
        # forward substitution histories (RHS rows touched by L(:,k))
        fwd_hist_list.append([int(rhs_hist[i]) for i in rk])
        fwd_xk_hist[k] = rhs_hist[k]
        for i in rk:
            rhs_hist[i] = k + 1
        rhs_hist[k] = k                        # x[k] final at level k-1

    E = len(row_of)
    rmax = max(1, max((len(s) for s in steps_col), default=0))
    cmax = max(1, max((len(s) for s in steps_row), default=0))

    def pad2(lists, width, fill):
        out = np.full((n, width), fill, dtype=np.int32)
        for k, ls in enumerate(lists):
            out[k, :len(ls)] = ls
        return out

    col_pos = pad2(steps_col, rmax, E)
    col_hist = pad2(steps_col_h, rmax, 0)
    row_pos = pad2(steps_row, cmax, E)
    row_hist = pad2(steps_row_h, cmax, 0)
    fwd_hist = pad2(fwd_hist_list, rmax, 0)
    tile_pos = np.full((n, rmax, cmax), E, dtype=np.int32)
    tile_hist = np.zeros((n, rmax, cmax), dtype=np.int32)
    for k in range(n):
        t = steps_tile[k]
        th = steps_tile_h[k]
        for a, (trow, trow_h) in enumerate(zip(t, th)):
            tile_pos[k, a, :len(trow)] = trow
            tile_hist[k, a, :len(trow_h)] = trow_h

    # back substitution: per step j (descending handled by the kernel),
    # the above-diagonal slots of U(:, j)
    bwd_lists: List[List[Tuple[int, int]]] = []
    for j in range(n):
        ent = [(get_slot(i, j), i) for i in sorted(pattern[j]) if i < j]
        bwd_lists.append(ent)
    umax = max(1, max((len(e) for e in bwd_lists), default=0))
    bwd_pos = np.full((n, umax), E, dtype=np.int32)
    bwd_row = np.full((n, umax), n, dtype=np.int32)
    for j, ent in enumerate(bwd_lists):
        for a, (s, i) in enumerate(ent):
            bwd_pos[j, a] = s
            bwd_row[j, a] = i

    lnz = sum(len(s) for s in steps_col) + n
    unz = sum(len(s) for s in steps_row) + n
    init_pos = np.array([slot[e] for e in entries_A], dtype=np.int32)
    sched = SparseSchedule(
        n=n, nnz=E, row_of=np.asarray(row_of, np.int32),
        col_of=np.asarray(col_of, np.int32), init_pos=init_pos,
        rmax=rmax, cmax=cmax,
        col_pos=col_pos, col_hist=col_hist, row_pos=row_pos,
        row_hist=row_hist, diag_pos=diag_pos, diag_hist=diag_hist,
        tile_pos=tile_pos, tile_hist=tile_hist,
        fwd_hist=fwd_hist, fwd_xk_hist=fwd_xk_hist,
        bwd_pos=bwd_pos, bwd_row=bwd_row, umax=umax, lnz=lnz, unz=unz)
    return sched, r


def _permute_cols(A: SlipMatrix, q: np.ndarray) -> SlipMatrix:
    """CSC column permutation B = A[:, q] (pattern + values, shallow-ish)."""
    n = A.n
    B = SlipMatrix.allocate(Kind.CSC, A.type, A.m, n,
                            nzmax=int(A.p[n]))
    pos = 0
    for newc in range(n):
        c = int(q[newc])
        B.p[newc] = pos
        for idx in range(int(A.p[c]), int(A.p[c + 1])):
            B.i[pos] = A.i[idx]
            B.x[pos] = A.x[idx]
            pos += 1
    B.p[n] = pos
    B.nz = pos
    B.scale = A.scale
    return B
