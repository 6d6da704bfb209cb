"""Symbolic analysis: fill-reducing ordering + fill estimates.

Reference parity: ``SLIP_LU_analyze.c`` / ``SLIP_LU_analysis_free.c``
(reference: SLIP_LU/Source/SLIP_LU_analyze.c ~l.60 — runs COLAMD (default),
AMD, or the identity on A and stores the column permutation ``q`` plus
``lnz``/``unz`` fill estimates used to pre-size L and U).

The TPU path extends the analysis with a static schedule (see
slip_lu_tpu.tpu); this module is the shared host-side front.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .errors import SlipIncorrectInputError
from .matrix import Kind, SlipMatrix
from .options import Options, Ordering


@dataclasses.dataclass
class Analysis:
    """Reference parity: SLIP_LU_analysis {int64 *q; int64 lnz, unz}."""

    q: np.ndarray       # column permutation, len n
    lnz: int            # estimated nnz(L) (pre-size hint only)
    unz: int            # estimated nnz(U)
    # symbolic state cached by the static-schedule sparse path: pinned
    # pivot rows after a cancellation repair, so repeated solves with the
    # same analysis skip the failed transversal plan (the reference
    # similarly carries symbolic results in SLIP_LU_analysis)
    sparse_fixed_r: "np.ndarray | None" = None


def _col_etree(A: SlipMatrix, q: np.ndarray) -> np.ndarray:
    """Column elimination tree of A[:, q] in STEP indices: parent[k] =
    first later step whose column shares fill with step k's (the tree
    of the Cholesky factor of (A[:, q])' A[:, q]; standard
    path-compression algorithm, cf. native/slip_symbolic.cpp
    slip_col_etree). parent[k] > k or -1 (root)."""
    n = A.n
    p, i = A.p, A.i
    prev = np.full(A.m, -1, dtype=np.int64)
    anc = np.full(n, -1, dtype=np.int64)
    parent = np.full(n, -1, dtype=np.int64)
    for k in range(n):
        col = int(q[k])
        for t in range(int(p[col]), int(p[col + 1])):
            row = int(i[t])
            r = prev[row] if prev[row] >= 0 else k
            while r != -1 and r < k:
                nxt = anc[r]
                anc[r] = k
                if nxt == -1:
                    parent[r] = k
                    break
                r = nxt
            prev[row] = k
    return parent


def etree_interleave(A: SlipMatrix, q: np.ndarray) -> np.ndarray:
    """Reorder q so independent elimination-tree branches interleave.

    Stable sort of the steps by etree LEVEL (leaf height): children
    always precede parents, so the order is topological — the fill of
    the column etree is preserved (the standard Cholesky-fill
    invariance under topological reordering of the etree) — but
    consecutive steps now come from DIFFERENT branches wherever the
    tree branches. The scheduled device paths pack independent pivot
    heads of adjacent steps into one chunk (tpu/schedule_stream.py),
    so bushy etrees get their scan length cut by up to heads_per_chunk
    (SURVEY §7 hard part 4: recover parallelism from the sequential
    k-loop). A pure chain is returned unchanged."""
    n = A.n
    if n <= 2:
        return q
    parent = _col_etree(A, q)
    level = np.zeros(n, dtype=np.int64)
    for j in range(n):                  # parent[j] > j: one pass
        pj = parent[j]
        if pj >= 0 and level[j] + 1 > level[pj]:
            level[pj] = level[j] + 1
    if int(level.max()) + 1 >= n:       # pure chain — no branching
        return q
    return q[np.argsort(level, kind="stable")]


def symbolic_cost_estimate(A: SlipMatrix, q, cap: int):
    """(fill, max_struct) of pattern(A + A') eliminated in order `q` —
    exact symbolic elimination by the first-neighbor merge (each
    eliminated column's remaining structure folds into its etree
    parent), O(fill) set work. Stops early once fill passes `cap`
    (returns cap and the max structure seen so far): only the
    comparison between candidate orderings matters (Ordering.AUTO).
    max_struct bounds the per-step pattern width, which is what the
    scheduled device paths PAD to (tile tables are n x rmax x cmax —
    an ordering with small fill but a few wide steps can cost orders
    of magnitude more memory/events there than a wider-fill banded
    order; measured: AMD on uni100k, est_fill 110K vs natural 251K,
    blows the padded schedule past 40 GB)."""
    n = A.n
    inv = np.empty(n, np.int64)
    inv[np.asarray(q, np.int64)] = np.arange(n)
    adj = [set() for _ in range(n)]
    for col in range(n):
        jc = int(inv[col])
        for idx in range(int(A.p[col]), int(A.p[col + 1])):
            jr = int(inv[int(A.i[idx])])
            if jr > jc:
                adj[jc].add(jr)
            elif jr < jc:
                adj[jr].add(jc)
    fill = 0
    ms = 0
    for j in range(n):
        s = adj[j]
        fill += len(s)
        ms = max(ms, len(s))
        if fill > cap:
            return cap, ms
        if s:
            m = min(s)
            s.discard(m)
            adj[m] |= s
        adj[j] = None
    return fill, ms


def identity_fill_estimate(A: SlipMatrix, cap: int) -> int:
    """Natural-order fill (see symbolic_cost_estimate)."""
    return symbolic_cost_estimate(A, np.arange(A.n, dtype=np.int64), cap)[0]


def _auto_order(A: SlipMatrix, options: Options):
    """Ordering.AUTO: minimize a schedule-aware cost over
    COLAMD / AMD / identity (see Ordering docstring):

        cost = exact symbolic fill + n * max_struct^2 / 16

    The quadratic max_struct term is the padded-schedule proxy — the
    device paths pad every step to the widest step's pattern
    (tile_pos is n x rmax x cmax), so one dense-ish supernode late in
    a low-fill ordering costs more than a uniformly banded order with
    more total fill. Exact counts are capped at 4x the best
    quotient-graph estimate, so a bad candidate costs O(best) work."""
    from .ordering.native import amd_order_best, colamd_order_best
    n = A.n
    cands = []
    qc, ec = colamd_order_best(A, want_fill=True)
    if ec is not None:
        cands.append((int(ec), 1, qc))
    qa, ea = amd_order_best(A, want_fill=True)
    if ea is not None:
        cands.append((int(ea), 2, qa))
    if not cands:
        # native engine unavailable: keep the reference default
        return qc, None
    cap = 4 * min(c[0] for c in cands) + n
    scored = []
    for _est, code, qq in cands:
        fill, ms = symbolic_cost_estimate(A, qq, cap)
        scored.append((fill + n * ms * ms // 16, code, qq, fill))
    fi, mi = symbolic_cost_estimate(A, np.arange(n, dtype=np.int64), cap)
    # ties prefer the identity (code 0): no permutation, natural
    # structure preserved
    scored.append((fi + n * mi * mi // 16, 0, np.arange(n, dtype=np.int64),
                   fi))
    _cost, code, q, est = min(scored, key=lambda c: (c[0], c[1]))
    if options.print_level >= 1:
        picked = {0: "NONE", 1: "COLAMD", 2: "AMD"}[code]
        print(f"analyze: AUTO ordering -> {picked} (fill {est}, "
              f"cost {_cost})")
    return q, est


def analyze(A: SlipMatrix, options: Optional[Options] = None) -> Analysis:
    """Compute the column ordering for REF LU (reference: SLIP_LU_analyze)."""
    options = options or Options()
    options.validate()
    if A.kind != Kind.CSC:
        raise SlipIncorrectInputError("analyze requires a CSC matrix")
    if A.m != A.n:
        raise SlipIncorrectInputError(f"matrix must be square, got {A.m}x{A.n}")
    n = A.n
    if n == 0:
        return Analysis(q=np.zeros(0, dtype=np.int64), lnz=0, unz=0)

    est_fill = None
    if options.order == Ordering.NONE:
        q = np.arange(n, dtype=np.int64)
    elif options.order == Ordering.AMD:
        from .ordering.native import amd_order_best
        q, est_fill = amd_order_best(A, want_fill=True)
    elif options.order == Ordering.COLAMD:
        from .ordering.native import colamd_order_best
        q, est_fill = colamd_order_best(A, want_fill=True)
    elif options.order == Ordering.AUTO:
        q, est_fill = _auto_order(A, options)
    else:
        raise SlipIncorrectInputError(f"unknown ordering {options.order!r}")

    # Fill estimates: the reference seeds these from the ordering's stats
    # (AMD Info[AMD_LNZ], reference SLIP_LU_analyze.c) and grows L/U
    # dynamically when exceeded (slip_sparse_realloc.c). The native
    # quotient-graph engine reports the same statistic (sum of pivot
    # degrees x supervariable weights, native/slip_amd.cpp); the
    # reference's formula remains the fallback when the ordering ran
    # without the native library (est_fill is None) or was the identity.
    nnz = A.nnz()
    cap = n * (n + 1) // 2
    if est_fill is not None:
        # est_fill counts strictly-sub-diagonal fill; lnz/unz include
        # the diagonal, like the reference's Info[AMD_LNZ] + n seeding
        guess = min(int(est_fill) + n, cap)
    else:
        guess = min(int(10 + 2 * nnz + n), cap)
    analysis = Analysis(q=q, lnz=guess, unz=guess)
    if options.print_level >= 1:
        print(f"analyze: n={n} nnz={nnz} order={options.order.name} "
              f"lnz~{analysis.lnz} unz~{analysis.unz}")
    return analysis
