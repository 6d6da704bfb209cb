"""Column minimum-degree ordering (the default ordering).

Reference parity: the COLAMD package (reference: COLAMD/Source/colamd.c,
entry colamd_l). COLAMD orders the columns of A by approximate minimum
degree of the graph of A'A *without forming A'A*; this implementation runs
greedy minimum degree over the column-intersection graph built row-wise
(two columns are adjacent iff they share a row), which is exactly the
pattern of A'A. Column ordering only — REF LU takes row choice from
pivoting (SURVEY.md section 2.3).
"""

from __future__ import annotations

import heapq
from typing import List

import numpy as np

from ..errors import SlipIncorrectInputError
from ..matrix import Kind, SlipMatrix


def colamd_order(A: SlipMatrix) -> np.ndarray:
    """Return a fill-reducing column permutation q of a CSC matrix."""
    if A.kind != Kind.CSC:
        raise SlipIncorrectInputError("ordering requires CSC input")
    m, n = A.m, A.n
    if n > 5000:
        # the native quotient-graph engine (native/slip_amd.cpp) is the
        # shipped ordering at scale; this greedy fallback materializes
        # column-intersection edges and is only meant as the oracle on
        # small inputs — make a large silent fallback loud
        import warnings
        warnings.warn(
            f"Python COLAMD fallback on n={n}: build the native "
            "symbolic library (make -C native) for production ordering",
            RuntimeWarning, stacklevel=2)
    # rows-of-column and columns-of-row index lists
    cols_of_row: List[List[int]] = [[] for _ in range(m)]
    for col in range(n):
        for idx in range(int(A.p[col]), int(A.p[col + 1])):
            cols_of_row[int(A.i[idx])].append(col)
    # Dense rows are stripped from adjacency construction (same
    # sqrt-threshold rule as the native engine and the real COLAMD,
    # which never forms A'A): a single dense row would otherwise
    # contribute O(n^2) explicit edges. Dropping a row from SCORING
    # only affects ordering quality, never correctness.
    thresh = max(16, 10 * int(np.sqrt(max(n, 1))))
    scored_rows = [cols for cols in cols_of_row if len(cols) <= thresh]
    # column-intersection adjacency (pattern of A'A on scored rows)
    adj: List[set] = [set() for _ in range(n)]
    for cols in scored_rows:
        for a in cols:
            for b in cols:
                if a != b:
                    adj[a].add(b)
    alive = np.ones(n, dtype=bool)
    degree = np.array([len(s) for s in adj], dtype=np.int64)
    order = np.empty(n, dtype=np.int64)
    heap = [(int(degree[v]), v) for v in range(n)]
    heapq.heapify(heap)
    for k in range(n):
        while True:
            d, v = heapq.heappop(heap)
            if alive[v] and d == degree[v]:
                break
        order[k] = v
        alive[v] = False
        nbrs = [u for u in adj[v] if alive[u]]
        nbr_set = set(nbrs)
        for u in nbrs:
            adj[u].discard(v)
            new = nbr_set - adj[u]
            new.discard(u)
            if new:
                adj[u] |= new
            degree[u] = sum(1 for w in adj[u] if alive[w])
            heapq.heappush(heap, (int(degree[u]), u))
        adj[v] = set()
    return order
