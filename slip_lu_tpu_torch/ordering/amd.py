"""Minimum-degree ordering on the pattern of A + A^T.

Reference parity: the AMD package (reference: AMD/Source/amd_order.c entry
point, amd_1.c forming A+A', amd_2.c the degree-update elimination loop).
This implementation performs greedy minimum-degree elimination on the
symmetrized pattern using an elimination graph with lazy clique formation —
the same objective AMD approximates; any output permutation is *correct*
for REF LU (only fill quality differs), which the ordering tests assert.

The native C++ implementation (native/slip_symbolic.cpp) follows the same
algorithm with indistinguishable output and is used when built; this module
is the always-available fallback and the oracle for its tests.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..errors import SlipIncorrectInputError
from ..matrix import Kind, SlipMatrix


def _sym_adjacency(A: SlipMatrix) -> List[set]:
    """Adjacency sets of A + A^T, no self loops (reference: amd_aat.c)."""
    if A.kind != Kind.CSC:
        raise SlipIncorrectInputError("ordering requires CSC input")
    if A.m != A.n:
        raise SlipIncorrectInputError("AMD requires a square matrix")
    n = A.n
    adj: List[set] = [set() for _ in range(n)]
    for col in range(n):
        for idx in range(int(A.p[col]), int(A.p[col + 1])):
            row = int(A.i[idx])
            if row != col:
                adj[row].add(col)
                adj[col].add(row)
    return adj


def amd_order(A: SlipMatrix) -> np.ndarray:
    """Return a fill-reducing permutation q (applied to columns of A).

    Greedy minimum degree: repeatedly eliminate the vertex of minimum
    degree in the elimination graph of A+A', connecting its neighbors into
    a clique (reference: amd_2.c's elimination loop; we use exact degrees
    where AMD uses approximate ones).
    """
    n = A.n
    adj = _sym_adjacency(A)
    alive = np.ones(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    degree = np.array([len(s) for s in adj], dtype=np.int64)

    import heapq

    heap = [(int(degree[v]), v) for v in range(n)]
    heapq.heapify(heap)
    for k in range(n):
        # pop the minimum-degree still-alive vertex with a current degree
        while True:
            d, v = heapq.heappop(heap)
            if alive[v] and d == degree[v]:
                break
        order[k] = v
        alive[v] = False
        nbrs = [u for u in adj[v] if alive[u]]
        # clique the neighbors (elimination-graph update)
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
