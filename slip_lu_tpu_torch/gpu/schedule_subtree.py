"""Subtree-local factorization streams: deferred determinant scaling.

The serial floor of the fused path is the chunk scan: consecutive
elimination steps conflict on their fix-then-update slots, so chunks
hazard-cut at ~1.5 steps and the scan length tracks n (ROADMAP
"Physics"). This module breaks that chain with the IPGE minor-product
structure (SURVEY §7 hard part 4; the loop being decomposed is the
k-loop of SLIP_LU_factorize.c ~l.100):

  * IPGE values after eliminating a SET of pivots are minors of A —
    independent of elimination order within the set.  Steps whose
    dependency closures are disjoint therefore factor CONCURRENTLY.
  * The dependency forest is built from the static schedule
    (parent(k) = representative of {m > k : m in rows(L(:,k)) or
    cols(U(k,:))}, linked cs_etree-style so every dependency is an
    ancestor).  Disjoint subtrees are packed into G balanced GROUPS;
    the uncovered remainder is the TOP (separator) block.
  * Each group runs its own LOCAL rho chain in a private SMT/GT row
    range [gbase_i .. gbase_i + gsz_i] (row gbase_i = identity, seeded
    by a virtual head; real heads write gbase_i+l+1).  Cross-group
    events share no slots and no table rows, so the chunk packer puts
    up to H independent heads and their events in ONE chunk — the scan
    shortens by ~G for balanced groups.
  * Updates from group i to a TOP slot s accumulate in a 0-initialized
    CLONE slot: by linearity of the IPGE recurrence in the initial
    value, the clone holds the pure contribution z_i (an integer — the
    difference of two exact IPGE sequences).  With det_i = the group's
    last local rho and PD_G = det_1 ... det_G (the rho of the whole
    grouped block), the exact merged value at level |S| is

        v(s) = PD_G * A_ss + sum_i  PD_G * z_i(l_i) / rho^loc_{l_i}

    (z at its last-touched local level l_i; the division is exact).
    Every term is one event of the standard formula: the pristine slot
    scales by SMT[TB]/GT[0], each clone scales IN PLACE by
    SMT[TB]/GT[local row l_i], then accumulates into s via
    A = (-1)-slot, B = clone.  PD_i products are computed in scratch
    slots (two events each: sp_i = -(PD_{i-1} * det_i), PD_i = -sp_i)
    and recorded as chain rows PD_1..PD_G by virtual heads, with
    SMT[TB] = PD_G = rho_{|S|} seeding the TOP chain, which then runs
    the standard global recurrence (rows TB+1 .. TB+T; the determinant
    lives in row R = TB + T, which the driver passes as `ndet`).
  * Group L/U values remain stored at their LOCAL scale (global value
    = PD_{i-1} * local).  The SOLVE stream compensates without any
    relift: forward substitution runs subtree-local with X clones and
    the same merge; the determinant scale (*SMT[R]) leaves group rows
    deflated by PD_{i-1}; back substitution consumes local U slots
    against true x values, keeping every contribution consistently
    deflated, and the final pivot division by the LOCAL rho restores
    the true det*solution exactly.

Structural guarantee used throughout (checked by asserts): a slot
(i, j) with min(i, j) in a group has BOTH endpoints in that group or
its row/col in the top; mixed slots always carry the group index as
the smaller original index, so the grouped reorder preserves the L/U
split and the schedule's per-step arrays stay valid.

Reference behavior reproduced: SLIP_LU_factorize.c +
slip_ref_triangular_solve.c (factor), SLIP_LU_solve.c /
slip_forward_sub.c / slip_back_sub.c (solve) — reorganized into
independent-subtree streams with deferred determinant scaling.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .schedule import SparseSchedule
from .schedule_stream import EventStream, _ChunkBuilder


# ---------------------------------------------------------------------------
# dependency forest + grouping
# ---------------------------------------------------------------------------

def dependency_forest(sched: SparseSchedule) -> np.ndarray:
    """parent[k] such that every m in nbrs(k) = rows(L(:,k)) u
    cols(U(k,:)) is an ancestor of k (cs_etree-style union climb)."""
    n, E = sched.n, sched.nnz
    row_of, col_of = sched.row_of, sched.col_of
    preds: List[List[int]] = [[] for _ in range(n)]
    cp, rp = np.asarray(sched.col_pos), np.asarray(sched.row_pos)
    for k in range(n):
        seen = set()
        for s in cp[k]:
            if s < E:
                seen.add(int(row_of[s]))
        for s in rp[k]:
            if s < E:
                seen.add(int(col_of[s]))
        for m in seen:
            if m > k:
                preds[m].append(k)
    parent = np.full(n, -1, np.int64)
    anc = np.full(n, -1, np.int64)
    for m in range(n):
        for k in preds[m]:
            r = k
            while anc[r] != -1 and anc[r] != m:
                nxt = int(anc[r])
                anc[r] = m
                r = nxt
            if anc[r] == -1:
                anc[r] = m
                parent[r] = m
    return parent


@dataclasses.dataclass
class Grouping:
    group_of: np.ndarray       # [n] group id, -1 = top
    groups: List[np.ndarray]   # ascending original steps per group
    top: np.ndarray            # ascending original steps
    lrank: np.ndarray          # [n] local rank within group / top
    gbase: np.ndarray          # [G] identity gap row per group
    pd_rows: np.ndarray        # [G] rows PD_1..PD_G (pd_rows[-1] = TB)
    TB: int                    # row of rho_{|S|} = PD_G
    R: int                     # determinant row (TB + |top|)


def partition_groups(parent: np.ndarray, n_groups: int = 8,
                     min_gain: float = 1.3) -> Optional[Grouping]:
    """Pack disjoint maximal subtrees into <= n_groups balanced groups.

    Returns None when the forest offers no useful decomposition (pure
    chains, tiny n, or a dominating top) — callers fall back to the
    ungrouped stream."""
    n = len(parent)
    if n < 24:
        return None
    size = np.ones(n, np.int64)
    for k in range(n):
        p = parent[k]
        if p >= 0:
            size[p] += size[k]

    def cut_roots(s_max):
        return [k for k in range(n)
                if size[k] <= s_max
                and (parent[k] < 0 or size[int(parent[k])] > s_max)]

    best = None
    for div in (n_groups, 2 * n_groups, n_groups // 2, 4 * n_groups):
        if div < 2:
            continue
        s_max = max(2, n // div)
        roots = cut_roots(s_max)
        if len(roots) < 2:
            continue
        # greedy balance into n_groups bins
        bins: List[List[int]] = [[] for _ in range(n_groups)]
        load = [0] * n_groups
        for rt in sorted(roots, key=lambda r: -int(size[r])):
            j = int(np.argmin(load))
            bins[j].append(rt)
            load[j] += int(size[rt])
        bins = [b for b in bins if b]
        covered = int(sum(load))
        top_n = n - covered
        # estimated serial scan: top + the heaviest group
        gain = n / max(1.0, top_n + max(load))
        if best is None or gain > best[0]:
            best = (gain, bins)
    if best is None or best[0] < min_gain:
        return None
    _, bins = best

    # children lists -> member sets per bin
    children: List[List[int]] = [[] for _ in range(n)]
    for k in range(n):
        if parent[k] >= 0:
            children[int(parent[k])].append(k)
    group_of = np.full(n, -1, np.int64)
    groups = []
    for gi, bin_roots in enumerate(bins):
        members = []
        stack = list(bin_roots)
        while stack:
            v = stack.pop()
            members.append(v)
            stack.extend(children[v])
        members = np.array(sorted(members), np.int64)
        group_of[members] = gi
        groups.append(members)
    top = np.array([k for k in range(n) if group_of[k] < 0], np.int64)
    lrank = np.zeros(n, np.int64)
    for g in groups:
        lrank[g] = np.arange(len(g))
    lrank[top] = np.arange(len(top))

    G = len(groups)
    gbase = np.zeros(G, np.int64)
    pos = 1
    for i, g in enumerate(groups):
        gbase[i] = pos
        pos += len(g) + 1
    pd_rows = np.arange(pos, pos + G, dtype=np.int64)
    TB = int(pd_rows[-1])
    R = TB + len(top)
    return Grouping(group_of=group_of, groups=groups, top=top,
                    lrank=lrank, gbase=gbase, pd_rows=pd_rows,
                    TB=TB, R=R)


def dissect_order(A, n_groups: int = 8) -> np.ndarray:
    """Recursive 1-D dissection of pattern(A + A^T): order = [left,
    right, separator] at every level; leaves keep their embedding
    (natural) order. Creates an elimination forest whose leaf blocks
    are independent subtrees — food for the grouped builder on
    matrices whose native ordering yields a pure dependency chain.

    The cut runs along a 1-D embedding — the natural index when the
    matrix is banded (the embedding IS the band axis, so leaves stay
    contiguous and their internal fill stays the natural-order fill;
    BFS level sets on a random sparse band are ragged and scramble the
    leaves, measured +55% fill on uni10k), reverse Cuthill-McKee
    otherwise. The separator at a segment midpoint m is the minimal
    adjacency cut {u left of m : u has a live neighbor right of m}.
    Fill quality is still guarded by the caller (schedules under both
    orders are compared before adoption)."""
    n = A.n
    adj: List[List[int]] = [[] for _ in range(n)]
    spread = 0
    for c in range(n):
        for idx in range(int(A.p[c]), int(A.p[c + 1])):
            r2 = int(A.i[idx])
            if r2 != c:
                adj[r2].append(c)
                adj[c].append(r2)
                spread = max(spread, abs(r2 - c))
    if spread > max(64, n // 8):
        # not banded in the natural index: embed with RCM
        try:
            import scipy.sparse as sp
            from scipy.sparse.csgraph import reverse_cuthill_mckee
            rows = np.repeat(np.arange(n), np.diff(np.asarray(A.p)))
            cols = np.asarray(A.i[:int(A.p[n])])
            pat = sp.csr_matrix(
                (np.ones(len(cols), np.int8), (rows, cols)), (n, n))
            pat = pat + pat.T
            vert = np.asarray(reverse_cuthill_mckee(pat.tocsr(),
                                                    symmetric_mode=True),
                              dtype=np.int64)
        except Exception:
            vert = np.arange(n, dtype=np.int64)
    else:
        vert = np.arange(n, dtype=np.int64)
    pos = np.empty(n, np.int64)
    pos[vert] = np.arange(n)
    depth = max(1, int(np.ceil(np.log2(max(2, n_groups)))))
    leaf = max(8, n // (4 * n_groups))
    order: List[int] = []
    excl = np.zeros(n, bool)

    def rec(plo, phi, d):
        if d == 0 or phi - plo <= leaf:
            order.extend(int(vert[p]) for p in range(plo, phi)
                         if not excl[vert[p]])
            return
        m = (plo + phi) // 2
        sep = []
        for p in range(plo, m):
            u = int(vert[p])
            if excl[u]:
                continue
            for w in adj[u]:
                if not excl[w] and m <= pos[w] < phi:
                    sep.append(u)
                    break
        if not sep:
            order.extend(int(vert[p]) for p in range(plo, phi)
                         if not excl[vert[p]])
            return
        for u in sep:
            excl[u] = True
        rec(plo, m, d - 1)
        rec(m, phi, d - 1)
        for u in sep:
            order.append(u)

    rec(0, n, depth)
    assert len(order) == n and len(set(order)) == n
    return np.asarray(order, np.int64)


# ---------------------------------------------------------------------------
# grouped stream emission
# ---------------------------------------------------------------------------

def build_event_stream_grouped(sched: SparseSchedule, gr: Grouping,
                               heads_per_chunk: int = 8,
                               pass1_events: int = 32,
                               pass2_events: int = 128,
                               p: Optional[int] = None):
    """Flatten a schedule into grouped (subtree-local) chunk streams.

    Same single event formula and chunk phases as
    schedule_stream.build_event_stream; mult/div fields index the
    grouped table-row layout and group updates to top slots go through
    clone slots merged by deferred determinant scaling (module
    docstring).

    With p set, builds the CHIP-PARTITIONED form instead (the sharded
    flagship, parallel/stream_shard_fused.py): identical emission order
    and hazard cuts, but events bin into per-chip lists with per-chip
    capacities — the global chunk capacity is p times larger, and with
    G independent groups feeding every chunk the capacity actually
    BINDS (ungrouped streams hazard-cut at ~1.5 elimination steps and
    never fill it). Ownership is cyclic by row, extended to the
    grouped extras so every pass-2 A operand stays on its target's
    chip (the IPGE row-locality argument):
      * clone(s, gi) lives on row(s)'s chip — group events updating it
        read their L operand from the same original row;
      * sp/pd scratch slots live on the chip owning group 1's last
        diagonal (the PD chain's only A-operand entry point);
      * the constant m1 slot is REPLICATED (it is the A operand of
        merge accumulates, whose targets are spread over all chips);
      * one_g constants sit on chip 0 (head/B-broadcast only).
    Returns a ShardedEventStream with ndet/nxx/extra init metadata."""
    n, E0 = sched.n, sched.nnz
    G = len(gr.groups)
    group_of, lrank = gr.group_of, gr.lrank
    gbase, pd_rows, TB, R = gr.gbase, gr.pd_rows, gr.TB, gr.R
    row_of, col_of = sched.row_of, sched.col_of
    cp, rp, tp = (np.asarray(sched.col_pos), np.asarray(sched.row_pos),
                  np.asarray(sched.tile_pos))

    def cur_row(k: int) -> int:
        g = int(group_of[k])
        if g >= 0:
            return int(gbase[g]) + int(lrank[k]) + 1
        return TB + int(lrank[k]) + 1

    # ---- pre-scan: clone allocation (top slots / top x rows touched
    # by groups). Touch sets are per-slot ordered lists of group ids.
    sep_touch: Dict[int, List[int]] = {}
    x_touch: Dict[int, List[int]] = {}
    for gi, g in enumerate(gr.groups):
        for k in g:
            k = int(k)
            for a in range(sched.rmax):
                gl = int(cp[k, a])
                if gl >= E0:
                    continue
                i_row = int(row_of[gl])
                if group_of[i_row] < 0:             # fwd target in top
                    lst = x_touch.setdefault(i_row, [])
                    if not lst or lst[-1] != gi:
                        if gi not in lst:
                            lst.append(gi)
                for b2 in range(sched.cmax):
                    gt = int(tp[k, a, b2])
                    if gt >= E0:
                        continue
                    tr, tc = int(row_of[gt]), int(col_of[gt])
                    if group_of[tr] < 0 and group_of[tc] < 0:
                        lst = sep_touch.setdefault(gt, [])
                        if gi not in lst:
                            lst.append(gi)
                    else:
                        # closure: non-separator targets stay inside
                        # the updating group
                        assert group_of[tr] == gi or group_of[tc] == gi

    # ---- extra value slots -------------------------------------------------
    e_next = E0
    extra_pos: List[int] = []
    extra_vals: List[int] = []

    def new_slot(init: Optional[int] = None) -> int:
        nonlocal e_next
        s = e_next
        e_next += 1
        if init is not None:
            extra_pos.append(s)
            extra_vals.append(init)
        return s

    one_g = [new_slot(1) for _ in range(G)]     # gap virtual-head slots
    m1_slot = new_slot(-1)                      # merge accumulate A-op
    sp_slot = {i: new_slot() for i in range(2, G + 1)}
    pd_slot = {i: new_slot() for i in range(2, G + 1)}
    clone = {(s, gi): new_slot()
             for s, lst in sorted(sep_touch.items()) for gi in lst}
    E = e_next                                  # dummy slot id
    # last step (original index) of each group, its diag slot = det_i
    last_diag = [int(sched.diag_pos[int(g[-1])]) for g in gr.groups]

    hist: Dict[int, int] = {}                   # slot -> current row
    H, C1, C2 = heads_per_chunk, pass1_events, pass2_events
    if p is None:
        fb = _ChunkBuilder(H, C1, C2, E)
    else:
        from ..parallel.stream_shard_fused import _ShardChunkBuilder
        owner = np.zeros(E, np.int64)
        owner[:E0] = np.asarray(row_of[:E0], np.int64) % p
        pd_owner = int(row_of[last_diag[0]]) % p
        for i in range(2, G + 1):
            owner[sp_slot[i]] = pd_owner
            owner[pd_slot[i]] = pd_owner
        owner[m1_slot] = -1                     # replicated constant
        for (s, gi), c in clone.items():
            owner[c] = int(row_of[s]) % p

        def owner_t(s: int) -> int:
            if s >= E:
                return 0
            o = int(owner[s])
            return 0 if o < 0 else o

        fb = _ShardChunkBuilder(p, owner_t, owner_t, H, C1, C2, E)

    # 1. gap identity rows (one virtual skip-fix head per group; their
    # k values are non-adjacent so no chain-refine fires)
    for i in range(G):
        fb.add_head(int(gbase[i]) - 1, one_g[i], int(gbase[i]) - 1)

    def emit_step(k: int) -> None:
        CUR = cur_row(k)
        PREV = CUR - 1
        ds = int(sched.diag_pos[k])
        fb.add_head(PREV, ds, hist.get(ds, 0))
        hist[ds] = CUR
        for pos_row in (cp[k], rp[k]):
            for s in pos_row:
                s = int(s)
                if s >= E0:
                    continue
                h = hist.get(s, 0)
                if h == PREV:
                    continue
                fb.add(s, PREV, h, E, E, pass2=False)
                hist[s] = PREV
        gi = int(group_of[k])
        for a in range(sched.rmax):
            gl = int(cp[k, a])
            if gl >= E0:
                continue
            for b2 in range(sched.cmax):
                gu = int(rp[k, b2])
                gt = int(tp[k, a, b2])
                if gu >= E0 or gt >= E0:
                    continue
                tgt = gt
                if gi >= 0:
                    tr, tc = int(row_of[gt]), int(col_of[gt])
                    if group_of[tr] < 0 and group_of[tc] < 0:
                        tgt = clone[(gt, gi)]
                h = hist.get(tgt, 0)
                if h == PREV:
                    fb.add(tgt, CUR, PREV, gl, gu, pass2=True)
                else:
                    fb.add_fix_update(tgt, PREV, h, CUR, PREV, gl, gu)
                hist[tgt] = CUR

    # 2. group steps, round-robin by local rank (independent heads and
    # events from different groups pack into shared chunks)
    max_g = max(len(g) for g in gr.groups)
    for l in range(max_g):
        for g in gr.groups:
            if l < len(g):
                emit_step(int(g[l]))

    # 3. PD chain: PD_1 = det_1 (row via virtual head on the group-1
    # last diagonal); PD_i = PD_{i-1} * det_i via two scratch events
    fb.add_head(int(pd_rows[0]) - 1, last_diag[0], int(pd_rows[0]) - 1)
    prev_pd = last_diag[0]
    for i in range(2, G + 1):
        fb.add(sp_slot[i], 0, 0, prev_pd, last_diag[i - 1], pass2=True)
        fb.add(pd_slot[i], 0, 0, sp_slot[i], one_g[0], pass2=True)
        fb.add_head(int(pd_rows[i - 1]) - 1, pd_slot[i],
                    int(pd_rows[i - 1]) - 1)
        prev_pd = pd_slot[i]

    # 4. separator merges: pristine scale + in-place clone terms +
    # accumulates (round-robin over slots so accumulates pack)
    sep_slots = sorted(sep_touch)
    for s in sep_slots:
        assert hist.get(s, 0) == 0      # all touches went to clones
        fb.add(s, TB, 0, E, E, pass2=False)
        hist[s] = TB
    live: Dict[int, List[int]] = {}
    for s in sep_slots:
        cl = []
        for gi in sep_touch[s]:
            c = clone[(s, gi)]
            h = hist.get(c, 0)
            if h:                        # untouched clone holds 0: skip
                fb.add(c, TB, h, E, E, pass2=False)
                cl.append(c)
        live[s] = cl
    fold = 0
    while True:
        any_live = False
        for s in sep_slots:
            cl = live[s]
            if fold < len(cl):
                any_live = True
                fb.add(s, 0, 0, m1_slot, cl[fold], pass2=True)
        if not any_live:
            break
        fold += 1

    # 5. top steps (standard global recurrence from rho_{|S|} = SMT[TB])
    for k in gr.top:
        emit_step(int(k))
    factor = fb.finish()

    # ---- solve stream -----------------------------------------------------
    x_clone: Dict[tuple, int] = {}
    x_next = n + 1
    for r, lst in sorted(x_touch.items()):
        for gi in lst:
            x_clone[(r, gi)] = x_next
            x_next += 1
    nxx = x_next - (n + 1)
    xhist: Dict[int, int] = {}
    if p is None:
        sb = _ChunkBuilder(0, C1, C2, n, dummy_a=E, dummy_b=n)
    else:
        # X rows: cyclic by row; clone rows follow their true row's
        # chip (their A operands live in that row)
        xowner = np.zeros(n + 1 + nxx, np.int64)
        xowner[:n] = np.arange(n, dtype=np.int64) % p
        for (r2, gi), xr in x_clone.items():
            xowner[xr] = r2 % p

        def owner_x(i: int) -> int:
            return int(xowner[i]) if i < len(xowner) else 0

        sb = _ShardChunkBuilder(p, owner_x, owner_x, 0, C1, C2, n,
                                dummy_a=E, dummy_b=n)

    def emit_fwd(k: int) -> None:
        CUR = cur_row(k)
        PREV = CUR - 1
        gi = int(group_of[k])
        h = xhist.get(k, 0)
        if h != PREV:
            sb.add(k, PREV, h, E, n, pass2=False)
            xhist[k] = PREV
        for a in range(sched.rmax):
            gl = int(cp[k, a])
            if gl >= E0:
                continue
            i_row = int(row_of[gl])
            tgt = i_row
            if gi >= 0 and group_of[i_row] < 0:
                tgt = x_clone[(i_row, gi)]
            hi = xhist.get(tgt, 0)
            if hi == PREV:
                sb.add(tgt, CUR, PREV, gl, k, pass2=True)
            else:
                sb.add_fix_update(tgt, PREV, hi, CUR, PREV, gl, k)
            xhist[tgt] = CUR

    for l in range(max_g):
        for g in gr.groups:
            if l < len(g):
                emit_fwd(int(g[l]))
    # x merges: every top x row scales to level |S|; touched rows then
    # accumulate their clones' deferred-scaled contributions
    for k in gr.top:
        k = int(k)
        assert xhist.get(k, 0) == 0
        sb.add(k, TB, 0, E, n, pass2=False)
        xhist[k] = TB
    xlive: Dict[int, List[int]] = {}
    for r in sorted(x_touch):
        cl = []
        for gi in x_touch[r]:
            c = x_clone[(r, gi)]
            h = xhist.get(c, 0)
            if h:
                sb.add(c, TB, h, E, n, pass2=False)
                cl.append(c)
        xlive[r] = cl
    fold = 0
    while True:
        any_live = False
        for r in sorted(xlive):
            cl = xlive[r]
            if fold < len(cl):
                any_live = True
                sb.add(r, 0, 0, m1_slot, cl[fold], pass2=True)
        if not any_live:
            break
        fold += 1
    for k in gr.top:
        emit_fwd(int(k))

    sb.barrier()                                 # fwd | det
    for i in range(n):
        sb.add(i, R, 0, E, n, pass2=False)       # x *= det (SMT[R])
    sb.barrier()                                 # det | bwd
    # back substitution: top descending (true values), then groups
    # round-robin descending (deflated-by-PD_{i-1} representation; the
    # local pivot division restores true det*sol — module docstring)
    def emit_bwd(j: int) -> None:
        sb.add(j, 0, cur_row(j), E, n, pass2=False)
        for a in range(sched.umax):
            g2 = int(sched.bwd_pos[j, a])
            if g2 >= E0:
                continue
            sb.add(int(sched.bwd_row[j, a]), 0, 0, g2, j, pass2=True)

    for k in gr.top[::-1]:
        emit_bwd(int(k))
    for l in range(max_g - 1, -1, -1):
        for g in gr.groups:
            if l < len(g):
                emit_bwd(int(g[l]))
    solve = sb.finish()

    # model level per chunk, for the adaptive-width segment planner
    # (plan_segments): a group event at LOCAL level l handles l x l
    # leaf-block minors — same bit-growth rate as global level l — so
    # chain rows map to their local level; PD/merge/top rows pin full
    # width. Monotone by construction (round-robin advances all groups
    # together; merges and top come last).
    lvl = np.zeros(R + 2, np.int64)
    for i, g in enumerate(gr.groups):
        for l in range(len(g) + 1):
            lvl[int(gbase[i]) + l] = l
    lvl[TB:] = n
    for rr in pd_rows:
        lvl[int(rr)] = n

    if p is not None:
        from ..parallel.stream_shard_fused import (ShardedEventStream,
                                                   _partition_value_table,
                                                   sharded_chunk_levels)
        factor.max_level = sharded_chunk_levels(factor, lvl)
        solve.max_level = sharded_chunk_levels(solve, lvl)
        row_all = np.concatenate(
            [row_of, [np.int32(n)]]).astype(np.int32)
        ses = ShardedEventStream(
            n=n, nnz=E, p=p, init_pos=sched.init_pos, row_of=row_all,
            factor=factor, solve=solve, lnz=sched.lnz, unz=sched.unz,
            ndet=R, nxx=nxx)
        _partition_value_table(ses, owner=owner,
                               repl=(m1_slot,),
                               extra_pos=np.asarray(extra_pos, np.int64),
                               extra_vals=list(extra_vals))
        return ses

    for sc in (factor, solve):
        for c in range(sc.nchunks):
            n1 = int(sc.counts[c, 1])
            assert (sc.ev1[c, :n1, 3] == E).all(), c

    def _chunk_levels(sc):
        ml = np.zeros(sc.nchunks, np.int32)
        run = 0
        for c in range(sc.nchunks):
            m = run
            for t in range(sc.h_step.shape[1]):
                k = int(sc.h_step[c, t])
                if k >= 0:
                    m = max(m, int(lvl[k + 1]))
            for ev, ci in ((sc.ev1, 1), (sc.ev2, 2)):
                for e in range(int(sc.counts[c, ci])):
                    m = max(m, int(lvl[int(ev[c, e, 1])]))
            run = m
            ml[c] = m
        return ml

    factor.max_level = _chunk_levels(factor)
    solve.max_level = _chunk_levels(solve)

    row_all = np.concatenate([row_of, [np.int32(n)]]).astype(np.int32)
    return EventStream(n=n, nnz=E, init_pos=sched.init_pos,
                       row_of=row_all, factor=factor, solve=solve,
                       lnz=sched.lnz, unz=sched.unz,
                       ndet=R, nxx=nxx,
                       extra_pos=np.asarray(extra_pos, np.int64),
                       extra_vals=list(extra_vals), grouped=gr)


def pin_rows_per_group(A, q_nd: np.ndarray, r_u: np.ndarray,
                       gr: Grouping, report_bad: bool = False):
    """Repair exact cancellations LOCALLY: factor each group's
    (independent) diagonal block on host with pivoting confined to the
    block, and compose a global pinned row sequence.

    A group's IPGE values are exactly the local block minors (the
    subtree-locality fact this whole module rests on), so local
    nonzero pivots imply nonzero pivots in the global grouped
    elimination. A global fallback pivot (the oracle's SMALLEST over
    the whole column) may grab a SEPARATOR row instead, which couples
    the leaves and destroys both the decomposition and the band fill —
    measured on uni10k: 44 off-diagonal global repairs pushed fill
    26.8K -> 57.5K and killed the partition.

    Top steps keep their transversal rows (a later exact host
    factorization with the composed sequence still certifies them).

    A block can be EXACTLY singular even when the whole matrix is not —
    its missing rank lives in the separator (first seen on uni100k's
    mid leaf: the contiguous sub-band has rank m-1 under EVERY pivot
    choice). With report_bad=True the repair drops the dependent
    column TOGETHER WITH an unpivoted row of the stuck state (for a
    rank-(m-1) block, adj(B) = sigma*u*v^T, so removing row r / col c
    keeps full rank exactly when u_r, v_c != 0: the stuck column has
    v_c != 0 by construction, the unpivoted rows carry the support of
    u) and retries; the demoted (column, row) PAIRS pivot at the top.
    Returns (pair, demoted) where pair maps every group column to its
    pivot row and demoted lists the dropped pairs — or (None, [])
    when unrepairable. report_bad=False keeps the old contract
    (fixed_r array or None, no repair)."""
    from ..analyze import analyze
    from ..errors import SlipSingularError
    from ..factorize import factorize
    from ..matrix import Kind, SlipMatrix, Type
    from ..options import Options, Ordering, Pivot

    n = A.n
    fixed_r = np.asarray(r_u, np.int64).copy()
    opts_loc = Options(order=Ordering.NONE, pivot=Pivot.DIAGONAL)
    demoted: List[tuple] = []
    pair: Dict[int, int] = {}
    for g in gr.groups:
        steps = [int(k) for k in g]
        cols = [int(q_nd[k]) for k in steps]     # original A columns
        rows = [int(r_u[k]) for k in steps]      # row POOL (original)
        while True:
            rpos = {r2: i for i, r2 in enumerate(rows)}
            m = len(cols)
            blk = SlipMatrix.allocate(Kind.CSC, Type.MPZ, m, m,
                                      nzmax=max(1, int(A.p[n])))
            nz = 0
            for j, c2 in enumerate(cols):
                blk.p[j] = nz
                for idx in range(int(A.p[c2]), int(A.p[c2 + 1])):
                    i2 = rpos.get(int(A.i[idx]))
                    if i2 is not None and A.x[idx] != 0:
                        blk.i[nz] = i2
                        blk.x[nz] = A.x[idx]
                        nz += 1
            blk.p[m] = nz
            blk.nz = nz
            try:
                F = factorize(blk, analyze(blk, opts_loc), opts_loc)
                break
            except SlipSingularError as e:
                t = getattr(e, "k", None)
                free = getattr(e, "free_rows", None)
                if not report_bad or t is None or not free \
                        or m <= 2 or len(demoted) > 16:
                    return (None, []) if report_bad else None
                demoted.append((cols[t], rows[int(free[0])]))
                del rows[int(free[0])]
                del steps[t], cols[t]
        for t, k in enumerate(steps):
            pair[cols[t]] = rows[int(F.row_perm[t])]
            fixed_r[k] = rows[int(F.row_perm[t])]
    if report_bad:
        return pair, demoted
    return fixed_r


def try_build_grouped(sched: SparseSchedule, heads_per_chunk: int = 8,
                      pass1_events: int = 32, pass2_events: int = 128,
                      n_groups: int = 8, p: Optional[int] = None):
    """Grouped stream if the dependency forest decomposes usefully,
    else None (caller falls back to the ungrouped builder). With p,
    the chip-partitioned (sharded) form."""
    parent = dependency_forest(sched)
    gr = partition_groups(parent, n_groups=n_groups)
    if gr is None:
        return None
    return build_event_stream_grouped(sched, gr, heads_per_chunk,
                                      pass1_events, pass2_events, p=p)
