"""Chip-partitioned uniform-event chunk streams (the sharded fused path).

The multi-chip form of the flagship fused mega-kernel (SURVEY §7 steps
4-5; the loop being distributed is SLIP_LU_factorize.c's left-looking
k-loop). The single-chip stream (tpu/schedule_stream.py) flattens the
whole factorization/solve into chunks of one uniform formula; here the
SAME chunk sequence is built with its events PARTITIONED by row owner
(cyclic: owner(row) = row % p, rows in pivot order — the block-row
partition of SURVEY §2.10), so every chip executes its own slice of
every chunk and the per-chunk communication is tiny and structured:

  per chunk (the sharded superstep, parallel/factor_fused_shard.py):
    1. psum#1 — the chunk's pivot DIAG values ([H, W8], owner-masked:
       only the owner's copy is current, it received all IPGE updates);
    2. phase A REPLICATED — every chip runs the identical head chain
       (fix diag, record rho, Hensel-lift) from the broadcast diags, so
       the rho/inverse tables stay bit-identical everywhere with no
       further traffic (same trick as parallel/factor_sparse_shard.py);
    3. pass 1 LOCAL — history fixes of chip-owned slots;
    4. psum#2 — the chunk's pass-2 B operands ([CB, W8], owner-masked,
       post-fix values: the pivot-row slots / solve X rows the update
       formula reads);
    5. pass 2 LOCAL — the O(W^2) bulk, every target chip-local, A
       operands in the target's own row by IPGE structure.

Scaling comes from CAPACITY: each chip packs up to (C1, C2) events per
chunk, so the global chunk capacity is p times the single-chip one and
the chunk count (the serial scan length, where all fixed costs live)
drops by up to p for event-bound streams. Head-bound streams keep their
serial rho chain (heads are replicated, not sharded) — the same floor
the single-chip path has.

Hazard rules are exactly the single-chip builder's: the sharded phase
order (A -> pass1 -> broadcast -> pass2) preserves the single-chip
execution semantics chunk for chunk, so the same cuts make all
reads/writes conflict-free; integer psums make every topology
bit-identical to the single-chip kernel.

The value table is PARTITIONED, not replicated: each chip stores only
its owned rows' slots (driver_fused.py builds the [p, Lp8, W8] owned
layout, slots remapped per chip). Pass-2 B operands are read from the
psum broadcast buffer by position, so remote rows' values are never
stored locally; only pivot diagonals and B operands travel.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..gpu.schedule import SparseSchedule


@dataclasses.dataclass
class ShardedChunks:
    """One phase-structured chunk stream, chip-partitioned."""
    h_step: np.ndarray    # [nc, H] head steps (replicated phase A)
    h_slot: np.ndarray    # [nc, H] diag slots
    h_div: np.ndarray     # [nc, H] diag hist
    mine_diag: np.ndarray  # [p, nc, H] 1 where this chip owns the diag
    counts: np.ndarray    # [p, nc, 4] per chip: nh, n1, n2, flags
    ev1: np.ndarray       # [p, nc, C1, 5]
    ev2: np.ndarray       # [p, nc, C2, 5]
    bc_idx: np.ndarray    # [nc, CB] pass-2 B operands to broadcast
    bc_cnt: np.ndarray    # [nc]
    mine_bc: np.ndarray   # [p, nc, CB] 1 where this chip owns the row
    nchunks: int
    CB: int
    max_level: np.ndarray = None   # [nc] elimination level reached by
    #   each chunk (monotone) — drives the adaptive-width segment
    #   planner (tpu/backslash_fused.plan_segments), same model as the
    #   single-chip StreamChunks.max_level


@dataclasses.dataclass
class ShardedEventStream:
    n: int
    nnz: int
    p: int
    init_pos: np.ndarray
    row_of: np.ndarray
    factor: ShardedChunks
    solve: ShardedChunks
    lnz: int
    unz: int
    # --- partitioned value table (set by partition_value_table) ---
    # each chip stores ONLY the slots of rows it owns, in a local index
    # space of uniform size Lp (last row = dummy); pass-2 B operands
    # read the per-chunk broadcast buffer by POSITION, so no slot is
    # ever mirrored (SURVEY §2.10 block-row partition, memory included)
    Lp: int = 0                       # local table rows (incl. dummy)
    h_slot_loc: np.ndarray = None     # [p, nc, H] local diag (or dummy)
    bc_loc: np.ndarray = None         # [p, nc, CB] owner-local bc idx
    init_chip: np.ndarray = None      # [nnz(A)] owner chip per A entry
    init_loc: np.ndarray = None       # [nnz(A)] local slot per A entry
    # --- grouped (subtree-local) streams only ---
    ndet: Optional[int] = None        # determinant table row (None -> n)
    nxx: int = 0                      # extra X clone rows
    extra_chip: np.ndarray = None     # extra-slot init (chip, local,
    extra_loc: np.ndarray = None      #   value) triples; replicated
    extra_vals: list = None           #   slots appear once per chip


class _ShardChunkBuilder:
    """The single-chip packer's hazard rules + per-chip event lists +
    per-chunk broadcast tracking (see tpu/schedule_stream._ChunkBuilder
    for the execution semantics the cuts protect)."""

    def __init__(self, p: int, owner_t, owner_b, H: int, C1: int,
                 C2: int, dummy_target: int, dummy_a=None, dummy_b=None):
        self.p = p
        self.owner_t = owner_t          # target index -> chip
        self.owner_b = owner_b          # b-operand index -> chip
        self.H, self.C1, self.C2 = H, C1, C2
        self.dummy = dummy_target
        self.dummy_a = dummy_target if dummy_a is None else dummy_a
        self.dummy_b = dummy_target if dummy_b is None else dummy_b
        self.h: List[List[int]] = []
        self.p1: List[List[List[int]]] = [[] for _ in range(p)]
        self.p2: List[List[List[int]]] = [[] for _ in range(p)]
        self.bc: set = set()
        self.chunks: List[tuple] = []
        self.w1: set = set()
        self.w2: set = set()
        self.r2: set = set()
        self.hsteps: set = set()
        self.events = 0

    def _flush(self):
        if not (self.h or any(self.p1) or any(self.p2)):
            return
        self.chunks.append((self.h, self.p1, self.p2, sorted(self.bc)))
        self.h = []
        self.p1 = [[] for _ in range(self.p)]
        self.p2 = [[] for _ in range(self.p)]
        self.bc = set()
        self.w1, self.w2, self.r2 = set(), set(), set()
        self.hsteps = set()

    def barrier(self):
        self._flush()

    def add_head(self, k: int, slot: int, div: int):
        # same cuts as the single-chip _ChunkBuilder (see its add_head
        # for the GT/TZ and SMT[k] chain-hazard rationale) — heads are
        # REPLICATED in the sharded superstep, so the batched head
        # phase's semantics are identical
        if (len(self.h) == self.H or slot in self.w1 or slot in self.w2
                or slot in self.r2
                or (div != k and (div - 1) in self.hsteps)
                or (div != k and (k - 1) in self.hsteps
                    and (not self.h or self.h[-1][0] != k - 1))):
            self._flush()
        self.h.append([k, slot, div])
        self.hsteps.add(k)
        self.w1.add(slot)

    def add(self, target, mult, div, a, b, pass2: bool):
        c = self.owner_t(target)
        if pass2:
            if (target in self.w2 or a in self.w2 or b in self.w2
                    or len(self.p2[c]) == self.C2):
                self._flush()
            self.p2[c].append([target, mult, div, a, b])
            self.w2.add(target)
            self.r2.update((target, a, b))
            if b != self.dummy_b:
                self.bc.add(b)
        else:
            if (target in self.w1 or target in self.w2
                    or target in self.r2 or len(self.p1[c]) == self.C1):
                self._flush()
            assert a == self.dummy_a
            self.p1[c].append([target, mult, div, self.dummy_a, b])
            self.w1.add(target)
        self.events += 1

    def add_fix_update(self, target, fix_mult, fix_div, upd_mult,
                       upd_div, a, b):
        c = self.owner_t(target)
        if (target in self.w1 or target in self.w2 or target in self.r2
                or a in self.w2 or b in self.w2
                or len(self.p1[c]) == self.C1
                or len(self.p2[c]) == self.C2):
            self._flush()
        self.p1[c].append([target, fix_mult, fix_div, self.dummy_a,
                           self.dummy_b])
        self.p2[c].append([target, upd_mult, upd_div, a, b])
        self.w1.add(target)
        self.w2.add(target)
        self.r2.update((target, a, b))
        if b != self.dummy_b:
            self.bc.add(b)
        self.events += 2

    def finish(self) -> ShardedChunks:
        self._flush()
        p = self.p
        nc = max(1, len(self.chunks))
        H, C1, C2 = self.H, self.C1, self.C2
        CB = max(1, max((len(bc) for _, _, _, bc in self.chunks),
                        default=1))
        h_step = np.full((nc, H), -1, np.int32)
        h_slot = np.full((nc, H), self.dummy, np.int32)
        h_div = np.zeros((nc, H), np.int32)
        mine_diag = np.zeros((p, nc, H), np.int32)
        counts = np.zeros((p, nc, 4), np.int32)
        ev1 = np.zeros((p, nc, C1, 5), np.int32)
        ev2 = np.zeros((p, nc, C2, 5), np.int32)
        ev1[:, :, :, 0] = self.dummy
        ev2[:, :, :, 0] = self.dummy
        ev1[:, :, :, 3] = self.dummy_a
        ev2[:, :, :, 3] = self.dummy_a
        ev1[:, :, :, 4] = self.dummy_b
        ev2[:, :, :, 4] = self.dummy_b
        bc_idx = np.full((nc, CB), self.dummy_b, np.int32)
        bc_cnt = np.zeros(nc, np.int32)
        mine_bc = np.zeros((p, nc, CB), np.int32)
        for ci, (h, p1, p2, bc) in enumerate(self.chunks):
            for t, (k, s, d) in enumerate(h):
                h_step[ci, t] = k
                h_slot[ci, t] = s
                h_div[ci, t] = d
                mine_diag[self.owner_t(s), ci, t] = 1
            anyfix = 256 if any(d != k for k, _, d in h) else 0
            for c in range(p):
                for t, e in enumerate(p1[c]):
                    ev1[c, ci, t] = e
                for t, e in enumerate(p2[c]):
                    ev2[c, ci, t] = e
                flags = anyfix
                if p1[c] and all(e[1] == 0 for e in p1[c]):
                    flags |= 1
                if p2[c] and all(e[1] == 0 for e in p2[c]):
                    flags |= 2
                if p1[c] and all(e[2] == 0 for e in p1[c]):
                    flags |= 4
                if p2[c] and all(e[2] == 0 for e in p2[c]):
                    flags |= 8
                if p1[c] and all(e[1] == p1[c][0][1] for e in p1[c]):
                    flags |= 16
                if p1[c] and all(e[2] == p1[c][0][2] for e in p1[c]):
                    flags |= 32
                if p2[c] and all(e[1] == p2[c][0][1] for e in p2[c]):
                    flags |= 64
                if p2[c] and all(e[2] == p2[c][0][2] for e in p2[c]):
                    flags |= 128
                counts[c, ci] = (len(h), len(p1[c]), len(p2[c]), flags)
            for t, bidx in enumerate(bc):
                bc_idx[ci, t] = bidx
                mine_bc[self.owner_b(bidx), ci, t] = 1
            bc_cnt[ci] = len(bc)
        return ShardedChunks(h_step=h_step, h_slot=h_slot, h_div=h_div,
                             mine_diag=mine_diag, counts=counts,
                             ev1=ev1, ev2=ev2, bc_idx=bc_idx,
                             bc_cnt=bc_cnt, mine_bc=mine_bc,
                             nchunks=nc, CB=CB)


def sharded_chunk_levels(sc: ShardedChunks, lvl: np.ndarray) -> np.ndarray:
    """Per-chunk max elimination level (monotone running max) for the
    adaptive-width segment planner: heads contribute their table row
    k+1, events their mult row, both mapped through `lvl` (identity
    for ungrouped streams; the local-level table for grouped streams,
    where a group event at LOCAL level l grows like a global level-l
    value — tpu/schedule_subtree docstring)."""
    lvl = np.asarray(lvl, np.int64)
    nc = sc.nchunks
    hs = np.asarray(sc.h_step, np.int64)
    m = np.where(hs >= 0, lvl[np.clip(hs + 1, 0, len(lvl) - 1)],
                 0).max(axis=1) if hs.size else np.zeros(nc, np.int64)
    for ci, ev in ((1, sc.ev1), (2, sc.ev2)):
        C = ev.shape[2]
        valid = (np.arange(C)[None, None, :]
                 < sc.counts[:, :, ci, None])          # [p, nc, C]
        lv = np.where(valid, lvl[np.clip(ev[:, :, :, 1], 0,
                                         len(lvl) - 1)], 0)
        m = np.maximum(m, lv.max(axis=(0, 2)))
    return np.maximum.accumulate(m).astype(np.int32)


def build_sharded_stream(sched: SparseSchedule, p: int,
                         heads_per_chunk: int = 8,
                         pass1_events: int = 32,
                         pass2_events: int = 128) -> ShardedEventStream:
    """Flatten a SparseSchedule into chip-partitioned chunk streams.

    Event emission order and skip rules are identical to the
    single-chip build_event_stream — only the assignment of each event
    to a chip (by target-row owner) and the per-chunk broadcast lists
    are new. Capacities are PER CHIP: the global chunk capacity is p
    times larger, which is where multi-chip scaling comes from.
    """
    n, E = sched.n, sched.nnz
    row_of = sched.row_of

    def owner_slot(s: int) -> int:
        return int(row_of[s]) % p if s < E else 0

    def owner_row(i: int) -> int:
        return i % p if i < n else 0

    fb = _ShardChunkBuilder(p, owner_slot, owner_slot, heads_per_chunk,
                            pass1_events, pass2_events, E)
    for k in range(n):
        fb.add_head(k, int(sched.diag_pos[k]), int(sched.diag_hist[k]))
        for pos, hist in ((sched.col_pos[k], sched.col_hist[k]),
                          (sched.row_pos[k], sched.row_hist[k])):
            for a in range(pos.shape[0]):
                s = int(pos[a])
                h = int(hist[a])
                if s >= E or h == k:
                    continue
                fb.add(s, k, h, E, E, pass2=False)
        for a in range(sched.rmax):
            gl = int(sched.col_pos[k, a])
            if gl >= E:
                continue
            for b2 in range(sched.cmax):
                gu = int(sched.row_pos[k, b2])
                gt = int(sched.tile_pos[k, a, b2])
                if gu >= E or gt >= E:
                    continue
                h = int(sched.tile_hist[k, a, b2])
                if h == k:
                    fb.add(gt, k + 1, k, gl, gu, pass2=True)
                else:
                    fb.add_fix_update(gt, k, h, k + 1, k, gl, gu)
    factor = fb.finish()

    sb = _ShardChunkBuilder(p, owner_row, owner_row, 0,
                            pass1_events, pass2_events, n,
                            dummy_a=E, dummy_b=n)
    for k in range(n):
        h = int(sched.fwd_xk_hist[k])
        if h != k:
            sb.add(k, k, h, E, n, pass2=False)
        for a in range(sched.rmax):
            gl = int(sched.col_pos[k, a])
            if gl >= E:
                continue
            i = int(sched.row_of[gl])
            hi = int(sched.fwd_hist[k, a])
            if hi == k:
                sb.add(i, k + 1, k, gl, k, pass2=True)
            else:
                sb.add_fix_update(i, k, hi, k + 1, k, gl, k)
    sb.barrier()
    for i in range(n):
        sb.add(i, n, 0, E, n, pass2=False)
    sb.barrier()
    for j in range(n - 1, -1, -1):
        sb.add(j, 0, j + 1, E, n, pass2=False)
        for a in range(sched.umax):
            g = int(sched.bwd_pos[j, a])
            if g >= E:
                continue
            sb.add(int(sched.bwd_row[j, a]), 0, 0, g, j, pass2=True)
    solve = sb.finish()

    row_of_ext = np.concatenate([sched.row_of,
                                 [np.int32(n)]]).astype(np.int32)
    ses = ShardedEventStream(n=n, nnz=E, p=p, init_pos=sched.init_pos,
                             row_of=row_of_ext, factor=factor,
                             solve=solve, lnz=sched.lnz, unz=sched.unz)
    lvl = np.arange(n + 2, dtype=np.int64)      # mult row == level
    factor.max_level = sharded_chunk_levels(factor, lvl)
    solve.max_level = sharded_chunk_levels(solve, lvl)
    _partition_value_table(ses)
    return ses


def _partition_value_table(ses: ShardedEventStream, owner=None,
                           repl=(), extra_pos=None,
                           extra_vals=None) -> None:
    """Rewrite every value-slot index into per-chip LOCAL spaces.

    Ownership is by row (cyclic). Each chip's table holds exactly its
    owned slots (+ one dummy row); remote values are never stored:
      * factor pass-2 B operands become POSITIONS into the chunk's
        broadcast buffer (the bc list already holds exactly the
        distinct B slots of the chunk), read directly from the psum
        result — the post-broadcast scatter disappears;
      * head diag writes go to the owner's local slot, the dummy row
        elsewhere (non-owners never read diags from their table — the
        heads consume the psum-broadcast diagonals);
      * A operands and all targets are owned by construction (IPGE
        updates read L(i,k) from the target's own row i).
    The solve stream keeps its full per-chip X (every X row is
    broadcast at least once over the solve, so partitioning X saves
    nothing) but its A operands are value slots and remap too.

    Grouped streams pass an explicit `owner` array covering the extra
    slots (clones, PD scratch), `repl` — slots replicated on EVERY
    chip at one shared local index (the constant m1 merge operand,
    which is an A operand of events on all chips), and the extra-slot
    init values, expanded here into (chip, local, value) triples.
    """
    p, E, n = ses.p, ses.nnz, ses.n
    row_of = ses.row_of
    if owner is None:
        owner = np.asarray(row_of[:E], np.int64) % p
    repl_set = set(int(s) for s in repl)
    loc = np.full(E + 1, -1, np.int64)
    counts = np.zeros(p, np.int64)
    for s_ in range(E):
        if owner[s_] >= 0:
            loc[s_] = counts[owner[s_]]
            counts[owner[s_]] += 1
    base = int(counts.max())
    for j, s_ in enumerate(sorted(repl_set)):
        loc[s_] = base + j            # same index on every chip
    Lp = base + len(repl_set) + 1     # + dummy row
    dummy = Lp - 1
    loc[E] = dummy                    # global dummy slot -> local dummy

    def local_of(c, s_):
        if s_ >= E:
            return dummy
        if s_ in repl_set:
            return int(loc[s_])
        return int(loc[s_]) if owner[s_] == c else dummy

    f = ses.factor
    nc, H = f.h_step.shape
    CB = f.bc_idx.shape[1]
    # per-chunk bc position lookup
    bc_pos = [dict() for _ in range(nc)]
    for ci in range(nc):
        for t in range(int(f.bc_cnt[ci])):
            bc_pos[ci][int(f.bc_idx[ci, t])] = t
    h_slot_loc = np.full((p, nc, H), dummy, np.int32)
    bc_loc = np.full((p, nc, CB), dummy, np.int32)
    for ci in range(nc):
        for t in range(H):
            s_ = int(f.h_slot[ci, t])
            if s_ < E:
                h_slot_loc[owner[s_], ci, t] = loc[s_]
        for t in range(int(f.bc_cnt[ci])):
            s_ = int(f.bc_idx[ci, t])
            if s_ < E:
                bc_loc[owner[s_], ci, t] = loc[s_]
    for c in range(p):
        for ci in range(nc):
            n1 = int(f.counts[c, ci, 1])
            n2 = int(f.counts[c, ci, 2])
            for t in range(n1):
                f.ev1[c, ci, t, 0] = local_of(c, int(f.ev1[c, ci, t, 0]))
                f.ev1[c, ci, t, 3] = dummy
                f.ev1[c, ci, t, 4] = max(CB - 1, 0)
            f.ev1[c, ci, n1:, 0] = dummy
            f.ev1[c, ci, n1:, 3] = dummy
            f.ev1[c, ci, n1:, 4] = max(CB - 1, 0)
            for t in range(n2):
                f.ev2[c, ci, t, 0] = local_of(c, int(f.ev2[c, ci, t, 0]))
                f.ev2[c, ci, t, 3] = local_of(c, int(f.ev2[c, ci, t, 3]))
                b = int(f.ev2[c, ci, t, 4])
                f.ev2[c, ci, t, 4] = bc_pos[ci].get(b, max(CB - 1, 0))
            f.ev2[c, ci, n2:, 0] = dummy
            f.ev2[c, ci, n2:, 3] = dummy
            f.ev2[c, ci, n2:, 4] = max(CB - 1, 0)
    # solve stream: only the A operands live in value-slot space
    sv = ses.solve
    for c in range(p):
        for ci in range(sv.ev2.shape[1]):
            n2 = int(sv.counts[c, ci, 2])
            for t in range(n2):
                sv.ev2[c, ci, t, 3] = local_of(
                    c, int(sv.ev2[c, ci, t, 3]))
            sv.ev2[c, ci, n2:, 3] = dummy
        sv.ev1[c, :, :, 3] = dummy
    init_pos = np.asarray(ses.init_pos, np.int64)
    ses.Lp = Lp
    ses.h_slot_loc = h_slot_loc
    ses.bc_loc = bc_loc
    ses.init_chip = owner[init_pos].astype(np.int32)
    ses.init_loc = loc[init_pos].astype(np.int32)
    if extra_pos is not None and len(extra_pos):
        e_chip, e_loc, e_val = [], [], []
        for s_, v in zip(extra_pos, extra_vals):
            s_ = int(s_)
            if s_ in repl_set:
                for c in range(p):
                    e_chip.append(c)
                    e_loc.append(int(loc[s_]))
                    e_val.append(v)
            else:
                e_chip.append(int(owner[s_]))
                e_loc.append(int(loc[s_]))
                e_val.append(v)
        ses.extra_chip = np.asarray(e_chip, np.int32)
        ses.extra_loc = np.asarray(e_loc, np.int32)
        ses.extra_vals = e_val
