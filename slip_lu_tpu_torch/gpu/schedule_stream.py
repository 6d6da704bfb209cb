"""Uniform-event chunk streams for the fused (Pallas) sparse kernels.

Every arithmetic action of the REF LU factorization and substitution is
one instance of a single formula over merged sign|magnitude rows:

    out = (value[target] * SMT[mult] - A_op * B_op) / GT[div]

where SMT[r] = rho_{r-1} (row 0 = 1) and GT[r] = (sign, tz, Hensel
inverse) of rho_{r-1} (row 0 = identity):

  * history fix of a slot last updated to level h-1 (hist field h),
    brought to level k-1:        mult=k,   div=h,   A=B=dummy (0)
  * IPGE update at step k:       mult=k+1, div=k,   A=L(i,k), B=U(k,j)
  * forward-sub update:          mult=k+1, div=k,   A=L(i,k), B=x[k]
  * determinant scale:           mult=n,   div=0,   A=B=dummy
  * back-sub pivot division:     mult=0,   div=j+1, A=B=dummy
  * back-sub update:             mult=0,   div=0,   A=U(i,j), B=x[j]

(reference: the IPGE/history recurrences of slip_ref_triangular_solve.c
and slip_forward_sub.c / slip_back_sub.c — here statically scheduled and
flattened into one op stream).

Events pack into CHUNKS that may span elimination steps — the lever that
keeps device scan length proportional to total work instead of n. Each
chunk executes in-order phases:

  phase A: <= H pivot HEADS, sequentially (the rho chain is inherently
           serial): fix the diagonal (same formula), record rho_k into
           SMT[k+1], Hensel-lift its inverse into GT[k+1];
  phase B: pass-1 events, batched (history fixes);
  phase C: pass-2 events, batched (updates; their targets were fixed in
           pass 1 of this chunk or are already at level k-1).

The builder cuts a chunk whenever an event would touch a slot already
written in the chunk (the only ordering hazards), so within each pass
all reads/writes are conflict-free and fully vectorizable.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .schedule import SparseSchedule


@dataclasses.dataclass
class StreamChunks:
    """One phase-structured chunk stream (factor, or fwd+det+bwd)."""
    h_step: np.ndarray   # [nc, H] pivot step k (pad -1)
    h_slot: np.ndarray   # [nc, H] diagonal value slot (pad dummy)
    h_div: np.ndarray    # [nc, H] hist field of the diagonal (pad 0)
    ev1: np.ndarray      # [nc, C1, 5] pass-1 (target, mult, div, A, B)
    ev2: np.ndarray      # [nc, C2, 5] pass-2 events
    counts: np.ndarray   # [nc, 4] (n_heads, n_ev1, n_ev2, flags) per
    #                      chunk — the kernels bound their gather/
    #                      scatter loops by these instead of paying
    #                      full capacity; flags are shortcut bits
    nchunks: int
    fill: float          # event-slot utilization (diagnostic)
    max_level: np.ndarray = None  # [nc] highest IPGE level written by
    #                      any event/head of the chunk (monotone
    #                      nondecreasing) — the adaptive-width planner
    #                      keys segment boundaries off this


@dataclasses.dataclass
class EventStream:
    """Everything the fused kernels need for factor + solve."""
    n: int
    nnz: int                  # value slots E (slot E = dummy)
    init_pos: np.ndarray      # [nnz(A)] slot of each original A entry
    row_of: np.ndarray        # [E+1] row of each slot (dummy -> n)
    factor: StreamChunks      # targets/operands are value slots
    solve: StreamChunks       # targets are X rows; A from val, B from X
    lnz: int
    unz: int
    # grouped (subtree-local) streams only — tpu/schedule_subtree.py:
    ndet: Optional[int] = None   # determinant table row (None -> n)
    nxx: int = 0                 # extra X rows (solve clone slots)
    extra_pos: Optional[np.ndarray] = None  # extra value-slot inits
    extra_vals: Optional[list] = None
    grouped: object = None       # Grouping (diagnostics)


class _ChunkBuilder:
    """Greedy chunk packer with write-after-read hazard cuts.

    Execution semantics the cuts protect (per chunk): phase A (heads,
    sequential) -> pass 1 (batched: gather all, then write all) ->
    pass 2 (likewise). Within a pass every event reads PRE-pass state,
    so the builder must guarantee:
      * no two same-pass events write one slot;
      * nothing a pass-2 event reads (target/operands) is written by
        pass 2 itself (pass-1 writes are fine — that IS fix-then-use);
      * a pass-1 write never lands after a same-chunk pass-2 reader of
        that slot was emitted (stream order would invert).
    """

    def __init__(self, H: int, C1: int, C2: int, dummy_target: int,
                 dummy_a: Optional[int] = None,
                 dummy_b: Optional[int] = None):
        # target/A/B dummies live in different index spaces for the
        # solve stream (targets are X rows, A is a value slot, B is an
        # X row) — conflating them broke the pass-1 A==dummy invariant
        self.H, self.C1, self.C2 = H, C1, C2
        self.dummy = dummy_target
        self.dummy_a = dummy_target if dummy_a is None else dummy_a
        self.dummy_b = dummy_target if dummy_b is None else dummy_b
        self.h: List[List[int]] = []
        self.p1: List[List[int]] = []
        self.p2: List[List[int]] = []
        self.chunks: List[tuple] = []
        self.w1: set = set()     # slots written by pass 1 (or heads)
        self.w2: set = set()     # slots written by pass 2
        self.r2: set = set()     # slots read by pass-2 events
        self.hsteps: set = set()  # steps whose head is in this chunk
        self.events = 0

    def _flush(self):
        if not (self.h or self.p1 or self.p2):
            return
        self.chunks.append((self.h, self.p1, self.p2))
        self.h, self.p1, self.p2 = [], [], []
        self.w1, self.w2, self.r2 = set(), set(), set()
        self.hsteps = set()

    def barrier(self):
        """End the current chunk (segment boundary, e.g. fwd|det|bwd)."""
        self._flush()

    def add_head(self, k: int, slot: int, div: int):
        # heads execute before both passes, but a head only touches its
        # diagonal slot and table rows no pass event reads, so it may
        # join a chunk with pass events already queued as long as its
        # diagonal is untouched there (phase A still runs first).
        #
        # GT/TZ hazard: a head's history fix (div != k) reads GT[div]
        # and TZ[div], which are written by the batched Hensel lift
        # (phase A2) of the chunk holding head div-1 — AFTER that
        # chunk's phase A. A same-chunk read would see garbage, so cut
        # the chunk. (div == k is the identity fix; the kernel skips it
        # without touching GT/TZ, so it may share freely.)
        #
        # SMT[k] hazard: a fix-head whose chain predecessor (head k-1)
        # shares the chunk is only repaired by the kernel's sequential
        # refine when the two are ADJACENT in the head list
        # (_heads_phase checks ks[t-1] == k-1); grouped round-robin
        # emission can interleave other groups' heads between chain
        # links, so cut unless the predecessor was the last head added.
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
        if pass2:
            if (target in self.w2 or a in self.w2 or b in self.w2
                    or len(self.p2) == self.C2):
                self._flush()
            self.p2.append([target, mult, div, a, b])
            self.w2.add(target)
            self.r2.update((target, a, b))
        else:
            if (target in self.w1 or target in self.w2
                    or target in self.r2 or len(self.p1) == self.C1):
                self._flush()
            assert a == self.dummy_a, (
                "pass-1 events must not carry a live A operand")
            self.p1.append([target, mult, div, self.dummy_a, b])
            self.w1.add(target)
        self.events += 1

    def add_fix_update(self, target, fix_mult, fix_div, upd_mult, upd_div,
                       a, b):
        """A stale target: history fix (pass 1) + update (pass 2)."""
        if (target in self.w1 or target in self.w2 or target in self.r2
                or a in self.w2 or b in self.w2
                or len(self.p1) == self.C1 or len(self.p2) == self.C2):
            self._flush()
        self.p1.append([target, fix_mult, fix_div, self.dummy_a,
                        self.dummy_b])
        self.p2.append([target, upd_mult, upd_div, a, b])
        self.w1.add(target)
        self.w2.add(target)
        self.r2.update((target, a, b))
        self.events += 2

    def finish(self) -> StreamChunks:
        self._flush()
        nc = max(1, len(self.chunks))
        H, C1, C2 = self.H, self.C1, self.C2
        h_step = np.full((nc, H), -1, np.int32)
        h_slot = np.full((nc, H), self.dummy, np.int32)
        h_div = np.zeros((nc, H), np.int32)
        ev1 = np.zeros((nc, C1, 5), np.int32)
        ev2 = np.zeros((nc, C2, 5), np.int32)
        for ev in (ev1, ev2):
            ev[:, :, 0] = self.dummy
            ev[:, :, 3] = self.dummy_a
            ev[:, :, 4] = self.dummy_b
        counts = np.zeros((nc, 4), np.int32)
        max_level = np.zeros(nc, np.int32)
        used = 0
        for c, (h, p1, p2) in enumerate(self.chunks):
            for t, (k, s, d) in enumerate(h):
                h_step[c, t] = k
                h_slot[c, t] = s
                h_div[c, t] = d
            for t, e in enumerate(p1):
                ev1[c, t] = e
            for t, e in enumerate(p2):
                ev2[c, t] = e
            # counts[:, 3] carries per-pass shortcut flags the kernels
            # branch on: bit0/bit1 = every pass-1/pass-2 event has
            # mult == 0 (SMT[0] = 1: skip the t*rho product), bit2/bit3
            # likewise div == 0 (GT[0] = identity: skip the Hensel
            # division). Back-substitution chunks set all of bit1|bit3.
            # bits 4-7: UNIFORM mult/div — every pass-1/pass-2 event
            # shares ONE mult (bit4/bit6) or ONE div (bit5/bit7) table
            # row, so the kernel broadcasts a single row instead of
            # gathering per event (most chunks span few elimination
            # steps; the per-event scalar row copies were the dominant
            # per-chunk cost on gather-bound matrices).
            flags = 0
            if p1 and all(e[1] == 0 for e in p1):
                flags |= 1
            if p2 and all(e[1] == 0 for e in p2):
                flags |= 2
            if p1 and all(e[2] == 0 for e in p1):
                flags |= 4
            if p2 and all(e[2] == 0 for e in p2):
                flags |= 8
            if p1 and all(e[1] == p1[0][1] for e in p1):
                flags |= 16
            if p1 and all(e[2] == p1[0][2] for e in p1):
                flags |= 32
            if p2 and all(e[1] == p2[0][1] for e in p2):
                flags |= 64
            if p2 and all(e[2] == p2[0][2] for e in p2):
                flags |= 128
            # bit 8: some head needs a history fix (dv != k) — the
            # kernel's batched speculative-fix/verify passes are gated
            # on this so skip-only chunks pay no head arithmetic
            if any(d != k for k, _, d in h):
                flags |= 256
            counts[c] = (len(h), len(p1), len(p2), flags)
            used += len(p1) + len(p2)
            # a head at step k writes rho_k (level k); an event with
            # mult m writes a level m-1 value (update m=k+1 -> level k,
            # fix m=k -> level k-1, det scale m=n -> level n-1)
            lv = max([k for k, _, _ in h] + [e[1] - 1 for e in p1]
                     + [e[1] - 1 for e in p2] + [0])
            max_level[c] = max(lv, max_level[c - 1] if c else 0)
        fill = used / float(nc * (C1 + C2))
        return StreamChunks(h_step=h_step, h_slot=h_slot, h_div=h_div,
                            ev1=ev1, ev2=ev2, counts=counts, nchunks=nc,
                            fill=fill, max_level=max_level)


def build_event_stream(sched: SparseSchedule, heads_per_chunk: int = 8,
                       pass1_events: int = 32,
                       pass2_events: int = 128) -> EventStream:
    """Flatten a SparseSchedule into uniform-event chunk streams.

    Identity history fixes (hist == current step, value already at level
    k-1) are skipped outright — unlike the padded kernel, which pays for
    them as full masked work.
    """
    n, E = sched.n, sched.nnz

    fb = _ChunkBuilder(heads_per_chunk, pass1_events, pass2_events, E)
    for k in range(n):
        fb.add_head(k, int(sched.diag_pos[k]), int(sched.diag_hist[k]))
        # finalizing fixes of the pivot column / pivot row (level k-1)
        for pos, hist in ((sched.col_pos[k], sched.col_hist[k]),
                          (sched.row_pos[k], sched.row_hist[k])):
            for a in range(pos.shape[0]):
                s = int(pos[a])
                h = int(hist[a])
                if s >= E or h == k:
                    continue
                fb.add(s, k, h, E, E, pass2=False)
        # IPGE tile updates
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

    # ---- solve stream: forward, determinant scale, backward -------------
    # targets are X rows 0..n-1 (dummy row n); operand A is a value slot,
    # operand B is an X row
    sb = _ChunkBuilder(0, pass1_events, pass2_events, n,
                       dummy_a=E, dummy_b=n)
    for k in range(n):
        h = int(sched.fwd_xk_hist[k])
        if h != k:
            sb.add(k, k, h, E, n, pass2=False)       # fix x[k]
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
    sb.barrier()                                     # fwd | det | bwd
    for i in range(n):
        sb.add(i, n, 0, E, n, pass2=False)           # x *= det
    sb.barrier()
    for j in range(n - 1, -1, -1):
        sb.add(j, 0, j + 1, E, n, pass2=False)       # x[j] /= rho_j
        for a in range(sched.umax):
            g = int(sched.bwd_pos[j, a])
            if g >= E:
                continue
            sb.add(int(sched.bwd_row[j, a]), 0, 0, g, j, pass2=True)
    solve = sb.finish()

    # pass-1 events NEVER carry a real A operand (every fix, determinant
    # scale, and pivot division multiplies the zero dummy value slot) —
    # the kernels rely on this to skip the A*B product statically
    for sc in (factor, solve):
        for c in range(sc.nchunks):
            n1 = int(sc.counts[c, 1])
            assert (sc.ev1[c, :n1, 3] == E).all(), c

    row_of = np.concatenate([sched.row_of, [np.int32(n)]]).astype(np.int32)
    return EventStream(n=n, nnz=E, init_pos=sched.init_pos, row_of=row_of,
                       factor=factor, solve=solve,
                       lnz=sched.lnz, unz=sched.unz)
