"""Host glue for the fused exact solve on a CUDA device.

Port of ``slip_lu_tpu/tpu/backslash_fused.py:factorize_solve_tpu_fused``
for one system (G = 1), taking the reference's decisions:

  1. ordering q + transversal r, symbolic elimination, uniform-event
     chunk streams (host, numpy); where the native forest is a chain, a
     dissection candidate certified by one host REF LU
     (``_dissect_candidate``), and the grouped (subtree-local) stream
     adopted by the reference's rules; all cached on the Analysis, the
     stream tensors keyed by device;
  2. adaptive-width segments of both streams (``plan_segments``);
  3. A's values packed as two's-complement limb rows at the first
     segment's width, cached per (stream, width, device);
  4. ``fused_solve_all``: the factor stream segment by segment (tables
     widened, GT re-lifted by K4 between segments) and each right-hand
     side's solve stream, one flat int32 vector back;
  5. the per-segment widen-and-retry, the host pin-check, a replan
     around the oracle's pivots on exact cancellation, the decode to
     rationals.

The environment switches of the reference keep their names and
defaults: ``SLIP_FUSED_SEGMENTS`` ("0": one full-width segment),
``SLIP_FUSED_SUBTREE`` ("0": never grouped, "force": adopt any
decomposition), ``SLIP_DISSECT_NMAX`` (largest n for a dissection) and
``SLIP_FUSED_DEBUG`` (print each rung's widths, segments and flags).

Left for later work, as the reference allows (each is an optimization or
a TPU memory artifact, sound either way): right-hand-side lanes and
member-lane batching (G > 1, ``fused_solve_many``), packed tables and
HBM value tables, and ``pivot_exact`` pinning (it raises). The last
resort after both plans flag a singular pivot is the reference's: on the
CPU, the dense path (``backslash_cuda``) up to n = ``DENSE_NMAX`` and the
host oracle above; on a device that can only be a kernel fault, and it
raises.
"""

from __future__ import annotations

import os
from fractions import Fraction
from math import gcd
from typing import Optional

import numpy as np
import torch

from ..analyze import Analysis
from ..convert import matrix_copy
from ..errors import (SlipIncorrectInputError, SlipLimbOverflowError,
                      SlipPanicError)
from ..matrix import Kind, SlipMatrix, Type
from ..options import Options
from ..stats import SolveStats, phase_timer, record
from .bounds import (_input_width, factor_width, hadamard_bits,
                     solve_width)
from .factor_fused import (_r8, fused_solve_all, ints_to_tc_rows,
                           stream_tensors, tc_rows_to_ints, val_tensor)
from .schedule import _permute_cols
from .schedule_native import build_schedule_best
from .schedule_stream import build_event_stream


def _mpq(num: int, den: int) -> Fraction:
    """Canonical Fraction without the pure-Python Fraction() overhead
    (the reference's mpq_canonicalize; math.gcd runs at C speed)."""
    if den < 0:
        num, den = -num, -den
    g = gcd(num, den)
    if g > 1:
        num //= g
        den //= g
    f = Fraction.__new__(Fraction)
    f._numerator = num
    f._denominator = den
    return f


def _tc_width(values, cap: int) -> int:
    """Smallest limb count whose two's complement holds every value
    exactly (sign bit included), clamped to [1, cap]."""
    bits = 1
    for v in values:
        b = (v if v >= 0 else ~v).bit_length() + 1
        if b > bits:
            bits = b
    return max(1, min(cap, -(-bits // 16)))


def plan_segments(max_level, n: int, W: int, Wmin: int):
    """Adaptive-width chunk segments: list of [lo, hi, W8s], widths
    nondecreasing and ending at _r8(W) (the reference's planner).

    Model: IPGE values at level L are k x k minors with k ~ L, whose bit
    growth is ~linear in L, so a level-L value needs ~W*(L+1)/n limbs.
    The model only steers the initial widths: every kernel write is
    overflow-checked, so an undersized segment costs a per-segment
    widen-and-retry, never a wrong answer."""
    nc = len(max_level)
    W8 = _r8(W)
    if W8 < 32 or nc < 16 or os.environ.get(
            "SLIP_FUSED_SEGMENTS", "1") == "0":
        return [[0, nc, W8]]

    def need(L):
        return _r8(max(Wmin, (W * (L + 2)) // n + 2))

    targets = sorted({max(_r8(W8 // 8), 8), _r8(W8 // 4),
                      _r8(W8 // 2)} - {W8})
    segs = []
    lo = 0
    for T in targets:
        hi = lo
        while hi < nc and need(int(max_level[hi])) <= T:
            hi += 1
        # slivers are not worth a launch and a relift boundary
        if hi - lo >= max(8, nc // 16):
            segs.append([lo, hi, T])
            lo = hi
    segs.append([lo, nc, W8])
    return segs


def _merged(segplan):
    """Collapse adjacent equal-width segments (after widen bumps)."""
    out = []
    for lo, hi, w in segplan:
        if out and out[-1][2] == w:
            out[-1][1] = hi
        else:
            out.append([lo, hi, w])
    return tuple((lo, hi, w) for lo, hi, w in out)


def _resolve_order(A, analysis, q, fixed_r):
    """One-time per analysis: pick the base or the etree-interleaved
    column order, measured-thin rule (the reference's rule unchanged).

    Interleaving independent elimination-tree branches lets the chunk
    packer put several pivot heads in one chunk, which shortens
    head-bound streams; event-bound streams lose locality, so interleave
    only when the schedule averages < 8 live IPGE tiles per step. The
    decision is sticky (analysis.q is updated in place) and skipped once
    pinned pivot rows exist.

    Returns (q, (sched, r) or None) — the schedule built while deciding
    is handed back so the caller doesn't rebuild it."""
    if fixed_r is not None or getattr(analysis, "ilv_decided", False):
        return q, None
    analysis.ilv_decided = True
    sched, r = build_schedule_best(A, q, None)
    tp = np.asarray(sched.tile_pos)
    per_step = float((tp < sched.nnz).sum()) / max(sched.n, 1)
    if per_step >= 8.0:
        analysis.ilv_applied = False
        return q, (sched, r)
    from ..analyze import etree_interleave
    q2 = etree_interleave(A, q)
    if q2 is q:
        analysis.ilv_applied = False
        return q, (sched, r)
    analysis.q = q2
    analysis.ilv_applied = True
    sched2, r2 = build_schedule_best(A, q2, None)
    return q2, (sched2, r2)


# Chunk-stream event capacities of pass 1 and pass 2: the reference
# planner's fixed (32, 128), so both packages plan the same stream.
C1, C2 = 32, 128

# The last resort's dense cap: its working set is O(n^2 * W), so larger
# systems go to the host oracle (the reference's n <= 256).
DENSE_NMAX = 256


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for, but torch finds "
                           "no CUDA device (pass device='cpu' to run the "
                           "kernels' plain versions)")
    if dev.type not in ("cuda", "cpu"):
        raise SlipIncorrectInputError(f"unsupported device {device!r}")
    return dev


def _dissect_candidate(A: SlipMatrix, analysis: Analysis,
                       options: Options, n_groups: int = 8):
    """One-time per analysis: when the native ordering's dependency
    forest is a chain (banded matrices under natural/COLAMD order),
    prepare, but do not commit, a dissection reorder so the grouped
    (subtree-local) streams have independent subtrees (the reference's
    rule, unchanged).

    Cancellations of the reordered pivots are repaired with pivoting
    confined to each group's block (``pin_rows_per_group``), the composed
    sequence is certified end to end by one host REF LU, and its exact
    limb width is kept so an adopting caller skips the widen ladder.
    Returns (q_nd, fixed_r, sched_nd, r_nd, Wx) or None, cached per
    n_groups on the Analysis; the caller adopts only if the grouped
    stream wins."""
    cache = getattr(analysis, "nd_candidate", None)
    if cache is not None and n_groups in cache:
        return cache[n_groups]
    if cache is None:
        cache = analysis.nd_candidate = {}
    cache[n_groups] = None
    n = A.n
    if n > int(os.environ.get("SLIP_DISSECT_NMAX", 65536)):
        # the certification is one full host REF LU: at 100K+ columns it
        # costs minutes for a candidate the width model would likely
        # reject anyway
        return None
    from .schedule_subtree import (dependency_forest, dissect_order,
                                   partition_groups, pin_rows_per_group)
    q0 = np.asarray(analysis.q, dtype=np.int64)
    sc = getattr(analysis, "fused_sched_only_cache", None)
    if sc is not None and sc[0] is None:
        sched0, _ = sc[1]
    else:
        q0, built = _resolve_order(A, analysis, q0, None)
        sched0, r0 = built if built is not None \
            else build_schedule_best(A, q0, None)
        analysis.fused_sched_only_cache = (None, (sched0, r0))
    q_nd = dissect_order(A, n_groups=n_groups)
    sched_nd, r_nd = build_schedule_best(A, q_nd, None)
    if sched_nd.lnz + sched_nd.unz > 1.9 * (sched0.lnz + sched0.unz):
        return None             # fill guard: reorder not worth it
    gr = partition_groups(dependency_forest(sched_nd), n_groups=n_groups)
    if gr is None:
        return None
    pair_g, demoted = pin_rows_per_group(A, q_nd, r_nd, gr,
                                         report_bad=True)
    if pair_g is None:
        return None             # unrepairable block: stay native
    # compose the full (column -> pivot row) assignment: block pivots
    # from the repair, demoted pairs (an exactly singular block's
    # dependent column with the unpivoted row carrying its missing rank),
    # transversal rows elsewhere; demoted columns move to the end of the
    # order (the separator)
    pair = {int(q_nd[k]): int(r_nd[k]) for k in range(n)}
    pair.update(pair_g)
    dem_cols = [c for c, _ in demoted]
    for c, r2 in demoted:
        pair[c] = r2
    if demoted:
        dset = set(dem_cols)
        q_nd = np.asarray([c for c in q_nd if int(c) not in dset]
                          + dem_cols, np.int64)
    fixed_r = np.asarray([pair[int(c)] for c in q_nd], np.int64)
    assert len(set(map(int, fixed_r))) == n   # still a permutation
    from ..errors import SlipSingularError
    from ..factorize import factorize
    old_q = analysis.q
    analysis.q = q_nd
    try:
        F = factorize(A, analysis, options, fixed_r=fixed_r)
    except SlipSingularError:
        return None             # top cancellation: stay native
    finally:
        analysis.q = old_q
    sched_p, r_p = build_schedule_best(A, q_nd, fixed_r)
    Wx = _tc_width((v for col in (F.Lcols + F.Ucols)
                    for _, v in col), 1 << 30) + 1
    cache[n_groups] = (q_nd, fixed_r, sched_p, r_p, Wx)
    return cache[n_groups]


def _width_probe(A: SlipMatrix, analysis: Analysis, options: Options,
                 fixed_r=None, steps: int = 1024) -> Optional[int]:
    """Value-aware limb-width estimate for the current order and pivot
    rows (the reference's probe): a truncated host REF factorization
    (the first ``steps`` columns, rows pinned) with linear-rate
    extrapolation, since IPGE entry widths grow ~linearly with level.
    None on an exact cancellation inside the probe window."""
    cache = getattr(analysis, "width_probe_cache", None)
    key = None if fixed_r is None else fixed_r.tobytes()
    if cache is not None and cache[0] == key:
        return cache[1]
    from ..errors import SlipSingularError
    from ..factorize import factorize
    n = A.n
    s = min(n, steps)
    try:
        F = factorize(A, analysis, options, fixed_r=fixed_r, max_steps=s)
    except SlipSingularError:
        analysis.width_probe_cache = (key, None)
        return None
    Wmax = _tc_width((v for col in (F.Lcols + F.Ucols)
                      for _, v in col), 1 << 30)
    W_in = _tc_width((int(A.x[i]) for i in range(int(A.p[n]))), 1 << 30)
    est = Wmax + 1 if s >= n \
        else max(Wmax, W_in + (Wmax - W_in) * n // s) + 1
    analysis.width_probe_cache = (key, est)
    return est


def _events(es) -> int:
    return int(es.factor.counts[:, 1:3].sum() + es.solve.counts[:, 1:3].sum())


def _width_cost(es, West: int, n: int) -> float:
    """The adoption model's cost of a stream: events weighted by the
    square of the segment width the planner would choose for them."""
    c = 0.0
    for sc in (es.factor, es.solve):
        ml = np.asarray(sc.max_level, np.float64)
        w = np.minimum(West, West * (ml + 2) / n + 2)
        ev = sc.counts[:, 1] + sc.counts[:, 2]
        c += float((ev * (w / 8.0) ** 2).sum())
    return c


def factorize_solve_cuda_fused(A: SlipMatrix, analysis: Analysis,
                               b: SlipMatrix,
                               options: Optional[Options] = None,
                               device="cuda",
                               heads_per_chunk: Optional[int] = None,
                               pass1_events: Optional[int] = None,
                               pass2_events: Optional[int] = None
                               ) -> SlipMatrix:
    """Exact solve via the fused stream kernels on ``device``.

    heads_per_chunk: None (default) picks 8 when the etree interleave
    packs independent heads together, else 2 (the reference's rule).
    pass1_events/pass2_events: chunk event capacities, default (32, 128).
    device: "cuda" runs the kernels; "cpu" runs their plain versions."""
    options = options or Options()
    options.validate()
    dev = _device(device)
    if A.kind != Kind.CSC or A.type != Type.MPZ:
        raise SlipIncorrectInputError("fused path requires CSC x MPZ input")
    if options.pivot_exact:
        raise SlipIncorrectInputError(
            "pivot_exact is not supported on the cuda-fused backend yet "
            "(pinned pivot schemes are queued in ROADMAP.md); use "
            "backend='host'")
    n = A.n
    if b.m != n:
        raise SlipIncorrectInputError(f"b has {b.m} rows, matrix has {n}")
    bz = matrix_copy(b, Kind.DENSE, Type.MPZ, options)
    nrhs = bz.n
    if n == 0:
        return SlipMatrix.allocate(Kind.DENSE, Type.MPQ, 0, nrhs)
    st = SolveStats(backend="cuda-fused", n=n, nnz=int(A.p[n]), nrhs=nrhs)
    q = np.asarray(analysis.q, dtype=np.int64)
    fixed_r = analysis.sparse_fixed_r   # cached repair from earlier solves

    for plan in range(2):
        # plan 0: transversal-diagonal pivots; plan 1 (cancellation
        # repair): pin the host oracle's pivot rows — guaranteed nonzero
        with phase_timer(st, "schedule"):
            skey = None if fixed_r is None else fixed_r.tobytes()
            sc = getattr(analysis, "fused_sched_only_cache", None)
            if sc is not None and sc[0] == skey:
                sched, r = sc[1]
            else:
                q, built = _resolve_order(A, analysis, q, fixed_r)
                sched, r = built if built is not None \
                    else build_schedule_best(A, q, fixed_r)
                analysis.fused_sched_only_cache = (skey, (sched, r))
            p1 = pass1_events if pass1_events is not None else C1
            p2 = pass2_events if pass2_events is not None else C2
            if heads_per_chunk is None:
                heads_per_chunk = 8 if getattr(
                    analysis, "ilv_applied", False) else 2
            key = (heads_per_chunk, p1, p2, skey)
            cache = getattr(analysis, "fused_cache", None)
            if cache is not None and cache[0] == key:
                sched, r, es, avals = cache[1]
            else:
                es = build_event_stream(sched, heads_per_chunk, p1, p2)
                subtree_mode = os.environ.get("SLIP_FUSED_SUBTREE", "1")
                if subtree_mode != "0":
                    es, key, cand = _adopt_grouped(
                        A, analysis, options, es, sched, r, fixed_r, skey,
                        key, p1, p2, subtree_mode)
                    if cand is not None:
                        # the dissection was committed: reorder, pinned
                        # rows, exact width seed, fresh cache keys
                        q, fixed_r, sched, r = cand[:4]
                        skey = key[3]
                Aq = _permute_cols(A, q)
                avals = [int(Aq.x[idx]) for c in range(n)
                         for idx in range(int(Aq.p[c]), int(Aq.p[c + 1]))]
                analysis.fused_cache = (key, (sched, r, es, avals))
                analysis.fused_stream_tensors = {}
            streams = analysis.fused_stream_tensors.get(str(dev))
            if streams is None:
                streams = stream_tensors(es, dev)
                analysis.fused_stream_tensors[str(dev)] = streams
        st.lnz, st.unz = es.lnz, es.unz
        E = es.nnz

        # --- width strategy: optimistic start + sound widen-and-retry --
        # Every value the kernels write is overflow-checked at a modulus
        # where the true quotient provably fits, and every value they
        # read was so checked or packed on host at a verified width, so
        # starting far below the Hadamard bound is sound: an undersized
        # width costs a retry, never a wrong answer. Converged widths are
        # cached on the Analysis, so warm solves skip the ladder.
        hbits = getattr(analysis, "hadamard_bits_cache", None)
        if hbits is None:
            hbits = hadamard_bits(A)
            analysis.hadamard_bits_cache = hbits
        W_full = factor_width(A, hbits=hbits)
        Ws_full = solve_width(A, bz.x, W_full, n, hbits=hbits)
        if es.ndet is not None:
            # grouped merge intermediates (clone terms scaled by
            # determinant products, fold partial sums) can exceed the
            # single-minor bound by a few bits: one limb of headroom keeps
            # the ladder-exhaustion invariant sound
            W_full += 1
            Ws_full += 1
        W_in = _input_width(avals)
        Wb_in = _input_width(bz.x.reshape(-1))
        if options.max_limbs is not None:
            # explicit user clamp: honor it exactly (reference semantics)
            W = factor_width(A, options.max_limbs, hbits=hbits)
            Ws = solve_width(A, bz.x, W, n, options.max_limbs,
                             hbits=hbits)
        else:
            wcache = getattr(analysis, "fused_width_cache", None)
            if wcache is not None:
                W, Ws = wcache
                W = min(max(W, W_in), W_full)
                Ws = min(max(Ws, W + 1, Wb_in), Ws_full)
            else:
                # start at bound/16 but never above 16 limbs; the
                # doubling ladder recovers genuinely wide cases
                W = min(max(2, W_in + 1, min(-(-W_full // 16), 16)),
                        W_full)
                Ws = min(max(W + 1, Wb_in + 1,
                             min(-(-Ws_full // 16), 32)), Ws_full)
            # an exact pinned-pivot width for THIS schedule beats any
            # guess — start there
            pchk = getattr(analysis, "fused_pin_check", None)
            if (pchk is not None and pchk[0] == skey
                    and pchk[1] is not None):
                W = min(max(W, pchk[1], W_in + 1), W_full)
                Ws = min(max(Ws, W + 1), Ws_full)

        sing = False
        Wmin_in = max(2, W_in + 1)
        segplan = ssegplan = None
        scache = getattr(analysis, "fused_seg_cache", None)
        if (scache is not None and scache[0] == key and scache[1] == W
                and scache[3] == Ws):
            segplan = [list(s) for s in scache[2]]
            ssegplan = [list(s) for s in scache[4]]
        while True:
            W8 = _r8(W)
            Ws8 = _r8(max(Ws, W + 1))
            WN = _r8(2 * W8 + 2)
            WNS = _r8(W8 + Ws8 + 2)
            WI8 = _r8(max(W8, Ws8) + 2)   # GT width: verified short
            #                                 division (factor_fused)
            st.W, st.Ws = W8, Ws8
            if segplan is None:
                segplan = plan_segments(es.factor.max_level, n, W, Wmin_in)
            segments = _merged(segplan)
            segplan = [list(s) for s in segments]
            S = len(segments)
            w0 = segments[0][2]
            with phase_timer(st, "pack"):
                # A's limb table per (stream, first-segment width,
                # device): upload once, reuse across solves (the kernels
                # never write it)
                vkey = (key, w0, str(dev))
                vcache = getattr(analysis, "fused_val_cache", None)
                if vcache is not None and vcache[0] == vkey:
                    val_dev = vcache[1]
                else:
                    val_dev = val_tensor(avals, es.init_pos, E, w0, dev,
                                         es.extra_pos, es.extra_vals)
                    analysis.fused_val_cache = (vkey, val_dev)
                bcols = [[int(bz.x[int(r[k]), c]) for k in range(n)]
                         for c in range(nrhs)]
                Wb = _tc_width((v for col in bcols for v in col), Ws8)
                b_rows = torch.from_numpy(np.stack(
                    [ints_to_tc_rows(col, Wb) for col in bcols])).to(dev)
            # solve-stream width segments (forward-substitution values
            # grow with level like factor values; det/bwd chunks pin the
            # full width). The first segment must hold b exactly.
            if ssegplan is None:
                ssegplan = plan_segments(es.solve.max_level, n,
                                         max(Ws, W + 1),
                                         max(Wmin_in, Wb + 1))
            for sp in ssegplan:
                sp[2] = min(max(sp[2], _r8(Wb + 1)), Ws8)
            ssegplan[-1][2] = Ws8
            ssegments = _merged(ssegplan)
            ssegplan = [list(s) for s in ssegments]
            Ss = len(ssegments)
            with phase_timer(st, "device"):
                flat = fused_solve_all(
                    n, W8, Ws8, WN, WNS, WI8, streams, val_dev, b_rows,
                    segments=segments, ssegments=ssegments, ndet=es.ndet,
                    nxx=es.nxx).cpu().numpy()
            seg_sing = [bool(flat[2 * s]) for s in range(S)]
            seg_ovf = [bool(flat[2 * s + 1]) for s in range(S)]
            o = 2 * S
            det_row = flat[o:o + W8][None, :]
            o += W8
            X_h = []
            sseg_ovf = [False] * Ss
            for c in range(nrhs):
                for s in range(Ss):
                    if flat[o + 1]:
                        sseg_ovf[s] = True
                    o += 2
                X_h.append(flat[o:o + n * Ws8].reshape(n, Ws8))
                o += n * Ws8
            sing = any(seg_sing)
            f_ovf = any(seg_ovf)
            s_ovf = any(sseg_ovf)
            # Flag trust: a sing counts only when no overflow hit the
            # same or an earlier segment — then every value feeding the
            # pivot fit its width, and a zero residue is a zero pivot. A
            # sing that rides with overflow is inconclusive: integer
            # pivot sequences can be 2-adically deep (exact pivots = 0
            # mod 2^(16*W8) for many rungs), so climb instead. At the
            # analytic bound genuine overflow is impossible, so the
            # ladder terminates.
            sing_clean = sing and not any(
                seg_ovf[i] for i in range(seg_sing.index(True) + 1))
            if os.environ.get("SLIP_FUSED_DEBUG"):
                print(f"[fused] plan={plan} W={W} Ws={Ws} "
                      f"segs={segments} sing={seg_sing} ovf={seg_ovf} "
                      f"s_ovf={s_ovf}", flush=True)
            if sing and sing_clean:
                break                       # genuine cancellation
            if sing or (f_ovf and st.retries >= 2):
                # ONE exact host REF LU pinned to THIS schedule's rows
                # decides for good: either the pinned sequence truly
                # cancels (replan), or it yields the exact width to jump
                # to. Keyed on the pinned row sequence only.
                chk = getattr(analysis, "fused_pin_check", None)
                if chk is None or chk[0] != skey:
                    with phase_timer(st, "pincheck"):
                        from ..errors import SlipSingularError
                        from ..factorize import factorize
                        try:
                            F = factorize(A, analysis, options,
                                          fixed_r=np.asarray(r))
                            Wx = _tc_width(
                                (v for col in (F.Lcols + F.Ucols)
                                 for _, v in col), 1 << 30) + 1
                            chk = (skey, Wx)
                        except SlipSingularError:
                            chk = (skey, None)
                    analysis.fused_pin_check = chk
                if chk[1] is None:
                    sing = True
                    break                   # proven cancellation
                Wx = max(chk[1], W_in + 1)  # table also holds raw A
                if W < Wx <= W_full:
                    W = Wx
                    Ws = max(Ws, W + 1)
                    segplan = ssegplan = None
                    st.retries += 1
                    continue
            if f_ovf or s_ovf:
                # only the FIRST overflowed segment's flag is trusted
                # (its garbage feeds everything after it): widen it alone
                # below the full width; escalate to the global ladder
                # only when the full-width segment flags. A rung where
                # both the first and the full-width segment flag is
                # wholesale undersized: go straight to the global ladder.
                first_bad = seg_ovf.index(True) if f_ovf else None
                if (first_bad is not None
                        and segplan[first_bad][2] < W8
                        and not (S > 1 and seg_ovf[0] and seg_ovf[-1])):
                    segplan[first_bad][2] = min(
                        2 * segplan[first_bad][2], W8)
                    for s in range(first_bad + 1, S):
                        segplan[s][2] = max(segplan[s][2],
                                            segplan[first_bad][2])
                    st.retries += 1
                    continue
                # the same per-segment policy for the solve stream (only
                # reached with the factor stream clean or exhausted)
                if not f_ovf and s_ovf:
                    sbad = sseg_ovf.index(True)
                    if ssegplan[sbad][2] < Ws8:
                        ssegplan[sbad][2] = min(2 * ssegplan[sbad][2], Ws8)
                        for s in range(sbad + 1, Ss):
                            ssegplan[s][2] = max(ssegplan[s][2],
                                                 ssegplan[sbad][2])
                        st.retries += 1
                        continue
                W2, Ws2 = W, Ws
                if f_ovf:
                    W2 = min(2 * W, W_full)
                else:
                    Ws2 = min(2 * Ws, Ws_full)
                Ws2 = max(Ws2, W2 + 1)
                if (W2, Ws2) == (W, Ws):
                    if sing:
                        break               # cancellation proven (see ^)
                    raise SlipLimbOverflowError(
                        "overflow persists at the analytic width bound "
                        f"(W={W}, Ws={Ws}) — internal invariant violated")
                if W2 != W:
                    segplan = None          # widths rescale with W
                if Ws2 != Ws:
                    ssegplan = None
                W, Ws = W2, Ws2
                st.retries += 1
                continue
            if options.max_limbs is None:
                analysis.fused_width_cache = (W, Ws)
                analysis.fused_seg_cache = (key, W, segments, Ws,
                                            ssegments)
            with phase_timer(st, "unpack"):
                det = tc_rows_to_ints(det_row)[0]
                x = SlipMatrix.allocate(Kind.DENSE, Type.MPQ, n, nrhs)
                factor = A.scale / bz.scale
                fnum, fden = factor.numerator, factor.denominator
                den_all = det * fden
                for c in range(nrhs):
                    xh = tc_rows_to_ints(X_h[c])
                    for k in range(n):
                        x.x[int(q[k]), c] = _mpq(xh[k] * fnum, den_all)
            record(st)
            return x
        # the singular flag stopped the width loop
        if plan == 0:
            # exact cancellation killed a scheduled pivot: replan around
            # the oracle's actual pivot sequence (the reference's dynamic
            # pivot search, done once on host) and rerun with the pinned
            # rows
            with phase_timer(st, "replan"):
                from ..factorize import factorize
                F = factorize(A, analysis, options)   # raises if singular
                fixed_r = np.asarray(F.row_perm, dtype=np.int64)
                analysis.sparse_fixed_r = fixed_r
                # this factorization IS plan 1's pinned sequence: seed
                # its exact width so plan 1 starts at the right rung
                Wx1 = _tc_width((v for col in (F.Lcols + F.Ucols)
                                 for _, v in col), 1 << 30) + 1
                analysis.fused_pin_check = (fixed_r.tobytes(), Wx1)
    # Both plans singular-flagged. Plan 0's replan raises for a singular
    # matrix and plan 1 pins the oracle's nonzero pivots, so only a fault
    # in the device half gets here: on a device it is raised, never
    # hidden behind another answer. The plain versions on the CPU take the
    # reference's last resort: the dense path, which searches pivots
    # dynamically, up to DENSE_NMAX, and the host oracle (exact, O(fill)
    # memory) above. Recorded after that solve, so last_stats() reports
    # the fallback.
    if dev.type != "cpu":
        raise SlipPanicError(
            f"the {dev.type} stream kernels flagged a singular pivot under "
            "the oracle's pinned nonzero pivots — internal invariant "
            "violated")
    st.fallback = True
    if n > DENSE_NMAX:
        from ..backslash import backslash
        x = backslash(A, b, Type.MPQ, options, backend="host")
    else:
        from .backslash_cuda import factorize_solve_cuda
        x = factorize_solve_cuda(A, analysis, b, options, device=dev)
    record(st)
    return x


def _adopt_grouped(A, analysis, options, es, sched, r, fixed_r, skey, key,
                   p1, p2, subtree_mode):
    """The reference's single-chip adoption of subtree-local (grouped)
    streams. Returns (stream, key, committed candidate or None); when a
    dissection candidate is adopted, it is committed on the Analysis
    (order, pinned rows, exact width seed, schedule cache).

    Grouped streams are fix-heavy, so pass-1 capacity doubles (at least
    64). Adoption: ``force`` adopts any decomposition; otherwise the
    grouped stream must shorten the chunk scan by 15% without inflating
    events by 25%, or, failing that, win the width-weighted cost model
    (each side costed at its own width: the candidate's certified Wx,
    the ungrouped side value-probed)."""
    from .schedule_subtree import try_build_grouped
    n = A.n
    es_g = try_build_grouped(sched, 8, max(64, p1), p2)
    cand = None
    if es_g is None and fixed_r is None and n >= 192:
        # chain forest: evaluate a dissection reorder (committed only if
        # the grouped stream wins)
        cand = _dissect_candidate(A, analysis, options)
        if cand is not None:
            es_g = try_build_grouped(cand[2], 8, max(64, p1), p2)
    adopt = es_g is not None and (
        subtree_mode == "force"
        or (es_g.factor.nchunks + es_g.solve.nchunks
            < 0.85 * (es.factor.nchunks + es.solve.nchunks)
            and _events(es_g) < 1.25 * _events(es)))
    if es_g is not None and not adopt:
        pchk = getattr(analysis, "fused_pin_check", None)
        West_g = cand[4] if cand is not None else (
            pchk[1] if (pchk is not None and pchk[0] == skey
                        and pchk[1]) else None)
        if West_g is not None and West_g >= 32:
            West_u = _width_probe(A, analysis, options, fixed_r=r)
            if West_u is None:
                West_u = West_g
            adopt = (_width_cost(es_g, West_g, n)
                     < 0.8 * _width_cost(es, West_u, n))
    if not adopt:
        return es, key, None
    if cand is None:
        return es_g, key, None
    q, fixed_r, sched, r, Wx = cand
    analysis.q = q
    analysis.sparse_fixed_r = fixed_r
    skey = fixed_r.tobytes()
    analysis.fused_pin_check = (skey, Wx)
    analysis.fused_sched_only_cache = (skey, (sched, r))
    return es_g, (key[0], key[1], key[2], skey), cand
