"""Host driver for the sharded fused exact solve, one process a rank.

Counterpart of ``slip_lu_tpu/parallel/driver_fused.py``: the single-chip
pipeline of ``gpu/backslash_fused.py`` (schedule, chunk streams, optimistic
widths with the widen-and-retry ladder, adaptive-width segments, grouped
(subtree-local) stream adoption), with the streams partitioned over the
ranks of a ``torch.distributed`` group (``stream_shard_fused.py``) and the
sharded chunk loop as the device half (``factor_fused_shard.py``). Every
rank plans on the host; the planning is deterministic numpy, so the ranks
agree without talking. Exact pivot cancellation falls back to the
single-chip fused driver on the same device (which replans there), as the
reference does, and ``SolveStats.fallback`` says so.

The reference's VMEM/HBM budget pair for adopting a grouped stream
becomes one device-memory budget a rank (``DEVICE_BUDGET``); its HBM
value-table layout is not ported.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..analyze import Analysis
from ..convert import matrix_copy
from ..errors import SlipIncorrectInputError, SlipLimbOverflowError
from ..gpu.backslash_fused import (_device, _dissect_candidate, _merged,
                                   _mpq, _resolve_order, _tc_width,
                                   _width_probe, plan_segments)
from ..gpu.bounds import (_input_width, factor_width, hadamard_bits,
                          solve_width)
from ..gpu.factor_fused import _r8, ints_to_tc_rows, tc_rows_to_ints
from ..gpu.schedule import _permute_cols
from ..gpu.schedule_native import build_schedule_best
from ..matrix import Kind, SlipMatrix, Type
from ..options import Options
from ..stats import SolveStats, phase_timer, record
from .factor_fused_shard import fused_sharded_solve, rank_streams
from .shard import rank, rank_device, world_size
from .stream_shard_fused import build_sharded_stream

# A rank's value table must fit this much device memory at the final
# segment width for a grouped stream to be adopted.
DEVICE_BUDGET = 2 * 1024 ** 3


def _ev4d(ev):
    """[p, nc, C, 5] -> field-major [p, nc, 5, C]."""
    return np.ascontiguousarray(ev.transpose(0, 1, 3, 2))


def _pad_bc(chunks, dummy):
    """Pad a ShardedChunks' bc arrays to a multiple of 8 rows."""
    CB8 = max(8, _r8(chunks.CB))
    nc = chunks.nchunks
    p = chunks.mine_bc.shape[0]
    bidx = np.full((nc, CB8), dummy, np.int32)
    bidx[:, :chunks.bc_idx.shape[1]] = chunks.bc_idx
    mbc = np.zeros((p, nc, CB8), np.int32)
    mbc[:, :, :chunks.mine_bc.shape[2]] = chunks.mine_bc
    return bidx, mbc


def stream_arrays(ses, n: int) -> tuple:
    """The reference driver's stream arguments of ``fused_sharded_solve``
    (numpy, in its order: fhs, fhsl, fhd, f_mdiag, f_cnt, f_ev1, f_ev2,
    f_bidx, f_bcnt, f_mbc, s_cnt, s_ev1, s_ev2, s_bidx, s_bcnt, s_mbc,
    xown). Factor bc indices are rank-local (the partitioned value table,
    padded with the last table row); solve bc indices are global X rows
    (padded with the dummy row n)."""
    p = ses.p
    Lp8 = _r8(ses.Lp)
    f = ses.factor
    CBf8 = max(8, _r8(f.CB))
    fb_idx = np.full((p, f.nchunks, CBf8), Lp8 - 1, np.int32)
    fb_idx[:, :, :ses.bc_loc.shape[2]] = ses.bc_loc
    fb_mbc = np.zeros((p, f.nchunks, CBf8), np.int32)
    fb_mbc[:, :, :f.mine_bc.shape[2]] = f.mine_bc
    sb_idx, sb_mbc = _pad_bc(ses.solve, n)
    xown = np.zeros((p, _r8(n)), np.int32)
    xown[np.arange(n) % p, np.arange(n)] = 1
    s = ses.solve
    return (f.h_step, ses.h_slot_loc, f.h_div, f.mine_diag, f.counts,
            _ev4d(f.ev1), _ev4d(f.ev2), fb_idx, f.bc_cnt, fb_mbc,
            s.counts, _ev4d(s.ev1), _ev4d(s.ev2), sb_idx, s.bc_cnt, sb_mbc,
            xown)


def plan_sharded(A: SlipMatrix, analysis: Analysis, p: int,
                 options: Options, heads_per_chunk: int = 8,
                 pass1_events: int = 32, pass2_events: int = 128):
    """The sharded driver's planning phase: schedule and the stream
    partitioned over p ranks, with grouped (subtree-local) adoption (the
    reference's rules, costs and cache keys). Runs nothing on a device.
    Returns (sched, r, ses, avals, q), cached on the Analysis under (p,
    capacities, pinned rows).

    Grouped adoption: G independent groups feed every chunk, so a rank's
    capacity binds and p ranks shorten the serial chunk scan by up to p.
    Each candidate stream is costed at its own width (a dissection can
    shorten the scan but widen the pivots) and adopted only when the
    modelled wall time wins at this rank count."""
    n = A.n
    q = np.asarray(analysis.q, dtype=np.int64)
    fixed_r = analysis.sparse_fixed_r
    skey = None if fixed_r is None else fixed_r.tobytes()
    key = (p, heads_per_chunk, pass1_events, pass2_events, skey)
    cache = getattr(analysis, "fused_shard_cache", None)
    if cache is not None and cache[0] == key:
        return cache[1] + (q,)
    q, built = _resolve_order(A, analysis, q, fixed_r)
    sched, r = built if built is not None \
        else build_schedule_best(A, q, fixed_r)
    ses = build_sharded_stream(sched, p, heads_per_chunk,
                               pass1_events, pass2_events)
    subtree_mode = os.environ.get("SLIP_FUSED_SUBTREE", "1")
    if subtree_mode != "0":
        from ..gpu.schedule_subtree import try_build_grouped
        # the group count scales with the ranks: more, smaller groups keep
        # each rank's capacity binding and shorten the solve scan
        G = min(32, max(8, 2 * p))
        ses_g = try_build_grouped(
            sched, 8, max(64, pass1_events), pass2_events,
            n_groups=G, p=p)
        cand = None
        if ses_g is None and fixed_r is None and n >= 192:
            cand = _dissect_candidate(A, analysis, options, n_groups=G)
            if cand is not None:
                ses_g = try_build_grouped(
                    cand[2], 8, max(64, pass1_events),
                    pass2_events, n_groups=G, p=p)

        def scan(s):
            return s.factor.nchunks + s.solve.nchunks

        def _cost(s, West):
            # the reference's model of a solve's wall time: a per-chunk
            # floor plus a per-event cost quadratic in the segment width
            # the planner will choose; events divide over the ranks, the
            # scan does not
            F, Ec = 15e-6, 2e-9
            tot = 0.0
            for sc in (s.factor, s.solve):
                ml = np.asarray(sc.max_level, np.float64)
                wq = (np.minimum(
                    West, West * (ml + 2) / n + 2) / 8.0) ** 2
                ev = sc.counts[:, :, 1:3].sum(
                    axis=(0, 2)).astype(np.float64)
                tot += (F * sc.nchunks
                        + Ec * float((ev / p * wq).sum()))
            return tot

        adopt = ses_g is not None and subtree_mode == "force"
        if ses_g is not None and not adopt:
            wc = getattr(analysis, "fused_width_cache", None)
            West_u = wc[0] if wc else _width_probe(
                A, analysis, options, fixed_r=r)
            if West_u is None:
                W_in0 = _input_width(
                    [int(A.x[i]) for i in range(int(A.p[n]))])
                hb = getattr(analysis, "hadamard_bits_cache", None)
                if hb is None:
                    hb = hadamard_bits(A)
                    analysis.hadamard_bits_cache = hb
                Wf0 = factor_width(A, hbits=hb)
                West_u = min(max(2, W_in0 + 1,
                                 min(-(-Wf0 // 16), 16)), Wf0)
            West_g = cand[4] if cand is not None else West_u
            # a rank's value table must fit its device memory budget at
            # the final segment width
            fits = _r8(ses_g.Lp) * _r8(West_g) * 4 <= DEVICE_BUDGET
            adopt = (fits and scan(ses_g) < scan(ses)
                     and _cost(ses_g, West_g)
                     < 0.9 * _cost(ses, West_u))
        if adopt:
            ses = ses_g
            if cand is not None:
                # commit the dissection: reorder, pinned rows, exact width
                # seed, fresh cache keys
                q, fixed_r, sched, r, _Wx = cand
                analysis.q = q
                analysis.sparse_fixed_r = fixed_r
                skey = fixed_r.tobytes()
                analysis.fused_pin_check = (skey, _Wx)
                analysis.fused_sched_only_cache = (skey, (sched, r))
                key = (p, heads_per_chunk, pass1_events,
                       pass2_events, skey)
    Aq = _permute_cols(A, q)
    avals = [int(Aq.x[idx]) for c in range(n)
             for idx in range(int(Aq.p[c]), int(Aq.p[c + 1]))]
    analysis.fused_shard_cache = (key, (sched, r, ses, avals))
    return sched, r, ses, avals, q


def _rank_streams(analysis, ses, n, rk, dev):
    """This rank's stream tensors, cached on the Analysis per plan, rank
    and device: warm solves upload nothing but the values."""
    key = (analysis.fused_shard_cache[0], rk, str(dev))
    cache = getattr(analysis, "fused_shard_tensors", None)
    if cache is not None and cache[0] == key:
        return cache[1]
    rs = rank_streams(rk, dev, *stream_arrays(ses, n))
    analysis.fused_shard_tensors = (key, rs)
    return rs


def factorize_solve_cuda_fused_sharded(A: SlipMatrix, analysis: Analysis,
                                       b: SlipMatrix, group=None,
                                       options: Optional[Options] = None,
                                       device="cuda",
                                       heads_per_chunk: int = 8,
                                       pass1_events: int = 32,
                                       pass2_events: int = 128
                                       ) -> SlipMatrix:
    """Exact solve of A x = b over the ranks of ``group`` (None: the
    default process group, which the caller initialises: NCCL on cards,
    gloo on the CPU). Every rank calls it with the same arguments and
    gets the same x. device: "cuda" runs the kernels on this rank's card
    (``cuda:<local rank>``); "cpu" runs their plain versions."""
    options = options or Options()
    options.validate()
    dev = _device(device)
    p, rk = world_size(group), rank(group)
    dev = rank_device(dev, group)
    if A.kind != Kind.CSC or A.type != Type.MPZ:
        raise SlipIncorrectInputError(
            "sharded fused path requires CSC x MPZ input")
    if options.pivot_exact:
        raise SlipIncorrectInputError(
            "pivot_exact is not supported on the sharded cuda-fused path yet "
            "(pinned pivot schemes are queued in ROADMAP.md); use "
            "backend='host'")
    n = A.n
    if b.m != n:
        raise SlipIncorrectInputError(
            f"b has {b.m} rows, matrix has {n}")
    bz = matrix_copy(b, Kind.DENSE, Type.MPZ, options)
    nrhs = bz.n
    if n == 0:
        return SlipMatrix.allocate(Kind.DENSE, Type.MPQ, 0, nrhs)
    st = SolveStats(backend="cuda-fused-sharded", n=n, nnz=int(A.p[n]),
                    nrhs=nrhs)

    with phase_timer(st, "schedule"):
        sched, r, ses, avals, q = plan_sharded(
            A, analysis, p, options, heads_per_chunk, pass1_events,
            pass2_events)
        rs = _rank_streams(analysis, ses, n, rk, dev)
    fixed_r = analysis.sparse_fixed_r
    st.lnz, st.unz = ses.lnz, ses.unz
    Lp8 = _r8(ses.Lp)

    hbits = getattr(analysis, "hadamard_bits_cache", None)
    if hbits is None:
        hbits = hadamard_bits(A)
        analysis.hadamard_bits_cache = hbits
    W_full = factor_width(A, hbits=hbits)
    Ws_full = solve_width(A, bz.x, W_full, n, hbits=hbits)
    if ses.ndet is not None:
        # grouped merge intermediates can exceed the single-minor bound by
        # a few bits (the same headroom as the single-chip path)
        W_full += 1
        Ws_full += 1
    W_in = _input_width(avals)
    Wb_in = _input_width(bz.x.reshape(-1))
    if options.max_limbs is not None:
        W = factor_width(A, options.max_limbs, hbits=hbits)
        Ws = solve_width(A, bz.x, W, n, options.max_limbs, hbits=hbits)
    else:
        # converged single-chip widths transfer exactly (same pivot
        # sequence): reuse the fused cache when present
        wcache = getattr(analysis, "fused_width_cache", None)
        if wcache is not None:
            W, Ws = wcache
            W = min(max(W, W_in), W_full)
            Ws = min(max(Ws, W + 1, Wb_in), Ws_full)
        else:
            W = min(max(2, W_in + 1, min(-(-W_full // 16), 16)),
                    W_full)
            Ws = min(max(W + 1, Wb_in + 1,
                         min(-(-Ws_full // 16), 32)), Ws_full)
        # an exact pinned-pivot width (dissection commit) beats any guess
        pchk = getattr(analysis, "fused_pin_check", None)
        if (pchk is not None and fixed_r is not None
                and pchk[0] == fixed_r.tobytes()
                and pchk[1] is not None):
            W = min(max(W, pchk[1], W_in + 1), W_full)
            Ws = min(max(Ws, W + 1), Ws_full)

    mine = np.asarray(ses.init_chip) == rk
    while True:
        W8 = _r8(W)
        Ws8 = _r8(max(Ws, W + 1))
        WI8 = _r8(max(W8, Ws8) + 2)
        st.W, st.Ws = W8, Ws8
        # adaptive-width chunk segments, re-planned per ladder rung
        # (overflow widens the whole rung); short scans stay one segment
        Wmin_in = max(2, W_in + 1)
        segments = _merged(plan_segments(
            ses.factor.max_level, n, W, Wmin_in)) \
            if ses.factor.nchunks >= 256 \
            else ((0, ses.factor.nchunks, W8),)
        bcols = [[int(bz.x[int(r[k]), c]) for k in range(n)]
                 for c in range(nrhs)]
        Wb = _tc_width((v for col in bcols for v in col), Ws8)
        if ses.solve.nchunks >= 256:
            ssegplan = plan_segments(
                ses.solve.max_level, n, max(Ws, W + 1),
                max(Wmin_in, Wb + 1))
            for sp in ssegplan:
                sp[2] = min(max(sp[2], _r8(Wb + 1)), Ws8)
            ssegplan[-1][2] = Ws8
            ssegments = _merged(ssegplan)
        else:
            ssegments = ((0, ses.solve.nchunks, Ws8),)
        w0 = segments[0][2]
        ws0 = ssegments[0][2]
        with phase_timer(st, "pack"):
            # this rank's slice of the partitioned value table [Lp8, w0]
            val_in = np.zeros((Lp8, w0), dtype=np.int32)
            val_in[ses.init_loc[mine]] = ints_to_tc_rows(avals, w0)[mine]
            if ses.extra_chip is not None and len(ses.extra_chip):
                # grouped streams: constant / scratch slot inits
                em = np.asarray(ses.extra_chip) == rk
                val_in[ses.extra_loc[em]] = ints_to_tc_rows(
                    ses.extra_vals, w0)[em]
            X8 = _r8(n + 1 + ses.nxx)
            X0 = np.zeros((nrhs, X8, ws0), dtype=np.int32)
            for c in range(nrhs):
                X0[c, :n] = ints_to_tc_rows(bcols[c], ws0)
        with phase_timer(st, "device"):
            flat = fused_sharded_solve(
                group, n, W8, Ws8, WI8, rs,
                torch.from_numpy(val_in).to(dev),
                torch.from_numpy(X0).to(dev), ndet=ses.ndet,
                segments=segments, ssegments=ssegments).cpu().numpy()
        fsing, fovf, sovf = (bool(flat[0]), bool(flat[1]),
                             bool(flat[2]))
        if fsing and not fovf:
            break                       # genuine cancellation: replan
        if fovf or sovf:
            W2, Ws2 = W, Ws
            if fovf:
                W2 = min(2 * W, W_full)
            else:
                Ws2 = min(2 * Ws, Ws_full)
            Ws2 = max(Ws2, W2 + 1)
            if (W2, Ws2) == (W, Ws):
                if fsing:
                    break
                raise SlipLimbOverflowError(
                    "overflow persists at the analytic width bound "
                    f"(W={W}, Ws={Ws})")
            W, Ws = W2, Ws2
            st.retries += 1
            continue
        if options.max_limbs is None:
            # converged widths are pivot-sequence properties: share them
            # with the single-chip fused driver's cache
            analysis.fused_width_cache = (W, Ws)
        with phase_timer(st, "unpack"):
            o = 3
            det = tc_rows_to_ints(flat[o:o + W8][None, :])[0]
            o += W8
            x = SlipMatrix.allocate(Kind.DENSE, Type.MPQ, n, nrhs)
            factor = A.scale / bz.scale
            fnum, fden = factor.numerator, factor.denominator
            den_all = det * fden
            for c in range(nrhs):
                xh = tc_rows_to_ints(
                    flat[o:o + n * Ws8].reshape(n, Ws8))
                o += n * Ws8
                for k in range(n):
                    x.x[int(q[k]), c] = _mpq(xh[k] * fnum, den_all)
        record(st)
        return x

    # exact cancellation on the scheduled pivots: the single-chip fused
    # driver replans around the oracle's pivot rows (and pins them on the
    # shared Analysis for later sharded solves); every rank takes it.
    # Recorded after that solve, so last_stats() reports the fallback.
    from ..gpu.backslash_fused import factorize_solve_cuda_fused
    st.fallback = True
    with phase_timer(st, "fallback"):
        x = factorize_solve_cuda_fused(A, analysis, b, options, device=dev)
    record(st)
    return x
