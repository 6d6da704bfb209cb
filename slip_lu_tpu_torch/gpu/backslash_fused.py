"""Host glue for the fused exact solve on a CUDA device.

Port of ``slip_lu_tpu/tpu/backslash_fused.py:factorize_solve_tpu_fused``
for one full-width segment, ungrouped streams and one system (G = 1):

  1. ordering q + transversal r, symbolic elimination, uniform-event
     chunk streams (host, numpy), cached on the Analysis with the
     stream tensors keyed by device;
  2. A's values packed as two's-complement limb rows, cached per
     (stream, width, device);
  3. ``fused_solve_all``: the factor stream and each right-hand side's
     solve stream, one flat int32 vector back;
  4. widen-and-retry on overflow, the host pin-check, a replan around
     the oracle's pivots on exact cancellation, the decode to rationals.

Left for later work, as the reference allows (each is an optimization or
a TPU memory artifact, sound either way): width segments
(``SLIP_FUSED_SEGMENTS=0`` in the reference), grouped subtree streams
(``SLIP_FUSED_SUBTREE=0``), packed tables and HBM value tables,
right-hand-side lanes, and ``pivot_exact`` pinning. The last resort
after both plans flag a singular pivot is the host oracle for every n
on the CPU (the dense device path is not ported yet); on a device that
can only be a kernel fault, and it raises.
"""

from __future__ import annotations

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


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for, but torch finds "
                           "no CUDA device (pass device='cpu' to run the "
                           "kernels' plain versions)")
    if dev.type not in ("cuda", "cpu"):
        raise SlipIncorrectInputError(f"unsupported device {device!r}")
    return dev


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
        while True:
            W8 = _r8(W)
            Ws8 = _r8(max(Ws, W + 1))
            WN = _r8(2 * W8 + 2)
            WNS = _r8(W8 + Ws8 + 2)
            WI8 = _r8(max(W8, Ws8) + 2)   # GT width: verified short
            #                                 division (factor_fused)
            st.W, st.Ws = W8, Ws8
            with phase_timer(st, "pack"):
                # A's limb table per (schedule, width, device): upload
                # once, reuse across solves (the kernels never write it)
                vkey = (key, W8, str(dev))
                vcache = getattr(analysis, "fused_val_cache", None)
                if vcache is not None and vcache[0] == vkey:
                    val_dev = vcache[1]
                else:
                    val_dev = val_tensor(avals, es.init_pos, E, W8, dev)
                    analysis.fused_val_cache = (vkey, val_dev)
                bcols = [[int(bz.x[int(r[k]), c]) for k in range(n)]
                         for c in range(nrhs)]
                Wb = _tc_width((v for col in bcols for v in col), Ws8)
                b_rows = torch.from_numpy(np.stack(
                    [ints_to_tc_rows(col, Wb) for col in bcols])).to(dev)
            with phase_timer(st, "device"):
                flat = fused_solve_all(n, W8, Ws8, WN, WNS, WI8, streams,
                                       val_dev, b_rows).cpu().numpy()
            sing = bool(flat[0])
            f_ovf = bool(flat[1])
            det_row = flat[2:2 + W8][None, :]
            o = 2 + W8
            X_h = []
            s_ovf = False
            for c in range(nrhs):
                s_ovf = s_ovf or bool(flat[o + 1])
                X_h.append(flat[o + 2:o + 2 + n * Ws8].reshape(n, Ws8))
                o += 2 + n * Ws8
            # Flag trust: a sing with no overflow in the factor stream
            # cannot be a truncation artifact — every value feeding the
            # pivot fit its width, so the cancellation is real. A sing
            # that rides with overflow is inconclusive: integer pivot
            # sequences can be 2-adically deep (exact pivots = 0 mod
            # 2^(16*W8) for many rungs), so climb instead. At the
            # analytic bound genuine overflow is impossible, so the
            # ladder terminates.
            if sing and not f_ovf:
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
                    st.retries += 1
                    continue
            if f_ovf or s_ovf:
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
                W, Ws = W2, Ws2
                st.retries += 1
                continue
            if options.max_limbs is None:
                analysis.fused_width_cache = (W, Ws)
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
    # hidden behind a host answer. The plain versions on the CPU keep the
    # reference's last resort, the host oracle (exact at any n; the dense
    # device path is not ported). Recorded after the host solve, so
    # last_stats() reports the fallback.
    if dev.type != "cpu":
        raise SlipPanicError(
            f"the {dev.type} stream kernels flagged a singular pivot under "
            "the oracle's pinned nonzero pivots — internal invariant "
            "violated")
    st.fallback = True
    from ..backslash import backslash
    x = backslash(A, b, Type.MPQ, options, backend="host")
    record(st)
    return x
