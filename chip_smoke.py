#!/usr/bin/env python3
"""Smoke run of slip_lu_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the kernels from slip_lu_tpu_torch/csrc with nvcc (one process per
source, in parallel; then times one nvcc over all sources beside it) and
drives the main path on four cases: uni10k
(default ordering), uni100k in natural order, uni100k in its default
ordering (a dissected, grouped stream in two width segments, GT
re-lifted by K4 at the boundary) and tri1000 (default ordering,
segmented). Each case makes one cold ``backslash(..., backend="cuda-fused",
device="cuda")`` call, which plans from scratch (dissection included,
wherever the reference pays it), held to the host oracle and to
``Options(check=True)``; then three warm solves through
``factorize_solve_cuda_fused`` on the Analysis that call built, the way
the JAX package's bench.py times its solves. The kernels' launch counts
are set to 0 before each case and read after it.

Then the card's busy share (torch.profiler: one ``backslash`` call on
uni10k, one solve on a reused Analysis for every case), and every kernel
held to its plain PyTorch version on the card: K2 and K3 on uni10k's
stream (at the width the ladder settled on, and clamped below need on the
shortest overflowing prefix); K4 on uni100k's real segment-boundary
tables and on a synthetic table at WIn >= 256; K2 on uni100k's second
factor segment (its tables handed in) and K3 on its widest solve segment;
and the whole segmented, grouped device half (``fused_solve_all``) on a
dissected band, against the same call on CPU copies. Every comparison is
bit equality: all values are exact integers. Exits non-zero on any
failure, and when there is no CUDA device or no slip_lu_tpu_torch beside
it.

Output: a few lines of results, the card's name and power limit, a JSON
line with one entry per kernel, and last the line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MATS = os.path.join(HERE, "data", "ExampleMats")

# The card's published peaks that the bounds use (H100 SXM, 700 W): device
# memory at 3.35 TB/s, and its exact integer peak, int8 on the tensor cores
# at 1,979 TOP/s: two operations a byte multiply-add, four byte products a
# 16-bit limb product, so 2.47e14 limb products/s.
HBM_BYTES_PER_S = 3.35e12
LIMB_PRODUCTS_PER_S = 1979e12 / 2 / 4


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        _fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def _load(slip, name):
    A = slip.read_triplet(os.path.join(MATS, f"{name}_mat.txt"))
    b = slip.read_dense(os.path.join(MATS, f"{name}_v.txt"))
    return A, b


def _same_x(x, y) -> bool:
    return x.m == y.m and x.n == y.n and all(
        x.x[i, c] == y.x[i, c] for i in range(x.m) for c in range(x.n))


@dataclasses.dataclass
class Case:
    label: str
    name: str
    order: object            # an Ordering, or None for the default
    grouped: bool = False    # the grouped stream must be adopted
    segmented: bool = False  # >= 2 factor segments, K4 launched
    A2: object = None        # CSC x MPZ copy and the cold call's Analysis
    ana: object = None
    b: object = None
    opts: object = None


def _counters():
    from slip_lu_tpu_torch.gpu import factor_fused as ff
    from slip_lu_tpu_torch.gpu import relift as rl
    return {"factor_stream": ff.factor_stream, "solve_stream": ff.solve_stream,
            "relift_gt": rl.relift_gt}


def main_path(slip, torch, case: Case, warm: int):
    """One case: the cold backslash call (its Analysis kept), then warm
    solves on that Analysis, each checked against the host oracle. Returns
    the result lines and the kernels' launches."""
    import importlib

    from slip_lu_tpu_torch.convert import matrix_copy
    from slip_lu_tpu_torch.gpu.backslash_fused import \
        factorize_solve_cuda_fused
    from slip_lu_tpu_torch.matrix import Kind, Type

    A, b = _load(slip, case.name)
    opts = slip.Options(check=True) if case.order is None else \
        slip.Options(check=True, order=case.order)
    t0 = time.perf_counter()
    x_host = slip.backslash(A, b, slip.Type.MPQ, opts, backend="host")
    host_s = time.perf_counter() - t0
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    # keep the Analysis the cold call builds (backslash makes its own;
    # the package's name backslash is the function, hence import_module)
    bs = importlib.import_module("slip_lu_tpu_torch.backslash")
    built = []
    real_analyze = bs.analyze

    def keep(*args, **kw):
        built.append(real_analyze(*args, **kw))
        return built[-1]

    bs.analyze = keep
    # the driver prints each rung of its width ladder (widths, segments,
    # flags) during the cold call
    os.environ["SLIP_FUSED_DEBUG"] = "1"
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = slip.backslash(A, b, slip.Type.MPQ, opts, backend="cuda-fused",
                           device="cuda")
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
    finally:
        bs.analyze = real_analyze
        del os.environ["SLIP_FUSED_DEBUG"]
    st = slip.last_stats()
    cold_phases = dict(st.phases)
    if st.backend != "cuda-fused" or st.fallback:
        _fail(f"{case.label}: fell back ({st.summary()})")
    if not _same_x(x, x_host):
        _fail(f"{case.label}: solution differs from the host oracle")
    ana = built[0]
    A2 = matrix_copy(A, Kind.CSC, Type.MPZ, opts)
    times, dev_times = [], []
    for _ in range(warm):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xw = factorize_solve_cuda_fused(A2, ana, b, opts, device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        stw = slip.last_stats()
        dev_times.append(stw.phases.get("device", 0.0))
        if stw.fallback or not _same_x(xw, x_host):
            _fail(f"{case.label}: warm solve differs from the host oracle")
    launches = {k: fn.launches for k, fn in counters.items()}
    es = ana.fused_cache[1][2]
    segments, ssegments = ana.fused_seg_cache[2], ana.fused_seg_cache[4]
    if case.grouped and es.grouped is None:
        _fail(f"{case.label}: the grouped stream was not adopted")
    if case.segmented and (len(segments) < 2 or launches["relift_gt"] == 0):
        _fail(f"{case.label}: factor plan {segments}, relift_gt launched "
              f"{launches['relift_gt']} times")
    for k in ("factor_stream", "solve_stream"):
        if launches[k] == 0:
            _fail(f"{case.label}: the main path never launched {k}")
    case.A2, case.ana, case.b, case.opts = A2, ana, b, opts
    out = [
        f"main path {case.label}: n={A.n} nnz={st.nnz} W8={st.W} "
        f"Ws8={st.Ws} retries={st.retries} grouped="
        f"{es.grouped is not None} factor chunks {es.factor.nchunks} solve "
        f"chunks {es.solve.nchunks} segments {list(segments)} ssegments "
        f"{list(ssegments)} exact=oracle, check=True",
        f"  cold backslash {cold_s:.3f} s, phases (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in cold_phases.items()),
        f"  warm solves on the reused Analysis: median "
        f"{statistics.median(times):.3f} s (device "
        f"{statistics.median(dev_times):.3f} s) over {warm}; host oracle "
        f"{host_s:.3f} s",
        f"  launches {launches}"]
    return out, launches


def _time_ms(torch, fn, reps):
    """Median wall time of fn() on the card, in ms (CUDA events)."""
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        res = fn()
        z.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(z))
    return statistics.median(ts), res


def _diff(xs, ys) -> int:
    """Max |x - y| over pairs of int32 tensors (0 = bit-equal)."""
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
               for x, y in zip(xs, ys))


def _prefix(st, kf: int, ks: int):
    """The first kf factor chunks and ks solve chunks of a stream."""
    from slip_lu_tpu_torch.gpu.factor_fused import chunk_range
    return chunk_range(chunk_range(st, 0, kf, True), 0, ks, False)


def _shortest_overflowing(overflows, nc: int) -> int:
    """Fewest leading chunks k for which overflows(k) (a kernel run on
    them) is true, or nc. The flag only accumulates along a stream, so
    bisect; kernel runs cost milliseconds."""
    if not overflows(nc):
        return nc
    lo, hi = 0, nc            # overflows(hi), not overflows(lo)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if overflows(mid):
            hi = mid
        else:
            lo = mid
    return hi


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for a kernel's work
# ---------------------------------------------------------------------------

def _trunc(nx: int, ny: int, D: int) -> int:
    """Limb products of an nx-by-ny product kept below limb D."""
    return sum(min(k, nx - 1) - max(0, k - ny + 1) + 1
               for k in range(min(D, nx + ny - 1)))


def _bound(ops: float, nbytes: float):
    t_ops, t_bytes = ops / LIMB_PRODUCTS_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _pass_ops(ev, cnt, Wt, W8, WQ, WV, has_ab):
    """Limb products of the pass events of one stream (this run's data:
    mult row 0 skips the product, div row 0 the division)."""
    import numpy as np
    live = np.arange(ev.shape[2])[None, :] < cnt[:, None]
    m, d = ev[:, 1, :], ev[:, 2, :]
    per = (m != 0) * Wt * W8 + (d != 0) * (_trunc(WQ, WQ, WQ)
                                           + _trunc(WQ, W8, WV))
    if has_ab:
        per = per + W8 * Wt
    return float((per * live).sum())


def _stream_bound(st, W8, Ws8, WI8, factor: bool):
    """Limb products and stream bytes of K2 (factor) or K3 (solve) over a
    whole stream at these widths: each input read once."""
    import numpy as np

    def nb(t):
        return t.numel() * 4

    Wt = W8 if factor else Ws8
    WQ = min(WI8, ((Wt + 2 + 7) // 8) * 8)
    WV = ((WQ + W8 + 7) // 8) * 8
    if factor:
        hm = st.fhm_host
        H = st.H
        ev1, ev2 = st.fev1.cpu().numpy(), st.fev2.cpu().numpy()
        ops = _pass_ops(ev1, hm[:, 3 * H + 1], W8, W8, WQ, WV, False) + \
            _pass_ops(ev2, hm[:, 3 * H + 2], W8, W8, WQ, WV, True)
        heads = hm[:, :H] >= 0
        fix = (hm[:, 2 * H:3 * H] != hm[:, :H]) & heads & \
            ((hm[:, 3 * H + 3:3 * H + 4] & 256) != 0)
        live = np.arange(H)[None, :] < hm[:, 3 * H:3 * H + 1]
        lift = 0
        w = 1
        while w < WI8:
            w2 = min(2 * w, WI8)
            lift += _trunc(w2, w, w2) + _trunc(w, w2, w2)
            w = w2
        ops += float(fix.sum()) * (W8 * W8 + _trunc(WQ, WQ, WQ)
                                   + _trunc(WQ, W8, WV))
        ops += float((live & heads).sum()) * lift
        nbytes = nb(st.fhm) + nb(st.fev1) + nb(st.fev2)
        return ops, nbytes
    cn = st.scnt_host
    ev1, ev2 = st.sev1.cpu().numpy(), st.sev2.cpu().numpy()
    ops = _pass_ops(ev1, cn[:, 1], Ws8, W8, WQ, WV, False) + \
        _pass_ops(ev2, cn[:, 2], Ws8, W8, WQ, WV, True)
    return ops, nb(st.scnt) + nb(st.sev1) + nb(st.sev2)


def _factor_bound(st, E8, n8, W8, WI, tables_in: bool):
    """Limb products and bytes of K2 over st: val in and out; SMT, GT, TZ
    and the flags written, and read too when a segment takes them in."""
    ops, nbytes = _stream_bound(st, W8, W8, WI, True)
    tabs = n8 * (W8 + WI + 8)
    return ops, nbytes + 4 * (2 * E8 * W8 + (1 + tables_in) * tabs + 8)


def _solve_bound(st, E8, n8, W8, Ws8, WI, nx):
    """Limb products and bytes of K3 over st: val, SMT, GT, TZ read; X
    (nx limbs) in and out; the flags written."""
    ops, nbytes = _stream_bound(st, W8, Ws8, WI, False)
    return ops, nbytes + 4 * (E8 * W8 + n8 * (W8 + WI + 8) + 2 * nx + 8)


# ---------------------------------------------------------------------------
# the kernels against their plain versions
# ---------------------------------------------------------------------------

def stream_checks(slip, torch, case: Case):
    """K2 and K3 against their plain versions on uni10k's stream: the
    whole stream at the width the ladder settled on, then a width clamped
    below need on the shortest prefix of the stream that overflows (the
    garbage after the first overflow is compared all the same)."""
    from slip_lu_tpu_torch.convert import matrix_copy
    from slip_lu_tpu_torch.gpu import factor_fused as ff
    from slip_lu_tpu_torch.gpu.backslash_fused import _tc_width
    from slip_lu_tpu_torch.matrix import Kind, Type

    ana, A2 = case.ana, case.A2
    _, (_, r, es, avals) = ana.fused_cache
    W, Ws = ana.fused_width_cache
    n = A2.n
    nd = n if es.ndet is None else es.ndet    # the determinant row
    dev = torch.device("cuda")
    st = ff.stream_tensors(es, dev)
    nf, ns = st.fhm.shape[0], st.scnt.shape[0]
    bz = matrix_copy(case.b, Kind.DENSE, Type.MPZ)
    bcol = [int(bz.x[int(r[k]), 0]) for k in range(n)]
    lines, report = [], {}
    for label, W_run in (("settled", W), ("clamped", 2)):
        W8 = ff._r8(W_run)
        Ws8 = ff._r8(max(Ws if label == "settled" else 3, W_run + 1))
        WN, WNS = ff._r8(2 * W8 + 2), ff._r8(W8 + Ws8 + 2)
        WI8 = ff._r8(max(W8, Ws8) + 2)
        val = ff.val_tensor(avals, es.init_pos, es.nnz, W8, dev,
                            es.extra_pos, es.extra_vals)
        Wb = _tc_width(bcol, Ws8)
        X0 = ff.x_tensor(torch.from_numpy(
            ff.ints_to_tc_rows(bcol, Wb)).to(dev), n, Ws8, es.nxx)
        tables = ff.factor_stream(st, val, nd, W8, WN, WI8)[:4]
        kf, ks = nf, ns
        if label == "clamped":
            kf = _shortest_overflowing(lambda k: bool(ff.factor_stream(
                _prefix(st, k, ns), val, nd, W8, WN, WI8)[4][1]), nf)
            ks = _shortest_overflowing(lambda k: bool(ff.solve_stream(
                _prefix(st, nf, k), *tables, X0, W8, Ws8, WNS, WI8)[1][1]),
                ns)
        fst, sst = _prefix(st, kf, ns), _prefix(st, nf, ks)
        reps = 3 if label == "settled" else 1
        k_ms, fk = _time_ms(torch, lambda: ff.factor_stream(
            fst, val, nd, W8, WN, WI8), reps)
        p_ms, fp = _time_ms(torch, lambda: ff.factor_stream_ref(
            fst, val, nd, W8, WN, WI8), 1)
        ks_ms, (Xk, sk) = _time_ms(torch, lambda: ff.solve_stream(
            sst, *tables, X0, W8, Ws8, WNS, WI8), reps)
        ps_ms, (Xp, sp) = _time_ms(torch, lambda: ff.solve_stream_ref(
            sst, *tables, X0, W8, Ws8, WNS, WI8), 1)
        f_err, s_err = _diff(fk, fp), _diff((Xk, sk), (Xp, sp))
        fflags, sflags = fk[4].tolist(), sk.tolist()
        if fflags != fp[4].tolist() or sflags != sp.tolist():
            _fail(f"{label}: kernel flags {fflags}/{sflags} differ from "
                  f"the plain version's {fp[4].tolist()}/{sp.tolist()}")
        if f_err or s_err:
            _fail(f"{label}: kernel tables differ from the plain version "
                  f"(factor max |diff| {f_err}, solve {s_err})")
        if label == "settled" and (any(fflags) or any(sflags)):
            _fail(f"settled width raised flags {fflags} {sflags}")
        if label == "clamped" and not (fflags[1] and sflags[1]):
            _fail(f"clamped width raised no overflow flag: {fflags} "
                  f"{sflags}")
        lines.append(
            f"kernels vs plain, {case.label} {label} W8={W8} Ws8={Ws8} on "
            f"{kf}/{nf} factor and {ks}/{ns} solve chunks: factor flags "
            f"{fflags[:5]}, solve flags {sflags[:5]}, bit-equal; "
            f"factor_stream {k_ms:.3f} ms vs plain {p_ms:.3f} ms; "
            f"solve_stream {ks_ms:.3f} ms vs plain {ps_ms:.3f} ms")
        if label == "settled":
            E8, n8 = val.shape[0], tables[0].shape[0]
            fops, fbytes = _factor_bound(st, E8, n8, W8, WI8, False)
            sops, sbytes = _solve_bound(st, E8, n8, W8, Ws8, WI8,
                                        X0.numel())
            report = {"factor_stream": (f_err, k_ms, p_ms,
                                        *_bound(fops, fbytes)),
                      "solve_stream": (s_err, ks_ms, ps_ms,
                                       *_bound(sops, sbytes))}
            lines.append(
                f"  bounds at W8={W8} Ws8={Ws8}: factor {fops:.4g} limb "
                f"products, {fbytes:.4g} bytes -> "
                f"{report['factor_stream'][3]:.4f} ms "
                f"({report['factor_stream'][4]}); solve {sops:.4g} "
                f"products, {sbytes:.4g} bytes -> "
                f"{report['solve_stream'][3]:.4f} ms "
                f"({report['solve_stream'][4]})")
    return lines, report


def _relift_bound(rows, W8, WIo, WIn):
    from slip_lu_tpu_torch.gpu.relift import newton_steps
    ops = rows * newton_steps(WIo, WIn) * 2 * _trunc(WIn, WIn, WIn)
    return _bound(ops, 4 * rows * (W8 + WIo + 8 + WIn))


def _synthetic_relift_tables(torch, ff):
    """SMT, GT, TZ of 4,096 rows at W8 = 256, WIo = 32 (K4 then lifts to
    264 limbs): the identity row, true rho and inverse pairs, seeds that
    are no inverse, and zero rows, from a seed."""
    import numpy as np
    rng = np.random.default_rng(7)
    n8, W8, WIo = 4096, 256, 32
    S = np.zeros((n8, W8), np.int32)
    G = np.zeros((n8, WIo), np.int32)
    Z = np.zeros((n8, 8), np.int32)
    S[0, 0] = G[0, 0] = 1
    for r in range(1, n8 // 2):
        v = int(rng.integers(1, 2**62)) ** 60 << int(rng.integers(0, 64))
        v = -v if r % 2 else v
        tz = (v & -v).bit_length() - 1
        S[r] = ff.ints_to_tc_rows([v], W8)[0]
        Z[r] = tz
        G[r] = ff.ints_to_tc_rows([pow(v >> tz, -1, 1 << (16 * WIo))],
                                  WIo)[0]
    S[n8 // 2:n8 - 8] = rng.integers(0, 1 << 16, (n8 // 2 - 8, W8))
    G[n8 // 2:n8 - 8] = rng.integers(0, 1 << 16, (n8 // 2 - 8, WIo))
    Z[n8 // 2:n8 - 8] = rng.integers(0, 16 * W8, (n8 // 2 - 8, 1))
    return [torch.from_numpy(t).to("cuda") for t in (S, G, Z)]


def boundary_checks(torch, case: Case):
    """The kernels against their plain versions on the card at the shapes
    uni100k's two-segment path gives them: K4 on the real tables after
    factor segment 0 (SMT widened to segment 1's width), K2 on segment 1
    with those incoming tables, K3 on the widest solve segment (X from the
    kernels' earlier segments); and K4 on a synthetic table at
    WIn >= 256."""
    from slip_lu_tpu_torch.convert import matrix_copy
    from slip_lu_tpu_torch.gpu import factor_fused as ff
    from slip_lu_tpu_torch.gpu import relift as rl
    from slip_lu_tpu_torch.gpu.backslash_fused import _tc_width
    from slip_lu_tpu_torch.matrix import Kind, Type

    ana = case.ana
    _, (_, r, es, _) = ana.fused_cache
    _, _, segments, _, ssegments = ana.fused_seg_cache
    if len(segments) != 2:
        _fail(f"{case.label}: the boundary checks take two factor "
              f"segments, not {list(segments)}")
    st = ana.fused_stream_tensors["cuda"]
    val = ana.fused_val_cache[1]
    n = case.A2.n
    ndet = n if es.ndet is None else es.ndet
    (lo0, hi0, w0), (lo1, hi1, w1) = segments
    Ws8 = ssegments[-1][2]
    WIo, WIn = ff._r8(w0 + 2), ff._r8(w1 + 2)
    val, SMT, GT, TZ, flags = ff.factor_stream(
        ff.chunk_range(st, lo0, hi0, True), val, ndet, w0,
        ff._r8(2 * w0 + 2), WIo)
    if flags.any():
        _fail(f"{case.label}: segment 0 flagged {flags.tolist()}")
    val = rl.widen_val(val, w0, w1)
    SMT = rl.widen_tc(SMT, w0, w1)
    lines, report = [], None
    cases = [("real", SMT, GT, TZ, w1, WIo, WIn),
             ("synthetic", *_synthetic_relift_tables(torch, ff), 256, 32,
              264)]
    for label, S_, G_, Z_, W8_, WIo_, WIn_ in cases:
        k_ms, got = _time_ms(torch, lambda: rl.relift_gt(
            S_, G_, Z_, W8_, WIo_, WIn_), 5)
        p_ms, want = _time_ms(torch, lambda: rl.relift_gt_ref(
            S_, G_, Z_, W8_, WIo_, WIn_), 1)
        err = _diff((got,), (want,))
        if err:
            _fail(f"relift_gt {label}: differs from the plain version "
                  f"(max |diff| {err})")
        b_ms, b_by = _relift_bound(S_.shape[0], W8_, WIo_, WIn_)
        lines.append(
            f"relift_gt vs plain, {label}: {S_.shape[0]} rows, W8={W8_} "
            f"WI {WIo_} -> {WIn_} ({rl.newton_steps(WIo_, WIn_)} steps), "
            f"bit-equal; {k_ms:.3f} ms vs plain {p_ms:.3f} ms; bound "
            f"{b_ms:.4g} ms ({b_by})")
        if label == "real":
            report, GT = (err, k_ms, p_ms, b_ms, b_by), got

    # K2 on segment 1, the tables handed in
    seg = ff.chunk_range(st, lo1, hi1, True)
    tables = (SMT, GT, TZ)
    WN = ff._r8(2 * w1 + 2)
    k_ms, fk = _time_ms(torch, lambda: ff.factor_stream(
        seg, val, ndet, w1, WN, WIn, tables), 1)
    p_ms, fp = _time_ms(torch, lambda: ff.factor_stream_ref(
        seg, val, ndet, w1, WN, WIn, tables), 1)
    err = _diff(fk, fp)
    if err or fk[4].any():
        _fail(f"{case.label}: factor segment 1 differs from the plain "
              f"version (max |diff| {err}) or flagged {fk[4].tolist()}")
    b_ms, b_by = _bound(*_factor_bound(seg, val.shape[0], SMT.shape[0], w1,
                                       WIn, True))
    lines.append(
        f"factor_stream vs plain, {case.label} segment 1 (chunks "
        f"{lo1}-{hi1}, W8={w1}, WI={WIn}, incoming tables): bit-equal; "
        f"{k_ms:.3f} ms vs plain {p_ms:.3f} ms; bound {b_ms:.4g} ms "
        f"({b_by})")

    # K3 on the widest solve segment, GT at the solve quotient's width
    val, SMT, GT, TZ = fk[:4]
    WI8 = ff._r8(max(w1, Ws8) + 2)
    WQs = min(WI8, ff._r8(Ws8 + 2))
    WIf = WIn
    if WIf < WQs:
        GT, WIf = rl.relift_gt(SMT, GT, TZ, w1, WIf, WQs), WQs
    bz = matrix_copy(case.b, Kind.DENSE, Type.MPZ)
    bcol = [int(bz.x[int(r[k]), 0]) for k in range(n)]
    X = ff.x_tensor(torch.from_numpy(ff.ints_to_tc_rows(
        bcol, _tc_width(bcol, Ws8))).to("cuda"), n, ssegments[0][2], es.nxx)
    pWs = ssegments[0][2]
    for slo, shi, Ws_s in ssegments[:-1]:
        X = rl.widen_tc(X, pWs, Ws_s)
        X, sflags = ff.solve_stream(ff.chunk_range(st, slo, shi, False), val,
                                    SMT, GT, TZ, X, w1, Ws_s,
                                    ff._r8(w1 + Ws_s + 2), WIf)
        pWs = Ws_s
    slo, shi, _ = ssegments[-1]
    X = rl.widen_tc(X, pWs, Ws8)
    sseg = ff.chunk_range(st, slo, shi, False)
    WNS = ff._r8(w1 + Ws8 + 2)
    k_ms, sk = _time_ms(torch, lambda: ff.solve_stream(
        sseg, val, SMT, GT, TZ, X, w1, Ws8, WNS, WIf), 1)
    p_ms, sp = _time_ms(torch, lambda: ff.solve_stream_ref(
        sseg, val, SMT, GT, TZ, X, w1, Ws8, WNS, WIf), 1)
    err = _diff(sk, sp)
    if err or sk[1].any():
        _fail(f"{case.label}: the widest solve segment differs from the "
              f"plain version (max |diff| {err}) or flagged "
              f"{sk[1].tolist()}")
    b_ms, b_by = _bound(*_solve_bound(sseg, val.shape[0], SMT.shape[0], w1,
                                      Ws8, WIf, X.numel()))
    lines.append(
        f"solve_stream vs plain, {case.label} solve segment "
        f"{len(ssegments) - 1} (chunks {slo}-{shi}, W8={w1}, Ws8={Ws8}, "
        f"WI={WIf}): bit-equal; {k_ms:.3f} ms vs plain {p_ms:.3f} ms; "
        f"bound {b_ms:.4g} ms ({b_by})")
    return lines, report


def _band_system(slip, n=220, seed=5):
    """A banded integer system whose natural order is a chain (the
    dissection's case), from a seed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, n), dtype=object)
    for i in range(n):
        dense[i, i] = 1
        for d in (1, 2, 3):
            if i + d < n:
                dense[i, i + d] = int(rng.integers(-3, 4))
                dense[i + d, i] = int(rng.integers(-3, 4))
    A = slip.matrix_copy(slip.SlipMatrix.from_dense(dense, slip.Type.MPZ),
                         slip.Kind.CSC, slip.Type.MPZ)
    b = slip.SlipMatrix.from_dense(np.array(
        [[int(rng.integers(-5, 6))] for _ in range(n)], dtype=object),
        slip.Type.MPZ)
    return A, b


def grouped_segment_check(slip, torch):
    """The whole device half on a grouped stream in forced segments (two
    factor and two solve segments) on the card against the same function
    on CPU copies of its inputs, where the wrappers take the plain
    versions: a dissected band, small enough for the plain versions."""
    from slip_lu_tpu_torch.gpu import factor_fused as ff
    from slip_lu_tpu_torch.gpu import relift as rl
    from slip_lu_tpu_torch.gpu.backslash_fused import (
        _tc_width, factorize_solve_cuda_fused)

    A, b = _band_system(slip)
    opts = slip.Options(order=slip.Ordering.NONE)
    ana = slip.analyze(A, opts)
    os.environ["SLIP_FUSED_SUBTREE"] = "force"
    try:
        x = factorize_solve_cuda_fused(A, ana, b, opts, device="cuda")
    finally:
        del os.environ["SLIP_FUSED_SUBTREE"]
    slip.check_solution(A, x, b)
    _, (_, r, es, avals) = ana.fused_cache
    if es.grouped is None:
        _fail("band: the forced grouped stream was not adopted")
    W, Ws = ana.fused_width_cache
    n = A.n
    W8 = ff._r8(max(W, 16))
    Ws8 = ff._r8(max(Ws, W8 + 1))
    WN, WNS, WI8 = ff._r8(2 * W8 + 2), ff._r8(W8 + Ws8 + 2), \
        ff._r8(max(W8, Ws8) + 2)
    nf, ns = es.factor.nchunks, es.solve.nchunks
    segs = ((0, nf // 2, ff._r8(W8 // 2)), (nf // 2, nf, W8))
    ssegs = ((0, ns // 2, ff._r8(Ws8 // 2)), (ns // 2, ns, Ws8))
    val = ff.val_tensor(avals, es.init_pos, es.nnz, segs[0][2], "cpu",
                        es.extra_pos, es.extra_vals)
    bcol = [int(b.x[int(r[k]), 0]) for k in range(n)]
    b_rows = torch.from_numpy(
        ff.ints_to_tc_rows(bcol, _tc_width(bcol, Ws8))[None])
    before = rl.relift_gt.launches

    def run(dev):
        # on CPU tensors the wrappers take the plain versions
        return ff.fused_solve_all(
            n, W8, Ws8, WN, WNS, WI8, ff.stream_tensors(es, dev),
            val.to(dev), b_rows.to(dev), segments=segs, ssegments=ssegs,
            ndet=es.ndet, nxx=es.nxx)

    k_ms, got = _time_ms(torch, lambda: run("cuda"), 1)
    lifts = rl.relift_gt.launches - before
    t0 = time.perf_counter()
    want = run("cpu")
    p_ms = 1e3 * (time.perf_counter() - t0)
    err = _diff((got.cpu(),), (want,))
    if err or lifts == 0:
        _fail(f"band: segmented grouped device half differs from the plain "
              f"versions (max |diff| {err}) or never re-lifted ({lifts})")
    return [f"fused_solve_all vs plain, grouped band n={n} (ndet={es.ndet}, "
            f"nxx={es.nxx}, {nf} factor / {ns} solve chunks) in segments "
            f"{segs} / {ssegs}: flat vectors of {got.numel()} limbs "
            f"bit-equal, flags {got[:4].tolist()}, {lifts} K4 launches; "
            f"{k_ms:.3f} ms vs plain (host CPU) {p_ms:.3f} ms"]


# ---------------------------------------------------------------------------
# the card's busy share
# ---------------------------------------------------------------------------

def _device_ms(prof):
    """Device time in the profiler's trace, in ms: the sum over kernels,
    copies and sets (one stream, so they do not overlap), and the part
    of it in each kernel of the port."""
    from torch.autograd import DeviceType
    total = 0.0
    per = {"factor_stream": 0.0, "solve_stream": 0.0, "relift_gt": 0.0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        total += ms
        for k in per:
            if f"{k}_kernel" in e.name:
                per[k] += ms
    return total, per


def busy_share(slip, torch, cases):
    """The card's busy share: device time from torch.profiler over the
    host-clock wall time of the call, profiler on. One ``backslash`` call
    on uni10k (it plans again: about a second of dissection there; on
    uni100k it would repeat half a minute of host certification), and one
    solve on each case's reused Analysis."""
    from torch.profiler import ProfilerActivity, profile

    from slip_lu_tpu_torch.gpu.backslash_fused import \
        factorize_solve_cuda_fused

    out = []
    for case in cases:
        calls = [("Analysis reused", lambda c=case: factorize_solve_cuda_fused(
            c.A2, c.ana, c.b, c.opts, device="cuda"))]
        if case.label == "uni10k":
            A, b = _load(slip, case.name)
            calls.insert(0, ("backslash", lambda: slip.backslash(
                A, b, slip.Type.MPQ, case.opts, backend="cuda-fused",
                device="cuda")))
        for label, fn in calls:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            dev_ms, per = _device_ms(prof)
            if dev_ms == 0.0:
                out.append(f"busy share {case.label}, {label}: not measured "
                           "(the profiler saw no device time)")
                continue
            out.append(
                f"busy share {case.label}, {label}: wall {wall:.3f} s, "
                f"device {dev_ms / 1e3:.3f} s, "
                f"{100 * dev_ms / 1e3 / wall:.1f}%; " + ", ".join(
                    f"{k} {v:.1f} ms" for k, v in per.items()))
    return out


def _serial_build_seconds(lib) -> float:
    """Seconds of one nvcc call over every source (the build before the
    library compiled one process per source), to compare with the
    parallel build; its output is deleted."""
    import glob
    import tempfile

    from slip_lu_tpu_torch.gpu import _build
    srcs = sorted(glob.glob(os.path.join(HERE, "slip_lu_tpu_torch", "csrc",
                                         "*.cu")))
    with tempfile.TemporaryDirectory(dir=os.path.dirname(lib.path)) as d:
        t0 = time.perf_counter()
        res = subprocess.run(
            [_build._nvcc()] + _build.NVCC_FLAGS
            + ["-shared", "-o", os.path.join(d, "serial.so")] + srcs,
            capture_output=True, text=True)
        seconds = time.perf_counter() - t0
    if res.returncode != 0:
        _fail(f"one-call nvcc build failed:\n{res.stderr}")
    return seconds


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs one card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "slip_lu_tpu_torch")):
        print("slip_lu_tpu_torch not found beside chip_smoke.py: run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import slip_lu_tpu_torch as slip
    from slip_lu_tpu_torch.gpu import _build

    smi = _smi()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}")
    from slip_lu_tpu_torch.ordering import native
    t0 = time.perf_counter()
    sym = native._load()
    print(f"native symbolic library: "
          f"{'loaded' if sym is not None else 'missing (Python fallback)'} "
          f"in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.build_seconds:.2f} s) -> "
          f"{os.path.relpath(lib.path, HERE)}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    if lib.build_seconds > 0:
        print(f"  the same sources in one nvcc call: "
              f"{_serial_build_seconds(lib):.2f} s")

    cases = [Case("uni10k", "uni10k", None),
             Case("uni100k-natural", "uni100k", slip.Ordering.NONE),
             Case("uni100k-default", "uni100k", None, grouped=True,
                  segmented=True),
             Case("tri1000", "tri1000", None, segmented=True)]
    launches = {k: 0 for k in _counters()}
    for case in cases:
        lines, got = main_path(slip, torch, case, warm=3)
        for line in lines:
            print(line, flush=True)
        for k, v in got.items():
            launches[k] += v
    print(f"launches on the main path (all cases): {launches}")
    for name, cnt in launches.items():
        if cnt <= 0:
            _fail(f"the main path never launched {name}")

    for line in busy_share(slip, torch, cases):
        print(line, flush=True)
    klines, rep = stream_checks(slip, torch, cases[0])
    rlines, rep["relift_gt"] = boundary_checks(torch, cases[2])
    glines = grouped_segment_check(slip, torch)
    for line in klines + rlines + glines:
        print(line)
    kernels = []
    ref = "slip_lu_tpu/tpu/factor_fused.py"
    for name, source, replaces in (
            ("factor_stream", "slip_lu_tpu_torch/csrc/fused.cu",
             f"{ref}:735"),
            ("solve_stream", "slip_lu_tpu_torch/csrc/fused.cu",
             f"{ref}:1116"),
            ("relift_gt", "slip_lu_tpu_torch/csrc/relift.cu",
             "slip_lu_tpu/tpu/relift.py:89")):
        err, ms, plain_ms, bound_ms, bound_by = rep[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None})
    print(f"total run: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
