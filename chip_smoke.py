#!/usr/bin/env python3
"""Smoke run of slip_lu_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the kernels from slip_lu_tpu_torch/csrc with nvcc (one process per
source, in parallel) and drives the three device paths.

The fused exact solve (backend="cuda-fused") on four cases: uni10k
(default ordering), uni100k in natural order, uni100k in its default
ordering (a dissected, grouped stream in two width segments, GT re-lifted
by K4 at the boundary) and tri1000 (default ordering, segmented). Each
case makes one cold ``backslash(..., backend="cuda-fused", device="cuda")``
call, which plans from scratch (dissection included, wherever the
reference pays it), held to the host oracle and to
``Options(check=True)``; then warm solves (three on uni10k and tri1000,
one on each uni100k) through ``factorize_solve_cuda_fused`` on the
Analysis that call built, the way the JAX package's bench.py times its
solves.

The dense exact solve (backend="cuda", every shared multiply through K5)
on grid16 (n = 256, the reference's dense cap: one cold ``backslash`` and
one warm ``factorize_solve_cuda`` call on its Analysis), tri200 under
all six pivot schemes (``factor_cuda`` held to the host ``factorize`` for
SMALLEST and TOL_LARGEST), sparse100 with ``max_limbs=2`` (the width
ladder climbs) and grid24 (n = 576, one cold call: the scale line), each
held to the host oracle and to check=True. The kernels' launch counts are
set to 0 before each case and read after it.

The sharded fused exact solve (``factorize_solve_cuda_fused_sharded``)
at world size 1, one rank in a one-rank NCCL group: uni10k (one cold call
on a new Analysis, then three warm solves), uni100k in its default
ordering (one planning call and one warm solve on the Analysis the
single-chip case built, so the dissection's certification is not paid
again), tri1000 (a new Analysis: its transversal pivots cancel, so the
first call climbs the width ladder through segments, K4 at the
boundaries, to the bound and takes the single-chip fallback; the warm
call then runs on the pinned rows) and the 4x4 system whose natural-order
pivots cancel (it must take the single-chip fallback and report it); each
held to the host oracle and to check_solution, K6 and K7 counted,
all-reduces counted per solve.

Then the card's busy share (torch.profiler: one ``backslash`` call on
uni10k, one solve on a reused Analysis for every fused case, for grid16
and for the sharded uni10k), and every kernel held to its plain PyTorch
version on the card: K2 and K3 on uni10k's stream (at the width the
ladder settled on, timed whole and compared on its first 300 chunks, and
clamped below need on the shortest overflowing prefix); K4 on uni100k's
real segment-boundary tables and on a synthetic table at WIn >= 256; K2
on uni100k's second factor segment (its tables handed in) and K3 on its
widest solve segment (timed whole, compared on its first tenth); the
whole segmented, grouped device half (``fused_solve_all``) on a dissected
band, against the same call on CPU copies; and K5 at grid16's shapes (rho
x M, the division, a Hensel step), on a worst-case ripple and at grid24's
179-limb division; K6 and K7 on prefixes of the factor and the solve
stream of uni10k's sharded plan at p = 1 (timed) and on ranks 0 and 1 of
a p = 2 plan, run one after the other with the sums taken by hand. Every
comparison is bit equality: all values are exact integers. Exits non-zero
on any failure, and when there is no CUDA device or no slip_lu_tpu_torch
beside it.

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
    warm: int = 3            # warm solves on the cold call's Analysis
    A2: object = None        # CSC x MPZ copy and the cold call's Analysis
    ana: object = None
    b: object = None
    opts: object = None


def _counters():
    from slip_lu_tpu_torch.gpu import factor_fused as ff
    from slip_lu_tpu_torch.gpu import relift as rl
    from slip_lu_tpu_torch.ops import mul_shared as ms
    from slip_lu_tpu_torch.parallel import factor_fused_shard as ffs
    return {"factor_stream": ff.factor_stream, "solve_stream": ff.solve_stream,
            "relift_gt": rl.relift_gt, "mul_shared": ms.mul_shared_limbs,
            "ab_chunk": ffs.ab_chunk, "c_chunk": ffs.c_chunk}


def _keep_analysis():
    """Patch the front end so the Analysis a backslash call builds is
    kept (the package's name backslash is the function, hence
    import_module). Returns (the list it lands in, the undo)."""
    import importlib
    bs = importlib.import_module("slip_lu_tpu_torch.backslash")
    built = []
    real_analyze = bs.analyze

    def keep(*args, **kw):
        built.append(real_analyze(*args, **kw))
        return built[-1]

    bs.analyze = keep
    return built, lambda: setattr(bs, "analyze", real_analyze)


def main_path(slip, torch, case: Case, warm: int):
    """One case: the cold backslash call (its Analysis kept), then warm
    solves on that Analysis, each checked against the host oracle. Returns
    the result lines and the kernels' launches."""
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
    # keep the Analysis the cold call builds (backslash makes its own)
    built, undo = _keep_analysis()
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
        undo()
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


# ---------------------------------------------------------------------------
# the dense exact solve (backend="cuda")
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DenseCase:
    label: str
    name: str
    fields: dict             # Options fields beside check=True
    warm: int = 0            # warm solves on the cold call's Analysis
    factor_check: bool = False   # factor_cuda against the host factorize
    retries: bool = False    # the width ladder must climb
    A2: object = None        # CSC x MPZ copy and the cold call's Analysis
    ana: object = None
    b: object = None
    opts: object = None


def _same_factorization(F, G) -> bool:
    return (F.rhos == G.rhos and list(F.pinv) == list(G.pinv)
            and list(F.row_perm) == list(G.row_perm)
            and [dict(c) for c in F.Lcols] == [dict(c) for c in G.Lcols]
            and [dict(c) for c in F.Ucols] == [dict(c) for c in G.Ucols])


def dense_path(slip, torch, case: DenseCase):
    """One dense case: the host oracle, one cold ``backslash(...,
    backend="cuda", device="cuda")`` (its Analysis kept), warm solves
    through ``factorize_solve_cuda`` on that Analysis, and, where asked,
    ``factor_cuda`` against the host ``factorize``. Every answer is held to
    the oracle (and to check=True inside the cold call). The launch counts
    are set to 0 before the case and read after it."""
    from slip_lu_tpu_torch.convert import matrix_copy
    from slip_lu_tpu_torch.factorize import factorize
    from slip_lu_tpu_torch.gpu.backslash_cuda import (factor_cuda,
                                                      factorize_solve_cuda)
    from slip_lu_tpu_torch.matrix import Kind, Type

    A, b = _load(slip, case.name)
    opts = slip.Options(check=True, **case.fields)
    t0 = time.perf_counter()
    x_host = slip.backslash(A, b, slip.Type.MPQ, opts, backend="host")
    host_s = time.perf_counter() - t0
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    built, undo = _keep_analysis()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        x = slip.backslash(A, b, slip.Type.MPQ, opts, backend="cuda",
                           device="cuda")
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
    finally:
        undo()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = slip.last_stats()
    if st.backend != "cuda" or st.fallback:
        _fail(f"{case.label}: not the dense path ({st.summary()})")
    if not _same_x(x, x_host):
        _fail(f"{case.label}: solution differs from the host oracle")
    if case.retries and st.retries < 1:
        _fail(f"{case.label}: the width ladder did not climb")
    cold = dict(st.phases)
    A2 = matrix_copy(A, Kind.CSC, Type.MPZ, opts)
    ana = built[0]
    times, dev_times = [], []
    for _ in range(case.warm):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xw = factorize_solve_cuda(A2, ana, b, opts, device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        dev_times.append(slip.last_stats().phases.get("device", 0.0))
        if not _same_x(xw, x_host):
            _fail(f"{case.label}: warm solve differs from the host oracle")
    fac = ""
    if case.factor_check:
        t0 = time.perf_counter()
        F = factor_cuda(A2, ana, opts, device="cuda")
        torch.cuda.synchronize()
        f_s = time.perf_counter() - t0
        if not _same_factorization(F, factorize(A2, ana, opts)):
            _fail(f"{case.label}: factor_cuda differs from the host "
                  "factorize")
        fac = f"; factor_cuda {f_s:.3f} s equals the host factorize"
    launches = {k: fn.launches for k, fn in counters.items()}
    if launches["mul_shared"] == 0:
        _fail(f"{case.label}: the dense path never launched mul_shared")
    case.A2, case.ana, case.b, case.opts = A2, ana, b, opts
    out = [f"dense {case.label}: n={A.n} nnz={st.nnz} W={st.W} Ws={st.Ws} "
           f"retries={st.retries} exact=oracle, check=True; cold backslash "
           f"{cold_s:.3f} s, phases (s): " + ", ".join(
               f"{k} {v:.3f}" for k, v in cold.items())
           + f"; peak device memory {peak_gb:.2f} GB; host oracle "
           f"{host_s:.3f} s{fac}"]
    if times:
        out.append(f"  warm solves on the reused Analysis: median "
                   f"{statistics.median(times):.3f} s (device "
                   f"{statistics.median(dev_times):.3f} s) over "
                   f"{case.warm}")
    out.append(f"  launches {launches}")
    return out, launches


def dense_busy_share(slip, torch, case: DenseCase):
    """torch.profiler over one warm dense solve: device time over the
    host-clock wall time, K5's part of it, and the operations that take
    the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from slip_lu_tpu_torch.gpu.backslash_cuda import factorize_solve_cuda
    torch.cuda.synchronize()
    # device activity only: a solve launches ~10^5 operations, and host
    # events would double the trace
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        factorize_solve_cuda(case.A2, case.ana, case.b, case.opts,
                             device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_ms, per, by_name = _device_ms(prof)
    if dev_ms == 0.0:
        return [f"busy share dense {case.label}, Analysis reused: not "
                "measured (the profiler saw no device time)"]
    k5 = sum(c for name, (_, c) in by_name.items()
             if "mul_shared_kernel" in name)
    events = sum(c for _, c in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return [f"busy share dense {case.label}, Analysis reused (profiler on):"
            f" wall {wall:.3f} s, device {dev_ms / 1e3:.3f} s, "
            f"{100 * dev_ms / 1e3 / wall:.1f}%, {events} device events; "
            f"mul_shared {per['mul_shared']:.1f} ms in {k5} launches",
            "  device time by name: " + "; ".join(
                f"{name[:60]} {t:.1f} ms x{c}" for name, (t, c) in top)]


def _k5_bound(B, La, Ls, D):
    """K5's limb products (what these shapes need) and bytes (a, s read
    once, out written once)."""
    return _bound(B * _trunc(La, Ls, D), 4 * (B * La + Ls + B * D))


def k5_checks(torch):
    """K5 against its plain version on the card, bit for bit, at the
    shapes the dense path gives it on grid16 (and grid24's division, past
    the TPU kernel's 257-digit cap), from a seed; each timed with CUDA
    events beside the plain version and the bound."""
    import numpy as np

    from slip_lu_tpu_torch.ops import mul_shared as ms
    rng = np.random.default_rng(16)
    shapes = [("grid16 rho x M", 65536, 40, 40, 80, None),
              ("grid16 division", 65536, 81, 81, 81, None),
              ("grid16 Hensel step", 1, 81, 81, 81, None),
              ("ripple", 65536, 81, 2, 81, 0xFFFF),
              ("grid24 division", 331776, 179, 179, 179, None)]
    lines, report = [], None
    for label, B, La, Ls, D, fill in shapes:
        if fill is None:
            a = torch.from_numpy(rng.integers(0, 1 << 16, (B, La))
                                 .astype(np.int32)).cuda()
            s = torch.from_numpy(rng.integers(0, 1 << 16, Ls)
                                 .astype(np.int32)).cuda()
        else:
            a = torch.full((B, La), fill, dtype=torch.int32, device="cuda")
            s = torch.ones(Ls, dtype=torch.int32, device="cuda")
        ms.mul_shared_limbs(a, s, D)                 # warm up
        k_ms, got = _time_ms(torch, lambda: ms.mul_shared_limbs(a, s, D), 5)
        p_ms, want = _time_ms(torch, lambda: ms.mul_shared_limbs_ref(
            a, s, D), 1)
        err = _diff((got,), (want,))
        if err:
            _fail(f"mul_shared {label}: differs from the plain version "
                  f"(max |diff| {err})")
        b_ms, b_by = _k5_bound(B, La, Ls, D)
        lines.append(f"mul_shared vs plain, {label}: B={B} La={La} Ls={Ls} "
                     f"D={D}, bit-equal; {k_ms:.4f} ms vs plain "
                     f"{p_ms:.3f} ms; bound {b_ms:.4g} ms ({b_by})")
        if label == "grid16 division":
            report = (err, k_ms, p_ms, b_ms, b_by)
    return lines, report


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

# chunks of uni10k's streams on which the settled-width kernels are held
# to their plain versions (the plain versions take 25-40 ms a chunk)
SETTLED_PREFIX = 300


def stream_checks(slip, torch, case: Case):
    """K2 and K3 against their plain versions on uni10k's stream: at the
    width the ladder settled on, the kernels timed on the whole stream and
    held to the plain versions on its first SETTLED_PREFIX chunks; then a
    width clamped below need on the shortest prefix of the stream that
    overflows (the garbage after the first overflow is compared all the
    same)."""
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
        kf, ks = min(nf, SETTLED_PREFIX), min(ns, SETTLED_PREFIX)
        if label == "settled":
            whole_f, _ = _time_ms(torch, lambda: ff.factor_stream(
                st, val, nd, W8, WN, WI8), 3)
            whole_s, _ = _time_ms(torch, lambda: ff.solve_stream(
                st, *tables, X0, W8, Ws8, WNS, WI8), 3)
        else:
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
        if label == "settled":
            lines.append(
                f"kernels on {case.label}'s whole streams ({nf} factor, {ns} "
                f"solve chunks), W8={W8} Ws8={Ws8}: factor_stream "
                f"{whole_f:.3f} ms, solve_stream {whole_s:.3f} ms")
        lines.append(
            f"kernels vs plain, {case.label} {label} W8={W8} Ws8={Ws8} on "
            f"{kf}/{nf} factor and {ks}/{ns} solve chunks: factor flags "
            f"{fflags[:5]}, solve flags {sflags[:5]}, bit-equal; "
            f"factor_stream {k_ms:.3f} ms vs plain {p_ms:.3f} ms; "
            f"solve_stream {ks_ms:.3f} ms vs plain {ps_ms:.3f} ms")
        if label == "settled":
            E8, n8 = val.shape[0], tables[0].shape[0]
            fops, fbytes = _factor_bound(fst, E8, n8, W8, WI8, False)
            sops, sbytes = _solve_bound(sst, E8, n8, W8, Ws8, WI8,
                                        X0.numel())
            report = {"factor_stream": (f_err, k_ms, p_ms,
                                        *_bound(fops, fbytes)),
                      "solve_stream": (s_err, ks_ms, ps_ms,
                                       *_bound(sops, sbytes))}
            lines.append(
                f"  bounds on those chunks at W8={W8} Ws8={Ws8}: factor "
                f"{fops:.4g} limb "
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
    if sk[1].any():
        _fail(f"{case.label}: the widest solve segment flagged "
              f"{sk[1].tolist()}")
    # the plain version takes ~50 ms a chunk at these widths: held to the
    # kernel on the segment's first tenth
    phi = slo + (shi - slo) // 10
    pseg = ff.chunk_range(st, slo, phi, False)
    pk_ms, pk = _time_ms(torch, lambda: ff.solve_stream(
        pseg, val, SMT, GT, TZ, X, w1, Ws8, WNS, WIf), 1)
    p_ms, sp = _time_ms(torch, lambda: ff.solve_stream_ref(
        pseg, val, SMT, GT, TZ, X, w1, Ws8, WNS, WIf), 1)
    err = _diff(pk, sp)
    if err:
        _fail(f"{case.label}: the widest solve segment differs from the "
              f"plain version (max |diff| {err})")
    b_ms, b_by = _bound(*_solve_bound(sseg, val.shape[0], SMT.shape[0], w1,
                                      Ws8, WIf, X.numel()))
    lines.append(
        f"solve_stream vs plain, {case.label} solve segment "
        f"{len(ssegments) - 1} (chunks {slo}-{shi}, W8={w1}, Ws8={Ws8}, "
        f"WI={WIf}): {k_ms:.3f} ms, bound {b_ms:.4g} ms ({b_by}); on "
        f"chunks {slo}-{phi} bit-equal, {pk_ms:.3f} ms vs plain "
        f"{p_ms:.3f} ms")
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
    copies and sets (one stream, so they do not overlap), the part of it
    in each kernel of the port, and the sums and counts by event name.
    Reads the raw trace events: building the profiler's Python event list
    takes minutes for the ~10^6 events of a dense solve."""
    from torch.autograd import DeviceType
    total = 0.0
    per = {"factor_stream": 0.0, "solve_stream": 0.0, "relift_gt": 0.0,
           "mul_shared": 0.0}
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        ms = e.duration_ns() / 1e6
        total += ms
        name = e.name()
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + ms, c + 1)
        for k in per:
            if f"{k}_kernel" in name:
                per[k] += ms
    return total, per, by_name


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
            dev_ms, per, _ = _device_ms(prof)
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


# ---------------------------------------------------------------------------
# the sharded fused exact solve (one rank in a one-rank NCCL group)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardCase:
    label: str
    name: str                # a corpus matrix, or "cancel4"
    order: object = None     # an Ordering, or None for the default
    warm: int = 0            # warm solves on the first call's Analysis
    base: object = None      # a fused Case whose Analysis the first call
    #                          reuses (else a new Analysis: a cold call)
    fallback: tuple = ()     # the calls (0 = first) that must take the
    #                          single-chip fallback; no other call may
    segmented: bool = False  # >= 2 factor segments in the last call, K4
    A2: object = None        # CSC x MPZ copy and the Analysis it ran on
    ana: object = None
    b: object = None
    opts: object = None


def _cancel4(slip):
    """In natural order this system's 2x2 leading minor cancels exactly
    (the JAX package's tests/test_sharded_fused.py)."""
    import numpy as np
    A = slip.SlipMatrix.from_dense(np.array(
        [[2, 1, 0, 3], [4, 2, 1, 0], [0, 1, 5, 1], [3, 0, 1, 4]],
        dtype=object), slip.Type.MPZ)
    b = slip.SlipMatrix.from_dense(np.array([[1], [2], [3], [4]],
                                            dtype=object), slip.Type.MPZ)
    return A, b


def _shard_spy():
    """Record the widths and segments of every call of the sharded device
    half. Returns (the list, the undo)."""
    from slip_lu_tpu_torch.parallel import driver_fused as df
    real = df.fused_sharded_solve
    seen = []

    def spy(group, n, W8, Ws8, WI8, rs, val0, X0, ndet=None, segments=None,
            ssegments=None):
        seen.append((W8, Ws8, segments, ssegments))
        return real(group, n, W8, Ws8, WI8, rs, val0, X0, ndet, segments,
                    ssegments)

    df.fused_sharded_solve = spy
    return seen, lambda: setattr(df, "fused_sharded_solve", real)


def sharded_path(slip, torch, case: ShardCase):
    """One sharded case at world size 1: the first call (cold on a new
    Analysis, or planning on a reused one), then warm solves on the same
    Analysis; each held to the host oracle and to check_solution, K6 and
    K7 counted. Returns the result lines and the launches."""
    from slip_lu_tpu_torch.convert import matrix_copy
    from slip_lu_tpu_torch.matrix import Kind, Type
    from slip_lu_tpu_torch.parallel import factorize_solve_cuda_fused_sharded
    from slip_lu_tpu_torch.parallel.shard import psum

    A, b = _cancel4(slip) if case.name == "cancel4" else \
        _load(slip, case.name)
    opts = slip.Options(check=True) if case.order is None else \
        slip.Options(check=True, order=case.order)
    x_host = slip.backslash(A, b, slip.Type.MPQ, opts, backend="host")
    if case.base is not None:
        A2, ana = case.base.A2, case.base.ana
    else:
        A2 = matrix_copy(A, Kind.CSC, Type.MPZ, opts)
        ana = slip.analyze(A2, opts)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    seen, undo = _shard_spy()
    times, dev_times, per_solve = [], [], []
    try:
        for i in range(1 + case.warm):
            before = (psum.calls, counters["ab_chunk"].launches,
                      counters["c_chunk"].launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = factorize_solve_cuda_fused_sharded(A2, ana, b, None, opts,
                                                   device="cuda")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            st = slip.last_stats()
            if i == 0:
                first = dict(st.phases)
            dev_times.append(st.phases.get("device", 0.0))
            per_solve.append((psum.calls - before[0],
                              counters["ab_chunk"].launches - before[1],
                              counters["c_chunk"].launches - before[2]))
            if st.backend != "cuda-fused-sharded" or \
                    st.fallback != (i in case.fallback):
                _fail(f"sharded {case.label}: {st.summary()}")
            slip.check_solution(A, x, b, opts)
            if not _same_x(x, x_host):
                _fail(f"sharded {case.label}: solution differs from the "
                      "host oracle")
    finally:
        undo()
    launches = {k: fn.launches for k, fn in counters.items()}
    for k in ("ab_chunk", "c_chunk"):
        if launches[k] == 0:
            _fail(f"sharded {case.label}: the main path never launched {k}")
    W8, Ws8, segments, ssegments = seen[-1]
    if case.segmented and (len(segments) < 2 or launches["relift_gt"] == 0):
        _fail(f"sharded {case.label}: factor plan {segments}, relift_gt "
              f"launched {launches['relift_gt']} times")
    ses = ana.fused_shard_cache[1][2]
    case.A2, case.ana, case.b, case.opts = A2, ana, b, opts
    kind = "planning call on the reused Analysis" if case.base is not None \
        else "cold call"
    out = [
        f"sharded {case.label} (world size 1): n={A.n} W8={st.W} Ws8="
        f"{st.Ws} retries={st.retries} fallback in calls "
        f"{list(case.fallback)} grouped="
        f"{ses.ndet is not None} factor chunks {ses.factor.nchunks} solve "
        f"chunks {ses.solve.nchunks} segments {list(segments)} ssegments "
        f"{list(ssegments)} exact=oracle, check_solution",
        f"  {kind} {times[0]:.3f} s, phases (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in first.items())]
    if case.warm:
        out.append(
            f"  warm solves on the same Analysis: median "
            f"{statistics.median(times[1:]):.3f} s (device "
            f"{statistics.median(dev_times[1:]):.3f} s) over {case.warm}")
    out.append(f"  per call (all-reduces, ab_chunk, c_chunk launches): "
               f"{per_solve}; sharded device-half calls (W8, Ws8, segments)"
               f": {[sn[:3] for sn in seen]}; launches {launches}")
    return out, launches


def _shard_states(torch, ses, avals, r, b, rank, W8, Ws8, WI):
    """One rank's tables of a plan on the card, as the driver packs them
    (first right-hand side only)."""
    import numpy as np

    from slip_lu_tpu_torch.convert import matrix_copy
    from slip_lu_tpu_torch.gpu import factor_fused as ff
    from slip_lu_tpu_torch.matrix import Kind, Type
    n = ses.n
    bz = matrix_copy(b, Kind.DENSE, Type.MPZ)
    v = np.zeros((ff._r8(ses.Lp), W8), np.int32)
    mine = ses.init_chip == rank
    v[ses.init_loc[mine]] = ff.ints_to_tc_rows(avals, W8)[mine]
    if ses.extra_chip is not None and len(ses.extra_chip):
        em = ses.extra_chip == rank
        v[ses.extra_loc[em]] = ff.ints_to_tc_rows(ses.extra_vals, W8)[em]
    n8 = ff._r8((n if ses.ndet is None else ses.ndet) + 2)
    tabs = [np.zeros((n8, w), np.int32) for w in (W8, WI, 8)]
    tabs[0][0, 0] = tabs[1][0, 0] = 1
    X = np.zeros((ff._r8(n + 1 + ses.nxx), Ws8), np.int32)
    X[:n] = ff.ints_to_tc_rows([int(bz.x[int(r[k]), 0]) for k in range(n)],
                               Ws8)
    return {k: torch.from_numpy(t).to("cuda") for k, t in zip(
        ("val", "SMT", "GT", "TZ", "X", "flags", "sflags"),
        (v, *tabs, X, np.zeros(8, np.int32), np.zeros(8, np.int32)))}


def _chunk_bound(chs, cs, W8, Wt, WI8, kernel):
    """Limb products and bytes of K6 ("ab") or K7 ("c") over the chunks cs
    of every rank's stream in chs: the events' products as for K2, the
    heads' fixes and lifts (K6, factor), and each chunk's stream rows and
    distinct table rows read once and written once."""
    import numpy as np
    WQ = min(WI8, ((Wt + 2 + 7) // 8) * 8)
    WV = ((WQ + W8 + 7) // 8) * 8
    ops = nbytes = 0.0
    for ch in chs:
        H = ch.H
        meta = ch.meta_host[cs]
        ev = (ch.ev1 if kernel == "ab" else ch.ev2)[cs].cpu().numpy()
        cnt = meta[:, 3 * H + (1 if kernel == "ab" else 2)]
        ops += _pass_ops(ev, cnt, Wt, W8, WQ, WV, kernel == "c")
        nbytes += 4 * (meta.size + ev.size + 2 * ch.CB8 * len(cs))
        for j, c in enumerate(cs):
            live = ev[j, :, :cnt[j]]
            t, m, d, a, bb = (np.unique(live[f]) for f in range(5))
            md = np.unique(np.concatenate([m, d]))
            nbytes += 4 * (2 * len(t) * Wt + len(md) * W8
                           + len(d) * (WI8 + 8))
            nb = int(meta[j, 3 * H + 4])
            if kernel == "c":
                nbytes += 4 * (len(a) * W8 + len(bb) * Wt + nb * Wt)
            else:
                nbytes += 4 * nb * Wt * 2            # gather in, bc out
            if kernel == "ab" and H and meta[j, 3 * H] > 0:
                nh = int(meta[j, 3 * H])
                ks, dv = meta[j, :nh], meta[j, 2 * H:2 * H + nh]
                fix = (dv != ks) & bool(meta[j, 3 * H + 3] & 256)
                ops += float(fix.sum()) * (W8 * W8 + _trunc(WQ, WQ, WQ)
                                           + _trunc(WQ, W8, WV))
                lift, w = 0, 1
                while w < WI8:
                    w2 = min(2 * w, WI8)
                    lift += _trunc(w2, w, w2) + _trunc(w, w2, w2)
                    w = w2
                ops += nh * lift
                nbytes += 4 * nh * (W8 + 3 * W8 + WI8 + 8)
    return ops, nbytes


def _timed_steps(torch, ffs, chs, cs, states, solve, plain):
    """Run the chunks cs on every rank in this process (local_ab, the sum,
    local_c). Returns the summed ms of the K6 and of the K7 calls: for the
    plain versions, CUDA events around each call; for the kernels, their
    device time in torch.profiler's trace (events around a call of a few
    microseconds would time the host's launch instead), or the events'
    time where the trace has none."""
    from torch.profiler import ProfilerActivity, profile
    ev = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for c in cs:
            e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            e[0].record()
            bcs = ffs.local_ab(chs, c, states, solve, plain)
            e[1].record()
            bc = sum(bcs)
            e[2].record()
            ffs.local_c(chs, c, states, bc, solve, plain)
            e[3].record()
            ev.append(e)
        torch.cuda.synchronize()
    timed = (sum(e[0].elapsed_time(e[1]) for e in ev),
             sum(e[2].elapsed_time(e[3]) for e in ev))
    if plain:
        return timed
    _, _, by_name = _device_ms(prof)
    dev = [sum(t for name, (t, _) in by_name.items() if k in name)
           for k in ("ab_chunk_kernel", "c_chunk_kernel")]
    return tuple(d if d > 0 else t for d, t in zip(dev, timed))


def shard_kernel_checks(slip, torch, case: ShardCase):
    """K6 and K7 against their plain versions on the card, bit for bit, on
    a prefix of the factor stream and, after the whole factor stream (the
    kernels), a prefix of the solve stream of uni10k's sharded plan: at
    p = 1 (timed: the kernels' device time, the plain versions' CUDA
    events, beside the bound), and on ranks 0 and 1 of a p = 2 plan, run
    one after the other in this process with the sums taken by hand (what
    the all-reduce computes)."""
    from slip_lu_tpu_torch.parallel import driver_fused as df
    from slip_lu_tpu_torch.parallel import factor_fused_shard as ffs
    ana, A2 = case.ana, case.A2
    W, Ws = ana.fused_width_cache
    W8 = ((W + 7) // 8) * 8
    Ws8 = ((max(Ws, W + 1) + 7) // 8) * 8
    WI = max(((W8 + 2 + 7) // 8) * 8, ((max(W8, Ws8) + 2 + 7) // 8) * 8)
    lines, report = [], {}
    for p, nf, ns in ((1, 100, 50), (2, 50, 25)):
        _, r, ses, avals, _ = df.plan_sharded(A2, ana, p, case.opts)
        arrays = df.stream_arrays(ses, A2.n)
        rss = [ffs.rank_streams(k, "cuda", *arrays) for k in range(p)]
        fch = [rs.factor for rs in rss]
        sch = [rs.solve for rs in rss]
        kst = [_shard_states(torch, ses, avals, r, case.b, k, W8, Ws8, WI)
               for k in range(p)]
        pst = [{k: t.clone() for k, t in st.items()} for st in kst]
        fcs = list(range(min(nf, fch[0].nchunks)))
        _timed_steps(torch, ffs, fch, fcs[:2], [
            {k: t.clone() for k, t in st.items()} for st in kst], False,
            False)                                     # warm up
        k6, k7 = _timed_steps(torch, ffs, fch, fcs, kst, False, False)
        p6, p7 = _timed_steps(torch, ffs, fch, fcs, pst, False, True)
        err = max(_diff(tuple(a.values()), tuple(b.values()))
                  for a, b in zip(kst, pst))
        if err:
            _fail(f"sharded kernels p={p}: factor prefix differs from the "
                  f"plain versions (max |diff| {err})")
        # the rest of the factor stream with the kernels, then the solve
        rest = range(len(fcs), fch[0].nchunks)
        _timed_steps(torch, ffs, fch, rest, kst, False, False)
        if any(st["flags"].any() for st in kst):
            _fail(f"sharded kernels p={p}: the settled widths flagged "
                  f"{[st['flags'].tolist() for st in kst]}")
        pst = [{k: t.clone() for k, t in st.items()} for st in kst]
        scs = list(range(min(ns, sch[0].nchunks)))
        s6, s7 = _timed_steps(torch, ffs, sch, scs, kst, True, False)
        q6, q7 = _timed_steps(torch, ffs, sch, scs, pst, True, True)
        serr = max(_diff(tuple(a.values()), tuple(b.values()))
                   for a, b in zip(kst, pst))
        if serr:
            _fail(f"sharded kernels p={p}: solve prefix differs from the "
                  f"plain versions (max |diff| {serr})")
        nfl, nsl = len(fcs) * p, len(scs) * p
        lines.append(
            f"sharded kernels vs plain, uni10k p={p} (ranks run in turn, "
            f"sums by hand), W8={W8} Ws8={Ws8} WI={WI}: {len(fcs)}/"
            f"{fch[0].nchunks} factor and {len(scs)}/{sch[0].nchunks} solve "
            f"chunks bit-equal; device time: factor ab_chunk {k6:.3f} ms / "
            f"c_chunk {k7:.3f} ms over {nfl} launches each (plain {p6:.3f} / "
            f"{p7:.3f} ms); solve ab_chunk {s6:.3f} / c_chunk {s7:.3f} ms "
            f"over {nsl} (plain {q6:.3f} / {q7:.3f} ms)")
        if p == 1:
            fo6, fb6 = _chunk_bound(fch, fcs, W8, W8, WI, "ab")
            fo7, fb7 = _chunk_bound(fch, fcs, W8, W8, WI, "c")
            so6, sb6 = _chunk_bound(sch, scs, W8, Ws8, WI, "ab")
            so7, sb7 = _chunk_bound(sch, scs, W8, Ws8, WI, "c")
            n6, n7 = nfl + nsl, nfl + nsl
            b6, by6 = _bound((fo6 + so6) / n6, (fb6 + sb6) / n6)
            b7, by7 = _bound((fo7 + so7) / n7, (fb7 + sb7) / n7)
            report = {
                "ab_chunk": (max(err, serr), (k6 + s6) / n6,
                             (p6 + q6) / n6, b6, by6),
                "c_chunk": (max(err, serr), (k7 + s7) / n7, (p7 + q7) / n7,
                            b7, by7)}
            lines.append(
                f"  per launch (mean over the {n6} factor and solve "
                f"launches): ab_chunk {report['ab_chunk'][1]:.4f} ms vs "
                f"plain {report['ab_chunk'][2]:.3f} ms, bound {b6:.3g} ms "
                f"({by6}); c_chunk {report['c_chunk'][1]:.4f} ms vs plain "
                f"{report['c_chunk'][2]:.3f} ms, bound {b7:.3g} ms ({by7})")
    return lines, report


def shard_busy_share(torch, case: ShardCase):
    """torch.profiler over one warm sharded uni10k solve: device time
    over the host-clock wall time, and K6's and K7's part of it."""
    from torch.profiler import ProfilerActivity, profile

    from slip_lu_tpu_torch.parallel import factorize_solve_cuda_fused_sharded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        factorize_solve_cuda_fused_sharded(case.A2, case.ana, case.b, None,
                                           case.opts, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_ms, _, by_name = _device_ms(prof)
    if dev_ms == 0.0:
        return [f"busy share sharded {case.label}: not measured (the "
                "profiler saw no device time)"]
    part = {k: sum(t for name, (t, _) in by_name.items() if k in name)
            for k in ("ab_chunk_kernel", "c_chunk_kernel", "nccl")}
    return [f"busy share sharded {case.label}, Analysis reused (profiler "
            f"on): wall {wall:.3f} s, device {dev_ms / 1e3:.3f} s, "
            f"{100 * dev_ms / 1e3 / wall:.1f}%; " + ", ".join(
                f"{k} {v:.1f} ms" for k, v in part.items())]


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

    cases = [Case("uni10k", "uni10k", None),
             Case("uni100k-natural", "uni100k", slip.Ordering.NONE, warm=1),
             Case("uni100k-default", "uni100k", None, grouped=True,
                  segmented=True, warm=1),
             Case("tri1000", "tri1000", None, segmented=True)]
    launches = {k: 0 for k in _counters()}
    for case in cases:
        lines, got = main_path(slip, torch, case, warm=case.warm)
        for line in lines:
            print(line, flush=True)
        for k, v in got.items():
            launches[k] += v
    P = slip.Pivot
    dense = [DenseCase("grid16", "grid16", {}, warm=1)]
    dense += [DenseCase(f"tri200 {p.name}", "tri200", {"pivot": p},
                        factor_check=p in (P.SMALLEST, P.TOL_LARGEST))
              for p in P]
    dense += [DenseCase("sparse100 max_limbs=2", "sparse100",
                        {"max_limbs": 2}, retries=True),
              DenseCase("grid24", "grid24", {})]
    for case in dense:
        lines, got = dense_path(slip, torch, case)
        for line in lines:
            print(line, flush=True)
        for k, v in got.items():
            launches[k] += v
    # the sharded fused solve at world size 1: one rank, one NCCL group
    import tempfile

    import torch.distributed as dist
    torch.cuda.set_device(0)
    store = tempfile.TemporaryDirectory()
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(store.name, "store"), 1), rank=0, world_size=1)
    base = {c.label: c for c in cases}
    shard = [ShardCase("uni10k", "uni10k", warm=3),
             ShardCase("uni100k-default", "uni100k", warm=1,
                       base=base["uni100k-default"]),
             # a new Analysis: the transversal pivots cancel, so the first
             # call climbs the ladder to the bound and falls back (the
             # reference's rule); the warm call runs on the pinned rows
             ShardCase("tri1000", "tri1000", warm=1, fallback=(0,),
                       segmented=True),
             ShardCase("cancel4", "cancel4", order=slip.Ordering.NONE,
                       fallback=(0,))]
    for case in shard:
        lines, got = sharded_path(slip, torch, case)
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
    for line in dense_busy_share(slip, torch, dense[0]):
        print(line, flush=True)
    for line in shard_busy_share(torch, shard[0]):
        print(line, flush=True)
    klines, rep = stream_checks(slip, torch, cases[0])
    rlines, rep["relift_gt"] = boundary_checks(torch, cases[2])
    glines = grouped_segment_check(slip, torch)
    mlines, rep["mul_shared"] = k5_checks(torch)
    slines, srep = shard_kernel_checks(slip, torch, shard[0])
    rep.update(srep)
    for line in klines + rlines + glines + mlines + slines:
        print(line)
    dist.destroy_process_group()
    store.cleanup()
    kernels = []
    ref = "slip_lu_tpu/tpu/factor_fused.py"
    shard_ref = "slip_lu_tpu/parallel/factor_fused_shard.py"
    for name, source, replaces in (
            ("factor_stream", "slip_lu_tpu_torch/csrc/fused.cu",
             f"{ref}:735"),
            ("solve_stream", "slip_lu_tpu_torch/csrc/fused.cu",
             f"{ref}:1116"),
            ("relift_gt", "slip_lu_tpu_torch/csrc/relift.cu",
             "slip_lu_tpu/tpu/relift.py:89"),
            ("mul_shared", "slip_lu_tpu_torch/csrc/mul_shared.cu",
             "slip_lu_tpu/ops/pallas_kernels.py:103"),
            ("ab_chunk", "slip_lu_tpu_torch/csrc/fused_shard.cu",
             f"{shard_ref}:53"),
            ("c_chunk", "slip_lu_tpu_torch/csrc/fused_shard.cu",
             f"{shard_ref}:157")):
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
