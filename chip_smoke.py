#!/usr/bin/env python3
"""Smoke run of slip_lu_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the two stream kernels from slip_lu_tpu_torch/csrc with nvcc,
drives the main path (``backslash(..., backend="cuda-fused",
device="cuda")``) on uni10k and on uni100k in natural order, holds each
exact solution to the host oracle's, measures the card's busy share with
torch.profiler, then holds each kernel to its plain PyTorch version on
the card (uni10k's whole stream at the width the ladder settled on, and
a width clamped below need on the shortest prefix of the stream that
overflows). Every comparison is bit
equality: all values are exact integers. Exits non-zero on any failure,
and when there is no CUDA device or no slip_lu_tpu_torch beside it.

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


def main_path(slip, torch, cases):
    """Drive backslash on the card: one cold run, then three warm ones,
    each checked against the host oracle. Returns the result lines."""
    out = []
    for name, order in cases:
        A, b = _load(slip, name)
        opts = slip.Options(check=True) if order is None else \
            slip.Options(check=True, order=order)
        t0 = time.perf_counter()
        x_host = slip.backslash(A, b, slip.Type.MPQ, opts, backend="host")
        host_s = time.perf_counter() - t0
        times, dev_times = [], []
        for rep in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = slip.backslash(A, b, slip.Type.MPQ, opts,
                               backend="cuda-fused", device="cuda")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            st = slip.last_stats()
            dev_times.append(st.phases.get("device", 0.0))
            if st.backend != "cuda-fused" or st.fallback:
                _fail(f"{name}: fell back ({st.summary()})")
            if not _same_x(x, x_host):
                _fail(f"{name}: solution differs from the host oracle")
        out.append(
            f"main path {name}: n={A.n} nnz={st.nnz} W8={st.W} Ws8={st.Ws} "
            f"retries={st.retries} exact=oracle; cold {times[0]:.3f} s "
            f"(device {dev_times[0]:.3f} s), warm median "
            f"{statistics.median(times[1:]):.3f} s (device "
            f"{statistics.median(dev_times[1:]):.3f} s); host oracle "
            f"{host_s:.3f} s")
        out.append("  last run's phases (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in st.phases.items()))
    return out


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
    return dataclasses.replace(
        st, fhm=st.fhm[:kf], fev1=st.fev1[:kf], fev2=st.fev2[:kf],
        fhm_host=st.fhm_host[:kf], scnt=st.scnt[:ks], sev1=st.sev1[:ks],
        sev2=st.sev2[:ks], scnt_host=st.scnt_host[:ks])


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


def kernel_checks(slip, torch):
    """K2 and K3 against their plain versions on uni10k's stream: the
    whole stream at the width the ladder settled on, then a width clamped
    below need on the shortest prefix of the stream that overflows (the
    garbage after the first overflow is compared all the same)."""
    from slip_lu_tpu_torch.convert import matrix_copy
    from slip_lu_tpu_torch.gpu import factor_fused as ff
    from slip_lu_tpu_torch.gpu.backslash_fused import (
        _tc_width, factorize_solve_cuda_fused)
    from slip_lu_tpu_torch.matrix import Kind, Type

    A, b = _load(slip, "uni10k")
    A2 = matrix_copy(A, Kind.CSC, Type.MPZ)
    opts = slip.Options()
    ana = slip.analyze(A2, opts)
    factorize_solve_cuda_fused(A2, ana, b, opts, device="cuda")
    _, (_, r, es, avals) = ana.fused_cache
    W, Ws = ana.fused_width_cache
    n = A2.n
    dev = torch.device("cuda")
    st = ff.stream_tensors(es, dev)
    nf, ns = st.fhm.shape[0], st.scnt.shape[0]
    bz = matrix_copy(b, Kind.DENSE, Type.MPZ)
    bcol = [int(bz.x[int(r[k]), 0]) for k in range(n)]
    lines, report = [], {}
    for label, W_run in (("settled", W), ("clamped", 2)):
        W8 = ff._r8(W_run)
        Ws8 = ff._r8(max(Ws if label == "settled" else 3, W_run + 1))
        WN, WNS = ff._r8(2 * W8 + 2), ff._r8(W8 + Ws8 + 2)
        WI8 = ff._r8(max(W8, Ws8) + 2)
        val = ff.val_tensor(avals, es.init_pos, es.nnz, W8, dev)
        Wb = _tc_width(bcol, Ws8)
        X0 = ff.x_tensor(torch.from_numpy(
            ff.ints_to_tc_rows(bcol, Wb)).to(dev), n, Ws8)
        tables = ff.factor_stream(st, val, n, W8, WN, WI8)[:4]
        kf, ks = nf, ns
        if label == "clamped":
            kf = _shortest_overflowing(lambda k: bool(ff.factor_stream(
                _prefix(st, k, ns), val, n, W8, WN, WI8)[4][1]), nf)
            ks = _shortest_overflowing(lambda k: bool(ff.solve_stream(
                _prefix(st, nf, k), *tables, X0, W8, Ws8, WNS, WI8)[1][1]),
                ns)
        fst, sst = _prefix(st, kf, ns), _prefix(st, nf, ks)
        reps = 3 if label == "settled" else 1
        k_ms, fk = _time_ms(torch, lambda: ff.factor_stream(
            fst, val, n, W8, WN, WI8), reps)
        p_ms, fp = _time_ms(torch, lambda: ff.factor_stream_ref(
            fst, val, n, W8, WN, WI8), 1)
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
            f"kernels vs plain, uni10k {label} W8={W8} Ws8={Ws8} on "
            f"{kf}/{nf} factor and {ks}/{ns} solve chunks: factor flags "
            f"{fflags[:5]}, solve flags {sflags[:5]}, bit-equal; "
            f"factor_stream {k_ms:.3f} ms vs plain {p_ms:.3f} ms; "
            f"solve_stream {ks_ms:.3f} ms vs plain {ps_ms:.3f} ms")
        if label == "settled":
            report = {"factor": (f_err, k_ms, p_ms),
                      "solve": (s_err, ks_ms, ps_ms)}
    return lines, report


def _device_ms(prof):
    """Device time in the profiler's trace, in ms: the sum over kernels,
    copies and sets (one stream, so they do not overlap), and the part
    of it in each stream kernel."""
    from torch.autograd import DeviceType
    total, per = 0.0, {"factor_stream": 0.0, "solve_stream": 0.0}
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
    """The card's busy share in one warm ``backslash`` call (which plans
    again) and in one solve that reuses a warm Analysis: device time from
    torch.profiler over the host-clock wall time of the call, profiler
    on. Returns the result lines."""
    from torch.profiler import ProfilerActivity, profile

    from slip_lu_tpu_torch.convert import matrix_copy
    from slip_lu_tpu_torch.gpu.backslash_fused import \
        factorize_solve_cuda_fused
    from slip_lu_tpu_torch.matrix import Kind, Type

    out = []
    for name, order in cases:
        A, b = _load(slip, name)
        opts = slip.Options(check=True) if order is None else \
            slip.Options(check=True, order=order)
        A2 = matrix_copy(A, Kind.CSC, Type.MPZ)
        ana = slip.analyze(A2, opts)
        factorize_solve_cuda_fused(A2, ana, b, opts, device="cuda")
        calls = (("backslash", lambda: slip.backslash(
                     A, b, slip.Type.MPQ, opts, backend="cuda-fused",
                     device="cuda")),
                 ("Analysis reused", lambda: factorize_solve_cuda_fused(
                     A2, ana, b, opts, device="cuda")))
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
                out.append(f"busy share {name}, {label}: not measured "
                           "(the profiler saw no device time)")
                continue
            out.append(
                f"busy share {name}, {label}: wall {wall:.3f} s, device "
                f"{dev_ms / 1e3:.3f} s, {100 * dev_ms / 1e3 / wall:.1f}%; "
                f"factor_stream {per['factor_stream']:.1f} ms, "
                f"solve_stream {per['solve_stream']:.1f} ms")
    return out


def main() -> int:
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
    from slip_lu_tpu_torch.gpu import factor_fused as ff

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

    ff.factor_stream.launches = 0
    ff.solve_stream.launches = 0
    cases = [("uni10k", None), ("uni100k", slip.Ordering.NONE)]
    lines = main_path(slip, torch, cases)
    launches = {"factor_stream": ff.factor_stream.launches,
                "solve_stream": ff.solve_stream.launches}
    for line in lines:
        print(line)
    print(f"launches on the main path: {launches}")
    for name, cnt in launches.items():
        if cnt <= 0:
            _fail(f"the main path never launched {name}")

    for line in busy_share(slip, torch, cases):
        print(line)
    klines, rep = kernel_checks(slip, torch)
    for line in klines:
        print(line)
    kernels = []
    ref = "slip_lu_tpu/tpu/factor_fused.py"
    for name, key, replaces in (("factor_stream", "factor", f"{ref}:735"),
                                ("solve_stream", "solve", f"{ref}:1116")):
        err, ms, plain_ms = rep[key]
        kernels.append({"name": name, "route": "cuda",
                        "source": "slip_lu_tpu_torch/csrc/fused.cu",
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
