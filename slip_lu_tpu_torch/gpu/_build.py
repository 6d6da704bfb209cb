"""Build and load the CUDA kernels of ``slip_lu_tpu_torch/csrc``.

The sources compile with ``nvcc`` for ``sm_90a``, one process per source,
all started together, and link into one shared library with a plain C
interface, which ``ctypes`` loads (no PyTorch headers, so a build takes
seconds). The library lands in ``slip_lu_tpu_torch/_build``
(git-ignored), named by a hash of the sources, at the first launch of a
kernel; later launches in the process, and later processes on the same
checkout, reuse it.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
                     "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # hmeta ev1 ev2 val SMT GT TZ flags obuf | nc H C1 C2 W8 WN WQ WV WI8
    # L nwarps | stream
    "slip_factor_stream": [_P] * 9 + [_I] * 11 + [_P],
    # cnts ev1 ev2 val SMT GT TZ X flags obuf | nc C1 C2 W8 Ws8 WNS WQ WV
    # WI8 L nwarps | stream
    "slip_solve_stream": [_P] * 10 + [_I] * 11 + [_P],
    # SMT GT_old TZ GT_new | rows smt_stride W8 WIo WIn steps | stream
    "slip_relift_gt": [_P] * 4 + [_I] * 6 + [_P],
    # a s out | B La Ls D | stream
    "slip_mul_shared": [_P] * 3 + [_I] * 4 + [_P],
    # meta ev1 bidx mbc diag val SMT GT TZ flags bc_out obuf | H C1 CB8 W8
    # Wt WN WQ WV WI8 L nwarps | stream
    "slip_ab_chunk": [_P] * 12 + [_I] * 11 + [_P],
    # meta ev2 bidx bc a_src val SMT GT TZ flags obuf | H C2 W8 Wt WN WQ WV
    # WI8 L nwarps | stream
    "slip_c_chunk": [_P] * 11 + [_I] * 10 + [_P],
}


class KernelLibrary:
    """The loaded library plus what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: str, seconds: float,
                 log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = seconds   # 0.0 when an earlier build was reused
        self.build_log = log           # nvcc's output (ptxas resource use)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int


_LIB: Optional[KernelLibrary] = None


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library() -> KernelLibrary:
    """Compile (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    srcs = _sources()
    h = hashlib.sha256()
    for path in srcs:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    so = os.path.join(_BUILD, f"libslip_fused_{h.hexdigest()[:16]}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(so):
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        nvcc = _nvcc()
        t0 = time.perf_counter()
        # one nvcc per source, all at once, then one link
        jobs = []
        for src in (p for p in srcs if p.endswith(".cu")):
            obj = f"{tmp}.{os.path.basename(src)}.o"
            jobs.append((obj, subprocess.Popen(
                [nvcc] + NVCC_FLAGS + ["-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for obj, proc in jobs:
            out = proc.communicate()[0]
            log += out
            if proc.returncode != 0:
                failed.append(proc.returncode)
        if not failed:
            res = subprocess.run(
                [nvcc] + ARCH + ["-shared", "-o", tmp]
                + [obj for obj, _ in jobs], capture_output=True, text=True)
            log += res.stdout + res.stderr
            failed += [res.returncode] if res.returncode else []
        for obj, _ in jobs:
            if os.path.exists(obj):
                os.remove(obj)
        seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
        os.replace(tmp, so)
    _LIB = KernelLibrary(ctypes.CDLL(so), so, seconds, log)
    return _LIB


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
