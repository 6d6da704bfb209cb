"""ctypes binding for the native schedule builder (native/slip_schedule.cpp).

`build_schedule_best` uses the C++ builder when the library is built and
falls back to the pure-Python oracle (tpu/schedule.py). Outputs are
bit-identical (tests/test_native_schedule.py), so either source feeds the
same device kernel.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from ..errors import SlipIncorrectInputError, SlipSingularError
from ..matrix import Kind, SlipMatrix
from ..ordering.native import _load
from .schedule import SparseSchedule, build_schedule

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_configured = False


def _lib():
    global _configured
    lib = _load()
    if lib is None or not hasattr(lib, "slip_schedule_build"):
        return None
    if not _configured:
        lib.slip_schedule_build.restype = ctypes.c_void_p
        lib.slip_schedule_build.argtypes = [
            ctypes.c_int64, ctypes.c_int64, _I64P,
            _I64P, ctypes.POINTER(ctypes.c_uint8), _I64P, _I64P]
        lib.slip_schedule_sizes.restype = ctypes.c_int
        lib.slip_schedule_sizes.argtypes = [ctypes.c_void_p, _I64P]
        lib.slip_schedule_fill.restype = ctypes.c_int
        lib.slip_schedule_fill.argtypes = [ctypes.c_void_p] + [_I32P] * 15 \
            + [_I64P]
        lib.slip_schedule_free.restype = None
        lib.slip_schedule_free.argtypes = [ctypes.c_void_p]
        _configured = True
    return lib


def build_schedule_native(A: SlipMatrix, q: np.ndarray,
                          fixed_r: Optional[np.ndarray] = None
                          ) -> Optional[Tuple[SparseSchedule, np.ndarray]]:
    """Native schedule build; None if the library is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    if A.kind != Kind.CSC:
        raise SlipIncorrectInputError("build_schedule requires CSC")
    n = A.n
    nnzA = int(A.p[n])
    p = np.ascontiguousarray(A.p, dtype=np.int64)
    i = np.ascontiguousarray(A.i[:nnzA], dtype=np.int64)
    mask = np.ascontiguousarray(
        np.fromiter((1 if A.x[t] != 0 else 0 for t in range(nnzA)),
                    count=nnzA, dtype=np.uint8))
    qa = np.ascontiguousarray(np.asarray(q), dtype=np.int64)
    if fixed_r is not None:
        fr = np.ascontiguousarray(np.asarray(fixed_r), dtype=np.int64)
        fr_ptr = fr.ctypes.data_as(_I64P)
    else:
        fr_ptr = None
    h = lib.slip_schedule_build(
        ctypes.c_int64(A.m), ctypes.c_int64(n), p.ctypes.data_as(_I64P),
        i.ctypes.data_as(_I64P),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        qa.ctypes.data_as(_I64P), fr_ptr)
    if not h:
        raise SlipIncorrectInputError("native schedule build failed")
    try:
        sizes = np.zeros(7, dtype=np.int64)
        lib.slip_schedule_sizes(h, sizes.ctypes.data_as(_I64P))
        E, rmax, cmax, umax, lnz, unz, _ = (int(v) for v in sizes)
        if E < 0:
            raise SlipSingularError(
                "matrix is structurally singular (no full transversal)")
        # padded-tile budget: the schedule pads every step to the
        # widest step's pattern (tile tables are n x rmax x cmax int32
        # x 2) — an ordering with a few dense-ish steps can blow this
        # past available memory (AMD on uni100k: >40 GB). Fail fast
        # with advice instead of thrashing; Ordering.AUTO's cost model
        # (analyze.symbolic_cost_estimate) avoids such orderings.
        budget = int(os.environ.get("SLIP_SCHED_BUDGET",
                                    512 * 1024 * 1024))  # elements
        if n * rmax * cmax > budget:
            raise SlipIncorrectInputError(
                f"padded schedule (n={n} x rmax={rmax} x cmax={cmax}) "
                f"exceeds the tile budget ({budget} elements, "
                "SLIP_SCHED_BUDGET to raise) — this ordering "
                "concentrates fill in wide steps; try order=NONE/AUTO "
                "or the host backend")
        a32 = lambda *shape: np.zeros(shape, dtype=np.int32)
        row_of, col_of = a32(E), a32(E)
        init_pos = a32(nnzA)
        col_pos, col_hist = a32(n, rmax), a32(n, rmax)
        row_pos, row_hist = a32(n, cmax), a32(n, cmax)
        diag_pos, diag_hist = a32(n), a32(n)
        tile_pos, tile_hist = a32(n, rmax, cmax), a32(n, rmax, cmax)
        fwd_hist, fwd_xk_hist = a32(n, rmax), a32(n)
        bwd_pos, bwd_row = a32(n, umax), a32(n, umax)
        r = np.zeros(n, dtype=np.int64)
        args = [row_of, col_of, init_pos, col_pos, col_hist, row_pos,
                row_hist, diag_pos, diag_hist, tile_pos, tile_hist,
                fwd_hist, fwd_xk_hist, bwd_pos, bwd_row]
        rc = lib.slip_schedule_fill(
            h, *[a.ctypes.data_as(_I32P) for a in args],
            r.ctypes.data_as(_I64P))
        if rc != 0:
            return None
        sched = SparseSchedule(
            n=n, nnz=E, row_of=row_of, col_of=col_of, init_pos=init_pos,
            rmax=rmax, cmax=cmax, col_pos=col_pos, col_hist=col_hist,
            row_pos=row_pos, row_hist=row_hist, diag_pos=diag_pos,
            diag_hist=diag_hist, tile_pos=tile_pos, tile_hist=tile_hist,
            fwd_hist=fwd_hist, fwd_xk_hist=fwd_xk_hist, bwd_pos=bwd_pos,
            bwd_row=bwd_row, umax=umax, lnz=lnz, unz=unz)
        return sched, r
    finally:
        lib.slip_schedule_free(h)


def build_schedule_best(A: SlipMatrix, q: np.ndarray,
                        fixed_r: Optional[np.ndarray] = None
                        ) -> Tuple[SparseSchedule, np.ndarray]:
    """Native builder when available, Python oracle otherwise."""
    out = build_schedule_native(A, q, fixed_r)
    if out is not None:
        return out
    return build_schedule(A, q, fixed_r)
