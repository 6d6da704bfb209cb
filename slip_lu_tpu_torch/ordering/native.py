"""Dispatch to the native C++ symbolic library when available.

The reference's ordering layer is native C (AMD/, COLAMD/); this framework's
equivalent is native/slip_symbolic.cpp built into ``libslip_symbolic.so``
and bound here via ctypes (pybind11 is not available in this image). The
pure-Python implementations in amd.py / colamd.py are the oracle and the
fallback when the library has not been built.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from ..matrix import SlipMatrix
from .amd import amd_order
from .colamd import colamd_order

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def _build_if_missing(native_dir: str) -> None:
    """Compile the library from source on first use (g++ is in the image)."""
    so = os.path.join(native_dir, "libslip_symbolic.so")
    mk = os.path.join(native_dir, "Makefile")
    if os.path.exists(so) or not os.path.exists(mk):
        return
    import subprocess
    try:
        subprocess.run(["make", "-C", native_dir], check=False,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        pass


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    _build_if_missing(os.path.join(here, "native"))
    for cand in (
        os.path.join(here, "native", "libslip_symbolic.so"),
        os.path.join(os.path.dirname(__file__), "libslip_symbolic.so"),
    ):
        if os.path.exists(cand):
            try:
                lib = ctypes.CDLL(cand)
                for name in ("slip_amd_order", "slip_colamd_order"):
                    fn = getattr(lib, name)
                    fn.restype = ctypes.c_int
                    fn.argtypes = [
                        ctypes.c_int64, ctypes.c_int64,
                        ctypes.POINTER(ctypes.c_int64),  # p
                        ctypes.POINTER(ctypes.c_int64),  # i
                        ctypes.POINTER(ctypes.c_int64),  # out perm
                    ]
                _LIB = lib
                return _LIB
            except OSError:
                continue
    return None


def _call_native(fn_name: str, A: SlipMatrix) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    n = A.n
    p = np.ascontiguousarray(A.p, dtype=np.int64)
    i = np.ascontiguousarray(A.i[: int(A.p[n])], dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    rc = getattr(lib, fn_name)(
        ctypes.c_int64(A.m), ctypes.c_int64(n),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        i.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        return None
    return out


def _call_approx(fn_name: str, A: SlipMatrix):
    lib = _load()
    if lib is None or not hasattr(lib, fn_name):
        return None
    n = A.n
    p = np.ascontiguousarray(A.p, dtype=np.int64)
    i = np.ascontiguousarray(A.i[: int(A.p[n])], dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    est = ctypes.c_int64(0)
    rc = getattr(lib, fn_name)(
        ctypes.c_int64(A.m), ctypes.c_int64(n),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        i.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(est),
    )
    if rc != 0:
        return None
    return out, int(est.value)


def amd_order_best(A: SlipMatrix, want_fill: bool = False):
    """Approximate minimum degree on the quotient graph (slip_amd.cpp)
    when the native library is present; Python exact-degree greedy
    fallback. Reference: AMD/Source/amd_2.c."""
    res = _call_approx("slip_amd_approx", A)
    if res is not None:
        return res if want_fill else res[0]
    q = _call_native("slip_amd_order", A)
    if q is None:
        q = amd_order(A)
    return (q, None) if want_fill else q


def colamd_order_best(A: SlipMatrix, want_fill: bool = False):
    """COLAMD-style column AMD (rows of A become the initial
    quotient-graph elements, so A'A is never formed; slip_amd.cpp)
    when the native library is present; Python greedy fallback.
    Reference: COLAMD/Source/colamd.c (colamd_l)."""
    res = _call_approx("slip_colamd_approx", A)
    if res is not None:
        return res if want_fill else res[0]
    q = _call_native("slip_colamd_order", A)
    if q is None:
        q = colamd_order(A)
    return (q, None) if want_fill else q


def native_available() -> bool:
    return _load() is not None
