"""The port's exact solve end to end, on the kernels' plain versions
(device="cpu"), held to the JAX package: its host oracle on the corpus,
the cases of tests/test_fused.py and of the fused overflow injection,
and its fused solve with one width segment and ungrouped streams (the
slice the port implements).

Equality is exact: the solutions are rationals.
"""

import os

import numpy as np
import pytest
import torch

import slip_lu_tpu as ref
import slip_lu_tpu_torch as port
from slip_lu_tpu.tpu.backslash_fused import factorize_solve_tpu_fused
from slip_lu_tpu_torch.gpu.backslash_fused import factorize_solve_cuda_fused

from conftest import random_sparse_int
from test_torch_host import release_jax  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATS = os.path.join(REPO, "data", "ExampleMats")


def _read(pkg, name):
    return (pkg.read_triplet(os.path.join(MATS, f"{name}_mat.txt")),
            pkg.read_dense(os.path.join(MATS, f"{name}_v.txt")))


def _dense(pkg, rows, b):
    A = pkg.matrix_copy(pkg.SlipMatrix.from_dense(
        np.array(rows, dtype=object), pkg.Type.MPZ), pkg.Kind.CSC,
        pkg.Type.MPZ)
    bb = pkg.SlipMatrix.from_dense(np.array([[v] for v in b], dtype=object),
                                   pkg.Type.MPZ)
    return A, bb


def _assert_same(x, y):
    assert (x.m, x.n) == (y.m, y.n)
    for i in range(x.m):
        for c in range(x.n):
            assert x.x[i, c] == y.x[i, c], (i, c)


@pytest.mark.parametrize("name", ["tiny4", "dense10", "arrow25", "tri20",
                                  "grid8", "sparse30", "multirhs15", "rat12",
                                  "wide_range"])
def test_corpus_matches_host_oracle(name):
    A, b = _read(port, name)
    x = port.backslash(A, b, port.Type.MPQ, port.Options(check=True),
                       backend="cuda-fused", device="cpu")
    st = port.last_stats()
    assert st.backend == "cuda-fused" and not st.fallback
    Ar, br = _read(ref, name)
    _assert_same(x, ref.backslash(Ar, br, ref.Type.MPQ, ref.Options()))


def test_singular_raises():
    A, b = _dense(port, [[1, 2], [2, 4]], [1, 1])
    with pytest.raises(port.SlipSingularError):
        port.backslash(A, b, port.Type.MPQ, port.Options(), device="cpu")


def test_cancellation_replans_around_oracle_pivots():
    """The transversal pivot cancels exactly: the solve replans around
    the host oracle's pivot rows and still solves on the device path."""
    rows = [[1, 1, 0], [1, 1, 1], [0, 1, 1]]
    A, b = _dense(port, rows, [1, 2, 3])
    opts = port.Options(order=port.Ordering.NONE)
    x = port.backslash(A, b, port.Type.MPQ, opts, device="cpu")
    st = port.last_stats()
    assert st.backend == "cuda-fused" and not st.fallback
    assert "replan" in st.phases
    Ar, br = _dense(ref, rows, [1, 2, 3])
    _assert_same(x, ref.backslash(Ar, br, ref.Type.MPQ,
                                  ref.Options(order=ref.Ordering.NONE)))


def test_2adically_deep_pivots_climb_not_sing():
    """diag(3*2^16): the pivots are 0 mod 2^(16*W8) for several rungs, so
    sing rides with overflow; the ladder must climb, never fall back."""
    n = 12
    rows = [[3 * 2**16 if i == j else 0 for j in range(n)] for i in range(n)]
    A, b = _dense(port, rows, list(range(1, n + 1)))
    x = port.backslash(A, b, port.Type.MPQ, port.Options(), device="cpu")
    st = port.last_stats()
    assert st.backend == "cuda-fused" and not st.fallback
    assert st.retries >= 1
    Ar, br = _dense(ref, rows, list(range(1, n + 1)))
    _assert_same(x, ref.backslash(Ar, br, ref.Type.MPQ, ref.Options()))


def _random_rows(n, seed, lo=-9, hi=9, blo=-9, bhi=10, density=0.3):
    """The systems of tests/test_fused.py and tests/test_overflow_injection
    .py as plain rows (same generator, same seeds), so both packages can
    build them."""
    rng = np.random.default_rng(seed)
    M = random_sparse_int(n, density=density, lo=lo, hi=hi, rng=rng)
    rows = [[int(M.x[i, j]) for j in range(n)] for i in range(n)]
    return rows, [int(rng.integers(blo, bhi)) for _ in range(n)]


def test_widen_retry_with_clamp():
    """max_limbs clamps below the true width: the widen ladder converges
    to the exact answer (overflow flags, never wrong bits)."""
    rows, bvals = _random_rows(10, 5, -10**6, 10**6, -10**6, 10**6)
    A, b = _dense(port, rows, bvals)
    opts = port.Options(max_limbs=2)
    x = factorize_solve_cuda_fused(A, port.analyze(A, opts), b, opts,
                                   device="cpu", heads_per_chunk=4,
                                   pass1_events=8, pass2_events=16)
    assert port.last_stats().retries >= 1
    Ar, br = _dense(ref, rows, bvals)
    _assert_same(x, ref.backslash(Ar, br, ref.Type.MPQ, ref.Options()))


@pytest.mark.parametrize("max_limbs", [2, 3, 4, 6])
def test_overflow_injection_sweep(max_limbs):
    """Every clamp level converges to the exact answer through the ladder
    or refuses cleanly with SlipLimbOverflowError — never wrong bits."""
    rows, bvals = _random_rows(5, 13, -10**5, 10**5, -10**5, 10**5, 0.5)
    A, b = _dense(port, rows, bvals)
    try:
        x = port.backslash(A, b, port.Type.MPQ,
                           port.Options(max_limbs=max_limbs), device="cpu")
    except port.SlipLimbOverflowError:
        return
    Ar, br = _dense(ref, rows, bvals)
    _assert_same(x, ref.backslash(Ar, br, ref.Type.MPQ, ref.Options()))


def test_optimistic_width_ladder_caches_widths():
    """No clamp: the optimistic start converges by widen-and-retry and
    caches the widths on the Analysis, so a warm solve pays no retry."""
    rows, bvals = _random_rows(6, 5, -10**6, 10**6, -10**6, 10**6, 0.5)
    A, b = _dense(port, rows, bvals)
    opts = port.Options()
    ana = port.analyze(A, opts)
    x = factorize_solve_cuda_fused(A, ana, b, opts, device="cpu")
    assert getattr(ana, "fused_width_cache", None) is not None
    x2 = factorize_solve_cuda_fused(A, ana, b, opts, device="cpu")
    assert port.last_stats().retries == 0
    Ar, br = _dense(ref, rows, bvals)
    x_ref = ref.backslash(Ar, br, ref.Type.MPQ, ref.Options())
    _assert_same(x, x_ref)
    _assert_same(x2, x_ref)


def test_slice_matches_reference_fused_solve(monkeypatch):
    """The whole slice against the JAX fused solve with one width
    segment and ungrouped streams: equal solutions, equal widths."""
    monkeypatch.setenv("SLIP_FUSED_SEGMENTS", "0")
    monkeypatch.setenv("SLIP_FUSED_SUBTREE", "0")
    rows, bvals = _random_rows(15, 2, blo=-9, bhi=10)
    A, b = _dense(port, rows, bvals)
    Ar, br = _dense(ref, rows, bvals)
    kw = dict(heads_per_chunk=4, pass1_events=8, pass2_events=16)
    x_ref = factorize_solve_tpu_fused(Ar, ref.analyze(Ar, ref.Options()), br,
                                      ref.Options(), **kw)
    st_ref = ref.stats.last_stats()
    x = factorize_solve_cuda_fused(A, port.analyze(A, port.Options()), b,
                                   port.Options(), device="cpu", **kw)
    st = port.last_stats()
    _assert_same(x, x_ref)
    assert (st.W, st.Ws, st.retries) == (st_ref.W, st_ref.Ws,
                                         st_ref.retries)


def _always_singular(n, W8, Ws8, WN, WNS, WI8, st, val_in, b_rows, **kw):
    """A device half whose factor stream flags a singular pivot (and no
    overflow) on every call, as only a kernel fault could under the
    oracle's pinned pivots (one segment on each stream, as tri20 plans)."""
    flat = torch.zeros(2 + W8 + b_rows.shape[0] * (2 + n * Ws8),
                       dtype=torch.int32)
    flat[0] = 1
    return flat


def test_last_resort_is_host_oracle_on_cpu(monkeypatch):
    """Both plans flag sing: on the plain versions the host oracle answers
    above the dense path's cap (lowered below tri20's n = 20 here), and
    last_stats() says so."""
    import slip_lu_tpu_torch.gpu.backslash_fused as bf
    monkeypatch.setattr(bf, "fused_solve_all", _always_singular)
    monkeypatch.setattr(bf, "DENSE_NMAX", 10)
    A, b = _read(port, "tri20")
    x = port.backslash(A, b, port.Type.MPQ, port.Options(check=True),
                       device="cpu")
    st = port.last_stats()
    assert st.backend == "cuda-fused" and st.fallback
    assert "replan" in st.phases
    Ar, br = _read(ref, "tri20")
    _assert_same(x, ref.backslash(Ar, br, ref.Type.MPQ, ref.Options()))


def test_last_resort_raises_off_the_cpu(monkeypatch):
    """Both plans flag sing on a device (the meta device stands in for a
    card here): a kernel fault is raised, never answered on the host."""
    import slip_lu_tpu_torch.gpu.backslash_fused as bf
    monkeypatch.setattr(bf, "fused_solve_all", _always_singular)
    monkeypatch.setattr(bf, "_device", lambda device: torch.device("meta"))
    A, b = _read(port, "tri20")
    with pytest.raises(port.SlipPanicError, match="invariant"):
        port.backslash(A, b, port.Type.MPQ, port.Options(), device="cuda")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    A, b = _read(port, "tiny4")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.backslash(A, b, port.Type.MPQ, port.Options())


def test_pivot_exact_is_refused():
    """pivot_exact is no longer refused: through backslash the fused path
    pins the scheme's host pivot rows (tests/test_torch_pivot_exact.py
    holds them to the JAX driver) and solves exactly."""
    A, b = _read(port, "tiny4")
    opts = port.Options(pivot=port.Pivot.LARGEST, pivot_exact=True)
    x = port.backslash(A, b, port.Type.MPQ, opts, device="cpu")
    st = port.last_stats()
    assert st.backend == "cuda-fused" and not st.fallback
    port.check_solution(A, x, b)
    y = port.backslash(A, b, port.Type.MPQ, opts, backend="host")
    assert all(x.x[i, 0] == y.x[i, 0] for i in range(x.m))
