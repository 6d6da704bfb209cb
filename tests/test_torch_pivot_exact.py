"""``Options(pivot_exact=True)`` on the port's fused paths, held to the JAX
package (the fused and sharded-fused cases of ``tests/test_pivot_exact.py``).

With pivot_exact the single-chip and the sharded fused drivers run the
reference pivot search once on the host (``_pin_scheme_rows``) and pin the
chosen rows into the schedule, so ``options.pivot`` is honoured. The port
runs on ``device="cpu"`` (the kernels' plain versions); its pinned rows
must be the JAX driver's (and the host scheme's ``row_perm``), and its
solutions the JAX driver's and the host oracle's. The sharded driver runs
at world size 1 in a one-rank gloo group in this process.
"""

import os
import tempfile

import numpy as np
import pytest
import torch.distributed as dist

import slip_lu_tpu as ref
import slip_lu_tpu_torch as port
from slip_lu_tpu.factorize import factorize as ref_factorize
from slip_lu_tpu.tpu import backslash_fused as ref_bf
from slip_lu_tpu_torch.factorize import factorize as port_factorize
from slip_lu_tpu_torch.gpu import backslash_fused as bf
from slip_lu_tpu_torch.parallel import factorize_solve_cuda_fused_sharded

from conftest import random_sparse_int
from test_torch_host import release_jax  # noqa: F401 (autouse)


def _sys(pkg, n, seed, density=0.25):
    """tests/test_pivot_exact.py's system, built in either package."""
    rng = np.random.default_rng(seed)
    M = random_sparse_int(n, density=density, rng=rng)
    rows = np.array([[int(M.x[i, j]) for j in range(n)] for i in range(n)],
                    dtype=object)
    A = pkg.matrix_copy(pkg.SlipMatrix.from_dense(rows, pkg.Type.MPZ),
                        pkg.Kind.CSC, pkg.Type.MPZ)
    b = pkg.SlipMatrix.from_dense(np.array(
        [[int(rng.integers(-9, 10))] for _ in range(n)], dtype=object),
        pkg.Type.MPZ)
    return A, b


def _rows(r):
    return list(map(int, r))


def _assert_same(x, y):
    assert (x.m, x.n) == (y.m, y.n)
    for i in range(x.m):
        for c in range(x.n):
            assert x.x[i, c] == y.x[i, c], (i, c)


def _ref_pin(n, seed, scheme_name):
    """The JAX driver's pinned rows for this system and scheme."""
    A, _ = _sys(ref, n, seed)
    o = ref.Options(pivot=ref.Pivot[scheme_name], pivot_exact=True)
    ana = ref.analyze(A, o)
    ref_bf._pin_scheme_rows(A, ana, o)
    return _rows(ana.sparse_fixed_r)


@pytest.mark.parametrize("scheme", ["SMALLEST", "LARGEST", "FIRST_NONZERO"])
def test_fused_pivot_exact_pins_scheme_rows(scheme):
    """The pinned sequence is the host scheme's row_perm and the JAX
    driver's; the solve is exact and equals the JAX driver's (same widths
    and retries)."""
    Ar, br = _sys(ref, 18, seed=3)
    o_r = ref.Options(pivot=ref.Pivot[scheme], pivot_exact=True)
    ana_r = ref.analyze(Ar, o_r)
    x_r = ref_bf.factorize_solve_tpu_fused(Ar, ana_r, br, o_r)
    st_r = ref.stats.last_stats()
    A, b = _sys(port, 18, seed=3)
    opts = port.Options(pivot=port.Pivot[scheme], pivot_exact=True)
    ana = port.analyze(A, opts)
    F = port_factorize(A, ana, opts)
    x = bf.factorize_solve_cuda_fused(A, ana, b, opts, device="cpu")
    st = port.last_stats()
    assert ana.sparse_fixed_r is not None
    assert _rows(ana.sparse_fixed_r) == _rows(F.row_perm) == \
        _rows(ana_r.sparse_fixed_r)
    assert (st.W, st.Ws, st.retries, st.fallback) == \
        (st_r.W, st_r.Ws, st_r.retries, st_r.fallback)
    port.check_solution(A, x, b)
    _assert_same(x, x_r)
    _assert_same(x, port.backslash(A, b, port.Type.MPQ, opts,
                                   backend="host"))


def test_pivot_exact_differs_from_transversal():
    """On a matrix where LARGEST picks other rows than the zero-free
    transversal, pivot_exact changes the pinned sequence (the hook fires)."""
    found = False
    for seed in range(12):
        A, b = _sys(port, 16, seed=seed)
        o_l = port.Options(pivot=port.Pivot.LARGEST, pivot_exact=True)
        ana_l = port.analyze(A, o_l)
        try:
            bf.factorize_solve_cuda_fused(A, ana_l, b, o_l, device="cpu")
        except port.SlipError:
            continue
        ana_t = port.analyze(A, port.Options())
        bf.factorize_solve_cuda_fused(A, ana_t, b, port.Options(),
                                      device="cpu")
        pinned = _rows(ana_l.sparse_fixed_r)
        assert pinned == _ref_pin(16, seed, "LARGEST")
        if ana_t.sparse_fixed_r is None \
                or _rows(ana_t.sparse_fixed_r) != pinned:
            found = True
            break
    assert found, "LARGEST never deviated from the transversal"


def test_pivot_exact_retags_on_scheme_change():
    """Same Analysis, new scheme: the pin is recomputed."""
    A, b = _sys(port, 16, seed=4)
    ana = port.analyze(A, port.Options())
    o1 = port.Options(pivot=port.Pivot.SMALLEST, pivot_exact=True)
    x1 = bf.factorize_solve_cuda_fused(A, ana, b, o1, device="cpu")
    assert _rows(ana.sparse_fixed_r) == _rows(port_factorize(
        A, ana, o1).row_perm) == _ref_pin(16, 4, "SMALLEST")
    o2 = port.Options(pivot=port.Pivot.LARGEST, pivot_exact=True)
    x2 = bf.factorize_solve_cuda_fused(A, ana, b, o2, device="cpu")
    assert _rows(ana.sparse_fixed_r) == _rows(port_factorize(
        A, ana, o2).row_perm) == _ref_pin(16, 4, "LARGEST")
    _assert_same(x1, x2)                  # the same exact solution


@pytest.fixture
def one_rank_group():
    """A one-rank gloo process group (FileStore in a temporary
    directory), destroyed after the test."""
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def test_sharded_fused_pivot_exact_parity(one_rank_group):
    """The sharded driver pins the scheme's rows as the reference's does
    (l.207-209) and solves exactly on them, without the fallback."""
    A, b = _sys(port, 14, seed=5)
    opts = port.Options(pivot=port.Pivot.SMALLEST, pivot_exact=True)
    ana = port.analyze(A, opts)
    x = factorize_solve_cuda_fused_sharded(A, ana, b, None, opts,
                                           device="cpu", heads_per_chunk=2,
                                           pass1_events=8, pass2_events=16)
    st = port.last_stats()
    assert st.backend == "cuda-fused-sharded" and not st.fallback
    assert _rows(ana.sparse_fixed_r) == _ref_pin(14, 5, "SMALLEST")
    Ar, _ = _sys(ref, 14, seed=5)
    o_r = ref.Options(pivot=ref.Pivot.SMALLEST, pivot_exact=True)
    assert _rows(ana.sparse_fixed_r) == _rows(ref_factorize(
        Ar, ref.analyze(Ar, o_r), o_r).row_perm)
    port.check_solution(A, x, b)
    _assert_same(x, port.backslash(A, b, port.Type.MPQ, opts,
                                   backend="host"))
