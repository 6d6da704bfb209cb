"""Adaptive-width segments in the port, held to the JAX package.

The planner segments only at real sizes (W >= 32 limbs, >= 16 chunks), so
these tests force multi-segment plans on small systems by patching
``plan_segments`` in both drivers with the same ``_force_split`` plans as
``tests/test_segments.py``: the boundary glue (sign extension, the K4
re-lift on its plain version) and the per-segment widen-and-retry ladder
must give the JAX driver's solutions, widths and retries. The JAX side
runs its Pallas kernels in interpret mode, on small systems only.
"""

import numpy as np
import pytest
import torch

import slip_lu_tpu as ref
import slip_lu_tpu_torch as port
from slip_lu_tpu.tpu import backslash_fused as ref_bf
from slip_lu_tpu_torch.gpu import backslash_fused as bf
from slip_lu_tpu_torch.gpu import factor_fused as ff
from slip_lu_tpu_torch.gpu import relift as rl

from conftest import random_sparse_int
from test_segments import _force_split
from test_torch_host import MATS
from test_torch_host import release_jax  # noqa: F401 (autouse)

KW = dict(heads_per_chunk=2, pass1_events=8, pass2_events=16)


def _system(pkg, n, seed, lohi, density, bvals=None):
    """tests/test_segments.py's systems, built in either package."""
    rng = np.random.default_rng(seed)
    M = random_sparse_int(n, density=density, lo=-lohi, hi=lohi, rng=rng)
    rows = np.array([[int(M.x[i, j]) for j in range(n)] for i in range(n)],
                    dtype=object)
    A = pkg.matrix_copy(pkg.SlipMatrix.from_dense(rows, pkg.Type.MPZ),
                        pkg.Kind.CSC, pkg.Type.MPZ)
    if bvals is None:
        bvals = [int(rng.integers(-lohi, lohi)) for _ in range(n)]
    b = pkg.SlipMatrix.from_dense(np.array([[v] for v in bvals],
                                           dtype=object), pkg.Type.MPZ)
    return A, b


def _assert_same(x, y):
    assert (x.m, x.n) == (y.m, y.n)
    for i in range(x.m):
        for c in range(x.n):
            assert x.x[i, c] == y.x[i, c], (i, c)


@pytest.mark.parametrize("n,parts,seed,lohi", [
    (12, 2, 3, 9),
    # wide entries: the boundary re-lift does real work; the JAX driver's
    # interpret-mode ladder takes over ten minutes here (slow, as in
    # tests/test_segments.py)
    pytest.param(16, 3, 7, 10**6, marks=pytest.mark.slow),
])
def test_forced_segments_match_jax(monkeypatch, n, parts, seed, lohi):
    monkeypatch.setattr(ref_bf, "plan_segments", _force_split(parts))
    monkeypatch.setattr(bf, "plan_segments", _force_split(parts))
    Ar, br = _system(ref, n, seed, lohi, 0.4)
    ana_ref = ref.analyze(Ar, ref.Options())
    x_ref = ref_bf.factorize_solve_tpu_fused(Ar, ana_ref, br, ref.Options(),
                                             **KW)
    st_ref = ref.stats.last_stats()
    A, b = _system(port, n, seed, lohi, 0.4)
    ana = port.analyze(A, port.Options())
    x = bf.factorize_solve_cuda_fused(A, ana, b, port.Options(),
                                      device="cpu", **KW)
    st = port.last_stats()
    _assert_same(x, x_ref)
    assert (st.W, st.Ws, st.retries) == (st_ref.W, st_ref.Ws,
                                         st_ref.retries)
    # the same merged segment plans on both streams
    assert ana.fused_seg_cache[1:] == ana_ref.fused_seg_cache[1:]


def test_segmented_flat_vector_matches_jax():
    """fused_solve_all with two factor and two solve segments, on the same
    stream, value table and b as the JAX one: equal flat vectors, and the
    boundary re-lift ran (WI 16 -> 24 at the factor boundary)."""
    import jax.numpy as jnp
    from slip_lu_tpu.tpu import factor_fused as ref_ff
    from test_torch_fused import _plan, _random_system

    n = 7
    A, bv = _random_system(n, 1)
    es, avals, r = _plan(A, 2, 4, 8)
    avals = [v << 100 for v in avals]
    bcol = [bv[int(r[k])] for k in range(n)]
    W8, Ws8 = 24, 32
    WN, WNS, WI8 = ff._r8(2 * W8 + 2), ff._r8(W8 + Ws8 + 2), ff._r8(Ws8 + 2)
    nf, ns = es.factor.nchunks, es.solve.nchunks
    segs = ((0, nf // 2, 8), (nf // 2, nf, W8))
    ssegs = ((0, ns // 2, 16), (ns // 2, ns, Ws8))
    val = ff.val_tensor(avals, es.init_pos, es.nnz, 8, "cpu")
    b_rows = ff.ints_to_tc_rows(bcol, 4)[None]
    flat_ref = np.asarray(ref_ff.fused_solve_all(
        n, es.nnz, W8, Ws8, WN, WNS, WI8, 2, 4, 8,
        *ref_bf._stream_arrays(es), jnp.asarray(val.numpy()),
        jnp.asarray(b_rows), segments=segs, ssegments=ssegs))
    flat = ff.fused_solve_all(n, W8, Ws8, WN, WNS, WI8,
                              ff.stream_tensors(es, "cpu"), val,
                              torch.from_numpy(b_rows), segments=segs,
                              ssegments=ssegs).numpy()
    assert np.array_equal(flat_ref, flat)
    # the values outgrow the first segment: its overflow flag is up
    assert flat[1] == 1


def test_plan_segments_matches_jax(monkeypatch):
    """The test_plan_segments_shape inputs give the reference's plans."""
    n, nc = 1000, 200
    max_level = np.minimum(np.arange(nc) * 5 + 4, n - 1).astype(np.int32)
    for ml, W, Wmin in ((max_level, 176, 2), (max_level, 16, 2),
                        (max_level[:8], 176, 2), (max_level, 64, 9),
                        (max_level, 256, 2)):
        assert bf.plan_segments(ml, n, W, Wmin) == \
            ref_bf.plan_segments(ml, n, W, Wmin)
    assert len(bf.plan_segments(max_level, n, 176, 2)) >= 2
    monkeypatch.setenv("SLIP_FUSED_SEGMENTS", "0")
    assert bf.plan_segments(max_level, n, 176, 2) == \
        ref_bf.plan_segments(max_level, n, 176, 2) == [[0, nc, 176]]
    plan = [[0, 5, 8], [5, 9, 8], [9, 12, 16], [12, 20, 16]]
    assert bf._merged(plan) == ref_bf._merged(plan) == \
        ((0, 9, 8), (9, 20, 16))


def test_forced_segments_undersized_inner(monkeypatch):
    """The inner segment starts at the 8-limb floor with 10^6-scale
    entries: it must overflow, and the per-segment ladder converges to the
    host oracle's answer (never wrong bits)."""
    n = 10
    A, b = _system(port, n, 21, 10**6, 0.6, bvals=[1] * n)

    def plan(max_level, n_, W, Wmin):
        nc = len(max_level)
        mid = max(1, nc // 2)
        return [[0, mid, ff._r8(Wmin)], [mid, nc, ff._r8(W)]]

    monkeypatch.setattr(bf, "plan_segments", plan)
    before = rl.relift_gt.launches
    x = bf.factorize_solve_cuda_fused(A, port.analyze(A, port.Options()), b,
                                      port.Options(), device="cpu", **KW)
    st = port.last_stats()
    assert st.retries >= 1 and not st.fallback
    assert rl.relift_gt.launches == before       # plain versions only
    _assert_same(x, port.backslash(A, b, port.Type.MPQ, port.Options(),
                                   backend="host"))


def _port_device_half(n, E, W8, Ws8, WN, WNS, WI8, H, C1, C2, fhm, fev1,
                      fev2, scnt, sev1, sev2, val_in, b_rows, hbm=False,
                      segments=None, ssegments=None, tpk=False, CK=1,
                      ndet=None, nxx=0):
    """The JAX fused_solve_all's signature over the port's device half
    (plain versions): one system, one right-hand side, tables in VMEM, so
    the flat layouts are the same."""
    import jax.numpy as jnp
    assert not hbm and not tpk and b_rows.shape[0] == 1

    def t(a):
        return torch.from_numpy(np.array(a))

    fh, sc = np.array(fhm), np.array(scnt)
    st = ff.StreamTensors(H=H, C1=C1, C2=C2, fhm=t(fh), fev1=t(fev1),
                          fev2=t(fev2), scnt=t(sc), sev1=t(sev1),
                          sev2=t(sev2), fhm_host=fh, scnt_host=sc)
    return jnp.asarray(ff.fused_solve_all(
        n, W8, Ws8, WN, WNS, WI8, st, t(val_in), t(b_rows),
        segments=segments, ssegments=ssegments, ndet=ndet, nxx=nxx).numpy())


@pytest.mark.parametrize("name", ["tri200", "sparse100"])
def test_driver_decisions_match_jax(monkeypatch, name):
    """Both drivers over the same device half (the port's plain versions,
    held bit-equal to the JAX kernels by the tests above): the same order,
    pinned rows, grouping, segment plans, widths, retries and solution.
    tri200 settles in three factor segments; sparse100 adopts the grouped
    stream and climbs the ladder."""
    monkeypatch.setattr(ref_bf, "fused_solve_all", _port_device_half)
    got = []
    for pkg, drive in ((ref, ref_bf.factorize_solve_tpu_fused),
                       (port, lambda *a: bf.factorize_solve_cuda_fused(
                           *a, device="cpu"))):
        A = pkg.matrix_copy(pkg.read_triplet(f"{MATS}/{name}_mat.txt"),
                            pkg.Kind.CSC, pkg.Type.MPZ)
        b = pkg.read_dense(f"{MATS}/{name}_v.txt")
        ana = pkg.analyze(A, pkg.Options())
        x = drive(A, ana, b, pkg.Options())
        st = (ref.stats if pkg is ref else port).last_stats()
        es = ana.fused_cache[1][2]
        fr = ana.sparse_fixed_r
        got.append((es.grouped is not None, es.factor.nchunks,
                    es.solve.nchunks, st.W, st.Ws, st.retries,
                    ana.fused_seg_cache[1:], np.asarray(ana.q).tobytes(),
                    None if fr is None else fr.tobytes(),
                    [x.x[i, 0] for i in range(A.n)]))
    assert got[0] == got[1]
    grouped, _, _, _, _, retries, (_, segs, _, _), _, _, _ = got[1]
    assert retries >= 1
    assert (len(segs) >= 3) if name == "tri200" else grouped
