"""Grouped (subtree-local) streams and the dissection in the port, held to
the JAX package.

``slip_lu_tpu_torch/gpu/schedule_subtree.py`` is a copy of the numpy
module ``slip_lu_tpu/tpu/schedule_subtree.py``: its streams must be
byte-equal to the reference's. The port's driver must take the
reference's decisions (the dissection candidate, grouped adoption) and
its device half, on the plain versions, must give the JAX flat vector on a
grouped, segmented stream bit for bit. The JAX side runs its Pallas
kernels in interpret mode, on small systems only.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slip_lu_tpu as ref
import slip_lu_tpu_torch as port
from slip_lu_tpu.tpu import backslash_fused as ref_bf
from slip_lu_tpu.tpu import factor_fused as ref_ff
from slip_lu_tpu.tpu import schedule_native as ref_native
from slip_lu_tpu.tpu import schedule_subtree as ref_sub
from slip_lu_tpu.tpu.schedule import _permute_cols as ref_permute
from slip_lu_tpu_torch.gpu import backslash_fused as bf
from slip_lu_tpu_torch.gpu import factor_fused as ff
from slip_lu_tpu_torch.gpu import relift as rl
from slip_lu_tpu_torch.gpu import schedule_native as port_native
from slip_lu_tpu_torch.gpu import schedule_subtree as port_sub
from slip_lu_tpu_torch.gpu.schedule import _permute_cols as port_permute

from conftest import random_sparse_int
from test_torch_host import MATS, _assert_fields_equal
from test_torch_host import release_jax  # noqa: F401 (autouse)


def _random(pkg, n, density, seed):
    """tests/test_subtree.py's random systems, built in either package."""
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


def _band(pkg, n=220):
    """test_dissect_driver_end_to_end's band: a chain under natural order."""
    rng = np.random.default_rng(5)
    dense = np.zeros((n, n), dtype=object)
    for i in range(n):
        dense[i, i] = 1
        for d in (1, 2, 3):
            if i + d < n:
                dense[i, i + d] = int(rng.integers(-3, 4))
                dense[i + d, i] = int(rng.integers(-3, 4))
    A = pkg.matrix_copy(pkg.SlipMatrix.from_dense(dense, pkg.Type.MPZ),
                        pkg.Kind.CSC, pkg.Type.MPZ)
    b = pkg.SlipMatrix.from_dense(np.array(
        [[int(rng.integers(-5, 6))] for _ in range(n)], dtype=object),
        pkg.Type.MPZ)
    return A, b


def _blocks(pkg):
    """test_grouped_chunk_count_drops's pattern: dense diagonal blocks
    coupled by a tail, under natural order."""
    rng = np.random.default_rng(11)
    n, blk = 96, 12
    dense = np.zeros((n, n), dtype=object)
    for bi in range((n - blk) // blk):
        lo = bi * blk
        for i in range(lo, lo + blk):
            for j in range(lo, lo + blk):
                if i == j:
                    dense[i, j] = int(rng.integers(2, 9))
                elif rng.random() < 0.3:
                    dense[i, j] = int(rng.integers(-4, 5))
    for i in range(n - blk, n):
        dense[i, i] = int(rng.integers(2, 9))
        for j in range(n):
            if j != i and rng.random() < 0.15:
                dense[i, j] = int(rng.integers(-3, 4))
                dense[j, i] = int(rng.integers(-3, 4))
    return pkg.matrix_copy(pkg.SlipMatrix.from_dense(dense, pkg.Type.MPZ),
                           pkg.Kind.CSC, pkg.Type.MPZ)


def _assert_streams_equal(e0, e1):
    for part in ("factor", "solve"):
        _assert_fields_equal(getattr(e0, part), getattr(e1, part), part)
    for f in ("n", "nnz", "lnz", "unz", "ndet", "nxx", "extra_vals"):
        assert getattr(e0, f) == getattr(e1, f), f
    for f in ("init_pos", "row_of", "extra_pos"):
        x, y = getattr(e0, f), getattr(e1, f)
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), f
    g0, g1 = e0.grouped, e1.grouped
    for f in dataclasses.fields(g0):
        x, y = getattr(g0, f.name), getattr(g1, f.name)
        if f.name == "groups":
            assert [g.tobytes() for g in x] == [g.tobytes() for g in y]
        else:
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), f.name


@pytest.mark.parametrize("case", ["random40", "blocks96", "band220"])
def test_grouped_streams_byte_equal(case):
    """try_build_grouped gives the reference's stream, field by field; on
    the band, after the reference's dissection and per-group pinning."""
    built = []
    for pkg, native, sub in ((ref, ref_native, ref_sub),
                             (port, port_native, port_sub)):
        if case == "band220":
            A, _ = _band(pkg)
            q = sub.dissect_order(A, 8)
            sched_u, r_u = native.build_schedule_best(A, q, None)
            gr = sub.partition_groups(sub.dependency_forest(sched_u))
            fixed_r = sub.pin_rows_per_group(A, q, r_u, gr)
            assert fixed_r is not None
            sched, _ = native.build_schedule_best(A, q, fixed_r)
        else:
            if case == "blocks96":
                A = _blocks(pkg)
                opts = pkg.Options(order=pkg.Ordering.NONE)
            else:
                A, _ = _random(pkg, 40, 0.10, 2)
                opts = pkg.Options()
            q = np.asarray(pkg.analyze(A, opts).q, np.int64)
            sched, _ = native.build_schedule_best(A, q, None)
        es = sub.try_build_grouped(sched, 8, 64, 128)
        assert es is not None and len(es.grouped.groups) >= 2
        built.append((np.asarray(q, np.int64), es))
    (q0, e0), (q1, e1) = built
    assert q0.tobytes() == q1.tobytes()
    _assert_streams_equal(e0, e1)


def test_sharded_form_is_not_ported():
    """The chip-partitioned (sharded) grouped stream, once left out of the
    port, is now the reference's: try_build_grouped(p=2) gives the same
    partitioned stream in both packages (tests/test_torch_shard_stream.py
    holds every field, at more ranks and on more systems)."""
    built = []
    for pkg, native, sub in ((ref, ref_native, ref_sub),
                             (port, port_native, port_sub)):
        A, _ = _random(pkg, 40, 0.10, 2)
        q = np.asarray(pkg.analyze(A, pkg.Options()).q, np.int64)
        sched, _ = native.build_schedule_best(A, q, None)
        built.append(sub.try_build_grouped(sched, 8, 64, 128, p=2))
    s0, s1 = built
    assert type(s1).__name__ == "ShardedEventStream" and s1.p == 2
    assert (s0.ndet, s0.nxx, s0.Lp) == (s1.ndet, s1.nxx, s1.Lp)
    for part in ("factor", "solve"):
        _assert_fields_equal(getattr(s0, part), getattr(s1, part), part)


def _grouped_plan(pkg, native, sub, permute):
    """The forced-grouped n = 40 system's stream, A's values in stream order
    and b in pivot order, built in one package."""
    A, b = _random(pkg, 40, 0.10, 2)
    q = np.asarray(pkg.analyze(A, pkg.Options()).q, np.int64)
    sched, r = native.build_schedule_best(A, q, None)
    es = sub.try_build_grouped(sched, 8, 64, 128)
    Aq = permute(A, q)
    avals = [int(Aq.x[i]) for c in range(A.n)
             for i in range(int(Aq.p[c]), int(Aq.p[c + 1]))]
    bcol = [int(b.x[int(r[k]), 0]) for k in range(A.n)]
    return es, avals, bcol


def test_grouped_segmented_flat_vector_matches_jax(monkeypatch):
    """fused_solve_all on a grouped stream (ndet, nxx, the extra value
    slots) with two forced factor segments and two solve segments: the
    port's plain versions give the JAX flat vector bit for bit, and the
    factor boundary re-lifts GT (WI 16 -> 24)."""
    es, avals, bcol = _grouped_plan(port, port_native, port_sub,
                                    port_permute)
    es_r, avals_r, bcol_r = _grouped_plan(ref, ref_native, ref_sub,
                                          ref_permute)
    _assert_streams_equal(es_r, es)
    assert (avals, bcol) == (avals_r, bcol_r)
    n = 40
    W8, Ws8 = 16, 24
    WN, WNS, WI8 = ff._r8(2 * W8 + 2), ff._r8(W8 + Ws8 + 2), ff._r8(Ws8 + 2)
    nf, ns = es.factor.nchunks, es.solve.nchunks
    segs = ((0, nf // 2, 8), (nf // 2, nf, W8))
    ssegs = ((0, ns // 2, 16), (ns // 2, ns, Ws8))
    val = ff.val_tensor(avals, es.init_pos, es.nnz, 8, "cpu", es.extra_pos,
                        es.extra_vals)
    b_rows = ff.ints_to_tc_rows(bcol, 2)[None]
    H, C1, C2 = (es.factor.h_step.shape[1], es.factor.ev1.shape[1],
                 es.factor.ev2.shape[1])
    flat_ref = np.asarray(ref_ff.fused_solve_all(
        n, es.nnz, W8, Ws8, WN, WNS, WI8, H, C1, C2,
        *ref_bf._stream_arrays(es_r), jnp.asarray(val.numpy()),
        jnp.asarray(b_rows), segments=segs, ssegments=ssegs, ndet=es.ndet,
        nxx=es.nxx))
    st = ff.stream_tensors(es, "cpu")
    seen = []
    real = rl.relift_gt

    def spy(SMT, GT, TZ, W8_, WIo, WIn):
        seen.append((WIo, WIn))
        return real(SMT, GT, TZ, W8_, WIo, WIn)

    monkeypatch.setattr(ff, "relift_gt", spy)
    flat = ff.fused_solve_all(n, W8, Ws8, WN, WNS, WI8, st, val,
                              torch.from_numpy(b_rows), segments=segs,
                              ssegments=ssegs, ndet=es.ndet,
                              nxx=es.nxx).numpy()
    assert np.array_equal(flat_ref, flat)
    assert seen and seen[0] == (16, 24)
    assert not flat[:4].any()               # both segments flag nothing


def test_forced_grouped_driver_matches_oracle(monkeypatch):
    """SLIP_FUSED_SUBTREE=force on test_grouped_fused_device_parity's
    system: the port adopts the grouped stream and answers exactly."""
    monkeypatch.setenv("SLIP_FUSED_SUBTREE", "force")
    A, b = _random(port, 40, 0.10, 2)
    ana = port.analyze(A, port.Options())
    x = bf.factorize_solve_cuda_fused(A, ana, b, port.Options(),
                                      device="cpu")
    port.check_solution(A, x, b)
    xo = port.backslash(A, b, port.Type.MPQ, port.Options(), backend="host")
    for k in range(A.n):
        assert x.x[k, 0] == xo.x[k, 0], k
    es = ana.fused_cache[1][2]
    assert es.grouped is not None and len(es.grouped.groups) >= 2
    assert not port.last_stats().fallback


def test_dissect_candidate_matches_jax():
    """The n = 220 band: the port's dissection candidate (order, pinned
    rows, certified width) is the reference's."""
    opts_r = ref.Options(order=ref.Ordering.NONE)
    opts_p = port.Options(order=port.Ordering.NONE)
    A_r, _ = _band(ref)
    A_p, _ = _band(port)
    c_r = ref_bf._dissect_candidate(A_r, ref.analyze(A_r, opts_r), opts_r)
    c_p = bf._dissect_candidate(A_p, port.analyze(A_p, opts_p), opts_p)
    assert c_r is not None and c_p is not None
    for x, y in ((c_r[0], c_p[0]), (c_r[1], c_p[1]), (c_r[3], c_p[3])):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
    assert c_r[4] == c_p[4]


def test_dissect_driver_matches_oracle(monkeypatch):
    """test_dissect_driver_end_to_end through the port: the dissection is
    committed (grouped stream, pinned rows) and the answer is the host
    oracle's."""
    monkeypatch.setenv("SLIP_FUSED_SUBTREE", "force")
    A, b = _band(port)
    opts = port.Options(order=port.Ordering.NONE)
    ana = port.analyze(A, opts)
    x = bf.factorize_solve_cuda_fused(A, ana, b, opts, device="cpu")
    port.check_solution(A, x, b)
    xo = port.backslash(A, b, port.Type.MPQ, opts, backend="host")
    for k in range(A.n):
        assert x.x[k, 0] == xo.x[k, 0], k
    assert ana.fused_cache[1][2].grouped is not None
    assert ana.sparse_fixed_r is not None


class _Planned(Exception):
    """Raised in place of the device half: the decisions are taken."""


def _plan_only(*args, **kw):
    raise _Planned


def test_uni10k_adoption_matches_jax(monkeypatch):
    """uni10k in its default ordering: both drivers build and certify the
    dissection candidate and both reject it (the stream stays ungrouped,
    the order and rows as they were)."""
    monkeypatch.setattr(ref_bf, "fused_solve_all", _plan_only)
    monkeypatch.setattr(bf, "fused_solve_all", _plan_only)
    got = []
    for pkg, drive in ((ref, ref_bf.factorize_solve_tpu_fused),
                       (port, lambda *a: bf.factorize_solve_cuda_fused(
                           *a, device="cpu"))):
        A = pkg.matrix_copy(pkg.read_triplet(f"{MATS}/uni10k_mat.txt"),
                            pkg.Kind.CSC, pkg.Type.MPZ)
        b = pkg.read_dense(f"{MATS}/uni10k_v.txt")
        ana = pkg.analyze(A, pkg.Options())
        with pytest.raises(_Planned):
            drive(A, ana, b, pkg.Options())
        es = ana.fused_cache[1][2]
        cand = ana.nd_candidate[8]
        got.append((es.grouped is None, np.asarray(ana.q).tobytes(),
                    ana.sparse_fixed_r, None if cand is None else cand[4],
                    es.factor.nchunks, es.solve.nchunks))
    (g0, q0, f0, w0, nf0, ns0), (g1, q1, f1, w1, nf1, ns1) = got
    assert g0 and g1                      # not grouped in either
    assert f0 is None and f1 is None      # no pinned rows committed
    assert (q0, w0, nf0, ns0) == (q1, w1, nf1, ns1)
    assert w0 is not None                 # a candidate existed
