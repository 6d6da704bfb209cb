"""The port's device half (slip_lu_tpu_torch/gpu/factor_fused.py) on its
plain path, held to the JAX package.

* ``fused_solve_all`` against the JAX ``fused_solve_all`` (Pallas in
  interpret mode) with the same stream, packed value table and b: the
  flat int32 vectors must be equal;
* a width clamped below need: the overflow flag must equal the
  reference's;
* the factor and solve streams against ``tests/test_stream.py``'s exact
  Python-int replay.

Equality is bit equality throughout (all values are exact integers).
Interpret-mode calls are few and small: the clamped case reuses the
n = 7 shapes, so it reuses that compilation.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slip_lu_tpu.analyze import analyze
from slip_lu_tpu.convert import matrix_copy
from slip_lu_tpu.io import read_dense, read_triplet
from slip_lu_tpu.matrix import Kind, Type
from slip_lu_tpu.options import Options
from slip_lu_tpu.tpu import factor_fused as ref
from slip_lu_tpu.tpu.backslash_fused import _stream_arrays
from slip_lu_tpu.tpu.schedule import _permute_cols
from slip_lu_tpu.tpu.schedule_native import build_schedule_best
from slip_lu_tpu.tpu.schedule_stream import build_event_stream
from slip_lu_tpu_torch.gpu import factor_fused as ff

from conftest import random_sparse_int
from test_stream import replay_stream

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _widths(W, Ws):
    W8 = ff._r8(W)
    Ws8 = ff._r8(max(Ws, W + 1))
    return (W8, Ws8, ff._r8(2 * W8 + 2), ff._r8(W8 + Ws8 + 2),
            ff._r8(max(W8, Ws8) + 2))


def _plan(A, H, C1, C2):
    """Reference planner -> (es, avals in stream order, r)."""
    n = A.n
    ana = analyze(A, Options())
    q = np.asarray(ana.q, np.int64)
    sched, r = build_schedule_best(A, q, None)
    es = build_event_stream(sched, H, C1, C2)
    Aq = _permute_cols(A, q)
    avals = [int(Aq.x[i]) for c in range(n)
             for i in range(int(Aq.p[c]), int(Aq.p[c + 1]))]
    return es, avals, r


def _random_system(n, seed):
    """The systems of tests/test_fused.py (same generator, same seeds)."""
    rng = np.random.default_rng(seed)
    A = matrix_copy(random_sparse_int(n, density=0.3, rng=rng),
                    Kind.CSC, Type.MPZ)
    b = [int(rng.integers(-9, 10)) for _ in range(n)]
    return A, b


def _both_flat(es, avals, bcol, n, W, Ws):
    """The same stream, value table and b through both packages."""
    W8, Ws8, WN, WNS, WI8 = _widths(W, Ws)
    H, C1, C2 = (es.factor.h_step.shape[1], es.factor.ev1.shape[1],
                 es.factor.ev2.shape[1])
    val = ff.val_tensor(avals, es.init_pos, es.nnz, W8, "cpu")
    b_rows = ff.ints_to_tc_rows(bcol, 4)[None]      # one shape: one compile
    flat_ref = np.asarray(ref.fused_solve_all(
        n, es.nnz, W8, Ws8, WN, WNS, WI8, H, C1, C2, *_stream_arrays(es),
        jnp.asarray(val.numpy()), jnp.asarray(b_rows)))
    flat = ff.fused_solve_all(n, W8, Ws8, WN, WNS, WI8,
                              ff.stream_tensors(es, "cpu"), val,
                              torch.from_numpy(b_rows)).numpy()
    return flat_ref, flat, W8


@pytest.mark.parametrize("n,H,C1,C2,seed", [(7, 2, 4, 8, 1),
                                            (15, 4, 8, 16, 2)])
def test_flat_vector_matches_jax(n, H, C1, C2, seed):
    A, b = _random_system(n, seed)
    es, avals, r = _plan(A, H, C1, C2)
    bcol = [b[int(r[k])] for k in range(n)]
    flat_ref, flat, _ = _both_flat(es, avals, bcol, n, 4, 6)
    assert flat_ref.dtype == flat.dtype == np.int32
    assert not flat[:2].any()
    assert np.array_equal(flat_ref, flat)


def test_clamped_width_overflow_flag_matches_jax():
    """Entries scaled by 2**40 at W8 = 8: the pivots outgrow 128 bits, so
    both packages must raise the factor overflow flag (and the solve
    stream's). A sing flag counts only when no overflow came with it."""
    n = 7
    A, b = _random_system(n, 1)
    es, avals, r = _plan(A, 2, 4, 8)
    avals = [v << 40 for v in avals]
    bcol = [b[int(r[k])] << 40 for k in range(n)]
    flat_ref, flat, W8 = _both_flat(es, avals, bcol, n, 4, 6)
    assert flat[1] == flat_ref[1] == 1                    # fovf
    s = 2 + W8
    assert flat[s + 1] == flat_ref[s + 1]                 # sovf
    if not flat[1]:
        assert flat[0] == flat_ref[0]


@pytest.mark.parametrize("name,W,Ws", [("grid8", 16, 24), ("tri20", 8, 16),
                                       ("sparse30", 8, 16)])
def test_streams_match_python_replay(name, W, Ws):
    A = matrix_copy(read_triplet(f"{REPO}/data/ExampleMats/{name}_mat.txt"),
                    Kind.CSC, Type.MPZ)
    bz = matrix_copy(read_dense(f"{REPO}/data/ExampleMats/{name}_v.txt"),
                     Kind.DENSE, Type.MPZ)
    n = A.n
    es, avals, r = _plan(A, 2, 32, 128)
    bcol = [int(bz.x[int(r[k]), 0]) for k in range(n)]
    val_x, X_x, det_x, sing = replay_stream(es, avals, [[v] for v in bcol],
                                            n)
    assert not sing
    W8, Ws8, WN, WNS, WI8 = _widths(W, Ws)
    st = ff.stream_tensors(es, "cpu")
    val0 = ff.val_tensor(avals, es.init_pos, es.nnz, W8, "cpu")
    val, SMT, GT, TZ, fflags = ff.factor_stream(st, val0, n, W8, WN, WI8)
    assert not fflags.any()
    assert ff.tc_rows_to_ints(val[:es.nnz + 1].numpy()) == val_x
    assert ff.tc_rows_to_ints(SMT[n:n + 1].numpy()) == [det_x]
    X0 = ff.x_tensor(torch.from_numpy(ff.ints_to_tc_rows(bcol, 4)), n, Ws8)
    X, sflags = ff.solve_stream(st, val, SMT, GT, TZ, X0, W8, Ws8, WNS, WI8)
    assert not sflags.any()
    assert ff.tc_rows_to_ints(X[:n].numpy()) == [row[0] for row in X_x[:n]]
    # the inputs are never written: a caller may cache them
    assert torch.equal(val0, ff.val_tensor(avals, es.init_pos, es.nnz, W8,
                                           "cpu"))
    assert not X0[n:].any()


def test_wrappers_refuse_other_devices():
    """CPU tensors take the plain versions, CUDA tensors the kernels;
    tensors anywhere else raise instead of falling back."""
    A = matrix_copy(read_triplet(f"{REPO}/data/ExampleMats/tiny4_mat.txt"),
                    Kind.CSC, Type.MPZ)
    es, _, _ = _plan(A, 2, 32, 128)
    st = ff.stream_tensors(es, "meta")
    val = torch.zeros((ff._r8(es.nnz + 1), 8), dtype=torch.int32,
                      device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ff.factor_stream(st, val, A.n, 8, 24, 24)
    X = torch.zeros((ff._r8(A.n + 1), 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ff.solve_stream(st, val, val, val, val, X, 8, 8, 24, 24)
