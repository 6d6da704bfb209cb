"""Member lanes of the stream kernels (K2, K3) in the port, held to the JAX
package.

The reference runs several systems, or several right-hand sides of one
system, through one chunk stream on its vector lanes (member-lane
batching): tables with member rows keep logical row r of member g at row
r*G + g. The port's plain versions put the members on a tensor dimension.
Here, on the same streams and tables, they must equal the JAX kernels in
interpret mode bit for bit:

* ``factor_stream`` / ``solve_stream`` at G = 2 and 3 pattern-sharing
  systems (every table per member, the reference's ``factor_fused`` and
  ``solve_fused`` with ``a_g = tab_g = True``);
* ``solve_stream`` with R = 2 and 3 right-hand sides of one system (only X
  per lane, the tables shared: ``a_g = tab_g = False``);
* the flat vectors of ``fused_solve_all`` with four right-hand sides
  (multirhs15: the right-hand-side lanes) and of ``fused_solve_many`` at
  G = 3 in two factor segments (the tables widen and GT re-lifts on member
  rows at the boundary).

Interpret-mode calls are few and small (n = 7 and 15).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slip_lu_tpu.convert import matrix_copy
from slip_lu_tpu.io import read_dense, read_triplet
from slip_lu_tpu.matrix import Kind, Type
from slip_lu_tpu.tpu import factor_fused as ref
from slip_lu_tpu.tpu.backslash_fused import _stream_arrays
from slip_lu_tpu_torch.gpu import factor_fused as ff
from slip_lu_tpu_torch.gpu import relift as rl

from test_torch_fused import _plan, _random_system, _widths
from test_torch_host import MATS
from test_torch_host import release_jax  # noqa: F401 (autouse)


def _member_values(avals, G, seed):
    """Member 0 keeps the system's values; members 1.. get others on the
    same pattern (nonzero, |v| <= 9), from a seed."""
    rng = np.random.default_rng(seed)
    out = [list(avals)]
    for _ in range(1, G):
        mag = rng.integers(1, 10, len(avals))
        sign = rng.choice([-1, 1], len(avals))
        out.append([int(v) for v in mag * sign])
    return out


def _val_stack(es, vals, W8):
    """[G, E8, W8]: each member's packed value table."""
    return np.stack([ff.val_tensor(av, es.init_pos, es.nnz, W8,
                                   "cpu").numpy() for av in vals])


def _interleave(stack):
    """[G, R, W] -> [R*G, W], row r*G + g (the reference's val_stack
    interleave)."""
    return np.ascontiguousarray(stack.transpose(1, 0, 2)).reshape(
        -1, stack.shape[2])


def _b_lanes(es, r, n, bcols, Wb):
    """[L, n, Wb] limb rows of L right-hand sides, permuted by r."""
    return np.stack([ff.ints_to_tc_rows([col[int(r[k])] for k in range(n)],
                                        Wb) for col in bcols])


def _assert_equal(ref_arrays, port_tensors, rows=None):
    """Equal tables; rows: compare only the first rows of each (the
    reference leaves the never-written logical row n+1 of SMT / GT / TZ
    unset)."""
    for a, t in zip(ref_arrays, port_tensors):
        assert np.array_equal(np.asarray(a)[:rows], t.numpy()[:rows])


@pytest.mark.parametrize("G", [2, 3])
def test_member_streams_match_jax(G):
    """K2 and K3 plain versions at G pattern-sharing systems against the
    JAX kernels (interpret mode): every table, X and the per-member
    flags."""
    n, H, C1, C2 = 7, 2, 4, 8
    A, bv = _random_system(n, 1)
    es, avals, r = _plan(A, H, C1, C2)
    W8, Ws8, WN, WNS, WI8 = _widths(4, 6)
    vals = _member_values(avals, G, seed=G)
    val_il = _interleave(_val_stack(es, vals, W8))
    fhm, fev1, fev2, scnt, sev1, sev2 = _stream_arrays(es)
    E = es.nnz
    rf = ref.factor_fused(n, E, W8, WN, WI8, H, C1, C2, fhm, fev1, fev2,
                          jnp.asarray(val_il), G=G)
    st = ff.stream_tensors(es, "cpu")
    pf = ff.factor_stream(st, torch.from_numpy(val_il), n, W8, WN, WI8, G=G)
    _assert_equal(rf[:1], pf[:1])
    _assert_equal(rf[1:4], pf[1:4], rows=(n + 1) * G)
    assert pf[4].shape == (8, G)
    assert np.array_equal(np.asarray(rf[4])[:, :G], pf[4].numpy())
    assert pf[0].shape == (ff._r8(E + 1) * G, W8)
    assert pf[1].shape == ((n + 2) * G, W8)
    rng = np.random.default_rng(10 + G)
    bcols = [bv] + [[int(v) for v in rng.integers(-9, 10, n)]
                    for _ in range(G - 1)]
    X0 = ff.x_tensor(torch.from_numpy(_b_lanes(es, r, n, bcols, 4)), n, Ws8)
    assert X0.shape == (ff._r8((n + 1) * G), Ws8)
    rs = ref.solve_fused(n, E, W8, Ws8, WNS, WI8, C1, C2, scnt, sev1, sev2,
                         *rf[:4], jnp.asarray(X0.numpy()), G=G)
    ps = ff.solve_stream(st, *pf[:4], X0, W8, Ws8, WNS, WI8, G=G)
    _assert_equal(rs[:1], ps[:1])
    assert np.array_equal(np.asarray(rs[1])[:, :G], ps[1].numpy())


@pytest.mark.parametrize("R", [2, 3])
def test_shared_table_solve_matches_jax(R):
    """K3's plain version with R right-hand sides of one factored system
    (X per lane, value table and SMT / GT / TZ shared) against the JAX
    ``solve_fused(..., a_g=False, tab_g=False)``."""
    n, H, C1, C2 = 7, 2, 4, 8
    A, bv = _random_system(n, 1)
    es, avals, r = _plan(A, H, C1, C2)
    W8, Ws8, WN, WNS, WI8 = _widths(4, 6)
    st = ff.stream_tensors(es, "cpu")
    val0 = ff.val_tensor(avals, es.init_pos, es.nnz, W8, "cpu")
    tables = ff.factor_stream(st, val0, n, W8, WN, WI8)[:4]
    rng = np.random.default_rng(20 + R)
    bcols = [bv] + [[int(v) for v in rng.integers(-9, 10, n)]
                    for _ in range(R - 1)]
    X0 = ff.x_tensor(torch.from_numpy(_b_lanes(es, r, n, bcols, 4)), n, Ws8)
    _, _, _, scnt, sev1, sev2 = _stream_arrays(es)
    rs = ref.solve_fused(n, es.nnz, W8, Ws8, WNS, WI8, C1, C2, scnt, sev1,
                         sev2, *(jnp.asarray(t.numpy()) for t in tables),
                         jnp.asarray(X0.numpy()), G=R, a_g=False,
                         tab_g=False)
    ps = ff.solve_stream(st, *tables, X0, W8, Ws8, WNS, WI8, G=R, a_g=False,
                         tab_g=False)
    _assert_equal(rs[:1], ps[:1])
    assert np.array_equal(np.asarray(rs[1])[:, :R], ps[1].numpy())
    # lane c is the one-column solve of right-hand side c
    for c in range(R):
        Xc, _ = ff.solve_stream(st, *tables, ff.x_tensor(
            X0[:n * R].view(n, R, Ws8)[:, c], n, Ws8), W8, Ws8, WNS, WI8)
        assert torch.equal(Xc[:n], ps[0][:n * R].view(n, R, Ws8)[:, c])


def test_rhs_lanes_flat_vector_matches_jax():
    """multirhs15's four right-hand sides through ``fused_solve_all``:
    one lane-batched solve-stream run in both packages, flat vectors
    equal, no flag up."""
    A = matrix_copy(read_triplet(os.path.join(MATS, "multirhs15_mat.txt")),
                    Kind.CSC, Type.MPZ)
    bz = matrix_copy(read_dense(os.path.join(MATS, "multirhs15_v.txt")),
                     Kind.DENSE, Type.MPZ)
    n, nrhs = A.n, bz.n
    assert nrhs == 4
    es, avals, r = _plan(A, 2, 32, 128)
    W8, Ws8, WN, WNS, WI8 = _widths(8, 16)
    val = ff.val_tensor(avals, es.init_pos, es.nnz, W8, "cpu")
    bcols = [[int(bz.x[i, c]) for i in range(n)] for c in range(nrhs)]
    b_rows = _b_lanes(es, r, n, bcols, 2)
    flat_ref = np.asarray(ref.fused_solve_all(
        n, es.nnz, W8, Ws8, WN, WNS, WI8, 2, 32, 128, *_stream_arrays(es),
        jnp.asarray(val.numpy()), jnp.asarray(b_rows)))
    flat = ff.fused_solve_all(n, W8, Ws8, WN, WNS, WI8,
                              ff.stream_tensors(es, "cpu"), val,
                              torch.from_numpy(b_rows)).numpy()
    assert np.array_equal(flat_ref, flat)
    # [fsing, fovf] [det] [ssing*4, sovf*4] [X: n*4*Ws8]
    assert flat.size == 2 + W8 + 2 * nrhs + n * nrhs * Ws8
    assert not flat[:2].any() and not flat[2 + W8:2 + W8 + 2 * nrhs].any()


def test_family_flat_vector_two_segments_matches_jax():
    """``fused_solve_many`` at G = 3 in two forced factor segments (8 then
    16 limbs): the value tables widen and GT re-lifts on member rows at the
    boundary; flat vector equal to the JAX package's."""
    n, H, C1, C2, G = 15, 4, 8, 16, 3
    A, bv = _random_system(n, 2)
    es, avals, r = _plan(A, H, C1, C2)
    W8, Ws8, WN, WNS, WI8 = _widths(16, 24)
    vals = _member_values(avals, G, seed=7)
    # outgrow the first segment on member 2 only: its overflow flag alone
    vals[2] = [v << 100 for v in vals[2]]
    nf = es.factor.nchunks
    segs = ((0, nf // 2, 8), (nf // 2, nf, W8))
    vstack = _val_stack(es, vals, 8)
    rng = np.random.default_rng(3)
    bcols = [bv] + [[int(v) for v in rng.integers(-9, 10, n)]
                    for _ in range(G - 1)]
    b_stack = _b_lanes(es, r, n, bcols, 4)[:, None]     # [G, 1, n, 4]
    flat_ref = np.asarray(ref.fused_solve_many(
        n, es.nnz, W8, Ws8, WN, WNS, WI8, H, C1, C2, G, *_stream_arrays(es),
        jnp.asarray(vstack), jnp.asarray(b_stack), segments=segs))
    flat = ff.fused_solve_many(n, W8, Ws8, WN, WNS, WI8, G,
                               ff.stream_tensors(es, "cpu"),
                               torch.from_numpy(vstack),
                               torch.from_numpy(b_stack),
                               segments=segs).numpy()
    assert np.array_equal(flat_ref, flat)
    # segment 0: [sing*3, ovf*3]; only member 2 overflowed there
    assert flat[G:2 * G].tolist() == [0, 0, 1]


def test_segment_glue_takes_member_rows():
    """``widen_tc`` / ``widen_val`` and K4's ``relift_gt`` work row by row,
    so member-row tables ([(n+2)*G, .], [E8*G, .]) go through them as they
    are: the interleave of the per-member results."""
    n, H, C1, C2, G = 7, 2, 4, 8, 3
    A, _ = _random_system(n, 1)
    es, avals, _ = _plan(A, H, C1, C2)
    W8, _, WN, _, WI8 = _widths(4, 6)
    vals = _member_values(avals, G, seed=5)
    st = ff.stream_tensors(es, "cpu")
    stack = _val_stack(es, vals, W8)
    fam = ff.factor_stream(st, torch.from_numpy(_interleave(stack)), n, W8,
                           WN, WI8, G=G)
    solo = [ff.factor_stream(st, torch.from_numpy(stack[g]), n, W8, WN, WI8)
            for g in range(G)]
    for i in range(4):
        per = np.stack([s[i].numpy()[:(n + 2) if i else None]
                        for s in solo])
        assert np.array_equal(_interleave(per), fam[i].numpy())
    val, SMT, GT, TZ, _ = fam
    wide = rl.widen_tc(SMT, W8, 24)
    relifted = rl.relift_gt(wide, GT, TZ, 24, WI8, 32)
    for g in range(G):
        s = solo[g]
        Sg = rl.widen_tc(s[1][:n + 2], W8, 24)
        Gg = rl.relift_gt(Sg, s[2][:n + 2], s[3][:n + 2], 24, WI8, 32)
        assert torch.equal(relifted[g::G], Gg)
        assert torch.equal(wide[g::G], Sg)
        assert torch.equal(rl.widen_val(val, W8, 24)[g::G],
                           rl.widen_val(s[0], W8, 24))
