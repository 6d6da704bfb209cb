"""The port's CUDA kernels on the card, held to their plain versions.

Needs a CUDA device and skips without one. This file imports neither jax
nor the JAX package, so it also runs where those are not installed:

    python -m pytest tests/test_torch_gpu.py -q --noconftest -o addopts=""

Equality is bit equality: every value is an exact integer, so the kernel
and its plain version must write the same limbs and raise the same
flags, also after an overflow (both compute the same residues).
"""

import os

import numpy as np
import pytest
import torch

import slip_lu_tpu_torch as port
from slip_lu_tpu_torch.convert import matrix_copy
from slip_lu_tpu_torch.gpu import factor_fused as ff
from slip_lu_tpu_torch.gpu.schedule import _permute_cols
from slip_lu_tpu_torch.gpu.schedule_native import build_schedule_best
from slip_lu_tpu_torch.gpu.schedule_stream import build_event_stream
from slip_lu_tpu_torch.matrix import Kind, Type

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATS = os.path.join(REPO, "data", "ExampleMats")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _read(name):
    return (port.read_triplet(os.path.join(MATS, f"{name}_mat.txt")),
            port.read_dense(os.path.join(MATS, f"{name}_v.txt")))


def _kernels_vs_plain(dev, name, W, Ws, H, shift=0):
    """K2 and K3 against their plain versions on the stream of ``name``
    (A's values times 2^shift) at widths (W, Ws); returns the kernels'
    factor and solve flags."""
    A, b = _read(name)
    A = matrix_copy(A, Kind.CSC, Type.MPZ)
    bz = matrix_copy(b, Kind.DENSE, Type.MPZ)
    n = A.n
    q = np.asarray(port.analyze(A, port.Options()).q, np.int64)
    sched, r = build_schedule_best(A, q, None)
    es = build_event_stream(sched, H, 32, 128)
    Aq = _permute_cols(A, q)
    avals = [int(Aq.x[i]) << shift for c in range(n)
             for i in range(int(Aq.p[c]), int(Aq.p[c + 1]))]
    W8, Ws8 = ff._r8(W), ff._r8(max(Ws, W + 1))
    WN, WNS, WI8 = ff._r8(2 * W8 + 2), ff._r8(W8 + Ws8 + 2), \
        ff._r8(max(W8, Ws8) + 2)
    st = ff.stream_tensors(es, dev)
    val = ff.val_tensor(avals, es.init_pos, es.nnz, W8, dev)
    before = ff.factor_stream.launches, ff.solve_stream.launches
    fk = ff.factor_stream(st, val, n, W8, WN, WI8)
    fp = ff.factor_stream_ref(st, val, n, W8, WN, WI8)
    for x, y in zip(fk, fp):
        assert torch.equal(x, y)
    bcol = [int(bz.x[int(r[k]), 0]) for k in range(n)]
    X0 = ff.x_tensor(torch.from_numpy(ff.ints_to_tc_rows(bcol, 4)).to(dev),
                     n, Ws8)
    Xk, sk = ff.solve_stream(st, *fk[:4], X0, W8, Ws8, WNS, WI8)
    Xp, sp = ff.solve_stream_ref(st, *fk[:4], X0, W8, Ws8, WNS, WI8)
    assert torch.equal(Xk, Xp) and torch.equal(sk, sp)
    assert (ff.factor_stream.launches, ff.solve_stream.launches) == \
        (before[0] + 1, before[1] + 1)
    return fk[4], sk


@pytest.mark.parametrize("name,W,Ws,H", [
    ("grid8", 16, 24, 2),      # settled widths: no flags
    ("grid8", 2, 3, 2),        # clamped: overflow flags, garbage values
    ("sparse30", 8, 16, 8),    # eight heads per chunk
    ("tri200", 40, 72, 2),     # wider limbs
])
def test_kernels_match_plain_versions(cuda, name, W, Ws, H):
    fflags, sflags = _kernels_vs_plain(cuda, name, W, Ws, H)
    if W >= 8:
        assert not fflags.any() and not sflags.any()
    else:
        assert fflags[1] == 1


@pytest.mark.parametrize("name,W,Ws,shift,settled", [
    # A * 2^350: the widths the ladder settles on (W8 = 224, Ws8 = 448);
    # the buffers span 456 and 680 limbs, so 9 and 6 warps
    ("dense10", 224, 448, 350, True),
    # A * 2^4000 at W8 = 256: the first products overflow
    ("grid8", 256, 264, 4000, False),
])
def test_kernels_match_plain_versions_wide(cuda, name, W, Ws, shift,
                                           settled):
    """The wide-limb regime: fewer than 16 warps per block, shared memory
    near the card's limit, long carry sweeps, 2-adically deep pivots."""
    assert ff._nwarps(ff._r8(2 * ff._r8(W) + 2)) < 16
    fflags, sflags = _kernels_vs_plain(cuda, name, W, Ws, 2, shift)
    if settled:
        assert not fflags.any() and not sflags.any()
    else:
        assert fflags[1] == 1


@pytest.mark.parametrize("name", ["tiny4", "arrow25", "grid8", "multirhs15",
                                  "wide_range"])
def test_backslash_on_card_matches_oracle(cuda, name):
    A, b = _read(name)
    x = port.backslash(A, b, port.Type.MPQ, port.Options(check=True),
                       device="cuda")
    st = port.last_stats()
    assert st.backend == "cuda-fused" and not st.fallback
    x_host = port.backslash(A, b, port.Type.MPQ, port.Options(),
                            backend="host")
    for i in range(x.m):
        for c in range(x.n):
            assert x.x[i, c] == x_host.x[i, c], (i, c)


def test_wide_backslash_on_card_matches_oracle(cuda):
    """dense10 with A times 2^350: the ladder climbs to W8 = 224 and
    Ws8 = 448 on the card and the answer is the oracle's."""
    A, b = _read("dense10")
    A = matrix_copy(A, Kind.CSC, Type.MPZ)
    for i in range(int(A.p[A.n])):
        A.x[i] = int(A.x[i]) << 350
    x = port.backslash(A, b, port.Type.MPQ, port.Options(check=True),
                       device="cuda")
    st = port.last_stats()
    assert st.backend == "cuda-fused" and not st.fallback
    assert st.W >= 224 and st.Ws >= 448
    x_host = port.backslash(A, b, port.Type.MPQ, port.Options(),
                            backend="host")
    for i in range(x.m):
        assert x.x[i, 0] == x_host.x[i, 0], i


def _relift_tables(seed, n8, W8, WIo):
    """SMT, GT_old, TZ of n8 rows: row 0 the identity, then true rho and
    inverse pairs, then seeds that are no inverse, the last rows zero."""
    rng = np.random.default_rng(seed)
    SMT = np.zeros((n8, W8), np.int32)
    GT = np.zeros((n8, WIo), np.int32)
    TZ = np.zeros((n8, 8), np.int32)
    SMT[0, 0] = GT[0, 0] = 1
    half = n8 // 2
    for r in range(1, half):
        v = int(rng.integers(1, 2**62)) ** (W8 // 8)
        v = (v | 1) << int(rng.integers(0, 40))
        v = -v if rng.random() < 0.5 else v
        tz = (v & -v).bit_length() - 1
        SMT[r] = ff.ints_to_tc_rows([v], W8)[0]
        TZ[r] = tz
        GT[r] = ff.ints_to_tc_rows([pow(v >> tz, -1, 1 << (16 * WIo))],
                                   WIo)[0]
    SMT[half:n8 - 3] = rng.integers(0, 1 << 16, (n8 - 3 - half, W8))
    GT[half:n8 - 3] = rng.integers(0, 1 << 16, (n8 - 3 - half, WIo))
    TZ[half:n8 - 3] = rng.integers(0, 16 * W8, (n8 - 3 - half, 1))
    return [torch.from_numpy(t) for t in (SMT, GT, TZ)]


@pytest.mark.parametrize("n8,W8,WIo,WIn", [
    (13024, 112, 24, 120),     # uni100k's factor boundary: three steps
    (1024, 256, 32, 264),      # the W8 = 256 regime: four steps
    (64, 16, 24, 24),          # not wider: truncates, launches nothing
])
def test_relift_kernel_matches_plain_version(cuda, n8, W8, WIo, WIn):
    from slip_lu_tpu_torch.gpu import relift as rl
    SMT, GT, TZ = [t.to(cuda) for t in _relift_tables(n8, n8, W8, WIo)]
    before = rl.relift_gt.launches
    got = rl.relift_gt(SMT, GT, TZ, W8, WIo, WIn)
    torch.cuda.synchronize()
    want = rl.relift_gt_ref(SMT, GT, TZ, W8, WIo, WIn)
    assert got.shape == (n8, WIn) and torch.equal(got, want)
    assert rl.relift_gt.launches == before + (WIn > WIo)


def test_segmented_device_half_matches_plain_versions(cuda):
    """fused_solve_all with three factor and two solve segments: K2 with
    incoming (widened, re-lifted) tables, K3 at the re-lifted GT width and
    K4 at each boundary give the plain versions' flat vector bit for bit."""
    from slip_lu_tpu_torch.gpu import relift as rl
    A, b = _read("tri200")
    A = matrix_copy(A, Kind.CSC, Type.MPZ)
    bz = matrix_copy(b, Kind.DENSE, Type.MPZ)
    n = A.n
    q = np.asarray(port.analyze(A, port.Options()).q, np.int64)
    sched, r = build_schedule_best(A, q, None)
    es = build_event_stream(sched, 2, 32, 128)
    Aq = _permute_cols(A, q)
    avals = [int(Aq.x[i]) for c in range(n)
             for i in range(int(Aq.p[c]), int(Aq.p[c + 1]))]
    W8, Ws8 = 40, 72
    WN, WNS, WI8 = ff._r8(2 * W8 + 2), ff._r8(W8 + Ws8 + 2), ff._r8(Ws8 + 2)
    nf, ns = es.factor.nchunks, es.solve.nchunks
    segs = ((0, nf // 3, 8), (nf // 3, 2 * nf // 3, 16), (2 * nf // 3, nf,
                                                           W8))
    ssegs = ((0, ns // 2, 40), (ns // 2, ns, Ws8))
    st = ff.stream_tensors(es, cuda)
    val = ff.val_tensor(avals, es.init_pos, es.nnz, 8, cuda)
    bcol = [int(bz.x[int(r[k]), 0]) for k in range(n)]
    b_rows = torch.from_numpy(ff.ints_to_tc_rows(bcol, 4)[None]).to(cuda)
    before = (ff.factor_stream.launches, ff.solve_stream.launches,
              rl.relift_gt.launches)
    got = ff.fused_solve_all(n, W8, Ws8, WN, WNS, WI8, st, val, b_rows,
                             segments=segs, ssegments=ssegs)
    torch.cuda.synchronize()
    # the same function on CPU copies runs the plain versions
    want = ff.fused_solve_all(n, W8, Ws8, WN, WNS, WI8,
                              ff.stream_tensors(es, "cpu"), val.cpu(),
                              b_rows.cpu(), segments=segs, ssegments=ssegs)
    assert torch.equal(got.cpu(), want)
    # two boundaries, then WI 24 -> the solve quotient's 80 limbs
    assert (ff.factor_stream.launches, ff.solve_stream.launches,
            rl.relift_gt.launches) == (before[0] + 3, before[1] + 2,
                                       before[2] + 3)


def test_factor_kernel_with_incoming_tables(cuda):
    """K2 on a later segment (tables handed in, never written) against its
    plain version on the same widened, re-lifted tables."""
    from slip_lu_tpu_torch.gpu import relift as rl
    A, _ = _read("tri200")
    A = matrix_copy(A, Kind.CSC, Type.MPZ)
    n = A.n
    q = np.asarray(port.analyze(A, port.Options()).q, np.int64)
    sched, _ = build_schedule_best(A, q, None)
    es = build_event_stream(sched, 2, 32, 128)
    Aq = _permute_cols(A, q)
    avals = [int(Aq.x[i]) for c in range(n)
             for i in range(int(Aq.p[c]), int(Aq.p[c + 1]))]
    st = ff.stream_tensors(es, cuda)
    mid = es.factor.nchunks // 2
    val = ff.val_tensor(avals, es.init_pos, es.nnz, 16, cuda)
    val, SMT, GT, TZ, _ = ff.factor_stream(ff.chunk_range(st, 0, mid, True),
                                           val, n, 16, 40, 24)
    W8 = 40
    val = rl.widen_val(val, 16, W8)
    SMT = rl.widen_tc(SMT, 16, W8)
    GT = rl.relift_gt(SMT, GT, TZ, W8, 24, 48)
    tables = (SMT, GT, TZ)
    seg = ff.chunk_range(st, mid, es.factor.nchunks, True)
    copies = [t.clone() for t in tables]
    got = ff.factor_stream(seg, val, n, W8, 88, 48, tables)
    want = ff.factor_stream_ref(seg, val, n, W8, 88, 48, tables)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert all(torch.equal(t, c) for t, c in zip(tables, copies))


def test_singular_flag_under_pinned_pivots_raises_on_card(cuda,
                                                          monkeypatch):
    """A device half that flags sing under the oracle's pinned pivots is a
    fault: the solve raises instead of answering on the host."""
    import slip_lu_tpu_torch.gpu.backslash_fused as bf
    real = bf.fused_solve_all

    def faulty(*args, **kw):
        flat = real(*args, **kw).clone()
        flat[0], flat[1] = 1, 0
        return flat

    monkeypatch.setattr(bf, "fused_solve_all", faulty)
    A, b = _read("tri20")
    with pytest.raises(port.SlipPanicError, match="invariant"):
        port.backslash(A, b, port.Type.MPQ, port.Options(), device="cuda")
