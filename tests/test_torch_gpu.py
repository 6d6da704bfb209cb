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


def _limb_ints(rows):
    return [sum(int(v) << (16 * i) for i, v in enumerate(r)) for r in rows]


@pytest.mark.parametrize("B,La,Ls,D,fill", [
    (65536, 40, 40, 80, None),     # grid16's rho x M: every limb kept
    (65536, 81, 81, 81, None),     # grid16's division, mod 2^(16*81)
    (1, 81, 81, 81, None),         # a Hensel doubling step
    (4096, 81, 2, 81, 0xFFFF),     # ripple: all-ones rows times 2^16 + 1
    (300, 179, 179, 179, None),    # grid24's division: 358 digits
    (7, 600, 300, 900, None),      # past 8 warps' shared memory budget
])
def test_mul_shared_kernel_matches_plain_version(cuda, B, La, Ls, D, fill):
    from slip_lu_tpu_torch.ops import mul_shared as ms
    rng = np.random.default_rng(B + La + Ls + D)
    if fill is None:
        a = rng.integers(0, 1 << 16, (B, La)).astype(np.int32)
        s = rng.integers(0, 1 << 16, Ls).astype(np.int32)
    else:
        a = np.full((B, La), fill, np.int32)
        s = np.ones(Ls, np.int32)
    a_d, s_d = torch.from_numpy(a).to(cuda), torch.from_numpy(s).to(cuda)
    before = ms.mul_shared_limbs.launches
    got = ms.mul_shared_limbs(a_d, s_d, D)
    torch.cuda.synchronize()
    want = ms.mul_shared_limbs_ref(a_d, s_d, D)
    assert got.shape == (B, D) and torch.equal(got, want)
    assert ms.mul_shared_limbs.launches == before + 1
    sv, mod = _limb_ints([s])[0], 1 << (16 * D)
    rows = list(range(min(B, 3))) + [B - 1]
    assert _limb_ints(got[rows].cpu().numpy()) == [
        (v * sv) % mod for v in _limb_ints(a[rows])]


def test_dense_program_matches_plain_versions(cuda):
    """factor_solve_dense on the card (K5 and the plain tensor code around
    it) against the same call on CPU copies, for every pivot scheme: the
    flat buffers are bit-equal."""
    from slip_lu_tpu_torch.gpu.backslash_cuda import (_pack_factor_inputs,
                                                      _tol_dyadic)
    from slip_lu_tpu_torch.gpu.bounds import factor_width, solve_width
    from slip_lu_tpu_torch.gpu.fused import factor_solve_dense
    from slip_lu_tpu_torch.ops import mul_shared as ms
    from slip_lu_tpu_torch.ops.limbs import matrix_to_limbs
    A, b = _read("tri20")
    A = matrix_copy(A, Kind.CSC, Type.MPZ)
    bz = matrix_copy(b, Kind.DENSE, Type.MPZ)
    q = np.asarray(port.analyze(A, port.Options()).q, np.int64)
    W = factor_width(A)
    Ws = solve_width(A, bz.x, W, A.n)
    mag, shift = _tol_dyadic(0.1)
    for scheme in port.Pivot:
        bufs = []
        for dev in (cuda, torch.device("cpu")):
            S, M = _pack_factor_inputs(A, q, W, dev)
            VS, VM = (torch.from_numpy(t).to(dev)
                      for t in matrix_to_limbs(bz.x, Ws))
            before = ms.mul_shared_limbs.launches
            bufs.append(factor_solve_dense(
                S, M, torch.from_numpy(q.astype(np.int32)).to(dev), VS, VM,
                int(scheme), torch.from_numpy(mag).to(dev), shift).cpu())
            launched = ms.mul_shared_limbs.launches - before
            assert (launched > 0) == (dev.type == "cuda")
        assert torch.equal(bufs[0], bufs[1]), scheme
        assert not bufs[0][:3].any()


@pytest.mark.parametrize("name", ["grid16", "tri20", "multirhs15"])
def test_dense_backslash_on_card_matches_oracle(cuda, name):
    from slip_lu_tpu_torch.ops import mul_shared as ms
    A, b = _read(name)
    before = ms.mul_shared_limbs.launches
    x = port.backslash(A, b, port.Type.MPQ, port.Options(check=True),
                       backend="cuda", device="cuda")
    st = port.last_stats()
    assert st.backend == "cuda" and ms.mul_shared_limbs.launches > before
    x_host = port.backslash(A, b, port.Type.MPQ, port.Options(),
                            backend="host")
    for i in range(x.m):
        for c in range(x.n):
            assert x.x[i, c] == x_host.x[i, c], (i, c)


def _shard_states(name, p, W8, Ws8, WI, dev):
    """A p-rank plan of ``name`` with every rank's streams and tables on
    dev (the widths must hold its values: no flag is expected)."""
    from slip_lu_tpu_torch.parallel import driver_fused as df
    from slip_lu_tpu_torch.parallel import factor_fused_shard as ffs
    A, b = _read(name)
    A = matrix_copy(A, Kind.CSC, Type.MPZ)
    bz = matrix_copy(b, Kind.DENSE, Type.MPZ)
    n = A.n
    opts = port.Options()
    _, r, ses, avals, _ = df.plan_sharded(A, port.analyze(A, opts), p, opts)
    arrays = df.stream_arrays(ses, n)
    rows = ff.ints_to_tc_rows(avals, W8)
    n8 = ff._r8((n if ses.ndet is None else ses.ndet) + 2)
    X = np.zeros((ff._r8(n + 1 + ses.nxx), Ws8), np.int32)
    X[:n] = ff.ints_to_tc_rows([int(bz.x[int(r[k]), 0]) for k in range(n)],
                               Ws8)
    chs, states = [], []
    for k in range(p):
        v = np.zeros((ff._r8(ses.Lp), W8), np.int32)
        mine = ses.init_chip == k
        v[ses.init_loc[mine]] = rows[mine]
        if ses.extra_chip is not None and len(ses.extra_chip):
            em = ses.extra_chip == k
            v[ses.extra_loc[em]] = ff.ints_to_tc_rows(ses.extra_vals, W8)[em]
        tabs = [np.zeros((n8, w), np.int32) for w in (W8, WI, 8)]
        tabs[0][0, 0] = tabs[1][0, 0] = 1
        rs = ffs.rank_streams(k, dev, *arrays)
        chs.append((rs.factor, rs.solve))
        states.append({key: torch.from_numpy(t).to(dev) for key, t in zip(
            ("val", "SMT", "GT", "TZ", "X", "flags", "sflags"),
            (v, *tabs, X, np.zeros(8, np.int32), np.zeros(8, np.int32)))})
    return chs, states


@pytest.mark.parametrize("name,p,W8,Ws8", [
    ("tri200", 1, 40, 72),
    ("tri200", 2, 40, 72),      # both ranks of a p = 2 plan, sums by hand
    ("sparse30", 3, 16, 24),
])
def test_shard_kernels_match_plain_versions(cuda, name, p, W8, Ws8):
    """K6 and K7 over a whole p-rank factor stream and one solve stream,
    every rank in this process (the diagonal and B sums by hand), against
    their plain versions on the same card: bit-equal tables and flags."""
    from slip_lu_tpu_torch.parallel import factor_fused_shard as ffs
    WI = ff._r8(max(W8, Ws8) + 2)
    chs, kst = _shard_states(name, p, W8, Ws8, WI, cuda)
    _, pst = _shard_states(name, p, W8, Ws8, WI, cuda)
    before = ffs.ab_chunk.launches, ffs.c_chunk.launches
    nf, ns = chs[0][0].nchunks, chs[0][1].nchunks
    for part, nc, solve in ((0, nf, False), (1, ns, True)):
        cs = [c[part] for c in chs]
        for c in range(nc):
            for sts, plain in ((kst, False), (pst, True)):
                bcs = ffs.local_ab(cs, c, sts, solve, plain)
                ffs.local_c(cs, c, sts, sum(bcs), solve, plain)
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(kst, pst)):
        for key in a:
            assert torch.equal(a[key], b[key]), (k, key)
        assert not a["flags"].any() and not a["sflags"].any()
    assert (ffs.ab_chunk.launches, ffs.c_chunk.launches) == (
        before[0] + p * (nf + ns), before[1] + p * (nf + ns))


def _cancel4():
    """In natural order this system's 2x2 leading minor cancels."""
    A = port.SlipMatrix.from_dense(np.array(
        [[2, 1, 0, 3], [4, 2, 1, 0], [0, 1, 5, 1], [3, 0, 1, 4]],
        dtype=object), port.Type.MPZ)
    b = port.SlipMatrix.from_dense(np.array([[1], [2], [3], [4]],
                                            dtype=object), port.Type.MPZ)
    return A, b


@pytest.mark.parametrize("name", ["tri200", "sparse30", "multirhs15",
                                  "cancel4"])
def test_sharded_solve_on_card_matches_oracle(cuda, tmp_path, name):
    """factorize_solve_cuda_fused_sharded at world size 1 in a one-rank
    NCCL group: exact, through K6 and K7; the cancelling system takes the
    single-chip fallback and reports it."""
    import torch.distributed as dist
    from slip_lu_tpu_torch.parallel import factor_fused_shard as ffs
    from slip_lu_tpu_torch.parallel import (
        factorize_solve_cuda_fused_sharded)
    A, b = _cancel4() if name == "cancel4" else _read(name)
    A = matrix_copy(A, Kind.CSC, Type.MPZ)
    opts = port.Options(order=port.Ordering.NONE) if name == "cancel4" \
        else port.Options()
    x_host = port.backslash(A, b, port.Type.MPQ, opts, backend="host")
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        before = ffs.ab_chunk.launches, ffs.c_chunk.launches
        x = factorize_solve_cuda_fused_sharded(A, port.analyze(A, opts), b,
                                               options=opts, device="cuda")
        st = port.last_stats()
    finally:
        dist.destroy_process_group()
    assert st.backend == "cuda-fused-sharded"
    assert st.fallback == (name == "cancel4")
    assert ffs.ab_chunk.launches > before[0]
    assert ffs.c_chunk.launches > before[1]
    for i in range(x.m):
        for c in range(x.n):
            assert x.x[i, c] == x_host.x[i, c], (i, c)
