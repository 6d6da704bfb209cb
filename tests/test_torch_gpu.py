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


def test_singular_flag_under_pinned_pivots_raises_on_card(cuda,
                                                          monkeypatch):
    """A device half that flags sing under the oracle's pinned pivots is a
    fault: the solve raises instead of answering on the host."""
    import slip_lu_tpu_torch.gpu.backslash_fused as bf
    real = bf.fused_solve_all

    def faulty(*args):
        flat = real(*args).clone()
        flat[0], flat[1] = 1, 0
        return flat

    monkeypatch.setattr(bf, "fused_solve_all", faulty)
    A, b = _read("tri20")
    with pytest.raises(port.SlipPanicError, match="invariant"):
        port.backslash(A, b, port.Type.MPQ, port.Options(), device="cuda")
