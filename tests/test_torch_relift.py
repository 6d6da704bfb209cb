"""The port's segment-boundary glue (slip_lu_tpu_torch/gpu/relift.py) held
to the JAX package's ``slip_lu_tpu/tpu/relift.py``, bit for bit.

``relift_gt_ref`` (the plain version of kernel K4) runs against the JAX
``relift_gt`` (Pallas in interpret mode) on the same numpy-seeded tables:
true inverses, all-zero rows, the identity row 0, and seeds that are no
inverse at all (the garbage rows an overflow leaves behind), at one and
at two Newton steps, and the WIn <= WIo truncation. Equality is exact.
"""

import numpy as np
import pytest
import torch

from slip_lu_tpu.tpu import relift as ref
from slip_lu_tpu.tpu.factor_fused import ints_to_tc_rows
from slip_lu_tpu_torch.gpu import relift as rl


def _tables(seed, n8, W8, WIo):
    """SMT [n8, W8], GT_old [n8, WIo], TZ [n8, 8]: row 0 the identity,
    rows 1..n8/2 true rho / inverse pairs, then seeds that are no inverse,
    and the last rows all zero."""
    rng = np.random.default_rng(seed)
    SMT = np.zeros((n8, W8), np.int32)
    GT = np.zeros((n8, WIo), np.int32)
    TZ = np.zeros((n8, 8), np.int32)
    SMT[0, 0] = GT[0, 0] = 1
    mod = 1 << (16 * WIo)
    half = n8 // 2
    for r in range(1, half):
        v = int(rng.integers(1, 2**62)) * int(rng.integers(1, 2**40))
        v = (v | 1) << int(rng.integers(0, 12))
        v = -v if rng.random() < 0.5 else v
        tz = (v & -v).bit_length() - 1
        SMT[r] = ints_to_tc_rows([v], W8)[0]
        TZ[r] = tz
        GT[r] = ints_to_tc_rows([pow(v >> tz, -1, mod)], WIo)[0]
    for r in range(half, n8 - 3):
        SMT[r] = rng.integers(0, 1 << 16, W8)
        GT[r] = rng.integers(0, 1 << 16, WIo)
        TZ[r] = int(rng.integers(0, 16 * W8))
    return SMT, GT, TZ


@pytest.mark.parametrize("seed,n8,W8,WIo,WIn", [
    (0, 24, 8, 8, 16),      # one Newton step
    (1, 40, 16, 8, 24),     # two steps, SMT already at the new width
])
def test_relift_matches_jax(seed, n8, W8, WIo, WIn):
    SMT, GT, TZ = _tables(seed, n8, W8, WIo)
    want = np.asarray(ref.relift_gt(SMT, GT, TZ, W8, WIo, WIn))
    got = rl.relift_gt_ref(torch.from_numpy(SMT), torch.from_numpy(GT),
                           torch.from_numpy(TZ), W8, WIo, WIn)
    assert got.dtype == torch.int32 and got.shape == (n8, WIn)
    assert np.array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors, launching
    # nothing
    before = rl.relift_gt.launches
    wrapped = rl.relift_gt(torch.from_numpy(SMT), torch.from_numpy(GT),
                           torch.from_numpy(TZ), W8, WIo, WIn)
    assert torch.equal(wrapped, got) and rl.relift_gt.launches == before
    # true inverses stay true inverses at the wider modulus
    mod = 1 << (16 * WIn)
    for r in range(n8 // 2):
        v = int.from_bytes(SMT[r].astype(np.uint16).tobytes(), "little",
                           signed=False)
        v -= (1 << (16 * W8)) if SMT[r, -1] >= 0x8000 else 0
        odd = v >> int(TZ[r, 0])
        x = int.from_bytes(got[r].numpy().astype(np.uint16).tobytes(),
                           "little")
        assert (x * odd) % mod == 1, r
    assert not got[n8 - 3:].any()          # zero rows stay zero


@pytest.mark.parametrize("WIn", [8, 4])
def test_relift_truncates_when_not_wider(WIn):
    SMT, GT, TZ = _tables(2, 16, 8, 8)
    want = np.asarray(ref.relift_gt(SMT, GT, TZ, 8, 8, WIn))
    got = rl.relift_gt(torch.from_numpy(SMT), torch.from_numpy(GT),
                       torch.from_numpy(TZ), 8, 8, WIn)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), GT[:, :WIn])


def test_widen_tc_matches_jax():
    rng = np.random.default_rng(3)
    vals = [int(v) for v in rng.integers(-(10**18), 10**18, size=30)]
    vals += [0, 1, -1, 2**63 - 1, -(2**63)]
    rows = ints_to_tc_rows(vals, 5)
    for W_new in (5, 12):
        want = np.asarray(ref.widen_tc(rows, 5, W_new))
        got = rl.widen_tc(torch.from_numpy(rows), 5, W_new)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(rl.widen_val(torch.from_numpy(rows), 5,
                                           W_new).numpy(), want)


def test_relift_refuses_other_devices():
    t = torch.zeros((8, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rl.relift_gt(t, t, t, 8, 8, 16)


def test_newton_step_count_matches_reference():
    assert [rl.newton_steps(24, w) for w in (24, 32, 48, 120, 264)] == \
        [0, 1, 1, 3, 4]
