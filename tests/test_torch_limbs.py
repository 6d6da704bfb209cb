"""The port's plain limb library (slip_lu_tpu_torch/ops/device_limbs.py)
against the JAX package's in-kernel helpers (ops/pallas_limbs.py, run
eagerly outside a kernel) and against Python-int arithmetic.

Inputs are int32 limbs made with numpy from a seed; every comparison is
bit equality (all values are exact integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slip_lu_tpu.ops import pallas_limbs as pk
from slip_lu_tpu_torch.ops import device_limbs as dl

M16 = 0xFFFF
SEEDS = [0, 1]


def _limbs(rng, D, B):
    return rng.integers(0, M16 + 1, size=(D, B)).astype(np.int32)


def _signed_cols(rng, D, B):
    """Limbs whose columns are small signed values (so fits_in, sign fill
    and shifts see both signs and both outcomes)."""
    x = _limbs(rng, D, B)
    for c in range(B):
        keep = int(rng.integers(1, D + 1))
        fill = M16 if rng.random() < 0.5 else 0
        x[keep:, c] = fill
    return x


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def _j(a):
    return np.asarray(a).astype(np.int64)


def _ints(x):
    """[D, B] limbs -> list of B unsigned Python ints."""
    D, B = x.shape
    return [sum(int(x[k, c]) << (16 * k) for k in range(D))
            for c in range(B)]


def _signed(u, D):
    return u - (1 << (16 * D)) if u >> (16 * D - 1) else u


def _to_limbs(vals, D):
    mod = 1 << (16 * D)
    return np.array([[(v % mod) >> (16 * k) & M16 for v in vals]
                     for k in range(D)], np.int64)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("max_val", [2 * M16 + 1, 4 * M16, 40 * M16 * 256])
def test_carry_normalize(seed, max_val):
    rng = np.random.default_rng(seed)
    acc = rng.integers(0, max_val + 1, size=(24, 16)).astype(np.int32)
    acc[:, 0] = M16                        # a full ripple chain
    acc[0, 0] = M16 + 1
    ref = pk.carry_normalize(jnp.asarray(acc), max_val)
    assert np.array_equal(_j(ref), dl.carry_normalize(_t(acc), max_val))


@pytest.mark.parametrize("seed", SEEDS)
def test_sub_and_two_minus(seed):
    rng = np.random.default_rng(seed)
    x, y = _limbs(rng, 16, 32), _limbs(rng, 16, 32)
    assert np.array_equal(_j(pk.sub_mod(jnp.asarray(x), jnp.asarray(y))),
                          dl.sub_mod(_t(x), _t(y)))
    assert np.array_equal(_j(pk.two_minus_mod(jnp.asarray(x))),
                          dl.two_minus_mod(_t(x)))


@pytest.mark.parametrize("seed", SEEDS)
def test_sign_extend_fits_in_is_zero(seed):
    rng = np.random.default_rng(seed)
    x = _signed_cols(rng, 16, 32)
    x[:, 3] = 0
    jx, tx = jnp.asarray(x), _t(x)
    for W in (1, 5, 16):
        assert np.array_equal(_j(pk.fits_in(jx, W)), dl.fits_in(tx, W))
    assert np.array_equal(_j(pk.sign_extend(jx, 24)), dl.sign_extend(tx, 24))
    assert np.array_equal(_j(pk.is_zero(jx)), dl.is_zero(tx))


@pytest.mark.parametrize("seed", SEEDS)
def test_trailing_zero_bits(seed):
    rng = np.random.default_rng(seed)
    x = _limbs(rng, 12, 32)
    for c in range(32):
        z = int(rng.integers(0, 12))
        x[:z, c] = 0
        x[z, c] = (1 << int(rng.integers(0, 16))) * \
            int(rng.integers(1, 3)) & M16 or 1
    x[:, 5] = 0                            # all zero: 16*D + 16
    assert np.array_equal(_j(pk.trailing_zero_bits(jnp.asarray(x))),
                          dl.trailing_zero_bits(_t(x)))


@pytest.mark.parametrize("seed", SEEDS)
def test_shr_bits(seed):
    rng = np.random.default_rng(seed)
    D = 24
    x = _signed_cols(rng, D, 32)
    tz = rng.integers(0, 16 * (D // 2), size=(1, 32)).astype(np.int32)
    ref = pk.shr_bits(jnp.asarray(x), jnp.asarray(tz), D // 2)
    assert np.array_equal(_j(ref), dl.shr_bits(_t(x), _t(tz)))


@pytest.mark.parametrize("seed", SEEDS)
def test_inv16(seed):
    rng = np.random.default_rng(seed)
    d = (rng.integers(0, 1 << 15, size=(1, 64)) * 2 + 1).astype(np.int32)
    ref = _j(pk.inv16(jnp.asarray(d)))
    got = dl.inv16(_t(d))
    assert np.array_equal(ref, got)
    assert ((got * _t(d)) & M16 == 1).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("Wa,Wb,D", [(8, 8, 24), (24, 16, 24), (5, 9, 40)])
def test_mul_mod_against_ints(seed, Wa, Wb, D):
    rng = np.random.default_rng(seed)
    a, b = _limbs(rng, Wa, 16), _limbs(rng, Wb, 16)
    mod = 1 << (16 * D)
    want = [x * y % mod for x, y in zip(_ints(a), _ints(b))]
    assert np.array_equal(dl.mul_mod(_t(a), _t(b), D), _to_limbs(want, D))
    sa = [_signed(u, Wa) for u in _ints(a)]
    sb = [_signed(u, Wb) for u in _ints(b)]
    want_s = [x * y % mod for x, y in zip(sa, sb)]
    assert np.array_equal(dl.signed_mul_mod(_t(a), _t(b), D),
                          _to_limbs(want_s, D))


@pytest.mark.parametrize("seed", SEEDS)
def test_signed_mul_sub_mod_against_ints(seed):
    rng = np.random.default_rng(seed)
    W, Ws, D = 16, 24, 48
    t, m = _signed_cols(rng, Ws, 16), _signed_cols(rng, W, 16)
    a, b = _signed_cols(rng, W, 16), _signed_cols(rng, Ws, 16)
    sv = [[_signed(u, x.shape[0]) for u in _ints(x)] for x in (t, m, a, b)]
    want = [(tt * mm - aa * bb) % (1 << (16 * D))
            for tt, mm, aa, bb in zip(*sv)]
    got = dl.signed_mul_sub_mod(_t(t), _t(m), _t(a), _t(b), D)
    assert np.array_equal(got, _to_limbs(want, D))


@pytest.mark.parametrize("seed", SEEDS)
def test_inverse_mod_against_ints(seed):
    rng = np.random.default_rng(seed)
    D = 24
    d = _limbs(rng, D, 16)
    d[0] |= 1
    mod = 1 << (16 * D)
    want = [pow(v, -1, mod) for v in _ints(d)]
    assert np.array_equal(dl.inverse_mod(_t(d), D), _to_limbs(want, D))
