"""Kernel K5's plain version (slip_lu_tpu_torch/ops/mul_shared.py) held to
the JAX package's ``mul_shared_digits_pallas`` (Pallas in interpret mode)
and to Python ints, bit for bit.

The JAX kernel takes 8-bit digits and the shared operand's Toeplitz
matrix; the port takes 16-bit limbs. Both are fed from the same
numpy-seeded values: B not a multiple of the TPU kernel's 256-row tile,
La = 257 digits (its cap), products that keep every digit and products
cut mod 2**(16*D). Past the TPU kernel's cap the port is held to Python
ints alone. Equality is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slip_lu_tpu.ops import matarith as ref_mt
from slip_lu_tpu.ops import pallas_kernels as pk
from slip_lu_tpu_torch.ops import matarith as mt
from slip_lu_tpu_torch.ops import mul_shared as ms
from test_torch_host import release_jax  # noqa: F401 (autouse)


@pytest.fixture
def force_pallas(monkeypatch):
    monkeypatch.setenv("SLIP_PALLAS", "1")
    assert pk.use_pallas()
    yield
    monkeypatch.setenv("SLIP_PALLAS", "0")


def _ints(limbs):
    return [sum(int(v) << (16 * i) for i, v in enumerate(row))
            for row in np.asarray(limbs).reshape(-1, np.shape(limbs)[-1])]


def _digits_to_limbs(d):
    """[B, L] 8-bit digits -> [B, ceil(L/2)] limbs (the same values)."""
    if d.shape[-1] % 2:
        d = np.pad(d, ((0, 0), (0, 1)))
    return (d[:, 0::2] + (d[:, 1::2] << 8)).astype(np.int32)


@pytest.mark.parametrize("seed,B,La,Ls,d_out", [
    (0, 300, 10, 10, 20),      # B not a multiple of 256; every digit kept
    (1, 37, 16, 16, 16),       # cut mod 2**(8*16)
    (2, 260, 257, 64, 160),    # La = 257 digits, the TPU kernel's cap
])
def test_plain_version_matches_pallas_kernel(seed, B, La, Ls, d_out):
    rng = np.random.default_rng(seed)
    da = rng.integers(0, 256, (B, La)).astype(np.int32)
    ds = rng.integers(0, 256, Ls).astype(np.int32)
    t = ref_mt._toeplitz(jnp.asarray(ds), La, d_out)
    want = np.asarray(pk.mul_shared_digits_pallas(jnp.asarray(da), t, d_out))
    a, s = _digits_to_limbs(da), _digits_to_limbs(ds[None])[0]
    got = ms.mul_shared_limbs_ref(torch.from_numpy(a), torch.from_numpy(s),
                                  d_out // 2)
    assert got.dtype == torch.int32 and got.shape == (B, d_out // 2)
    assert np.array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors, launching
    # nothing
    before = ms.mul_shared_limbs.launches
    wrapped = ms.mul_shared_limbs(torch.from_numpy(a), torch.from_numpy(s),
                                  d_out // 2)
    assert torch.equal(wrapped, got) and ms.mul_shared_limbs.launches == before


@pytest.mark.parametrize("Wa,Ws,out_w", [(7, 7, 15), (5, 3, 5), (3, 9, 12)])
def test_matarith_mul_shared_matches_jax_pallas_path(force_pallas, Wa, Ws,
                                                     out_w):
    """The port's mul_shared / mul_shared_mod (K5 on the CPU: its plain
    version) against the JAX package's with the Pallas kernel forced."""
    rng = np.random.default_rng(Wa * 10 + Ws)
    a = rng.integers(0, 1 << 16, (45, Wa)).astype(np.int32)
    s = rng.integers(0, 1 << 16, Ws).astype(np.int32)
    m_ref, o_ref = ref_mt.mul_shared(jnp.asarray(a), jnp.asarray(s), out_w)
    m, o = mt.mul_shared(torch.from_numpy(a), torch.from_numpy(s), out_w)
    assert np.array_equal(m.numpy(), np.asarray(m_ref))
    assert np.array_equal(o.numpy(), np.asarray(o_ref))
    mod_ref = ref_mt.mul_shared_mod(jnp.asarray(a), jnp.asarray(s), out_w)
    mod = mt.mul_shared_mod(torch.from_numpy(a), torch.from_numpy(s), out_w)
    assert np.array_equal(mod.numpy(), np.asarray(mod_ref))


@pytest.mark.parametrize("B,La,Ls,D", [
    (3, 200, 200, 400),        # 400 digits a side: past the 257-digit cap
    (5, 179, 179, 179),        # grid24's division: 358 digits, mod
    (4, 300, 2, 150),          # cut below the operand's own width
])
def test_plain_version_matches_python_ints_past_the_tpu_cap(B, La, Ls, D):
    rng = np.random.default_rng(La + Ls + D)
    a = rng.integers(0, 1 << 16, (B, La)).astype(np.int32)
    s = rng.integers(0, 1 << 16, Ls).astype(np.int32)
    got = ms.mul_shared_limbs(torch.from_numpy(a), torch.from_numpy(s), D)
    sv = _ints(s[None])[0]
    assert _ints(got.numpy()) == [(v * sv) % (1 << (16 * D))
                                  for v in _ints(a)]


def test_worst_case_ripple_carry():
    """All-ones limbs times 2**16 + 1 and times an all-ones operand: every
    carry ripples through the whole row."""
    ones = np.full((7, 40), 0xFFFF, np.int32)
    for s, D in ((np.array([1, 1], np.int32), 41),
                 (np.full(40, 0xFFFF, np.int32), 80),
                 (np.full(40, 0xFFFF, np.int32), 57)):
        got = ms.mul_shared_limbs(torch.from_numpy(ones), torch.from_numpy(s),
                                  D)
        want = (_ints(ones[:1])[0] * _ints(s[None])[0]) % (1 << (16 * D))
        assert _ints(got.numpy()) == [want] * 7


def test_batched_shared_operands_take_the_plain_version():
    """A batch of shared operands (one per row) goes to the plain version
    on any device, as the JAX package's grouped-convolution branch."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 1 << 16, (6, 4)).astype(np.int32)
    s = rng.integers(0, 1 << 16, (6, 3)).astype(np.int32)
    got = mt.mul_shared_mod(torch.from_numpy(a), torch.from_numpy(s), 5)
    assert _ints(got.numpy()) == [(x * y) % (1 << 80) for x, y in
                                  zip(_ints(a), _ints(s))]


def test_wrapper_refuses_other_devices():
    t = torch.zeros((4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ms.mul_shared_limbs(t, t[0], 8)
