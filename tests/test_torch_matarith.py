"""The port's limb arithmetic (slip_lu_tpu_torch/ops/arith.py and
ops/matarith.py) held to the JAX package's (its XLA path) and to Python
ints, function by function, bit for bit.

Both packages get the same numpy-seeded limbs; every output (limbs,
signs, flags, carries) must match in value, shape and kind. Equality is
exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slip_lu_tpu.ops import arith as ref_ar
from slip_lu_tpu.ops import matarith as ref_mt
from slip_lu_tpu.ops.limbs import ints_to_limbs, limbs_to_ints
from slip_lu_tpu_torch.ops import arith as ar
from slip_lu_tpu_torch.ops import matarith as mt
from test_torch_host import release_jax  # noqa: F401 (autouse)

W = 6
RNG_SEED = 2024


def _vals(rng, n, bits, signed=True):
    out = []
    for _ in range(n):
        b = int(rng.integers(0, bits + 1))
        v = int.from_bytes(rng.bytes(32), "little") % (1 << max(b, 1))
        out.append(-v if signed and rng.random() < 0.5 else v)
    return out


def _mags(rng, n, bits, w=W):
    return ints_to_limbs([abs(v) for v in _vals(rng, n, bits, False)], w)[1]


def _signed(rng, n, bits, w=W):
    vals = _vals(rng, n, bits)
    vals[:3] = [0, 5, -5]
    s, m = ints_to_limbs(vals, w)
    return vals, s, m


def _as_list(x):
    return list(x) if isinstance(x, tuple) else [x]


def _same(fn_ref, fn_port, *args):
    """Run both on the same numpy inputs; every output equal."""
    r = fn_ref(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                 for a in args])
    p = fn_port(*[torch.from_numpy(a.copy()) if isinstance(a, np.ndarray)
                  else a for a in args])
    r, p = _as_list(r), _as_list(p)
    assert len(r) == len(p)
    for x, y in zip(r, p):
        x, y = np.asarray(x), y.numpy()
        assert x.shape == y.shape, (x.shape, y.shape)
        assert x.dtype == y.dtype, (x.dtype, y.dtype)
        assert np.array_equal(x, y)
    return p


def _hensel(d, w):
    """(odd(d)^-1 mod 2**(16*w) as limbs, trailing zero bits of d)."""
    tz = (d & -d).bit_length() - 1
    return (ints_to_limbs([pow(d >> tz, -1, 1 << (16 * w))], w)[1][0],
            np.int32(tz))


def _cases():
    rng = np.random.default_rng(RNG_SEED)
    a, b = _mags(rng, 24, 90), _mags(rng, 24, 90)
    b[:4] = a[:4]                                   # equal pairs
    _, sa, ma = _signed(rng, 24, 80)
    _, sb, mb = _signed(rng, 24, 80)
    mb[3] = ma[3]
    acc = rng.integers(0, 1 << 20, (9, 12)).astype(np.int32)
    dig = rng.integers(0, 256, (5, 8)).astype(np.int32)
    odd = (rng.integers(0, 1 << 15, 16) * 2 + 1).astype(np.int32)
    shifts = rng.integers(0, 16 * W, 24).astype(np.int32)
    d = ints_to_limbs([9876543210 << 5], 3)[1][0]
    nums = ints_to_limbs([v * (9876543210 << 5) for v in range(30, 54)],
                         W + 3)[1]
    dvec = ints_to_limbs([(3 ** k) << k for k in range(1, 25)], 4)[1]
    nvec = ints_to_limbs([((3 ** k) << k) * (7 ** k) for k in range(1, 25)],
                         9)[1]
    col, row = _mags(rng, 5, 60, 4), _mags(rng, 3, 60, 5)
    scol = np.array([1, -1, 0, 1, -1], np.int32)
    srow = np.array([-1, 1, 1], np.int32)
    # divisor precomputations from Python ints (inputs, not under test)
    inv, tz = _hensel(9876543210 << 5, W + 3)
    pre = [_hensel((3 ** k) << k, 9) for k in range(1, 25)]
    invs = np.stack([x for x, _ in pre])
    tzs = np.array([t for _, t in pre], np.int32)
    d_odd = [3 ** k for k in range(1, 25)]
    jeb = (ints_to_limbs(d_odd, 4)[1],
           np.array([pow(v & 0xFFFF, -1, 1 << 16) for v in d_odd], np.int32),
           tzs)
    return {
        # --- arith (the scan reference ops)
        "carry_normalize": (acc,),
        "_borrow_subtract": (np.maximum(a, b), np.minimum(a, b)),
        "_pad_to": (a, W + 3),
        "_pad_to_cut": (a, W - 2),
        "mag_add": (a, b, W + 1),
        "mag_add_cut": (a, b, W - 1),
        "mag_sub": (np.maximum(a, b), np.minimum(a, b)),
        "mag_cmp": (a, b),
        "mag_is_zero": (np.concatenate([a, np.zeros((2, W), np.int32)]),),
        "_to_digits": (a,),
        "_from_digits": (dig,),
        "mag_mul": (a[:, :3], b[:, :3], 2 * 3),
        "mag_mul_cut": (a, b, W),
        "_mulmod16": (odd, odd[::-1].copy()),
        "inv16": (odd,),
        "trailing_zero_bits": (np.concatenate([a[4:], dvec[:, :W // 2].repeat(
            2, 1)]),),
        "mag_shr_bits": (a, shifts),
        "mag_shr_bits_scalar": (a, np.int32(37)),
        "mag_shl_bits_static": (a, 37),
        "mag_shl_bits_static_limb": (a, 32),
        "_scalar_mul16": (odd, a[:16]),
        "div_precompute": (dvec,),
        "mag_divexact": (nvec,) + jeb + (6,),
        "signed_mul": (sa, ma, sb, mb, W),
        "signed_add": (sa, ma, sb, mb, W),
        "signed_sub": (sa, ma, sb, mb, W),
        "signed_divexact": (sa[:24], nvec, sb[:24]) + jeb + (6,),
        # --- matarith (the vectorized ops of the dense path)
        "normalize": (acc,),
        "normalize_unsigned": (acc,),
        "normalize_unsigned_8": (acc, 8),
        "mag_shr_bits_vec": (a, shifts),
        "mag_shr_bits_vec_scalar": (a, np.int32(37)),
        "trailing_zero_bits_vec": (dvec,),
        "truncate_mag": (a, W - 2),
        "truncate_mag_pad": (a, W + 2),
        "mag_cmp_vec": (a, b),
        "mag_add_vec": (a, b, W + 1),
        "mag_add_vec_cut": (a, b, W),
        "mag_sub_vec": (np.maximum(a, b), np.minimum(a, b)),
        "signed_add_vec": (sa, ma, sb, mb, W),
        "signed_sub_vec": (sa, ma, sb, mb, W),
        "_toeplitz": (dig[0], 5, 12),
        "mul_shared": (a, b[0], 2 * W),
        "mul_shared_mod": (a, b[0], W),
        "mul_outer": (col, row, 9),
        "mul_outer_cut": (col, row, 4),
        "signed_mul_shared": (sa, ma, np.int32(-1), mb[5], 2 * W),
        "signed_mul_outer": (scol, col, srow, row, 9),
        "_mod_sub_from_two": (a,),
        "hensel_inv": (ints_to_limbs([12345678901 | 1], 3)[1][0], 7),
        "div_precompute_hensel": (d, W + 3),
        "divexact_shared": (nums, inv, tz, W),
        "signed_divexact_shared": (sa, nums, np.int32(-1), inv, tz, W),
        "mul_pairwise": (a, b, W + 1),
        "mul_pairwise_mod": (a, b, W),
        "divexact_gathered": (nvec, invs, tzs, 6),
    }


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax(case):
    name = case
    for suffix in ("_cut", "_pad", "_scalar", "_limb", "_8"):
        name = name[:-len(suffix)] if name.endswith(suffix) else name
    mod_ref, mod_port = ((ref_ar, ar) if hasattr(ar, name)
                         and not hasattr(mt, name) else (ref_mt, mt))
    if name in ("_pad_to", "_to_digits", "_from_digits", "inv16"):
        mod_ref, mod_port = ref_ar, ar
    _same(getattr(mod_ref, name), getattr(mod_port, name), *CASES[case])


# ---------------------------------------------------------------------------
# against Python ints
# ---------------------------------------------------------------------------

def _ints(s, m):
    return list(limbs_to_ints(np.asarray(s), np.asarray(m)).reshape(-1))


def test_vectorized_ops_match_python_ints():
    rng = np.random.default_rng(5)
    xs, sa, ma = _signed(rng, 40, 90)
    ys, sb, mb = _signed(rng, 40, 90)
    t = torch.from_numpy
    s, m, o = mt.signed_add_vec(t(sa), t(ma), t(sb), t(mb), W + 1)
    assert _ints(s, m) == [x + y for x, y in zip(xs, ys)] and not o.any()
    s, m, o = mt.signed_sub_vec(t(sa), t(ma), t(sb), t(mb), W + 1)
    assert _ints(s, m) == [x - y for x, y in zip(xs, ys)] and not o.any()
    c = mt.mag_cmp_vec(t(ma), t(mb)).tolist()
    assert c == [(abs(x) > abs(y)) - (abs(x) < abs(y)) for x, y in
                 zip(xs, ys)]
    s, m, o = mt.signed_mul_outer(t(sa[:4]), t(ma[:4]), t(sb[:3]),
                                  t(mb[:3]), 2 * W)
    assert _ints(s, m) == [x * y for x in xs[:4] for y in ys[:3]]
    s, m, o = mt.signed_mul_shared(t(sa), t(ma), torch.tensor(sb[7]),
                                   t(mb[7]), 2 * W)
    assert _ints(s, m) == [x * ys[7] for x in xs]
    m, o = mt.mul_pairwise(t(ma), t(mb), 2 * W)
    assert _ints(np.ones(40, np.int32), m) == [abs(x * y) for x, y in
                                              zip(xs, ys)]


def test_divexact_shared_matches_python_ints():
    d = 0xDEADBEEF << 9
    qs = [v for v in range(1, 33)] + [2**70 + 3, 2**80 - 1]
    _, mn = ints_to_limbs([q * d for q in qs], W + 2)
    _, md = ints_to_limbs([d], 3)
    inv, tz = mt.div_precompute_hensel(torch.from_numpy(md[0]), W + 2)
    q, bad = mt.divexact_shared(torch.from_numpy(mn), inv, tz, W)
    assert _ints(np.ones(len(qs), np.int32), q) == qs and not bad.any()
    x = int.from_bytes(inv.numpy().astype(np.uint16).tobytes(), "little")
    assert (x * (d >> 9)) % (1 << (16 * (W + 2))) == 1


def test_worst_case_ripple_carry():
    """(2**(16*6) - 1) * (2**16 + 1): normalization ripples a carry across
    the whole row (the JAX package's tests/test_pallas.py case)."""
    v = (1 << (16 * 6)) - 1
    _, ma = ints_to_limbs([v] * 16, 8)
    _, ms_ = ints_to_limbs([(1 << 16) + 1], 2)
    m, o = mt.mul_shared(torch.from_numpy(ma), torch.from_numpy(ms_[0]), 10)
    assert _ints(np.ones(16, np.int32), m) == [v * ((1 << 16) + 1)] * 16
    assert not o.any()
    m_ref, _ = ref_mt.mul_shared(jnp.asarray(ma), jnp.asarray(ms_[0]), 10)
    assert np.array_equal(m.numpy(), np.asarray(m_ref))


def test_scan_reference_ops_match_python_ints():
    rng = np.random.default_rng(8)
    a = [abs(v) for v in _vals(rng, 20, 45, False)]
    b = [abs(v) for v in _vals(rng, 20, 45, False)]
    t = torch.from_numpy
    _, ma = ints_to_limbs(a, W)
    _, mb = ints_to_limbs(b, W)
    p, o = ar.mag_mul(t(ma), t(mb), 2 * W)
    assert _ints(np.ones(20, np.int32), p) == [x * y for x, y in zip(a, b)]
    s, o = ar.mag_add(t(ma), t(mb), W + 1)
    assert _ints(np.ones(20, np.int32), s) == [x + y for x, y in zip(a, b)]
    d = 123456789 << 3
    _, mn = ints_to_limbs([x * d for x in a], W + 3)
    _, md = ints_to_limbs([d], W)
    d_odd, inv0, tz = ar.div_precompute(t(md[0]))
    q, bad = ar.mag_divexact(t(mn), d_odd, inv0, tz, W)
    assert _ints(np.ones(20, np.int32), q) == a and not bad.any()
    vals = [1, 2, 12, 2**16, 2**40, 3 << 33, 2**90, 6]
    _, m = ints_to_limbs(vals, W)
    want = [(v & -v).bit_length() - 1 for v in vals]
    assert ar.trailing_zero_bits(t(m)).tolist() == want
    assert mt.trailing_zero_bits_vec(t(m)).tolist() == want
