"""The port's dense device path (slip_lu_tpu_torch/gpu/factor.py, solve.py
and fused.py) held to the JAX package's ``tpu/factor.py``, ``tpu/solve.py``
and ``tpu/fused.py`` bit for bit, on the kernels' plain versions (CPU).

Every pivot scheme runs on a matrix whose columns hold candidates of
equal magnitude, so the tie-breaks (first index of argmin/argmax, the
tournament's smallest original row, its 2**30 padding) decide pivots;
the columns are permuted, so the DIAGONAL schemes look up the original
column. The packed factors, the pivot rows, the flags, the substitution
and the one flat result buffer must equal the JAX package's. Equality is
exact.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slip_lu_tpu.ops.limbs import matrix_to_limbs
from slip_lu_tpu.tpu import factor as ref_factor
from slip_lu_tpu.tpu import fused as ref_fused
from slip_lu_tpu.tpu import solve as ref_solve
from slip_lu_tpu.tpu.backslash_tpu import _tol_dyadic as ref_tol
from slip_lu_tpu_torch.gpu import factor as port_factor
from slip_lu_tpu_torch.gpu import fused as port_fused
from slip_lu_tpu_torch.gpu import solve as port_solve
from slip_lu_tpu_torch.gpu.backslash_cuda import _tol_dyadic
from slip_lu_tpu_torch.options import Pivot
from test_torch_host import release_jax  # noqa: F401 (autouse)

N, W, WS = 7, 3, 6


def _tied_system(seed=3):
    """A nonsingular 7 x 7 integer matrix over {0, +-1, +-2, +-3} (many
    equal magnitudes in every column), a column permutation and two
    right-hand sides."""
    rng = np.random.default_rng(seed)
    while True:
        A = rng.choice([0, 0, 1, -1, 1, -1, 2, -2, 3], size=(N, N))
        if abs(np.linalg.det(A.astype(float))) > 0.5:
            break
    q = rng.permutation(N).astype(np.int32)
    perm = np.array([[int(A[i, j]) for j in q] for i in range(N)],
                    dtype=object)
    S, M = matrix_to_limbs(perm, W)
    b = np.array([[int(rng.integers(-9, 10)) for _ in range(2)]
                  for _ in range(N)], dtype=object)
    VS, VM = matrix_to_limbs(b, WS)
    return S, M, q, VS, VM


def _tol(tol):
    mag, shift = _tol_dyadic(tol)
    rmag, rshift = ref_tol(tol)
    assert np.array_equal(mag, rmag) and shift == rshift
    return mag, shift


def _same(ref_out, port_out):
    for x, y in zip(ref_out, port_out):
        x = np.asarray(x)
        y = y.numpy()
        assert x.shape == y.shape and x.dtype == y.dtype
        assert np.array_equal(x, y)


def _t(a):
    return torch.from_numpy(np.array(a))


SCHEMES = [(p, 0.1) for p in Pivot] + [(Pivot.TOL_SMALLEST, 1.0),
                                        (Pivot.TOL_LARGEST, 1.0)]


@pytest.mark.parametrize("scheme,tol", SCHEMES,
                         ids=[f"{p.name}-{t}" for p, t in SCHEMES])
def test_factor_and_solve_match_jax(scheme, tol):
    S, M, q, VS, VM = _tied_system()
    mag, shift = _tol(tol)
    ref = ref_factor.factor_dense_limbs(
        jnp.asarray(S), jnp.asarray(M), jnp.asarray(q), int(scheme),
        jnp.asarray(mag), shift)
    got = port_factor.factor_dense_limbs(_t(S), _t(M), _t(q), int(scheme),
                                         _t(mag), shift)
    _same(ref, got)
    assert not bool(ref[3]) and not bool(ref[4])        # no flag raised
    if tol != 0.1:
        return
    # the substitution on the same (JAX) factors, RHS in pivot order
    FS, FM, rowidx = (np.asarray(x) for x in ref[:3])
    VSp, VMp = VS[rowidx], VM[rowidx]
    ref_x = ref_solve.solve_dense_limbs(jnp.asarray(FS), jnp.asarray(FM),
                                        jnp.asarray(VSp), jnp.asarray(VMp))
    got_x = port_solve.solve_dense_limbs(_t(FS), _t(FM), _t(VSp), _t(VMp))
    _same(ref_x, got_x)
    assert not bool(ref_x[2])
    # the whole dense program: one flat buffer
    ref_buf = ref_fused.factor_solve_dense(
        jnp.asarray(S), jnp.asarray(M), jnp.asarray(q), jnp.asarray(VS),
        jnp.asarray(VM), int(scheme), jnp.asarray(mag), shift)
    got_buf = port_fused.factor_solve_dense(_t(S), _t(M), _t(q), _t(VS),
                                            _t(VM), int(scheme), _t(mag),
                                            shift)
    _same([ref_buf], [got_buf])
    parts = port_fused.unpack_dense_result(got_buf.numpy(), N, 2, W, WS)
    ref_parts = ref_fused.unpack_dense_result(np.asarray(ref_buf), N, 2, W,
                                              WS)
    for x, y in zip(ref_parts, parts):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_pivots_break_ties_by_original_row():
    """Column 0 holds |1| in rows 1 and 3 and |3| in rows 0 and 2:
    SMALLEST takes row 1, LARGEST row 0, FIRST_NONZERO the smallest
    original row overall."""
    A = np.array([[3, 1, 0, 1], [-1, 2, 1, 0], [-3, 0, 2, 1],
                  [1, 1, 1, 2]])
    perm = np.array(A.tolist(), dtype=object)
    S, M = matrix_to_limbs(perm, 2)
    q = np.arange(4, dtype=np.int32)
    mag, shift = _tol(0.1)
    first = {}
    for scheme in (Pivot.SMALLEST, Pivot.LARGEST, Pivot.FIRST_NONZERO):
        out = port_factor.factor_dense_limbs(_t(S), _t(M), _t(q), int(scheme),
                                             _t(mag), shift)
        first[scheme] = int(out[2][0])
    assert first == {Pivot.SMALLEST: 1, Pivot.LARGEST: 0,
                     Pivot.FIRST_NONZERO: 0}


def test_singular_and_overflow_flags_match_jax():
    """A singular matrix raises the singular flag, and a width too narrow
    for the products raises the overflow flag, as in the JAX package; the
    values written past the fault are the JAX package's too."""
    mag, shift = _tol(0.1)
    sing = np.array([[1, 2, 3], [2, 4, 6], [1, 0, 1]], dtype=object)
    wide = np.array([[2**20 + 3, 5, 7], [11, 2**19 + 1, 13],
                     [17, 19, 2**18 + 5]], dtype=object)
    q = np.arange(3, dtype=np.int32)
    flags = []
    for A, Wx in ((sing, 2), (wide, 2)):
        S, M = matrix_to_limbs(A, Wx)
        ref = ref_factor.factor_dense_limbs(
            jnp.asarray(S), jnp.asarray(M), jnp.asarray(q), 0,
            jnp.asarray(mag), shift)
        got = port_factor.factor_dense_limbs(_t(S), _t(M), _t(q), 0, _t(mag),
                                             shift)
        _same(ref, got)
        flags.append((bool(got[3]), bool(got[4])))
    assert flags[0][0] and flags[1][1]


def test_tol_dyadic_matches_jax():
    for tol in (0.1, 0.5, 1.0, 1e-9, 0.3):
        mag, shift = _tol(tol)
        f = Fraction(tol)
        assert sum(int(v) << (16 * i) for i, v in enumerate(mag)) == \
            f.numerator and (1 << shift) == f.denominator
