"""The port's dense exact solve end to end (``backend="cuda"``) on the
kernels' plain versions (``device="cpu"``), held to the JAX package's
``backend="tpu"`` and to its host oracle; ``factor_cuda`` held to the
host ``factorize``; the width ladder under a clamp; the fused solve's
last resort, which now reaches the dense path.

Equality is exact: the solutions are rationals, the factors integers.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import slip_lu_tpu as ref
import slip_lu_tpu_torch as port
from slip_lu_tpu_torch.gpu.backslash_cuda import factor_cuda

from conftest import random_sparse_int
from test_torch_host import release_jax  # noqa: F401 (autouse)


def _rows(n, seed, lo=-9, hi=9, density=0.5):
    rng = np.random.default_rng(seed)
    M = random_sparse_int(n, density=density, lo=lo, hi=hi, rng=rng)
    return [[int(M.x[i, j]) for j in range(n)] for i in range(n)]


def _system(pkg, rows, bcols, mpq=False):
    t = pkg.Type.MPQ if mpq else pkg.Type.MPZ
    Ad = np.array(rows, dtype=object) if len(rows) else \
        np.zeros((0, 0), dtype=object)
    return (pkg.SlipMatrix.from_dense(Ad, t),
            pkg.SlipMatrix.from_dense(np.array(bcols, dtype=object), t))


def _assert_same(x, y):
    assert (x.m, x.n) == (y.m, y.n)
    for i in range(x.m):
        for c in range(x.n):
            assert x.x[i, c] == y.x[i, c], (i, c)


def _both(rows, bcols, mpq=False, **opts):
    """The port's backend="cuda" on the CPU, the JAX backend="tpu" and the
    host oracle on the same system: all three equal."""
    A, b = _system(port, rows, bcols, mpq)
    x = port.backslash(A, b, port.Type.MPQ, port.Options(check=True, **opts),
                       backend="cuda", device="cpu")
    st = port.last_stats()
    Ar, br = _system(ref, rows, bcols, mpq)
    _assert_same(x, ref.backslash(Ar, br, ref.Type.MPQ,
                                  ref.Options(**opts), backend="tpu"))
    _assert_same(x, ref.backslash(Ar, br, ref.Type.MPQ, ref.Options(**opts)))
    return x, st


def test_empty_system():
    x, _ = _both([], np.zeros((0, 1), dtype=object))
    assert (x.m, x.n) == (0, 1)


def test_one_by_one():
    x, st = _both([[7]], [[3]])
    assert x.x[0, 0] == Fraction(3, 7) and st.backend == "cuda"


def test_negative_diagonal():
    rows = [[-5, 1, 0, 2], [0, -3, 1, 0], [1, 0, -7, 1], [2, 1, 0, -4]]
    _both(rows, [[1], [-2], [3], [4]])


def test_rational_input():
    rows = [[Fraction(1, 2), Fraction(1, 3)], [Fraction(1, 5), Fraction(2)]]
    _both(rows, [[Fraction(7, 11)], [Fraction(1)]], mpq=True)


def test_several_right_hand_sides():
    rows = _rows(5, 11, density=0.6)
    rng = np.random.default_rng(12)
    _both(rows, [[int(rng.integers(-5, 6)) for _ in range(3)]
                 for _ in range(5)])


def test_large_entries_bit_growth():
    """Entries ~2**40: multi-limb arithmetic in every op, W of 9 limbs."""
    rng = np.random.default_rng(13)
    rows = [[(int(rng.integers(-2**40, 2**40)) or 1)
             if (rng.random() < 0.7 or r == c) else 0 for c in range(5)]
            for r in range(5)]
    _, st = _both(rows, [[2**30]] * 5)
    assert st.W > 4


def test_singular_raises_in_both_packages():
    with pytest.raises(port.SlipSingularError):
        port.backslash(*_system(port, [[1, 2], [2, 4]], [[1], [1]]),
                       backend="cuda", device="cpu")
    with pytest.raises(ref.SlipSingularError):
        ref.backslash(*_system(ref, [[1, 2], [2, 4]], [[1], [1]]),
                      backend="tpu")


def test_clamped_widths_reach_the_same_outcome():
    """max_limbs=2 starts below the bound: the ladder widens to the exact
    answer, or both packages refuse with SlipLimbOverflowError."""
    rows = _rows(6, 42, lo=-999, hi=999, density=0.8)
    bcols = [[1]] * 6
    outcome = []
    for pkg, kw in ((port, dict(backend="cuda", device="cpu")),
                    (ref, dict(backend="tpu"))):
        try:
            outcome.append(pkg.backslash(*_system(pkg, rows, bcols),
                                         pkg.Type.MPQ,
                                         pkg.Options(max_limbs=2), **kw))
        except pkg.SlipLimbOverflowError:
            outcome.append(None)
    if outcome[0] is None:
        assert outcome[1] is None
        return
    st = port.last_stats()
    assert st.retries >= 1
    _assert_same(outcome[0], outcome[1])
    _assert_same(outcome[0], ref.backslash(*_system(ref, rows, bcols),
                                           ref.Type.MPQ))


@pytest.mark.parametrize("pivot", list(port.Pivot))
def test_factor_cuda_matches_host_factorize(pivot):
    rows = _rows(7, 40 + int(pivot), density=0.5)
    A, _ = _system(port, rows, [[0]] * 7)
    A2 = port.matrix_copy(A, port.Kind.CSC, port.Type.MPZ)
    opt = port.Options(pivot=pivot, order=port.Ordering.COLAMD)
    an = port.analyze(A2, opt)
    from slip_lu_tpu_torch.factorize import factorize
    F_host = factorize(A2, an, opt)
    F_dev = factor_cuda(A2, an, opt, device="cpu")
    assert F_host.rhos == F_dev.rhos
    assert list(F_host.pinv) == list(F_dev.pinv)
    assert list(F_host.row_perm) == list(F_dev.row_perm)
    assert [dict(c) for c in F_host.Lcols] == [dict(c) for c in F_dev.Lcols]
    assert [dict(c) for c in F_host.Ucols] == [dict(c) for c in F_dev.Ucols]


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    A, b = _system(port, [[2, 1], [1, 3]], [[1], [2]])
    with pytest.raises(RuntimeError, match="CUDA"):
        port.backslash(A, b, port.Type.MPQ, port.Options(), backend="cuda")
    A2 = port.matrix_copy(A, port.Kind.CSC, port.Type.MPZ)
    with pytest.raises(RuntimeError, match="CUDA"):
        factor_cuda(A2, port.analyze(A2, port.Options()))


# ---------------------------------------------------------------------------
# the fused solve's last resort (both plans singular-flagged)
# ---------------------------------------------------------------------------

def _always_singular(n, W8, Ws8, WN, WNS, WI8, st, val_in, b_rows, **kw):
    """A fused device half that flags a singular pivot on every call (one
    segment on each stream, as tri20 plans)."""
    flat = torch.zeros(2 + W8 + b_rows.shape[0] * (2 + n * Ws8),
                       dtype=torch.int32)
    flat[0] = 1
    return flat


def _tri20(pkg):
    import os
    mats = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "ExampleMats")
    return (pkg.read_triplet(os.path.join(mats, "tri20_mat.txt")),
            pkg.read_dense(os.path.join(mats, "tri20_v.txt")))


def test_fused_last_resort_is_dense_path_on_cpu(monkeypatch):
    """Both plans flag sing: on the CPU, n <= DENSE_NMAX (tri20, n = 20)
    goes to the dense path, as in the reference, and last_stats() reports
    the fused call's fallback. (Above the cap the host oracle answers:
    tests/test_torch_backslash.py::test_last_resort_is_host_oracle_on_cpu.)
    """
    import slip_lu_tpu_torch.gpu.backslash_cuda as bc
    import slip_lu_tpu_torch.gpu.backslash_fused as bf
    monkeypatch.setattr(bf, "fused_solve_all", _always_singular)
    calls = []
    real = bc.factorize_solve_cuda

    def spy(*args, **kw):
        calls.append(kw.get("device"))
        return real(*args, **kw)

    monkeypatch.setattr(bc, "factorize_solve_cuda", spy)
    A, b = _tri20(port)
    x = port.backslash(A, b, port.Type.MPQ, port.Options(check=True),
                       device="cpu")
    st = port.last_stats()
    assert st.backend == "cuda-fused" and st.fallback
    assert calls == [torch.device("cpu")]
    _assert_same(x, ref.backslash(*_tri20(ref), ref.Type.MPQ))
