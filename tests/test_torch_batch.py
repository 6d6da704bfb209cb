"""Families of pattern-sharing systems on the port's fused path, held to the
JAX package (the fused cases of ``tests/test_batch.py``).

``factorize_solve_cuda_fused_many`` runs on ``device="cpu"`` (the kernels'
plain versions). Each family goes through the JAX driver
``factorize_solve_tpu_fused_many`` too (interpret mode), and the port must
give its rationals and take its decisions: the plan (the rows pinned on
the shared Analysis by a family replan, or none), and which members were
solved alone by the single-system driver (spied on in both packages).
The reference's test of a family whose tables would need HBM becomes a
test of the port's own rule, ``family_fits`` against ``DEVICE_BUDGET``.
"""

import numpy as np
import pytest

import slip_lu_tpu as ref
import slip_lu_tpu_torch as port
from slip_lu_tpu.factorize import factorize as ref_factorize
from slip_lu_tpu.tpu import backslash_fused as ref_bf
from slip_lu_tpu_torch.factorize import factorize as port_factorize
from slip_lu_tpu_torch.gpu import backslash_fused as bf

from test_torch_host import release_jax  # noqa: F401 (autouse)

CAPS = dict(heads_per_chunk=2, pass1_events=8, pass2_events=16)


def _family(pkg, nb=4, n=10, seed=3, nrhs=1):
    """tests/test_batch.py's family (nb matrices sharing one pattern, with
    right-hand sides), built in either package."""
    rng = np.random.default_rng(seed)
    pattern = np.zeros((n, n), dtype=bool)
    for r in range(n):
        for c in range(n):
            if rng.random() < 0.3:
                pattern[r, c] = True
        pattern[r, r] = True
    As, bs = [], []
    for _ in range(nb):
        d = np.zeros((n, n), dtype=object)
        for r in range(n):
            for c in range(n):
                if pattern[r, c]:
                    d[r, c] = int(rng.integers(1, 10)) * \
                        (1 if rng.random() < 0.5 else -1)
        As.append(pkg.matrix_copy(pkg.SlipMatrix.from_dense(d, pkg.Type.MPZ),
                                  pkg.Kind.CSC, pkg.Type.MPZ))
        bs.append(pkg.SlipMatrix.from_dense(
            np.array([[int(rng.integers(-5, 6)) for _ in range(nrhs)]
                      for _ in range(n)], dtype=object), pkg.Type.MPZ))
    return As, bs


def _spy_solo(monkeypatch, module, name):
    """Record which systems the family driver hands to the single-system
    driver (by their values)."""
    real = getattr(module, name)
    seen = []

    def spy(A, *args, **kw):
        seen.append([int(v) for v in A.x[:int(A.p[A.n])]])
        return real(A, *args, **kw)

    monkeypatch.setattr(module, name, spy)
    return seen


def _run_both(monkeypatch, make, opts=lambda pkg: {}):
    """One family through both drivers; opts(pkg): the Options fields.
    Returns (port xs, ref xs, port Analysis, ref Analysis, port solo
    calls, ref solo calls)."""
    ref_solo = _spy_solo(monkeypatch, ref_bf, "factorize_solve_tpu_fused")
    port_solo = _spy_solo(monkeypatch, bf, "factorize_solve_cuda_fused")
    Ar, br = make(ref)
    ana_r = ref.analyze(Ar[0], ref.Options(**opts(ref)))
    xr = ref_bf.factorize_solve_tpu_fused_many(Ar, ana_r, br,
                                               ref.Options(**opts(ref)),
                                               **CAPS)
    Ap, bp = make(port)
    ana_p = port.analyze(Ap[0], port.Options(**opts(port)))
    xp = bf.factorize_solve_cuda_fused_many(Ap, ana_p, bp,
                                            port.Options(**opts(port)),
                                            device="cpu", **CAPS)
    return xp, xr, ana_p, ana_r, port_solo, ref_solo


def _assert_same(xs, ys):
    assert len(xs) == len(ys)
    for x, y in zip(xs, ys):
        assert (x.m, x.n) == (y.m, y.n)
        for i in range(x.m):
            for c in range(x.n):
                assert x.x[i, c] == y.x[i, c], (i, c)


def _assert_same_plan(ana_p, ana_r):
    fp, fr = ana_p.sparse_fixed_r, ana_r.sparse_fixed_r
    assert (fp is None) == (fr is None)
    if fp is not None:
        assert list(map(int, fp)) == list(map(int, fr))


def _assert_host(As, bs, xs):
    for A, b, x in zip(As, bs, xs):
        xh = port.backslash(A, b, port.Type.MPQ, port.Options(),
                            backend="host")
        _assert_same([x], [xh])


def test_fused_batch_matches_jax(monkeypatch):
    xp, xr, ana_p, ana_r, ps, rs = _run_both(
        monkeypatch, lambda pkg: _family(pkg, nb=3, n=8, seed=4))
    _assert_same(xp, xr)
    _assert_same_plan(ana_p, ana_r)
    assert ps == rs
    assert ana_p.fused_many_width_cache[1:] == \
        ana_r.fused_many_width_cache[1:]
    _assert_host(*_family(port, nb=3, n=8, seed=4), xp)


@pytest.mark.slow
def test_fused_batch_multi_rhs_and_widths(monkeypatch):
    """Members of very different magnitudes share one (the widest) width;
    two right-hand sides a member."""
    def make(pkg):
        As, bs = _family(pkg, nb=3, n=8, seed=9, nrhs=2)
        for t in range(int(As[2].p[8])):
            As[2].x[t] = int(As[2].x[t]) * 10**6
        return As, bs

    xp, xr, ana_p, ana_r, ps, rs = _run_both(monkeypatch, make)
    _assert_same(xp, xr)
    _assert_same_plan(ana_p, ana_r)
    assert ps == rs
    _assert_host(*make(port), xp)


def _zero_entries(pkg, As, g, n):
    """tests/test_batch.py's edit: zero member g's stored entries where
    that keeps it nonsingular (pattern unchanged)."""
    A2 = As[g]
    opts = pkg.Options()
    factorize = ref_factorize if pkg is ref else port_factorize
    for t in range(int(A2.p[n])):
        old = A2.x[t]
        if old == 0:
            continue
        A2.x[t] = 0
        try:
            factorize(A2, pkg.analyze(A2, opts), opts)
        except Exception:
            A2.x[t] = old


@pytest.mark.slow
def test_fused_batch_member_with_zero_pivot_falls_back(monkeypatch):
    def make(pkg):
        As, bs = _family(pkg, nb=3, n=6, seed=11)
        _zero_entries(pkg, As, 1, 6)
        return As, bs

    xp, xr, ana_p, ana_r, ps, rs = _run_both(monkeypatch, make)
    _assert_same(xp, xr)
    _assert_same_plan(ana_p, ana_r)
    assert ps == rs
    _assert_host(*make(port), xp)


# in natural order this system's 2x2 leading minor cancels exactly (the
# JAX package's tests/test_sharded_fused.py); the family's other member
# shares its pattern and does not cancel
CANCEL = [[2, 1, 0, 3], [4, 2, 1, 0], [0, 1, 5, 1], [3, 0, 1, 4]]
CLEAN = [[2, 1, 0, 3], [4, 3, 1, 0], [0, 1, 5, 1], [3, 0, 1, 4]]


def _cancel_family(pkg):
    As = [pkg.matrix_copy(pkg.SlipMatrix.from_dense(
        np.array(m, dtype=object), pkg.Type.MPZ), pkg.Kind.CSC,
        pkg.Type.MPZ) for m in (CLEAN, CANCEL, CLEAN)]
    bs = [pkg.SlipMatrix.from_dense(np.array([[1], [2], [3], [g]],
                                             dtype=object), pkg.Type.MPZ)
          for g in range(3)]
    return As, bs


def test_cancelling_member_replans_the_family(monkeypatch):
    """Member 1's transversal pivot cancels exactly: the whole family is
    replanned around its oracle pivot rows (pinned on the shared
    Analysis) and solved together; no member is solved alone."""
    def opts(pkg):
        return {"order": pkg.Ordering.NONE}

    xp, xr, ana_p, ana_r, ps, rs = _run_both(monkeypatch, _cancel_family,
                                             opts)
    _assert_same(xp, xr)
    _assert_same_plan(ana_p, ana_r)
    assert ana_p.sparse_fixed_r is not None
    A1 = _cancel_family(port)[0][1]
    o = port.Options(**opts(port))
    F = port_factorize(A1, port.analyze(A1, o), o)
    assert list(map(int, ana_p.sparse_fixed_r)) == list(map(int, F.row_perm))
    assert ps == rs == []
    _assert_host(*_cancel_family(port), xp)


def test_fused_batch_rejects_mismatched_patterns():
    As, bs = _family(port, nb=2, n=5, seed=5)
    Bs, _ = _family(port, nb=1, n=5, seed=6)
    with pytest.raises(port.SlipIncorrectInputError):
        bf.factorize_solve_cuda_fused_many(
            [As[0], Bs[0]], port.analyze(As[0], port.Options()), bs,
            port.Options(), device="cpu")
    with pytest.raises(port.SlipIncorrectInputError):
        bf.factorize_solve_cuda_fused_many(As, port.analyze(
            As[0], port.Options()), bs[:1], port.Options(), device="cpu")


def test_fused_batch_groups(monkeypatch):
    """A family larger than SLIP_FUSED_GMAX splits into groups (8 and 2
    members here; the port runs the exact member count)."""
    monkeypatch.setenv("SLIP_FUSED_GMAX", "8")
    groups = []
    real = bf._fused_many_group

    def spy(As, *args, **kw):
        groups.append(len(As))
        return real(As, *args, **kw)

    monkeypatch.setattr(bf, "_fused_many_group", spy)
    xp, xr, ana_p, ana_r, ps, rs = _run_both(
        monkeypatch, lambda pkg: _family(pkg, nb=10, n=6, seed=21))
    assert groups == [8, 2]
    _assert_same(xp, xr)
    _assert_same_plan(ana_p, ana_r)
    assert ps == rs


def test_family_budget_rule(monkeypatch):
    """The port's memory rule: a group whose G member tables exceed
    DEVICE_BUDGET is solved one member at a time (still exact); within the
    budget it runs as one family."""
    E, n = 24_999, 1_400
    nbytes = 4 * 16 * (25_000 * 24 + 1_402 * (24 + 32 + 8))
    assert bf.family_fits(E, n, 16, 24, 32)
    assert not bf.family_fits(E, n, 16, 2048, 2056)
    monkeypatch.setattr(bf, "DEVICE_BUDGET", nbytes)
    assert bf.family_fits(E, n, 16, 24, 32)
    monkeypatch.setattr(bf, "DEVICE_BUDGET", nbytes - 1)
    assert not bf.family_fits(E, n, 16, 24, 32)
    monkeypatch.setattr(bf, "DEVICE_BUDGET", 2 * 1024 ** 3)
    As, bs = _family(port, nb=2, n=6, seed=31)
    solo = _spy_solo(monkeypatch, bf, "factorize_solve_cuda_fused")
    xs = bf.factorize_solve_cuda_fused_many(
        As, port.analyze(As[0], port.Options()), bs, port.Options(),
        device="cpu", **CAPS)
    assert solo == []
    monkeypatch.setattr(bf, "DEVICE_BUDGET", 1)
    xs1 = bf.factorize_solve_cuda_fused_many(
        As, port.analyze(As[0], port.Options()), bs, port.Options(),
        device="cpu", **CAPS)
    assert len(solo) == 2
    _assert_same(xs, xs1)
    _assert_host(As, bs, xs)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    As, bs = _family(port, nb=2, n=5, seed=5)
    with pytest.raises(RuntimeError, match="CUDA"):
        bf.factorize_solve_cuda_fused_many(
            As, port.analyze(As[0], port.Options()), bs, port.Options())


def test_family_of_one_runs_its_rhs_as_lanes():
    """A group of one member is one system: its right-hand sides run as
    the lanes of one solve run, and the decode reads that layout."""
    As, bs = _family(port, nb=1, n=8, seed=4, nrhs=3)
    xs = bf.factorize_solve_cuda_fused_many(
        As, port.analyze(As[0], port.Options()), bs, port.Options(),
        device="cpu", **CAPS)
    _assert_host(As, bs, xs)
