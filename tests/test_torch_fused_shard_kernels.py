"""Kernels K6 and K7 of the sharded fused solve: their plain versions held
to the JAX package's ``_ab_call`` and ``_c_call`` (Pallas, interpret mode).

A p = 2 plan of an n = 12 system runs on both ranks in this one process,
with the plain versions and the sums over the ranks taken by hand (what
the all-reduce computes): the factor stream up to a chunk with heads, a
history fix, events of both passes on both ranks and B operands to
broadcast, then, after the whole factor stream, the solve stream up to a
chunk with events of both passes and broadcast rows. On that factor chunk
and that solve chunk, each rank's K6 and K7 plain versions must write what
the JAX kernels write, bit for bit: the value table (or X), SMT, GT, TZ,
the flags and the broadcast buffer.
"""

import gc
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slip_lu_tpu_torch as port
from slip_lu_tpu.parallel import factor_fused_shard as ref_ffs
from slip_lu_tpu_torch.gpu.factor_fused import _r8, ints_to_tc_rows
from slip_lu_tpu_torch.parallel import driver_fused as port_df
from slip_lu_tpu_torch.parallel import factor_fused_shard as ffs

from test_torch_fused_shard import CAPS, CASES

P = 2
W8, Ws8 = 8, 16        # the system's settled widths: no flag is raised



@pytest.fixture(scope="module", autouse=True)
def _release_jax():
    """Drop this module's compiled JAX programs when it is done: each one
    holds JIT memory maps, and an xdist worker runs many modules in one
    process (whose map count is capped)."""
    yield
    _jitted.cache_clear()
    jax.clear_caches()
    gc.collect()


def _zeros(*shape):
    return torch.zeros(shape, dtype=torch.int32)


def _tables(n8, W, WI):
    SMT, GT, TZ = _zeros(n8, W), _zeros(n8, WI), _zeros(n8, 8)
    SMT[0, 0] = GT[0, 0] = 1
    return SMT, GT, TZ


@pytest.fixture(scope="module")
def plan():
    """The port's p = 2 plan of sys12: each rank's streams and value
    table, and A's order."""
    A, b, _, _ = CASES["sys12"]
    Ap = port.matrix_copy(port.SlipMatrix.from_dense(A, port.Type.MPZ),
                          port.Kind.CSC, port.Type.MPZ)
    opts = port.Options()
    ana = port.analyze(Ap, opts)
    _, r, ses, avals, _ = port_df.plan_sharded(Ap, ana, P, opts, **CAPS)
    n = Ap.n
    arrays = port_df.stream_arrays(ses, n)
    rows = ints_to_tc_rows(avals, W8)
    vals = []
    for k in range(P):
        v = np.zeros((_r8(ses.Lp), W8), np.int32)
        mine = ses.init_chip == k
        v[ses.init_loc[mine]] = rows[mine]
        vals.append(torch.from_numpy(v))
    rss = [ffs.rank_streams(k, "cpu", *arrays) for k in range(P)]
    bcol = [int(b[int(r[k]), 0]) for k in range(n)]
    X0 = _zeros(_r8(n + 1 + ses.nxx), Ws8)
    X0[:n] = torch.from_numpy(ints_to_tc_rows(bcol, Ws8))
    return dict(n=n, E=ses.nnz, ndet=n if ses.ndet is None else ses.ndet,
                rss=rss, vals=vals, X0=X0)


def _factor_chunk(ch):
    """A factor chunk with a fixed head, both passes on both ranks and B
    operands to broadcast."""
    H = ch[0].H
    for c in range(ch[0].nchunks):
        ms = [x.meta_host[c] for x in ch]
        if (ms[0][3 * H] > 0 and ms[0][3 * H + 3] & 256
                and ms[0][3 * H + 4] > 0
                and all(m[3 * H + 1] > 0 and m[3 * H + 2] > 0 for m in ms)):
            return c
    raise AssertionError("no factor chunk exercises every phase")


def _solve_chunk(ch):
    for c in range(ch[0].nchunks):
        ms = [x.meta_host[c] for x in ch]
        if ms[0][4] > 0 and all(m[1] > 0 and m[2] > 0 for m in ms):
            return c
    raise AssertionError("no solve chunk exercises every phase")


@functools.lru_cache(maxsize=None)
def _jitted(fn, statics):
    """One compiled JAX kernel per shape: both ranks share it."""
    return jax.jit(functools.partial(fn, **dict(statics)))


def _j(t):
    return jnp.asarray(t.numpy())


def _facc(flags):
    f = np.zeros((8, 128), np.int32)
    f[:, 0] = flags.numpy()
    return jnp.asarray(f)


def _same(got, want, what):
    assert np.array_equal(np.asarray(want), got.numpy()), what


def _ab_jax(ch, c, st, diag, statics, solve):
    """The JAX K6 on a copy of one rank's state at chunk c."""
    H = ch.H if not solve else statics["H"]
    hm = ch.meta_host[c]
    cnt = hm[3 * ch.H:3 * ch.H + 4]
    zH = np.zeros(H, np.int32)
    hs, hsl, hd = (zH, zH, zH) if solve else \
        (hm[:H], hm[H:2 * H], hm[2 * H:3 * H])
    tgt = st["X"] if solve else st["val"]
    Wt = tgt.shape[1]
    H8 = max(H, 8)
    d = np.zeros((H8, Wt), np.int32)
    if diag is not None:
        d[:H] = diag.numpy()
    fn = _jitted(ref_ffs._ab_call, tuple(sorted(dict(
        statics, heads=not solve, is_solve=solve, Wt=Wt).items())))
    flags = st["sflags"] if solve else st["flags"]
    return fn(jnp.asarray(cnt), jnp.asarray(hs), jnp.asarray(hsl),
              jnp.asarray(hd), _j(ch.ev1[c]), _j(ch.bidx[c]),
              jnp.asarray(np.int32(hm[3 * ch.H + 4])), jnp.asarray(d),
              _j(tgt), _j(st["SMT"]), _j(st["GT"]), _j(st["TZ"]),
              _facc(flags), _j(ch.mbc[c]))


def _c_jax(ch, c, st, bc, statics, solve):
    hm = ch.meta_host[c]
    tgt = st["X"] if solve else st["val"]
    a_src = _j(st["val"]) if solve else jnp.zeros((8, 128), jnp.int32)
    fn = _jitted(ref_ffs._c_call, tuple(sorted(dict(
        statics, is_solve=solve, Wt=tgt.shape[1]).items())))
    flags = st["sflags"] if solve else st["flags"]
    return fn(jnp.asarray(hm[3 * ch.H:3 * ch.H + 4]), _j(ch.ev2[c]),
              _j(ch.bidx[c]), jnp.asarray(np.int32(hm[3 * ch.H + 4])),
              _j(bc), a_src, _j(st["SMT"]), _j(st["GT"]), _j(st["TZ"]),
              _j(tgt), _facc(flags))


def _superstep(chs, c, sts, solve, check=None):
    """Chunk c on every rank with the plain versions, the sums by hand.
    check(stage, states before, B operands): the JAX comparison after each
    kernel."""
    before = [{k: t.clone() for k, t in st.items()} for st in sts]
    bcs = ffs.local_ab(chs, c, sts, solve, plain=True)
    if check:
        check("ab", before, bcs)
    before = [{k: t.clone() for k, t in st.items()} for st in sts]
    ffs.local_c(chs, c, sts, sum(bcs), solve, plain=True)
    if check:
        check("c", before, sum(bcs))


def test_k6_k7_plain_versions_match_jax_on_both_ranks(plan):
    n, E = plan["n"], plan["E"]
    rss = plan["rss"]
    fch = [rs.factor for rs in rss]
    sch = [rs.solve for rs in rss]
    n8 = _r8(plan["ndet"] + 2)
    WQ = _r8(W8 + 2)
    WI = max(WQ, _r8(max(W8, Ws8) + 2))       # one segment: S == 1
    sts = []
    for v in plan["vals"]:
        SMT, GT, TZ = _tables(n8, W8, WI)
        sts.append(dict(val=v.clone(), SMT=SMT, GT=GT, TZ=TZ,
                        flags=_zeros(8), X=plan["X0"].clone(),
                        sflags=_zeros(8)))
    fs = dict(n=n, E=E, W8=W8, WN=_r8(2 * W8 + 2), WQ=WQ, WV=_r8(WQ + W8),
              WI8=WI)
    seen = []

    def check_factor(stage, before, bc):
        H = fch[0].H
        diag = None
        if fch[0].meta_host[c0, 3 * H] > 0:
            diag = sum(b["val"][ch.hsl[c0]] * ch.mdiag[c0]
                       for ch, b in zip(fch, before))
        for k, (ch, st, b) in enumerate(zip(fch, sts, before)):
            if stage == "ab":
                out = _ab_jax(ch, c0, b, diag, dict(
                    fs, H=ch.H, C1=ch.C1, CB8=ch.CB8), False)
                for t, name in zip(out[:4], ("val", "SMT", "GT", "TZ")):
                    _same(st[name], t, (k, name))
                _same(st["flags"], np.asarray(out[4])[:, 0], (k, "flags"))
                _same(bc[k], out[5], (k, "bc_out"))
            else:
                out = _c_jax(ch, c0, b, bc, dict(fs, C2=ch.C2), False)
                _same(st["val"], out[0], (k, "val"))
                _same(st["flags"], np.asarray(out[1])[:, 0], (k, "flags"))
            seen.append(("factor", k, stage))

    c0 = _factor_chunk(fch)
    for c in range(fch[0].nchunks):
        _superstep(fch, c, sts, False, check_factor if c == c0 else None)
    for st in sts:
        assert not st["flags"].any()
    WQs = min(WI, _r8(Ws8 + 2))
    ss = dict(n=n, E=E, W8=W8, WN=_r8(W8 + Ws8 + 2), WQ=WQs,
              WV=_r8(WQs + W8), WI8=WI)

    def check_solve(stage, before, bc):
        for k, (ch, st, b) in enumerate(zip(sch, sts, before)):
            if stage == "ab":
                out = _ab_jax(ch, c1, b, None, dict(
                    ss, H=fch[k].H, C1=ch.C1, CB8=ch.CB8), True)
                _same(st["X"], out[0], (k, "X"))
                _same(st["sflags"], np.asarray(out[4])[:, 0], (k, "flags"))
                _same(bc[k], out[5], (k, "bc_out"))
            else:
                out = _c_jax(ch, c1, b, bc, dict(ss, C2=ch.C2), True)
                _same(st["X"], out[0], (k, "X"))
                _same(st["sflags"], np.asarray(out[1])[:, 0], (k, "flags"))
            seen.append(("solve", k, stage))

    c1 = _solve_chunk(sch)
    for c in range(c1 + 1):
        _superstep(sch, c, sts, True, check_solve if c == c1 else None)
    assert len(seen) == 8
