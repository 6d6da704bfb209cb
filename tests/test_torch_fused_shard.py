"""The sharded fused exact solve of the port, on gloo ranks, held to the JAX
package.

``slip_lu_tpu_torch.parallel`` runs one process a rank over a
``torch.distributed`` group. Here each world size (1, 2 and 3) is one group
of gloo processes on the CPU, started once for the module with a
``FileStore`` in a temporary directory; the kernels' plain versions run.
Every rank runs its cases through ``factorize_solve_cuda_fused_sharded``
and reports the inputs and the flat vector of each call of its device half
(``fused_sharded_solve``). Meanwhile this process runs the JAX driver on
the same n = 12 system with two right-hand sides on the reference's
virtual mesh of one device (interpret mode; two devices in
``tests/test_torch_fused_shard_p2.py``), recording its device
half's arguments and flat vector. They must be equal bit for bit: the
streams, the value tables of each rank, X, the widths and segments, and
the flat vector. The port's answers must equal the host oracle, also at
p = 3, after an exact cancellation (the single-chip fallback) and up a
width ladder.
"""

import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import slip_lu_tpu as ref
import slip_lu_tpu_torch as port
from slip_lu_tpu.parallel import driver_fused as ref_df
from slip_lu_tpu.parallel import make_mesh
from slip_lu_tpu.stats import last_stats as ref_last_stats
from slip_lu_tpu_torch.parallel import driver_fused as port_df

from conftest import random_sparse_int
from test_torch_host import release_jax  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# small chunk capacities, as in tests/test_sharded_fused.py: many chunks,
# small interpret-mode kernels
CAPS = dict(heads_per_chunk=2, pass1_events=8, pass2_events=16)

# The rank's process: runs each case through the port's sharded driver on
# the CPU and pickles what it saw.
WORKER = r"""
import pickle, sys, traceback
import torch.distributed as dist
rank, world, store, task, out = sys.argv[1:6]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
import slip_lu_tpu_torch as port
from slip_lu_tpu_torch.parallel import driver_fused as df
real = df.fused_sharded_solve
calls = []

def spy(group, n, W8, Ws8, WI8, rs, val0, X0, ndet=None, segments=None,
        ssegments=None):
    flat = real(group, n, W8, Ws8, WI8, rs, val0, X0, ndet, segments,
                ssegments)
    calls.append(dict(n=n, W8=W8, Ws8=Ws8, WI8=WI8, ndet=ndet,
                      segments=segments, ssegments=ssegments,
                      val0=val0.numpy(), X0=X0.numpy(), flat=flat.numpy()))
    return flat

df.fused_sharded_solve = spy
res = {}
for case in pickle.load(open(task, "rb")):
    calls.clear()
    try:
        A = port.matrix_copy(port.SlipMatrix.from_dense(
            case["A"], port.Type.MPZ), port.Kind.CSC, port.Type.MPZ)
        b = port.SlipMatrix.from_dense(case["b"], port.Type.MPZ)
        opts = port.Options(**case["opts"])
        ana = port.analyze(A, opts)
        x = df.factorize_solve_cuda_fused_sharded(A, ana, b, None, opts,
                                                  device="cpu", **case["caps"])
        st = port.last_stats()
        ses = ana.fused_shard_cache[1][2]
        res[case["name"]] = dict(
            x=[[x.x[i, c] for c in range(x.n)] for i in range(x.m)],
            backend=st.backend, fallback=st.fallback, retries=st.retries,
            calls=list(calls), arrays=df.stream_arrays(ses, A.n))
    except Exception:
        res[case["name"]] = dict(error=traceback.format_exc())
pickle.dump(res, open(out, "wb"))
dist.destroy_process_group()
"""


def _dense(n, seed, density=0.35, lohi=9, nrhs=1):
    """tests/test_sharded_fused.py's random system as dense Python ints."""
    rng = np.random.default_rng(seed)
    M = random_sparse_int(n, density=density, lo=-lohi, hi=lohi, rng=rng)
    A = np.array([[int(M.x[i, j]) for j in range(n)] for i in range(n)],
                 dtype=object)
    b = np.array([[int(rng.integers(-lohi, lohi + 1)) for _ in range(nrhs)]
                  for _ in range(n)], dtype=object)
    return A, b


CANCEL = (np.array([[2, 1, 0, 3], [4, 2, 1, 0], [0, 1, 5, 1], [3, 0, 1, 4]],
                   dtype=object),
          np.array([[1], [2], [3], [4]], dtype=object))

CASES = {
    # the system held to the JAX driver at p = 1 and 2 (one rung, no
    # fallback in either package)
    "sys12": (*_dense(12, seed=9, nrhs=2), {}, CAPS),
    # p = 3 against p = 1
    "sys16": (*_dense(16, seed=11, nrhs=2), {}, CAPS),
    # in natural order the 2x2 leading minor cancels: the single-chip
    # replan
    "cancel4": (*CANCEL, {"order": port.Ordering.NONE}, CAPS),
    # 10^9-scale entries under max_limbs=2: the width ladder climbs
    "ladder": (*_dense(12, seed=3, lohi=10**9), {"max_limbs": 2}, CAPS),
}
# the cases of each world size's gloo group in this file
GROUPS = {1: ["sys12", "sys16"], 2: ["cancel4", "ladder"], 3: ["sys16"]}


def _start(tmp, p, names):
    """Start one gloo group of p rank processes on the cases ``names``;
    returns their handles."""
    cases = [dict(name=k, A=CASES[k][0], b=CASES[k][1], opts=CASES[k][2],
                  caps=CASES[k][3]) for k in names]
    task = os.path.join(tmp, f"task{p}.pkl")
    with open(task, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for r in range(p):
        out = os.path.join(tmp, f"out{p}_{r}.pkl")
        procs.append((out, subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), str(p),
             os.path.join(tmp, f"store{p}"), task, out], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return procs


def _collect(procs):
    outs = []
    for out, proc in procs:
        try:
            log = proc.communicate(timeout=300)[0]
        except subprocess.TimeoutExpired:
            for _, q in procs:
                q.kill()
            raise
        assert proc.returncode == 0, log[-4000:]
        with open(out, "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _jax_calls(name, p):
    """The JAX driver on a case over a mesh of p virtual devices: its
    device half's arguments and flat vector per call, and its answer."""
    A, b, opts, caps = CASES[name]
    Ar = ref.matrix_copy(ref.SlipMatrix.from_dense(A, ref.Type.MPZ),
                         ref.Kind.CSC, ref.Type.MPZ)
    br = ref.SlipMatrix.from_dense(b, ref.Type.MPZ)
    real = ref_df.fused_sharded_solve
    calls = []

    def spy(*args, **kw):
        flat = np.asarray(real(*args, **kw))
        calls.append(([np.asarray(a) if hasattr(a, "shape") else a
                       for a in args], kw, flat))
        return flat

    ref_df.fused_sharded_solve = spy
    try:
        o = ref.Options(**opts)
        x = ref_df.factorize_solve_fused_sharded(
            Ar, ref.analyze(Ar, o), br, make_mesh(jax.devices()[:p]), o,
            **caps)
    finally:
        ref_df.fused_sharded_solve = real
    assert not ref_last_stats().fallback
    return calls, x


def gloo_and_jax(tmp, groups, jax_ps):
    """Start the gloo groups ({p: case names}), run the JAX driver on
    sys12 at each mesh size of jax_ps meanwhile, then collect the groups.
    Returns ({p: [each rank's results]}, {p: (JAX calls, JAX answer)})."""
    procs = {p: _start(tmp, p, names) for p, names in groups.items()}
    try:
        jx = {p: _jax_calls("sys12", p) for p in jax_ps}
    finally:
        got = {p: _collect(procs[p]) for p in groups}
    for p, outs in got.items():
        for res in outs:
            for name, r in res.items():
                assert "error" not in r, (p, name, r.get("error"))
    return got, jx


def assert_flat_vector_matches_jax(got, jx, p):
    """The device half's inputs and flat vector on every rank of the
    p-rank group equal the JAX driver's on a p-device mesh, bit for bit."""
    jcalls, _ = jx[p]
    ranks = [res["sys12"] for res in got[p]]
    assert len(jcalls) == 1
    for r, res in enumerate(ranks):
        assert len(res["calls"]) == len(jcalls)
        for (args, kw, flat), c in zip(jcalls, res["calls"]):
            assert (c["n"], c["W8"], c["Ws8"], c["WI8"]) == \
                (args[1], args[3], args[4], args[7])
            assert (c["ndet"], c["segments"], c["ssegments"]) == \
                (kw["ndet"], kw["segments"], kw["ssegments"])
            for i, a in enumerate(res["arrays"]):
                _eq(np.asarray(args[14 + i]), a, f"stream array {i}")
            _eq(np.asarray(args[31])[r], c["val0"], "value table")
            _eq(np.asarray(args[32]), c["X0"], "X0")
            _eq(flat, c["flat"], "flat vector")
    x = jx[p][1]
    assert [[x.x[i, c] for c in range(x.n)] for i in range(x.m)] == \
        _oracle("sys12")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every gloo group's results, and the JAX driver's calls on one
    device (tests/test_torch_fused_shard_p2.py holds two)."""
    return gloo_and_jax(str(tmp_path_factory.mktemp("gloo")), GROUPS, (1,))


def _oracle(name):
    A, b, opts, _ = CASES[name]
    Ap = port.SlipMatrix.from_dense(A, port.Type.MPZ)
    bp = port.SlipMatrix.from_dense(b, port.Type.MPZ)
    x = port.backslash(Ap, bp, port.Type.MPQ, port.Options(**opts),
                       backend="host")
    return [[x.x[i, c] for c in range(x.n)] for i in range(x.m)]


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, \
        (what, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


def test_flat_vector_matches_jax(runs):
    """One rank against the JAX driver on one device."""
    assert_flat_vector_matches_jax(*runs, 1)


def test_sharded_answers_equal_oracle(runs):
    """Every case on every rank of every group: the oracle's rationals,
    under the sharded backend's name."""
    got, jx = runs
    for p, outs in got.items():
        for res in outs:
            for name, r in res.items():
                assert r["x"] == _oracle(name), (p, name)
                assert r["backend"] == "cuda-fused-sharded", (p, name)


def test_three_ranks_match_one_rank(runs):
    got, _ = runs
    one = got[1][0]["sys16"]
    for res in got[3]:
        assert res["sys16"]["x"] == one["x"]
        assert not res["sys16"]["fallback"]
        for c3, c1 in zip(res["sys16"]["calls"], one["calls"]):
            _eq(c3["flat"], c1["flat"], "flat vector, p = 3 vs 1")


def test_cancellation_falls_back_to_single_chip(runs):
    """The transversal pivots cancel exactly: the sharded program flags a
    singular pivot, every rank takes the single-chip replan and reports
    the fallback."""
    got, _ = runs
    for res in got[2]:
        r = res["cancel4"]
        assert r["fallback"]
        assert r["calls"] and r["calls"][0]["flat"][0] > 0
        assert r["x"] == _oracle("cancel4")


def test_width_ladder_climbs(runs):
    got, _ = runs
    for res in got[2]:
        r = res["ladder"]
        assert r["retries"] > 0 and not r["fallback"]
        assert len(r["calls"]) == r["retries"] + 1
        assert r["x"] == _oracle("ladder")


def test_no_card_raises():
    A, b = CANCEL
    Ap = port.matrix_copy(port.SlipMatrix.from_dense(A, port.Type.MPZ),
                          port.Kind.CSC, port.Type.MPZ)
    bp = port.SlipMatrix.from_dense(b, port.Type.MPZ)
    ana = port.analyze(Ap, port.Options())
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_df.factorize_solve_cuda_fused_sharded(Ap, ana, bp,
                                                   device="cuda")


def test_missing_process_group_raises():
    A, b = CANCEL
    Ap = port.matrix_copy(port.SlipMatrix.from_dense(A, port.Type.MPZ),
                          port.Kind.CSC, port.Type.MPZ)
    bp = port.SlipMatrix.from_dense(b, port.Type.MPZ)
    ana = port.analyze(Ap, port.Options())
    with pytest.raises(RuntimeError, match="process group"):
        port_df.factorize_solve_cuda_fused_sharded(Ap, ana, bp,
                                                   device="cpu")
