"""The port's copied host layers held to the JAX package's originals.

slip_lu_tpu_torch carries copies of the numpy host layers (ordering,
schedule, chunk streams, the Python-int oracle) so that importing it
never imports jax. These tests pin the copies: the planner's arrays must
be byte-equal, and the oracle must give equal rationals.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import slip_lu_tpu as ref
import slip_lu_tpu_torch as port
from slip_lu_tpu.tpu import schedule_native as ref_native
from slip_lu_tpu.tpu import schedule_stream as ref_stream
from slip_lu_tpu_torch.gpu import schedule_native as port_native
from slip_lu_tpu_torch.gpu import schedule_stream as port_stream

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATS = os.path.join(REPO, "data", "ExampleMats")


def _mat(pkg, name):
    A = pkg.read_triplet(os.path.join(MATS, f"{name}_mat.txt"))
    return pkg.matrix_copy(A, pkg.Kind.CSC, pkg.Type.MPZ)


def _assert_fields_equal(a, b, what):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, (what, f.name)
            assert x.tobytes() == y.tobytes(), (what, f.name)
        elif not dataclasses.is_dataclass(x):
            assert x == y, (what, f.name)


@pytest.mark.parametrize("name", ["grid8", "tri200", "sparse100", "uni10k"])
def test_planner_arrays_byte_equal(name):
    plans = []
    for pkg, native, stream in ((ref, ref_native, ref_stream),
                                (port, port_native, port_stream)):
        A = _mat(pkg, name)
        ana = pkg.analyze(A, pkg.Options())
        q = np.asarray(ana.q, np.int64)
        sched, r = native.build_schedule_best(A, q, None)
        es = stream.build_event_stream(sched, 2, 32, 128)
        plans.append((q, sched, r, es))
    (q0, s0, r0, e0), (q1, s1, r1, e1) = plans
    assert q0.tobytes() == q1.tobytes()
    assert r0.tobytes() == r1.tobytes()
    _assert_fields_equal(s0, s1, "schedule")
    assert e0.init_pos.tobytes() == e1.init_pos.tobytes()
    for part in ("factor", "solve"):
        c0, c1 = getattr(e0, part), getattr(e1, part)
        for f in ("h_step", "h_slot", "h_div", "counts", "ev1", "ev2",
                  "max_level"):
            assert getattr(c0, f).tobytes() == getattr(c1, f).tobytes(), \
                (part, f)


@pytest.mark.parametrize("name", ["tiny4", "dense10", "arrow25", "tri20",
                                  "sparse30", "multirhs15", "rat12",
                                  "wide_range"])
def test_host_oracle_equal_rationals(name):
    xs = []
    for pkg in (ref, port):
        A = pkg.read_triplet(os.path.join(MATS, f"{name}_mat.txt"))
        b = pkg.read_dense(os.path.join(MATS, f"{name}_v.txt"))
        xs.append(pkg.backslash(A, b, pkg.Type.MPQ, pkg.Options(check=True),
                                backend="host"))
    x0, x1 = xs
    assert (x0.m, x0.n) == (x1.m, x1.n)
    for i in range(x0.m):
        for c in range(x0.n):
            assert x0.x[i, c] == x1.x[i, c], (i, c)


def test_import_leaves_jax_out():
    """Importing the port (every module of it) never imports jax or the
    JAX package."""
    code = (
        "import sys\n"
        "import slip_lu_tpu_torch\n"
        "import slip_lu_tpu_torch.gpu.backslash_fused\n"
        "import slip_lu_tpu_torch.gpu.factor_fused\n"
        "import slip_lu_tpu_torch.gpu._build\n"
        "import slip_lu_tpu_torch.gpu.relift\n"
        "import slip_lu_tpu_torch.gpu.schedule_subtree\n"
        "import slip_lu_tpu_torch.ops.device_limbs\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'slip_lu_tpu' or m.startswith('slip_lu_tpu.')]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
