"""The port's chip-partitioned (sharded) chunk streams held to the JAX
package's.

``slip_lu_tpu_torch/parallel/stream_shard_fused.py`` is a copy of the numpy
module ``slip_lu_tpu/parallel/stream_shard_fused.py``, and the port's
``gpu/schedule_subtree.py`` builds the sharded grouped stream with it. Both
must give the reference's streams byte for byte at every rank count:
every ``ShardedChunks`` field, the local diag slots and broadcast rows,
the owner and local slot of each value and of each grouped stream's extra
slot. The sharded driver's planning must take the reference's decisions.
"""

import dataclasses

import numpy as np
import pytest

import slip_lu_tpu as ref
import slip_lu_tpu_torch as port
from slip_lu_tpu.parallel import driver_fused as ref_df
from slip_lu_tpu.parallel import stream_shard_fused as ref_ssf
from slip_lu_tpu.tpu import schedule_native as ref_native
from slip_lu_tpu.tpu import schedule_subtree as ref_sub
from slip_lu_tpu_torch.gpu import schedule_native as port_native
from slip_lu_tpu_torch.gpu import schedule_subtree as port_sub
from slip_lu_tpu_torch.parallel import driver_fused as port_df
from slip_lu_tpu_torch.parallel import stream_shard_fused as port_ssf

from test_torch_host import _assert_fields_equal, _mat
from test_torch_host import release_jax  # noqa: F401 (autouse)
from test_torch_subtree import _band, _blocks

PKGS = ((ref, ref_native, ref_ssf, ref_sub),
        (port, port_native, port_ssf, port_sub))


def _assert_sharded_equal(s0, s1):
    assert type(s1).__name__ == "ShardedEventStream"
    for part in ("factor", "solve"):
        _assert_fields_equal(getattr(s0, part), getattr(s1, part), part)
    for f in dataclasses.fields(s0):
        x, y = getattr(s0, f.name), getattr(s1, f.name)
        if f.name in ("factor", "solve"):
            continue
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.asarray(x).dtype == np.asarray(y).dtype, f.name
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), \
                f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("name", ["tri200", "sparse100"])
def test_sharded_streams_byte_equal(name, p):
    built = []
    for pkg, native, ssf, _ in PKGS:
        A = _mat(pkg, name)
        q = np.asarray(pkg.analyze(A, pkg.Options()).q, np.int64)
        sched, _ = native.build_schedule_best(A, q, None)
        built.append(ssf.build_sharded_stream(sched, p, 8, 32, 128))
    _assert_sharded_equal(*built)
    assert built[1].p == p


@pytest.mark.parametrize("p", [1, 2, 3])
def test_sharded_grouped_streams_byte_equal(p):
    """try_build_grouped(p=...) on dense diagonal blocks coupled by a tail:
    ndet, nxx, clone ownership, the replicated m1 slot and the extra-slot
    inits per rank."""
    built = []
    for pkg, native, _, sub in PKGS:
        A = _blocks(pkg)
        q = np.asarray(pkg.analyze(
            A, pkg.Options(order=pkg.Ordering.NONE)).q, np.int64)
        sched, _ = native.build_schedule_best(A, q, None)
        built.append(sub.try_build_grouped(sched, 8, 64, 128,
                                           n_groups=min(32, max(8, 2 * p)),
                                           p=p))
    assert built[0] is not None and built[0].ndet is not None
    assert built[1].extra_chip is not None and len(built[1].extra_chip)
    _assert_sharded_equal(*built)


@pytest.mark.parametrize("p", [2, 3])
def test_plan_sharded_takes_the_reference_decisions(p):
    """plan_sharded on the band (a chain forest under natural order: the
    dissection candidate, its certification and the width-aware grouped
    adoption): the same order, pinned rows and stream in both packages,
    and the driver's stream arguments byte-equal."""
    plans = []
    for pkg, df in ((ref, ref_df), (port, port_df)):
        A, _ = _band(pkg)
        opts = pkg.Options(order=pkg.Ordering.NONE)
        ana = pkg.analyze(A, opts)
        sched, r, ses, avals, q = df.plan_sharded(A, ana, p, opts)
        plans.append((ana, r, ses, avals, q))
    (a0, r0, s0, v0, q0), (a1, r1, s1, v1, q1) = plans
    assert np.asarray(q0).tobytes() == np.asarray(q1).tobytes()
    assert np.asarray(r0).tobytes() == np.asarray(r1).tobytes()
    assert v0 == v1
    # the dissection was committed and the grouped stream adopted
    assert a1.sparse_fixed_r is not None and s1.ndet is not None
    assert a0.sparse_fixed_r.tobytes() == a1.sparse_fixed_r.tobytes()
    _assert_sharded_equal(s0, s1)
    for x, y in zip(port_df.stream_arrays(s0, len(q0)),
                    port_df.stream_arrays(s1, len(q1))):
        assert x.tobytes() == y.tobytes()
