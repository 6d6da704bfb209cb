"""The sharded fused exact solve of the port on two gloo ranks, held to the
JAX driver on a virtual mesh of two devices: the device half's inputs and
flat vector bit for bit (see tests/test_torch_fused_shard.py, which holds
one rank to one device; the JAX side is compiled in interpret mode, so
each mesh size has a file of its own)."""

import pytest

from test_torch_fused_shard import assert_flat_vector_matches_jax, \
    gloo_and_jax
from test_torch_host import release_jax  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return gloo_and_jax(str(tmp_path_factory.mktemp("gloo")),
                        {2: ["sys12"]}, (2,))


def test_flat_vector_matches_jax_two_ranks(runs):
    """Two ranks against the JAX driver on two devices."""
    assert_flat_vector_matches_jax(*runs, 2)
