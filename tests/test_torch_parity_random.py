"""``tests/test_parity.py::test_parity_random_shared_stream``'s world
(RANDOM, 20,000 ticks of 0.1 ms), the port's ``run`` against JAX ``run``
on every leaf; built and compared by ``tests/test_torch_parity_worlds.py``.
"""
from tests.test_torch_parity_worlds import (  # noqa: F401 (a fixture)
    assert_port_matches_jax,
    one_torch_thread,
)


def test_random_parity_world_matches_jax_every_leaf():
    assert_port_matches_jax("random")
