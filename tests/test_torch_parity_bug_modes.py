"""``tests/test_parity.py::test_parity_fixed_bug_modes``'s world (the
``mips0_divisor`` and ``v1_max_scan`` quirks repaired, 10,000 ticks of
0.1 ms), the port's ``run`` against JAX ``run`` on every leaf; built and
compared by ``tests/test_torch_parity_worlds.py``.
"""
from tests.test_torch_parity_worlds import (  # noqa: F401 (a fixture)
    assert_port_matches_jax,
    one_torch_thread,
)


def test_fixed_bug_modes_parity_world_matches_jax_every_leaf():
    assert_port_matches_jax("fixed_bug_modes")
