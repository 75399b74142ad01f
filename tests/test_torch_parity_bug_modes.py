"""``tests/test_parity.py::test_parity_fixed_bug_modes``'s world (the
``mips0_divisor`` and ``v1_max_scan`` quirks repaired, 10,000 ticks of
0.1 ms), the port's ``run`` against JAX ``run`` on every leaf; built and
compared by ``tests/test_torch_parity_worlds.py``, then replayed
through the native DES (``tests/test_torch_des.py``).
"""
from tests import test_torch_des as des
from tests.test_torch_parity_worlds import (  # noqa: F401 (a fixture)
    assert_port_holds_to_the_des,
    assert_port_matches_jax,
    one_torch_thread,
)


def test_fixed_bug_modes_parity_world_matches_jax_every_leaf():
    assert_port_matches_jax("fixed_bug_modes")


def test_fixed_bug_modes_parity_world_holds_to_the_des():
    assert_port_holds_to_the_des("fixed_bug_modes", des.check_fixed_bug_modes)
