"""``tests/test_parity.py::test_parity_fixed_bug_modes``'s world (the
``mips0_divisor`` and ``v1_max_scan`` quirks repaired, 10,000 ticks of
0.1 ms), the port's ``run`` against JAX ``run`` on every leaf; built and
compared by ``tests/test_torch_parity_worlds.py``, then replayed
through the native DES (``tests/test_torch_des.py``).
"""
import pytest
import torch

from tests import test_torch_des as des
from tests.test_torch_parity_worlds import (
    assert_port_holds_to_the_des,
    assert_port_matches_jax,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_fixed_bug_modes_parity_world_matches_jax_every_leaf():
    assert_port_matches_jax("fixed_bug_modes")


def test_fixed_bug_modes_parity_world_holds_to_the_des():
    assert_port_holds_to_the_des("fixed_bug_modes", des.check_fixed_bug_modes)
