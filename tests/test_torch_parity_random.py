"""``tests/test_parity.py::test_parity_random_shared_stream``'s world
(RANDOM, 20,000 ticks of 0.1 ms), the port's ``run`` against JAX ``run``
on every leaf; built and compared by
``tests/test_torch_parity_worlds.py``, then replayed through the native
DES (``tests/test_torch_des.py``).
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


def test_random_parity_world_matches_jax_every_leaf():
    assert_port_matches_jax("random")


def test_random_parity_world_holds_to_the_des():
    assert_port_holds_to_the_des("random", des.check_random)
