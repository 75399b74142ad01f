"""The C++-DES parity gate pointed at the port: ``tests/test_parity.py``'s
v2 POOL world (MAX_MIPS, periodic adverts, the status-6 relay) (``:216``, 7,500 ticks of 0.2 ms): the port's ``run`` on
the CPU against JAX ``run`` on every leaf, then its final state replayed
through the native simulator with that file's assertions and tolerances;
built, replayed and checked by ``tests/test_torch_des.py``.
"""
import pytest
import torch

from tests import test_torch_des as des


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


NAME = "v2_pool"


@pytest.fixture(scope="module")
def port_final():
    return des.port_run(NAME)


def test_v2_pool_world_matches_jax_every_leaf(port_final):
    des.assert_port_matches_jax(NAME, port_final)


def test_v2_pool_world_holds_to_the_des(port_final):
    spec, final, d, used, _ = des.replay(NAME, port_final)
    des.check_v2_pool(spec, final, d, used)
