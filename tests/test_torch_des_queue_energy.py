"""The C++-DES parity gate pointed at the port: ``tests/test_parity.py``'s
queueing world (``:90``, 15,000 ticks) and its ENERGY_AWARE world
(``:329``, 20,000 ticks), run by the port on the CPU and replayed through
the native simulator with that file's assertions and tolerances; built,
replayed and checked by ``tests/test_torch_des.py``.
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


def test_queueing_world_holds_to_the_des():
    spec, final, d, used, _ = des.replay("queueing", des.port_run("queueing"))
    des.check_queueing(spec, final, d, used)


def test_energy_aware_world_holds_to_the_des():
    spec, final, d, used, _ = des.replay("energy_aware", des.port_run("energy_aware"))
    des.check_energy_aware(spec, final, d, used)
