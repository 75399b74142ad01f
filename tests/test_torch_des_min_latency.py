"""The C++-DES parity gate pointed at the port: ``tests/test_parity.py``'s
MIN_LATENCY world (``:119``, 10,000 ticks) and its world where fog 0
registers last (``:411``, 3,000 ticks), run by the port on the CPU and
replayed through the native simulator with that file's assertions;
built, replayed and checked by ``tests/test_torch_des.py``.  A file of
their own, so that a test worker runs them beside that file's steady
world.
"""
import numpy as np
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


def test_min_latency_holds_to_the_des():
    spec, final, d, used, _ = des.replay("min_latency", des.port_run("min_latency"))
    des.check_other_policies(2, spec, final, d, used)


def test_fog0_registers_last_holds_to_the_des():
    spec, final, d, used, state0 = des.replay("fog0_last", des.port_run("fog0_last"))
    reg0 = float(np.asarray(state0.broker.register_t)[0])
    t_dec = np.asarray(final.tasks.t_at_broker)[used]
    eng_fog = np.asarray(final.tasks.fog)[used]
    early = t_dec < reg0
    assert early.any()  # the window before fog 0 registers was exercised
    assert (eng_fog[early] != 0).all()  # never the unregistered slot 0
    np.testing.assert_array_equal(eng_fog, d["fog"])
