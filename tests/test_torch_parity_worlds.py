"""The native-DES parity worlds of the compacted broker, port against JAX.

``tests/test_parity.py`` holds the JAX engine against the sequential
C++ simulator on three worlds the compacted broker decides: ROUND_ROBIN
with heterogeneous fog access links (``test_parity_other_policies``),
the repaired ``mips0_divisor`` / ``v1_max_scan`` quirks
(``test_parity_fixed_bug_modes``) and RANDOM's task-id-keyed stream
(``test_parity_random_shared_stream``).  Here each is built as that test
builds it, and the port's ``run`` is held against JAX ``run`` on every
leaf, bit for bit (10,000 to 20,000 ticks of 0.1 ms).  Each world has
its own file, so the three run side by side: ROUND_ROBIN here, the
quirk-repaired world in ``tests/test_torch_parity_bug_modes.py`` and
RANDOM in ``tests/test_torch_parity_random.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu.spec import BugCompat
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.state import state_to_numpy, tree_leaves


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are small: torch's OpenMP pool would
    only spin (five cores busy for one core's work) beside the other test
    workers, so this module's tests run the port on one thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


_PARITY = dict(
    send_interval=0.05, dt=1e-4, n_users=2, start_time_max=0.02,
)
WORLDS = {
    # test_parity.py::test_parity_other_policies[1]
    "round_robin": dict(
        _PARITY, horizon=1.0, n_fogs=3, fog_mips=(16384.0, 32768.0, 8192.0),
        policy=1,
    ),
    # test_parity.py::test_parity_fixed_bug_modes
    "fixed_bug_modes": dict(
        _PARITY, horizon=1.0, n_fogs=2, fog_mips=(20000.0, 30000.0),
        bug_compat=BugCompat(mips0_divisor=False, v1_max_scan=False),
    ),
    # test_parity.py::test_parity_random_shared_stream
    "random": dict(
        _PARITY, horizon=2.0, n_fogs=3, fog_mips=(16384.0, 32768.0, 8192.0),
        policy=4,
    ),
}
#: test_parity_other_policies' extra access delay of each fog
FOG_ACC = np.asarray([5e-4, 0.0, 1e-3])


def _build(name, mod, xp):
    kw = WORLDS[name]
    if mod is tsmoke:
        spec, state, net, bounds = mod.build(device="cpu", **kw)
    else:
        spec, state, net, bounds = mod.build(**kw)
    if name == "round_robin":
        # heterogeneous fog access links, then the adverts primed again
        fog_nodes = np.arange(spec.n_fogs) + spec.n_users
        acc = np.asarray(net.node_acc).copy()
        acc[fog_nodes] += FOG_ACC
        net = net.replace(node_acc=jnp.asarray(acc) if xp is jnp else torch.from_numpy(acc))
        engine = jengine if xp is jnp else tengine
        state = engine.prime_initial_advertisements(spec, state, net)
    return spec, state, net, bounds


def assert_port_matches_jax(name):
    spec_t, st_t, net_t, b_t = _build(name, tsmoke, torch)
    final_t, _ = tengine.run(spec_t, st_t, net_t, b_t)
    spec_j, st_j, net_j, b_j = _build(name, jsmoke, jnp)
    final_j, _ = jengine.run(spec_j, st_j, net_j, b_j)
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(final_j)]
    got = state_to_numpy(final_t)
    paths = [p for p, _ in tree_leaves(final_t)]
    for p, a, b in zip(paths, ref, got):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        assert a.tobytes() == b.tobytes(), f"{name}: leaf {p} differs"
    fog = final_t.tasks.fog.numpy()
    assert len(set(fog[fog >= 0].tolist())) == spec_t.n_fogs  # every fog used


def test_round_robin_parity_world_matches_jax_every_leaf():
    assert_port_matches_jax("round_robin")
