"""The C++-DES parity gate pointed at the port.

``tests/test_parity.py`` holds the JAX engine against the sequential
native simulator (``fognetsimpp_tpu/native/desim.cpp``) through
``native/bridge.replay_engine_world``.  Here the port runs each of those
worlds that it can run, on the CPU; its final leaves are laid into JAX's
pytree structure and replayed through the same bridge, with
``test_parity.py``'s own assertions and tolerances.  The worlds, by the
line of ``tests/test_parity.py`` that builds them:

- ``:24`` the steady wired world (this file);
- ``:90`` queueing (``tests/test_torch_des_queue_energy.py``) and ``:329``
  ENERGY_AWARE (``tests/test_torch_des_energy.py``);
- ``:119`` MIN_LATENCY (``tests/test_torch_des_min_latency.py``) and
  ROUND_ROBIN, ``:164`` the repaired
  bug modes and ``:297`` RANDOM, each beside its port-against-JAX run in
  ``tests/test_torch_parity_worlds.py``, ``tests/test_torch_parity_bug_modes.py``
  and ``tests/test_torch_parity_random.py``;
- ``:411`` fog 0 registering last (``tests/test_torch_des_min_latency.py``);
- ``:188`` the wired v1 world (``scenarios/wired_v1``: LOCAL_FIRST, POOL
  fogs), ``:216`` v2 POOL fogs under MAX_MIPS and ``:252`` the v2 hybrid
  broker with its shared release timer, in
  ``tests/test_torch_des_wired_v1.py``, ``tests/test_torch_des_v2_pool.py``
  and ``tests/test_torch_des_v2_hybrid.py``, each beside its
  port-against-JAX run.

The port runs 3,000-20,000 ticks of 0.1-0.2 ms a world.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fognetsimpp_tpu import Stage
from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.native import bridge
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu.scenarios import wired_v1 as jwired_v1
from fognetsimpp_tpu.spec import BugCompat
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.scenarios import wired_v1 as twired_v1
from fognetsimpp_tpu_torch.state import state_to_numpy


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


#: Each world: ``smoke.build`` arguments as ``tests/test_parity.py`` passes
#: them, and the edits it makes after the build: extra fog access delay
#: (``acc_add``, by fog) or one fog's access delay (``acc_set``), each then
#: priming the adverts again, and fogs in the energy model (``energy_fogs``).
WORLDS = {
    "steady": dict(build=dict(  # :24
        horizon=2.0, send_interval=0.05, dt=1e-4, n_users=2, n_fogs=2,
        fog_mips=(20000.0, 30000.0), start_time_max=0.02)),
    "queueing": dict(build=dict(  # :90
        horizon=1.5, send_interval=0.04, dt=1e-4, n_users=3, n_fogs=2,
        fog_mips=(4000.0, 6000.0), start_time_max=0.02)),
    "round_robin": dict(build=dict(  # :119, policy 1
        horizon=1.0, send_interval=0.05, dt=1e-4, n_users=2, n_fogs=3,
        fog_mips=(16384.0, 32768.0, 8192.0), start_time_max=0.02, policy=1),
        acc_add=(5e-4, 0.0, 1e-3)),
    "min_latency": dict(build=dict(  # :119, policy 2
        horizon=1.0, send_interval=0.05, dt=1e-4, n_users=2, n_fogs=3,
        fog_mips=(16384.0, 32768.0, 8192.0), start_time_max=0.02, policy=2),
        acc_add=(5e-4, 0.0, 1e-3)),
    "fixed_bug_modes": dict(build=dict(  # :164
        horizon=1.0, send_interval=0.05, dt=1e-4, n_users=2, n_fogs=2,
        fog_mips=(20000.0, 30000.0), start_time_max=0.02,
        bug_compat=BugCompat(mips0_divisor=False, v1_max_scan=False))),
    "random": dict(build=dict(  # :297
        horizon=2.0, send_interval=0.05, dt=1e-4, n_users=2, n_fogs=3,
        fog_mips=(16384.0, 32768.0, 8192.0), start_time_max=0.02, policy=4)),
    "energy_aware": dict(build=dict(  # :329
        horizon=2.0, send_interval=0.05, dt=1e-4, n_users=2, n_fogs=2,
        fog_mips=(16384.0, 32768.0), policy=3, energy_enabled=True,
        energy_capacity_j=1.0, tx_energy_j=1.0 / 256.0, rx_energy_j=1.0 / 256.0,
        idle_power_w=0.0, compute_power_w=0.0, harvest_power_w=0.0),
        energy_fogs=True),
    "fog0_last": dict(build=dict(  # :411
        horizon=0.3, send_interval=0.02, dt=1e-4, n_users=2, n_fogs=3,
        fog_mips=(2000.0, 3000.0, 2500.0), start_time_max=0.001),
        acc_set={0: 6e-3}),
    "v1_local_first": dict(wired_v1=True, build=dict(  # :188
        horizon=1.5, dt=2e-4)),
    "v2_pool": dict(build=dict(  # :216, POOL fogs, MAX_MIPS
        horizon=1.5, send_interval=0.05, dt=2e-4, n_users=2, n_fogs=2,
        fog_mips=(1000.0, 2000.0), start_time_max=0.02, app_gen=2,
        fog_model=1, policy=6, adv_on_completion=False, adv_periodic=True)),
    "v2_hybrid": dict(build=dict(  # :252, LOCAL_FIRST with v2_local_broker
        horizon=1.0, send_interval=0.004, dt=1e-4, n_users=2, n_fogs=2,
        fog_mips=(1024.0, 2048.0), app_gen=2, fog_model=1, policy=5,
        broker_mips=2048.0, v2_local_broker=True, adv_on_completion=False,
        adv_periodic=True, send_stop_time=0.5, max_sends_per_user=130)),
}


def _edit(name, spec, state, net, xp):
    """``tests/test_parity.py``'s edits of world ``name`` on one package's
    build (``xp`` = jnp or torch)."""
    w = WORLDS[name]
    engine = jengine if xp is jnp else tengine
    if "acc_add" in w or "acc_set" in w:
        acc = np.asarray(net.node_acc).copy()
        fogs = np.arange(spec.n_fogs) + spec.n_users
        if "acc_add" in w:
            acc[fogs] += np.asarray(w["acc_add"])
        for f, v in w.get("acc_set", {}).items():
            acc[spec.n_users + f] = v
        acc = jnp.asarray(acc) if xp is jnp else torch.from_numpy(acc)
        net = net.replace(node_acc=acc)
        state = engine.prime_initial_advertisements(spec, state, net)
    if w.get("energy_fogs"):
        has = np.zeros((spec.n_nodes,), bool)
        has[spec.n_users: spec.n_users + spec.n_fogs] = True
        has = jnp.asarray(has) if xp is jnp else torch.from_numpy(has)
        state = state.replace(nodes=state.nodes.replace(has_energy=has))
    return spec, state, net


def jax_world(name):
    """World ``name`` built and edited by the JAX package."""
    build = jwired_v1.build if WORLDS[name].get("wired_v1") else jsmoke.build
    spec, state, net, _ = build(**WORLDS[name]["build"])
    return _edit(name, spec, state, net, jnp)


def port_run(name):
    """The port's final state of world ``name`` on the CPU."""
    build = twired_v1.build if WORLDS[name].get("wired_v1") else tsmoke.build
    spec, state, net, bounds = build(device="cpu", **WORLDS[name]["build"])
    spec, state, net = _edit(name, spec, state, net, torch)
    return tengine.run(spec, state, net, bounds)[0]


def assert_port_matches_jax(name, port_final):
    """The port's final state of world ``name`` equals JAX ``run``'s on
    every leaf (dtype, shape and bits)."""
    spec, state, net = jax_world(name)
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(jengine.run(spec, state, net)[0])]
    got = state_to_numpy(port_final)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), (
            f"{name}: leaf {i} differs")


def replay(name, port_final):
    """The port's final leaves in JAX's tree, replayed through the DES:
    ``(spec, final, des, used, state0)`` with JAX's spec and initial
    state."""
    spec, state0, net = jax_world(name)
    leaves = [jnp.asarray(a) for a in state_to_numpy(port_final)]
    final = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(state0), leaves)
    des, used = bridge.replay_engine_world(spec, final, net)
    return spec, final, des, used, state0


def _eng(final, used, col):
    return np.asarray(getattr(final.tasks, col), np.float64)[used]


def _ack6_close(final, des, used, at_least):
    ack6 = _eng(final, used, "t_ack6")
    both = np.isfinite(ack6) & np.isfinite(des["t_ack6"])
    assert both.sum() >= at_least
    np.testing.assert_allclose(ack6[both], des["t_ack6"][both], rtol=1e-5)


# ----------------------------------------------------------------------
# test_parity.py's assertions, world by world
# ----------------------------------------------------------------------

def check_other_policies(policy, spec, final, des, used):
    """``test_parity_other_policies``."""
    ef = np.asarray(final.tasks.fog)[used]
    np.testing.assert_array_equal(ef, des["fog"])
    if policy == 2:
        # the rtt term decided: the cheapest-link fog dominates
        assert (ef == 1).sum() > (ef == 0).sum(), np.bincount(ef[ef >= 0])
    _ack6_close(final, des, used, 20)


def check_fixed_bug_modes(spec, final, des, used):
    """``test_parity_fixed_bug_modes``."""
    np.testing.assert_array_equal(np.asarray(final.tasks.fog)[used], des["fog"])
    _ack6_close(final, des, used, 20)


def check_random(spec, final, des, used):
    """``test_parity_random_shared_stream``."""
    ef = np.asarray(final.tasks.fog)[used]
    np.testing.assert_array_equal(ef, des["fog"])
    assert len(set(ef.tolist())) == 3  # the stream spreads load
    _ack6_close(final, des, used, 30)


def check_queueing(spec, final, des, used):
    """``test_parity_under_queueing``."""
    np.testing.assert_array_equal(np.asarray(final.tasks.fog)[used], des["fog"])
    eng_q = _eng(final, used, "queue_time_ms") / 1e3
    both_q = np.isfinite(eng_q) & np.isfinite(des["queue_time"])
    assert both_q.sum() >= 10  # real queueing happened
    np.testing.assert_allclose(
        eng_q[both_q], des["queue_time"][both_q], rtol=1e-2, atol=1e-5
    )
    done = (np.asarray(final.tasks.stage)[used] == int(Stage.DONE)) & (
        des["stage"] == int(Stage.DONE)
    )
    t0 = _eng(final, used, "t_create")[done]
    lat_e = _eng(final, used, "t_ack6")[done] - t0
    lat_d = des["t_ack6"][done] - t0
    rel = np.abs(lat_e - lat_d) / np.maximum(lat_d, 1e-9)
    assert rel.max() < 0.01


def check_energy_aware(spec, final, des, used):
    """``test_parity_energy_aware``."""
    ef = np.asarray(final.tasks.fog)[used]
    np.testing.assert_array_equal(ef, des["fog"])
    counts = np.bincount(ef[ef >= 0], minlength=2)
    assert counts.min() >= 10, counts  # the energy term decided
    _ack6_close(final, des, used, 30)
    eng_e = np.asarray(final.nodes.energy, np.float64)[
        spec.n_users: spec.n_users + spec.n_fogs
    ]
    np.testing.assert_allclose(eng_e, des["fog_energy"], rtol=0.01)


def check_v1_local_first(spec, final, des, used):
    """``test_parity_v1_local_first``."""
    np.testing.assert_array_equal(np.asarray(final.tasks.stage)[used], des["stage"])
    local3 = _eng(final, used, "t_ack3")
    both3 = np.isfinite(local3) & np.isfinite(des["t_ack3"])
    assert both3.sum() >= 8  # the ~9 pool-funded local tasks
    np.testing.assert_allclose(local3[both3], des["t_ack3"][both3], rtol=1e-5)
    ack6 = _eng(final, used, "t_ack6")
    both6 = np.isfinite(ack6) & np.isfinite(des["t_ack6"])
    assert (np.isfinite(ack6) == np.isfinite(des["t_ack6"])).all()
    np.testing.assert_allclose(ack6[both6], des["t_ack6"][both6], rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(final.tasks.fog)[used], des["fog"])
    tc = _eng(final, used, "t_complete")
    done = np.isfinite(tc) & np.isfinite(des["t_complete"])
    rel = np.abs(tc[done] - des["t_complete"][done]) / des["t_complete"][done]
    assert rel.max() < 0.01


def check_v2_pool(spec, final, des, used):
    """``test_parity_v2_pool``."""
    np.testing.assert_array_equal(np.asarray(final.tasks.fog)[used], des["fog"])
    np.testing.assert_array_equal(np.asarray(final.tasks.stage)[used], des["stage"])
    ack6 = _eng(final, used, "t_ack6")
    both = np.isfinite(ack6) & np.isfinite(des["t_ack6"])
    assert both.sum() >= 40
    t0 = _eng(final, used, "t_create")[both]
    lat_e = ack6[both] - t0
    lat_d = des["t_ack6"][both] - t0
    rel = np.abs(lat_e - lat_d) / np.maximum(lat_d, 1e-9)
    assert rel.max() < 1e-3


def check_v2_hybrid(spec, final, des, used):
    """``test_parity_v2_hybrid_broker``."""
    np.testing.assert_array_equal(np.asarray(final.tasks.stage)[used], des["stage"])
    np.testing.assert_array_equal(np.asarray(final.tasks.fog)[used], des["fog"])
    stage = np.asarray(final.tasks.stage)[used]
    assert (stage == int(Stage.LOCAL_RUN)).sum() > 0  # still leaked
    assert (np.asarray(final.tasks.fog)[used] >= 0).sum() > 5
    _ack6_close(final, des, used, 10)


# ----------------------------------------------------------------------
# this file's worlds
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def steady():
    return replay("steady", port_run("steady"))[:4]


def test_workload_and_choices_match(steady):
    spec, final, des, used = steady
    assert used.sum() >= 70  # ~80 publishes in 2 s
    np.testing.assert_allclose(
        _eng(final, used, "t_at_broker"), des["t_at_broker"], rtol=1e-5
    )
    decided = des["fog"] >= 0
    assert decided.all()
    np.testing.assert_array_equal(np.asarray(final.tasks.fog)[used], des["fog"])


def test_completion_times_within_1pct(steady):
    spec, final, des, used = steady
    eng_done = np.asarray(final.tasks.stage)[used] == int(Stage.DONE)
    des_done = des["stage"] == int(Stage.DONE)
    assert abs(int(eng_done.sum()) - int(des_done.sum())) <= 1
    both = eng_done & des_done
    assert both.sum() >= 30
    t0 = _eng(final, used, "t_create")[both]
    for col in ("t_complete", "t_ack6", "t_ack5", "t_service_start"):
        e = _eng(final, used, col)[both]
        d = des[col][both]
        fin = np.isfinite(e) & np.isfinite(d)
        assert (np.isfinite(e) == np.isfinite(d)).all(), col
        lat_e, lat_d = e[fin] - t0[fin], d[fin] - t0[fin]
        rel = np.abs(lat_e - lat_d) / np.maximum(np.abs(lat_d), 1e-9)
        assert rel.max() < 0.01, (col, rel.max())
    lat_e = _eng(final, used, "t_ack6")[both] - t0
    lat_d = des["t_ack6"][both] - t0
    assert abs(lat_e.mean() - lat_d.mean()) / lat_d.mean() < 0.01


def test_queue_times_match(steady):
    spec, final, des, used = steady
    eng_q = _eng(final, used, "queue_time_ms") / 1e3
    des_q = des["queue_time"]
    both = np.isfinite(eng_q) & np.isfinite(des_q)
    assert (np.isfinite(eng_q) == np.isfinite(des_q)).mean() > 0.95
    if both.any():
        np.testing.assert_allclose(eng_q[both], des_q[both], rtol=1e-2, atol=1e-5)
