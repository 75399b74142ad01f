"""The compacted broker's worlds: the port's ``run`` against JAX ``run``.

Every leaf of the final state has the same dtype, shape and bits as the
undonated JAX ``engine.run`` on the same world: here ROUND_ROBIN (with
topic fan-out to subscribers and a window smaller than a tick's
publishes), RANDOM, MIN_BUSY / MIN_LATENCY / ENERGY_AWARE without the
``mips0_divisor`` quirk, and DYNAMIC at a static and at an invalid id;
the learned policies' worlds run from ``tests/test_torch_learn.py`` with
this file's machinery, so the two files run side by side.  A failure
names the first differing leaf and the first tick at which the two
engines' states part.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fognetsimpp_tpu import Policy
from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.net.topology import associate as jassociate
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu.spec import BugCompat
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.net.topology import associate as tassociate
from fognetsimpp_tpu_torch.runtime.signals import summarize as tsummarize
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


#: A small wired world whose fogs keep up, so tasks complete and ack.
BASE = dict(
    n_users=24, n_fogs=4, fog_mips=(40000.0, 80000.0, 20000.0, 60000.0),
    send_interval=0.02, horizon=0.2, start_time_max=0.02, queue_capacity=16,
)
NO_MIPS0 = BugCompat(mips0_divisor=False)
LEARN = dict(BASE, derive_acks=False)

#: world -> (build kwargs, state edits applied to both engines' states)
WORLDS = {
    # topic fan-out, and a K-window smaller than a tick's publishes:
    # deferral and rotated windows
    "round_robin": (
        dict(BASE, policy=int(Policy.ROUND_ROBIN), send_interval=0.004,
             arrival_window=2, n_topics=3), {"fanout": 5}),
    "random": (dict(BASE, policy=int(Policy.RANDOM), policy_seed=3), {}),
    "min_busy": (dict(BASE, bug_compat=NO_MIPS0), {}),
    "min_latency": (
        dict(BASE, policy=int(Policy.MIN_LATENCY), bug_compat=NO_MIPS0), {}),
    "energy_aware": (
        dict(BASE, policy=int(Policy.ENERGY_AWARE), bug_compat=NO_MIPS0,
             energy_enabled=True), {}),
    "dynamic_random": (dict(BASE, policy=int(Policy.DYNAMIC)), {"policy_id": 4}),
    "dynamic_invalid": (dict(BASE, policy=int(Policy.DYNAMIC)), {"policy_id": 6}),
    "ucb": (dict(LEARN, policy=int(Policy.UCB)), {}),
    "ducb": (dict(LEARN, policy=int(Policy.DUCB), learn_discount=0.9), {}),
    "exp3": (dict(LEARN, policy=int(Policy.EXP3), learn_explore=0.2), {}),
    "dynamic_learn_static": (
        dict(LEARN, policy=int(Policy.DYNAMIC), learn_in_dynamic=True),
        {"policy_id": 1}),
    "dynamic_learn_exp3": (
        dict(LEARN, policy=int(Policy.DYNAMIC), learn_in_dynamic=True),
        {"policy_id": int(Policy.EXP3)}),
}


def _picked_p(s):
    return s["pick_p_not_one"] > 0


EXPECT = {
    "round_robin": lambda s: (
        s["fogs_used"] == 4 and s["n_deferred_max"] > 0 and s["n_fanout"] > 0),
    "random": lambda s: s["fogs_used"] == 4,
    "min_busy": lambda s: s["fogs_used"] >= 2,
    "min_latency": lambda s: s["fogs_used"] >= 2,
    "energy_aware": lambda s: s["fogs_used"] >= 2,
    "dynamic_random": lambda s: s["fogs_used"] == 4,
    "dynamic_invalid": lambda s: s["n_scheduled"] == 0 and s["n_no_resource"] > 0,
    "ucb": lambda s: s["lat_cnt"] > 0 and s["fogs_used"] == 4,
    "ducb": lambda s: s["lat_cnt"] > 0 and s["fogs_used"] == 4,
    "exp3": lambda s: s["lat_cnt"] > 0 and _picked_p(s),
    "dynamic_learn_static": lambda s: s["lat_cnt"] > 0 and not _picked_p(s),
    "dynamic_learn_exp3": lambda s: s["lat_cnt"] > 0 and _picked_p(s),
}


def _edit(edits, state, xp):
    """Apply a world's state edits with the array module ``xp`` (``jnp``
    for JAX, ``torch`` for the port): the DYNAMIC policy id, and a
    numpy-seeded topic table for fan-out."""
    def arr(a):
        return jnp.asarray(a) if xp is jnp else torch.from_numpy(a)

    if "policy_id" in edits:
        state = state.replace(broker=state.broker.replace(
            policy_id=arr(np.array(edits["policy_id"], np.int32))))
    if "fanout" in edits:
        U, n_topics = state.users.sub_mask.shape
        rng = np.random.default_rng(edits["fanout"])
        state = state.replace(users=state.users.replace(
            pub_topic=arr(rng.integers(0, n_topics, U).astype(np.int32)),
            sub_mask=arr(rng.random((U, n_topics)) < 0.4),
        ))
    return state


def _build_port(name):
    kw, edits = WORLDS[name]
    spec, st, net, b = tsmoke.build(device="cpu", **kw)
    return spec, _edit(edits, st, torch), net, b


def _build_jax(name):
    kw, edits = WORLDS[name]
    spec, st, net, b = jsmoke.build(**kw)
    return spec, _edit(edits, st, jnp), net, b


@pytest.fixture(scope="module")
def port_runs():
    cache = {}

    def get(name):
        if name not in cache:
            spec, st, net, b = _build_port(name)
            cache[name] = (spec, tengine.run(spec, st, net, b)[0])
        return cache[name]

    return get


def _first_diverging_tick(name):
    spec_j, st_j, net_j, b_j = _build_jax(name)
    spec_t, st_t, net_t, b_t = _build_port(name)
    step_j = jax.jit(jengine.make_step(spec_j))
    step_t = tengine.make_step(spec_t)
    cache_j = cache_t = None
    if spec_j.assume_static:
        cache_j = jassociate(net_j, st_j.nodes.pos, st_j.nodes.alive, broker=spec_j.broker_index)
        cache_t = tassociate(net_t, st_t.nodes.pos, st_t.nodes.alive, spec_t.broker_index)
    paths = [p for p, _ in tree_leaves(st_t)]
    for tick in range(spec_j.n_ticks):
        st_j = step_j(st_j, net_j, b_j, cache_j)
        st_t = step_t(st_t, net_t, b_t, cache_t)
        ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(st_j)]
        for p, a, b in zip(paths, ref, state_to_numpy(st_t)):
            if a.tobytes() != b.tobytes():
                return tick, p
    return None, None


def _facts(final):
    s = tsummarize(final)
    fog = final.tasks.fog.numpy()
    s["fogs_used"] = len(set(fog[fog >= 0].tolist()))
    s["lat_cnt"] = float(final.learn.lat_cnt)
    s["pick_p_not_one"] = int((final.learn.pick_p != 1.0).sum())
    s["n_fanout"] = int(final.metrics.n_fanout)
    return s


#: Worlds of the learned policies, run by ``tests/test_torch_learn.py``.
LEARNED_WORLDS = (
    "ucb", "ducb", "exp3", "dynamic_learn_static", "dynamic_learn_exp3",
)


def assert_run_matches_jax(name, port_runs):
    spec_t, final_t = port_runs(name)
    spec_j, st_j, net_j, b_j = _build_jax(name)
    final_j, _ = jengine.run(spec_j, st_j, net_j, b_j)
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(final_j)]
    got = state_to_numpy(final_t)
    paths = [p for p, _ in tree_leaves(final_t)]
    assert len(ref) == len(got) == 144
    for p, a, b in zip(paths, ref, got):
        if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
            tick, leaf = _first_diverging_tick(name)
            raise AssertionError(
                f"{name}: leaf {p} differs ({a.dtype}{a.shape} vs "
                f"{b.dtype}{b.shape}); the states first part at tick {tick}, "
                f"leaf {leaf}"
            )
    facts = _facts(final_t)
    assert EXPECT[name](facts), f"{name} does not exercise its path: {facts}"


@pytest.mark.parametrize("name", [w for w in WORLDS if w not in LEARNED_WORLDS])
def test_run_matches_jax_every_leaf(name, port_runs):
    assert_run_matches_jax(name, port_runs)
