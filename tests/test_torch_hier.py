"""The federated multi-broker hierarchy, port against JAX
(``tests/test_hier.py``'s gates at a small size).

Each federated world runs through the port's ``run`` and undonated JAX
``run`` on the CPU, and every leaf must be equal (dtype, shape, bits):
the forced-migration grid (dense and learned policies under THRESHOLD
and LEAST_LOADED), EXP3's per-domain importance weights, a domain taken
down by scripted chaos, and a dead federation that exhausts its hop
budget.  An inert two-broker world (one real domain, threshold at
infinity) leaves every other leaf as one broker leaves it.  Each JAX
oracle runs once a module.
"""
import numpy as np
import pytest
import torch

from fognetsimpp_tpu import Policy
from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.hier import federation as jfed
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu.spec import ChaosMode, HierPolicy, Stage
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.hier import federation as tfed
from fognetsimpp_tpu_torch.parallel.taskshard import run_tp_sharded
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.state import state_to_numpy
from tests.test_torch_v1v2 import assert_same


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


THRESHOLD, LEAST = int(HierPolicy.THRESHOLD), int(HierPolicy.LEAST_LOADED)
#: ``tests/test_hier.py``'s imbalanced world: every user publishes to
#: broker 0, whose one slow fog saturates, while broker 1 owns three
#: fast idle fogs one 5 ms hop away.
IMBALANCED = dict(
    n_users=4, n_fogs=4, fog_mips=(900.0, 60000.0, 60000.0, 60000.0),
    send_interval=0.02, horizon=0.25, dt=1e-3, seed=0, n_brokers=2,
    hier_threshold=0.5, hier_max_hops=2, hier_rtt_s=0.005, assume_static=True,
)
IMB_OWNERS = dict(user_broker=[0, 0, 0, 0], fog_broker=[0, 1, 1, 1])
#: Domain 0's two fogs down over most of the horizon, its tasks bounced
#: back to its broker (``test_chaos_dead_domain_migrates_instead_of_dropping``).
DOMAIN_DOWN = dict(
    n_users=4, n_fogs=4, fog_mips=(60000.0,), send_interval=0.02,
    horizon=0.3, dt=1e-3, seed=0, n_brokers=2, hier_policy=THRESHOLD,
    hier_threshold=0.5, hier_max_hops=2, assume_static=False, chaos=True,
    chaos_mode=int(ChaosMode.REOFFLOAD), chaos_max_retries=8,
    chaos_script=((0, 0.05, 0.28), (1, 0.05, 0.28)),
)
DOWN_OWNERS = dict(user_broker=[0, 0, 0, 0], fog_broker=[0, 0, 1, 1])
#: Every fog down: the bounced tasks have nowhere to go.
DEAD = dict(
    n_users=2, n_fogs=2, send_interval=0.05, horizon=0.3, assume_static=False,
    n_brokers=2, hier_policy=THRESHOLD, hier_threshold=0.5, hier_max_hops=1,
    chaos=True, chaos_mode=int(ChaosMode.REOFFLOAD), chaos_max_retries=8,
    chaos_script=((0, 0.05, 0.28), (1, 0.05, 0.28)),
)
WORLDS = {
    **{
        f"{p.name.lower()}-{h.name.lower()}": (
            dict(IMBALANCED, policy=int(p), hier_policy=int(h)), IMB_OWNERS
        )
        for p in (Policy.MIN_BUSY, Policy.DUCB)
        for h in (HierPolicy.THRESHOLD, HierPolicy.LEAST_LOADED)
    },
    "exp3-threshold": (
        dict(IMBALANCED, policy=int(Policy.EXP3), hier_policy=THRESHOLD,
             learn_explore=0.1),
        IMB_OWNERS,
    ),
    "domain-down": (DOMAIN_DOWN, DOWN_OWNERS),
    "dead": (DEAD, None),
}


def _census(final) -> dict:
    stage = final.tasks.stage.numpy()
    return {s.name: int((stage == int(s)).sum()) for s in Stage}


def _assert_conserved(final):
    """spawned = completed + dropped + lost + in flight + hop-exhausted."""
    c = _census(final)
    terminal = (
        c["DONE"] + c["DROPPED"] + c["LOST"] + c["NO_RESOURCE"] + c["REJECTED"]
        + c["HOP_EXHAUSTED"]
    )
    in_flight = (
        c["PUB_INFLIGHT"] + c["TASK_INFLIGHT"] + c["QUEUED"] + c["RUNNING"]
        + c["LOCAL_RUN"]
    )
    assert int(final.metrics.n_published) == terminal + in_flight, c
    assert c["HOP_EXHAUSTED"] == int(final.hier.n_hop_exhausted)
    assert c["DONE"] == int(final.metrics.n_completed)


@pytest.fixture(scope="module")
def runs():
    """``name -> (spec, port final, JAX final)``, the port held to JAX
    ``run`` on every leaf the first time a world is asked for."""
    cache = {}

    def get(name):
        if name not in cache:
            kw, owners = WORLDS[name]
            spec, state, net, bounds = tsmoke.build(device="cpu", **kw)
            js, jst, jn, jb = jsmoke.build(**kw)
            if owners:
                state = tfed.stamp_ownership(spec, state, **owners)
                jst = jfed.stamp_ownership(js, jst, **owners)
            final, _ = tengine.run(spec, state, net, bounds)
            want, _ = jengine.run(js, jst, jn, jb)
            assert_same(final, want, name)
            cache[name] = (spec, final, want)
        return cache[name]

    return get


@pytest.mark.parametrize("hier_policy", ["threshold", "least_loaded"])
@pytest.mark.parametrize("policy", ["min_busy", "ducb"])
def test_forced_migration_grid_matches_jax(policy, hier_policy, runs):
    """Migration fires on the imbalanced world, the per-broker counters
    add up, rescued tasks ran on the idle domain's fogs, and the
    conservation identity holds exactly."""
    spec, final, want = runs(f"{policy}-{hier_policy}")
    h = final.hier
    assert int(h.n_migrated) > 0
    assert int(h.mig_out.sum()) == int(h.mig_in.sum()) == int(h.n_migrated)
    done = final.tasks.stage.numpy() == int(Stage.DONE)
    rescued = done & (h.hops.numpy() > 0)
    assert rescued.any()
    assert np.isin(final.tasks.fog.numpy()[rescued], [1, 2, 3]).all()
    _assert_conserved(final)
    if spec.learn_active:
        # every credit resolves once, on the rescuing broker's pick
        reward_cnt = float(final.learn.reward_cnt.double().sum())
        assert reward_cnt == pytest.approx(float(final.learn.lat_cnt)) and reward_cnt > 0
    assert tfed.hier_summary(spec, final) == jfed.hier_summary(spec, want)
    assert tfed.hier_counters(final) == jfed.hier_counters(want)


def test_exp3_records_the_pick_probability_within_its_domain(runs):
    """EXP3 under federation samples from its broker's own softmax, and
    stores that probability for the credit's importance weight."""
    _, final, _ = runs("exp3-threshold")
    assert int(final.hier.n_migrated) > 0
    pick_p = final.learn.pick_p.numpy()
    fog = final.tasks.fog.numpy()
    on_idle = np.isin(fog, [1, 2, 3])
    # a pick in the three-fog domain is never certain; the one-fog
    # domain's always is
    assert (pick_p[on_idle] < 1.0).any()
    assert (pick_p[fog == 0] == 1.0).all()
    assert float(final.learn.lat_cnt) > 0


def test_dead_domain_migrates_instead_of_dropping(runs):
    """Domain 0's fogs down, REOFFLOAD: the bounced tasks move to the
    surviving domain and complete there."""
    _, final, _ = runs("domain-down")
    assert int(final.chaos.n_crashes) == 2 and int(final.chaos.n_reoffloaded) > 0
    assert int(final.hier.n_migrated) > 0
    done = final.tasks.stage.numpy() == int(Stage.DONE)
    assert (done & (final.hier.hops.numpy() > 0)).any()
    _assert_conserved(final)


def test_hop_budget_exhausts_in_a_dead_federation(runs):
    _, final, _ = runs("dead")
    assert int(final.hier.n_hop_exhausted) > 0
    _assert_conserved(final)


@pytest.mark.parametrize("policy", [Policy.MIN_BUSY, Policy.RANDOM, Policy.DUCB],
                         ids=lambda p: p.name.lower())
def test_inert_two_broker_world_changes_nothing_else(policy):
    """Two brokers with every user and fog in domain 0 and the threshold
    at infinity: the domain masks and the migrate phase run, and every
    leaf but the hierarchy's equals the one-broker world, and the
    two-broker world equals JAX's."""
    kw = dict(n_users=4, n_fogs=3, send_interval=0.02, horizon=0.15,
              assume_static=True, policy=int(policy))
    spec, state, net, bounds = tsmoke.build(device="cpu", **kw)
    one, _ = tengine.run(spec, state, net, bounds)
    fed = dict(kw, n_brokers=2, hier_policy=THRESHOLD, hier_threshold=float("inf"))
    owners = dict(user_broker=[0] * 4, fog_broker=[0] * 3)
    spec2, state2, net2, bounds2 = tsmoke.build(device="cpu", **fed)
    state2 = tfed.stamp_ownership(spec2, state2, **owners)
    two, _ = tengine.run(spec2, state2, net2, bounds2)
    assert [x.tobytes() for x in state_to_numpy(two.replace(hier=one.hier))] == [
        x.tobytes() for x in state_to_numpy(one)
    ]
    assert int(two.hier.n_migrated) == 0 and int(two.hier.n_hop_exhausted) == 0
    js, jst, jn, jb = jsmoke.build(**fed)
    jst = jfed.stamp_ownership(js, jst, **owners)
    assert_same(two, jengine.run(js, jst, jn, jb)[0], "inert two brokers")


def test_ownership_and_the_tp_refusal_are_the_references():
    """Default domains, restamping and its refusals, and ``[TP-HIER]``
    in JAX's words from the task-sharded runner."""
    kw = dict(n_users=5, n_fogs=4, n_brokers=3, horizon=0.05, assume_static=True)
    spec, state, net, bounds = tsmoke.build(device="cpu", **kw)
    js, jst, _, _ = jsmoke.build(**kw)
    for a, b in zip(tfed.default_ownership(spec), jfed.default_ownership(js)):
        assert a.tobytes() == b.tobytes()
    assert_same(state.hier, jst.hier, "init")
    owners = dict(user_broker=[2, 0, 1, 1, 0], fog_broker=[1, 2, 0, 0])
    assert_same(
        tfed.stamp_ownership(spec, state, **owners).hier,
        jfed.stamp_ownership(js, jst, **owners).hier, "stamped",
    )
    for bad in (dict(user_broker=[0, 0, 3, 0, 0]), dict(fog_broker=[0, 1])):
        with pytest.raises(ValueError, match="must be"):
            tfed.stamp_ownership(spec, state, **bad)
    one = tsmoke.build(device="cpu", horizon=0.05)
    with pytest.raises(ValueError, match="federated world"):
        tfed.stamp_ownership(one[0], one[1])
    reason = tengine.tp_reject_reason(spec)
    assert reason == jengine.tp_reject_reason(js) and reason.startswith("[TP-HIER]")
    with pytest.raises(ValueError, match=r"\[TP-HIER\]"):
        run_tp_sharded(spec, state, net, bounds, n_shards=2)
    assert tfed.hier_summary(one[0], None) is None
    assert tfed.hier_reject_reason(one[0]) is None
