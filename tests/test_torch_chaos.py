"""Chaos fault injection, port against JAX (``tests/test_chaos.py``'s
gates at a small size).

The schedule kernels (``step_lifecycle``, ``rtt_factor``) are held
against JAX tick by tick, the host replay against the device schedule,
and whole chaos worlds (random and scripted outages, RTT waves and
bursts, LOSE and REOFFLOAD, dense and compacted brokers, learned
policies) against undonated JAX ``run`` on every leaf (dtype, shape,
bits); then the promoted retune of ``run_chunked``, a replica batch and
a ``sweep_dyn`` grid over the MTBF.  Each JAX oracle runs once a module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fognetsimpp_tpu import Policy
from fognetsimpp_tpu.chaos import faults as jfaults
from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.dynspec import dyn_of as jdyn_of
from fognetsimpp_tpu.parallel import replicas as jreplicas
from fognetsimpp_tpu.parallel import sweep as jsweep
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu.spec import ChaosMode, Stage
from fognetsimpp_tpu_torch import dynspec as tdyn
from fognetsimpp_tpu_torch.chaos import faults as tfaults
from fognetsimpp_tpu_torch.chaos import profiles as tprofiles
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.parallel import replicas as treplicas
from fognetsimpp_tpu_torch.parallel import sweep as tsweep
from fognetsimpp_tpu_torch.parallel.replicas import strict_vmap
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.state import state_from_numpy, state_to_numpy
from tests.test_torch_v1v2 import assert_same


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


REO, LOSE = int(ChaosMode.REOFFLOAD), int(ChaosMode.LOSE)
SMALL = dict(n_users=8, n_fogs=3, fog_mips=(40000.0, 80000.0),
             send_interval=0.01, horizon=0.2, assume_static=False)
#: Random churn, a scripted outage, the RTT wave and its bursts at once.
ACTIVE = dict(
    SMALL, chaos=True, chaos_mode=REO, chaos_mtbf_s=0.05, chaos_mttr_s=0.02,
    chaos_max_retries=3, chaos_script=((1, 0.05, 0.1),), chaos_rtt_amp=0.5,
    chaos_rtt_burst_prob=0.05,
)
LEARNED = dict(derive_acks=False, learn_explore=0.1)
WORLDS = {
    "min_busy": ACTIVE,
    "random": dict(ACTIVE, policy=int(Policy.RANDOM)),
    "exp3": dict(ACTIVE, policy=int(Policy.EXP3), **LEARNED),
    "ucb": dict(ACTIVE, policy=int(Policy.UCB), **LEARNED),
    # LOSE with a learner: every swept pick resolves as a penalty
    "lose": dict(
        SMALL, n_fogs=2, chaos=True, chaos_mode=LOSE, policy=int(Policy.DUCB),
        chaos_script=((0, 0.05, 0.12), (1, 0.08, 0.15)), **LEARNED,
    ),
    # a budget of no retries: the first sweep loses the task
    "exhausted": dict(
        SMALL, n_fogs=1, chaos=True, chaos_mode=REO, chaos_max_retries=0,
        chaos_script=((0, 0.05, 0.15),),
    ),
    # chaos on with no fault source: read-only
    "inert": dict(SMALL, chaos=True),
}


def _census(final) -> dict:
    stage = final.tasks.stage.numpy()
    return {s.name: int((stage == int(s)).sum()) for s in Stage}


@pytest.fixture(scope="module")
def runs():
    """``name -> (spec, port final)``, each checked against JAX ``run``
    on every leaf the first time it is asked for."""
    cache = {}

    def get(name):
        if name not in cache:
            kw = WORLDS[name]
            spec, state, net, bounds = tsmoke.build(device="cpu", **kw)
            final, _ = tengine.run(spec, state, net, bounds)
            js, jst, jn, jb = jsmoke.build(**kw)
            assert_same(final, jengine.run(js, jst, jn, jb)[0], name)
            cache[name] = (spec, final)
        return cache[name]

    return get


# ----------------------------------------------------------------------
# the schedule kernels
# ----------------------------------------------------------------------

def _chaos_np(ch):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(ch)]


@pytest.mark.parametrize("promote", [False, True], ids=["static", "operand"])
def test_step_lifecycle_and_rtt_factor_match_jax(promote):
    """Tick by tick over 200 ticks of random churn under two scripted
    outages (one overlapping a random outage): every chaos leaf, the
    edges, the edge times and the RTT factor, with the spec's knobs as
    host constants or as the promoted operand."""
    kw = dict(ACTIVE, chaos_script=((0, 0.02, 0.06), (2, 0.1, 0.15)),
              chaos_rtt_burst_prob=0.3)
    js, jst, _, _ = jsmoke.build(**kw)
    ts, tst, _, _ = tsmoke.build(device="cpu", **kw)
    jdv = jax.tree.map(jnp.asarray, jdyn_of(js)) if promote else None
    tdv = tdyn.dyn_to_device(tdyn.dyn_of(ts), "cpu") if promote else None
    step_j = jax.jit(lambda ch, up, tick, dv: _jax_tick(js, ch, up, tick, dv))
    jch, tch = jst.chaos, tst.chaos
    up_j = jnp.ones((3,), bool)
    up_t = torch.ones((3,), dtype=torch.bool)
    edges = 0
    for tick in range(ts.n_ticks):
        t0 = torch.tensor(tick, dtype=torch.int32).to(torch.float32) * np.float32(ts.dt)
        t1 = torch.tensor(tick + 1, dtype=torch.int32).to(torch.float32) * np.float32(ts.dt)
        jch, jout, jfac = step_j(jch, up_j, jnp.int32(tick), jdv)
        tch, *tout = tfaults.step_lifecycle(ts, tch, up_t, t0, t1, tdv)
        tfac = tfaults.rtt_factor(ts, tch, torch.tensor(tick, dtype=torch.int32), t0, tdv)
        assert [a.tobytes() for a in _chaos_np(jch)] == [
            a.tobytes() for a in state_to_numpy(tch)
        ], tick
        for a, b in zip(jout, tout):
            assert np.asarray(a).tobytes() == b.numpy().tobytes(), tick
        assert np.asarray(jfac).tobytes() == tfac.numpy().tobytes(), tick
        up_j, up_t = jout[0], tout[0]
        edges += int(tout[1].sum()) + int(tout[2].sum())
    assert int(tch.n_crashes) >= 4 and edges >= 8


def _jax_tick(spec, ch, up, tick, dv):
    t0 = tick.astype(jnp.float32) * spec.dt
    t1 = (tick + 1).astype(jnp.float32) * spec.dt
    ch, *out = jfaults.step_lifecycle(spec, ch, up, t0, t1, dyn=dv)
    return ch, out, jfaults.rtt_factor(spec, ch, tick, t0, dyn=dv)


def test_outage_timeline_replays_the_device_schedule():
    """The host replay reads the device machine's stream: its outages
    give every fog's ticks down, and it equals JAX's replay."""
    kw = dict(SMALL, chaos=True, chaos_mtbf_s=0.04, chaos_mttr_s=0.02,
              chaos_seed=7, horizon=0.5, chaos_script=((2, 0.3, 0.35),))
    spec, state, _, _ = tsmoke.build(device="cpu", **kw)
    ch, up = state.chaos, torch.ones((3,), dtype=torch.bool)
    for tick in range(spec.n_ticks):
        t0 = torch.tensor(tick, dtype=torch.int32).to(torch.float32) * np.float32(spec.dt)
        t1 = torch.tensor(tick + 1, dtype=torch.int32).to(torch.float32) * np.float32(spec.dt)
        ch, up, *_ = tfaults.step_lifecycle(spec, ch, up, t0, t1)
    timeline = tfaults.outage_timeline(spec, ch.key)
    t1s = (np.arange(spec.n_ticks) + 1).astype(np.float32) * np.float32(spec.dt)
    expect = np.zeros(3, np.int64)
    down = np.zeros((3, spec.n_ticks), bool)
    for f, td, tu in timeline:
        down[f] |= (np.float32(td) < t1s) & (np.float32(tu) >= t1s)
    expect = down.sum(axis=1)
    np.testing.assert_array_equal(ch.down_ticks.numpy(), expect)
    assert len(timeline) >= 6
    js = jsmoke.build(**kw)[0]
    assert timeline == jfaults.outage_timeline(js, np.asarray(ch.key.numpy(), np.uint32))


def test_profiles_and_script_parser_are_the_references():
    from fognetsimpp_tpu.chaos import profiles as jprofiles

    assert tprofiles.PROFILES == jprofiles.PROFILES
    script = "0:0.1:0.3; 2:0.5:0.75"
    assert tprofiles.parse_script(script) == jprofiles.parse_script(script)
    for name in tprofiles.PROFILES:
        assert tprofiles.chaos_config_lines(name, seed=3, mode="lose", script=script) == (
            jprofiles.chaos_config_lines(name, seed=3, mode="lose", script=script)
        )
    with pytest.raises(ValueError, match="unknown chaos profile"):
        tprofiles.resolve_profile("nope")


# ----------------------------------------------------------------------
# whole worlds against JAX run
# ----------------------------------------------------------------------

def _assert_conserved(final):
    c = _census(final)
    published = int(final.metrics.n_published)
    terminal = c["DONE"] + c["DROPPED"] + c["LOST"] + c["NO_RESOURCE"] + c["REJECTED"]
    in_flight = (
        c["PUB_INFLIGHT"] + c["TASK_INFLIGHT"] + c["QUEUED"] + c["RUNNING"]
        + c["LOCAL_RUN"]
    )
    assert published == terminal + in_flight, c
    assert c["DONE"] == int(final.metrics.n_completed)


def _credit_exactly_once(final):
    """Every pick resolves at most once: credited rows are the observed
    acks plus the crash penalties (``tests/test_chaos.py:308-323``)."""
    ch = final.chaos
    reward_cnt = float(final.learn.reward_cnt.double().sum())
    penalties = float(ch.n_lost_crash + ch.n_reoffloaded + ch.n_retry_exhausted)
    assert reward_cnt == pytest.approx(float(final.learn.lat_cnt) + penalties)
    assert reward_cnt <= float(final.learn.pick_count.double().sum()) + 1e-6


@pytest.mark.parametrize("name", ["min_busy", "random", "exp3", "ucb"])
def test_reoffload_world_matches_jax_every_leaf(name, runs):
    spec, final = runs(name)
    ch = final.chaos
    assert int(ch.n_crashes) > 0 and int(ch.n_recovers) > 0
    assert int(ch.n_reoffloaded) > 0 and int(ch.n_lost_crash) == 0
    _assert_conserved(final)
    if spec.learn_active:
        _credit_exactly_once(final)
        assert float(final.learn.lat_cnt) > 0


def test_lose_world_matches_jax_and_resolves_every_loss_once(runs):
    spec, final = runs("lose")
    lost = int(final.chaos.n_lost_crash)
    assert lost > 0 and _census(final)["LOST"] == lost
    assert int(final.metrics.n_lost) == 0
    _credit_exactly_once(final)
    lost_rows = final.tasks.stage.numpy() == int(Stage.LOST)
    assert (final.learn.credited.numpy()[lost_rows] == 1).all()
    _assert_conserved(final)


def test_spent_retry_budget_loses_the_task(runs):
    _, final = runs("exhausted")
    ch = final.chaos
    assert int(ch.n_retry_exhausted) > 0
    assert int(ch.n_reoffloaded) == 0 and int(ch.n_lost_crash) == 0
    assert _census(final)["LOST"] == int(ch.n_retry_exhausted)


def test_chaos_off_and_inert_chaos_leave_the_world_as_it_was(runs):
    """chaos off: every chaos leaf is zero-row and the world is JAX's;
    chaos on without a fault source: every other leaf is the chaos-off
    world's, bit for bit (the chaos key is folded, not split)."""
    spec, state, net, bounds = tsmoke.build(device="cpu", **SMALL)
    off, _ = tengine.run(spec, state, net, bounds)
    assert off.chaos.next_down.shape == (0,) and off.chaos.retry.shape == (0,)
    js, jst, jn, jb = jsmoke.build(**SMALL)
    assert_same(off, jengine.run(js, jst, jn, jb)[0], "chaos off")
    _, inert = runs("inert")
    same = state_to_numpy(inert.replace(chaos=off.chaos))
    assert [x.tobytes() for x in same] == [x.tobytes() for x in state_to_numpy(off)]
    assert int(inert.chaos.n_crashes) == 0 and int(inert.chaos.n_reoffloaded) == 0


def test_run_chunked_retunes_the_chaos_knobs_as_jax_does():
    """A promoted chunked run retuned at tick 60 (the MTBF and the RTT
    amplitude) equals JAX ``run_chunked`` with the same retune."""
    kw = dict(ACTIVE, horizon=0.12)
    knobs = {"chaos_mtbf_s": 0.02, "chaos_rtt_amp": 1.5}

    def retune(done):
        return knobs if done == 60 else None

    spec, state, net, bounds = tsmoke.build(device="cpu", **kw)
    got = tengine.run_chunked(spec, state, net, bounds, chunk_ticks=30,
                              reconfigure=retune)
    js, jst, jn, jb = jsmoke.build(**kw)
    want = jengine.run_chunked(js, jst, jn, jb, 30, callback=lambda s, d: None,
                               reconfigure=retune)
    assert_same(got, want, "chunked retune")
    spec2, state2, net2, bounds2 = tsmoke.build(device="cpu", **kw)
    plain = tengine.run_chunked(spec2, state2, net2, bounds2, chunk_ticks=30)
    assert int(got.chaos.n_crashes) != int(plain.chaos.n_crashes)


# ----------------------------------------------------------------------
# the replica axis
# ----------------------------------------------------------------------

#: The replica worlds: churn and a scripted outage (first), and the RTT
#: terms as well (second).
REPLICA_WORLDS = [
    dict(ACTIVE, chaos_rtt_amp=0.0, chaos_rtt_burst_prob=0.0, horizon=0.1,
         start_time_max=0.02),
    dict(ACTIVE, horizon=0.06, start_time_max=0.02),
]


def test_chaos_replica_batch_matches_jax():
    """Four replicas, each re-keyed onto ``fold_in(chaos_key, r)``: the
    batch equals JAX ``replicate_state`` + ``run_replicated`` (a vmap of
    ``run``) on every leaf.  With the RTT terms, JAX's vmapped program
    contracts the degraded delay into a multiply-add that its one-world
    program does not (ROADMAP.md §3), so that batch is held to JAX
    ``run`` of its first and last replicas' rows, the reference's own
    contract."""
    kw = REPLICA_WORLDS[0]
    spec, state, net, bounds = tsmoke.build(device="cpu", **kw)
    batch = treplicas.replicate_state(spec, state, 4)
    js, jst, jn, jb = jsmoke.build(**kw)
    jbatch = jreplicas.replicate_state(js, jst, 4)
    assert_same(batch, jbatch, "replicated chaos rows")
    with strict_vmap():
        final = treplicas.run_replicated(spec, batch, net, bounds)
    assert_same(final, jreplicas.run_replicated(js, jbatch, jn, jb), "chaos batch")
    crashes = final.chaos.n_crashes.numpy()
    assert (crashes > 0).all() and len(set(crashes.tolist())) > 1

    kw = REPLICA_WORLDS[1]
    spec, state, net, bounds = tsmoke.build(device="cpu", **kw)
    batch = treplicas.replicate_state(spec, state, 4)
    with strict_vmap():
        final = treplicas.run_replicated(spec, batch, net, bounds)
    js, jst, jn, jb = jsmoke.build(**kw)
    jbatch = jreplicas.replicate_state(js, jst, 4)
    for r in (0, 3):
        row = jax.tree.map(lambda x, r=r: x[r], jbatch)
        want = jengine.run(js, row, jn, jb)[0]
        got = state_from_numpy([x[r] for x in state_to_numpy(final)], "cpu")
        assert_same(got, want, f"replica {r}")


def test_sweep_dyn_over_the_mtbf_matches_jax():
    """A ``sweep_dyn`` grid over ``chaos_mtbf_s`` (two cells, two
    replicas each): each cell's init-time schedule is its own, and the
    counters equal JAX's grid."""
    kw = dict(ACTIVE, chaos_rtt_amp=0.0, chaos_rtt_burst_prob=0.0, horizon=0.06)
    knobs = {"chaos_mtbf_s": [0.02, 0.2]}
    got = tsweep.sweep_dyn(tsmoke.build, knobs, n_replicas_per_cell=2,
                           device="cpu", **kw)
    want = jsweep.sweep_dyn(jsmoke.build, knobs, n_replicas_per_cell=2, **kw)
    assert [c["chaos_mtbf_s"] for c in got] == [0.02, 0.2]
    for g, w in zip(got, want):
        assert set(g["counters"]) == set(w["counters"])
        for k, v in w["counters"].items():
            assert np.asarray(v).tobytes() == g["counters"][k].tobytes(), k
    _, _, batch, _, _, _ = tsweep.dyn_batch(tsmoke.build, knobs, 2, device="cpu", **kw)
    spec0 = tsmoke.build(device="cpu", **dict(kw, chaos_mtbf_s=0.2))
    direct = treplicas.replicate_state(spec0[0], spec0[1], 2)
    # cell 1's rows start where a direct build of its spec starts
    assert torch.equal(batch.chaos.next_down[2:], direct.chaos.next_down)
