"""Task journeys in the fault worlds, port against JAX, on the CPU.

Chaos re-offloads and crash losses and broker migration, each journey
world against JAX ``run`` on every leaf, then the host readers
(``decode_rings``, ``journey_summary``, ``snapshot_rings``,
``rings_from_snapshot``, ``hier_summary``'s load lanes) on the same
final state.
"""
import dataclasses

import numpy as np
import pytest
import torch

from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.hier import federation as jfed
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu.spec import ChaosMode, HierPolicy
from fognetsimpp_tpu.telemetry import journeys as jjn
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.hier import federation as tfed
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.telemetry import journeys as tjn
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
TEL = dict(telemetry=True, telemetry_hist=True)
#: ``tests/test_journeys.py``'s acceptance world, cut to 60 ticks: domain
#: 0's slow fogs die mid-run, their tasks bounce back (REOFFLOAD), migrate
#: to domain 1 and complete.
CHAOS_HIER = dict(
    n_users=4, n_fogs=4, fog_mips=(2000.0, 2000.0, 60000.0, 60000.0),
    send_interval=0.02, horizon=0.06, dt=1e-3, seed=0, max_sends_per_user=12,
    n_brokers=2, hier_policy=int(HierPolicy.THRESHOLD), hier_threshold=0.5,
    hier_max_hops=2, assume_static=False, chaos=True, chaos_mode=REO,
    chaos_max_retries=8, chaos_script=((0, 0.03, 0.12), (1, 0.03, 0.12)),
    telemetry_journeys=48, telemetry_journey_ring=16, **TEL,
)
CH_OWNERS = dict(user_broker=[0] * 4, fog_broker=[0, 0, 1, 1])
WORLDS = {
    "chaos-hier": (CHAOS_HIER, CH_OWNERS, {"reoffload", "migrate", "decide", "done"}),
    # LOSE: a crash loses the tasks on the fog
    "chaos-lose": (
        dict(n_users=8, n_fogs=2, fog_mips=(40000.0, 80000.0), send_interval=0.01,
             horizon=0.06, assume_static=False, chaos=True, chaos_mode=LOSE,
             chaos_script=((0, 0.02, 0.048), (1, 0.032, 0.06)),
             telemetry_journeys=48, telemetry_journey_ring=32, **TEL),
        None, {"crash_lost", "spawn"},
    ),
}


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name):
        if name not in cache:
            kw, owners, _ = WORLDS[name]
            spec, st, net, b = tsmoke.build(device="cpu", **kw)
            js, jst, jn, jb = jsmoke.build(**kw)
            if owners:
                st = tfed.stamp_ownership(spec, st, **owners)
                jst = jfed.stamp_ownership(js, jst, **owners)
            final, _ = tengine.run(spec, st, net, b)
            jfinal, _ = jengine.run(js, jst, jn, jb)
            assert_same(final, jfinal, name)
            cache[name] = (spec, final, js, jfinal)
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_journey_world_matches_jax(runs, name):
    spec, final, _, _ = runs(name)
    seen = {e["name"] for d in tjn.decode_rings(spec, final) for e in d["events"]}
    assert WORLDS[name][2] <= seen, seen


def test_readers_equal_jax(runs):
    spec, final, js, jfinal = runs("chaos-hier")
    assert tjn.decode_rings(spec, final) == jjn.decode_rings(js, jfinal)
    assert tjn.journey_summary(spec, final) == jjn.journey_summary(js, jfinal)
    stamped, jstamped = (dataclasses.replace(s, tp_shards=2) for s in (spec, js))
    snap = tjn.snapshot_rings(final, stamped)
    assert snap == jjn.snapshot_rings(jfinal, jstamped) and "shard" in snap
    assert tjn.rings_from_snapshot(snap) == jjn.rings_from_snapshot(snap)
    assert tjn.journey_owner_shards(spec, final.telem.j_task) is None
    got = tfed.hier_summary(spec, final)
    want = jfed.hier_summary(js, jfinal)
    assert set(got) == set(want) and "load_mean" in got
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)
    assert tjn.EVENT_NAMES == jjn.EVENT_NAMES and tjn.J_COLS == jjn.J_COLS
    assert tjn.TERMINAL_EVENTS == jjn.TERMINAL_EVENTS
    assert tjn.BROKER_SIDE_EVENTS == jjn.BROKER_SIDE_EVENTS
    assert tjn.INF_BITS == jjn.INF_BITS
