"""The port's ``run`` against JAX ``engine.run``, every leaf, bit for bit.

One port run per world is held against the undonated JAX ``run`` with
``fused_slots`` on and off (the two JAX ticks are bit-identical,
``tests/test_fused.py``; the port carries the per-phase one).  A failure
names the first differing leaf and, by stepping both engines tick by
tick, the first tick at which the states part.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from fognetsimpp_tpu import Policy
from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.net.topology import associate as jassociate
from fognetsimpp_tpu.runtime.signals import summarize as jsummarize
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.net.topology import associate as tassociate
from fognetsimpp_tpu_torch.parallel.taskshard import run_tp_sharded
from fognetsimpp_tpu_torch.runtime.signals import summarize as tsummarize
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.state import state_to_numpy, tree_leaves


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


BENCH_SMALL = dict(
    n_users=256, n_fogs=8, fog_mips=(1000.0, 2000.0, 3000.0, 4000.0),
    send_interval=0.0025, horizon=0.1, max_sends_per_user=44,
    queue_capacity=128, start_time_max=0.025, derive_acks=True,
)

#: Each world with what it must exercise (checked on the port's result).
WORLDS = {
    # the smoke world itself (2 users, 2 fogs, dt 1 ms, acks in-tick)
    "smoke": dict(horizon=0.5),
    # the bench world cut to CPU size, dt 5 ms: multi-send spawn
    "bench_dt5ms": dict(BENCH_SMALL, dt=5e-3, max_sends_per_tick=2, arrival_window=1024),
    # dt 1 ms with a window smaller than a tick's arrivals: deferral
    "bench_dt1ms": dict(BENCH_SMALL, dt=1e-3, arrival_window=8),
    # tests/test_overflow.py's world on the dense broker: sustained
    # overflow of a K=8 window with rotated compaction, fast fogs
    "overflow": dict(
        horizon=0.5, send_interval=0.002, dt=1e-3, n_users=64, n_fogs=4,
        fog_mips=(50000.0,), policy=int(Policy.MIN_BUSY), arrival_window=8,
        queue_capacity=256, start_time_max=0.002,
    ),
    # tests/test_fused.py's saturated world: the candidate-list fast
    # drop; with send jitter and in-tick ack columns
    "saturated": dict(
        n_users=8, send_interval=0.004, dt=1e-3, horizon=0.5, n_fogs=3,
        fog_mips=(400.0, 800.0, 1200.0), queue_capacity=4,
        send_interval_jitter=0.1, derive_acks=False,
    ),
    # the v1/v2 MAX_MIPS scan on the dense broker: rejections; without
    # the static link cache (association every tick, two candidates a
    # user in the arrival front)
    "max_mips": dict(
        horizon=0.3, n_users=6, n_fogs=3, fog_mips=(300.0, 600.0, 900.0),
        send_interval=0.01, policy=int(Policy.MAX_MIPS), assume_static=False,
    ),
}

EXPECT = {
    "smoke": lambda s: s["n_scheduled"] > 0 and s["stage_queued"] > 0,
    "bench_dt5ms": lambda s: s["n_scheduled"] > 5_000 and s["n_dropped"] > 0,
    "bench_dt1ms": lambda s: s["n_deferred_max"] > 0 and s["n_dropped"] > 0,
    "overflow": lambda s: s["n_deferred_max"] > 0 and s["n_completed"] > 0,
    "saturated": lambda s: s["n_dropped"] > 0,
    "max_mips": lambda s: s["n_rejected"] > 0,
}


@pytest.fixture(scope="module")
def port_runs():
    """World name -> (spec, port final state), run once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            spec, state, net, bounds = tsmoke.build(device="cpu", **WORLDS[name])
            final, _ = tengine.run(spec, state, net, bounds)
            cache[name] = (spec, final)
        return cache[name]

    return get


def _first_diverging_tick(kw, fused):
    """Step both engines tick by tick; the first tick whose states differ
    and the leaf that differs first (before any ack finalisation)."""
    spec_j, st_j, net_j, b_j = jsmoke.build(fused_slots=fused, **kw)
    spec_t, st_t, net_t, b_t = tsmoke.build(device="cpu", **kw)
    step_j = jax.jit(jengine.make_step(spec_j))
    step_t = tengine.make_step(spec_t)
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


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("name", list(WORLDS))
def test_run_matches_jax_every_leaf(name, fused, port_runs):
    kw = WORLDS[name]
    spec_t, final_t = port_runs(name)
    spec_j, state_j, net_j, bounds_j = jsmoke.build(fused_slots=fused, **kw)
    assert dataclasses.asdict(spec_j) == dict(
        dataclasses.asdict(spec_t), fused_slots=fused
    )
    final_j, _ = jengine.run(spec_j, state_j, net_j, bounds_j)
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(final_j)]
    got = state_to_numpy(final_t)
    paths = [p for p, _ in tree_leaves(final_t)]
    assert len(ref) == len(got) == 144
    for p, a, b in zip(paths, ref, got):
        if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
            tick, leaf = _first_diverging_tick(kw, fused)
            raise AssertionError(
                f"{name} (fused_slots={fused}): leaf {p} differs "
                f"({a.dtype}{a.shape} vs {b.dtype}{b.shape}); the states "
                f"first part at tick {tick}, leaf {leaf}"
            )
    assert EXPECT[name](tsummarize(final_t)), f"{name} does not exercise its path"


def test_summarize_matches_jax(port_runs):
    spec_t, final_t = port_runs("smoke")
    spec_j, state_j, net_j, bounds_j = jsmoke.build(**WORLDS["smoke"])
    final_j, _ = jengine.run(spec_j, state_j, net_j, bounds_j)
    want, got = jsummarize(final_j), tsummarize(final_t)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k] == got[k] or (np.isnan(want[k]) and np.isnan(got[k])), k


#: ``bench.py::tp_measurement``'s world cut to CPU size, with tasks of
#: 2^22..2^23 MIPS on fogs of 10^9 MIPS: a tick's tasks to one fog sum
#: past 2^24, where a float32 sum rounds and its bits follow the order of
#: its adds, and the tasks still complete within the horizon.
BIG_MIPS = dict(
    n_users=512, n_fogs=8, fog_mips=(1e9,), send_interval=0.05, horizon=0.1,
    dt=5e-3, max_sends_per_user=6, max_sends_per_tick=1, queue_capacity=128,
    start_time_max=0.025, derive_acks=True,
    mips_required_min=2 ** 22, mips_required_max=2 ** 23,
)
#: The leaves that hold a fog's busy time: fogs.busy_time, and the copies
#: the adverts carry to the broker.
BUSY_LEAVES = ("fogs.busy_time", "broker.view_busy", "broker.adv_val_busy")


def test_mips_sums_past_2_24_part_from_jax_in_busy_time_only():
    """The port sums a tick's MIPS per fog in float64 and rounds once
    (``engine._mips_sum64``), on one device and across shards; JAX sums in
    float32.  Past 2^24 the two differ.  Here the difference reaches the
    busy-time leaves only, by at most two units in the last place of each
    value, and every other leaf (every decision, queue and task) is
    bit-equal."""
    spec_j, st_j, net_j, b_j = jsmoke.build(**BIG_MIPS)
    final_j, _ = jengine.run(spec_j, st_j, net_j, b_j)
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(final_j)]
    for runner in ("run", "run_tp_sharded"):
        spec, st, net, b = tsmoke.build(device="cpu", **BIG_MIPS)
        if runner == "run":
            final, _ = tengine.run(spec, st, net, b)
        else:
            _, final = run_tp_sharded(spec, st, net, b, n_shards=4)
        paths = [p for p, _ in tree_leaves(final)]
        parted = []
        for p, a, c in zip(paths, ref, state_to_numpy(final)):
            assert a.dtype == c.dtype and a.shape == c.shape, (runner, p)
            if a.tobytes() == c.tobytes():
                continue
            assert p in BUSY_LEAVES, f"{runner}: leaf {p} differs from JAX"
            assert (np.abs(a - c) <= 2 * np.spacing(np.abs(a))).all(), (runner, p)
            parted.append(p)
        assert "fogs.busy_time" in parted, f"{runner}: the sums stayed exact"
        s = tsummarize(final)
        assert s["n_completed"] > 0 and s["n_dropped"] > 0
