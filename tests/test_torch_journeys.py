"""Causal task journeys, port against JAX, on the CPU.

The journey sample (a prefix of a sort-based shuffle of the task slots,
at one and two shuffle rounds and at the bench world's 440,000 slots),
the ring append (drop-oldest overflow, and a tick with more edges than
the ring holds), a journey world with defers at a small arrival window
against JAX ``run`` on every leaf, the device tap against the host
replay, and the padding rule ``dynspec.bucket_spec`` relies on.  The
chaos and hier journey worlds and the host readers are in
``tests/test_torch_journeys_faults.py``.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.hier import federation as jfed
from fognetsimpp_tpu.parallel import taskshard as jts
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu.telemetry import journeys as jjn
from fognetsimpp_tpu_torch import dynspec as tdyn
from fognetsimpp_tpu_torch import random as trandom
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.hier import federation as tfed
from fognetsimpp_tpu_torch.parallel import taskshard as tts
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


@pytest.mark.parametrize("T, rounds", [(100, 1), (5000, 2), (440_000, 2)])
def test_sample_ids_match_jax(T, rounds):
    """``choice(fold_in(key, 0x10A7), T, (J,), replace=False)``, sorted,
    at one and two rounds of ``_shuffle``; at 440,000 slots some twenty
    pairs of draws tie and the stable sort keeps their order."""
    assert int(np.ceil(3 * np.log(T) / np.log(2.0 ** 32 - 1))) == rounds
    spec = SimpleNamespace(task_capacity=T, journey_slots=64)
    for seed in (0, 7):
        got = tjn.journey_sample_ids(spec, trandom.PRNGKey(seed))
        want = jjn.journey_sample_ids(spec, jax.random.PRNGKey(seed))
        assert got.dtype == torch.int32
        assert got.numpy().tobytes() == np.asarray(want).tobytes()
    key = trandom.fold_in(trandom.PRNGKey(3), 0x10A7)
    jkey = jax.random.fold_in(jax.random.PRNGKey(3), 0x10A7)
    assert np.array_equal(trandom.permutation(key, T).numpy(),
                          np.asarray(jax.random.permutation(jkey, T)))


SMALL = dict(n_users=2, n_fogs=2, send_interval=0.05, horizon=0.4)


def _telem_np(telem):
    return {f.name: getattr(telem, f.name).numpy() for f in dataclasses.fields(telem)}


def test_ring_overflow_matches_jax():
    """``tests/test_journeys.py``'s synthetic overflow: one ENQUEUE a tick
    for 13 ticks into rings of 8, eagerly on both sides; then one append
    of nine edges a slot into rings of 8, where JAX's in-order scatter
    keeps the last candidate of the doubly written position."""
    kw = dict(SMALL, telemetry=True, telemetry_journeys=2, telemetry_journey_ring=8)
    spec, st, _, _ = tsmoke.build(device="cpu", **kw)
    js, jst, _, _ = jsmoke.build(**kw)
    telem, tasks, jtelem, jtasks = st.telem, st.tasks, jst.telem, jst.tasks
    ids = telem.j_task.long()
    jids = jnp.asarray(ids.numpy())

    @jax.jit
    def jtick(te, tk, t):
        tk = tk.replace(t_q_enter=tk.t_q_enter.at[jids].set(t))
        return jjn.journey_tick(js, te, tk, t), tk

    for i in range(13):
        t = np.float32(0.001 * (i + 1))
        tasks = tasks.replace(t_q_enter=tasks.t_q_enter.index_fill(0, ids, float(t)))
        telem = tjn.journey_tick(spec, telem, tasks, torch.tensor(t))
        jtelem, jtasks = jtick(jtelem, jtasks, jnp.float32(t))
    assert int(telem.j_dropped) == 2 * (13 - 8)
    got, want = _telem_np(telem), jax.tree.map(np.asarray, jtelem)
    for name, v in got.items():
        assert v.tobytes() == np.asarray(getattr(want, name)).tobytes(), name
    # nine candidates a slot in one append: positions 0 and 8 collide
    J, E = 2, 9
    rng = np.random.default_rng(0)
    cols = [rng.integers(-5, 5000, (J, E)).astype(np.int32) for _ in range(4)]
    valid = np.ones((J, E), bool)
    cur = np.array(jtelem.j_prev)
    t_new, over = tjn._append_edges(
        telem, torch.from_numpy(cur), torch.from_numpy(valid),
        *(torch.from_numpy(c) for c in cols),
    )
    j_new, jover = jjn._append_edges(jtelem, jnp.asarray(cur), jnp.asarray(valid),
                                     *(jnp.asarray(c) for c in cols))
    assert int(over) == int(jover) == 2 * 9
    for name in ("j_prev", "j_ring", "j_cursor"):
        assert getattr(t_new, name).numpy().tobytes() == \
            np.asarray(getattr(j_new, name)).tobytes(), name


TEL = dict(telemetry=True, telemetry_hist=True)
WORLDS = {
    # one arrival seat a tick: matured arrivals defer, tick on tick,
    # and rings of 8 wrap
    "defer-ring8": (
        dict(n_users=16, n_fogs=3, send_interval=0.005, horizon=0.1,
             start_time_max=0.05, arrival_window=1, telemetry_journeys=16,
             telemetry_journey_ring=8, **TEL),
        None, {"defer", "enqueue"},
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
    if name == "defer-ring8":
        assert int(final.telem.j_dropped) > 0


def test_device_tap_matches_the_host_replay(runs):
    """The defer world stepped tick by tick: every tick's edges re-derived
    on the host by the same rule set over numpy, against the rings."""
    spec, final, _, _ = runs("defer-ring8")
    _, st, net, b = tsmoke.build(device="cpu", **WORLDS["defer-ring8"][0])
    step = tengine.make_step(spec)
    cache = tengine._static_cache(spec, net, st, fused=False)
    ids = st.telem.j_task

    def snap(s):
        return tjn.snapshot_rows(spec, s.tasks, s.chaos, s.hier, ids).numpy()

    expected = [[] for _ in range(ids.shape[0])]
    prev = snap(st)
    for i in range(spec.n_ticks):
        st = step(st, net, b, cache)
        cur = snap(st)
        t1 = float(np.float32(i + 1) * np.float32(spec.dt))
        for j, evs in enumerate(tjn.replay_tick(spec, prev, cur, ids, t1)):
            expected[j].extend(evs)
        prev = cur
    R = spec.journey_ring
    for j, d in enumerate(tjn.decode_rings(spec, st)):
        assert d["events_total"] == len(expected[j])
        assert d["events"] == expected[j][-R:]
    assert_same(st, state_leaves(final), "stepped")


def state_leaves(state):
    from fognetsimpp_tpu_torch.state import state_to_numpy

    return state_to_numpy(state)


def test_padding_keeps_the_sample():
    """``pad_users_to_multiple`` (and so ``dynspec.bucket_spec``) appends
    ghost rows at the table's end: the journey leaves stay as they were,
    the latency flags grow, and both equal JAX's padding."""
    kw = dict(SMALL, n_users=5, telemetry=True, telemetry_hist=True,
              telemetry_journeys=4)
    spec, st, net, _ = tsmoke.build(device="cpu", **kw)
    spec2, st2, _ = tts.pad_users_to_multiple(spec, st, net, 3)
    js, jst, jn, _ = jsmoke.build(**kw)
    _, jst2, _ = jts.pad_users_to_multiple(js, jst, jn, 3)
    assert spec2.n_users == 6 and spec2.journey_slots == spec.journey_slots
    assert torch.equal(st2.telem.j_task, st.telem.j_task)
    assert st2.telem.lat_seen.shape == (spec2.task_capacity,)
    assert_same(st2, jst2, "padded")
    spec3, st3, _ = tdyn.bucket_spec(spec, st, net, floor=4)
    assert spec3.n_users == 6 and torch.equal(st3.telem.j_task, st.telem.j_task)
