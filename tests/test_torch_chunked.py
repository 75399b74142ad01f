"""The port's chunked runner against the JAX package, bit for bit.

``run_chunked`` in chunks of 7 and of 13 ticks (a ragged tail), with and
without promotion, against JAX's undonated ``run_chunked`` on the same
world, every leaf; ``reconfigure`` against JAX's and against the manual
composition of ``apply_knobs`` between runs; its refusals against JAX's
text and the items that will lift the rest; states a callback keeps stay
as they were handed over.  A learned world at a reward scale of 0.3,
past its first credits, pins the reference's two arithmetic modes: JAX's
promoted chunked run parts from its ``run`` in exactly the reward sums
and the EXP3 weights, and the port's two paths part in the same leaves.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from fognetsimpp_tpu import Policy
from fognetsimpp_tpu import dynspec as jdyn
from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu.scenarios import wireless as jw
from fognetsimpp_tpu_torch import dynspec as tdyn
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.scenarios import wireless as tw
from fognetsimpp_tpu_torch.state import state_to_numpy, tree_leaves


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are small: one thread beside the other
    test workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


#: A small wireless5 with batteries that matter: the energy knobs are
#: retuned between chunks.
WIRELESS = dict(
    numb_users=24, horizon=0.5, dt=0.01, extra_aps=4,
    policy=int(Policy.ENERGY_AWARE), idle_power_w=3e-3,
    harvest_period_s=0.07, harvest_duty=0.4, shutdown_frac=0.2,
)
RETUNE = {"idle_power_w": 8e-3, "shutdown_frac": 0.4}
#: A wired world with the uplink-loss gate on, a finite stop time and the
#: ack columns derived after each chunk.
SMOKE = dict(
    n_users=16, n_fogs=3, send_interval=0.01, horizon=0.1, start_time_max=0.02,
    uplink_loss_prob=0.05, send_stop_time=0.08, derive_acks=True,
)


def _jleaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _differing(port_tree, ref_leaves):
    paths = [p for p, _ in tree_leaves(port_tree)]
    got = state_to_numpy(port_tree)
    assert len(got) == len(ref_leaves) == len(paths)
    out = []
    for p, a, b in zip(paths, got, ref_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        if a.tobytes() != b.tobytes():
            out.append(p)
    return out


def _noop(state, done):
    """A callback: JAX's chunked runner then takes its undonated program
    (the donated one is not a usable oracle on this tree, ROADMAP §3)."""


def _retune_at(first: int):
    """A ``reconfigure`` that retunes at the first boundary at or past
    ``first`` and records every boundary it is asked at."""
    calls = []

    def reconfigure(done):
        calls.append(done)
        hit = done >= first and all(c < first for c in calls[:-1])
        return RETUNE if hit else None

    return reconfigure, calls


@pytest.mark.parametrize("chunk", [7, 13])
def test_reconfigure_matches_jax_and_the_manual_composition(chunk):
    jspec, jst, jnet, jb = jw.wireless5(**WIRELESS)
    jrec, _ = _retune_at(20)
    ref = jengine.run_chunked(jspec, jst, jnet, jb, chunk_ticks=chunk,
                              reconfigure=jrec, callback=_noop)
    spec, st, net, b = tw.wireless5(device="cpu", **WIRELESS)
    rec, calls = _retune_at(20)
    got = tengine.run_chunked(spec, st, net, b, chunk_ticks=chunk, reconfigure=rec)
    assert _differing(got, _jleaves(ref)) == []
    total = spec.n_ticks
    assert calls == list(range(chunk, total, chunk))  # interior boundaries only
    at = next(c for c in calls if c >= 20)
    # the manual composition: the key with the first knobs, then retuned
    key, dyn = tdyn.split_spec(spec)
    mid, _ = tengine.run(key, st, net, b, n_ticks=at, dyn=tdyn.dyn_to_device(dyn, "cpu"))
    dyn2 = tdyn.dyn_to_device(tdyn.dyn_of(tdyn.apply_knobs(spec, RETUNE)), "cpu")
    manual, _ = tengine.run(key, mid, net, b, n_ticks=total - at, dyn=dyn2)
    assert _differing(got, state_to_numpy(manual)) == []
    # the retune reached the tick
    plain = tengine.run_chunked(spec, st, net, b, chunk_ticks=chunk)
    assert _differing(got, state_to_numpy(plain)) != []


@pytest.mark.parametrize("promote", [True, False])
def test_run_chunked_matches_jax_with_derived_acks(promote):
    jspec, jst, jnet, jb = jsmoke.build(**SMOKE)
    ref = jengine.run_chunked(jspec, jst, jnet, jb, chunk_ticks=13,
                              promote=promote, callback=_noop)
    spec, st, net, b = tsmoke.build(device="cpu", **SMOKE)
    got = tengine.run_chunked(spec, st, net, b, chunk_ticks=13, promote=promote)
    assert _differing(got, _jleaves(ref)) == []
    one, _ = tengine.run(spec, st, net, b)
    assert _differing(got, state_to_numpy(one)) == []


def test_callback_states_survive_the_later_chunks():
    spec, st, net, b = tsmoke.build(device="cpu", **dict(SMOKE, horizon=0.02))
    kept = []
    tengine.run_chunked(spec, st, net, b, chunk_ticks=7,
                        callback=lambda s, done: kept.append((done, s, state_to_numpy(s))))
    assert [d for d, _, _ in kept] == [7, 14, 20]
    for done, s, snap in kept:
        assert int(s.tick) == done
        assert all(a.tobytes() == c.tobytes() for a, c in zip(state_to_numpy(s), snap))


def test_gate_flip_raises_the_reference_text():
    jspec = jsmoke.build(**SMOKE)[0]
    spec, st, net, b = tsmoke.build(device="cpu", **SMOKE)
    flip = {"uplink_loss_prob": 0.0}
    with pytest.raises(ValueError) as je:
        jdyn.apply_knobs(jspec, flip)
    with pytest.raises(ValueError) as te:
        tengine.run_chunked(spec, st, net, b, chunk_ticks=5, reconfigure=lambda d: flip)
    assert str(te.value) == str(je.value)
    assert "flips a trace gate" in str(te.value)


def _value_error(fn, *args, **kwargs):
    with pytest.raises(ValueError) as e:
        fn(*args, **kwargs)
    return str(e.value)


def test_refusals_match_jax_and_name_their_items():
    jspec, jst, jnet, jb = jsmoke.build(**SMOKE)
    spec, st, net, b = tsmoke.build(device="cpu", **SMOKE)
    no_promote = dict(chunk_ticks=5, promote=False, reconfigure=lambda d: None)
    assert _value_error(tengine.run_chunked, spec, st, net, b, **no_promote) == \
        _value_error(jengine.run_chunked, jspec, jst, jnet, jb, **no_promote)
    series = dict(chunk_ticks=5)
    assert _value_error(
        tengine.run_chunked, dataclasses.replace(spec, record_tick_series=True),
        st, net, b, **series,
    ) == _value_error(
        jengine.run_chunked, dataclasses.replace(jspec, record_tick_series=True),
        jst, jnet, jb, **series,
    )
    # the reservoir stream (item 14) is ported: it refuses a telemetry-off
    # spec as JAX does, and streams JAX's rows from a telemetry-on one
    stream = dict(chunk_ticks=40, telemetry_stream=lambda rows, d: None)
    assert _value_error(tengine.run_chunked, spec, st, net, b, **stream) == \
        _value_error(jengine.run_chunked, jspec, jst, jnet, jb, **stream)
    tel = dict(SMOKE, telemetry=True)
    got, want = [], []
    spec, st, net, b = tsmoke.build(device="cpu", **tel)
    tengine.run_chunked(spec, st, net, b, 40,
                        telemetry_stream=lambda rows, d: got.append((rows, d)))
    jspec, jst, jnet, jb = jsmoke.build(**tel)
    jengine.run_chunked(jspec, jst, jnet, jb, 40, callback=lambda s, d: None,
                        telemetry_stream=lambda rows, d: want.append((rows, d)))
    assert [d for _, d in got] == [d for _, d in want] == [40, 80, 100]
    for (g, _), (w, _) in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].tobytes() == np.asarray(w[k]).tobytes(), k
    # the twin's inject hook (item 16) is ported: an injection at each
    # interior boundary, after reconfigure, equals JAX's
    kw = dict(SMOKE, ingest=True, ingest_batch=4)
    spec, st, net, b = tsmoke.build(device="cpu", **kw)
    jspec, jst, jnet, jb = jsmoke.build(**kw)
    rows = {40: ([0, 1, 1], [500.0, 250.5, 90.0]), 80: ([2], [1000.0])}
    seen = []

    def hook(inject_fn, sp, nt):
        def inject(s, done):
            seen.append(done)
            if done not in rows:
                return s
            return inject_fn(sp, s, nt, *rows[done])[0]
        return inject

    got = tengine.run_chunked(spec, st, net, b, 40,
                              inject=hook(tengine.inject_arrivals, spec, net))
    want = jengine.run_chunked(jspec, jst, jnet, jb, 40, callback=lambda s, d: None,
                               inject=hook(jengine.inject_arrivals, jspec, jnet))
    assert seen == [40, 80] * 2  # interior boundaries, each run
    assert _differing(got, _jleaves(want)) == []
    assert int(got.metrics.n_published) > int(
        tengine.run_chunked(spec, st, net, b, 40).metrics.n_published)


#: A learned world whose credits land and whose reward scale 0.3 is not a
#: power of two: 64 users, 4 fogs of 20,000/30,000 MIPS, UCB, 10 ms sends,
#: 0.3 s of 1 ms ticks.
LEARNED = dict(
    n_users=64, n_fogs=4, fog_mips=(20000.0, 30000.0), send_interval=0.01,
    horizon=0.3, derive_acks=False, policy=int(Policy.UCB),
    learn_reward_scale=0.3,
)
#: Where XLA's division by the operand parts from its reciprocal product.
PARTED = ["learn.reward_sum", "learn.disc_sum", "learn.logw"]


def test_the_two_arithmetic_modes_part_as_jax_does():
    jspec, jst, jnet, jb = jsmoke.build(**LEARNED)
    j_static, _ = jengine.run(jspec, jst, jnet, jb)
    j_promoted = jengine.run_chunked(jspec, jst, jnet, jb, chunk_ticks=40,
                                     promote=True, callback=_noop)
    j_static, j_promoted = _jleaves(j_static), _jleaves(j_promoted)
    spec, st, net, b = tsmoke.build(device="cpu", **LEARNED)
    static, _ = tengine.run(spec, st, net, b)
    assert float(static.learn.lat_cnt.sum()) > 0  # past the first credits
    assert _differing(static, j_static) == []
    promoted = tengine.run_chunked(spec, st, net, b, chunk_ticks=40)
    assert _differing(promoted, j_promoted) == []
    # JAX's two paths part in exactly these leaves, and so do the port's
    assert _differing(static, j_promoted) == PARTED
    assert _differing(promoted, state_to_numpy(static)) == PARTED
