"""The per-tick series (``engine.run`` with ``spec.record_tick_series``)
against JAX ``run``'s, bit for bit.

Every series key and the final state, on the smoke world, on a wireless
world with more than 32 nodes (``energy_mean`` is XLA's float32 sum in
windows of 32 times the reciprocal of the count; ``n_assoc`` the tick's
own association; ``pos`` the trails) and on a learned world (the
``learn_*`` keys).  The final state of a series run equals that of the
same run without series, in the port and in JAX.  A replica batch's
series (``run_batched``) equals JAX ``run_fleet_series`` on a one-device
mesh, the path of the CLI's ``--replicas R --ticks``.
"""
import jax
import numpy as np
import pytest
import torch

from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.parallel import make_mesh
from fognetsimpp_tpu.parallel import replicate_state as jreplicate
from fognetsimpp_tpu.parallel.fleet import run_fleet_series
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu.scenarios import wireless as jwireless
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.parallel import replicate_state as treplicate
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.scenarios import wireless as twireless
from fognetsimpp_tpu_torch.state import state_to_numpy


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


#: ``(JAX builder, port builder, kwargs)`` a world, each with the series on.
WORLDS = {
    "smoke": (jsmoke.build, tsmoke.build, dict(
        n_users=6, n_fogs=3, horizon=0.08, record_tick_series=True)),
    "wireless": (jwireless.wireless5, twireless.wireless5, dict(
        numb_users=40, horizon=0.3, record_tick_series=True, record_trails=True)),
}


def _leaves_equal(got, ref):
    assert len(got) == len(ref)
    return all(a.dtype == b.dtype and a.tobytes() == b.tobytes() for a, b in zip(got, ref))


def _jax_leaves(state):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


@pytest.fixture(scope="module")
def runs():
    """``name -> (jax final, jax series, port final, port series, spec)``."""
    out = {}

    def get(name):
        if name not in out:
            jb, tb, kw = WORLDS[name]
            jfinal, jseries = jengine.run(*jb(**kw))
            spec, st, net, b = tb(device="cpu", **kw)
            tfinal, tseries = tengine.run(spec, st, net, b)
            out[name] = (jfinal, jseries, tfinal, tseries, spec)
        return out[name]

    return get


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_series_and_final_state_match_jax(name, runs):
    jfinal, jseries, tfinal, tseries, spec = runs(name)
    assert _leaves_equal(state_to_numpy(tfinal), _jax_leaves(jfinal))
    assert list(tseries) == list(jseries)  # JAX's scan hands back sorted keys
    for k, v in jseries.items():
        want = np.asarray(v)
        got = tseries[k]
        assert got.device.type == "cpu" and got.shape[0] == spec.n_ticks, k
        assert got.numpy().dtype == want.dtype and got.numpy().shape == want.shape, k
        assert got.numpy().tobytes() == want.tobytes(), k
    if name == "wireless":
        assert spec.n_nodes > 32 and tseries["n_assoc"].sum() > 0
        assert len(np.unique(tseries["energy_mean"].numpy())) > 1
        assert tseries["pos"].shape == (spec.n_ticks, spec.n_nodes, 2)


@pytest.mark.parametrize("name", ["wireless"])
def test_series_on_leaves_the_final_state_as_off(name, runs):
    """The tick with its aux is the plain tick: the final state of a
    series run equals the series-off run's, in the port and in JAX."""
    jfinal, _, tfinal, _, _ = runs(name)
    jb, tb, kw = WORLDS[name]
    off = dict(kw, record_tick_series=False, record_trails=False)
    spec, st, net, b = tb(device="cpu", **off)
    t_off, none = tengine.run(spec, st, net, b)
    assert none is None
    assert _leaves_equal(state_to_numpy(t_off), state_to_numpy(tfinal))
    j_off, _ = jengine.run(*jb(**off))
    assert _leaves_equal(_jax_leaves(j_off), _jax_leaves(jfinal))


def test_replica_series_match_jax_fleet_series():
    """``run_batched``'s series, ``(R, n_ticks, ...)``, and final batch
    against JAX ``run_fleet_series`` on a one-device mesh."""
    kw = dict(n_users=6, n_fogs=3, horizon=0.05, start_time_max=0.02,
              record_tick_series=True)
    spec_j, st_j, net_j, b_j = jsmoke.build(**kw)
    jfinal, jseries = run_fleet_series(
        spec_j, jreplicate(spec_j, st_j, 3, seed=2), net_j, b_j, make_mesh(1))
    spec, st, net, b = tsmoke.build(device="cpu", **kw)
    tfinal, tseries = tengine.run_batched(spec, treplicate(spec, st, 3, seed=2), net, b)
    assert _leaves_equal(state_to_numpy(tfinal), _jax_leaves(jfinal))
    assert sorted(tseries) == sorted(jseries)
    for k, v in jseries.items():
        assert tseries[k].numpy().tobytes() == np.asarray(v).tobytes(), k
        assert tuple(tseries[k].shape[:2]) == (3, spec.n_ticks), k


def test_run_chunked_and_tp_keep_their_series_refusals():
    """``run_chunked`` collects no series and the TP tick records none:
    JAX's errors, word for word."""
    from fognetsimpp_tpu.parallel.taskshard import run_tp_sharded as jtp
    from fognetsimpp_tpu_torch.parallel.taskshard import run_tp_sharded as ttp

    kw = dict(n_users=4, n_fogs=2, horizon=0.02, record_tick_series=True)
    spec_j, st_j, net_j, b_j = jsmoke.build(**kw)
    spec, st, net, b = tsmoke.build(device="cpu", **kw)
    with pytest.raises(ValueError) as want:
        jengine.run_chunked(spec_j, st_j, net_j, b_j, chunk_ticks=5)
    with pytest.raises(ValueError) as got:
        tengine.run_chunked(spec, st, net, b, chunk_ticks=5)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jtp(spec_j, st_j, net_j, b_j, make_mesh(2, axis_name="node"))
    with pytest.raises(ValueError) as got:
        ttp(spec, st, net, b, n_shards=2)
    assert "[TP-SERIES]" in str(got.value) and str(got.value) == str(want.value)
