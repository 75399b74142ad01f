"""The TP tick's telemetry, port against JAX, on the CPU.

``run_tp_sharded`` with the telemetry plane, the latency histogram and
journeys on, against JAX ``run_tp_sharded`` on the conftest's CPU mesh:
the stamped shard axis, the per-shard exchange gauges, the phase brackets
(each shard its partial share, shard 0 the replicated one), the
histogram's per-shard deltas and the journeys stitched back by owner.
Every leaf is bit-equal but ``telem.lat_sum``, whose float32 sum over the
shards JAX documents as agreeing to 1e-6 (``tests/test_tp_telemetry.py``).
Then ``run_tp_chunked``, the readers and ``unstamp_tp_carry``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from fognetsimpp_tpu.parallel import make_mesh
from fognetsimpp_tpu.parallel import taskshard as jts
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu.telemetry import metrics as jmetrics
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.parallel import taskshard as tts
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.state import state_to_numpy, tree_leaves
from fognetsimpp_tpu_torch.telemetry import metrics as tmetrics


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


#: The leaf the reference holds to 1e-6 under TP, not to its bits.
LOOSE = "telem.lat_sum"
SMALL = dict(n_users=16, n_fogs=3, send_interval=0.01, horizon=0.2, start_time_max=0.05)
TEL = dict(telemetry=True, telemetry_hist=True, telemetry_journeys=16,
           telemetry_journey_ring=16)
N_TICKS = 40
CASES = {
    # the ring exchange bounded at two candidates a shard: overflow, the
    # age gauge and the tp_defer slot
    "ring-2": (dict(SMALL, fog_mips=(100000.0,), **TEL), 2, dict(exchange_window=2)),
    # a windowed spec: the distributed top-K merge; bit-equal to the
    # single-device engine
    "window-4": (dict(SMALL, fog_mips=(100000.0,), arrival_window=2, **TEL), 4, {}),
}


def _jleaves(state):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


def assert_tp_same(got, ref_leaves, what):
    paths = [p for p, _ in tree_leaves(got)]
    assert len(paths) == len(ref_leaves)
    for p, b, a in zip(paths, ref_leaves, state_to_numpy(got)):
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what}: {p}"
        if p == LOOSE:
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=what)
        else:
            assert a.tobytes() == b.tobytes(), f"{what}: leaf {p} differs"


@pytest.fixture(scope="module")
def tp_runs():
    cache = {}

    def get(name):
        if name not in cache:
            kw, n, extra = CASES[name]
            spec, st, net, b = tsmoke.build(device="cpu", **kw)
            spec2, got = tts.run_tp_sharded(spec, st, net, b, n_shards=n,
                                            n_ticks=N_TICKS, **extra)
            js, jst, jn, jb = jsmoke.build(**kw)
            jspec2, ref = jts.run_tp_sharded(js, jst, jn, jb, make_mesh(n, axis_name="node"),
                                             n_ticks=N_TICKS, **extra)
            assert spec2.tp_shards == jspec2.tp_shards == n
            assert_tp_same(got, _jleaves(ref), name)
            cache[name] = (spec2, got, jspec2, ref)
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_telemetry_matches_jax(tp_runs, name):
    spec, got, jspec, ref = tp_runs(name)
    t = got.telem
    assert int(t.ticks) == N_TICKS
    assert int(t.phase_work[tmetrics.PHASE_INDEX["tp_exchange"]]) > 0
    assert int(t.j_cursor.sum()) > 0
    assert int(t.lat_hist.sum()) > 0
    assert int(t.exg_defer_sum.sum()) > 0 and float(t.exg_age_max.max()) > 0
    if name == "ring-2":
        assert int(t.phase_work[tmetrics.PHASE_INDEX["tp_defer"]]) > 0
    got_x = tmetrics.exchange_summary(spec, got)
    want_x = jmetrics.exchange_summary(jspec, ref)
    assert set(got_x) == set(want_x)
    for k, v in want_x.items():
        np.testing.assert_array_equal(np.asarray(got_x[k]), np.asarray(v), err_msg=k)


def test_phase_work_under_tp_equals_the_single_device_profile(tp_runs):
    """Every slot but the two TP-only ones equals the port's own
    single-device run of the same world (``test_tp_telemetry.py``'s pin)."""
    spec, got, _, _ = tp_runs("window-4")
    kw, _, _ = CASES["window-4"]
    s, st, net, b = tsmoke.build(device="cpu", **kw)
    one, _ = tengine.run(s, st, net, b, n_ticks=N_TICKS)
    tp_only = {tmetrics.PHASE_INDEX["tp_exchange"], tmetrics.PHASE_INDEX["tp_defer"]}
    keep = [i for i in range(len(tmetrics.PHASES)) if i not in tp_only]
    assert torch.equal(got.telem.phase_work[keep], one.telem.phase_work[keep])
    assert torch.equal(got.telem.lat_hist, one.telem.lat_hist)


def test_run_tp_chunked_matches_jax(tp_runs):
    """Chunks of 15 ticks on two shards (the journey leaves re-tiled and
    the flags re-cut at every boundary) equal JAX's one TP call, which
    JAX's chunked runner equals by its contract."""
    _, _, _, ref = tp_runs("ring-2")
    kw, n, extra = CASES["ring-2"]
    spec, st, net, b = tsmoke.build(device="cpu", **kw)
    seen = []
    spec2, got = tts.run_tp_chunked(spec, st, net, b, n_shards=n, chunk_ticks=15,
                                    n_ticks=N_TICKS, callback=lambda s, d: seen.append(d),
                                    **extra)
    assert seen == [15, 30, 40] and spec2.tp_shards == n
    assert_tp_same(got, _jleaves(ref), "chunked")


def test_unstamp_returns_the_unsharded_shape(tp_runs):
    spec, got, jspec, ref = tp_runs("ring-2")
    spec0, st0 = tts.unstamp_tp_carry(spec, got)
    jspec0, jst0 = jts.unstamp_tp_carry(jspec, ref)
    assert spec0.tp_shards == 0 and st0.telem.exg_cand_sum.shape == (0,)
    assert_tp_same(st0, _jleaves(jst0), "unstamped")
    assert tmetrics.exchange_summary(spec0, st0) is None
    # a stamped carry goes on under the single-device engine
    more, _ = tengine.run(spec0, st0, tsmoke.build(device="cpu", **CASES["ring-2"][0])[2],
                          None, n_ticks=2)
    assert int(more.telem.ticks) == N_TICKS + 2
    # the exchange gauges' f32 fold needs candidate counts below 2^24
    s, st, _, _ = tsmoke.build(device="cpu", n_users=2, horizon=0.01, telemetry=True)
    huge = dataclasses.replace(s, n_users=2 ** 24, max_sends_per_user=1)
    with pytest.raises(ValueError, match="2\\^24"):
        tts.stamp_tp_telemetry(huge, st, 1)
