"""The latency histogram (the health plane's device half), port against
JAX, on the CPU.

The histogram's per-fog latency sum is an ordered float32 scatter-add, so
the port's must add in XLA's order: these worlds stream 64 and more
tasks of one fog in one tick (a backlog: the exactly-once flags cleared
in a carried state), single and as a replica batch (where the batching
rule of ``cell_sum_ordered`` lays the replicas end to end), and every
leaf must equal JAX's.  Then the host readers (``hist_summary``,
``slo_breach_count``, ``state_hash``, ``shard_state_hashes``,
``find_nonfinite``) on the same final state.
"""
import jax
import numpy as np
import pytest
import torch

from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.parallel import replicas as jreplicas
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu.telemetry import health as jhealth
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.ops.cell_kernels import cell_sum_ordered
from fognetsimpp_tpu_torch.parallel import replicas as treplicas
from fognetsimpp_tpu_torch.parallel.replicas import strict_vmap
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.state import state_from_numpy, state_to_numpy, tree_leaves
from fognetsimpp_tpu_torch.telemetry import health as thealth
from tests.test_torch_v1v2 import assert_same


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


#: 64 users on two fast fogs, two completion passes a tick: by tick 40
#: each fog has completed more than 64 tasks.  The arrival window holds a
#: tick's 64 publishes (all users start at t = 0).
BURST = dict(
    n_users=64, n_fogs=2, fog_mips=(4e6, 8e6), send_interval=0.01, dt=5e-3,
    horizon=0.4, start_time_max=0.0, completions_per_tick=2, arrival_window=64,
    telemetry=True, telemetry_hist=True,
)
HALF = 40


def _clear_seen(leaves, paths):
    """The carried leaves with every exactly-once flag cleared: a backlog
    of acks the histogram has not counted, as if it had just been turned
    on, so the next tick streams every DONE task at once."""
    return [np.zeros_like(x) if p == "telem.lat_seen" else x for p, x in zip(paths, leaves)]


def _jax_state(like, leaves):
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(like), [jax.numpy.asarray(x) for x in leaves]
    )


@pytest.fixture(scope="module")
def burst():
    """``(spec, port final, JAX spec, JAX final, most acks of one fog in a
    tick)``: 40 ticks, the flags cleared in the carry on both sides, 40
    more; the port stepped tick by tick to read the per-tick deltas."""
    spec, st, net, b = tsmoke.build(device="cpu", **BURST)
    paths = [p for p, _ in tree_leaves(st)]
    step = tengine.make_step(spec)
    cache = tengine._static_cache(spec, net, st, fused=False)
    most = 0
    for k in range(2 * HALF):
        if k == HALF:
            st = state_from_numpy(_clear_seen(state_to_numpy(st), paths), "cpu")
        prev = st.telem.lat_hist.sum(dim=1)
        st = step(st, net, b, cache)
        most = max(most, int((st.telem.lat_hist.sum(dim=1) - prev).max()))
    js, jst, jn, jb = jsmoke.build(**BURST)
    mid, _ = jengine.run(js, jst, jn, jb, n_ticks=HALF)
    mid = _jax_state(mid, _clear_seen([np.asarray(x) for x in jax.tree_util.tree_leaves(mid)], paths))
    return spec, st, js, jengine.run(js, mid, jn, jb, n_ticks=HALF)[0], most


def test_burst_of_acks_matches_jax(burst):
    spec, final, _, jfinal, most = burst
    assert most >= 64
    assert_same(final, jfinal, "burst")
    assert int(final.telem.lat_seen.sum()) < int(final.telem.lat_hist.sum())


def test_burst_replica_batch_matches_jax():
    """Two replicas of the burst world with journeys on, under
    ``strict_vmap``: one ordered sum a tick for the whole batch."""
    kw = dict(BURST, telemetry_journeys=16)
    spec, st, net, b = tsmoke.build(device="cpu", **kw)
    paths = [p for p, _ in tree_leaves(st)]
    batch = treplicas.replicate_state(spec, st, 2, seed=5)
    js, jst, jn, jb = jsmoke.build(**kw)
    jbatch = jreplicas.replicate_state(js, jst, 2, seed=5)
    for half in range(2):
        with strict_vmap():
            batch = treplicas.run_replicated(spec, batch, net, b, n_ticks=HALF)
        jbatch = jreplicas.run_replicated(js, jbatch, jn, jb, n_ticks=HALF)
        if half == 0:
            batch = state_from_numpy(_clear_seen(state_to_numpy(batch), paths), "cpu")
            jbatch = _jax_state(jbatch, _clear_seen(
                [np.asarray(x) for x in jax.tree_util.tree_leaves(jbatch)], paths
            ))
    assert_same(batch, jbatch, "replicas")
    assert (batch.telem.lat_hist.sum(dim=(1, 2)) >= 128).all()
    assert torch.equal(batch.telem.j_task[0], batch.telem.j_task[1])


def test_latency_hist_delta_matches_jax(burst):
    """The TP tick's per-shard delta (sums from +0.0) on a mid-run state
    with its flags cleared: JAX's jitted delta, bit for bit."""
    spec, final, js, jfinal, _ = burst
    telem = final.telem.replace(lat_seen=torch.zeros_like(final.telem.lat_seen))
    t1 = torch.tensor(0.1, dtype=torch.float32)
    got = thealth.latency_hist_delta(spec, telem, final.tasks, t1)
    jtelem = jfinal.telem.replace(lat_seen=jax.numpy.zeros_like(jfinal.telem.lat_seen))
    want = jax.jit(lambda te, tk: jhealth.latency_hist_delta(js, te, tk, np.float32(0.1)))(
        jtelem, jfinal.tasks
    )
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    # rows that are not due go to cell -1 and are dropped
    vals = torch.tensor([1.0, 2.0, 4.0], dtype=torch.float32)
    out = cell_sum_ordered(torch.tensor([-1, 0, -1], dtype=torch.int32), vals, 2)
    assert out.tolist() == [2.0, 0.0]


def test_host_readers_equal_jax(burst):
    spec, final, js, jfinal, _ = burst
    got, want = thealth.hist_summary(spec, final), jhealth.hist_summary(js, jfinal)
    assert set(got) == set(want)
    for k in ("edges_ms", "counts", "per_fog_count", "per_fog_sum_ms"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["count"] == want["count"] and got["sum_ms"] == want["sum_ms"]
    assert got["quantiles_ms"] == want["quantiles_ms"]
    for k, v in want["per_fog_quantiles_ms"].items():
        np.testing.assert_array_equal(got["per_fog_quantiles_ms"][k], v)
    np.testing.assert_array_equal(thealth.hist_edges_s(spec), jhealth.hist_edges_s(js))
    assert thealth.QUANTILES == jhealth.QUANTILES
    for slo in (0.5, 20.0, 80.0):
        assert thealth.slo_breach_count(spec, final, slo) == jhealth.slo_breach_count(
            js, jfinal, slo
        )
    assert thealth.state_hash(final) == jhealth.state_hash(jfinal)
    assert thealth.shard_state_hashes(spec, final, 4) == jhealth.shard_state_hashes(
        js, jfinal, 4
    )
    assert thealth.find_nonfinite(final) == jhealth.find_nonfinite(jfinal) == {}
    leaves = state_to_numpy(final)
    bad = state_from_numpy(leaves, "cpu")
    bad.tasks.t_ack6[3] = float("nan")
    jbad = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jfinal),
        [np.asarray(x) for x in state_to_numpy(bad)],
    )
    assert thealth.find_nonfinite(bad) == jhealth.find_nonfinite(jbad) == {
        ".tasks.t_ack6": "nan"
    }
    off = tsmoke.build(device="cpu", n_users=2, horizon=0.01)
    assert thealth.hist_summary(off[0], off[1]) is None
