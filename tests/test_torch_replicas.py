"""The port's replica axis against the JAX package, bit for bit.

``replicate_state`` and ``run_replicated`` (one ``vmap`` of the tick a
tick, ``core/engine.run_batched``) against JAX's on the same worlds, every
leaf: a config-3-shaped smoke world cut to 32 users x 6 fogs, a small
``wireless5`` world (the Bianchi MAC keyed through the per-cell sum laid
end to end), UCB on the compacted broker with its credit phase, and
ROUND_ROBIN with a window smaller than a tick's publishes.  The batching
rules of the kernels' custom operators are held against per-replica calls
of their plain versions, and the refusals against the items that will
lift them.  Every test runs with functorch's per-replica fallback off
(``strict_vmap``): an operation without a batching rule raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fognetsimpp_tpu import Policy
from fognetsimpp_tpu.parallel import replicas as jreplicas
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu.scenarios import wireless as jw
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.ops import arrival_kernels as ak
from fognetsimpp_tpu_torch.ops import cell_kernels as ck
from fognetsimpp_tpu_torch.ops import cuda_build
from fognetsimpp_tpu_torch.parallel import replicas as treplicas
from fognetsimpp_tpu_torch.parallel import sweep as tsweep
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.scenarios import wireless as tw
from fognetsimpp_tpu_torch.state import state_to_numpy, tree_leaves, tree_map


@pytest.fixture(autouse=True, scope="module")
def strict_vmap():
    """No per-replica fallback loop, and the port on one thread beside
    the other test workers (its CPU tensors here are small)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with treplicas.strict_vmap():
        yield
    torch.set_num_threads(old)


R = 3
SEED = 5

#: Each world: (JAX builder, port builder, arguments), cut to CPU size.
WORLDS = {
    # benchmarks.py::config3's world cut to 32 users x 6 fogs, K = 64
    "min_latency": (jsmoke.build, tsmoke.build, dict(
        n_users=32, n_fogs=6, policy=int(Policy.MIN_LATENCY),
        send_interval=0.01, horizon=0.04, dt=1e-3, max_sends_per_user=8,
        arrival_window=64, start_time_max=0.02)),
    # config 4's world cut to 40 users and 4 extra APs: mobility, the
    # Bianchi keying (the per-cell sum of every replica in one call),
    # batteries
    "wireless5": (jw.wireless5, tw.wireless5, dict(
        numb_users=40, horizon=0.1, dt=5e-3, extra_aps=4,
        mac_model="bianchi", policy=int(Policy.ENERGY_AWARE))),
    # the learned credit phase: acks land and are credited
    "ucb": (jsmoke.build, tsmoke.build, dict(
        n_users=24, n_fogs=4, fog_mips=(40000.0, 80000.0, 20000.0, 60000.0),
        send_interval=0.02, horizon=0.1, start_time_max=0.02,
        queue_capacity=16, derive_acks=False, policy=int(Policy.UCB))),
    # the compacted broker's round-robin slots, deferral past K = 8
    "round_robin": (jsmoke.build, tsmoke.build, dict(
        n_users=24, n_fogs=4, policy=int(Policy.ROUND_ROBIN),
        send_interval=0.004, horizon=0.04, start_time_max=0.02,
        queue_capacity=16, arrival_window=8)),
}


def _jleaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _assert_same(port_tree, ref_leaves, what):
    paths = [p for p, _ in tree_leaves(port_tree)]
    got = state_to_numpy(port_tree)
    assert len(got) == len(ref_leaves) == len(paths)
    for p, a, b in zip(paths, got, ref_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, p)
        assert a.tobytes() == b.tobytes(), (what, p)


@pytest.fixture(scope="module")
def jax_runs():
    """Each world's JAX replica batch and its ``run_replicated`` result,
    computed once for the module."""
    cache = {}

    def get(name):
        if name not in cache:
            jbuild, _, kw = WORLDS[name]
            spec, state, net, bounds = jbuild(**kw)
            batch = jreplicas.replicate_state(spec, state, R, seed=SEED)
            final = jreplicas.run_replicated(spec, batch, net, bounds)
            cache[name] = (_jleaves(batch), _jleaves(final))
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_run_replicated_matches_jax_every_leaf(name, jax_runs):
    jbatch, jfinal = jax_runs(name)
    _, tbuild, kw = WORLDS[name]
    spec, state, net, bounds = tbuild(device="cpu", **kw)
    batch = treplicas.replicate_state(spec, state, R, seed=SEED)
    _assert_same(batch, jbatch, "replicate_state")
    final = treplicas.run_replicated(spec, batch, net, bounds)
    _assert_same(final, jfinal, "run_replicated")
    m = final.metrics
    assert (m.n_scheduled > 0).all()
    if name == "ucb":
        assert (final.learn.lat_cnt > 0).all()  # the credit phase ran
    if name == "round_robin":
        assert (m.n_deferred_max > 0).any()  # the window deferred


def test_replica_equals_its_single_world_run():
    """Replica r of the batch is ``engine.run`` on replica r's state."""
    _, tbuild, kw = WORLDS["wireless5"]
    spec, state, net, bounds = tbuild(device="cpu", **kw)
    batch = treplicas.replicate_state(spec, state, R, seed=SEED)
    final = treplicas.run_replicated(spec, batch, net, bounds, n_ticks=6)
    for r in (0, R - 1):
        one, _ = tengine.run(spec, tree_map(lambda x: x[r], batch), net, bounds, n_ticks=6)
        want = state_to_numpy(one)
        got = state_to_numpy(tree_map(lambda x: x[r], final))
        assert all(a.tobytes() == b.tobytes() for a, b in zip(got, want))


@pytest.mark.parametrize("gating", [True, False])
def test_replicate_state_matches_jax(gating):
    """Per-replica keys and start times; without the connect handshake
    the first publish moves with the start time."""
    kw = dict(n_users=16, n_fogs=3, horizon=0.05, start_time_min=0.01,
              start_time_max=0.04, connect_gating=gating)
    jspec, jstate, _, _ = jsmoke.build(**kw)
    spec, state, _, _ = tsmoke.build(device="cpu", **kw)
    jb = jreplicas.replicate_state(jspec, jstate, 4, seed=11)
    tb = treplicas.replicate_state(spec, state, 4, seed=11)
    _assert_same(tb, _jleaves(jb), "replicate_state")
    starts = tb.users.start_t
    assert not torch.equal(starts[0], starts[1])
    assert torch.equal(tb.users.next_send, starts) != gating
    kept = treplicas.replicate_state(spec, state, 4, seed=11, resample_starts=False)
    assert torch.equal(kept.users.start_t[2], state.users.start_t)


def test_replica_counters_and_fork_state():
    _, tbuild, kw = WORLDS["min_latency"]
    spec, state, net, bounds = tbuild(device="cpu", **kw)
    forked = tsweep.fork_state(state, 2)
    assert torch.equal(forked.key[0], state.key) and torch.equal(forked.key[1], state.key)
    final = treplicas.run_replicated(spec, forked, net, bounds, n_ticks=10)
    counters = treplicas.replica_counters(final)
    assert set(counters) >= {"n_published", "n_scheduled", "n_deferred_max"}
    assert counters["n_published"].shape == (2,)
    assert counters["n_published"][0] == counters["n_published"][1] > 0


# ----------------------------------------------------------------------
# the kernels' batching rules, against per-replica plain calls
# ----------------------------------------------------------------------

def _windows(R_, K, F, seed, empty=(), p=0.7):
    rng = np.random.default_rng(seed)
    mask = rng.random((R_, K)) < p
    for r in empty:
        mask[r] = False
    fog = rng.integers(0, F, (R_, K)).astype(np.int32)
    t = np.round(rng.random((R_, K)) * 0.01, 4).astype(np.float32)
    t[:, :3] = np.float32(-0.0)  # ties of -0.0 and +0.0
    t[:, 3:6] = np.float32(0.0)
    f_key = np.where(mask, fog, F).astype(np.int32)
    t_key = np.where(mask, t, np.inf).astype(np.float32)
    return [torch.from_numpy(a) for a in (mask, f_key, t_key)]


def _equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("R_, K, F, empty", [
    (3, 64, 6, (1,)),     # 18 fogs end to end: the fused kernel; an empty replica
    (4, 300, 256, ()),    # 1,024 end to end: the fused kernel's edge
    (3, 200, 400, (2,)),  # 1,200 end to end: the rank kernel and reductions a replica
    (2, 2500, 5, (0,)),   # 5,000 rows end to end: the CPU's sort rank
])
def test_fused_rule_equals_per_replica_plain(R_, K, F, empty):
    taps = []
    mask, f_key, t_key = _windows(R_, K, F, seed=R_ * K + F, empty=empty)
    hook = lambda name, *args: taps.append((name, args[0].shape[0]))  # noqa: E731
    cuda_build.TAPS.append(hook)
    try:
        got = torch.func.vmap(lambda m, f, t: ak.fused_arrival_plan(m, f, t, F))(
            mask, f_key, t_key)
    finally:
        cuda_build.TAPS.remove(hook)
    for r in range(R_):
        want = ak.fused_arrival_plan_plain(mask[r], f_key[r], t_key[r], F)
        for name, g, w in zip(("rank", "counts", "t_min", "first"), got, want):
            assert _equal(g[r], w), (r, name)
    # one call a batch, of the kernel the end-to-end shape picks
    fused = R_ * F <= ak.FUSED_MAX_FOGS and R_ * K <= 4096
    want_taps = [("fused_arrival_plan", R_ * K)] if fused else (
        [("pairwise_rank", R_ * K)] if R_ * K <= 4096 else [])
    assert taps == want_taps
    assert (got[1][list(empty)] == 0).all() and (got[3][list(empty)] == K).all()


def test_pairwise_rule_equals_per_replica_plain():
    R_, K, F = 3, 500, 1500
    mask, f_key, t_key = _windows(R_, K, F, seed=3, empty=(1,))
    got = torch.func.vmap(lambda m, f, t: ak.pairwise_rank(m, f, t, F))(mask, f_key, t_key)
    for r in range(R_):
        assert _equal(got[r], ak.pairwise_rank_plain(mask[r], f_key[r], t_key[r]))
    with pytest.raises(ValueError, match="n_fogs"):
        torch.func.vmap(ak.pairwise_rank)(mask, f_key, t_key)


@pytest.mark.parametrize("in_dims", [(0, 0), (0, None)])
def test_cell_sum_rule_equals_per_replica_plain_and_xla(in_dims):
    """Replica r's cell a at r * A + a, every dropped entry (outside
    [0, A), negative ones too) at R * A, one call for all R * A cells."""
    R_, n, A = 4, 3000, 9
    rng = np.random.default_rng(2)
    cell = rng.integers(-2, A + 3, (R_, n)).astype(np.int32)
    vals = rng.choice(np.array([1 / 1.5, 1 / 0.05, 0.1, 1 / 3, 1e7], np.float32), (R_, n))
    c, v = torch.from_numpy(cell), torch.from_numpy(vals)
    if in_dims[1] is None:
        v, vals = v[0], np.repeat(vals[:1], R_, axis=0)
    taps = []
    cuda_build.TAPS.append(lambda name, *args: taps.append((name, args[2])))
    try:
        got = torch.func.vmap(lambda a, b: ck.cell_sum_ordered(a, b, A), in_dims=in_dims)(c, v)
    finally:
        cuda_build.TAPS.pop()
    assert taps == [("cell_sum_ordered", R_ * A)]
    kept = (cell >= 0) & (cell < A)
    xla = jax.vmap(
        lambda a, b: jnp.zeros((A + 1,), jnp.float32).at[a].add(b, mode="drop")[:A]
    )(jnp.asarray(np.where(kept, cell, A)), jnp.asarray(vals))
    assert got.numpy().tobytes() == np.asarray(xla).tobytes()
    for r in range(R_):
        want = ck.cell_sum_ordered_plain(c[r], torch.from_numpy(vals[r]), A)
        assert _equal(got[r], want)


# ----------------------------------------------------------------------
# refusals
# ----------------------------------------------------------------------

def test_refusals_name_their_items():
    spec, state, net, bounds = tsmoke.build(device="cpu", n_users=4, n_fogs=2, horizon=0.01)
    batch = treplicas.replicate_state(spec, state, 2)
    with pytest.raises(NotImplementedError, match="item 11"):
        treplicas.run_replicated(spec, batch, net, bounds, dyn_rows=object())
    with pytest.raises(NotImplementedError, match="item 11"):
        tsweep.sweep_dyn(tsmoke.build, {"uplink_loss_prob": [0.0, 0.1]}, device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        tsweep.sweep_dyn_from(spec, state, net, bounds, {"uplink_loss_prob": [0.1]}, 5)
    with pytest.raises(NotImplementedError, match="item 27"):
        tsweep.sweep_policies(tsmoke.build, [0], [0.05], mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 27"):
        tsweep.sweep_explore(tsmoke.build, int(Policy.UCB), [0.1], [0.05],
                             mesh=object(), device="cpu")
    chaos = dataclasses.replace(spec, chaos=True)
    with pytest.raises(NotImplementedError, match="item 12"):
        treplicas.replicate_state(chaos, state, 2)
    with pytest.raises(NotImplementedError, match="item 12"):
        treplicas.run_replicated(chaos, batch, net, bounds)
