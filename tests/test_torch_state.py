"""The port's world construction against the JAX package, leaf for leaf.

``fognetsimpp_tpu_torch.scenarios.smoke.build`` from a seed must give the
JAX ``smoke.build`` world bit for bit (positions included); the numpy
carry-across must round-trip; specs outside the slice must raise, and
the specs the slice admitted since must run as JAX runs them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fognetsimpp_tpu import Policy
from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.net import topology as jtopology
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu_torch import envelope
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.net import topology as ttopology
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.spec import FogModel
from fognetsimpp_tpu_torch.spec import WorldSpec as TWorldSpec
from fognetsimpp_tpu_torch.state import (
    WorldState,
    net_from_numpy,
    state_from_numpy,
    state_to_numpy,
    tree_leaves,
)


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
    send_interval=0.0025, horizon=0.1, dt=5e-3, max_sends_per_user=44,
    max_sends_per_tick=2, queue_capacity=128, start_time_max=0.025,
    derive_acks=True, arrival_window=1024,
)

WORLDS = {
    "smoke": dict(horizon=0.5),
    "bench_small": BENCH_SMALL,
    "gated_off": dict(horizon=0.2, connect_gating=False, n_fogs=5, seed=7),
}


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [jax.tree_util.keystr(p)[1:] for p, _ in flat], [
        np.asarray(x) for _, x in flat
    ]


def assert_leaves_equal(ref_tree, port_tree, what=""):
    """Every leaf: same path, dtype, shape and bytes; names the first
    leaf that differs."""
    paths, ref = _jax_leaves(ref_tree)
    got = state_to_numpy(port_tree)
    port_paths = [p for p, _ in tree_leaves(port_tree)]
    assert paths == port_paths, "leaf order differs"
    for p, a, b in zip(paths, ref, got):
        assert a.dtype == b.dtype, f"{what} {p}: dtype {a.dtype} vs {b.dtype}"
        assert a.shape == b.shape, f"{what} {p}: shape {a.shape} vs {b.shape}"
        if a.tobytes() != b.tobytes():
            bad = np.nonzero(a.reshape(-1) != b.reshape(-1))[0]
            raise AssertionError(
                f"{what} {p}: {bad.size} elements differ, first at flat "
                f"index {bad[0]}: reference {a.reshape(-1)[bad[0]]!r} vs "
                f"port {b.reshape(-1)[bad[0]]!r}"
            )


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_build_matches_jax_leaf_for_leaf(name):
    kw = WORLDS[name]
    spec_j, state_j, net_j, bounds_j = jsmoke.build(**kw)
    spec_t, state_t, net_t, bounds_t = tsmoke.build(device="cpu", **kw)
    assert dataclasses.asdict(spec_j) == dataclasses.asdict(spec_t)
    assert_leaves_equal(state_j, state_t, name)
    assert_leaves_equal(net_j, net_t, name)
    assert_leaves_equal(bounds_j, bounds_t, name)


def test_smoke_state_has_144_leaves():
    _, state, _, _ = tsmoke.build(device="cpu", horizon=0.5)
    assert len(tree_leaves(state)) == 144


@pytest.mark.parametrize("n", [1, 2, 3, 6, 12, 265, 1001, 2085, 10035])
def test_positions_match_jnp_linspace(n):
    want = np.asarray(jnp.linspace(0.0, 100.0, n))
    got = tsmoke.linspace_f32(0.0, 100.0, n, "cpu").numpy()
    assert want.dtype == got.dtype
    assert want.tobytes() == got.tobytes()


def test_numpy_carry_across_round_trips():
    spec_j, state_j, net_j, _ = jsmoke.build(**BENCH_SMALL)
    _, ref = _jax_leaves(state_j)
    port = state_from_numpy(ref, device="cpu")
    assert isinstance(port, WorldState)
    assert_leaves_equal(state_j, port, "from_numpy")
    # and back through the port's own leaves
    again = state_from_numpy(state_to_numpy(port), device="cpu")
    assert_leaves_equal(state_j, again, "round trip")
    net = net_from_numpy([np.asarray(x) for x in jax.tree_util.tree_leaves(net_j)], "cpu")
    assert_leaves_equal(net_j, net, "net")


def test_carried_state_runs_like_a_built_one():
    """A JAX-built world carried across runs to the same final state as a
    port-built one."""
    spec_j, state_j, net_j, _ = jsmoke.build(horizon=0.05)
    spec_t, state_t, net_t, bounds_t = tsmoke.build(device="cpu", horizon=0.05)
    carried = state_from_numpy(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(state_j)], "cpu"
    )
    a, _ = tengine.run(spec_t, carried, net_t, bounds_t)
    b, _ = tengine.run(spec_t, state_t, net_t, bounds_t)
    assert all(
        x.tobytes() == y.tobytes()
        for x, y in zip(state_to_numpy(a), state_to_numpy(b))
    )


def test_entry_points_need_a_device_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsmoke.build(horizon=0.05)


@pytest.mark.parametrize(
    "kw, item",
    [
        pytest.param(dict(telemetry=True, telemetry_journeys=4), "item 14",
                     id="kw0-item 14"),
        pytest.param(dict(telemetry=True, telemetry_hist=True), "item 14",
                     id="kw5-item 14"),
        pytest.param(dict(ingest=True, ingest_batch=4), "item 16", id="kw7-item 16"),
        pytest.param(dict(telemetry=True), "item 14", id="kw8-item 14"),
        pytest.param(dict(record_tick_series=True), "item 15", id="kw9-item 15"),
    ],
)
def test_specs_outside_the_slice_raise(kw, item):
    """Specs of items still to port raise, naming the item.  The telemetry
    planes (item 14) and the per-tick series (item 15) are ported: those
    specs build, run and equal JAX on every leaf (and every series key)."""
    spec = TWorldSpec(
        n_users=2, n_fogs=2, send_interval=0.05, horizon=0.05,
        max_sends_per_user=5, **kw,
    ).validate()
    if item in ("item 14", "item 15"):
        assert envelope.slice_reject_reason(spec) is None
        spec, st, net, b = tsmoke.build(device="cpu", horizon=0.05, **kw)
        final, series = tengine.run(spec, st, net, b)
        js, jst, jn, jb = jsmoke.build(horizon=0.05, **kw)
        jfinal, jseries = jengine.run(js, jst, jn, jb)
        ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(jfinal)]
        got = state_to_numpy(final)
        assert [a.dtype for a in got] == [a.dtype for a in ref]
        assert all(a.tobytes() == b.tobytes() for a, b in zip(got, ref))
        if item == "item 14":
            assert series is None and jseries is None
            assert int(final.telem.ticks) == spec.n_ticks
            return
        assert sorted(series) == sorted(jseries)
        for k, v in jseries.items():
            a = np.asarray(v)
            assert series[k].numpy().dtype == a.dtype and series[k].numpy().tobytes() == a.tobytes(), k
        assert series["t"].shape == (spec.n_ticks,)
        return
    with pytest.raises(NotImplementedError, match=item):
        tsmoke.build(device="cpu", horizon=0.05, **kw)
    assert item in envelope.slice_reject_reason(spec)


@pytest.mark.parametrize(
    "kw, item",
    [
        (dict(fog_model=int(FogModel.POOL), app_gen=2), "item 10"),
        (dict(two_stage_arrivals=False), "item 7"),
        (dict(link_up_s=1.0), "item 10"),
        (dict(wired_queue_enabled=True), "item 25"),
        (dict(policy=int(Policy.LOCAL_FIRST), broker_mips=2048.0), "item 10"),
    ],
)
def test_specs_once_outside_the_slice_run_and_match_jax(kw, item):
    """The specs the slice refused until items 7, 10 and 25 were ported
    are admitted, and the same spec runs to JAX ``run``'s final state,
    every leaf (dtype, shape and bits)."""
    spec = TWorldSpec(
        n_users=2, n_fogs=2, send_interval=0.05, horizon=0.05,
        max_sends_per_user=5, **kw,
    ).validate()
    assert envelope.slice_reject_reason(spec) is None, item
    world = dict(horizon=0.05, **kw)
    spec_t, st_t, net_t, b_t = tsmoke.build(device="cpu", **world)
    final_t, _ = tengine.run(spec_t, st_t, net_t, b_t)
    spec_j, st_j, net_j, b_j = jsmoke.build(**world)
    final_j, _ = jengine.run(spec_j, st_j, net_j, b_j)
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(final_j)]
    got = state_to_numpy(final_t)
    assert len(got) == len(ref)
    for (path, _), a, b in zip(tree_leaves(final_t), got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    assert int(final_t.metrics.n_published) > 0


def test_link_cache_and_pair_delay_match_jax():
    spec_j, state_j, net_j, _ = jsmoke.build(**BENCH_SMALL)
    spec_t, state_t, net_t, _ = tsmoke.build(device="cpu", **BENCH_SMALL)
    b = spec_j.broker_index
    cache_j = jtopology.associate(net_j, state_j.nodes.pos, state_j.nodes.alive, broker=b)
    cache_t = ttopology.associate(net_t, state_t.nodes.pos, state_t.nodes.alive, b)
    assert_leaves_equal(cache_j, cache_t, "link cache")
    rng = np.random.default_rng(1)
    src = rng.integers(0, spec_j.n_nodes, 500).astype(np.int32)
    dst = rng.integers(0, spec_j.n_nodes, 500).astype(np.int32)
    want = jtopology.pair_delay(net_j, cache_j, jnp.asarray(src), jnp.asarray(dst))
    got = ttopology.pair_delay(
        net_t, cache_t, torch.from_numpy(src).long(), torch.from_numpy(dst).long()
    )
    assert np.asarray(want).tobytes() == got.numpy().tobytes()


def test_mobile_nodes_raise():
    """Mobile nodes no longer raise: a smoke world whose nodes move (LINEAR
    and CIRCLE, association every tick) runs to JAX's leaves."""
    kw = dict(horizon=0.2, n_users=12, n_fogs=3, assume_static=False)
    spec_j, st_j, net_j, b_j = jsmoke.build(**kw)
    spec_t, st_t, net_t, b_t = tsmoke.build(device="cpu", **kw)
    rng = np.random.default_rng(5)
    N = spec_j.n_nodes
    move = dict(
        mobility=rng.integers(0, 3, N).astype(np.int8),
        vel=rng.uniform(-30, 30, (N, 2)).astype(np.float32),
        circle_center=rng.uniform(0, 100, (N, 2)).astype(np.float32),
        circle_radius=rng.uniform(5, 50, N).astype(np.float32),
        circle_omega=rng.uniform(-2, 2, N).astype(np.float32),
        circle_phase=rng.uniform(-3, 3, N).astype(np.float32),
    )
    st_j = st_j.replace(nodes=st_j.nodes.replace(**{k: jnp.asarray(v) for k, v in move.items()}))
    st_t = st_t.replace(nodes=st_t.nodes.replace(**{k: torch.from_numpy(v) for k, v in move.items()}))
    final_j, _ = jengine.run(spec_j, st_j, net_j, b_j)
    final_t, _ = tengine.run(spec_t, st_t, net_t, b_t)
    assert_leaves_equal(final_j, final_t, "mobile smoke")
    assert (final_t.nodes.pos != st_t.nodes.pos).any()
