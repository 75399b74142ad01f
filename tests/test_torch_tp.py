"""The port's task-sharded runner against the JAX package, bit for bit.

``run_tp_sharded`` of the port runs the shards as threads on the CPU.
Where the JAX TP contract is bit-exact against the single-device engine
(no exchange window, or a windowed spec) the oracle is JAX ``run``; with a
bounded exchange window it is JAX ``run_tp_sharded`` on the conftest's
8-device CPU mesh.  The exchange collectives are held against their JAX
counterparts inside ``shard_map``, the Pallas ring kernel in interpret
mode among them.
"""
import ast
import dataclasses
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from fognetsimpp_tpu import Policy
from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.ops.pallas_kernels import ring_all_gather_pallas as jring_pallas
from fognetsimpp_tpu.ops.queues import topk_merge_sorted as jtopk_merge
from fognetsimpp_tpu.parallel import make_mesh
from fognetsimpp_tpu.parallel import taskshard as jts
from fognetsimpp_tpu.parallel.tp import shard_map
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.ops import ring_kernels as rk
from fognetsimpp_tpu_torch.ops.queues import topk_merge_sorted
from fognetsimpp_tpu_torch.parallel import taskshard as tts
from fognetsimpp_tpu_torch.parallel.shards import ShardGroup
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


REPO = pathlib.Path(__file__).resolve().parents[1]

#: ``tests/test_tp.py``'s worlds: SMALL under the three dense-broker
#: policy families the TP tick admits, and SMALL with fast fogs and
#: two-slot queues, where tasks complete and saturated fogs drop (no task
#: completes in SMALL's own first 100 ticks).
SMALL = dict(
    n_users=16, n_fogs=3, send_interval=0.01, horizon=0.2,
    start_time_max=0.05,
)
WORLDS = {
    "min_busy": dict(policy=int(Policy.MIN_BUSY)),
    "min_latency_jitter": dict(
        policy=int(Policy.MIN_LATENCY), send_interval_jitter=0.1
    ),
    "max_mips": dict(policy=int(Policy.MAX_MIPS)),
    "fast_fogs": dict(fog_mips=(100000.0,), queue_capacity=2),
}
#: Each (world, exchange regime) at one shard count; every count meets
#: both regimes (the windowed spec takes ``arrival_window=8``).  The runs
#: take the first 60 of SMALL's 200 ticks, which keeps the file's time
#: down: every shard draws at the global width and runs the fog tail, so
#: n shards cost about n single-device ticks on the CPU.
N_TICKS = 60
CASES = [
    ("min_busy", None, 2),
    ("min_latency_jitter", None, 4),
    ("max_mips", None, 8),
    ("fast_fogs", None, 4),
    ("min_busy", 8, 8),
    ("min_latency_jitter", 8, 2),
    ("max_mips", 8, 4),
    ("fast_fogs", 8, 2),
]

#: ``bench.py::tp_measurement``'s world cut to CPU size: 512 users x 8
#: fogs, send interval 50 ms, dt 5 ms, one send a tick (R = 1), queue 128,
#: derive_acks, no arrival window.
TP_SMALL = dict(
    n_users=512, n_fogs=8, fog_mips=(1000.0, 2000.0, 3000.0, 4000.0),
    send_interval=0.05, horizon=0.1, dt=5e-3, max_sends_per_user=6,
    max_sends_per_tick=1, queue_capacity=128, start_time_max=0.025,
    derive_acks=True,
)


def _kw(name, window):
    kw = dict(SMALL, **WORLDS[name])
    if window is not None:
        kw["arrival_window"] = window
    return kw


def _assert_leaves_equal(got, ref_leaves, what):
    paths = [p for p, _ in tree_leaves(got)]
    assert len(paths) == len(ref_leaves)
    for p, a, b in zip(paths, ref_leaves, state_to_numpy(got)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what}: {p}"
        assert a.tobytes() == b.tobytes(), f"{what}: leaf {p} differs"


def _jax_leaves(state):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


@pytest.mark.parametrize("name, window, n", CASES)
def test_run_tp_sharded_matches_jax_run(name, window, n):
    kw = _kw(name, window)
    spec_j, st_j, net_j, b_j = jsmoke.build(**kw)
    ref, _ = jengine.run(spec_j, st_j, net_j, b_j, n_ticks=N_TICKS)
    spec_t, st_t, net_t, b_t = tsmoke.build(device="cpu", **kw)
    spec2, got = tts.run_tp_sharded(
        spec_t, st_t, net_t, b_t, n_shards=n, n_ticks=N_TICKS
    )
    assert spec2 == spec_t
    assert (window is None) == (spec_t.window == spec_t.task_capacity)
    _assert_leaves_equal(got, _jax_leaves(ref), f"{name} n={n} window={window}")
    assert int(got.metrics.n_scheduled) > 0
    if name == "fast_fogs":
        assert int(got.metrics.n_completed) > 0
        assert int(got.fogs.q_drops.sum()) > 0


def test_bounded_exchange_matches_jax_tp():
    """exchange_window below a shard's candidates: tick-keyed rotation
    and deferral, held against JAX ``run_tp_sharded`` at n = 8."""
    n, window = 8, 3
    spec_j, st_j, net_j, b_j = jsmoke.build(**TP_SMALL)
    mesh = make_mesh(n, axis_name="node")
    _, ref = jts.run_tp_sharded(
        spec_j, st_j, net_j, b_j, mesh, exchange_window=window
    )
    spec_t, st_t, net_t, b_t = tsmoke.build(device="cpu", **TP_SMALL)
    assert window < spec_t.n_users // n  # below the shard's candidates
    _, got = tts.run_tp_sharded(
        spec_t, st_t, net_t, b_t, n_shards=n, exchange_window=window
    )
    _assert_leaves_equal(got, _jax_leaves(ref), "bounded exchange")
    assert int(got.metrics.n_deferred_max) > 0
    assert int(got.metrics.n_scheduled) > 0


def test_padding_is_inert():
    """13 users over 4 shards: padded with ghosts, equal to JAX ``run`` at
    the padded spec, and the ghosts never leave Stage.UNUSED."""
    kw = _kw("min_busy", None)
    kw["n_users"] = 13
    spec_j, st_j, net_j, b_j = jsmoke.build(**kw)
    spec_jp, st_jp, net_jp = jts.pad_users_to_multiple(spec_j, st_j, net_j, 4)
    ref, _ = jengine.run(spec_jp, st_jp, net_jp, b_j, n_ticks=N_TICKS)
    spec_t, st_t, net_t, b_t = tsmoke.build(device="cpu", **kw)
    with pytest.raises(ValueError, match="divide"):
        tts.run_tp_sharded(spec_t, st_t, net_t, b_t, n_shards=4, pad=False)
    spec2, got = tts.run_tp_sharded(
        spec_t, st_t, net_t, b_t, n_shards=4, n_ticks=N_TICKS
    )
    assert dataclasses.asdict(spec2) == dataclasses.asdict(spec_jp)
    _assert_leaves_equal(got, _jax_leaves(ref), "padded")
    S = spec2.max_sends_per_user
    assert (got.tasks.stage.reshape(16, S)[13:] == 0).all()
    assert not got.users.connected[13:].any()
    assert (got.users.send_count[13:] == 0).all()
    assert (got.users.send_count[:13] > 0).any()


@pytest.mark.parametrize("n, K, C", [(8, 6, 4), (8, 5, 5), (4, 7, 4)])
def test_ring_all_gather_plain_matches_jax(n, K, C):
    """The plain all-gather against JAX's ``ppermute`` ring and the Pallas
    remote-DMA kernel in interpret mode, inside ``shard_map``."""
    mesh = make_mesh(n, axis_name="node")
    rng = np.random.default_rng(n * 100 + K * 10 + C)
    x = rng.integers(-2 ** 31, 2 ** 31 - 1, (n * K, C), dtype=np.int64).astype(np.int32)

    def gathered(fn):
        f = jax.jit(shard_map(
            fn, mesh=mesh, in_specs=P("node"), out_specs=P("node"),
            check_vma=False,
        ))
        return np.asarray(f(jnp.asarray(x))).reshape(n, n * K, C)

    want_ring = gathered(lambda b: jts.ring_all_gather(b, "node", n))
    want_pallas = gathered(
        lambda b: jring_pallas(b, "node", n, interpret=True)
    )
    blocks = [torch.from_numpy(b.copy()) for b in x.reshape(n, K, C)]
    got = rk.ring_all_gather_plain(blocks)
    wrapped = rk.ring_all_gather(blocks)  # a CPU tensor: the plain version
    assert len(got) == len(wrapped) == n
    for s in range(n):
        np.testing.assert_array_equal(got[s].numpy(), want_ring[s])
        np.testing.assert_array_equal(got[s].numpy(), want_pallas[s])
        assert torch.equal(wrapped[s], got[s])


def test_ring_all_gather_refuses_bad_blocks():
    a = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        rk.ring_all_gather([a, a.float()])
    with pytest.raises(ValueError):
        rk.ring_all_gather([a, torch.zeros((2, 4), dtype=torch.int32)])
    with pytest.raises(ValueError):
        rk.ring_all_gather([a, torch.zeros((4, 3), dtype=torch.int32).t()])
    with pytest.raises(ValueError):
        rk.ring_all_gather([])


def _unique_windows(n, K, W, seed):
    """Per-shard (K, W) i32 windows sorted on unique last-column keys,
    each with a tail of identical max-key sentinel rows."""
    rng = np.random.default_rng(seed)
    keys = rng.permutation(n * K * 3)[: n * K].astype(np.int32)
    x = np.stack(
        [np.arange(n * K, dtype=np.int32)]
        + [rng.integers(0, 99, n * K, dtype=np.int32) for _ in range(W - 2)]
        + [keys],
        axis=1,
    ).reshape(n, K, W)
    sent = np.array([n * K] + [0] * (W - 2) + [2 ** 30], np.int32)
    out = []
    for s, b in enumerate(x):
        b = b[np.argsort(b[:, -1], kind="stable")]
        b[K - 1 - s % 3:] = sent  # 1-3 sentinel rows at the end
        out.append(b)
    return np.stack(out)


def test_ring_topk_merge_matches_jax():
    n, K, W = 8, 5, 3
    x = _unique_windows(n, K, W, seed=7)
    mesh = make_mesh(n, axis_name="node")
    f = jax.jit(shard_map(
        lambda b: jts.ring_topk_merge(b, "node", n), mesh=mesh,
        in_specs=P("node"), out_specs=P("node"), check_vma=False,
    ))
    want = np.asarray(f(jnp.asarray(x.reshape(n * K, W)))).reshape(n, K, W)
    group = ShardGroup(n, "cpu")
    got = group.run(
        lambda s: group.ring_topk_merge(s, torch.from_numpy(x[s].copy()))
    )
    for s in range(n):
        np.testing.assert_array_equal(got[s].numpy(), want[s])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_merge_sorted_matches_jax(seed):
    x = _unique_windows(2, 9, 5, seed)
    if seed == 2:  # equal keys across the two sides: a wins the ties
        x[1, :, -1] = x[0, :, -1]
    want = np.asarray(jtopk_merge(jnp.asarray(x[0]), jnp.asarray(x[1])))
    got = topk_merge_sorted(torch.from_numpy(x[0]), torch.from_numpy(x[1]))
    np.testing.assert_array_equal(got.numpy(), want)


def test_replicated_leaves_equal_on_every_shard():
    n = 4
    spec, st, net, b = tsmoke.build(device="cpu", **_kw("fast_fogs", None))
    spec, finals = tts.run_tp_shards(spec, st, net, n_shards=n, n_ticks=N_TICKS)
    U_loc = spec.n_users // n
    f0 = finals[0]
    for f in finals[1:]:
        for k in ("t", "tick", "key", "fogs", "broker", "metrics", "learn",
                  "chaos", "hier", "telem"):
            a, c = getattr(f0, k), getattr(f, k)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, c), k
            else:
                for (p, x), (_, y) in zip(tree_leaves(a), tree_leaves(c)):
                    assert x.dtype == y.dtype and torch.equal(x, y), f"{k}.{p}"
        for (p, x), (_, y) in zip(tree_leaves(f0.nodes), tree_leaves(f.nodes)):
            assert torch.equal(x[U_loc:], y[U_loc:]), f"nodes.{p}"
    assert int(f0.metrics.n_completed) > 0


def _rejected_specs(spec):
    rep = dataclasses.replace
    return {
        "TP-NOFOGS": rep(spec, n_fogs=0),
        "TP-CHAOS": rep(spec, chaos=True),
        "TP-HIER": rep(spec, n_brokers=2),
        "TP-POOL": rep(spec, fog_model=1 - spec.fog_model),
        "TP-POLICY": rep(spec, policy=int(Policy.ROUND_ROBIN)),
        "TP-ARRIVALS": rep(spec, two_stage_arrivals=False),
        "TP-DYNTOPO": rep(spec, assume_static=False),
        "TP-ENERGY": rep(spec, energy_enabled=True),
        "TP-WIRED": rep(spec, wired_queue_enabled=True),
        "TP-SERIES": rep(spec, record_tick_series=True),
    }


def test_tp_reject_reason_matches_jax():
    spec_j = jsmoke.build(**SMALL)[0]
    spec_t = tsmoke.build(device="cpu", **SMALL)[0]
    assert tengine.tp_ok(spec_t) and jengine.tp_ok(spec_j)
    cases_j, cases_t = _rejected_specs(spec_j), _rejected_specs(spec_t)
    for tag in cases_t:
        want = jengine.tp_reject_reason(cases_j[tag])
        got = tengine.tp_reject_reason(cases_t[tag])
        assert want.startswith(f"[{tag}]"), (tag, want)
        assert got == want, tag
    learn_j = dataclasses.replace(spec_j, policy=int(Policy.UCB))
    learn_t = dataclasses.replace(spec_t, policy=int(Policy.UCB))
    assert tengine.tp_reject_reason(learn_t) == jengine.tp_reject_reason(learn_j)


def test_run_tp_sharded_rejects_outside_its_envelope():
    spec, st, net, b = tsmoke.build(device="cpu", **SMALL)
    rr = dataclasses.replace(spec, policy=int(Policy.ROUND_ROBIN))
    with pytest.raises(ValueError, match=r"\[TP-POLICY\]"):
        tts.run_tp_sharded(rr, st, net, b, n_shards=2)
    # the telemetry plane runs under two shards (items 14 and 23) and
    # equals JAX's TP runner; the shard axis is stamped on the spec
    tel = dict(SMALL, telemetry=True)
    spec_t, st_t, net_t, b_t = tsmoke.build(device="cpu", **tel)
    spec2, got = tts.run_tp_sharded(spec_t, st_t, net_t, b_t, n_shards=2, n_ticks=20)
    js, jst, jn, jb = jsmoke.build(**tel)
    jspec2, ref = jts.run_tp_sharded(
        js, jst, jn, jb, make_mesh(2, axis_name="node"), n_ticks=20
    )
    assert spec2.tp_shards == jspec2.tp_shards == 2
    _assert_leaves_equal(got, _jax_leaves(ref), "telemetry under two shards")
    win = dataclasses.replace(spec, arrival_window=4)
    with pytest.raises(ValueError, match="exchange_window"):
        tts.run_tp_sharded(win, st, net, b, n_shards=2, exchange_window=2)


def test_run_tp_chunked_equals_one_call():
    kw = dict(_kw("fast_fogs", None), horizon=0.05)
    spec, st, net, b = tsmoke.build(device="cpu", **kw)
    _, one = tts.run_tp_sharded(spec, st, net, b, n_shards=2)
    seen = []
    spec, st, net, b = tsmoke.build(device="cpu", **kw)
    _, chunked = tts.run_tp_chunked(
        spec, st, net, b, n_shards=2, chunk_ticks=spec.n_ticks // 3 + 1,
        callback=lambda s, done: seen.append(done),
    )
    assert seen[-1] == spec.n_ticks and len(seen) == 3
    _assert_leaves_equal(chunked, state_to_numpy(one), "chunked")


def test_a_shard_that_raises_stops_the_run():
    group = ShardGroup(4, "cpu", timeout=60)

    def body(s):
        if s == 2:
            raise KeyError("shard 2 fails")
        return group.psum(s, torch.ones(3))

    with pytest.raises(KeyError, match="shard 2 fails"):
        group.run(body)
    # the group is usable again, and psum adds in shard order
    out = group.run(lambda s: group.psum(s, torch.full((2,), s, dtype=torch.int32)))
    assert all(torch.equal(o, torch.full((2,), 6, dtype=torch.int32)) for o in out)
    assert len({id(o) for o in out}) == 4  # one copy per shard
    assert not any(t.name.startswith("shard-") for t in threading.enumerate())


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "fognetsimpp_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    assert {"metrics.py", "health.py", "journeys.py", "profile.py"} <= {
        p.name for p in files if p.parent.name == "telemetry"
    }
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "fognetsimpp_tpu"), (path, mod)


# ----------------------------------------------------------------------
# the promoted knobs under the TP tick
# ----------------------------------------------------------------------

#: ``tests/test_sharded_dynspec.py``'s TP world: SMALL under MIN_BUSY with
#: a finite stop time, retuned to cut the sends mid-run.
TP_DYN = dict(SMALL, policy=int(Policy.MIN_BUSY), send_stop_time=0.12)
TP_DYN_TICKS, TP_DYN_SHARDS = 60, 4
STOP = {"send_stop_time": 0.04}


def _noop(state, done):
    """A callback (JAX's chunked runners take no donated carry with it)."""


def test_promoted_tp_retune_matches_jax_and_the_static_path():
    """``tests/test_sharded_dynspec.py``'s promoted retune: the retuned
    spec through the operand equals JAX's promoted TP runner and the
    port's host-constant path."""
    from fognetsimpp_tpu import dynspec as jdyn
    from fognetsimpp_tpu_torch import dynspec as tdyn

    spec_j, st_j, net_j, b_j = jsmoke.build(**TP_DYN)
    mesh = make_mesh(TP_DYN_SHARDS, axis_name="node")
    _, ref = jts.run_tp_sharded(
        jdyn.apply_knobs(spec_j, STOP), st_j, net_j, b_j, mesh,
        n_ticks=TP_DYN_TICKS, promote=True,
    )
    spec_t, st_t, net_t, b_t = tsmoke.build(device="cpu", **TP_DYN)
    spec2 = tdyn.apply_knobs(spec_t, STOP)
    out_spec, got = tts.run_tp_sharded(
        spec2, st_t, net_t, b_t, n_shards=TP_DYN_SHARDS, n_ticks=TP_DYN_TICKS,
        promote=True,
    )
    assert out_spec == spec2  # the real spec comes back, not the key
    _assert_leaves_equal(got, _jax_leaves(ref), "promoted TP")
    _, static = tts.run_tp_sharded(
        spec2, st_t, net_t, b_t, n_shards=TP_DYN_SHARDS, n_ticks=TP_DYN_TICKS,
        promote=False,
    )
    _assert_leaves_equal(got, state_to_numpy(static), "promoted vs static TP")
    _, base = tts.run_tp_sharded(
        spec_t, st_t, net_t, b_t, n_shards=TP_DYN_SHARDS, n_ticks=TP_DYN_TICKS,
    )
    assert int(got.metrics.n_published) < int(base.metrics.n_published)


def test_tp_chunked_reconfigure_matches_jax_and_composes():
    """``run_tp_chunked(reconfigure=)`` against JAX's, and against the
    manual ``apply_knobs`` between two ``run_tp_sharded`` calls."""
    from fognetsimpp_tpu import dynspec as jdyn
    from fognetsimpp_tpu_torch import dynspec as tdyn

    half = TP_DYN_TICKS // 2
    calls = []

    def reconf(done):
        calls.append(done)
        return STOP

    spec_j, st_j, net_j, b_j = jsmoke.build(**TP_DYN)
    mesh = make_mesh(TP_DYN_SHARDS, axis_name="node")
    sp_jf, ref = jts.run_tp_chunked(
        spec_j, st_j, net_j, b_j, mesh, chunk_ticks=half, n_ticks=TP_DYN_TICKS,
        donate=False, promote=True, reconfigure=reconf, callback=_noop,
    )
    spec_t, st_t, net_t, b_t = tsmoke.build(device="cpu", **TP_DYN)
    sp_f, got = tts.run_tp_chunked(
        spec_t, st_t, net_t, b_t, n_shards=TP_DYN_SHARDS, chunk_ticks=half,
        n_ticks=TP_DYN_TICKS, reconfigure=reconf,
    )
    assert calls == [half, half]  # JAX's interior boundary, then the port's
    assert dataclasses.asdict(sp_f) == dataclasses.asdict(sp_jf)
    assert sp_f.send_stop_time == pytest.approx(0.04)
    _assert_leaves_equal(got, _jax_leaves(ref), "TP chunked reconfigure")
    sp_a, mid = tts.run_tp_sharded(
        spec_t, st_t, net_t, b_t, n_shards=TP_DYN_SHARDS, n_ticks=half)
    _, manual = tts.run_tp_sharded(
        tdyn.apply_knobs(sp_a, STOP), mid, net_t, b_t, n_shards=TP_DYN_SHARDS,
        n_ticks=half,
    )
    _assert_leaves_equal(got, state_to_numpy(manual), "TP manual composition")
    with pytest.raises(ValueError, match="promote"):
        tts.run_tp_chunked(spec_t, st_t, net_t, b_t, n_shards=2, promote=False,
                           reconfigure=reconf)
    with pytest.raises(ValueError, match="flips a trace gate"):
        tts.run_tp_chunked(spec_t, st_t, net_t, b_t, n_shards=2, chunk_ticks=10,
                           n_ticks=20, reconfigure=lambda d: {"send_stop_time": float("inf")})


def test_tp_whatif_fork_matches_jax_and_cold_runs():
    """``tests/test_sharded_dynspec.py``'s TP what-if: a promoted TP carry
    leaves the shards through ``unstamp_tp_carry`` and forks onto a knob
    grid whose every row equals a direct run of the retuned spec from the
    same carry, and JAX's fork, every leaf."""
    from fognetsimpp_tpu.parallel import sweep as jsweep
    from fognetsimpp_tpu_torch import dynspec as tdyn
    from fognetsimpp_tpu_torch.parallel import sweep as tsweep
    from fognetsimpp_tpu_torch.state import tree_map

    half = TP_DYN_TICKS // 2
    knobs = {"send_stop_time": [0.04, 0.08]}
    spec_j, st_j, net_j, b_j = jsmoke.build(**TP_DYN)
    mesh = make_mesh(TP_DYN_SHARDS, axis_name="node")
    sp_j, carry_j = jts.run_tp_sharded(
        spec_j, st_j, net_j, b_j, mesh, n_ticks=half, promote=True)
    sp_j, carry_j = jts.unstamp_tp_carry(sp_j, carry_j)
    _, ref = jsweep.sweep_dyn_from(sp_j, carry_j, net_j, b_j, knobs, half)

    spec_t, st_t, net_t, b_t = tsmoke.build(device="cpu", **TP_DYN)
    sp_tp, carry_sh = tts.run_tp_sharded(
        spec_t, st_t, net_t, b_t, n_shards=TP_DYN_SHARDS, n_ticks=half)
    sp_w, carry = tts.unstamp_tp_carry(sp_tp, carry_sh)
    assert sp_w.tp_shards == 0 and dataclasses.asdict(sp_w) == dataclasses.asdict(sp_j)
    _assert_leaves_equal(carry, _jax_leaves(carry_j), "TP carry")
    grid, batch = tsweep.sweep_dyn_from(sp_w, carry, net_t, b_t, knobs, half)
    _assert_leaves_equal(batch, _jax_leaves(ref), "TP what-if grid")
    key = tdyn.shape_key(sp_w)
    for i, cell in enumerate(grid):
        dyn = tdyn.dyn_to_device(tdyn.dyn_of(dataclasses.replace(sp_w, **cell)), "cpu")
        cold, _ = tengine.run(key, carry, net_t, b_t, n_ticks=half, dyn=dyn)
        _assert_leaves_equal(tree_map(lambda x, i=i: x[i], batch),
                             state_to_numpy(cold), f"TP what-if row {i}")
    stamped = dataclasses.replace(sp_w, tp_shards=4)
    assert tts.unstamp_tp_carry(stamped, carry)[0].tp_shards == 0
