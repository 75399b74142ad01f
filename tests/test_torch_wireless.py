"""The port's wireless worlds against the JAX package, bit for bit.

Module by module (mobility, association under each MAC keying, the
ordered per-cell sum, energy) on seeded inputs, each ladder builder leaf
for leaf, and each world's ``run`` against the undonated JAX ``run``,
every leaf, with a check that the world exercises its path: a CIRCLE
user that moved, a handover, publishes lost on the uplink, users that
shut down and restarted.  A failure names the first differing leaf and,
by stepping both engines, the first tick at which the states part.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fognetsimpp_tpu import Policy
from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.dynspec import dyn_of as jdyn_of
from fognetsimpp_tpu.net import energy as jenergy
from fognetsimpp_tpu.net import mobility as jmobility
from fognetsimpp_tpu.net import topology as jtopology
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu.scenarios import wireless as jw
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.dynspec import dyn_of
from fognetsimpp_tpu_torch.net import energy as tenergy
from fognetsimpp_tpu_torch.net import mobility as tmobility
from fognetsimpp_tpu_torch.net import topology as ttopology
from fognetsimpp_tpu_torch.ops import cell_kernels as ck
from fognetsimpp_tpu_torch.ops.cell_kernels import cell_sum_ordered, cell_sum_ordered_plain
from fognetsimpp_tpu_torch.parallel.taskshard import run_tp_sharded
from fognetsimpp_tpu_torch.runtime.signals import summarize
from fognetsimpp_tpu_torch.scenarios.cell_sum_inputs import replicas
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.scenarios import wireless as tw
from fognetsimpp_tpu_torch.spec import Stage
from fognetsimpp_tpu_torch.state import (
    NodeState,
    net_from_numpy,
    state_from_numpy,
    state_to_numpy,
    tree_from_numpy,
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


#: tests/test_parity_wireless.py's fast-cycling battery world at dt 10 ms
#: under MIN_BUSY, cut to 3 s: every user dies (from about 0.7 s) and
#: restarts (from about 2.2 s).
CHURN = dict(
    numb_users=8, horizon=3.0, dt=0.01, send_interval=0.1, w_contention=0.0,
    mac_model="linear", policy=int(Policy.MIN_BUSY), energy_capacity_j=0.012,
    tx_energy_j=2e-3, rx_energy_j=1e-4, idle_power_w=2e-3,
    harvest_power_w=4e-3, harvest_period_s=50.0, harvest_duty=0.5,
)

#: Each world: (builder, its arguments), cut to CPU size.
WORLDS = {
    # one linear user, 2 APs, Bianchi keyed
    "wireless": ("wireless", dict(horizon=0.3)),
    # two CircleMobility users among nine linear ones
    "wireless2": ("wireless2", dict(horizon=1.0, dt=5e-3)),
    # the AP chain at a coarse tick: three sends a tick on the (U, R)
    # lanes, a fitted residual loss on top of the Bianchi loss
    "wireless3": ("wireless3", dict(
        horizon=1.0, dt=0.01, send_interval=0.004, max_sends_per_tick=3,
        uplink_loss_prob=0.2,
    )),
    # the 10-AP row: users hand over at about 2.4 s
    "wireless4": ("wireless4", dict(horizon=3.0, dt=0.01)),
    # the publication topology, with a wired static sensor
    "paper": ("paper", dict(horizon=1.0, dt=5e-3)),
    # the full-feature world with energy, ENERGY_AWARE, a grid of 4 APs
    "wireless5": ("wireless5", dict(
        numb_users=40, horizon=1.5, dt=0.01, extra_aps=4,
        policy=int(Policy.ENERGY_AWARE), uplink_loss_prob=0.2,
    )),
    "churn": ("wireless5", CHURN),
}


def _jleaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _first_diff(ref_tree, port_tree):
    """The first leaf (path) whose dtype, shape or bytes differ, or None."""
    paths = [p for p, _ in tree_leaves(port_tree)]
    ref, got = _jleaves(ref_tree), state_to_numpy(port_tree)
    assert len(ref) == len(got) == len(paths)
    for p, a, b in zip(paths, ref, got):
        if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
            return p
    return None


def _build(name, fused=True):
    builder, kw = WORLDS[name]
    j = getattr(jw, builder)(fused_slots=fused, **kw)
    t = getattr(tw, builder)(device="cpu", **kw)
    return j, t


def _handovers(net, spec, st0, st1):
    """Users associated at both states, with different APs."""
    a0 = ttopology.associate(net, st0.nodes.pos, st0.nodes.alive, spec.broker_index).assoc
    a1 = ttopology.associate(net, st1.nodes.pos, st1.nodes.alive, spec.broker_index).assoc
    U = spec.n_users
    return int(((a0[:U] != a1[:U]) & (a0[:U] >= 0) & (a1[:U] >= 0)).sum())


def _expect(name, spec, net, st0, final, track):
    s = summarize(final)
    U = spec.n_users
    moved = (final.nodes.pos[:U] != st0.nodes.pos[:U]).any(dim=1)
    if name == "wireless":
        return s["n_scheduled"] > 0 and bool(moved.all())
    if name == "wireless2":
        circ = final.nodes.mobility[:U] == 2
        return bool(circ.sum() == 2 and moved[circ].all()) and s["n_scheduled"] > 0
    if name == "wireless3":
        return s["n_lost"] > 0 and s["n_scheduled"] > 0
    if name == "wireless4":
        return _handovers(net, spec, st0, final) > 0
    if name == "paper":
        return bool(~net.is_wireless[U - 1]) and int(final.users.send_count[U - 1]) > 0
    if name == "wireless5":
        e0, e1 = st0.nodes.energy[:U], final.nodes.energy[:U]
        return s["n_lost"] > 0 and bool((e1 != e0).all()) and s["n_scheduled"] > 0
    if name == "churn":
        return bool((track["downs"] > 0).any() and (track["ups"] > 0).any())
    raise KeyError(name)


@pytest.fixture(scope="module")
def port_runs():
    """World name -> (spec, net, initial state, final state, alive edges),
    run once a module through ``engine.run``, a tick a call."""
    cache = {}

    def get(name):
        if name not in cache:
            _, kw = WORLDS[name]
            spec, st, net, b = getattr(tw, WORLDS[name][0])(device="cpu", **kw)
            st0, U = st, spec.n_users
            prev = st.nodes.alive[:U]
            downs = torch.zeros(U, dtype=torch.int32)
            ups = torch.zeros(U, dtype=torch.int32)
            for _ in range(spec.n_ticks):
                st, _ = tengine.run(spec, st, net, b, n_ticks=1)
                a = st.nodes.alive[:U]
                downs += (prev & ~a).int()
                ups += (~prev & a).int()
                prev = a
            cache[name] = (spec, net, st0, st, {"downs": downs, "ups": ups})
        return cache[name]

    return get


def _first_diverging_tick(name, fused):
    (spec_j, st_j, net_j, b_j), (spec_t, st_t, net_t, b_t) = _build(name, fused)
    step_j = jax.jit(jengine.make_step(spec_j))
    step_t = tengine.make_step(spec_t)
    for tick in range(spec_j.n_ticks):
        st_j = step_j(st_j, net_j, b_j)
        st_t = step_t(st_t, net_t, b_t)
        leaf = _first_diff(st_j, st_t)
        if leaf is not None:
            return tick, leaf
    return None, None


@pytest.mark.parametrize(
    "name, fused",
    [(n, True) for n in WORLDS] + [("wireless5", False)],
)
def test_run_matches_jax_every_leaf(name, fused, port_runs):
    spec_t, net_t, st0, final_t, track = port_runs(name)
    builder, kw = WORLDS[name]
    spec_j, state_j, net_j, bounds_j = getattr(jw, builder)(fused_slots=fused, **kw)
    assert dataclasses.asdict(spec_j) == dict(dataclasses.asdict(spec_t), fused_slots=fused)
    final_j, _ = jengine.run(spec_j, state_j, net_j, bounds_j)
    leaf = _first_diff(final_j, final_t)
    if leaf is not None:
        tick, first = _first_diverging_tick(name, fused)
        raise AssertionError(
            f"{name} (fused_slots={fused}): leaf {leaf} differs; the states "
            f"first part at tick {tick}, leaf {first}"
        )
    assert _expect(name, spec_t, net_t, st0, final_t, track), (
        f"{name} does not exercise its path"
    )


# ----------------------------------------------------------------------
# the ladder's builders
# ----------------------------------------------------------------------

BUILDS = {
    "wireless": ("wireless", dict(horizon=0.2)),
    "wireless2": ("wireless2", dict(horizon=0.2, seed=3)),
    "wireless3": ("wireless3", dict(numb=5, numb_users=6, horizon=0.2)),
    "wireless4": ("wireless4", dict(numb_users=5, horizon=0.2, seed=2)),
    "wireless5": ("wireless5", dict(numb_users=30, horizon=0.2, extra_aps=9, seed=4)),
    "wireless5_linear": ("wireless5", dict(horizon=0.2, mac_model="linear")),
    "paper": ("paper", dict(horizon=0.2)),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_builders_match_jax_leaf_for_leaf(name):
    builder, kw = BUILDS[name]
    ref = getattr(jw, builder)(**kw)
    got = getattr(tw, builder)(device="cpu", **kw)
    assert dataclasses.asdict(ref[0]) == dataclasses.asdict(got[0])
    for what, a, b in zip(("state", "net", "bounds"), ref[1:], got[1:]):
        assert _first_diff(a, b) is None, f"{name}: {what} differs"


# ----------------------------------------------------------------------
# module by module
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_world(builder, **kw):
    """A JAX world, built once a module (its arrays are immutable)."""
    return getattr(jw, builder)(**kw)


def _random_nodes(n_users, seed, t_scale):
    """A JAX wireless5 world's nodes with seeded random motion: every
    mobility kind, positions inside and outside the area, CIRCLE angles
    past 120 rad at ``t_scale``."""
    spec, st, _, bounds = _jax_world("wireless5", numb_users=n_users, horizon=0.1, mac_model="linear")
    rng = np.random.default_rng(seed)
    N = spec.n_nodes
    f32 = np.float32
    nodes = st.nodes.replace(
        mobility=jnp.asarray(rng.integers(0, 3, N).astype(np.int8)),
        pos=jnp.asarray(rng.uniform(-50, 1050, (N, 2)).astype(f32)),
        vel=jnp.asarray(rng.uniform(-40, 40, (N, 2)).astype(f32)),
        circle_center=jnp.asarray(rng.uniform(0, 1000, (N, 2)).astype(f32)),
        circle_radius=jnp.asarray(rng.uniform(1, 400, N).astype(f32)),
        circle_omega=jnp.asarray(rng.uniform(-0.5, 0.5, N).astype(f32)),
        circle_phase=jnp.asarray(rng.uniform(-7, 7, N).astype(f32)),
    )
    t_next = np.float32(rng.uniform(0, t_scale))
    return spec, nodes, bounds, t_next


@pytest.mark.parametrize("t_scale", [10.0, 1000.0])
@pytest.mark.parametrize("dt", [1e-3, 5e-3, 0.01])
def test_step_mobility_matches_jax(dt, t_scale):
    spec, nodes, bounds, t_next = _random_nodes(4000, seed=int(dt * 1e4 + t_scale), t_scale=t_scale)
    go = jax.jit(jmobility.step_mobility, static_argnums=3)
    want = go(nodes, bounds, jnp.float32(t_next), dt)
    tn = tree_from_numpy(NodeState, _jleaves(nodes), "cpu")
    tb = tmobility.MobilityBounds(
        lo=torch.from_numpy(np.asarray(bounds.lo)), hi=torch.from_numpy(np.asarray(bounds.hi))
    )
    got = tmobility.step_mobility(tn, tb, torch.tensor(t_next), dt)
    for w, g in zip(want, got):
        assert np.asarray(w).tobytes() == g.numpy().tobytes()


def _assoc_inputs(world, seed):
    """A JAX world's net and (pos, alive, offered) with seeded positions
    over the area, some dead nodes and APs, and per-node offered rates
    from idle to past a cell's saturation."""
    if world == "wireless5":
        spec, st, net, _ = _jax_world("wireless5", numb_users=3000, horizon=0.1, extra_aps=59)
        hi = 1000.0
    else:
        spec, st, net, _ = _jax_world("wireless4", numb_users=400, horizon=0.1)
        hi = 1150.0
    rng = np.random.default_rng(seed)
    N, U = spec.n_nodes, spec.n_users
    pos = np.asarray(st.nodes.pos).copy()
    pos[:U] = rng.uniform(0, hi, (U, 2)).astype(np.float32)
    if world == "wireless4":
        pos[:U, 1] = rng.uniform(150, 370, U).astype(np.float32)
    alive = rng.random(N) > 0.1
    a0, a1 = spec.ap_slice
    alive[a0:a1] = rng.random(a1 - a0) > 0.2
    rates = np.array([0.0, 1 / 1.5, 20.0, 1 / 0.05, 500.0, 3000.0], np.float32)
    offered = np.zeros(N, np.float32)
    offered[:U] = rng.choice(rates, U, p=[0.2, 0.3, 0.2, 0.2, 0.07, 0.03])
    return spec, net, pos, alive, offered


@pytest.mark.parametrize("scaled", [False, True], ids=["net", "scaled_net"])
@pytest.mark.parametrize("keying", ["bianchi_keyed", "occupancy", "linear"])
@pytest.mark.parametrize("world", ["wireless5", "wireless4"])
def test_associate_matches_jax(world, keying, scaled):
    """``scaled_net`` makes the propagation term as large as the base
    delay, so the last bit of each node's distance reaches its access
    delay (at the builders' 3.3 ns/m it is lost in the sum)."""
    spec, net_j, pos, alive, offered = _assoc_inputs(world, seed=len(world) + len(keying))
    if keying == "linear":
        empty = jnp.zeros((0,), jnp.float32)
        net_j = net_j.replace(mac_delay_tab=empty, mac_loss_tab=empty)
    if scaled:
        net_j = net_j.replace(w_prop=jnp.float32(7.3e-6), w_base=jnp.float32(1.7e-3))
    off = offered if keying == "bianchi_keyed" else None
    b = spec.broker_index
    go = jax.jit(jtopology.associate, static_argnames="broker")
    want = go(net_j, jnp.asarray(pos), jnp.asarray(alive), broker=b,
              offered_rate=None if off is None else jnp.asarray(off))
    net_t = net_from_numpy(_jleaves(net_j), "cpu")
    got = ttopology.associate(
        net_t, torch.from_numpy(pos), torch.from_numpy(alive), b,
        None if off is None else torch.from_numpy(off),
    )
    assert _first_diff(want, got) is None
    if keying == "bianchi_keyed":  # the loss term is live
        assert (got.mac_loss_p > 0).any()


def _jax_cell_sum(cell, vals, n_cells):
    return np.asarray(jnp.zeros((n_cells + 1,), jnp.float32).at[jnp.asarray(cell)].add(
        jnp.asarray(vals), mode="drop")[:n_cells])


def _cell_case(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "config4":  # 10,069 nodes in 64 cells, inexact rates
        n, A = 10_069, 64
        cell = rng.integers(0, A + 1, n).astype(np.int32)
        vals = rng.choice(np.array([1 / 1.5, 1 / 0.05, 0.1, 1 / 3], np.float32), n)
    elif kind == "one_cell":  # every entry in one cell
        n, A = 10_000, 64
        cell = np.full(n, 17, np.int32)
        vals = (rng.random(n) * 30).astype(np.float32)
    elif kind == "dropped":  # cells at and past n_cells dropped
        n, A = 3000, 10
        cell = rng.integers(0, A + 5, n).astype(np.int32)
        vals = (rng.random(n) * 7).astype(np.float32)
    elif kind == "order":  # the sum's bits follow the order of the adds
        n, A = 4096, 3
        cell = rng.integers(0, A, n).astype(np.int32)
        vals = rng.choice(np.array([1e8, 1.0, -1e8, 3.3, 0.1], np.float32), n)
    else:
        raise KeyError(kind)
    return cell, vals.astype(np.float32), A


@pytest.mark.parametrize("kind", ["config4", "one_cell", "dropped", "order"])
def test_cell_sum_plain_matches_xla_scatter_add(kind):
    cell, vals, A = _cell_case(kind)
    want = _jax_cell_sum(cell, vals, A)
    got = cell_sum_ordered_plain(torch.from_numpy(cell), torch.from_numpy(vals), A)
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()
    # the CPU wrapper is the plain version
    wrap = cell_sum_ordered(torch.from_numpy(cell), torch.from_numpy(vals), A)
    assert wrap.numpy().tobytes() == want.tobytes()
    if kind == "order":  # an exact sum rounded once is another answer
        exact = np.zeros(A, np.float64)
        np.add.at(exact, cell, vals.astype(np.float64))
        assert exact.astype(np.float32).tobytes() != want.tobytes()


def test_cell_sum_keeps_xla_signed_zero_and_empty_cells():
    cell = torch.tensor([0, 0, 2, 5], dtype=torch.int32)
    vals = torch.tensor([-0.0, -0.0, 1.5, 9.0])
    got = cell_sum_ordered_plain(cell, vals, 3)
    want = _jax_cell_sum(cell.numpy(), vals.numpy(), 3)
    assert got.numpy().tobytes() == want.tobytes()
    assert got.tolist() == [0.0, 0.0, 1.5] and not torch.signbit(got[0])


def test_cell_sum_plain_matches_xla_on_flattened_replicas():
    """Config 4's replicas as one sum, the layout of the replica axis:
    replica r's kept cells offset by r * A, its dropped entries at R * A.
    Bit-equal to XLA's scatter-add mapped over the (R, n) input."""
    R = 4
    cell, vals, A = _cell_case("config4")
    perms = [np.random.default_rng(r).permutation(cell.shape[0]) for r in range(R)]
    by_replica = jax.vmap(
        lambda c, v: jnp.zeros((A + 1,), jnp.float32).at[c].add(v, mode="drop")[:A]
    )(jnp.asarray(np.stack([cell[p] for p in perms])),
      jnp.asarray(np.stack([vals[p] for p in perms])))
    flat_cell, flat_vals, n_cells = replicas(cell, vals, A, R)
    assert n_cells == R * A and flat_cell.max() == R * A
    got = cell_sum_ordered_plain(torch.from_numpy(flat_cell), torch.from_numpy(flat_vals),
                                 n_cells)
    assert got.numpy().tobytes() == np.asarray(by_replica).reshape(-1).tobytes()


def test_cell_sum_drops_negative_cells_where_xla_wraps_them():
    """The domain is cell >= 0.  XLA's ``.at[]`` wraps cells -2 .. -(A + 1)
    into cells A - 1 .. 0 (and -1 into the spare slot the slice cuts); the
    port drops every negative cell.  ``associate`` passes only [0, A]."""
    A = 3
    cell = np.array([-1, -2, -4, -5, 0, 2], np.int32)
    vals = np.array([1, 2, 4, 8, 16, 32], np.float32)
    assert _jax_cell_sum(cell, vals, A).tolist() == [20.0, 0.0, 34.0]
    for fn in (cell_sum_ordered_plain, cell_sum_ordered):
        got = fn(torch.from_numpy(cell), torch.from_numpy(vals), A)
        assert got.tolist() == [16.0, 0.0, 32.0]
    kept = cell >= 0
    assert got.numpy().tobytes() == _jax_cell_sum(cell[kept], vals[kept], A).tobytes()


@pytest.mark.parametrize("slots", [132, 264])
def test_cell_sum_tier_rule(slots):
    """The wrapper's tier on an H100 (132 SMs, one block of the one-block
    kernel an SM, and twice as many slots): one block a cell at the wireless tick
    (N = 10,069, A = 64) and with no entries; cell segments at config 4's
    128 replicas flattened (N = 1,288,832, A = 8,192)."""
    def one_block(n, n_cells):
        return ck.one_block_tiles(n, n_cells, slots) <= ck.ONE_BLOCK_MAX_TILES

    assert one_block(10_069, 64) and one_block(0, 8_192)
    assert not one_block(1_288_832, 8_192)
    assert ck.one_block_tiles(10_069, 64, slots) == 3


@pytest.mark.parametrize("seed", [0, 1])
def test_step_energy_matches_jax(seed):
    spec, *_ = jw.wireless5(
        numb_users=10, horizon=0.1, dt=[5e-3, 0.01][seed], mac_model="linear",
        idle_power_w=2e-3 * (1 + seed), tx_energy_j=2e-3, rx_energy_j=1e-4,
        compute_power_w=0.3, harvest_period_s=0.07, harvest_duty=0.4,
    )
    rng = np.random.default_rng(seed)
    N = 20_000
    f32 = np.float32
    cap = rng.choice(np.array([0.05, 0.012, 1.0, 0.0], f32), N)
    args = dict(
        energy=(rng.random(N) * cap * 1.1).astype(f32), capacity=cap,
        has_energy=rng.random(N) < 0.8, alive=rng.random(N) < 0.7,
        tx_count=rng.integers(0, 7, N).astype(np.int32),
        rx_count=rng.integers(0, 40, N).astype(np.int32),
        computing=rng.random(N) < 0.3,
    )
    go = jax.jit(jenergy.step_energy, static_argnums=0)
    for t in (0.005, 0.03, 0.0699, 0.07, 1.23):
        t32 = np.float32(t)
        want = go(spec, args["energy"], args["capacity"], args["has_energy"],
                  args["alive"], jnp.float32(t32), args["tx_count"],
                  args["rx_count"], args["computing"])
        th = {k: torch.from_numpy(v) for k, v in args.items()}
        got = tenergy.step_energy(
            dyn_of(spec), th["energy"], th["capacity"], th["has_energy"],
            th["alive"], torch.tensor(t32), th["tx_count"], th["rx_count"],
            th["computing"],
        )
        for w, g in zip(want, got):
            assert np.asarray(w).tobytes() == g.numpy().tobytes(), t
    assert jdyn_of(spec).energy_idle_dt == dyn_of(spec).energy_idle_dt


def test_offered_rate_vector_matches_jax():
    spec, st, *_ = jw.wireless5(numb_users=500, horizon=0.2, send_stop_time=0.1)
    rng = np.random.default_rng(9)
    U = spec.n_users
    users = st.users.replace(
        connected=jnp.asarray(rng.random(U) < 0.8),
        send_count=jnp.asarray(rng.integers(0, spec.max_sends_per_user + 1, U).astype(np.int32)),
        next_send=jnp.asarray(np.where(rng.random(U) < 0.1, np.inf, rng.random(U)).astype(np.float32)),
        send_interval=jnp.asarray(rng.choice(np.array([1.5, 0.05, 0.3], np.float32), U)),
    )
    alive = jnp.asarray(rng.random(U) < 0.9)
    port = state_from_numpy(_jleaves(st.replace(users=users)), "cpu")
    for t0 in (0.05, 0.1, 0.15):
        want = jengine.offered_rate_vector(spec, alive, users, jnp.float32(t0))
        got = tengine.offered_rate_vector(
            spec, torch.from_numpy(np.asarray(alive)), port.users,
            torch.tensor(np.float32(t0)), dyn_of(spec),
        )
        assert np.asarray(want).tobytes() == got.numpy().tobytes()


# ----------------------------------------------------------------------
# carrying a world across, wired worlds with the wireless features, gates
# ----------------------------------------------------------------------

def test_wireless_world_carried_across_runs_like_jax():
    """A JAX wireless5 world (MAC tables, energy leaves) as numpy leaves
    becomes the port's world; both runs give the same leaves."""
    spec, st_j, net_j, b_j = jw.wireless5(numb_users=12, horizon=0.5, dt=0.01, extra_aps=1)
    assert np.asarray(net_j.mac_delay_tab).size > 0
    assert bool(np.asarray(st_j.nodes.has_energy).any())
    st = state_from_numpy(_jleaves(st_j), "cpu")
    net = net_from_numpy(_jleaves(net_j), "cpu")
    b = tmobility.MobilityBounds(
        lo=torch.from_numpy(np.asarray(b_j.lo)), hi=torch.from_numpy(np.asarray(b_j.hi))
    )
    final_t, _ = tengine.run(spec, st, net, b)
    final_j, _ = jengine.run(spec, st_j, net_j, b_j)
    assert _first_diff(final_j, final_t) is None
    assert _first_diff(net_j, net) is None


@pytest.mark.parametrize("kw", [
    dict(energy_enabled=True, uplink_loss_prob=0.1, horizon=0.1),
    dict(energy_enabled=True, uplink_loss_prob=0.3, horizon=0.2, n_users=64,
         n_fogs=4, send_interval=0.004, dt=0.01, max_sends_per_tick=3,
         idle_power_w=0.5, compute_power_w=1.0),
])
def test_wired_smoke_world_with_energy_and_uplink_loss_matches_jax(kw):
    spec_j, st_j, net_j, b_j = jsmoke.build(**kw)
    spec_t, st_t, net_t, b_t = tsmoke.build(device="cpu", **kw)
    final_j, _ = jengine.run(spec_j, st_j, net_j, b_j)
    final_t, _ = tengine.run(spec_t, st_t, net_t, b_t)
    assert _first_diff(final_j, final_t) is None
    assert int(final_t.metrics.n_lost) == 0  # wired senders lose nothing


def test_run_refuses_a_static_world_with_bianchi_tables():
    spec, st, net, b = tw.wireless(device="cpu", horizon=0.05)
    spec = dataclasses.replace(spec, assume_static=True, mac_keyed=False)
    with pytest.raises(ValueError, match="SPEC-STATIC-MAC"):
        tengine.run(spec, st, net, b)
    with pytest.raises(ValueError, match="SPEC-STATIC-MAC"):
        tengine.make_step(spec)(st, net, b)


def test_tp_runner_refuses_access_points():
    """Access points under the task-sharded tick (item 26): a static
    linear-MAC AP world at 2 shards equals the port's ``run`` and JAX
    ``run_tp_sharded`` on every leaf, the APs' ``assoc_sum`` included; a
    moving AP world is still refused (``TP-DYNTOPO``)."""
    from fognetsimpp_tpu.parallel import make_mesh
    from fognetsimpp_tpu.parallel import taskshard as jts

    kw = dict(numb_users=24, horizon=0.05, mac_model="linear",
              energy_enabled=False, assume_static=True)
    spec, st, net, b = tw.wireless5(device="cpu", **kw)
    ref, _ = tengine.run(spec, st, net, b)
    spec, st, net, b = tw.wireless5(device="cpu", **kw)
    _, got = run_tp_sharded(spec, st, net, b, n_shards=2)
    assert [x.tobytes() for x in state_to_numpy(got)] == [
        x.tobytes() for x in state_to_numpy(ref)
    ]
    js, jst, jn, jb = jw.wireless5(**kw)
    _, want = jts.run_tp_sharded(js, jst, jn, jb, make_mesh(2, axis_name="node"))
    assert _first_diff(want, got) is None
    a0, a1 = spec.ap_slice
    # every tick adds the (static) association counts into the AP rows
    n_assoc = int(got.nodes.assoc_sum[a0:a1].sum())
    assert n_assoc > 0 and n_assoc % spec.n_ticks == 0
    spec, st, net, b = tw.wireless5(device="cpu", horizon=0.05)
    with pytest.raises(ValueError, match="TP-DYNTOPO"):
        run_tp_sharded(spec, st, net, b, n_shards=2)


def test_wireless_builders_need_a_device_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tw.wireless(horizon=0.05)


@pytest.mark.parametrize("multi", [False, True], ids=["spawn", "spawn_multi"])
def test_uplink_loss_threshold_rounds_once_as_xla(multi):
    """A publish is lost where its draw ``u < 1 - (1 - p)(1 - mac)``.  XLA
    computes the threshold with one fused multiply-add; each user's
    ``mac_loss_p`` is chosen here so that the fused and the twice-rounded
    threshold fall on either side of its draw, and the port's spawn must
    lose exactly JAX's publishes."""
    from fognetsimpp_tpu.core.engine import TickBuf as JTickBuf
    from fognetsimpp_tpu_torch.f32math import fma
    from fognetsimpp_tpu_torch.random import split, uniform

    kw = dict(numb_users=3000, horizon=0.2, dt=0.01, uplink_loss_prob=0.3)
    if multi:
        kw.update(send_interval=0.004, max_sends_per_tick=3)
    spec, st_j, net_j, _ = jw.wireless5(**kw)
    U, R = spec.n_users, spec.max_sends_per_tick
    users = st_j.users.replace(
        connected=jnp.ones((U,), bool), next_send=jnp.zeros((U,), jnp.float32)
    )
    st_j = st_j.replace(users=users)
    key = torch.from_numpy(np.asarray(st_j.key).astype(np.int64))
    k_loss = split(key, 3)[2] if multi else split(key, 4)[3]
    u = uniform(k_loss, (U, R) if multi else (U,))
    u = (u[:, 0] if multi else u).double()
    # search the float32 grid around 1 - (1 - u)/(1 - p) for a mac loss
    # where the two roundings of the threshold disagree about u
    p32 = torch.tensor(np.float32(0.3))
    m0 = (1 - (1 - u) / (1 - p32.double())).float().clamp(0.0, 0.999)
    one = torch.ones(U)
    found = torch.zeros(U, dtype=torch.bool)
    mac = torch.zeros(U)
    for k in range(-48, 49):
        m = (m0.view(torch.int32) + k).view(torch.float32).clamp(0.0, 0.999)
        fused = fma(-(1 - p32).expand(U), 1 - m, one).double()
        twice = (1 - (1 - p32) * (1 - m)).double()
        split_here = ((u < fused) != (u < twice)) & ~found
        mac = torch.where(split_here, m, mac)
        found |= split_here
    assert int(found.sum()) > 100
    cache_j = jtopology.associate(net_j, st_j.nodes.pos, st_j.nodes.alive, broker=spec.broker_index)
    N = spec.n_nodes
    mac_n = np.zeros(N, np.float32)
    mac_n[:U] = mac.numpy()
    cache_j = cache_j.replace(mac_loss_p=jnp.asarray(mac_n))
    i32 = jnp.int32
    buf_j = JTickBuf(
        tx_u=jnp.zeros((U,), i32), rx_u=jnp.zeros((U,), i32),
        tx_f=jnp.zeros((spec.n_fogs,), i32), rx_f=jnp.zeros((spec.n_fogs,), i32),
        tx_b=jnp.zeros((), i32), rx_b=jnp.zeros((), i32),
    )
    t0, t1 = jnp.float32(0.0), jnp.float32(spec.dt)
    phase_j = jengine._phase_spawn_multi if multi else jengine._phase_spawn
    want = jax.jit(lambda s, c: phase_j(spec, s, net_j, c, buf_j, t0, t1)[0])(st_j, cache_j)
    st_t = state_from_numpy(_jleaves(st_j), "cpu")
    net_t = net_from_numpy(_jleaves(net_j), "cpu")
    cache_t = ttopology.LinkCache(
        **{k: torch.from_numpy(np.array(getattr(cache_j, k))) for k in
           ("assoc", "n_assoc", "attach_now", "acc_delay", "reachable", "d2b", "mac_loss_p")}
    )
    buf_t = tengine.TickBuf(*[torch.from_numpy(np.asarray(x)) for x in buf_j])
    phase_t = tengine._phase_spawn_multi if multi else tengine._phase_spawn
    got, _ = phase_t(spec, st_t, net_t, cache_t, buf_t, torch.tensor(0.0),
                     torch.tensor(np.float32(spec.dt)), dyn_of(spec))
    assert _first_diff(want, got) is None
    lost = got.tasks.stage.reshape(U, -1)[:, 0] == int(Stage.LOST)
    fused = fma(-(1 - p32).expand(U), 1 - mac, one).double()
    twice = (1 - (1 - p32) * (1 - mac)).double()
    assert torch.equal(lost[found], (u < fused)[found])
    assert not torch.equal(lost[found], (u < twice)[found])


def test_tp_runner_draws_the_uplink_loss_as_engine_run():
    """A wired world with a fitted uplink loss under four shards: every
    shard draws the loss at the global width (wired senders lose nothing)
    and the run equals ``engine.run``, every leaf."""
    kw = dict(n_users=16, n_fogs=3, horizon=0.05, send_interval=0.01, uplink_loss_prob=0.2)
    spec, st, net, b = tsmoke.build(device="cpu", **kw)
    ref, _ = tengine.run(spec, st, net, b)
    spec, st, net, b = tsmoke.build(device="cpu", **kw)
    _, got = run_tp_sharded(spec, st, net, b, n_shards=4)
    for x, y in zip(state_to_numpy(ref), state_to_numpy(got)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert int(got.metrics.n_published) > 0
