"""The v2 hybrid broker's shared release timer and the POOL fogs' depth,
port against JAX, and the local-pool scan against ``jax.lax.scan``.

- The hand-placed worlds of ``tests/test_v1v2.py``: a pending release
  fire between two same-tick arrivals, the first accept cancelling it, its
  refund visible to a later accept, and same-tick arrivals deeper than
  ``pool_phases``.  Each world is built by the JAX package, laid into the
  port's tree, stepped by both ``make_step``s (JAX's compiled, as its
  ``run`` compiles it) and held leaf for leaf, with that file's own
  assertions on the port's state.
- One step from each tick where the periodic advert's float32 period
  count depends on how XLA evaluates it.
- :func:`~fognetsimpp_tpu_torch.ops.pool_kernels.local_pool_scan_plain`
  (the kernel's plain version) against ``jax.lax.scan`` of the JAX
  engine's two scan bodies.
- ``run_replicated`` on a 4-replica v2 hybrid world against JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fognetsimpp_tpu import FogModel, Policy, Stage
from fognetsimpp_tpu.core.engine import make_step as jmake_step
from fognetsimpp_tpu.net.mobility import default_bounds as jbounds
from fognetsimpp_tpu.net.topology import wired_star as jwired_star
from fognetsimpp_tpu.parallel import replicas as jreplicas
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu.spec import WorldSpec as JWorldSpec
from fognetsimpp_tpu.state import init_state as jinit_state
from fognetsimpp_tpu_torch.core.engine import make_step as tmake_step
from fognetsimpp_tpu_torch.net.mobility import default_bounds as tbounds
from fognetsimpp_tpu_torch.ops.pool_kernels import local_pool_scan
from fognetsimpp_tpu_torch.parallel import replicas as treplicas
from fognetsimpp_tpu_torch.parallel.replicas import strict_vmap
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.spec import WorldSpec as TWorldSpec
from fognetsimpp_tpu_torch.state import net_from_numpy, state_from_numpy
from tests.test_torch_v1v2 import assert_same


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _port_of(kw, jstate, jnet):
    """The port's spec, state and net for a JAX-built world."""
    spec = TWorldSpec(**kw).validate()
    return (spec, state_from_numpy(_leaves(jstate), "cpu"),
            net_from_numpy(_leaves(jnet), "cpu"))


def _v2_timer_world(pool, a_mips, b_mips, timer=0.005):
    """``tests/test_v1v2.py::_v2_timer_world``: two hand-placed same-tick
    arrivals (0.002, 0.008) around a pending shared-timer fire, plus one
    stored expired request of 100 MIPS.  Both packages step it once and
    must agree on every leaf; returns ``(the port's spec, its stepped
    state, the stored request's slot)``."""
    kw = dict(
        n_users=2, n_fogs=1, dt=0.01, horizon=0.02,
        policy=int(Policy.LOCAL_FIRST), v2_local_broker=True,
        broker_mips=pool, connect_gating=False, max_sends_per_user=2,
    )
    spec = JWorldSpec(**kw).validate()
    state = jinit_state(spec)
    S = spec.max_sends_per_user
    state = state.replace(users=state.users.replace(publisher=jnp.zeros((2,), bool)))
    tasks = state.tasks
    inflight = jnp.int8(int(Stage.PUB_INFLIGHT))

    def put(col, i, v):
        return col.at[i].set(v)

    a, b, r = 0 * S + 0, 1 * S + 0, 0 * S + 1
    tasks = tasks.replace(
        stage=put(put(put(tasks.stage, a, inflight), b, inflight),
                  r, jnp.int8(int(Stage.LOCAL_RUN))),
        t_at_broker=put(put(put(tasks.t_at_broker, a, 0.002), b, 0.008), r, -0.01),
        t_create=put(put(put(tasks.t_create, a, 0.002), b, 0.008), r, -0.01),
        mips_req=put(put(put(tasks.mips_req, a, a_mips), b, b_mips), r, 100.0),
        req_open=put(tasks.req_open, r, jnp.int8(1)),
    )
    state = state.replace(
        tasks=tasks,
        broker=state.broker.replace(release_timer_t=jnp.asarray(timer)),
    )
    net = jwired_star(spec.n_nodes, packet_bytes=spec.task_bytes)
    tspec, tstate, tnet = _port_of(kw, state, net)
    jout = jax.jit(jmake_step(spec))(state, net, jbounds(1000.0))
    tout = tmake_step(tspec)(tstate, tnet, tbounds(1000.0, "cpu"))
    assert_same(tout, jout, "v2 timer world")
    return tspec, tout, r


def test_v2_release_fire_between_same_tick_arrivals():
    """The 0.005 fire lies between the arrivals: the later accept cannot
    cancel it, so the stored request completes at 0.005 and refunds its
    100 MIPS, the accept debits 400, and its reschedule is installed."""
    spec, out, r = _v2_timer_world(pool=500.0, a_mips=600.0, b_mips=400.0)
    assert int(out.tasks.stage[r]) == int(Stage.DONE)
    np.testing.assert_allclose(float(out.tasks.t_complete[r]), 0.005, atol=1e-6)
    np.testing.assert_allclose(float(out.broker.local_pool), 500.0 + 100.0 - 400.0)
    np.testing.assert_allclose(
        float(out.broker.release_timer_t), 0.008 + spec.required_time, rtol=1e-6
    )


def test_v2_first_accept_cancels_pending_timer():
    spec, out, r = _v2_timer_world(pool=500.0, a_mips=400.0, b_mips=50.0)
    assert int(out.tasks.stage[r]) == int(Stage.LOCAL_RUN)
    np.testing.assert_allclose(float(out.broker.local_pool), 500 - 400 - 50)
    np.testing.assert_allclose(
        float(out.broker.release_timer_t), 0.008 + spec.required_time, rtol=1e-6
    )


def test_v2_fire_refund_visible_to_later_accept():
    spec, out, r = _v2_timer_world(pool=500.0, a_mips=600.0, b_mips=550.0)
    assert int(out.tasks.stage[r]) == int(Stage.DONE)
    np.testing.assert_allclose(float(out.tasks.t_complete[r]), 0.005, atol=1e-6)
    np.testing.assert_allclose(float(out.broker.local_pool), 500 + 100 - 550)
    np.testing.assert_allclose(
        float(out.broker.release_timer_t), 0.008 + spec.required_time, rtol=1e-6
    )


def test_pool_same_tick_depth_beyond_phases_is_benign():
    """Seven same-tick arrivals at one POOL fog, ``pool_phases=4``: four
    are decided in the tick, three a tick later at their own arrival
    times, both ticks equal to JAX's on every leaf."""
    n = 7
    kw = dict(
        n_users=n, n_fogs=1, dt=1e-3, horizon=0.01, app_gen=2,
        fog_model=int(FogModel.POOL), adv_periodic=False,
        adv_on_completion=False, connect_gating=False,
        max_sends_per_user=1, pool_phases=4,
    )
    spec = JWorldSpec(**kw).validate()
    state = jinit_state(spec)
    state = state.replace(
        users=state.users.replace(publisher=jnp.zeros((n,), bool)),
        fogs=state.fogs.replace(
            mips=jnp.full((1,), 1e5, jnp.float32),
            pool_avail=jnp.full((1,), 1e5, jnp.float32),
        ),
    )
    t_arr = 1e-4 + jnp.arange(n, dtype=jnp.float32) * 1e-6
    state = state.replace(tasks=state.tasks.replace(
        stage=jnp.full((n,), jnp.int8(int(Stage.TASK_INFLIGHT))),
        fog=jnp.zeros((n,), jnp.int32),
        mips_req=jnp.full((n,), 500.0, jnp.float32),
        t_create=t_arr, t_at_broker=t_arr, t_at_fog=t_arr,
    ))
    net = jwired_star(spec.n_nodes, packet_bytes=spec.task_bytes)
    tspec, tstate, tnet = _port_of(kw, state, net)
    jstep, tstep = jax.jit(jmake_step(spec)), tmake_step(tspec)
    j1 = jstep(state, net, jbounds(1000.0))
    t1 = tstep(tstate, tnet, tbounds(1000.0, "cpu"))
    assert_same(t1, j1, "depth, tick 1")
    st1 = t1.tasks.stage.numpy()
    assert (st1 == int(Stage.RUNNING)).sum() == spec.pool_phases
    assert (st1 == int(Stage.TASK_INFLIGHT)).sum() == n - spec.pool_phases
    j2 = jstep(j1, net, jbounds(1000.0))
    t2 = tstep(t1, tnet, tbounds(1000.0, "cpu"))
    assert_same(t2, j2, "depth, tick 2")
    assert (t2.tasks.stage.numpy() == int(Stage.RUNNING)).sum() == n
    np.testing.assert_allclose(
        t2.tasks.t_service_start.numpy(), np.asarray(t_arr), atol=1e-7
    )
    np.testing.assert_allclose(float(t2.fogs.pool_avail[0]), 1e5 - n * 500.0)


# ----------------------------------------------------------------------
# the local-pool scan against jax.lax.scan of the engine's bodies
# ----------------------------------------------------------------------

def _jax_scan(m, v, t, pool0, fire_t0, refund0, v2):
    """The JAX engine's scan bodies (``_phase_broker``, LOCAL_FIRST)."""
    if not v2:
        def body(pool, xs):
            mm, vv = xs
            take = vv & (mm < pool)
            return pool - jnp.where(take, mm, 0.0), take

        pool, take = jax.lax.scan(body, pool0, (m, v))
        return take, pool, jnp.zeros((), bool)

    def body2(carry, xs):
        pool, armed, fired = carry
        mm, vv, tt = xs
        fire_now = armed & vv & (tt >= fire_t0)
        pool = pool + jnp.where(fire_now, refund0, 0.0)
        fired = fired | fire_now
        armed = armed & ~fire_now
        take = vv & (mm < pool)
        pool = pool - jnp.where(take, mm, 0.0)
        armed = armed & ~take
        return (pool, armed, fired), take

    (pool, _, fired), take = jax.lax.scan(
        body2, (pool0, jnp.isfinite(fire_t0), jnp.zeros((), bool)), (m, v, t)
    )
    return take, pool, fired


def _scan_case(kind, seed, K=257):
    """A window sorted by time: MIPS on a coarse grid (ties), some rows
    invalid, times with repeats; ``kind`` picks the pool and the timer,
    or the window's length (``k1``, ``k33``)."""
    K = {"k1": 1, "k33": 33}.get(kind, K)
    rng = np.random.default_rng(seed)
    m = rng.choice(np.float32([100, 250, 400, 400, 733]), K).astype(np.float32)
    v = rng.random(K) < 0.8
    t = np.sort(np.round(rng.random(K) * 0.01, 3)).astype(np.float32)
    pool0, fire, refund = np.float32(5000.0), np.float32(0.004), np.float32(333.0)
    if kind == "exhausted":  # the pool runs out in the middle of the window
        pool0 = np.float32(20000.0)
    elif kind == "no_timer":
        fire = np.float32(np.inf)
    elif kind == "fire_at_a_row":  # the fire time equals a row's time
        fire = t[K // 2]
    elif kind == "tiny_pool":
        pool0 = np.float32(99.5)
    elif kind == "neg_zero_pool":
        pool0 = np.float32(-0.0)
    elif kind == "ties":  # the pool equals the first valid row's MIPS
        pool0 = m[v][0]
    elif kind == "fire_first_row":  # the timer is due at the first row
        fire = t[0]
    elif kind == "take_before_fire":  # the first take disarms it
        fire = t[-1]
    elif kind == "all_invalid":
        v[:] = False
    return m, v, t, pool0, fire, refund


@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("kind", [
    "exhausted", "no_timer", "fire_at_a_row", "tiny_pool", "neg_zero_pool", "ties",
    "fire_first_row", "take_before_fire", "all_invalid", "k1", "k33",
])
def test_local_pool_scan_plain_matches_lax_scan(kind, v2):
    m, v, t, pool0, fire, refund = _scan_case(kind, seed=len(kind) * 7 + v2)
    want = _jax_scan(jnp.asarray(m), jnp.asarray(v), jnp.asarray(t),
                     jnp.float32(pool0), jnp.float32(fire), jnp.float32(refund), v2)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    got = local_pool_scan(torch.from_numpy(m), torch.from_numpy(v), torch.from_numpy(t),
                          f32(pool0), f32(fire), f32(refund), v2)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.numpy().tobytes() == w.tobytes()
    take = got[0].numpy()
    assert (take <= v).all()  # an invalid row is never taken
    if kind == "exhausted":  # the first rows fit, later ones are refused
        assert take[v][:10].all() and (~take[v]).any()
    if kind == "tiny_pool" and not v2:
        assert not take.any()
    if kind == "tiny_pool" and v2:  # only the timer's refund funds a take
        assert bool(got[2]) and take.any()
    if kind == "neg_zero_pool":  # v1 keeps -0.0; v2 folds it into +0.0, then fires
        assert np.signbit(got[1].numpy()) != v2 and bool(got[2]) == v2
    if kind == "ties":  # the tie is refused, smaller rows after it are taken
        assert not take[np.argmax(v)] and take.any()
    if kind == "fire_first_row" and v2:
        assert bool(got[2])
    if kind == "take_before_fire":
        assert take[np.argmax(v)] and not bool(got[2])
    if kind == "all_invalid":
        assert not take.any() and not bool(got[2])
    assert take.shape == (m.shape[0],)


# ----------------------------------------------------------------------
# replicas of the v2 hybrid world
# ----------------------------------------------------------------------

V2_HYBRID = dict(
    n_users=6, n_fogs=2, fog_mips=(1024.0, 2048.0), send_interval=0.004,
    horizon=0.08, dt=1e-3, start_time_max=0.02, app_gen=2,
    fog_model=int(FogModel.POOL), policy=int(Policy.LOCAL_FIRST),
    broker_mips=2048.0, v2_local_broker=True, adv_on_completion=False,
    adv_periodic=True, max_sends_per_user=24, arrival_window=16,
)


def test_run_replicated_v2_hybrid_matches_jax_every_leaf():
    R, seed = 4, 3
    spec, state, net, bounds = jsmoke.build(**V2_HYBRID)
    jbatch = jreplicas.replicate_state(spec, state, R, seed=seed)
    jfinal = jreplicas.run_replicated(spec, jbatch, net, bounds)
    spec, state, net, bounds = tsmoke.build(device="cpu", **V2_HYBRID)
    batch = treplicas.replicate_state(spec, state, R, seed=seed)
    assert_same(batch, jbatch, "replicate_state")
    with strict_vmap():
        final = treplicas.run_replicated(spec, batch, net, bounds)
    assert_same(final, jfinal, "run_replicated")
    m = final.metrics
    assert (m.n_local > 0).all() and (m.n_scheduled > 0).any()


# ----------------------------------------------------------------------
# the periodic advert's boundary ticks
# ----------------------------------------------------------------------

def _boundary_ticks(dt, adv, n=20_000, at_most=3):
    """Ticks where ``floor(tick * dt / adv)`` in float32 depends on how it
    is evaluated: XLA's folded product ``tick * (dt * (1 / adv))`` against
    the reciprocal product of ``tick * dt`` and the IEEE division."""
    f32 = np.float32
    tick = np.arange(n, dtype=np.int32)
    t0 = tick.astype(f32) * f32(dt)
    folded = np.floor(tick.astype(f32) * (f32(dt) * (f32(1.0) / f32(adv))))
    recip = np.floor(t0 * (f32(1.0) / f32(adv)))
    div = np.floor(t0 / f32(adv))
    ticks = []
    for other in (recip, div):
        # the tick before a parting boundary fires on one form only
        ticks += [int(t) - 1 for t in np.nonzero(folded != other)[0][:at_most] if t > 0]
    return sorted(set(ticks))


@pytest.mark.parametrize("fog_model", [int(FogModel.FIFO), int(FogModel.POOL)])
def test_periodic_advert_boundary_ticks_match_jax(fog_model):
    """One step from each tick where the advert period's float32 forms
    part (dt 0.2 ms, the 10 ms interval of ``tests/test_parity.py``'s v1/v2
    worlds): the fire and its time equal JAX's on every leaf."""
    dt = 2e-4
    kw = dict(horizon=0.02, dt=dt, n_users=2, n_fogs=2, fog_mips=(1000.0, 2000.0),
              fog_model=fog_model, app_gen=2 if fog_model else 3,
              policy=int(Policy.MAX_MIPS), adv_periodic=True, adv_on_completion=False)
    spec, state, net, bounds = jsmoke.build(**kw)
    ticks = _boundary_ticks(dt, spec.adv_interval)
    assert ticks  # the forms do part at this dt
    tspec = tsmoke.build(device="cpu", **kw)[0]
    jstep, tstep = jax.jit(jmake_step(spec)), tmake_step(tspec)
    for n in ticks:
        st = state.replace(tick=jnp.int32(n), t=jnp.float32(n * dt))
        tst, tnet = state_from_numpy(_leaves(st), "cpu"), net_from_numpy(_leaves(net), "cpu")
        assert_same(tstep(tst, tnet, tbounds(1000.0, "cpu")),
                    jstep(st, net, bounds), f"tick {n}")
