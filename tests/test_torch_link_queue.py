"""DropTail link queues and the full arrival front, port against JAX.

``tests/test_link_queue.py``'s two worlds (600 users publishing every
1 ms through the broker's 100 Mbps egress, which saturates, and 10 users
at the reference scenarios' 50 ms, which never touch the queue), each
with the queues on and off, and the full-table arrival front
(``two_stage_arrivals=False``) on ``tests/test_compaction.py``'s
saturated world: the port's ``run`` against JAX ``run`` on the CPU,
every leaf (dtype, shape and bits), then that file's own assertions on
the port's states.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.core.engine import make_step as jmake_step
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.core.engine import make_step as tmake_step
from fognetsimpp_tpu_torch.net.mobility import default_bounds as tbounds
from fognetsimpp_tpu_torch.runtime.signals import summarize
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.spec import Stage
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


def _kw(enabled, n_users, interval, horizon=0.2, rate=100e6):
    """``tests/test_link_queue.py::_build``'s arguments."""
    return dict(
        n_users=n_users, n_fogs=4, fog_mips=(20000.0, 30000.0, 25000.0, 35000.0),
        send_interval=interval, horizon=horizon, dt=1e-3,
        max_sends_per_user=int(horizon / interval) + 4, arrival_window=2048,
        queue_capacity=256, wired_queue_enabled=enabled, link_rate_bps=rate,
    )


def _run_both(kw):
    spec, st, net, b = tsmoke.build(device="cpu", **kw)
    final, _ = tengine.run(spec, st, net, b)
    js, jst, jn, jb = jsmoke.build(**kw)
    assert_same(final, jengine.run(js, jst, jn, jb)[0], str(kw))
    return spec, final


def _h1(f):
    t0 = f.tasks.t_create.double().numpy()
    a4 = f.tasks.t_ack4_fwd.double().numpy()
    ok = np.isfinite(t0) & np.isfinite(a4)
    return a4[ok] - t0[ok]


def test_saturated_link_matches_jax_and_delays_and_drops():
    spec, final = _run_both(_kw(True, n_users=600, interval=1e-3))
    m = final.metrics
    assert int(m.n_link_drops) > 1000, int(m.n_link_drops)
    assert summarize(final)["n_link_drops"] == int(m.n_link_drops)
    assert int(m.n_lost) > 10_000, int(m.n_lost)
    _, base = _run_both(_kw(False, n_users=600, interval=1e-3))
    q_full = spec.link_queue_frames * spec.task_bytes * 8 / spec.link_rate_bps
    assert _h1(final).mean() > _h1(base).mean() * 1.05
    assert _h1(final).max() > _h1(base).max() + 0.5 * q_full


def test_committed_scenario_loads_match_jax_and_never_saturate():
    _, final = _run_both(_kw(True, n_users=10, interval=0.05))
    assert int(final.metrics.n_link_drops) == 0
    assert int(final.metrics.n_lost) == 0
    assert float(final.nodes.link_backlog.max()) == 0.0
    _, base = _run_both(_kw(False, n_users=10, interval=0.05))
    assert (final.tasks.fog == base.tasks.fog).all()
    a_on, a_off = final.tasks.t_ack6.numpy(), base.tasks.t_ack6.numpy()
    both = np.isfinite(a_on) & np.isfinite(a_off)
    np.testing.assert_allclose(a_on[both], a_off[both], rtol=1e-6)


def test_full_arrival_front_matches_jax_and_the_two_stage_front():
    """``tests/test_compaction.py``'s saturated world (queues of 4, so the
    fast drop runs): each front equals JAX's; the two fronts' task
    columns and counters agree, as that test holds them."""
    kw = dict(
        horizon=0.5, send_interval=0.002, dt=1e-3, n_users=48, n_fogs=3,
        fog_mips=(400.0, 800.0, 1200.0), queue_capacity=4, start_time_max=0.004,
    )
    _, f_full = _run_both(dict(kw, two_stage_arrivals=False))
    assert int(f_full.metrics.n_dropped) > 0  # the fast drop ran
    _, f_two = _run_both(dict(kw, two_stage_arrivals=True))
    for col in ("stage", "fog", "t_at_broker", "t_at_fog", "t_service_start",
                "t_complete", "t_q_enter", "t_ack5", "t_ack4_queued", "t_ack6",
                "queue_time_ms", "mips_req"):
        a, b = getattr(f_two.tasks, col).numpy(), getattr(f_full.tasks, col).numpy()
        assert a.tobytes() == b.tobytes(), col
    for m in ("n_scheduled", "n_completed", "n_dropped", "n_published"):
        assert int(getattr(f_two.metrics, m)) == int(getattr(f_full.metrics, m)), m
    assert (f_full.tasks.stage == int(Stage.DROPPED)).any()


def test_droptail_arithmetic_matches_jax_compiled_step():
    """One step of a world whose every wired node holds a non-integral
    backlog and a drop probability: the backlog delays every publish's
    arrival (``d2b + qdelay + qdelay[broker]``), the drop probabilities
    meet the tail-drop draw, and the integration adds a tick's traffic.
    JAX's step is compiled, as its ``run`` compiles it, so its float32
    contractions are the reference's."""
    kw = _kw(True, n_users=64, interval=1e-3, horizon=0.01)
    spec, state, net, bounds = jsmoke.build(**dict(kw, start_time_max=1e-6,
                                                    connect_gating=False))
    rng = np.random.default_rng(9)
    N = spec.n_nodes
    backlog = (rng.random(N) * 5120.0).astype(np.float32)
    drop_p = (rng.random(N) * 0.5).astype(np.float32)
    state = state.replace(nodes=state.nodes.replace(
        link_backlog=jnp.asarray(backlog), link_drop_p=jnp.asarray(drop_p)))
    tst = state_from_numpy([np.asarray(x) for x in jax.tree_util.tree_leaves(state)], "cpu")
    tnet = net_from_numpy([np.asarray(x) for x in jax.tree_util.tree_leaves(net)], "cpu")
    tspec = tsmoke.build(device="cpu", **dict(kw, start_time_max=1e-6,
                                               connect_gating=False))[0]
    j1 = jax.jit(jmake_step(spec))(state, net, bounds)
    t1 = tmake_step(tspec)(tst, tnet, tbounds(1000.0, "cpu"))
    assert_same(t1, j1, "one DropTail step")
    assert int(t1.metrics.n_published) == spec.n_users
