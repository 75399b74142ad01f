"""The shipped v2 demo and the link warm-up, port against JAX.

- ``scenarios/example.build`` with its horizon cut to 1.3 s, past the
  1.0414 s link-up and both drain phases (the 7-frame burst and the
  trickle): the port's ``run`` against JAX ``run``, every leaf, and
  ``run_chunked`` (the link knobs then a device operand) against JAX's
  undonated ``run_chunked``.
- The drain schedule's fused multiply-adds: smoke worlds whose every
  send before a late link-up drains, with and without the burst; the
  send indices met include ones where the single and the twice-rounded
  forms of ``burst_base + (k - nb) * drain2`` (and of ``up + k * drain``)
  part, so a twice-rounded port fails here.
"""
import numpy as np
import pytest
import torch

from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.scenarios import example as jexample
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.scenarios import example as texample
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.spec import Stage
from tests.test_torch_v1v2 import assert_same


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


HORIZON = 1.3


def _noop(state, done):
    """A callback: JAX's ``run_chunked`` then runs its undonated program."""


def test_example_world_matches_jax_every_leaf():
    spec, st, net, b = texample.build(device="cpu", horizon=HORIZON)
    final, _ = tengine.run(spec, st, net, b)
    js, jst, jn, jb = jexample.build(horizon=HORIZON)
    assert_same(final, jengine.run(js, jst, jn, jb)[0], "example")
    # the warm-up ran: buffered creations drained after the link came up,
    # the overflow was lost, and the hybrid broker ran some locally
    t_ab = final.tasks.t_at_broker.numpy()
    drained = np.isfinite(t_ab) & (t_ab >= texample.CALIB_LINK_UP)
    assert drained.sum() >= texample.CALIB_BURST_N
    assert int(final.metrics.n_lost) > 0
    assert int(final.metrics.n_local) > 0


def test_example_run_chunked_matches_jax_run_chunked():
    spec, st, net, b = texample.build(device="cpu", horizon=HORIZON)
    got = tengine.run_chunked(spec, st, net, b, chunk_ticks=400)
    js, jst, jn, jb = jexample.build(horizon=HORIZON)
    ref = jengine.run_chunked(js, jst, jn, jb, chunk_ticks=400, callback=_noop)
    assert_same(got, ref, "example, run_chunked")


@pytest.mark.parametrize("burst_n", [0, 7])
def test_drain_schedule_fma_matches_jax(burst_n):
    """Two users publishing every 5 ms from t = 0, the link up at 0.33 s:
    send indices 0-64 all drain (no buffer), onto the example's drain
    gaps.  With the burst the indices 11, 12, 15, ..., 64 part between
    the fused and the twice-rounded schedule; without it 21, 22, 24 and
    60-64 do."""
    kw = dict(
        n_users=2, n_fogs=2, send_interval=0.005, horizon=0.335, dt=1e-3,
        start_time_max=1e-6, link_up_s=0.33, link_burst_n=burst_n,
        link_drain_s=texample.CALIB_DRAIN, link_drain2_s=texample.CALIB_DRAIN2,
    )
    spec, st, net, b = tsmoke.build(device="cpu", **kw)
    final, _ = tengine.run(spec, st, net, b)
    js, jst, jn, jb = jsmoke.build(**kw)
    assert_same(final, jengine.run(js, jst, jn, jb)[0], f"drain, burst {burst_n}")
    t_ab = final.tasks.t_at_broker.numpy().reshape(2, -1)
    sent = final.tasks.stage.numpy().reshape(2, -1) != int(Stage.UNUSED)
    assert sent[:, :65].all() and (t_ab[:, :65] >= 0.33).all()
