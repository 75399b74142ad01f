"""Chaos fleets and the fleet's refusals against JAX's ``run_fleet`` on
the conftest's 8-device CPU mesh (``tests/test_fleet.py`` and
``tests/test_sharded_dynspec.py`` at a small size): each replica on its
own fault schedule, bit for bit (with the RTT terms each replica is held
to JAX ``run`` of its row, ROADMAP.md §3); the refusals in JAX's words.
"""
import jax
import pytest
import torch

from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.dynspec import split_spec as jsplit_spec
from fognetsimpp_tpu.parallel import fleet as jfleet
from fognetsimpp_tpu.parallel import mesh as jmesh
from fognetsimpp_tpu.spec import ChaosMode
from fognetsimpp_tpu_torch import dynspec as tdyn
from fognetsimpp_tpu_torch.parallel import fleet as tfleet
from fognetsimpp_tpu_torch.parallel import mesh as tmesh
from fognetsimpp_tpu_torch.parallel import replicas as treplicas
from fognetsimpp_tpu_torch.state import state_from_numpy, state_to_numpy
from tests.test_torch_fleet import SMALL, _worlds
from tests.test_torch_v1v2 import assert_same


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin), and no per-replica
    fallback loop under ``vmap``."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with treplicas.strict_vmap():
        yield
    torch.set_num_threads(old)


CHAOS = dict(n_users=6, n_fogs=3, fog_mips=(40000.0, 80000.0), horizon=0.02,
             start_time_max=0.01, assume_static=False, chaos=True,
             chaos_mode=int(ChaosMode.REOFFLOAD), chaos_mtbf_s=0.006,
             chaos_mttr_s=0.003, chaos_max_retries=4)


def test_fleet_chaos_per_replica_schedules_match_jax():
    """Every replica draws its own fault schedule; without the RTT terms
    the fleet equals JAX's fleet, with them each replica equals JAX
    ``run`` of its row (JAX's vmapped program contracts the degraded
    delay, its one-world program does not)."""
    (js, jbatch, jn, jb), (spec, batch, net, b) = _worlds(CHAOS, 4)
    got = tfleet.run_fleet(spec, batch, net, b, tmesh.make_mesh(4, device="cpu"))
    assert_same(got, jfleet.run_fleet(js, jbatch, jn, jb, jmesh.make_mesh(4), donate=False),
                "chaos fleet")
    crashes = got.chaos.n_crashes.numpy()
    assert crashes.sum() > 0 and len(set(got.chaos.down_ticks.sum(1).tolist())) > 1

    rtt = dict(CHAOS, chaos_rtt_amp=0.5, chaos_rtt_burst_prob=0.05)
    (js, jbatch, jn, jb), (spec, batch, net, b) = _worlds(rtt, 4)
    got = tfleet.run_fleet(spec, batch, net, b, tmesh.make_mesh(2, device="cpu"))
    rows = state_to_numpy(got)
    for r in (0, 3):
        want = jengine.run(js, jax.tree.map(lambda x, r=r: x[r], jbatch), jn, jb)[0]
        assert_same(state_from_numpy([x[r] for x in rows], "cpu"), want, f"replica {r}")


def test_fleet_refusals_match_jax():
    (js, jbatch, jn, jb), (spec, batch, net, b) = _worlds(dict(SMALL, horizon=0.01), 3)
    with pytest.raises(ValueError, match="divide") as je:
        jfleet.run_fleet(js, jbatch, jn, jb, jmesh.make_mesh(8))
    with pytest.raises(ValueError, match="divide") as te:
        tfleet.run_fleet(spec, batch, net, b, tmesh.make_mesh(8, device="cpu"))
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="divide"):
        tmesh.run_sharded(spec, batch, net, b, tmesh.make_mesh(2, device="cpu"))
    # dyn_rows need the promoted path
    (js, jbatch, jn, jb), (spec, batch, net, b) = _worlds(dict(SMALL, horizon=0.01), 8)
    jrows = jax.tree.map(lambda x: jax.numpy.broadcast_to(x, (8,) + x.shape),
                         jsplit_spec(js)[1])
    with pytest.raises(ValueError, match="promote") as je:
        jfleet.run_fleet(js, jbatch, jn, jb, jmesh.make_mesh(8), promote=False,
                         dyn_rows=jrows)
    rows = tdyn.dyn_rows([tdyn.dyn_of(spec)], "cpu", repeats=8)
    with pytest.raises(ValueError, match="promote") as te:
        tfleet.run_fleet(spec, batch, net, b, tmesh.make_mesh(8, device="cpu"),
                         promote=False, dyn_rows=rows)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="one promoted-knob row per replica"):
        tfleet.run_fleet(spec, batch, net, b, tmesh.make_mesh(8, device="cpu"),
                         dyn_rows=tdyn.dyn_rows([tdyn.dyn_of(spec)], "cpu", repeats=4))
    # the federated hierarchy stays off the fleet, in JAX's words
    hier = dict(n_users=4, n_fogs=4, horizon=0.01, n_brokers=2, hier_policy=1)
    (js, jbatch, jn, jb), (spec, batch, net, b) = _worlds(hier, 2)
    with pytest.raises(ValueError, match="FLEET-HIER") as je:
        jfleet.run_fleet(js, jbatch, jn, jb, jmesh.make_mesh(2))
    with pytest.raises(ValueError, match="FLEET-HIER") as te:
        tfleet.run_fleet(spec, batch, net, b, tmesh.make_mesh(2, device="cpu"))
    assert str(te.value) == str(je.value)
    # slots of one process on distinct cards are item 21
    with pytest.raises(NotImplementedError, match="item 21"):
        tmesh.make_mesh(device=["cuda:0", "cuda:1"])
