"""The port's fleet on a slot mesh against JAX's ``run_fleet`` on the
conftest's 8-device CPU mesh (``tests/test_fleet.py``'s gates at a small
size), every leaf bit for bit: three policy families on 8 slots, the
static path against the promoted one, and a fleet whose fogs end to end
take ``pairwise_rank`` while one slot's rows alone take
``fused_arrival_plan``.
``tests/test_torch_fleet_chaos.py`` holds the chaos fleets and the
refusals, ``tests/test_torch_fleet_series.py`` ``fleet_decisions``,
``run_fleet_series``, the CLI's ``--mesh`` and the sweeps.
"""
import jax
import pytest
import torch

from fognetsimpp_tpu import Policy
from fognetsimpp_tpu.parallel import fleet as jfleet
from fognetsimpp_tpu.parallel import mesh as jmesh
from fognetsimpp_tpu.parallel import replicas as jreplicas
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu_torch import dynspec as tdyn
from fognetsimpp_tpu_torch.ops import cuda_build
from fognetsimpp_tpu_torch.parallel import fleet as tfleet
from fognetsimpp_tpu_torch.parallel import mesh as tmesh
from fognetsimpp_tpu_torch.parallel import replicas as treplicas
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.state import state_to_numpy, tree_map
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


SMALL = dict(n_users=6, n_fogs=3, horizon=0.012, start_time_max=0.005)

#: The three policy families of ``tests/test_fleet.py``: the dense
#: scalar winner, the task-keyed RANDOM stream, the v1 local-pool scan.
WORLDS = {
    "min_busy": dict(SMALL, policy=int(Policy.MIN_BUSY)),
    "random": dict(SMALL, policy=int(Policy.RANDOM)),
    "local_first": dict(SMALL, policy=int(Policy.LOCAL_FIRST), broker_mips=2048.0),
}

def _worlds(kw, R, seed=3):
    js, jst, jn, jb = jsmoke.build(**kw)
    spec, st, net, b = tsmoke.build(device="cpu", **kw)
    return ((js, jreplicas.replicate_state(js, jst, R, seed=seed), jn, jb),
            (spec, treplicas.replicate_state(spec, st, R, seed=seed), net, b))


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_fleet_matches_jax_per_replica_on_eight_slots(name):
    (js, jbatch, jn, jb), (spec, batch, net, b) = _worlds(WORLDS[name], 8)
    want = jfleet.run_fleet(js, jbatch, jn, jb, jmesh.make_mesh(8), donate=False)
    got = tfleet.run_fleet(spec, batch, net, b, tmesh.make_mesh(8, device="cpu"))
    assert_same(got, want, name)
    m = got.metrics  # the broker decided: offloaded, or kept in its pool
    assert int(m.n_scheduled.sum()) + int(m.n_local.sum()) > 0


def test_static_fleet_equals_promoted_and_dyn_rows_cells():
    """``promote=False`` (the spec's values as host constants) equals the
    promoted fleet on a world whose knobs do not divide; explicit rows of
    the spec's own knobs equal the broadcast default."""
    _, (spec, batch, net, b) = _worlds(dict(WORLDS["min_busy"], uplink_loss_prob=0.1), 4)
    mesh = tmesh.make_mesh(2, device="cpu")
    prom = state_to_numpy(tfleet.run_fleet(spec, batch, net, b, mesh, promote=True))
    static = state_to_numpy(tfleet.run_fleet(spec, batch, net, b, mesh, promote=False))
    rows = tdyn.dyn_rows([tdyn.dyn_of(spec)], "cpu", repeats=4)
    explicit = state_to_numpy(tfleet.run_fleet(spec, batch, net, b, mesh, dyn_rows=rows))
    for a, s, e in zip(prom, static, explicit):
        assert a.tobytes() == s.tobytes() == e.tobytes()


def test_slots_take_the_fused_kernel_where_the_whole_batch_takes_pairwise():
    """8 replicas x 130 fogs are 1,040 fogs end to end, past the fused
    kernel's 1,024: the four-slot fleet runs them as one batch, ranked by
    ``pairwise_rank``; one slot's 2 replicas alone are 260 fogs and take
    ``fused_arrival_plan``.  The two give those replicas the same leaves,
    and the four-slot fleet equals JAX's batch."""
    kw = dict(n_users=8, n_fogs=130, horizon=0.006, start_time_max=0.002,
              send_interval=0.002, max_sends_per_user=4)
    (js, jbatch, jn, jb), (spec, batch, net, b) = _worlds(kw, 8)
    calls = []
    tap = lambda name, *args: calls.append(name)  # noqa: E731
    cuda_build.TAPS.append(tap)
    try:
        whole = tmesh.run_sharded(spec, batch, net, b, tmesh.make_mesh(4, device="cpu"))
        n_whole = list(calls)
        calls.clear()
        slot = treplicas.run_replicated(spec, tree_map(lambda x: x[2:4], batch), net, b)
    finally:
        cuda_build.TAPS.remove(tap)
    assert set(n_whole) == {"pairwise_rank"}
    assert set(calls) == {"fused_arrival_plan"} and len(calls) == len(n_whole)
    assert_same(whole, jreplicas.run_replicated(js, jbatch, jn, jb), "four slots")
    rows = state_to_numpy(tree_map(lambda x: x[2:4], whole))
    for a, s in zip(rows, state_to_numpy(slot)):
        assert a.tobytes() == s.tobytes()
