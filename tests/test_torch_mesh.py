"""The slot mesh against JAX's device mesh on the conftest's 8 CPU devices
(``tests/test_parallel.py``'s gates at a small size), bit for bit:
``run_sharded``; ``sharded_min_busy`` against JAX's and against
``ops/sched.schedule_batch`` (MIN_BUSY, with and without the brokers[0]
divisor, and with no fog registered); ``run_node_sharded`` on a TP spec
(the task-sharded tick), on a compacted-broker smoke world and on
``wireless4`` (the engine), both on the mesh's device, and its
uneven-world refusal;
``initialize()`` and ``global_mesh()`` in one process.  The sweeps with
``mesh=``: ``tests/test_torch_fleet_series.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fognetsimpp_tpu import Policy
from fognetsimpp_tpu.parallel import mesh as jmesh
from fognetsimpp_tpu.parallel import multihost as jmultihost
from fognetsimpp_tpu.parallel import replicas as jreplicas
from fognetsimpp_tpu.parallel import taskshard as jtaskshard
from fognetsimpp_tpu.parallel import tp as jtp
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu.scenarios import wireless as jwireless
from fognetsimpp_tpu_torch import random as trandom
from fognetsimpp_tpu_torch.core.engine import tp_ok
from fognetsimpp_tpu_torch.ops import sched as tsched
from fognetsimpp_tpu_torch.ops.ring_kernels import ring_all_gather
from fognetsimpp_tpu_torch.parallel import mesh as tmesh
from fognetsimpp_tpu_torch.parallel import multihost as tmultihost
from fognetsimpp_tpu_torch.parallel import replicas as treplicas
from fognetsimpp_tpu_torch.parallel import shards as tshards
from fognetsimpp_tpu_torch.parallel import taskshard as ttaskshard
from fognetsimpp_tpu_torch.parallel import tp as ttp
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.scenarios import wireless as twireless
from fognetsimpp_tpu_torch.state import tree_map
from tests.test_torch_v1v2 import assert_same


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_run_sharded_matches_jax():
    kw = dict(n_users=6, n_fogs=3, horizon=0.02, start_time_max=0.01)
    js, jst, jn, jb = jsmoke.build(**kw)
    jbatch = jreplicas.replicate_state(js, jst, 8, seed=7)
    spec, st, net, b = tsmoke.build(device="cpu", **kw)
    batch = treplicas.replicate_state(spec, st, 8, seed=7)
    mesh = tmesh.make_mesh(4, device="cpu")
    assert mesh.shape == {"replica": 4} and mesh.devices.size == 4
    got = tmesh.run_sharded(spec, batch, net, b, mesh)
    assert_same(got, jmesh.run_sharded(js, jbatch, jn, jb, jmesh.make_mesh(8)), "run_sharded")
    assert tmesh.replica_sharding(mesh)(batch.t) == [(0, 2), (2, 4), (4, 6), (6, 8)]


def _min_busy_inputs(K=8, F=16):
    rng = np.random.default_rng(3)
    f32 = np.float32
    busy = (rng.random(F) * 2).astype(f32)
    busy[5] = busy[9]  # a tie across slots: the lower slot wins
    mips = (100 + rng.random(F) * 3900).astype(f32)
    mips[9] = mips[5]
    reg = np.ones(F, bool)
    reg[3] = False
    mask = np.ones(K, bool)
    mask[K - 1] = False
    req = (200 + rng.random(K) * 700).astype(f32)
    return mask, req, busy, mips, reg


@pytest.mark.parametrize("case", ["per_fog", "divisor", "none_registered"])
def test_sharded_min_busy_matches_jax_and_schedule_batch(case):
    mask, req, busy, mips, reg = _min_busy_inputs()
    if case == "none_registered":
        reg = np.zeros_like(reg)
    F = busy.shape[0]
    div = mips[0] if case == "divisor" else None
    want = jtp.sharded_min_busy(
        jmesh.make_mesh(8, axis_name="fog"), jnp.asarray(mask), jnp.asarray(req),
        jnp.asarray(busy), jnp.asarray(mips), jnp.asarray(reg),
        divisor=None if div is None else jnp.float32(div), axis_name="fog")
    t = [torch.from_numpy(x) for x in (mask, req, busy, mips, reg)]
    got = ttp.sharded_min_busy(
        tmesh.make_mesh(8, axis_name="fog", device="cpu"), *t,
        divisor=None if div is None else torch.tensor(div), axis_name="fog")
    assert got.dtype == torch.int32
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    plain, _ = tsched.schedule_batch(
        int(Policy.MIN_BUSY), *t, torch.ones(F, dtype=torch.bool), torch.ones(F),
        torch.zeros(F), torch.zeros((), dtype=torch.int32), trandom.PRNGKey(3),
        mips0_divisor=case == "divisor")
    if case == "none_registered":
        assert (got == -1).all()
    else:
        assert torch.equal(got, plain) and (got[:-1] >= 0).all()
    with pytest.raises(ValueError, match="divide"):
        ttp.sharded_min_busy(tmesh.make_mesh(3, axis_name="fog", device="cpu"), *t)


#: ``tests/test_parallel.py``'s node-sharded worlds, cut to CPU size: a
#: TP-admissible smoke world (T = 192 rows, 24 a slot), a compacted-broker
#: twin of it (the engine) and ``wireless4``'s mobile world.
NODE_WORLDS = {
    "tp": (jsmoke.build, tsmoke.build, dict(
        n_users=8, n_fogs=2, horizon=0.05, send_interval=0.02, max_sends_per_user=24)),
    "smoke": (jsmoke.build, tsmoke.build, dict(
        n_users=8, n_fogs=2, horizon=0.05, send_interval=0.02, max_sends_per_user=24,
        policy=int(Policy.RANDOM))),
    "wireless4": (jwireless.wireless4, twireless.wireless4, dict(
        numb_users=8, horizon=0.15, dt=5e-3)),
}


@pytest.mark.parametrize("name", sorted(NODE_WORLDS))
def test_run_node_sharded_matches_jax(name, monkeypatch):
    jbuild, tbuild, kw = NODE_WORLDS[name]
    js, jst, jn, jb = jbuild(**kw)
    spec, st, net, b = tbuild(device="cpu", **kw)
    assert tp_ok(spec) == (name == "tp")
    want = jtaskshard.run_node_sharded(js, jst, jn, jb, jmesh.make_mesh(8, axis_name="node"))
    rings = []

    def ring(blocks):
        rings.append(len(blocks))
        return ring_all_gather(blocks)

    monkeypatch.setattr(tshards, "ring_all_gather", ring)
    got = ttaskshard.run_node_sharded(
        spec, st, net, b, tmesh.make_mesh(8, axis_name="node", device="cpu"))
    assert_same(got, want, name)
    # the task-sharded tick's exchange: one ring a tick over 8 shards
    assert rings == ([8] * spec.n_ticks if name == "tp" else [])
    assert int(got.metrics.n_published) > 0


@pytest.mark.parametrize("name", ["tp", "smoke"])
def test_run_node_sharded_runs_on_the_mesh_device(name, monkeypatch):
    """Both branches move the state, ``net`` and ``bounds`` to the mesh's
    device, whatever device the state was built on (a ``meta`` mesh stands
    in for a card here; the runners are spies that record the devices)."""
    _, tbuild, kw = NODE_WORLDS[name]
    spec, st, net, b = tbuild(device="cpu", **kw)
    seen = []

    def spy(spec, state, net, bounds, *args, **kwargs):
        devices = set()
        for tree in (state, net, bounds):
            tree_map(lambda x: devices.add(x.device), tree)
        seen.append(devices)
        return state, state

    monkeypatch.setattr(ttaskshard, "run_tp_sharded", spy)
    monkeypatch.setattr(ttaskshard, "_run", spy)
    meta = torch.device("meta")
    ttaskshard.run_node_sharded(spec, st, net, b, tmesh.Mesh("node", 8, meta, (0,) * 8))
    assert seen == [{meta}]


def test_uneven_node_world_is_refused_as_jax_does():
    kw = dict(n_users=3, n_fogs=2, horizon=0.01, max_sends_per_user=8)
    js, jst, jn, jb = jsmoke.build(**kw)
    spec, st, net, b = tsmoke.build(device="cpu", **kw)
    with pytest.raises(ValueError, match="divide") as je:
        jtaskshard.run_node_sharded(js, jst, jn, jb, jmesh.make_mesh(8, axis_name="node"))
    with pytest.raises(ValueError, match="divide") as te:
        ttaskshard.run_node_sharded(spec, st, net, b,
                                    tmesh.make_mesh(8, axis_name="node", device="cpu"))
    assert str(te.value) == str(je.value)
    spec, st, net, b = tsmoke.build(device="cpu", **dict(kw, policy=int(Policy.RANDOM)))
    with pytest.raises(ValueError, match="divide"):
        ttaskshard.shard_state_by_node(spec, st, tmesh.make_mesh(8, axis_name="node",
                                                                 device="cpu"))


def test_initialize_and_global_mesh_in_one_process():
    assert tmultihost.initialize() == jmultihost.initialize() == 1
    mesh = tmultihost.global_mesh(device="cpu")
    jm = jmultihost.global_mesh()
    assert mesh.axis_names == jm.axis_names == ("replica",)
    assert mesh.size == 1 and mesh.owners == (0,) and mesh.group_size == 0
    assert tmultihost.global_mesh(local_slots=4, device="cpu").local_slots() == [0, 1, 2, 3]
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
            assert k not in __import__("os").environ
        tmultihost.initialize(auto=True, device="cpu")
    with pytest.raises(ValueError, match="together"):
        tmultihost.initialize(num_processes=2, device="cpu")
