"""The port's carry contracts (``fognetsimpp_tpu_torch/core/contracts.py``),
on the eight worlds of ``tests/test_contracts.py``.

Every check is a shape-only trace (``FakeTensorMode``): no arithmetic
runs, so a dtype promotion or a shape drift in any phase fails here in
seconds.  The registry is held to the engine's module text, and its
names to JAX's registry.
"""
import re

import pytest
import torch

from fognetsimpp_tpu_torch.core import contracts
from fognetsimpp_tpu_torch.core import engine
from fognetsimpp_tpu_torch.core.engine import make_step
from fognetsimpp_tpu_torch.parallel.replicas import replicate_state
from fognetsimpp_tpu_torch.scenarios import smoke


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# JAX's eight worlds: FIFO v3 argmin (the dense broker), the v2 POOL
# LOCAL_FIRST world (compacted broker, pool phases, v2 release timer),
# a coarse-dt multi-send world, a learned policy (the credit phase),
# telemetry with the histogram, chaos with the federated hierarchy, the
# journey tap, and the live-ingestion gate (the injection phase)
WORLDS = {
    "dense": dict(horizon=0.4),
    "v2_pool": dict(
        horizon=0.4, dt=1e-3, send_interval=0.008, n_users=3, n_fogs=2,
        app_gen=2, fog_model=1, policy=5, broker_mips=2048.0, v2_local_broker=True,
    ),
    "multi_send": dict(horizon=0.3, dt=0.2, send_interval=0.05, max_sends_per_tick=8),
    "ucb": dict(horizon=0.4, policy=8),
    "telemetry": dict(horizon=0.4, telemetry=True, telemetry_hist=True),
    "chaos_hier": dict(
        horizon=0.4, chaos=True, chaos_mode=1, chaos_mtbf_s=0.1, chaos_mttr_s=0.05,
        chaos_script=((0, 0.1, 0.2),), n_brokers=2, hier_policy=1, hier_threshold=0.5,
    ),
    "journeys": dict(horizon=0.4, telemetry=True, telemetry_journeys=4,
                     telemetry_journey_ring=16),
    "ingest": dict(horizon=0.4, telemetry=True, ingest=True, ingest_batch=8),
}

#: Each world's phase check, run once by whichever test asks first.
_CHECKED = {}


def _world(name):
    return smoke.build(device="cpu", **WORLDS[name])


def _phases_checked(name):
    if name not in _CHECKED:
        spec, state, net, _ = _world(name)
        _CHECKED[name] = contracts.check_phase_contracts(spec, state, net)
    return _CHECKED[name]


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_step_contract_holds_for_all_worlds(name):
    spec, state, net, bounds = _world(name)
    contracts.check_step_contract(spec, state, net, bounds)


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_phase_contracts_hold_on_each_world(name):
    assert _phases_checked(name)


def test_phase_contracts_hold_and_cover_registry():
    checked = set()
    for name in WORLDS:
        checked.update(_phases_checked(name))
    registry = {pc.name for pc in contracts.PHASE_CONTRACTS}
    assert checked == registry, f"phases never traced by any test world: {registry - checked}"


def test_registry_names_every_engine_phase():
    """Every ``_phase_*`` the engine defines is registered, once, and
    nothing else is: the same names as JAX's registry, whose fused-view
    entries repeat names the port has once."""
    from fognetsimpp_tpu.core import contracts as jcontracts

    with open(engine.__file__) as f:
        defined = re.findall(r"^def (_phase_\w+)\(", f.read(), flags=re.M)
    names = [pc.name for pc in contracts.PHASE_CONTRACTS]
    assert len(names) == len(set(names))
    assert sorted(names) == sorted(set(defined))
    assert set(names) == {pc.name for pc in jcontracts.PHASE_CONTRACTS}


def test_gates_are_the_ticks():
    """A phase's gate says when ``make_step`` calls it: the dense world
    takes the dense broker and FIFO fogs, the v2 world the compacted
    broker, the pool phases and the release timer."""
    dense = {pc.name for pc in contracts.PHASE_CONTRACTS if pc.when(_world("dense")[0])}
    v2 = {pc.name for pc in contracts.PHASE_CONTRACTS if pc.when(_world("v2_pool")[0])}
    assert {"_phase_broker_dense", "_phase_completions", "_phase_fog_arrivals"} <= dense
    assert not dense & {"_phase_broker", "_phase_pool_arrivals", "_phase_v2_release",
                        "_phase_spawn_multi", "_phase_chaos", "_phase_telemetry"}
    assert {"_phase_broker", "_phase_pool_completions", "_phase_pool_arrivals",
            "_phase_v2_release"} <= v2
    assert not v2 & {"_phase_broker_dense", "_phase_completions", "_phase_fog_arrivals"}


def test_injected_carry_dtype_promotion_fails():
    spec, state, net, bounds = _world("dense")
    step = make_step(spec)

    def promoted_step(s, n, b):
        out = step(s, n, b)
        # int8 stage + an int32 tensor promotes the carry leaf to int32
        stage = out.tasks.stage
        return out.replace(tasks=out.tasks.replace(
            stage=stage + torch.ones_like(stage, dtype=torch.int32)))

    with pytest.raises(contracts.ContractError, match="stage"):
        contracts.check_step_contract(spec, state, net, bounds, step=promoted_step)


def test_injected_int64_sum_fails():
    """Torch's own hazard: an integer sum without ``dtype=`` is int64."""
    spec, state, net, bounds = _world("dense")
    step = make_step(spec)

    def widened_step(s, n, b):
        out = step(s, n, b)
        m = out.metrics
        return out.replace(metrics=m.replace(n_published=m.n_published + out.users.send_count.sum()))

    with pytest.raises(contracts.ContractError, match=r"n_published: expected int32\[\], got int64"):
        contracts.check_step_contract(spec, state, net, bounds, step=widened_step)


def test_injected_shape_drift_fails():
    spec, state, net, bounds = _world("dense")
    step = make_step(spec)

    def truncated_step(s, n, b):
        out = step(s, n, b)
        return out.replace(tasks=out.tasks.replace(mips_req=out.tasks.mips_req[:-1]))

    with pytest.raises(contracts.ContractError, match="mips_req"):
        contracts.check_step_contract(spec, state, net, bounds, step=truncated_step)


def test_checks_run_no_arithmetic_and_keep_the_kept_tables():
    """A trace returns fake tensors and leaves ``f32math``'s kept device
    tables as it found them (a fake one kept would poison later runs)."""
    from torch._subclasses.fake_tensor import FakeTensor

    from fognetsimpp_tpu_torch import f32math

    spec, state, net, bounds = _world("telemetry")
    before = dict(f32math._TABLES)
    out = contracts._trace(lambda s: make_step(spec)(s, net, bounds), state)
    assert isinstance(out.tasks.stage, FakeTensor)
    assert f32math._TABLES == before
    assert not any(isinstance(t, FakeTensor) for t in f32math._TABLES.values())


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_telemetry_contract_holds(name):
    spec, state, _, _ = _world(name)
    contracts.check_telemetry_contract(spec, state)


def test_telemetry_contract_catches_a_missized_plane():
    spec, state, _, _ = _world("dense")
    t = state.telem
    bad = state.replace(telem=t.replace(q_len_sum=torch.zeros((spec.n_fogs,), dtype=torch.float32)))
    with pytest.raises(contracts.ContractError, match="q_len_sum"):
        contracts.check_telemetry_contract(spec, bad)


@pytest.mark.parametrize("name", ["dense", "v2_pool", "ucb", "chaos_hier", "telemetry"])
def test_fleet_contract_holds(name):
    spec, state, net, bounds = _world(name)
    batch = replicate_state(spec, state, 3, seed=1)
    contracts.check_fleet_contract(spec, batch, net, bounds)

