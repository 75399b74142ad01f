"""The port's Perfetto trace against JAX's, on the CPU.

``build_trace`` of the same world run by each package: ``json.loads`` of
the two exports is equal (events, their order, the metadata), on a world
with plane 1, the histogram and journeys (task spans, counter tracks,
journey lanes and flows), a chaos world (``fog_down`` spans), a federated
world (broker load lanes), a 2-shard TP run (exchange lanes, per-shard
journey processes) and a replica batch (a pid a replica).  The oracle is
JAX's ``build_trace`` on the same world, never a committed golden.
"""
import json

import pytest
import torch

from fognetsimpp_tpu.telemetry import timeline as jtl
from fognetsimpp_tpu_torch.telemetry import timeline as ttl
from tests.torch_exporter_support import N_REPLICAS, run_pair


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


#: Process names each world's trace must hold beside ``replica0``.
PROCESSES = {
    "telemetry": {"journeys"},
    "chaos": set(),
    "hier": {"hier-brokers"},
    "tp": {"tp-exchange"},
    "replicas": {f"replica{r}" for r in range(1, N_REPLICAS)},
}


def _process_names(trace):
    return {e["args"]["name"] for e in trace["traceEvents"] if e["name"] == "process_name"}


@pytest.mark.parametrize("world", sorted(PROCESSES))
def test_build_trace_matches_jax(world, tmp_path):
    js, jfinal, spec, final = run_pair(world)
    want = jtl.export_trace(js, jfinal, str(tmp_path / "jax.json"))
    got = ttl.export_trace(spec, final, str(tmp_path / "port.json"))
    trace = json.loads(open(got).read())
    assert trace == json.loads(open(want).read())
    names = _process_names(trace)
    shards = {n for n in names if n.startswith("journeys-shard")}
    assert (world == "tp") == bool(shards)  # the owning shards' lanes
    assert names - shards == {"replica0"} | PROCESSES[world]
    cats = {e.get("cat") for e in trace["traceEvents"]}
    if world == "chaos":
        assert "chaos" in cats
    if world in ("telemetry", "tp"):
        assert {"journey", "health", "task"} <= cats


def test_max_tasks_cap_matches_jax():
    js, jfinal, spec, final = run_pair("telemetry")
    got = ttl.build_trace(spec, final, max_tasks=5)
    assert got == jtl.build_trace(js, jfinal, max_tasks=5)
    spans = [e for e in got["traceEvents"] if e["name"].startswith("task")]
    assert 0 < len({e["args"]["task"] for e in spans}) <= 5
