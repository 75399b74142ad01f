"""The port's OpenMetrics exposition against JAX's, on the CPU.

``render_openmetrics`` on the same world run by each package gives the
same text, JAX's ``fns_compile_*`` families removed (the departure by
design: XLA's program cache has no PyTorch counterpart): a world with
plane 1, the histogram and journeys, a chaos world, a federated world and
a 2-shard TP run; ``render_fleet_openmetrics`` on a replica batch (through
the recorder's ``.fleet.om.txt``); the recorder's ``.om.txt``; the twin's
aggregate and ingest families.  Every text passes
``tools/check_openmetrics.py``.
"""
import pytest
import torch

from fognetsimpp_tpu.runtime import recorder as jrec
from fognetsimpp_tpu.telemetry import openmetrics as jom
from fognetsimpp_tpu_torch.runtime import recorder as trec
from fognetsimpp_tpu_torch.telemetry import openmetrics as tom
from tests.torch_exporter_support import run_pair, without_compile_families
from tools.check_openmetrics import check_text


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


ATTRS = {"live_chunks": 3, "live_ticks": 120, "slo_breaches": 0, "note": "text"}
INGEST = {"depth": 3, "capacity": 16, "accepted": 40, "dropped": 2, "injected": 35,
          "rejected": 2, "latency_s": 0.012345}


@pytest.mark.parametrize("world", ["telemetry", "chaos", "hier", "tp"])
def test_render_openmetrics_matches_jax(world):
    js, jfinal, spec, final = run_pair(world)
    want = without_compile_families(jom.render_openmetrics(js, jfinal, attrs=ATTRS))
    got = tom.render_openmetrics(spec, final, attrs=ATTRS)
    assert got == want
    assert check_text(got, where=world) == 0
    families = {
        "telemetry": ("fns_task_latency_bucket", "fns_journey_tasks", "fns_fog_busy_fraction"),
        "chaos": ("fns_chaos_fog_down_ticks",),
        "hier": ("fns_hier_migrations_out", "fns_hier_load_mean"),
        "tp": ("fns_tp_exchange_occupancy_bucket", "fns_tp_exchange_deferred"),
    }[world]
    for fam in families:
        assert f"\n{fam}{{" in got, fam
    assert "fns_compile_" not in got and got.endswith("# EOF\n")


def test_ingest_families_and_a_given_histogram_match_jax():
    js, jfinal, spec, final = run_pair("telemetry")
    from fognetsimpp_tpu.telemetry.health import hist_summary as jhist
    from fognetsimpp_tpu_torch.telemetry.health import hist_summary as thist

    want = without_compile_families(
        jom.render_openmetrics(js, jfinal, hist=jhist(js, jfinal), ingest=INGEST))
    got = tom.render_openmetrics(spec, final, hist=thist(spec, final), ingest=INGEST)
    assert got == want and "fns_twin_ingest_latency_seconds 0.012345" in got
    assert check_text(got, where="ingest") == 0


def test_twin_aggregate_matches_jax():
    rows = [dict(label=f"t{i}", ticks=250 * (i + 1), chunks=i + 1, n_users=1024 + i,
                 n_published=37 * i, n_completed=30 * i, ingest_depth=i) for i in range(3)]
    got = tom.render_twin_openmetrics(rows)
    assert got == jom.render_twin_openmetrics(rows)
    assert check_text(got, where="aggregate") == 0


def test_recorder_om_files_match_jax(tmp_path):
    """``record_run``'s ``<run>.om.txt`` and ``record_fleet_run``'s
    ``<run>.fleet.om.txt`` (per-replica busy fractions and phase work, the
    replica-merged histogram) equal JAX's."""
    js, jfinal, spec, final = run_pair("telemetry")
    jp = jrec.record_run(str(tmp_path / "jax"), js, jfinal, scave=False)
    tp = trec.record_run(str(tmp_path / "port"), spec, final, scave=False)
    assert list(tp) == list(jp)
    got = open(tp["om"]).read()
    assert got == without_compile_families(open(jp["om"]).read())
    assert check_text(got, where="om.txt") == 0

    js, jfinal, spec, final = run_pair("replicas")
    jp = jrec.record_fleet_run(str(tmp_path / "jax"), js, jfinal)
    tp = trec.record_fleet_run(str(tmp_path / "port"), spec, final)
    assert list(tp) == list(jp)
    got = open(tp["om"]).read()
    assert got == without_compile_families(open(jp["om"]).read())
    assert 'fns_fleet_fog_busy_fraction{fleet="3",fog="2"}' in got
    assert "fns_fleet_task_latency_bucket" in got
    assert check_text(got, where="fleet.om.txt") == 0
