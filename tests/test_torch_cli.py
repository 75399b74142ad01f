"""``python -m fognetsimpp_tpu_torch`` against ``python -m
fognetsimpp_tpu`` on the same argv (``--platform cpu``): the printed JSON
summary (every key but wall times and file paths) and the results files
(``tests/torch_cli_support.py``), for the single-world runs: the
shipped smoke config and its ``fog.*.mips`` tier, the wired v1 world with
its tick series, the telemetry planes, chaos and the broker hierarchy
(``--trails`` and ``--analyze``: ``tests/test_torch_recorder.py``).
"""
import pytest
import torch

from tests.torch_cli_support import (
    assert_same_files,
    assert_same_summary,
    run_both,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


ARGV = {
    "smoke_ini": ["-c", "examples/smoke.ini", "--set", "scenario.horizon=0.15"],
    "wired_v1_ticks": ["--scenario", "wired_v1", "--ticks",
                       "--set", "scenario.horizon=0.15"],
    "telemetry_hist_journeys": [
        "-s", "smoke", "--telemetry", "--hist", "--journeys", "4", "--slo", "5",
        "--set", "scenario.n_users=6", "--set", "fog.*.mips=100000",
        "--set", "scenario.horizon=0.1", "--set", "spec.derive_acks=false"],
    "chaos": ["-s", "smoke", "--chaos", "light", "--chaos-seed", "3",
              "--set", "scenario.n_users=6", "--set", "scenario.horizon=0.1"],
    "brokers": ["-s", "smoke", "--brokers", "2", "--hier-policy", "threshold",
                "--set", "scenario.n_fogs=4", "--set", "scenario.horizon=0.1"],
}


@pytest.mark.parametrize("name", sorted(ARGV))
def test_cli_run_matches_jax(name, tmp_path, capsys):
    (jrc, jout, _, jdir), (trc, tout, _, tdir) = run_both(ARGV[name], capsys, tmp_path)
    assert jrc == trc == 0
    jsum, tsum = assert_same_summary(jout, tout)
    keys = assert_same_files(jsum, tsum, jdir, tdir)
    assert len(keys) == 5
    assert tsum["n_published"] > 0
    if name == "telemetry_hist_journeys":
        assert "lat_quantiles_ms" in tsum and "slo_breaches" in tsum
