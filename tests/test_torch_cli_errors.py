"""The port's CLI guard rails and config tier against JAX's.

Each guard rail of ``tests/test_cli_errors.py`` that the port serves,
run through both ``main``s on the same argv: the same exit code and the
same ``error:`` lines (``ap.error``'s usage line names each package's own
program), the serving loop's and the twin's ``[TWIN-*]`` rails among them.
``--mesh`` (the last flag that raised ``NotImplementedError`` naming a
``ROADMAP.md`` item) runs, and its rails are JAX's.  The ini tier:
values, first-match wildcards, ``build_from_config`` on the shipped
smoke config (its ``fog.*.mips`` tier re-primes the first adverts) and
the tier's error texts, all against JAX's.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from fognetsimpp_tpu.config import ini as jini
import fognetsimpp_tpu_torch.__main__ as tcli
from fognetsimpp_tpu_torch.__main__ import main as tmain
from fognetsimpp_tpu_torch.config import ini as tini
from fognetsimpp_tpu_torch.state import state_to_numpy
from tests.torch_cli_support import run_both


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


S = ["--scenario", "smoke"]
SHORT = ["--set", "scenario.horizon=0.05"]
SWEEP = ["--sweep", "policies=min_busy loads=0.05"]

#: ``tests/test_cli_errors.py``'s cases that the port serves, by its
#: test's name (a few more of the same guard rails beside them).
CASES = {
    "unknown_scenario_flag": ["--scenario", "wirelessnet-42"],
    "unknown_network_in_ini": ["--config", "INI:[General]\nscenario = NoSuchNetwork\n"],
    "unknown_policy_name": S + ["--policy", "warp_speed"],
    "sweep_unknown_policy_name": S + ["--sweep", "policies=min_busy,warp"],
    "sweep_explores_without_learned_policy": S + ["--sweep", "explores=0.1,0.5"],
    "sweep_policy_without_explores": S + ["--sweep", "policy=ducb loads=0.05"],
    "policy_flag_conflicts_with_sweep": S + ["--policy", "ucb"] + SWEEP,
    "replicas_conflicts_with_sweep": S + ["--replicas", "8"] + SWEEP,
    "sweep_with_ticks": S + ["--ticks"] + SWEEP,
    "sweep_with_telemetry": S + ["--telemetry"] + SWEEP,
    "sweep_with_hist": S + ["--hist"] + SWEEP,
    "sweep_with_spec_override": S + ["--set", "spec.send_interval=0.02"] + SWEEP,
    "tp_conflicts_with_replicas": S + ["--tp", "8", "--replicas", "8"],
    "tp_outside_policy_family": S + ["--tp", "8", "--policy", "ucb"] + SHORT,
    "tp_with_ticks": S + ["--tp", "2", "--ticks"],
    "tp_window_requires_tp": S + ["--tp-window", "4"],
    "tp_window_flag_conflicts_with_windowed_spec": S + [
        "--tp", "8", "--tp-window", "2", "--set", "scenario.arrival_window=4"] + SHORT,
    "unknown_chaos_profile": S + ["--chaos", "mayhem"],
    "chaos_seed_requires_chaos": S + ["--chaos-seed", "3"],
    "chaos_script_requires_chaos": S + ["--chaos-script", "x.json"],
    "unknown_chaos_mode": S + ["--chaos", "light", "--chaos-mode", "explode"],
    "malformed_chaos_script_file": S + ["--chaos", "scripted", "--chaos-script",
                                        "FILE:[[0, 0.5]]"],
    "chaos_script_fog_out_of_range": S + ["--chaos", "scripted", "--chaos-script",
                                          "FILE:[[99, 0.1, 0.2]]"],
    "chaos_conflicts_with_sweep": S + ["--chaos", "light"] + SWEEP,
    "chaos_with_tp": S + ["--tp", "8", "--chaos", "light"] + SHORT,
    "brokers_below_one": S + ["--brokers", "0"],
    "brokers_above_fog_count": S + ["--brokers", "5"],
    "unknown_hier_policy": S + ["--brokers", "2", "--hier-policy", "warp_speed"],
    "hier_policy_requires_brokers": S + ["--hier-policy", "threshold"],
    "brokers_with_tp": S + ["--brokers", "2", "--tp", "8"],
    "brokers_with_replicas": S + ["--brokers", "2", "--replicas", "8"],
    "brokers_with_sweep": S + ["--brokers", "2"] + SWEEP,
    "hier_unsupported_policy": S + ["--brokers", "2", "--set", "scenario.n_fogs=4",
                                    "--policy", "round_robin"],
    "set_unknown_spec_field": S + ["--set", "spec.bogus_knob=1"],
    "set_without_equals": S + ["--set", "spec.horizon"],
    "journeys_below_one": S + ["--telemetry", "--journeys", "0"],
    "journeys_without_telemetry": S + ["--journeys", "4"],
    "journeys_above_task_capacity": S + ["--telemetry", "--journeys", "999999999"],
    "progress_with_ticks": S + ["--progress", "10", "--ticks"] + SHORT,
    "fleet_with_progress": S + ["--replicas", "2", "--progress", "10"] + SHORT,
    "fleet_with_trails": S + ["--replicas", "2", "--trails", "x.svg"] + SHORT,
    # the live health plane and the twin (the serve and [TWIN-*] rails)
    "ingest_with_tp": S + ["--ingest", "8", "--tp", "8"],
    "ingest_with_replicas": S + ["--ingest", "8", "--replicas", "8"],
    "ingest_requires_serve": S + ["--ingest", "8"],
    "replay_arrivals_requires_serve": S + ["--replay-arrivals", "log.json"],
    "ingest_capacity_below_one": S + ["--serve", "0", "--ingest", "0"],
    "whatif_with_replicas": S + ["--whatif", "uplink_loss_prob=0.1", "--replicas", "8"],
    "whatif_conflicts_with_sweep": S + ["--whatif", "uplink_loss_prob=0.1"] + SWEEP,
    "tenants_with_tp": S + ["--tenants", "2", "--tp", "8"],
    "tenants_with_replicas": S + ["--tenants", "2", "--replicas", "8"],
    "tenants_requires_serve": S + ["--tenants", "2"],
    "tenants_below_one": S + ["--tenants", "0", "--serve", "0"],
    "tenants_conflicts_with_whatif_flag": S + ["--tenants", "2", "--serve", "0",
                                               "--whatif", "uplink_loss_prob=0.1"],
    "tenants_conflicts_with_replay": S + ["--tenants", "2", "--serve", "0",
                                          "--replay-arrivals", "log.json"],
    "tenant_cap_requires_tenants": S + ["--tenant-cap", "2"],
    "serve_with_ticks": S + ["--serve", "0", "--ticks"] + SHORT,
    "serve_with_replicas": S + ["--serve", "0", "--replicas", "2"] + SHORT,
    "sweep_with_serve": S + ["--serve", "0"] + SWEEP,
    "sweep_with_trace_out": S + ["--trace-out", "x.json"] + SWEEP,
    "whatif_unknown_knob": S + ["--whatif", "warp_factor=0.1,0.2"] + SHORT,
    "whatif_malformed_grid": S + ["--whatif", "uplink_loss_prob"] + SHORT,
    # the slot mesh (--mesh)
    "fleet_replicas_not_dividing_mesh": S + ["--replicas", "3", "--mesh", "2"] + SHORT,
    "tp_conflicts_with_mesh": S + ["--tp", "8", "--mesh", "8"],
    "mesh_conflicts_with_sweep": S + ["--mesh", "2"] + SWEEP,
    "serve_with_mesh": S + ["--serve", "0", "--mesh", "2"] + SHORT,
    "brokers_with_mesh": S + ["--brokers", "2", "--mesh", "2"],
}


def _error_lines(err):
    """The ``error:`` lines, from ``error:`` on (``ap.error`` puts each
    package's own program name before it)."""
    return [ln[ln.index("error:"):] for ln in err.splitlines() if "error:" in ln]


def _materialise(argv, tmp_path):
    """``INI:<text>`` / ``FILE:<text>`` arguments become files."""
    out = []
    for i, a in enumerate(argv):
        for tag, name in (("INI:", f"run{i}.ini"), ("FILE:", f"script{i}.json")):
            if a.startswith(tag):
                p = tmp_path / name
                p.write_text(a[len(tag):])
                a = str(p)
        out.append(a)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_guard_rail_matches_jax(name, tmp_path, capsys):
    argv = _materialise(CASES[name], tmp_path)
    (jrc, _, jerr, _), (trc, _, terr, _) = run_both(argv, capsys)
    assert jrc == trc == 2, (jrc, trc, terr)
    assert _error_lines(terr) == _error_lines(jerr) != []
    assert "Traceback" not in terr


@pytest.mark.parametrize("flag", ["--mesh"])
def test_later_item_flags_raise_naming_their_item(flag, capsys):
    """No flag is refused as a later item any more: ``--mesh`` (item 27)
    runs a fleet over its slots, ``--replicas`` defaulting to the mesh."""
    assert not hasattr(tcli, "NOT_PORTED")
    assert tmain(S + [flag, "2", "--platform", "cpu", "--set", "scenario.n_users=4"]
                 + SHORT) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n_devices"] == out["n_replicas"] == 2 and out["n_published_sum"] > 0


def test_whatif_on_the_static_spec_path_matches_jax(monkeypatch, capsys):
    """``FNS_SPEC_PROMOTE=0`` turns the promoted runners off: the what-if
    one-shot is then refused with JAX's ``[TWIN-WHATIF-STATIC]`` line."""
    monkeypatch.setenv("FNS_SPEC_PROMOTE", "0")
    (jrc, _, jerr, _), (trc, _, terr, _) = run_both(
        S + ["--whatif", "uplink_loss_prob=0.1"], capsys)
    assert jrc == trc == 2
    assert _error_lines(terr) == _error_lines(jerr) != []
    assert "[TWIN-WHATIF-STATIC]" in terr


def test_cli_runs_on_the_card_by_default(capsys):
    """Without ``--platform cpu`` the CLI runs on the card; with none it
    stops with the port's own device error, before building a world."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    assert tmain(S + SHORT) == 2
    assert "runs on a CUDA device and none is available" in capsys.readouterr().err


def test_parse_value_and_wildcards_match_jax():
    raws = ["50ms", "2s", "1.5", "3", "1e3", "-2", "true", "False", "10us", "5mW",
            "1Mbps", "abc", '"quoted"', "7 m", "0.5deg", "3kbps", "12B", "2.0J", "1x"]
    for r in raws:
        want, got = jini.parse_value(r), tini.parse_value(r)
        assert type(got) is type(want) and got == want, r
    text = ("[General]\nfog.0.mips = 1000 # first wins\nfog.*.mips = 3000\n"
            "fog.0.mips = 9\n**.send_interval = 20ms\nscenario.n_users = 4\n"
            "scenario.*.x = 1\nnot a line\nseed = 7\n")
    j, t = jini.Config.from_str(text), tini.Config.from_str(text)
    assert [(p, v) for p, _, v in t.entries] == [(p, v) for p, _, v in j.entries]
    for path in ("fog.0.mips", "fog.1.mips", "fog.12.mips", "user.3.send_interval",
                 "a.b.send_interval", "seed", "scenario.n_users", "missing"):
        assert t.lookup(path, "D") == j.lookup(path, "D"), path
    assert t.matching("scenario") == j.matching("scenario") == {"n_users": 4}


def test_build_from_config_on_smoke_ini_matches_jax():
    cfg_j = jini.Config.from_file("examples/smoke.ini")
    cfg_t = tini.Config.from_file("examples/smoke.ini")
    js, jst, jnet, _ = jini.build_from_config(cfg_j, seed=3)
    ts, tst, tnet, _ = tini.build_from_config(cfg_t, seed=3, device="cpu")
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(jst)]
    got = state_to_numpy(tst)
    assert all(a.dtype == b.dtype and a.tobytes() == b.tobytes() for a, b in zip(got, ref))
    assert tst.fogs.mips.tolist() == [1000.0, 2000.0, 3000.0]
    assert ts.record_tick_series and ts.n_users == js.n_users == 4


@pytest.mark.parametrize("text", [
    "scenario = warp\n",
    "scenario = smoke\nspec.bogus = 1\n",
    "scenario = wired_v1\nspec.n_users = 4\n",
    "scenario = wireless5\nscenario.horizon = 0.1\nspec.n_aps = 2\n",
    "scenario = smoke\nscenario.horizon = 0.2\nuser.0.send_interval = 1ms\n",
    "scenario = smoke\nuser.*.send_interval = 0\n",
])
def test_config_error_texts_match_jax(text):
    with pytest.raises(ValueError) as want:
        jini.build_from_config(jini.Config.from_str(text))
    with pytest.raises(ValueError) as got:
        tini.build_from_config(tini.Config.from_str(text), device="cpu")
    assert str(got.value) == str(want.value)
