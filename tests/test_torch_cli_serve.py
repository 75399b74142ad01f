"""The CLI's serving and twin flags against JAX's, on the CPU.

Both ``main``s on one argv (``--platform cpu``, each side's own output
paths): ``--serve 0 --serve-chunk`` with ``--postmortem``, ``--slo`` and
``--trace-out``; a single run's ``--trace-out`` and ``--whatif``;
``--ingest`` with ``--arrival-log``, then ``--replay-arrivals``; and
``--tenants 2``.  The exit codes, the JSON lines, the results files, the
trace, the bundles and the arrival logs match.  Fields that differ by run
are removed by name: ``wall_s``, ``port`` and ``served_port`` (an
ephemeral port), ``recorded_at``, the paths (each side's directory reads
as ``OUT``) and ``latency_s`` of the ingest stats.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

from fognetsimpp_tpu.__main__ import main as jmain
from fognetsimpp_tpu_torch.__main__ import main as tmain
from tests.torch_cli_support import run_main, summary_lines
from tests.torch_exporter_support import without_compile_families
from tools.check_openmetrics import check


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


SMALL = ["-s", "smoke", "--set", "scenario.n_users=6", "--set", "fog.*.mips=100000",
         "--set", "scenario.horizon=0.1", "--set", "spec.derive_acks=false"]
#: Keys of a JSON line that differ by run.
VARYING = {"wall_s", "port"}
PATHS = {"sca", "vec", "om", "sca_txt", "vec_txt", "anf", "trace"}


def _both(argv, capsys, root):
    """Both CLIs; ``{side}`` in an argument becomes ``<root>/jax`` or
    ``<root>/port``.  ``[(rc, stdout, stderr, dir)]``, JAX first."""
    out = []
    for main, side in ((jmain, "jax"), (tmain, "port")):
        d = os.path.join(str(root), side)
        os.makedirs(d, exist_ok=True)
        args = [a.replace("{side}", d) for a in argv] + ["--platform", "cpu"]
        out.append(run_main(main, args, capsys) + (d,))
    return out


def _masked(obj, d):
    """A JSON value with the side's directory read as ``OUT`` and the
    run-varying keys dropped."""
    text = json.dumps(obj).replace(d, "OUT")
    obj = json.loads(text)
    if isinstance(obj, dict):
        obj = {k: v for k, v in obj.items() if k not in VARYING}
        if isinstance(obj.get("ingest"), dict):
            obj["ingest"] = {k: v for k, v in obj["ingest"].items() if k != "latency_s"}
    return obj


def _same_lines(jres, tres):
    (jrc, jout, jerr, jdir), (trc, tout, terr, tdir) = jres, tres
    assert jrc == trc == 0, terr[-2000:]
    want, got = summary_lines(jout), summary_lines(tout)
    assert len(got) == len(want) >= 1
    for w, g in zip(want, got):
        assert list(g) == list(w)
        assert _masked(g, tdir) == _masked(w, jdir)
    return want[-1], got[-1]


def _sca(path, d):
    doc = json.loads(open(path).read().replace(d, "OUT"))
    doc.pop("recorded_at")
    doc.pop("compile_cache", None)
    doc["attrs"].pop("served_port", None)
    return doc


def _scave(path, d):
    text = open(path).read().replace(d, "OUT")
    return re.sub(r"^attr (datetime|processid|served_port) .*$", r"attr \1 -", text, flags=re.M)


def _same_files(jsum, tsum, jdir, tdir):
    keys = [k for k in PATHS if k in tsum]
    assert sorted(keys) == sorted(k for k in PATHS if k in jsum)
    for k in keys:
        jp, tp = jsum[k], tsum[k]
        if k == "sca":
            assert _sca(tp, tdir) == _sca(jp, jdir)
        elif k == "vec":
            a, b = np.load(jp), np.load(tp)
            assert sorted(b.files) == sorted(a.files)
            assert all(b[f].tobytes() == a[f].tobytes() for f in a.files)
        elif k == "om":
            assert open(tp).read() == without_compile_families(open(jp).read())
            assert check(tp) == 0
        elif k == "trace":
            assert json.load(open(tp)) == json.load(open(jp))
        else:
            assert _scave(tp, tdir) == _scave(jp, jdir), k
    return keys


def test_serve_with_postmortem_and_trace_matches_jax(tmp_path, capsys):
    argv = SMALL + ["--serve", "0", "--serve-chunk", "25", "--hist", "--journeys", "4",
                    "--slo", "0.001", "--postmortem", "{side}/pm",
                    "--trace-out", "{side}/trace.json", "--out", "{side}/out"]
    jres, tres = _both(argv, capsys, tmp_path)
    jsum, tsum = _same_lines(jres, tres)
    assert len(summary_lines(tres[1])) == 5  # a health line a chunk, the summary
    assert sorted(_same_files(jsum, tsum, jres[3], tres[3])) == sorted(PATHS)
    assert tsum["chunks"] == 4 and tsum["slo_breaches"] > 0 and tsum["dumps"]
    for jp, tp in zip(jsum["dumps"], tsum["dumps"]):
        drop = ("recorded_at", "compile_cache", "trace")
        want = {k: v for k, v in json.load(open(jp)).items() if k not in drop}
        got = json.load(open(tp))
        assert {k: v for k, v in got.items() if k not in drop} == want
        assert json.load(open(got["trace"])) == json.load(open(json.load(open(jp))["trace"]))


def test_trace_out_and_whatif_match_jax(tmp_path, capsys):
    argv = SMALL + ["--telemetry", "--hist", "--set", "spec.uplink_loss_prob=0.01",
                    "--whatif", "uplink_loss_prob=0.05,0.1 ticks=20",
                    "--trace-out", "{side}/trace.json", "--trace-max-tasks", "30"]
    jres, tres = _both(argv, capsys, tmp_path)
    jsum, tsum = _same_lines(jres, tres)
    assert _same_files(jsum, tsum, jres[3], tres[3]) == ["trace"]
    assert tsum["whatif"]["n_cells"] == 2 and tsum["whatif"]["horizon_ticks"] == 20


def test_ingest_log_and_replay_match_jax(tmp_path, capsys):
    argv = SMALL + ["--serve", "0", "--serve-chunk", "25", "--ingest", "8",
                    "--ingest-batch", "4", "--arrival-log", "{side}/live.json"]
    jres, tres = _both(argv, capsys, tmp_path / "live")
    jsum, tsum = _same_lines(jres, tres)
    assert tsum["ingest"]["capacity"] == 8
    live = [json.load(open(os.path.join(r[3], "live.json"))) for r in (jres, tres)]
    assert live[1] == live[0] == {"capacity": 8, "entries": []}
    log = {"capacity": 8, "entries": [
        {"ticks_done": 25, "user": [0, 1, 1], "mips": [500.0, 250.5, 90.0]},
        {"ticks_done": 50, "user": [3, 9], "mips": [1000.0, 5.0]},
    ]}
    path = tmp_path / "in.json"
    path.write_text(json.dumps(log))
    argv = SMALL + ["--serve", "0", "--serve-chunk", "25", "--ingest-batch", "4",
                    "--replay-arrivals", str(path), "--arrival-log", "{side}/re.json",
                    "--out", "{side}/out"]
    jres, tres = _both(argv, capsys, tmp_path / "replay")
    jsum, tsum = _same_lines(jres, tres)
    _same_files(jsum, tsum, jres[3], tres[3])
    # user 9 is past the population: neither injected nor rejected
    assert tsum["ingest"]["injected"] == 4 and tsum["ingest"]["rejected"] == 0
    again = json.load(open(os.path.join(tres[3], "re.json")))
    assert again == json.load(open(os.path.join(jres[3], "re.json")))
    assert again["entries"] == log["entries"]


def test_tenants_match_jax(tmp_path, capsys):
    argv = SMALL + ["--serve", "0", "--tenants", "2", "--serve-chunk", "25"]
    jres, tres = _both(argv, capsys, tmp_path)
    jsum, tsum = _same_lines(jres, tres)
    assert tsum["tenants"] == 2 and tsum["rounds"] == 4
    assert tsum["ticks"] == {"t0": 100, "t1": 100}
