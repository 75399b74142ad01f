"""Shared helpers of the CLI test files (no tests here): run
``python -m fognetsimpp_tpu``'s ``main`` and the port's on one argv and
hold the port's printed JSON and results files to JAX's."""
import json
import os
import re

import numpy as np

from fognetsimpp_tpu.__main__ import main as jmain
from fognetsimpp_tpu_torch.__main__ import main as tmain
from tests.torch_exporter_support import without_compile_families

#: Summary keys that hold a file path or a wall time, which differ.
VARYING = {"wall_s", "sweep_wall_s", "sca", "vec", "om", "sca_txt", "vec_txt",
           "anf", "trails", "profile_dir"}


def run_main(main, argv, capsys):
    """``(exit code, stdout, stderr)`` of one ``main(argv)``."""
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


def run_both(argv, capsys, outroot=None):
    """Both CLIs on ``argv`` (+ ``--platform cpu``, + ``--out
    <outroot>/{jax,port}`` when given): ``(jax, port)``, each ``(rc,
    stdout, stderr, outdir)``."""
    res = []
    for main, name in ((jmain, "jax"), (tmain, "port")):
        extra = ["--platform", "cpu"]
        out = None
        if outroot is not None:
            out = os.path.join(str(outroot), name)
            extra += ["--out", out]
        res.append(run_main(main, list(argv) + extra, capsys) + (out,))
    return res


def summary_lines(stdout):
    return [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]


def assert_same_summary(jax_out, port_out):
    """The printed JSON lines: the same keys in the same order, and the
    same values but for wall times and paths."""
    want, got = summary_lines(jax_out), summary_lines(port_out)
    assert len(got) == len(want) >= 1
    for w, g in zip(want, got):
        assert list(g) == list(w)
        assert {k: v for k, v in g.items() if k not in VARYING} == {
            k: v for k, v in w.items() if k not in VARYING}
    return want[-1], got[-1]


def _text(path, outdir):
    text = open(path).read().replace(str(outdir), "OUT")
    return re.sub(r"^attr (datetime|processid) .*$", r"attr \1 -", text, flags=re.M)


def assert_same_files(jsum, tsum, jdir, tdir):
    """Every results file the port wrote equals JAX's of the same key:
    ``.sca.json`` key for key without ``compile_cache`` and the run
    stamp, ``.npz`` array for array, the OpenMetrics text byte for byte
    without JAX's ``fns_compile_*`` families, text twins byte for byte
    with the stamps masked; the output directory reads as one name."""
    keys = [k for k in ("sca", "vec", "om", "sca_txt", "vec_txt", "anf") if k in tsum]
    assert keys and all(k in jsum for k in keys)
    for k in keys:
        jp, tp = jsum[k], tsum[k]
        if jp.endswith(".npz"):
            a, b = np.load(jp), np.load(tp)
            assert sorted(b.files) == sorted(a.files), k
            for f in a.files:
                assert b[f].dtype == a[f].dtype and b[f].tobytes() == a[f].tobytes(), (k, f)
        elif k == "om":
            assert open(tp).read() == without_compile_families(open(jp).read()), k
        elif jp.endswith(".json"):
            a = json.loads(open(jp).read().replace(str(jdir), "OUT"))
            b = json.loads(open(tp).read().replace(str(tdir), "OUT"))
            a.pop("compile_cache", None)
            a.pop("recorded_at")
            b.pop("recorded_at")
            assert list(b) == list(a) and b == a, k
        else:
            assert _text(tp, tdir) == _text(jp, jdir), k
    return keys
