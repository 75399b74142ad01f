"""The port's result files against JAX's, from the same world.

``record_run`` of the port's final state and series against JAX's
``record_run`` of JAX's: ``.sca.json`` key for key (JAX's
``compile_cache`` section, XLA's program cache, has no port counterpart),
``.vec.npz`` array for array, and the OMNeT++ twins ``.sca`` / ``.vec`` /
``General.anf`` byte for byte with the run-stamp attributes masked
(``datetime``, ``processid``, ``recorded_at``) and the output directory
read as one name.  Then the readers of the results: ``read_sca`` /
``read_vec`` on both packages' files and on a file in the reference's own
grammar, ``analyze`` / ``render_report``, ``message_counts`` and the
trails picture, also through the CLI (``--trails``, ``--analyze``).
"""
import json
import re

import numpy as np
import pytest
import torch

from fognetsimpp_tpu import messages as jmessages
from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.runtime import analysis as janalysis
from fognetsimpp_tpu.runtime import recorder as jrecorder
from fognetsimpp_tpu.runtime import scave as jscave
from fognetsimpp_tpu.runtime import trails as jtrails
from fognetsimpp_tpu.scenarios import wireless as jwireless
from fognetsimpp_tpu_torch import messages as tmessages
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.runtime import analysis as tanalysis
from fognetsimpp_tpu_torch.runtime import recorder as trecorder
from fognetsimpp_tpu_torch.runtime import scave as tscave
from fognetsimpp_tpu_torch.runtime import trails as ttrails
from fognetsimpp_tpu_torch.scenarios import wireless as twireless
from tests.torch_cli_support import assert_same_files, assert_same_summary, run_both


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


#: A wireless world with every recorded section a single run can carry:
#: the series and trails, the telemetry planes (busy fractions, the
#: latency histogram, journeys) and access points.
WORLD = dict(numb_users=40, horizon=0.3, record_tick_series=True, record_trails=True,
             telemetry=True, telemetry_hist=True, telemetry_journeys=8,
             derive_acks=False)
ATTRS = {"scenario": "wireless5", "argv": ["-s", "wireless5"]}


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """Both packages' files of the same world: ``(jax dir, port dir,
    jax paths, port paths, jax (spec, final, series, net), port's)``."""
    root = tmp_path_factory.mktemp("rec")
    jspec, jst, jnet, jb = jwireless.wireless5(**WORLD)
    jfinal, jseries = jengine.run(jspec, jst, jnet, jb)
    tspec, tst, tnet, tb = twireless.wireless5(device="cpu", **WORLD)
    tfinal, tseries = tengine.run(tspec, tst, tnet, tb)
    jdir, tdir = root / "jax", root / "port"
    jp = jrecorder.record_run(str(jdir), jspec, jfinal, series=jseries, attrs=ATTRS)
    tp = trecorder.record_run(str(tdir), tspec, tfinal, series=tseries, attrs=ATTRS)
    return (jdir, tdir, jp, tp, (jspec, jfinal, jseries, jnet),
            (tspec, tfinal, tseries, tnet))


def test_sca_json_matches_jax_key_for_key(recorded):
    _, _, jp, tp, *_ = recorded
    want = json.load(open(jp["sca"]))
    got = json.load(open(tp["sca"]))
    assert "compile_cache" in want and "compile_cache" not in got
    want.pop("compile_cache")
    want.pop("recorded_at")
    assert re.fullmatch(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", got.pop("recorded_at"))
    assert list(got) == list(want)
    assert got == want
    for section in ("hist", "journeys"):
        assert section in got
    assert got["modules"]["ap"] and "busy_frac" in got["modules"]["fog"][0]


def test_vec_npz_matches_jax_array_for_array(recorded):
    _, _, jp, tp, *_ = recorded
    want, got = np.load(jp["vec"]), np.load(tp["vec"])
    assert sorted(got.files) == sorted(want.files)
    assert "tick.energy_mean" in got.files and "tick.pos" in got.files
    for k in want.files:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def _masked(path, outdir):
    text = open(path).read().replace(str(outdir), "OUTDIR")
    return re.sub(r"^attr (datetime|processid) .*$", r"attr \1 -", text, flags=re.M)


@pytest.mark.parametrize("kind", ["sca_txt", "vec_txt", "anf"])
def test_scave_twins_match_jax_byte_for_byte(recorded, kind):
    jdir, tdir, jp, tp, *_ = recorded
    assert _masked(tp[kind], tdir) == _masked(jp[kind], jdir)


#: The reference's ``.sca`` grammar: header, quoted names, a statistic
#: block with fields, a nested attr and histogram bins.
REFERENCE_GRAMMAR = """version 2
run General-0-20180626-10:00:00-1234
attr configname General
attr network WirelessNet

scalar WirelessNet.BaseBroker.udpApp[0] \techoedPk:count \t1744
scalar WirelessNet.ComputeBroker1.eth[0].mac \t"simulated time" \t3.350067039997
statistic WirelessNet.ComputeBroker1.udpApp[0] \trcvdPkLifetime:stats
field count 3
field mean 0.25
field min -0.5
attr unit s
bin -INF 0
bin 0 2
bin 1 1

scalar WirelessNet.user.udpApp[0] \t"frames/sec sent" \t12.5
"""


def test_readers_match_jax(recorded, tmp_path):
    jdir, tdir, jp, tp, *_ = recorded
    ref = tmp_path / "ref.sca"
    ref.write_text(REFERENCE_GRAMMAR)
    for path in (jp["sca_txt"], tp["sca_txt"], str(ref)):
        # repr: the empty statistics' NaN fields compare equal as text
        assert repr(tscave.read_sca(path)) == repr(jscave.read_sca(path))
    got = tscave.read_sca(str(ref))
    assert got["statistics"][("WirelessNet.ComputeBroker1.udpApp[0]",
                               "rcvdPkLifetime:stats")]["bins"][0] == (float("-inf"), 0.0)
    for path in (jp["vec_txt"], tp["vec_txt"]):
        want, got = jscave.read_vec(path), tscave.read_vec(path)
        assert got["vectors"] == want["vectors"] and got["attrs"] == want["attrs"]
        assert got["data"].keys() == want["data"].keys()
        for vid, cols in want["data"].items():
            for a, b in zip(got["data"][vid], cols):
                assert a.tobytes() == b.tobytes()
    some = sorted(want["vectors"])[:2]
    assert tscave.read_vec(tp["vec_txt"], vector_ids=set(some))["data"].keys() <= set(some)


def test_analyze_and_report_match_jax(recorded):
    jdir, tdir, *_ = recorded
    want, got = janalysis.analyze(str(jdir)), tanalysis.analyze(str(tdir))
    assert got == want
    assert tanalysis.render_report(got) == janalysis.render_report(want)
    with pytest.raises(FileNotFoundError):
        tanalysis.analyze(str(tdir / "nothing-here"))


def test_message_counts_and_schemas_match_jax(recorded):
    *_, (jspec, jfinal, _, _), (tspec, tfinal, _, _) = recorded
    assert tmessages.message_counts(tspec, tfinal) == jmessages.message_counts(jspec, jfinal)
    assert list(tmessages.live_schemas()) == list(jmessages.live_schemas())
    for name, s in jmessages.SCHEMAS.items():
        t = tmessages.SCHEMAS[name]
        assert (t.msg_file, t.direction.value, t.payload, t.realised_by, t.live) == (
            s.msg_file, s.direction.value, s.payload, s.realised_by, s.live)


def test_trails_svg_matches_jax(recorded, tmp_path):
    *_, (jspec, jfinal, jseries, jnet), (tspec, tfinal, tseries, tnet) = recorded
    jpath = jtrails.render_trails_svg(jspec, jfinal, jseries, str(tmp_path / "j.svg"), net=jnet)
    tpath = ttrails.render_trails_svg(tspec, tfinal, tseries, str(tmp_path / "t.svg"), net=tnet)
    assert open(tpath).read() == open(jpath).read()
    with pytest.raises(ValueError, match="record_trails"):
        ttrails.render_trails_svg(tspec, tfinal, {"t": tseries["t"]}, str(tmp_path / "x.svg"))


def test_cli_trails_and_analyze_match_jax(tmp_path, capsys):
    argv = ["-s", "wireless5", "--trails", str(tmp_path / "t.svg"),
            "--set", "scenario.numb_users=6", "--set", "scenario.horizon=0.2"]
    (jrc, jout, _, jdir), (trc, tout, _, tdir) = run_both(argv, capsys, tmp_path)
    assert jrc == trc == 0
    jsum, tsum = assert_same_summary(jout, tout)
    assert_same_files(jsum, tsum, jdir, tdir)
    assert tsum["trails"] == jsum["trails"]  # one path: the port wrote it last
    assert open(tsum["trails"]).read().startswith("<svg")
    (jrc, jout, _, _), (trc, tout, _, _) = run_both(["--analyze", str(jdir)], capsys)
    assert jrc == trc == 0 and tout == jout and "== run General-0" in tout
