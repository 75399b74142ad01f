"""The port's live health plane against JAX's, on the CPU.

The watchdog on JAX's injected-row cases (the same anomalies, z-scores
and signals), the flight recorder's bundle on a NaN world (JAX's manifest
without its ``compile_cache`` section, the departure by design; the same
trace; ``tools/postmortem.py`` reads both alike), the pull endpoint and
the retune door on ``127.0.0.1:0``, and ``serve_run`` / ``serve_tp_run``
(2 shards): the same final state, flight-recorder ring and last
exposition as JAX's.  Fields that differ by run are removed by name:
``wall_s`` (/healthz), ``recorded_at`` and ``trace`` (a path) of a
manifest.  Every ``urlopen`` has a timeout; servers close in ``finally``.
"""
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.parallel import make_mesh
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu.telemetry import live as jlive
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.state import state_to_numpy
from fognetsimpp_tpu_torch.telemetry import live as tlive
from tests.torch_exporter_support import without_compile_families
from tools import postmortem
from tools.check_openmetrics import check_text


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


TIMEOUT_S = 30
#: Plane 1, the histogram and journeys on fast fogs, 200 ticks in 4 chunks.
SERVE = dict(n_users=16, n_fogs=3, fog_mips=(100000.0,), send_interval=0.01,
             horizon=0.2, telemetry=True, telemetry_hist=True,
             telemetry_journeys=8, derive_acks=False)
CHUNK = 50
#: The 2-shard serve: the ring bounded at two candidates a shard.
SERVE_TP = dict(n_users=16, n_fogs=3, send_interval=0.01, horizon=0.1,
                start_time_max=0.05, fog_mips=(100000.0,), telemetry=True,
                telemetry_hist=True)
TP_CHUNK = 25


def _jleaves(state):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


def _same_leaves(got, want):
    got = state_to_numpy(got)
    assert len(got) == len(want)
    return [i for i, (a, b) in enumerate(zip(got, want))
            if a.dtype != b.dtype or a.tobytes() != b.tobytes()]


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT_S) as r:
        return r.status, r.headers["Content-Type"], r.read().decode()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ---- the watchdog ------------------------------------------------------

def _q_step_rows():
    def rows(q):
        return {"t": np.asarray([0.1]), "q_len_total": np.asarray([q], float),
                "n_busy": np.asarray([2.0]), "n_deferred": np.asarray([0.0]),
                "n_completed": np.asarray([1.0]), "n_dropped": np.asarray([0.0])}

    return [rows(10.0 + 0.1 * (i % 2)) for i in range(8)] + [rows(80.0), {"t": np.zeros((0,))}]


def _crash_loss_rows():
    out = []
    for chunk in range(6):
        out.append({
            "t": np.asarray([chunk * 0.1]), "q_len_total": np.asarray([4.0]),
            "n_busy": np.asarray([2.0]), "n_deferred": np.asarray([0.0]),
            "n_completed": np.asarray([10.0 * chunk]), "n_dropped": np.asarray([0.0]),
            "defer_total": np.asarray([0.0]), "n_fogs_down": np.asarray([1.0]),
            "lost_crash_total": np.asarray([2.0 * chunk]),
        })
    return out


def _defer_rows():
    n = 10
    zero = np.zeros(n)
    return [{"t": np.arange(n, dtype=float), "q_len_total": zero, "n_busy": zero,
             "n_deferred": zero, "n_completed": zero, "n_dropped": zero,
             "defer_total": np.arange(n) * 5.0 * (k + 1)} for k in range(5)]


WATCH = {
    "q_depth_step": (dict(n_fogs=4, z_threshold=4.0, warmup=3), _q_step_rows),
    "crash_loss_floor": (dict(n_fogs=4, crash_loss_floor=1.0, row_ticks=1.0), _crash_loss_rows),
    "defer_rate_stride_100": (dict(n_fogs=4, row_ticks=100), _defer_rows),
    "defer_rate_stride_1": (dict(n_fogs=4, row_ticks=1), _defer_rows),
}


@pytest.mark.parametrize("case", sorted(WATCH))
def test_watchdog_matches_jax(case):
    kw, rows = WATCH[case]
    jwd, twd = jlive.Watchdog(**kw), tlive.Watchdog(**kw)
    fired = []
    for i, r in enumerate(rows()):
        want = jwd.update_from_rows(r, 100 * (i + 1), extra={"ingest_depth": 0.01 * i})
        got = twd.update_from_rows(r, 100 * (i + 1), extra={"ingest_depth": 0.01 * i})
        assert got == want
        fired += got
    assert bool(fired) == (case != "defer_rate_stride_100")  # a benign trickle
    assert list(twd.anomalies) == list(jwd.anomalies)
    assert twd.anomaly_count == jwd.anomaly_count
    assert twd.last_z == jwd.last_z and twd.last_signals == jwd.last_signals
    e_j, e_t = jlive.Ewma(warmup=3), tlive.Ewma(warmup=3)
    for x in (1.0, 1.0, 1.0, 1.0, 0.999, 0.2, 5.0):
        assert e_t.update(x) == e_j.update(x)


# ---- the endpoint and the retune door -----------------------------------

RECONF_BODIES = [
    b"not json", b"[]", b"{}", b'{"knobs": {"uplink_loss_prob": "x"}}',
    b'{"set": ["spec.uplink_loss_prob"]}', b'{"set": ["spec.uplink_loss_prob=oops"]}',
    b'{"knobs": {"n_users": 8}}', b'{"knobs": {"bogus_knob": 1}}',
    b'{"knobs": {"uplink_loss_prob": 0.0}}',
    b'{"knobs": {"uplink_loss_prob": 0.05}}',
    b'{"set": ["spec.uplink_loss_prob=0.02", "send_stop_time=0.5"]}',
]


def test_endpoint_and_reconfigure_door_match_jax():
    kw = dict(n_users=4, n_fogs=2, horizon=0.05, uplink_loss_prob=0.01, telemetry=True)
    js = jsmoke.build(**kw)[0]
    spec = tsmoke.build(device="cpu", **kw)[0]
    jdoor, door = jlive.ReconfigDoor(js), tlive.ReconfigDoor(spec)
    server = tlive.HealthServer(port=0)
    try:
        url = f"http://127.0.0.1:{server.port}"
        assert _get(url + "/metrics")[2] == "# EOF\n"
        assert json.loads(_get(url + "/healthz")[2]) == {"status": "starting"}
        server.set_metrics("fns_x 1\n# EOF\n")
        server.set_health({"status": "ok", "ticks_done": 7})
        status, ctype, text = _get(url + "/metrics")
        assert (status, text) == (200, "fns_x 1\n# EOF\n") and "openmetrics" in ctype
        assert json.loads(_get(url + "/healthz")[2]) == {"status": "ok", "ticks_done": 7}
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(url + "/nope")
        assert e.value.code == 404
        server.set_handler(door.handle_http)
        for body in RECONF_BODIES:
            want = jdoor.handle_http("POST", "/reconfigure", body)
            assert _post(url + "/reconfigure", body) == (want[0], json.loads(want[2])), body
        assert _get(url + "/reconfigure")[2] == jdoor.handle_http("GET", "/reconfigure", b"")[2]
        assert (door.accepted, door.rejected) == (jdoor.accepted, jdoor.rejected)
        assert door.accepted >= 1 and door.rejected >= 1
        popped = door.as_reconfigure()(10)
        assert popped == jdoor.as_reconfigure()(10) and popped
        assert door.as_reconfigure()(20) is None
    finally:
        server.close()


def test_serve_run_refusals_match_jax():
    for kw, slo in ((dict(), None), (dict(telemetry=True), 10.0)):
        spec, st, net, b = tsmoke.build(device="cpu", n_users=4, horizon=0.02, **kw)
        js, jst, jn, jb = jsmoke.build(n_users=4, horizon=0.02, **kw)
        with pytest.raises(ValueError) as want:
            jlive.serve_run(js, jst, jn, jb, port=None, slo_ms=slo)
        with pytest.raises(ValueError) as got:
            tlive.serve_run(spec, st, net, b, port=None, slo_ms=slo)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="n_shards"):
        tlive.serve_tp_run(spec, st, net, b)


# ---- the serving loops -------------------------------------------------

def _serve_both(serve_j, serve_t, j_args, t_args, **kw):
    """Run both loops on ``127.0.0.1:0``; each side's final, status, the
    health lines a chunk and the last ``/metrics`` and ``/healthz``."""
    out = []
    for serve, args in ((serve_j, j_args), (serve_t, t_args)):
        chunks = []
        res = serve(*args, port=0, on_chunk=chunks.append, **kw)
        status = res[-1]
        try:
            url = f"http://127.0.0.1:{status['port']}"
            metrics = _get(url + "/metrics")[2]
            health = json.loads(_get(url + "/healthz")[2])
        finally:
            status["server"].close()
        out.append((res, chunks, metrics, health))
    return out


def _strip_wall(health):
    return {k: v for k, v in health.items() if k != "wall_s"}


def test_serve_run_matches_jax_and_undonated_run():
    spec, st, net, b = tsmoke.build(device="cpu", **SERVE)
    js, jst, jn, jb = jsmoke.build(**SERVE)
    jref, _ = jengine.run(js, jst, jn, jb)
    (jres, jch, jm, jh), (tres, tch, tm, th) = _serve_both(
        jlive.serve_run, tlive.serve_run, (js, jst, jn, jb), (spec, st, net, b),
        chunk_ticks=CHUNK, slo_ms=1e6)
    (jfinal, jstat), (final, status) = jres, tres
    assert _same_leaves(final, _jleaves(jfinal)) == []
    assert _same_leaves(final, _jleaves(jref)) == []
    assert status["chunks"] == jstat["chunks"] == 4
    assert [_strip_wall(h) for h in tch] == [_strip_wall(h) for h in jch]
    assert tm == without_compile_families(jm) and check_text(tm, "live") == 0
    assert "fns_run_live_chunks 4" in tm and "fns_journey_tasks" in tm
    assert _strip_wall(th) == _strip_wall(jh)
    assert status["recorder"].ring == jstat["recorder"].ring  # JAX's state hashes
    assert list(status["watchdog"].anomalies) == list(jstat["watchdog"].anomalies)
    same = {k for k, v in jstat["scalars"].items()
            if v == status["scalars"][k] or (v != v and status["scalars"][k] != status["scalars"][k])}
    assert same == set(jstat["scalars"]) == set(status["scalars"])


def test_serve_tp_run_matches_jax():
    spec, st, net, b = tsmoke.build(device="cpu", **SERVE_TP)
    js, jst, jn, jb = jsmoke.build(**SERVE_TP)
    mesh = make_mesh(2, axis_name="node")
    (jres, jch, jm, jh), (tres, tch, tm, th) = _serve_both(
        lambda *a, **k: jlive.serve_tp_run(*a, mesh=mesh, exchange_window=2, **k),
        lambda *a, **k: tlive.serve_tp_run(*a, n_shards=2, exchange_window=2, **k),
        (js, jst, jn, jb), (spec, st, net, b), chunk_ticks=TP_CHUNK)
    (jspec2, jfinal, jstat), (spec2, final, status) = jres, tres
    assert (spec2.tp_shards, spec2.n_users) == (jspec2.tp_shards, jspec2.n_users) == (2, 16)
    assert status["tp_shards"] == jstat["tp_shards"] == 2
    assert _same_leaves(final, _jleaves(jax.device_get(jfinal))) == []
    assert [_strip_wall(h) for h in tch] == [_strip_wall(h) for h in jch]
    assert tm == without_compile_families(jm) and check_text(tm, "live_tp") == 0
    assert "fns_tp_exchange_deferred{shard=" in tm
    assert _strip_wall(th) == _strip_wall(jh)
    ring, jring = status["recorder"].ring, jstat["recorder"].ring
    assert ring == jring and all(len(e["shard_hashes"]) == 2 for e in ring)


# ---- the flight recorder -----------------------------------------------

def _manifest(path, drop=("recorded_at", "trace", "compile_cache")):
    with open(path) as f:
        m = json.load(f)
    return {k: v for k, v in m.items() if k not in drop}, m


def _pm_lines(lines):
    """``tools/postmortem.py`` summary lines less the run-stamped ones."""
    skip = ("recorded_at:", "compile:", "trace:")
    return [ln for ln in lines if not ln.startswith(skip)]


def test_flight_recorder_bundle_on_nan_matches_jax(tmp_path):
    kw = dict(SERVE, horizon=0.1)
    spec, st, net, b = tsmoke.build(device="cpu", **kw)
    js, jst, jn, jb = jsmoke.build(**kw)
    energy = st.nodes.energy.clone()
    energy[0] = float("nan")
    st = st.replace(nodes=st.nodes.replace(energy=energy))
    jst = jst.replace(nodes=jst.nodes.replace(
        energy=jst.nodes.energy.at[0].set(jnp.float32(float("nan")))))
    _, jstat = jlive.serve_run(js, jst, jn, jb, chunk_ticks=CHUNK, port=None,
                               dump_dir=str(tmp_path / "jax"))
    _, status = tlive.serve_run(spec, st, net, b, chunk_ticks=CHUNK, port=None,
                                dump_dir=str(tmp_path / "port"))
    assert [p.split("/")[-1] for p in status["dumps"]] == \
        [p.split("/")[-1] for p in jstat["dumps"]] != []
    for jp, tp in zip(jstat["dumps"], status["dumps"]):
        (want, jm), (got, tm) = _manifest(jp), _manifest(tp)
        assert "compile_cache" in jm and "compile_cache" not in tm
        assert got == want
        assert json.load(open(tm["trace"])) == json.load(open(jm["trace"]))
    m = tlive.FlightRecorder.load(status["dumps"][0])
    assert m["reason"] == "nan" and any("energy" in k for k in m["detail"]["nonfinite"])
    pj, pt = postmortem.load(jstat["dumps"][0]), postmortem.load(status["dumps"][0])
    assert _pm_lines(postmortem.summarize(pt)) == _pm_lines(postmortem.summarize(pj))
    assert postmortem.diff(pt, pj) == postmortem.diff(pj, pj)
    assert any("state hashes agree" in ln for ln in postmortem.diff(pt, pj))
    # a manual dump of the recorder after the run loads back its ring
    p2 = status["recorder"].dump(str(tmp_path / "port"), "manual", spec=spec)
    assert tlive.FlightRecorder.load(p2)["ring"] == status["recorder"].ring
