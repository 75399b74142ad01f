"""The port's digital twin against JAX's, on the CPU.

* ``inject_arrivals``: every leaf and both counts equal JAX's, on a batch
  with several rows for one user, a dead user, a user with one send slot
  left, a user past the population, and padding; on the wired smoke world
  and on a mobile linear-MAC wireless world, where the injector's
  contracted association (``fused=True``, as JAX's jitted injector
  computes it) and the op-by-op one differ for an injected user.
* A live session through ``serve_ingest_run`` and its replay from the
  recorded arrival log: JAX's final state, flight-recorder hashes and log.
* ``run_whatif``: JAX's report, each cell equal to a direct run from the
  carry, bad grids refused with JAX's errors.
* ``FrontDoor`` with two tenants: JAX's states, pages and rings, tenant by
  tenant.
* A what-if asked over HTTP while a live serve run goes on: JAX's answer
  from the carry it forked.
* The ``[TWIN-*]`` gate texts and the doors' 400 answers.
"""
import dataclasses
import json
import re
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu.scenarios import wireless as jwireless
from fognetsimpp_tpu.twin import front as jfront
from fognetsimpp_tpu.twin import gates as jgates
from fognetsimpp_tpu.twin import ingest as jingest
from fognetsimpp_tpu.twin import whatif as jwhatif
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.dynspec import dyn_to_device, split_spec
from fognetsimpp_tpu_torch.net.topology import associate
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.scenarios import wireless as twireless
from fognetsimpp_tpu_torch.state import state_to_numpy, tree_map
from fognetsimpp_tpu_torch.telemetry.live import HealthServer
from fognetsimpp_tpu_torch.twin import front as tfront
from fognetsimpp_tpu_torch.twin import gates as tgates
from fognetsimpp_tpu_torch.twin import ingest as tingest
from fognetsimpp_tpu_torch.twin import whatif as twhatif
from tests.torch_exporter_support import without_compile_families


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


TIMEOUT_S = 60


def _jleaves(state):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


def _differing(got, want_leaves):
    got = state_to_numpy(got)
    assert len(got) == len(want_leaves)
    return [i for i, (a, b) in enumerate(zip(got, want_leaves))
            if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes()]


# ---- the injector ----------------------------------------------------------

#: Worlds with the ingest gate, and the ticks before the injection.
INJECT = {
    "wired": (lambda m, **k: m.build(n_users=6, n_fogs=2, horizon=0.1, max_sends_per_user=6,
                                     ingest=True, ingest_batch=8, **k), 60),
    # at t = 0, with every user connected by hand: a wireless user's
    # handshake takes 0.2-0.5 s, and past a few ms the arrival time
    # t + d2b rounds the two associations' one-ulp difference away
    "wireless": (lambda m, **k: m.wireless5(numb_users=16, horizon=0.6, mac_model="linear",
                                            energy_enabled=False, ingest=True,
                                            ingest_batch=8, **k), 0),
}


def _prepared(name):
    """Both packages' carries after the warm-up, user 1 dead and user 2
    one send slot short of its last."""
    build, ticks = INJECT[name]
    mod_t, mod_j = (tsmoke, jsmoke) if name == "wired" else (twireless, jwireless)
    spec, st, net, b = build(mod_t, device="cpu")
    js, jst, jn, jb = build(mod_j)
    if ticks:
        st, _ = tengine.run(spec, st, net, b, n_ticks=ticks)
        jst, _ = jengine.run(js, jst, jn, jb, n_ticks=ticks)
    else:
        st = st.replace(users=st.users.replace(connected=torch.ones_like(st.users.connected)))
        jst = jst.replace(users=jst.users.replace(connected=jst.users.connected | True))
    S = spec.max_sends_per_user
    alive = st.nodes.alive.clone()
    alive[1] = False
    count = st.users.send_count.clone()
    count[2] = S - 1
    st = st.replace(nodes=st.nodes.replace(alive=alive),
                    users=st.users.replace(send_count=count))
    jst = jst.replace(nodes=jst.nodes.replace(alive=jst.nodes.alive.at[1].set(False)),
                      users=jst.users.replace(send_count=jst.users.send_count.at[2].set(S - 1)))
    return spec, st, net, js, jst, jn


@pytest.mark.parametrize("name", sorted(INJECT))
def test_inject_arrivals_matches_jax(name):
    spec, st, net, js, jst, jn = _prepared(name)
    U = spec.n_users
    connected = [u for u in range(3, U) if bool(st.users.connected[u])]
    assert connected, "no user connected after the warm-up"
    u3 = connected[0]
    if name == "wireless":
        # an injected user whose contracted and op-by-op delays differ
        fused = associate(net, st.nodes.pos, st.nodes.alive, spec.broker_index, fused=True)
        plain = associate(net, st.nodes.pos, st.nodes.alive, spec.broker_index, fused=False)
        parted = [u for u in connected
                  if float(st.t + fused.d2b[u]) != float(st.t + plain.d2b[u])]
        assert parted, "the test world no longer tells the two associations apart"
        u3 = parted[0]
    users = [0, 0, 1, 2, 2, u3, U + 5]  # 7 rows: one padding row of 8
    mips = [1234.5, 800.0, 999.0, 4000.25, 3000.0, 1500.75, 10.0]
    got, n_inj, n_rej = tengine.inject_arrivals(spec, st, net, users, mips)
    want, j_inj, j_rej = jengine.inject_arrivals(js, jst, jn, users, mips)
    assert (n_inj, n_rej) == (j_inj, j_rej)
    assert _differing(got, _jleaves(want)) == []
    # user 0 twice, user 2 once (one slot left), u3 once; the dead user
    # and the second row of user 2 rejected (the one past U is neither)
    expect = int(bool(st.users.connected[0])) * 2 + int(bool(st.users.connected[2])) + 1
    assert n_inj == expect and n_rej == 6 - expect
    # draw-free: the key is untouched
    assert torch.equal(got.key, st.key)
    with pytest.raises(ValueError) as e:
        tengine.inject_arrivals(spec, st, net, list(range(9)), [1.0] * 9)
    with pytest.raises(ValueError) as je:
        jengine.inject_arrivals(js, jst, jn, list(range(9)), [1.0] * 9)
    assert str(e.value) == str(je.value)


def test_inject_refusals_match_jax():
    spec, st, net, b = tsmoke.build(device="cpu", n_users=4, horizon=0.02)
    js, jst, jn, jb = jsmoke.build(n_users=4, horizon=0.02)
    for t_fn, j_fn in (
        (lambda: tengine.inject_arrivals(spec, st, net, [0], [1.0]),
         lambda: jengine.inject_arrivals(js, jst, jn, [0], [1.0])),
        (lambda: tingest.make_inject(spec, net, tingest.IngestQueue(2)),
         lambda: jingest.make_inject(js, jn, jingest.IngestQueue(2))),
        (lambda: tingest.serve_ingest_run(spec, st, net, b, port=None),
         lambda: jingest.serve_ingest_run(js, jst, jn, jb, port=None)),
    ):
        with pytest.raises(ValueError) as e:
            t_fn()
        with pytest.raises(ValueError) as je:
            j_fn()
        assert str(e.value) == str(je.value)


# ---- a live session and its replay ------------------------------------------

def _no_latency(stats):
    """Queue stats less ``latency_s``, a wall-clock reading."""
    return {k: v for k, v in stats.items() if k != "latency_s"}


def _ring(recorder):
    """A flight recorder's ring with each entry's ingest stats less
    ``latency_s``."""
    return [dict(e, **({"ingest": _no_latency(e["ingest"])} if "ingest" in e else {}))
            for e in recorder.ring]


SESSION = dict(n_users=6, n_fogs=2, fog_mips=(100000.0,), horizon=0.2, telemetry=True,
               telemetry_hist=True, derive_acks=False, ingest=True, ingest_batch=4)
SESSION_CHUNK = 50
FEED = [(0, 500.0), (1, 800.0), (0, 250.0), (3, 1000.0), (5, 60.5), (2, 700.0)]


def test_live_session_and_replay_match_jax(tmp_path):
    """Six queued arrivals drain four and two at the first two
    boundaries; the port's final state, ring hashes, log and queue stats
    are JAX's, and a replay from the log reproduces the hashes."""
    from fognetsimpp_tpu.telemetry.live import FlightRecorder as JRec
    from fognetsimpp_tpu_torch.telemetry.live import FlightRecorder as TRec

    out = {}
    for name, build, ingest, Rec, kw in (
        ("jax", jsmoke.build, jingest, JRec, {}),
        ("port", tsmoke.build, tingest, TRec, {"device": "cpu"}),
    ):
        spec, st, net, b = build(**SESSION, **kw)
        q = ingest.IngestQueue(capacity=8)
        q.feed_rows(FEED)
        rec = Rec()
        final, status = ingest.serve_ingest_run(
            spec, st, net, b, queue=q, port=None, whatif=False,
            chunk_ticks=SESSION_CHUNK, recorder=rec)
        log = status["arrival_log"]
        spec2, st2, net2, b2 = build(**SESSION, **kw)
        rec2 = Rec()
        final2, status2 = ingest.serve_ingest_run(
            spec2, st2, net2, b2, port=None, whatif=False, chunk_ticks=SESSION_CHUNK,
            recorder=rec2, replay_log=log)
        out[name] = (final, status, rec, final2, status2, rec2)
    jf, js_, jrec, jf2, js2, jrec2 = out["jax"]
    tf, ts_, trec, tf2, ts2, trec2 = out["port"]
    assert _differing(tf, _jleaves(jf)) == []
    assert _differing(tf2, _jleaves(jf)) == []
    assert ts_["arrival_log"] == js_["arrival_log"]
    assert [e["ticks_done"] for e in ts_["arrival_log"]] == [50, 100]
    stats = _no_latency(ts_["ingest"])
    assert stats == _no_latency(js_["ingest"])
    assert stats["injected"] + stats["rejected"] == len(FEED) and stats["injected"] > 0
    assert _ring(trec) == _ring(jrec)  # JAX's state hashes, chunk by chunk
    assert _ring(trec2) == _ring(jrec2)
    hashes = [e["state_hash"] for e in trec.ring]
    assert [e["state_hash"] for e in trec2.ring] == hashes and len(hashes) == 4
    assert ts2["arrival_log"] == ts_["arrival_log"]


# ---- what-if ------------------------------------------------------------------

WHATIF = dict(n_users=8, n_fogs=3, fog_mips=(50000.0,), telemetry=True, telemetry_hist=True,
              derive_acks=False, horizon=0.2, uplink_loss_prob=0.01, send_stop_time=0.5)
FORK_TICKS = 80
AHEAD = 40
GRID = {"uplink_loss_prob": [0.05, 0.2], "send_stop_time": [0.15, 1.0]}


@pytest.fixture(scope="module")
def carries():
    spec, st, net, b = tsmoke.build(device="cpu", **WHATIF)
    js, jst, jn, jb = jsmoke.build(**WHATIF)
    carry, _ = tengine.run(spec, st, net, b, n_ticks=FORK_TICKS)
    jcarry, _ = jengine.run(js, jst, jn, jb, n_ticks=FORK_TICKS)
    return (spec, carry, net, b), (js, jcarry, jn, jb)


def test_run_whatif_matches_jax_and_direct_runs(carries):
    (spec, carry, net, b), (js, jcarry, jn, jb) = carries
    report, batch = twhatif.run_whatif(spec, carry, net, b, GRID, AHEAD, return_state=True)
    want, jbatch = jwhatif.run_whatif(js, jcarry, jn, jb, GRID, AHEAD, return_state=True)
    assert report == want and report["n_cells"] == 4
    assert json.loads(json.dumps(twhatif._json_safe(report))) == jwhatif._json_safe(want)
    assert _differing(batch, _jleaves(jbatch)) == []
    key_spec, _ = split_spec(spec)
    for i, cell in enumerate({k: c[k] for k in GRID} for c in report["cells"]):
        _, dyn = split_spec(dataclasses.replace(spec, **cell))
        direct, _ = tengine.run(key_spec, carry, net, b, n_ticks=AHEAD,
                                dyn=dyn_to_device(dyn, "cpu"))
        row = tree_map(lambda x: x[i], batch)
        assert _differing(row, state_to_numpy(direct)) == [], cell


@pytest.mark.parametrize("knobs, ticks", [
    ({"uplink_loss_prob": [0.1]}, 0),
    ({"not_a_knob": [1.0]}, 10),
    ({"uplink_loss_prob": [0.0]}, 10),
    ({"n_users": [9]}, 10),
])
def test_bad_whatif_grids_raise_jax_errors(carries, knobs, ticks):
    (spec, carry, net, b), (js, jcarry, jn, jb) = carries
    with pytest.raises(ValueError) as e:
        twhatif.run_whatif(spec, carry, net, b, knobs, ticks)
    with pytest.raises(ValueError) as je:
        jwhatif.run_whatif(js, jcarry, jn, jb, knobs, ticks)
    assert str(e.value) == str(je.value)


@pytest.mark.parametrize("text", [
    "uplink_loss_prob=0.05,0.1 ticks=32", "a=1 b=2,3", "uplink_loss_prob",
    "ticks=100", "uplink_loss_prob=x", "ticks=many uplink_loss_prob=0.1",
])
def test_parse_grid_matches_jax(text):
    try:
        want = jwhatif.parse_grid(text)
    except ValueError as je:
        with pytest.raises(ValueError) as e:
            twhatif.parse_grid(text)
        assert str(e.value) == str(je)
        return
    assert twhatif.parse_grid(text) == want


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_whatif_over_http_during_a_live_run_matches_jax():
    """A client thread asks ``POST /whatif`` after the first chunk while
    the loop runs on; the answer equals JAX's ``run_whatif`` from JAX's
    carry at the boundary the port forked from (after that boundary's
    injection)."""
    kw = dict(WHATIF, ingest=True, ingest_batch=4)
    spec, st, net, b = tsmoke.build(device="cpu", **kw)
    q = tingest.IngestQueue(capacity=8)
    q.feed_rows(FEED[:3])
    ask = json.dumps({"knobs": {"uplink_loss_prob": [0.02, 0.3]}, "ticks": 20}).encode()
    answer, threads = {}, []

    def on_chunk(health):
        if health["chunks"] == 1:
            url = f"http://127.0.0.1:{port['port']}/whatif"
            th = threading.Thread(target=lambda: answer.update(r=_post(url, ask)))
            th.start()
            threads.append(th)

    server = HealthServer(port=0)
    port = {"port": server.port}
    try:
        final, status = tingest.serve_ingest_run(
            spec, st, net, b, queue=q, server=server, chunk_ticks=40, on_chunk=on_chunk,
            whatif_ticks=20)
        for th in threads:
            th.join(TIMEOUT_S)
        assert threads and not any(th.is_alive() for th in threads)
    finally:
        server.close()
    code, report = answer["r"]
    assert code == 200, report
    done = report.pop("fork_ticks_done")
    assert done in range(40, spec.n_ticks, 40)
    # JAX's carry at that boundary: its run with the same log, post-inject
    js, jst, jn, jb = jsmoke.build(**kw)
    kept = {}
    replay = jingest.make_replay_inject(js, jn, status["arrival_log"])

    def inject(s, d):
        s = replay(s, d)
        kept[d] = s
        return s

    jengine.run_chunked(js, jst, jn, jb, chunk_ticks=40, callback=lambda s, d: None,
                        inject=inject)
    want = jwhatif._json_safe(jwhatif.run_whatif(
        js, kept[done], jn, jb, {"uplink_loss_prob": [0.02, 0.3]}, 20))
    assert report == want


# ---- the front door -------------------------------------------------------------

def _mask_latency(text):
    """An exposition with the ingest latency gauge's wall-clock value
    masked."""
    return re.sub(r"^(fns_twin_ingest_latency_seconds) .*$", r"\1 -", text, flags=re.M)


def _health(h):
    return dict(h, **({"ingest": _no_latency(h["ingest"])} if "ingest" in h else {}))


TENANT = dict(telemetry=True, ingest=True, ingest_batch=8, horizon=1.0)
TENANT_CHUNK = 100


def _tenant_door(front, build, kw):
    door = front.FrontDoor(capacity=2, chunk_ticks=TENANT_CHUNK, bucket_floor=4, port=None)
    worlds = []
    for i, n in enumerate((5, 6)):
        w = build(n_users=n, seed=i, **TENANT, **kw)
        worlds.append(w)
        door.admit(f"t{i}", *w, ingest_capacity=8)
    return door, worlds


def test_front_door_two_tenants_match_jax():
    jdoor, jworlds = _tenant_door(jfront, jsmoke.build, {})
    door, worlds = _tenant_door(tfront, tsmoke.build, {"device": "cpu"})
    try:
        for d, w in ((jdoor, jworlds), (door, worlds)):
            with pytest.raises(ValueError) as e:
                d.admit("t2", *w[0])
            assert "[TWIN-CAP]" in str(e.value)
        assert str(e.value) == tgates.admission_error("t2", 2) == jgates.admission_error("t2", 2)
        body = b'{"rows": [[0, 250.0], [1, 90.5], [4, 3.0]]}'
        for _ in range(2):
            assert door.step() == jdoor.step()
            assert door._route("POST", "/t/t1/ingest", body) == \
                jdoor._route("POST", "/t/t1/ingest", body)
        door.step()
        jdoor.step()
        assert door.tenant_rows() == jdoor.tenant_rows()
        assert door.render_aggregate() == jdoor.render_aggregate()
        for label in ("t0", "t1"):
            t, jt = door._tenants[label], jdoor._tenants[label]
            assert _differing(t.state, _jleaves(jt.state)) == [], label
            assert _mask_latency(t.metrics_text) == \
                _mask_latency(without_compile_families(jt.metrics_text))
            assert _health(t.health) == _health(jt.health)
            assert _ring(t.recorder) == _ring(jt.recorder)
            assert _no_latency(t.queue.stats()) == _no_latency(jt.queue.stats())
            assert t.queue.log == jt.queue.log
            for path in (f"/t/{label}/metrics", f"/t/{label}/healthz"):
                got, want = door._route("GET", path, b""), jdoor._route("GET", path, b"")
                assert got[:2] == want[:2]
        ask = json.dumps({"knobs": {"uplink_loss_prob": [0.0]}, "ticks": 30}).encode()
        got = door._route("POST", "/t/t0/whatif", ask)
        want = jdoor._route("POST", "/t/t0/whatif", ask)
        assert (got[0], json.loads(got[2])) == (want[0], json.loads(want[2]))
        assert got[0] == 200
        for path in ("/t/nope/metrics", "/t/t0/bogus", "/metrics"):
            assert door._route("GET", path, b"") == jdoor._route("GET", path, b"")
    finally:
        door.close()
        jdoor.close()


# ---- the gates and the doors' 400s ------------------------------------------------

def test_gate_texts_match_jax():
    for fn, args in (
        ("ingest_reject_reason", [("tp",), ("fleet",), ("solo",)]),
        ("ingest_needs_serve_error", [()]),
        ("ingest_off_error", [()]),
        ("payload_error", [("x",)]),
        ("front_reject_reason", [("tp",), ("fleet",), ("solo",), ("single",)]),
        ("whatif_payload_error", [("y",)]),
        ("admission_error", [("a", 1), ("b", 3)]),
    ):
        for a in args:
            assert getattr(tgates, fn)(*a) == getattr(jgates, fn)(*a), (fn, a)
    for fleet in (False, True):
        for promote in (False, True):
            assert tgates.whatif_reject_reason(fleet=fleet, promote=promote) == \
                jgates.whatif_reject_reason(fleet=fleet, promote=promote)


PAYLOADS = [b"not json", b'{"user": -1, "mips": 5.0}', b'{"rows": [[0, "fast"]]}',
            b'{"mips": 5.0}', b'{"user": true, "mips": 1.0}', b'{"rows": 3}',
            b'{"user": 2, "mips": 5.0}', b'{"rows": [[0, 1], [1, 2.5], [2, 3]]}']
WHATIF_BODIES = [b"not json", b"[]", b'{"knobs": []}', b'{"knobs": {"x": []}}',
                 b'{"knobs": {"x": [1, "a"]}}', b'{"knobs": {"x": [1]}, "ticks": "soon"}',
                 b'{"knobs": {"uplink_loss_prob": [0.1]}}']


def test_door_answers_match_jax():
    tq, jq = tingest.IngestQueue(capacity=4), jingest.IngestQueue(capacity=4)
    for body in PAYLOADS:
        assert tq.ingest_payload(body) == jq.ingest_payload(body), body
        assert tq.handle_http("POST", "/ingest", body) == jq.handle_http("POST", "/ingest", body)
    assert tq.handle_http("GET", "/ingest", b"") == jq.handle_http("GET", "/ingest", b"")
    assert tq.handle_http("POST", "/other", b"") is None
    assert {k: v for k, v in tq.stats().items()} == jq.stats()
    with pytest.raises(ValueError) as e:
        tingest.IngestQueue(capacity=0)
    with pytest.raises(ValueError) as je:
        jingest.IngestQueue(capacity=0)
    assert str(e.value) == str(je.value)
    tdoor, jdoor = twhatif.WhatIfDoor(None, None, None), jwhatif.WhatIfDoor(None, None, None)
    for body in WHATIF_BODIES:
        assert tdoor._post(body) == jdoor._post(body), body
    assert tdoor.handle_http("GET", "/whatif", b"") == jdoor.handle_http("GET", "/whatif", b"")
