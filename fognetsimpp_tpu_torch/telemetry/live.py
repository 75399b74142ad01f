"""Live health plane, host half: serving loop, watchdog, flight recorder.

Counterpart of ``fognetsimpp_tpu/telemetry/live.py``: a serving loop over
the port's :func:`..core.engine.run_chunked`.  Per chunk it

* takes the reservoir rows the chunk completed
  (:func:`.metrics.reservoir_progress`) into an **EWMA z-score watchdog**
  (queue depth, busy fraction, drop rate, deferred backlog and its rate,
  fogs down, crash losses, the twin's queue depth);
* re-renders the OpenMetrics exposition (:mod:`.openmetrics`) behind a
  stdlib ``http.server`` **pull endpoint** (``GET /metrics``; ``GET
  /healthz`` returns the watchdog and SLO state as JSON), with a route
  hook for the twin's ``POST /ingest`` and ``POST /whatif`` and the
  ``POST /reconfigure`` door;
* appends the rows and a per-chunk **state hash** to a bounded
  :class:`FlightRecorder` ring, and on NaN, SLO breach, watchdog anomaly
  or crash dumps a post-mortem bundle (manifest JSON and the Perfetto
  trace of the state) that ``tools/postmortem.py`` reads and diffs.

Everything here is host Python over the device-resident accumulators; the
tick is untouched.  The chunk-boundary state is read to the host once a
chunk (:func:`..runtime.recorder.to_host`) for the hash and the NaN scan.

Departures from JAX, by design: the bundle has no ``compile_cache``
section (XLA's program cache, with no PyTorch counterpart), and
:func:`serve_tp_run` takes ``n_shards`` where JAX takes a ``Mesh``: the
port's TP tick runs its shards on one card
(:func:`..parallel.taskshard.run_tp_chunked`).

Two host threads drive the card in a live session: the serving loop and
the server's handler threads (``POST /whatif`` forks the carry and runs
it).  That is safe without a lock: no chunk writes into a state in place,
so a carry the door holds stays as it was handed over; the kernel
wrappers count their launches under a lock, launch on the calling
thread's current stream and build the library under a lock;
``f32math.kept_tensor`` inserts its per-device copies atomically; each TP
run makes its own ``ShardGroup`` with its own turn lock.
"""
from __future__ import annotations

import collections
import http.server
import json
import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..spec import WorldSpec

#: Signals the watchdog tracks, derived per chunk from reservoir rows.
#: ``defer_rate`` is the per-row DELTA of the cumulative
#: ``defer_total`` reservoir column — the per-tick ``n_deferred`` gauge
#: (the ``defer`` signal) sits constant under sustained exchange-window
#: overflow because the tick-keyed rotation spreads deferral evenly, so
#: only the rate signal can page before a shard starves.
#: ``fog_down`` / ``crash_loss_rate`` ride the chaos
#: reservoir columns: ``fog_down`` is the mean fraction of fogs down
#: over the chunk (a flapping fog oscillates it — the z-score fires),
#: and ``crash_loss_rate`` is the per-tick delta of the cumulative
#: crash-loss column with an ABSOLUTE floor next to its z-score,
#: exactly the ``defer_rate`` discipline: steady crash losses from
#: tick 0 have zero variance and must still page.
#: ``ingest_depth`` is the twin ingestion queue's occupancy
#: FRACTION at the chunk boundary (depth / capacity, host-side — it
#: rides serve_run's ``extra`` signal door, not the reservoir): a
#: backing-up arrival queue is the twin's earliest overload page,
#: firing before a single request is dropped.
WATCH_SIGNALS = ("q_depth", "busy_frac", "drop_rate", "defer",
                 "defer_rate", "fog_down", "crash_loss_rate",
                 "ingest_depth")


class Ewma:
    """One exponentially-weighted mean/variance tracker.

    ``update`` returns the z-score of the NEW sample against the
    statistics accumulated *before* it (so a step change scores against
    the pre-step regime), then folds the sample in.  The first
    ``warmup`` samples return 0.0 — an empty-history z-score is noise.

    The score's denominator is floored at ``rel_floor * |mean| +
    abs_floor``: a signal that sat EXACTLY constant through warmup
    (zero drops on a healthy run, busy_frac pinned at 1.0 on a
    saturated fleet) has zero variance, and without the floor its first
    infinitesimal wiggle would score z ~ 1e5 and page — only a change
    that is material relative to the signal's own level should fire.
    """

    def __init__(
        self,
        alpha: float = 0.3,
        warmup: int = 3,
        rel_floor: float = 0.05,
        abs_floor: float = 0.01,
    ):
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.rel_floor = float(rel_floor)
        self.abs_floor = float(abs_floor)
        self.n = 0
        self.mean = 0.0
        self.var = 0.0

    def update(self, x: float) -> float:
        x = float(x)
        if self.n < self.warmup:
            z = 0.0
        else:
            floor = self.rel_floor * abs(self.mean) + self.abs_floor
            z = (x - self.mean) / math.sqrt(self.var + floor * floor)
        if self.n == 0:
            self.mean = x
        else:
            a = self.alpha
            d = x - self.mean
            self.mean += a * d
            self.var = (1.0 - a) * (self.var + a * d * d)
        self.n += 1
        return z


class Watchdog:
    """EWMA z-score anomaly detection over the per-chunk health signals.

    Feed it the reservoir rows each chunk delivered
    (:meth:`update_from_rows`); it derives per-chunk means of queue
    depth / busy fraction / deferred backlog, the per-row drop RATE
    from consecutive cumulative ``n_dropped`` samples, and flags any
    signal whose z-score exceeds ``z_threshold``.  Anomalies are
    returned AND kept in ``self.anomalies`` (the /healthz payload and
    the flight-recorder manifest read it).
    """

    def __init__(
        self,
        n_fogs: int,
        z_threshold: float = 4.0,
        alpha: float = 0.3,
        warmup: int = 3,
        defer_rate_floor: float = 1.0,
        crash_loss_floor: float = 1.0,
        row_ticks: float = 1.0,
        anomaly_capacity: int = 256,
    ):
        self.n_fogs = max(int(n_fogs), 1)
        self.z_threshold = float(z_threshold)
        # the defer-rate signal gets an ABSOLUTE trip on top of the
        # z-score: sustained exchange-window overflow from
        # tick 0 is a CONSTANT rate — zero variance, z ~ 0 forever —
        # yet it is exactly the condition that starves a shard.  Any
        # chunk whose mean deferred-PER-TICK rate exceeds the floor
        # pages, warmup or not.  ``row_ticks`` (the reservoir stride:
        # ticks covered per row) normalizes the per-row cumulative
        # delta into that per-tick unit, so the floor means the same
        # thing at any horizon — serve_run passes the spec's stride.
        # The EWMA floors (Ewma rel/abs) still apply to its z-score
        # like every other signal.
        self.defer_rate_floor = float(defer_rate_floor)
        # crash-loss twin of the defer-rate floor: a fog
        # that flaps and eats tasks at a CONSTANT per-tick rate never
        # moves the z-score — any chunk whose mean crash-losses-per-
        # tick exceeds this floor pages regardless of variance.
        self.crash_loss_floor = float(crash_loss_floor)
        self.row_ticks = max(float(row_ticks), 1.0)
        self._trackers = {
            s: Ewma(alpha=alpha, warmup=warmup) for s in WATCH_SIGNALS
        }
        self._last_dropped: Optional[float] = None
        self._last_deferred: Optional[float] = None
        self._last_crash_lost: Optional[float] = None
        # bounded ring (the FlightRecorder discipline): the defer-rate
        # FLOOR fires on EVERY chunk of a sustained-overflow run by
        # design — unbounded growth would leak host memory and bloat
        # late post-mortem manifests.  anomaly_count keeps the true
        # total for /healthz.
        self.anomalies: collections.deque = collections.deque(
            maxlen=int(anomaly_capacity)
        )
        self.anomaly_count = 0
        self.last_signals: Dict[str, float] = {}
        self.last_z: Dict[str, float] = {}

    def signals_from_rows(self, rows: Dict[str, np.ndarray]) -> Dict:
        """Chunk-level signal values from this chunk's reservoir rows
        (empty dict when the chunk completed no reservoir row)."""
        t = np.asarray(rows.get("t", ()))
        if t.size == 0:
            return {}
        sig = {
            "q_depth": float(np.mean(rows["q_len_total"])),
            "busy_frac": float(np.mean(rows["n_busy"])) / self.n_fogs,
            "defer": float(np.mean(rows["n_deferred"])),
        }
        dropped = np.asarray(rows["n_dropped"], dtype=float)
        prev = (
            self._last_dropped if self._last_dropped is not None
            else float(dropped[0])
        )
        sig["drop_rate"] = float(dropped[-1] - prev) / max(dropped.size, 1)
        self._last_dropped = float(dropped[-1])
        # cumulative-deferred delta (the defer RATE, per TICK: the
        # chunk's delta over the ticks its rows cover, so the absolute
        # floor is stride-independent) — rows recorded by a
        # older build have no defer_total column; skip then
        if "defer_total" in rows:
            deferred = np.asarray(rows["defer_total"], dtype=float)
            prev_d = (
                self._last_deferred if self._last_deferred is not None
                else float(deferred[0])
            )
            sig["defer_rate"] = float(deferred[-1] - prev_d) / max(
                deferred.size * self.row_ticks, 1.0
            )
            self._last_deferred = float(deferred[-1])
        # chaos columns — rows recorded by a pre-chaos build
        # have neither; skip then (the postmortem .get-safety contract)
        if "n_fogs_down" in rows:
            sig["fog_down"] = float(
                np.mean(rows["n_fogs_down"])
            ) / self.n_fogs
        if "lost_crash_total" in rows:
            lost = np.asarray(rows["lost_crash_total"], dtype=float)
            prev_l = (
                self._last_crash_lost
                if self._last_crash_lost is not None
                else float(lost[0])
            )
            sig["crash_loss_rate"] = float(lost[-1] - prev_l) / max(
                lost.size * self.row_ticks, 1.0
            )
            self._last_crash_lost = float(lost[-1])
        return sig

    def update(self, signals: Dict[str, float], ticks_done: int) -> List[Dict]:
        """Score one chunk's signals; returns (and records) anomalies."""
        fired = []
        for name, value in signals.items():
            tracker = self._trackers.get(name)
            if tracker is None:
                continue
            z = tracker.update(value)
            self.last_z[name] = z
            tripped = abs(z) > self.z_threshold
            kind = "z"
            if (
                name == "defer_rate"
                and value > self.defer_rate_floor
            ):
                # absolute floor trip: a sustained overflow is constant
                # (z ~ 0) but still pages — see __init__
                tripped, kind = True, "floor"
            if (
                name == "crash_loss_rate"
                and value > self.crash_loss_floor
            ):
                # chaos twin: steady crash losses are z ~ 0
                tripped, kind = True, "floor"
            if tripped:
                fired.append(
                    {
                        "signal": name,
                        "value": value,
                        "z": z,
                        "kind": kind,
                        "mean": tracker.mean,
                        "ticks_done": int(ticks_done),
                    }
                )
        self.last_signals = dict(signals)
        self.anomalies.extend(fired)
        self.anomaly_count += len(fired)
        return fired

    def update_from_rows(
        self, rows: Dict[str, np.ndarray], ticks_done: int,
        extra: Optional[Dict[str, float]] = None,
    ) -> List[Dict]:
        """``extra`` merges host-side signals (the twin's
        ``ingest_depth``) into the chunk's row-derived ones — they are
        scored even when the chunk completed no reservoir row."""
        sig = self.signals_from_rows(rows)
        if extra:
            sig.update(extra)
        if not sig:
            return []
        return self.update(sig, ticks_done)


class FlightRecorder:
    """Bounded ring of recent reservoir rows + per-chunk state hashes.

    ``capacity`` bounds host memory no matter the horizon; on
    :meth:`dump` the ring, the watchdog state and (when a final state is
    at hand) the Perfetto trace of the last window land in ``outdir`` as a post-mortem bundle —
    ``postmortem-<reason>-<ticks>.json`` plus a ``.trace.json`` twin —
    that :mod:`tools.postmortem` inspects and diffs.
    """

    def __init__(self, capacity: int = 64):
        self.capacity = int(capacity)
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity
        )
        self.dumps: List[str] = []

    def note_chunk(
        self,
        ticks_done: int,
        rows: Optional[Dict[str, np.ndarray]] = None,
        state_hash: Optional[str] = None,
        extra: Optional[Dict] = None,
    ) -> None:
        entry = {
            "ticks_done": int(ticks_done),
            "state_hash": state_hash,
            "rows": {
                k: [float(x) for x in np.asarray(v)]
                for k, v in (rows or {}).items()
            },
        }
        if extra:
            entry.update(extra)
        self._ring.append(entry)

    @property
    def ring(self) -> List[Dict]:
        return list(self._ring)

    def dump(
        self,
        outdir: str,
        reason: str,
        spec: Optional[WorldSpec] = None,
        final=None,
        watchdog: Optional[Watchdog] = None,
        detail: Optional[Dict] = None,
        max_tasks: int = 5000,
    ) -> str:
        """Write the post-mortem bundle; returns the manifest path.  JAX's
        manifest but for its ``compile_cache`` section."""
        from ..runtime.recorder import _json_sanitize, spec_to_dict, to_host

        os.makedirs(outdir, exist_ok=True)
        ticks = self._ring[-1]["ticks_done"] if self._ring else 0
        stem = f"postmortem-{reason}-{ticks:09d}"
        manifest_path = os.path.join(outdir, f"{stem}.json")
        manifest = {
            "reason": reason,
            "recorded_at": time.strftime("%Y-%m-%d %H:%M:%S"),
            "ticks_done": ticks,
            "detail": detail or {},
            "ring": self.ring,
        }
        # the twin's ingest roll-up: the newest chunk entry
        # carrying queue stats becomes the bundle's ingest_summary —
        # pre-twin bundles simply lack the key (the .get-safe contract)
        ing = next(
            (
                e["ingest"] for e in reversed(self._ring)
                if isinstance(e, dict) and e.get("ingest")
            ),
            None,
        )
        if ing is not None:
            manifest["ingest_summary"] = dict(ing)
        if watchdog is not None:
            manifest["watchdog"] = {
                "anomalies": list(watchdog.anomalies),
                "anomaly_count": watchdog.anomaly_count,
                "last_signals": watchdog.last_signals,
                "last_z": watchdog.last_z,
                "z_threshold": watchdog.z_threshold,
            }
        if spec is not None:
            manifest["spec"] = spec_to_dict(spec)
        if final is not None:
            final = to_host(final)
        if spec is not None and final is not None and spec.chaos:
            from ..chaos.faults import chaos_summary

            manifest["chaos"] = chaos_summary(spec, final)
        if (
            spec is not None
            and final is not None
            and getattr(spec, "journey_active", False)
        ):
            # journey rings ride the bundle RAW: the decode
            # needs no spec, so tools/postmortem.py can print "what was
            # task 4711 doing when the watchdog paged" from the
            # manifest alone; pre-journey bundles simply lack the key
            # (the .get-safe contract)
            from .journeys import snapshot_rings

            rings = snapshot_rings(final, spec)
            if rings is not None:
                manifest["journeys"] = {
                    "sampled": len(rings["task"]),
                    "dropped_total": rings["dropped"],
                    "rings": rings,
                }
        if spec is not None and final is not None:
            from .health import hist_summary

            hist = hist_summary(spec, final)
            if hist is not None:
                manifest["hist"] = {
                    "count": hist["count"],
                    "quantiles_ms": hist["quantiles_ms"],
                }
            # the Perfetto trace of the last window: the task spans
            # + counter tracks a post-mortem zooms into first
            from .timeline import export_trace

            trace_path = os.path.join(outdir, f"{stem}.trace.json")
            manifest["trace"] = export_trace(
                spec, final, trace_path, max_tasks=max_tasks
            )
        with open(manifest_path, "w") as f:
            json.dump(
                _json_sanitize(manifest), f, indent=1, allow_nan=False
            )
        self.dumps.append(manifest_path)
        return manifest_path

    @staticmethod
    def load(path: str) -> Dict:
        with open(path) as f:
            return json.load(f)


class HealthServer:
    """Stdlib pull endpoint: ``GET /metrics`` (OpenMetrics text) and
    ``GET /healthz`` (watchdog/SLO JSON).

    A daemon-threaded ``http.server`` — no dependency beyond the
    stdlib, matching the container constraint.  ``port=0`` binds an
    ephemeral port (read it back from ``.port``); content is swapped
    atomically under a lock by the serving loop.

    ``set_handler`` installs an optional route hook (the
    twin's extension door): called FIRST for every request as
    ``hook(method, path, body)`` and may return ``(status, ctype,
    body)`` to serve the request — ``POST /ingest``, ``GET /whatif``
    and the front door's per-tenant ``/t/<label>/...`` routes live in
    :mod:`..twin` behind this hook, so the base server
    stays twin-agnostic.  Returning ``None`` falls through to the
    built-in GET routes (404 for anything else).
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._lock = threading.Lock()
        self._metrics = "# EOF\n"
        self._health: Dict = {"status": "starting"}
        self._hook: Optional[Callable] = None
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _respond(self, status, ctype, body):
                if isinstance(body, str):
                    body = body.encode()
                self.send_response(int(status))
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _hooked(self, method: str, body: bytes) -> bool:
                with outer._lock:
                    hook = outer._hook
                if hook is None:
                    return False
                out = hook(method, self.path, body)
                if out is None:
                    return False
                self._respond(*out)
                return True

            def do_GET(self):  # noqa: N802 (stdlib API name)
                if self._hooked("GET", b""):
                    return
                if self.path.startswith("/metrics"):
                    with outer._lock:
                        body = outer._metrics.encode()
                    ctype = "application/openmetrics-text; version=1.0.0"
                elif self.path.startswith("/healthz"):
                    with outer._lock:
                        payload = dict(outer._health)
                    body = (json.dumps(payload) + "\n").encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self._respond(200, ctype, body)

            def do_POST(self):  # noqa: N802 (stdlib API name)
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                if self._hooked("POST", body):
                    return
                self.send_error(404)

            def log_message(self, *a):  # silence per-request stderr
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            (host, port), Handler
        )
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def set_metrics(self, text: str) -> None:
        with self._lock:
            self._metrics = text

    def set_health(self, payload: Dict) -> None:
        with self._lock:
            self._health = payload

    def set_handler(self, hook: Optional[Callable]) -> None:
        """Install (or clear) the route hook — see the class docstring."""
        with self._lock:
            self._hook = hook

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


class ReconfigDoor:
    """The live session's retune endpoint: queued promoted-knob changes.

    ``POST /reconfigure`` with ``{"knobs": {"<field>": value, ...}}``
    or the CLI's own ``--set`` shape, ``{"set":
    ["spec.<field>=<value>", ...]}``.  Knobs are validated EAGERLY
    against the door's live-spec shadow
    (:func:`..dynspec.apply_knobs`: unknown fields,
    shape-defining fields and trace-gate flips answer 400 with the
    one-line error — the serving loop never sees them) and queued; the
    chunk runner pops the queue at the next chunk boundary via
    :meth:`as_reconfigure`.  An accepted retune changes only the knobs'
    device operand, and every accepted field answers ``"recompile":
    "no"`` (JAX's answer: the CLI ``--set`` classification, served over
    HTTP).

    One door serves both substrates unchanged:
    ``serve_run`` → ``run_chunked`` and ``serve_tp_run`` →
    ``run_tp_chunked`` take the same ``reconfigure`` hook.  The POST
    thread only ever touches the spec shadow and the queue under the
    door lock; the chunk loop applies knobs between chunks, so a
    mid-chunk POST races nothing and lands one boundary later.
    """

    def __init__(self, spec: WorldSpec):
        self._lock = threading.Lock()
        self._spec = spec
        self._pending: Dict = {}
        self.accepted = 0
        self.rejected = 0
        self.applied_batches = 0

    # ---- HTTP (the HealthServer route hook) --------------------------
    def handle_http(self, method: str, path: str, body: bytes):
        """``POST /reconfigure`` handler; None for any other route."""
        if not path.split("?", 1)[0].rstrip("/").endswith("/reconfigure"):
            return None
        if method != "POST":
            with self._lock:
                pending = sorted(self._pending)
            return (
                200, "application/json",
                json.dumps({
                    "usage": 'POST {"knobs": {"<promoted field>": '
                             'value, ...}} or {"set": '
                             '["spec.<field>=<value>", ...]}',
                    "pending": pending,
                }) + "\n",
            )
        status, payload = self._post(body)
        return (status, "application/json", json.dumps(payload) + "\n")

    def _post(self, body: bytes):
        from ..dynspec import apply_knobs, classify_field

        try:
            doc = json.loads(body.decode() or "null")
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            return 400, {"error": f"invalid JSON ({e})"}
        if not isinstance(doc, dict):
            return 400, {
                "error": "POST a JSON object with 'knobs' and/or 'set'"
            }
        knobs = dict(doc.get("knobs") or {})
        for item in doc.get("set") or []:
            if not isinstance(item, str) or "=" not in item:
                return 400, {
                    "error": "'set' entries are 'spec.<field>=<value>' "
                             f"strings, got {item!r}"
                }
            key, val = item.split("=", 1)
            key = key.strip()
            if key.startswith("spec."):
                key = key[5:]
            try:
                knobs[key] = json.loads(val.strip())
            except json.JSONDecodeError:
                return 400, {
                    "error": f"could not parse the value for {key!r}: "
                             f"{val.strip()!r}"
                }
        if not knobs:
            return 400, {
                "error": "no knobs given: pass 'knobs' (field->value "
                         "object) and/or 'set' (a list of "
                         "'spec.<field>=<value>' strings)"
            }
        bad = [
            k for k, v in knobs.items()
            if isinstance(v, bool) or not isinstance(v, (int, float))
        ]
        if bad:
            return 400, {"error": f"knob {bad[0]!r} needs a number"}
        with self._lock:
            try:
                # the shadow accumulates accepted retunes, so gate
                # checks always run against the values the loop will
                # actually be carrying at the next boundary
                self._spec = apply_knobs(self._spec, knobs)
            except ValueError as e:
                self.rejected += 1
                return 400, {"error": str(e)}
            self._pending.update(knobs)
            pending = sorted(self._pending)
        self.accepted += 1
        return 200, {
            "accepted": {k: knobs[k] for k in sorted(knobs)},
            "recompile": "no",
            "why": {k: classify_field(k)[1] for k in sorted(knobs)},
            "pending": pending,
        }

    def as_reconfigure(self) -> Callable[[int], Optional[Dict]]:
        """The chunk-boundary hook: pops the queued knobs (applied once)."""

        def reconfigure(ticks_done: int) -> Optional[Dict]:
            with self._lock:
                if not self._pending:
                    return None
                knobs, self._pending = self._pending, {}
            self.applied_batches += 1
            return knobs

        return reconfigure


def serve_run(
    spec: WorldSpec,
    state,
    net,
    bounds=None,
    chunk_ticks: int = 1000,
    port: Optional[int] = 0,
    slo_ms: Optional[float] = None,
    z_threshold: float = 4.0,
    dump_dir: Optional[str] = None,
    recorder: Optional[FlightRecorder] = None,
    watchdog: Optional[Watchdog] = None,
    server: Optional[HealthServer] = None,
    on_chunk: Optional[Callable[[Dict], None]] = None,
    hash_every_chunk: bool = True,
    run_fn: Optional[Callable] = None,
    shard_hash_fn: Optional[Callable] = None,
    reconfigure: Optional[Callable[[int], Optional[Dict]]] = None,
    inject: Optional[Callable] = None,
    ingest=None,
):
    """The production serving loop over ``run_chunked``.

    ``run_fn`` swaps the chunked runner: it must accept
    ``(spec, state, net, bounds, chunk_ticks=..., callback=...)`` and
    return the final state — :func:`serve_tp_run` passes the TP
    sharded chunk runner here, so the watchdog/exposition loop is ONE
    code path whatever the execution substrate.  ``shard_hash_fn``
    (TP): called with each chunk's host-fetched state, returns the
    per-shard hash list the flight recorder stores next to the global
    state hash (``tools/postmortem.py --diff`` bisects WHICH shard
    diverged first); needs ``hash_every_chunk``.

    Returns ``(final_state, status)`` where ``status`` carries the
    server (still live, so late scrapes see the final exposition —
    callers own ``status['server'].close()``), the watchdog, the flight
    recorder and the run roll-up.  ``port=None`` disables the endpoint
    (watchdog + recorder only).  ``slo_ms`` arms the SLO-breach trigger
    (needs ``spec.telemetry_hist``); breaches, watchdog anomalies, NaNs
    and crashes each dump at most one post-mortem bundle per reason
    into ``dump_dir``.

    ``hash_every_chunk=False`` skips the per-chunk full-state fetch —
    both the state hash AND the NaN scan ride one host read — for
    latency-sensitive serving; the flight recorder ring then carries
    rows only and NaN dumps are disabled (the histogram/SLO/watchdog
    triggers still fire).

    ``reconfigure`` (the live retune door): forwarded to the chunk
    runner — called at every chunk boundary with the tick count, may
    return a dict of PROMOTED WorldSpec knobs (chaos amplitudes, loss
    probabilities, energy budgets...) to apply to the remaining horizon
    as new values of the knobs' device operand, so an operator can steer
    a live twin between scrapes.
    The default ``run_chunked`` runner and any ``run_fn`` with an
    explicit ``reconfigure`` parameter support it (``serve_tp_run``'s
    TP chunk runner does, with the promoted knobs); a
    ``run_fn`` without the parameter still raises up front.

    ``inject`` / ``ingest`` (the digital-twin input door):
    ``inject`` is forwarded to ``run_chunked``'s chunk-boundary hook
    (external arrivals land between chunks); ``ingest`` is the
    IngestQueue-like stats provider — anything with a ``stats()``
    returning the twin/ingest dict — whose depth/accepted/dropped/
    latency counters ride the exposition (``fns_twin_ingest_*``), the
    /healthz payload and the watchdog's ``ingest_depth`` signal.
    :func:`..twin.ingest.serve_ingest_run` wires both
    plus the HTTP POST endpoint.  Like ``reconfigure``, both need the
    default ``run_chunked`` runner.
    """
    if reconfigure is not None and run_fn is not None:
        # a runner opts in by NAMING the parameter (VAR_KEYWORD does not
        # count: swallowing the hook silently would serve stale knobs)
        import inspect

        try:
            _params = inspect.signature(run_fn).parameters
        except (TypeError, ValueError):
            _params = {}
        if "reconfigure" not in _params:
            raise ValueError(
                "reconfigure rides the chunk runner's DynSpec operand; "
                "this run_fn runner does not take it (declare an "
                "explicit reconfigure= parameter, like the TP chunk "
                "loop's)"
            )
    if inject is not None and run_fn is not None:
        raise ValueError(
            "inject rides run_chunked's chunk-boundary hook; custom "
            "run_fn runners (the TP chunk loop) do not take it"
        )
    from ..core.engine import run_chunked
    from ..runtime.recorder import to_host
    from ..runtime.signals import summarize
    from .health import find_nonfinite, hist_summary, slo_breach_count
    from .health import state_hash as health_state_hash
    from .metrics import reservoir_progress
    from .openmetrics import render_openmetrics

    if not spec.telemetry:
        raise ValueError(
            "serve_run needs spec.telemetry=True (the health plane "
            "reads the device-resident reservoir)"
        )
    if slo_ms is not None and not spec.telemetry_hist:
        raise ValueError(
            "slo_ms needs spec.telemetry_hist=True (SLO breaches are "
            "derived from the streaming latency histogram)"
        )
    if watchdog is None:
        # the reservoir stride (ticks per row) normalizes the
        # defer-rate signal to per-tick units, whatever the horizon
        stride = max(1, -(-spec.n_ticks // max(spec.telemetry_slots, 1)))
        watchdog = Watchdog(
            spec.n_fogs, z_threshold=z_threshold, row_ticks=stride
        )
    recorder = recorder or FlightRecorder()
    if server is None and port is not None:
        server = HealthServer(port=port)
    dumped_reasons: set = set()
    progress = {"next_row": 0, "chunks": 0, "t0": time.perf_counter()}
    slo_state = {"breaches": 0}

    def _dump(reason: str, s, detail: Optional[Dict] = None) -> None:
        if dump_dir is None or reason in dumped_reasons:
            return
        dumped_reasons.add(reason)
        recorder.dump(
            dump_dir, reason, spec=spec, final=s,
            watchdog=watchdog, detail=detail,
        )

    def _chunk_cb(s, ticks_done: int) -> None:
        rows, progress["next_row"] = reservoir_progress(
            spec, s.telem, ticks_done, progress["next_row"]
        )
        progress["chunks"] += 1
        # one device->host fetch serves both the fingerprint and the
        # NaN scan; hash_every_chunk=False skips the whole full-state
        # transfer for latency-sensitive serving (rows + histogram only)
        if hash_every_chunk:
            host = to_host(s)
            h = health_state_hash(host)
            bad = find_nonfinite(host)
            shard_hashes = (
                shard_hash_fn(host) if shard_hash_fn is not None else None
            )
        else:
            h, bad, shard_hashes = None, {}, None
        extra = {}
        if shard_hashes:
            extra["shard_hashes"] = shard_hashes
        if spec.chaos:
            # chaos counters ride every chunk entry (five scalars):
            # a post-mortem of a churn run sees WHEN the losses grew
            from ..chaos.faults import chaos_counters

            extra["chaos"] = chaos_counters(s)
        if spec.hier_active:
            # federation counters ride every chunk entry (two scalars):
            # a post-mortem sees WHEN migration spiked or hops exhausted
            from ..hier.federation import hier_counters

            extra["hier"] = hier_counters(s)
        ingest_stats = ingest.stats() if ingest is not None else None
        if ingest_stats is not None:
            # the ingest roll-up rides every chunk entry: a post-mortem
            # of a live session sees WHEN the queue backed up
            extra["ingest"] = dict(ingest_stats)
        recorder.note_chunk(
            ticks_done, rows=rows, state_hash=h, extra=extra or None,
        )
        ingest_sig = None
        if ingest_stats is not None:
            ingest_sig = {
                "ingest_depth": ingest_stats["depth"]
                / max(float(ingest_stats.get("capacity", 1)), 1.0)
            }
        fired = watchdog.update_from_rows(
            rows, ticks_done, extra=ingest_sig
        )
        if fired:
            _dump("anomaly", s, detail={"anomalies": fired})
        if bad:
            _dump("nan", s, detail={"nonfinite": bad})
        # ONE hist_summary per chunk feeds the SLO check, /healthz and
        # the exposition alike (the single-quantile-source discipline)
        hist = hist_summary(spec, s)
        breaches = None
        if slo_ms is not None:
            breaches = slo_breach_count(spec, s, slo_ms, summ=hist)
            if breaches and breaches > slo_state["breaches"]:
                _dump(
                    "slo",
                    s,
                    detail={"slo_ms": slo_ms, "breaches": breaches},
                )
            slo_state["breaches"] = breaches or 0
        health = {
            "status": (
                "degraded" if (fired or bad or (breaches or 0) > 0)
                else "ok"
            ),
            "ticks_done": int(ticks_done),
            "chunks": progress["chunks"],
            "wall_s": round(time.perf_counter() - progress["t0"], 3),
            "signals": watchdog.last_signals,
            "z": watchdog.last_z,
            "anomalies": watchdog.anomaly_count,
            "nonfinite": sorted(bad),
            **(
                {"slo_ms": slo_ms, "slo_breaches": breaches}
                if slo_ms is not None
                else {}
            ),
            **(
                {"ingest": ingest_stats}
                if ingest_stats is not None
                else {}
            ),
        }
        if server is not None:
            if hist is not None:
                # an empty histogram yields NaN quantiles; /healthz is
                # strict JSON, so those become null
                health["latency_ms"] = {
                    k: (v if math.isfinite(v) else None)
                    for k, v in hist["quantiles_ms"].items()
                }
            server.set_metrics(
                render_openmetrics(
                    spec, s,
                    hist=hist,
                    ingest=ingest_stats,
                    attrs={
                        "live_chunks": progress["chunks"],
                        "live_ticks": int(ticks_done),
                        **(
                            {"slo_breaches": breaches}
                            if breaches is not None
                            else {}
                        ),
                    },
                )
            )
            server.set_health(health)
        if on_chunk is not None:
            on_chunk(health)

    try:
        final = (run_fn or run_chunked)(
            spec, state, net, bounds,
            chunk_ticks=chunk_ticks, callback=_chunk_cb,
            **({} if reconfigure is None else {"reconfigure": reconfigure}),
            **({} if inject is None else {"inject": inject}),
        )
    except Exception as e:
        # crash flight-record: the ring up to the last good chunk plus
        # the failure, then re-raise — a serving loop must not swallow
        if dump_dir is not None:
            recorder.dump(
                dump_dir, "crash", spec=spec, watchdog=watchdog,
                detail={"error": f"{type(e).__name__}: {e}"},
            )
        if server is not None:
            server.set_health(
                {"status": "crashed", "error": f"{type(e).__name__}: {e}"}
            )
        raise
    status = {
        "server": server,
        "port": server.port if server is not None else None,
        "watchdog": watchdog,
        "recorder": recorder,
        "chunks": progress["chunks"],
        "anomalies": watchdog.anomaly_count,
        "slo_breaches": slo_state["breaches"],
        "dumps": list(recorder.dumps),
        "scalars": summarize(final),
    }
    return final, status


def serve_tp_run(
    spec: WorldSpec,
    state,
    net,
    bounds=None,
    n_shards: Optional[int] = None,
    exchange_window: Optional[int] = None,
    **kw,
):
    """The sharded health plane: :func:`serve_run` over the task-sharded
    tick (``telemetry/live.serve_tp_run``), ``n_shards`` shards on one
    card where JAX takes a ``Mesh``.

    One serving loop, two substrates: the chunk runner becomes
    :func:`..parallel.taskshard.run_tp_chunked`, the flight recorder also
    stores per-shard state hashes (:func:`.health.shard_state_hashes`) so
    ``tools/postmortem.py --diff`` can bisect which shard diverged first,
    and the exposition gains the ``fns_tp_exchange_*{shard}`` families.
    The spec is padded and stamped before the loop, so every render sees
    the world it serves; returns ``(spec, final_state, status)``.

    Accepts every :func:`serve_run` keyword.  The defer-rate watchdog
    matters most here: the exchange window defers overflow instead of
    dropping it, so only the defer-rate floor pages for a starving shard.
    """
    import functools

    from ..parallel.taskshard import (
        pad_users_to_multiple,
        run_tp_chunked,
        stamp_tp_telemetry,
    )
    from .health import shard_state_hashes

    if n_shards is None:
        raise ValueError("serve_tp_run needs n_shards (the shards on the card)")
    if not spec.telemetry:
        raise ValueError(
            "serve_tp_run needs spec.telemetry=True (the health plane "
            "reads the device-resident reservoir)"
        )
    n_shards = int(n_shards)
    # pad and stamp once, before the loop (the chunk runner's own setup
    # derives the same spec and state again)
    if spec.n_users % n_shards:
        spec, state, net = pad_users_to_multiple(spec, state, net, n_shards)
    spec, state = stamp_tp_telemetry(spec, state, n_shards)

    # the chunk loop applies reconfigure knobs to the live spec between
    # chunks; keep the retuned spec so the caller's describes the state
    live = {"spec": spec}

    def _runner(sp, st, nt, bd, chunk_ticks, callback, reconfigure=None):
        live["spec"], final = run_tp_chunked(
            sp, st, nt, bd, n_shards=n_shards, chunk_ticks=chunk_ticks,
            callback=callback, exchange_window=exchange_window,
            reconfigure=reconfigure,
        )
        return final

    final, status = serve_run(
        spec, state, net, bounds,
        run_fn=_runner,
        shard_hash_fn=functools.partial(
            shard_state_hashes, spec, n_shards=n_shards
        ),
        **kw,
    )
    status["tp_shards"] = n_shards
    return live["spec"], final, status
