"""Queue-fed live ingestion: the twin's input door.

Counterpart of ``fognetsimpp_tpu/twin/ingest.py``.  External arrival
requests (HTTP ``POST /ingest`` beside the serving endpoint's ``GET
/metrics``, or :meth:`IngestQueue.feed` in process) land in a bounded,
drop-counted host queue.  At every chunk boundary the serve loop drains
up to ``spec.ingest_batch`` rows into
:func:`..core.engine.inject_arrivals`: the publishes enter the task table
stamped at the boundary's sim time, between chunks, never inside a tick.

Every drained batch is appended to the session's arrival log
(``ticks_done`` and the rows), and :func:`make_replay_inject` turns a
saved log back into the inject hook: the injector is draw-free, so a
session replayed from its log reproduces every chunk state hash bit for
bit, and ``tools/postmortem.py --diff`` works across a replay.  The
queue's depth, accepted, dropped, injected, rejected and latency counters
ride the ``fns_twin_ingest_*`` families, the /healthz ``ingest`` section
and the watchdog's ``ingest_depth`` signal, all from one
:meth:`IngestQueue.stats` dict.
"""
from __future__ import annotations

import collections
import json
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .gates import ingest_off_error, payload_error


class IngestQueue:
    """Bounded, drop-counted, thread-safe arrival queue + arrival log.

    ``feed`` is the in-process producer API (tests, bench, embedding
    services); :meth:`handle_http` is the same producer behind ``POST
    /ingest`` (installed on the HealthServer's route hook by
    :func:`serve_ingest_run`).  A feed past ``capacity`` is DROPPED and
    counted — never blocks, never grows host memory — the bounded-ring
    FlightRecorder discipline.
    """

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError(
                f"ingest queue capacity must be >= 1, got {capacity}"
            )
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._q: collections.deque = collections.deque()
        self.accepted = 0
        self.dropped = 0
        self.injected = 0  # landed into simulation state
        self.rejected = 0  # drained but refused by the injector
        self.latency_s = 0.0  # feed->injection wall latency, last batch
        #: the arrival log: one entry per NON-EMPTY drained batch,
        #: ``{"ticks_done": t, "user": [...], "mips": [...]}`` — the
        #: session's replayable input record
        self.log: List[Dict] = []

    def feed(self, user: int, mips: float) -> bool:
        """Queue one arrival; False (and a drop count) when full."""
        row = (int(user), float(mips), time.monotonic())
        with self._lock:
            if len(self._q) >= self.capacity:
                self.dropped += 1
                return False
            self._q.append(row)
            self.accepted += 1
            return True

    def feed_rows(self, rows: Sequence[Sequence]) -> Tuple[int, int]:
        """Queue many ``(user, mips)`` rows; returns (accepted, dropped)."""
        acc = drop = 0
        for r in rows:
            if self.feed(r[0], r[1]):
                acc += 1
            else:
                drop += 1
        return acc, drop

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def drain(self, max_n: int) -> Tuple[List[int], List[float], float]:
        """Pop up to ``max_n`` rows in feed order.

        Returns ``(users, mips, oldest_feed_monotonic)`` — the third
        element feeds the injected-latency gauge (0.0 when empty).
        Rows beyond ``max_n`` stay queued for the next boundary.
        """
        users: List[int] = []
        mips: List[float] = []
        oldest = 0.0
        with self._lock:
            while self._q and len(users) < max_n:
                u, m, t = self._q.popleft()
                if not users:
                    oldest = t
                users.append(u)
                mips.append(m)
        return users, mips, oldest

    def note_injected(
        self, n_injected: int, n_rejected: int, latency_s: float
    ) -> None:
        with self._lock:
            self.injected += int(n_injected)
            self.rejected += int(n_rejected)
            self.latency_s = float(latency_s)

    def stats(self) -> Dict:
        """The single source every exposition reads (openmetrics
        ``fns_twin_ingest_*``, /healthz ``ingest``, the watchdog's
        ``ingest_depth`` signal, post-mortem chunk extras)."""
        with self._lock:
            return {
                "depth": len(self._q),
                "capacity": self.capacity,
                "accepted": self.accepted,
                "dropped": self.dropped,
                "injected": self.injected,
                "rejected": self.rejected,
                "latency_s": round(self.latency_s, 6),
            }

    # ---- HTTP producer (the HealthServer route hook) -----------------
    def handle_http(
        self, method: str, path: str, body: bytes
    ) -> Optional[Tuple[int, str, str]]:
        """``POST /ingest`` handler; None for any other route."""
        if not path.split("?", 1)[0].rstrip("/").endswith("/ingest"):
            return None
        if method != "POST":
            return (405, "text/plain", "error: POST /ingest only\n")
        status, payload = self.ingest_payload(body)
        return (status, "application/json", json.dumps(payload) + "\n")

    def ingest_payload(self, body: bytes) -> Tuple[int, Dict]:
        """Parse + queue one ingest payload; (HTTP status, response).

        Accepted shapes: ``{"user": u, "mips": m}`` or ``{"rows":
        [[u, m], ...]}``.  Anything else is a 400 with the one-line
        ``[TWIN-PAYLOAD]`` error — malformed traffic must never kill
        the serving loop.
        """
        try:
            doc = json.loads(body.decode() or "null")
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            return 400, {"error": payload_error(f"invalid JSON ({e})")}
        if isinstance(doc, dict) and "rows" in doc:
            rows = doc["rows"]
            if not isinstance(rows, list):
                return 400, {"error": payload_error("rows is not a list")}
        elif isinstance(doc, dict) and "user" in doc:
            rows = [[doc["user"], doc.get("mips", 0)]]
        else:
            return 400, {
                "error": payload_error("neither 'user' nor 'rows' given")
            }
        clean: List[Tuple[int, float]] = []
        for r in rows:
            if (
                not isinstance(r, (list, tuple)) or len(r) != 2
                or isinstance(r[0], bool)
                or not isinstance(r[0], int)
                or isinstance(r[1], bool)
                or not isinstance(r[1], (int, float))
                or r[0] < 0 or not (float(r[1]) >= 0.0)
            ):
                return 400, {
                    "error": payload_error(
                        f"row {r!r} is not [user >= 0, mips >= 0]"
                    )
                }
            clean.append((r[0], float(r[1])))
        acc, drop = self.feed_rows(clean)
        return 200, {"accepted": acc, "dropped": drop, "depth": self.depth}

    # ---- arrival-log persistence (replay-from-inputs) ----------------
    def save_log(self, path: str) -> None:
        """Write the arrival log as JSON (the input flight record)."""
        with self._lock:
            doc = {"capacity": self.capacity, "entries": list(self.log)}
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=1)


def load_log(path: str) -> List[Dict]:
    """Read an arrival log written by :meth:`IngestQueue.save_log`."""
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    return list(doc["entries"])


def make_inject(spec, net, queue: IngestQueue) -> Callable:
    """The chunk-boundary drain hook for ``run_chunked(inject=...)``.

    Drains up to ``spec.ingest_batch`` queued rows, lands them through
    the injector, appends the batch to the session's arrival
    log and updates the queue's injected/rejected/latency counters.
    An empty queue is a no-op (no log entry — the log records inputs,
    not boundaries).
    """
    from ..core.engine import inject_arrivals

    if not spec.ingest:
        raise ValueError(ingest_off_error())

    def inject(state, ticks_done: int):
        users, mips, oldest = queue.drain(spec.ingest_batch)
        if not users:
            return state
        state, n_inj, n_rej = inject_arrivals(spec, state, net, users, mips)
        queue.note_injected(
            n_inj, n_rej,
            (time.monotonic() - oldest) if oldest else 0.0,
        )
        queue.log.append({
            "ticks_done": int(ticks_done),
            "user": list(users),
            "mips": list(mips),
        })
        return state

    return inject


def make_replay_inject(
    spec, net, log: Sequence[Dict],
    queue: Optional[IngestQueue] = None,
) -> Callable:
    """Re-run a recorded arrival log as the inject hook.

    Because injection is draw-free and the log records exactly what
    was INJECTED (post-drain) at which ``ticks_done``, replaying under
    the same spec/chunking reproduces every chunk state hash of the
    original session bit-exactly (``tools/postmortem.py --diff`` leans
    on it).  When ``queue`` is given, replayed injections count into
    its stats and re-record its arrival log, so the replay session's
    exposition/bundle matches the original's (and replay-then-save
    round-trips the log).
    """
    from ..core.engine import inject_arrivals

    if not spec.ingest:
        raise ValueError(ingest_off_error())
    by_tick: Dict[int, List[Dict]] = {}
    for e in log:
        by_tick.setdefault(int(e["ticks_done"]), []).append(e)

    def inject(state, ticks_done: int):
        for e in by_tick.get(int(ticks_done), ()):
            state, n_inj, n_rej = inject_arrivals(
                spec, state, net, e["user"], e["mips"]
            )
            if queue is not None:
                queue.note_injected(n_inj, n_rej, 0.0)
                queue.log.append({
                    "ticks_done": int(ticks_done),
                    "user": list(e["user"]),
                    "mips": list(e["mips"]),
                })
        return state

    return inject


def chain_hooks(*hooks) -> Callable:
    """Compose HealthServer route hooks: first non-None answer wins."""
    live = [h for h in hooks if h is not None]

    def hook(method: str, path: str, body: bytes):
        for h in live:
            out = h(method, path, body)
            if out is not None:
                return out
        return None

    return hook


def serve_ingest_run(
    spec,
    state,
    net,
    bounds=None,
    queue: Optional[IngestQueue] = None,
    capacity: int = 1024,
    port: Optional[int] = 0,
    replay_log: Optional[Sequence[Dict]] = None,
    whatif: bool = True,
    whatif_ticks: int = 256,
    **serve_kwargs,
):
    """`serve_run` with the twin's doors wired (the live-twin entry).

    Creates (or reuses) the :class:`IngestQueue`, installs ``POST
    /ingest`` and ``POST /whatif`` on the health server's route hook,
    threads the chunk-boundary drain into ``run_chunked`` and the
    queue stats into the exposition/watchdog.  ``replay_log`` swaps the
    queue drain for a recorded arrival log — the bit-exact replay mode.

    Returns ``(final_state, status)`` with ``status["ingest"]`` holding
    the queue's final stats and ``status["arrival_log"]`` the session's
    recorded inputs.
    """
    from ..telemetry.live import HealthServer, serve_run
    from .whatif import WhatIfDoor

    if not spec.ingest:
        raise ValueError(ingest_off_error())
    queue = queue or IngestQueue(capacity=capacity)
    if replay_log is not None:
        inject = make_replay_inject(spec, net, replay_log, queue=queue)
    else:
        inject = make_inject(spec, net, queue)
    door = None
    if whatif:
        door = WhatIfDoor(spec, net, bounds, default_ticks=whatif_ticks)
        door.update(state, 0)  # pre-first-chunk carry: askable immediately
        inject = door.wrap_inject(inject)
    server = serve_kwargs.pop("server", None)
    if server is None and port is not None:
        server = HealthServer(port=port)
    if server is not None:
        server.set_handler(chain_hooks(
            queue.handle_http, door.handle_http if door else None
        ))
    final, status = serve_run(
        spec, state, net, bounds,
        port=None, server=server,
        inject=inject, ingest=queue,
        **serve_kwargs,
    )
    status["ingest"] = queue.stats()
    status["arrival_log"] = list(queue.log)
    return final, status
