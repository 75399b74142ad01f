"""Multi-tenant serve front door: N live sessions behind one endpoint.

Counterpart of ``fognetsimpp_tpu/twin/front.py``.  A :class:`FrontDoor`
multiplexes up to ``capacity`` independent serve sessions.  Each admitted
tenant's population is padded to its shape bucket
(:func:`..dynspec.bucket_spec`) and its spec split into its shape key and
promoted knobs (:func:`..dynspec.split_spec`), so tenants with nearby
populations and different knob values run the same shapes; one
:meth:`FrontDoor.step` advances every tenant one chunk, round robin.

Per tenant, the single-session health plane in miniature: its own
:class:`~..telemetry.live.FlightRecorder`, :class:`~..telemetry.live.Watchdog`,
optional ingest queue and what-if door.  The shared endpoint routes by
label (``/t/<label>/metrics``, ``/healthz``, ``/ingest``, ``/whatif``);
the root ``/metrics`` serves the tenant-labelled aggregate
(:func:`..telemetry.openmetrics.render_twin_openmetrics`).  Admission past
``capacity`` raises the one-line ``[TWIN-CAP]`` clause.

JAX's chunk is a jitted program shared by the tenants of a bucket
(``_tenant_chunk``); here it is a plain call of the engine's runner with
the tenant's knobs as a device operand, the static link cache built as a
jitted program builds it.  JAX's ``dynspec.registry_note`` (its program
registry) has no PyTorch counterpart and is not called.
"""
from __future__ import annotations

import collections
import json
import math
import threading
from typing import Dict, List, Optional, Tuple

from ..core.engine import _run
from .gates import admission_error
from .ingest import IngestQueue
from .whatif import WhatIfDoor


def _tenant_chunk(run_spec, n_ticks, state, net, bounds, dyn):
    """One tenant chunk: ``n_ticks`` of the shape key ``run_spec`` with
    the tenant's knobs ``dyn`` (a device operand); the tenant's carry is
    not written into, so the door may hold it between turns."""
    return _run(run_spec, state, net, bounds, n_ticks, dyn, fused_cache=True)[0]


class Tenant:
    """One admitted serve session: carry + per-tenant health plane."""

    def __init__(self, label, spec, run_spec, dyn, state, net, bounds,
                 queue, door, watchdog, recorder):
        self.label = label
        self.spec = spec
        self.run_spec = run_spec
        self.dyn = dyn
        self.state = state
        self.net = net
        self.bounds = bounds
        self.queue: Optional[IngestQueue] = queue
        self.door: Optional[WhatIfDoor] = door
        self.watchdog = watchdog
        self.recorder = recorder
        self.ticks_done = 0
        self.chunks = 0
        self.next_row = 0
        self.metrics_text = "# EOF\n"
        self.health: Dict = {"status": "admitted", "ticks_done": 0}


class FrontDoor:
    """Capacity-bounded multiplexer of live serve sessions.

    ``capacity`` bounds admission (``[TWIN-CAP]`` past it);
    ``chunk_ticks`` is the round-robin quantum; ``bucket_floor`` is
    forwarded to :func:`~..dynspec.bucket_spec` (lower it
    in tests so small nearby populations still share a bucket);
    ``port`` opens the shared HTTP endpoint (None = API-only).
    """

    def __init__(
        self,
        capacity: int = 4,
        chunk_ticks: int = 256,
        bucket_floor: Optional[int] = None,
        port: Optional[int] = None,
        hash_every_chunk: bool = True,
        whatif_ticks: int = 256,
    ):
        if capacity < 1:
            raise ValueError(
                f"front door capacity must be >= 1 tenant, got {capacity}"
            )
        from ..dynspec import BUCKET_FLOOR

        self.capacity = int(capacity)
        self.chunk_ticks = int(chunk_ticks)
        self.bucket_floor = (
            BUCKET_FLOOR if bucket_floor is None else int(bucket_floor)
        )
        self.hash_every_chunk = bool(hash_every_chunk)
        self.whatif_ticks = int(whatif_ticks)
        self._lock = threading.Lock()
        self._tenants: "collections.OrderedDict[str, Tenant]" = (
            collections.OrderedDict()
        )
        self.server = None
        if port is not None:
            from ..telemetry.live import HealthServer

            self.server = HealthServer(port=port)
            self.server.set_handler(self._route)

    # ---- admission ---------------------------------------------------
    def admit(
        self, label: str, spec, state, net, bounds,
        ingest_capacity: int = 1024,
    ) -> Tenant:
        """Admit one serve session.

        Buckets the population, splits the spec into (shape key, knobs
        on the device) and builds the tenant's own
        recorder/watchdog/queue/what-if door.  Raises the one-line
        ``[TWIN-CAP]`` error at capacity and a plain ``ValueError`` for
        a duplicate label or a telemetry-less spec (the per-tenant
        health plane reads the device-resident reservoir, the
        ``serve_run`` precondition).
        """
        from ..dynspec import bucket_spec, dyn_to_device, split_spec
        from ..telemetry.live import FlightRecorder, Watchdog

        if not spec.telemetry:
            raise ValueError(
                "front-door tenants need spec.telemetry=True (each "
                "tenant's watchdog reads its device-resident reservoir)"
            )
        with self._lock:
            if label in self._tenants:
                raise ValueError(
                    f"tenant label {label!r} is already admitted: "
                    "labels route /t/<label>/* and must be unique"
                )
            if len(self._tenants) >= self.capacity:
                raise ValueError(admission_error(label, self.capacity))
        spec, state, net = bucket_spec(
            spec, state, net, floor=self.bucket_floor
        )
        run_spec, dyn = split_spec(spec)
        dyn = dyn_to_device(dyn, state.t.device)
        queue = (
            IngestQueue(capacity=ingest_capacity) if spec.ingest else None
        )
        door = WhatIfDoor(
            spec, net, bounds, default_ticks=self.whatif_ticks
        )
        door.update(state, 0)
        stride = max(1, -(-spec.n_ticks // max(spec.telemetry_slots, 1)))
        tenant = Tenant(
            label, spec, run_spec, dyn, state, net, bounds,
            queue, door,
            Watchdog(spec.n_fogs, row_ticks=stride),
            FlightRecorder(),
        )
        with self._lock:
            if len(self._tenants) >= self.capacity:
                raise ValueError(admission_error(label, self.capacity))
            self._tenants[label] = tenant
        return tenant

    def evict(self, label: str) -> Tenant:
        """Release a slot; the tenant object (carry included) returns
        to the caller for archival or re-admission elsewhere."""
        with self._lock:
            if label not in self._tenants:
                raise ValueError(f"no tenant {label!r} admitted")
            return self._tenants.pop(label)

    @property
    def tenants(self) -> List[str]:
        with self._lock:
            return list(self._tenants)

    # ---- the round-robin chunk scheduler -----------------------------
    def step(self) -> Dict[str, int]:
        """One round-robin sweep: every tenant advances one chunk (in
        admission order).  Returns ``{label: ticks_done}``."""
        with self._lock:
            order = list(self._tenants.values())
        out = {}
        for t in order:
            self._advance(t)
            out[t.label] = t.ticks_done
        if self.server is not None:
            self.server.set_metrics(self.render_aggregate())
            self.server.set_health({
                "status": "ok",
                "tenants": {
                    t.label: t.health.get("status", "ok") for t in order
                },
            })
        return out

    def serve(self, n_rounds: int) -> Dict[str, int]:
        """``n_rounds`` round-robin sweeps; returns final tick counts."""
        out: Dict[str, int] = {}
        for _ in range(int(n_rounds)):
            out = self.step()
        return out

    def _advance(self, t: Tenant) -> None:
        from ..runtime.recorder import to_host
        from ..telemetry.health import hist_summary, state_hash
        from ..telemetry.metrics import reservoir_progress
        from ..telemetry.openmetrics import render_openmetrics

        t.state = _tenant_chunk(
            t.run_spec, self.chunk_ticks, t.state, t.net, t.bounds, t.dyn
        )
        t.ticks_done += self.chunk_ticks
        t.chunks += 1
        # drain AFTER the chunk — injections land at the interior
        # boundary exactly as run_chunked's inject hook does (never
        # before tick 0, where users are still mid-handshake)
        if t.queue is not None:
            from ..core.engine import inject_arrivals

            users, mips, oldest = t.queue.drain(t.spec.ingest_batch)
            if users:
                import time as _time

                t.state, n_inj, n_rej = inject_arrivals(
                    t.spec, t.state, t.net, users, mips
                )
                t.queue.note_injected(
                    n_inj, n_rej,
                    (_time.monotonic() - oldest) if oldest else 0.0,
                )
                t.queue.log.append({
                    "ticks_done": t.ticks_done,
                    "user": list(users),
                    "mips": list(mips),
                })
        rows, t.next_row = reservoir_progress(
            t.spec, t.state.telem, t.ticks_done, t.next_row
        )
        h = (
            state_hash(to_host(t.state))
            if self.hash_every_chunk else None
        )
        stats = t.queue.stats() if t.queue is not None else None
        t.recorder.note_chunk(
            t.ticks_done, rows=rows, state_hash=h,
            extra={"ingest": dict(stats)} if stats is not None else None,
        )
        ingest_sig = None
        if stats is not None:
            ingest_sig = {
                "ingest_depth": stats["depth"]
                / max(float(stats["capacity"]), 1.0)
            }
        fired = t.watchdog.update_from_rows(
            rows, t.ticks_done, extra=ingest_sig
        )
        if t.door is not None:
            t.door.update(t.state, t.ticks_done)
        hist = hist_summary(t.spec, t.state)
        t.metrics_text = render_openmetrics(
            t.spec, t.state, hist=hist,
            ingest=stats,
            attrs={"live_chunks": t.chunks, "live_ticks": t.ticks_done},
        )
        t.health = {
            "status": "degraded" if fired else "ok",
            "tenant": t.label,
            "ticks_done": t.ticks_done,
            "chunks": t.chunks,
            "signals": t.watchdog.last_signals,
            "anomalies": t.watchdog.anomaly_count,
            **({"ingest": stats} if stats is not None else {}),
        }
        if hist is not None:
            t.health["latency_ms"] = {
                k: (v if math.isfinite(v) else None)
                for k, v in hist["quantiles_ms"].items()
            }

    # ---- exposition --------------------------------------------------
    def tenant_rows(self) -> List[Dict]:
        """One dict per tenant (admission order) for
        :func:`~..telemetry.openmetrics.
        render_twin_openmetrics` — the ``tenant="0..N-1"`` label axis
        ``tools/check_openmetrics.py`` cross-checks against
        ``fns_twin_tenants``."""
        with self._lock:
            order = list(self._tenants.values())
        rows = []
        for t in order:
            m = t.state.metrics
            rows.append({
                "label": t.label,
                "ticks": t.ticks_done,
                "chunks": t.chunks,
                "n_users": t.spec.n_users,
                "n_published": int(m.n_published),
                "n_completed": int(m.n_completed),
                "ingest_depth": (
                    t.queue.depth if t.queue is not None else 0
                ),
            })
        return rows

    def render_aggregate(self) -> str:
        from ..telemetry.openmetrics import render_twin_openmetrics

        return render_twin_openmetrics(self.tenant_rows())

    # ---- HTTP routing (the shared endpoint's route hook) -------------
    def _route(
        self, method: str, path: str, body: bytes
    ) -> Optional[Tuple[int, str, str]]:
        """``/t/<label>/(metrics|healthz|ingest|whatif)``; None lets
        the HealthServer's own ``/metrics``+``/healthz`` (the
        aggregate) answer."""
        parts = path.split("?", 1)[0].strip("/").split("/")
        if len(parts) != 3 or parts[0] != "t":
            return None
        label, leaf = parts[1], parts[2]
        with self._lock:
            t = self._tenants.get(label)
        if t is None:
            return (
                404, "text/plain",
                f"error: no tenant {label!r} admitted "
                f"(tenants: {', '.join(self.tenants) or 'none'})\n",
            )
        if leaf == "metrics":
            return (
                200,
                "application/openmetrics-text; version=1.0.0; "
                "charset=utf-8",
                t.metrics_text,
            )
        if leaf == "healthz":
            return (
                200, "application/json", json.dumps(t.health) + "\n"
            )
        if leaf == "ingest":
            if t.queue is None:
                from .gates import ingest_off_error

                return (
                    409, "application/json",
                    json.dumps({"error": ingest_off_error()}) + "\n",
                )
            return t.queue.handle_http(method, path, body)
        if leaf == "whatif" and t.door is not None:
            return t.door.handle_http(method, path, body)
        return (404, "text/plain", f"error: unknown route {path!r}\n")

    def close(self) -> None:
        if self.server is not None:
            self.server.close()
