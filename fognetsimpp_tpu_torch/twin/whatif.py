"""State-forked what-if grids: the twin's question door.

Counterpart of ``fognetsimpp_tpu/twin/whatif.py``.  A live session holds
a chunk-boundary carry; :func:`run_whatif` forks it onto a grid of
promoted-knob retunings (:func:`..parallel.sweep.sweep_dyn_from`: one
replica batch, each row's knobs a row of the device operand) and advances
every cell ``n_ticks``, answering "p95 / energy / defer under these K
retunings, from the current state, H ticks ahead".

Everything reported is a delta against the fork point: the ``Metrics``
counters less the carry's, and latency quantiles from each cell's
histogram less the carry's (``lat_hist`` is cumulative).  The fork
re-keys nothing, so cell i's final state equals a direct run of the
retuned spec from the same carry, leaf for leaf.

:class:`WhatIfDoor` is the serving wrapper: it shadows the newest
chunk-boundary carry (through :meth:`WhatIfDoor.wrap_inject` on the
``run_chunked`` inject hook) and answers ``POST /whatif`` on the health
server's route hook.  An ask runs in the server's handler thread while
the loop runs its chunks: no chunk writes into a state in place, so the
held carry stays as it was handed over.
"""
from __future__ import annotations

import dataclasses
import json
import math
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .gates import whatif_payload_error


def _fork_counters(state) -> Dict[str, int]:
    """The carry's Metrics counters (the delta baseline), by field
    enumeration — a counter added to the state never silently vanishes
    from what-if reports (the ``summarize`` discipline)."""
    return {
        f.name: int(getattr(state.metrics, f.name))
        for f in dataclasses.fields(state.metrics)
    }


def _cell_quantiles(
    spec, carry, final, i: int
) -> Tuple[Optional[Dict[str, float]], int]:
    """Latency quantiles (ms) of cell ``i``'s forked window.

    ``lat_hist`` is CUMULATIVE over the session, so the cell's own
    window is its final histogram minus the carry's — the same
    upper-edge estimator ``hist_summary`` publishes, over the delta
    counts.  ``(None, 0)`` when the histogram plane is off.
    """
    if not (spec.telemetry and spec.telemetry_hist):
        return None, 0
    from ..telemetry.health import QUANTILES, _quantile_from_cum
    from ..telemetry.health import hist_edges_s
    from ..telemetry.metrics import _np

    base = _np(carry.telem.lat_hist, np.int64)  # (F, B)
    counts = _np(final.telem.lat_hist, np.int64)[i] - base
    edges_ms = hist_edges_s(spec).astype(np.float64) * 1e3
    g_cum = np.cumsum(counts.sum(axis=0))
    total = int(g_cum[-1]) if g_cum.size else 0
    q = {
        name: _quantile_from_cum(
            g_cum, edges_ms, frac, total, float(spec.telemetry_hist_max_ms)
        )
        for name, frac in QUANTILES
    }
    return q, total


def run_whatif(
    spec,
    state,
    net,
    bounds,
    knobs: Mapping[str, Sequence],
    n_ticks: int,
    return_state: bool = False,
):
    """Answer a knob grid from a live carry: per-cell future deltas
    (``twin/whatif.run_whatif``).

    ``knobs`` maps promoted fields (``dynspec.DYN_FIELDS``) to value
    lists; the cartesian grid forks ``state`` and runs ``n_ticks``
    ticks per cell as one replica batch.  Returns a
    JSON-serializable report::

        {"horizon_ticks": H, "fork_t": <sim seconds>,
         "n_cells": K, "knobs": [names...],
         "cells": [{<knob values...>,
                    "delta": {counter: int, ...},   # future-only
                    "counters": {counter: int, ...}, # absolute
                    "quantiles_ms": {p50/p95/p99} | None,
                    "completed_in_window": int}, ...]}

    ``return_state=True`` additionally returns the replica-batched
    final state (row *i* = cell *i*) for bit-exactness assertions.
    Raises ``ValueError`` (one actionable line) for unpromoted knobs,
    bucket-crossing cells or a non-positive horizon.
    """
    from ..parallel.replicas import replica_counters
    from ..parallel.sweep import sweep_dyn_from

    if n_ticks < 1:
        raise ValueError(
            f"what-if horizon must be >= 1 tick, got {n_ticks}"
        )
    base = _fork_counters(state)
    grid, final = sweep_dyn_from(spec, state, net, bounds, knobs, n_ticks)
    cells: List[Dict] = []
    if grid:
        counters = replica_counters(final)
        for i, cell in enumerate(grid):
            absolute = {k: int(v[i]) for k, v in counters.items()}
            q, n_win = _cell_quantiles(spec, state, final, i)
            cells.append({
                **cell,
                "counters": absolute,
                "delta": {k: absolute[k] - base[k] for k in absolute},
                "quantiles_ms": q,
                "completed_in_window": n_win,
            })
    report = {
        "horizon_ticks": int(n_ticks),
        "fork_t": float(state.t),
        "n_cells": len(grid),
        "knobs": sorted(knobs),
        "cells": cells,
    }
    if return_state:
        return report, final
    return report


def parse_grid(text: str) -> Tuple[Dict[str, List[float]], int]:
    """Parse the CLI ``--whatif`` grid syntax: ``'knob=v1,v2 ...
    [ticks=H]'`` -> ``(knobs, n_ticks)``.  Raises ``ValueError`` (one
    actionable line) on malformed tokens — knob-name validity is
    checked downstream by :func:`run_whatif` against ``DYN_FIELDS``.
    """
    knobs: Dict[str, List[float]] = {}
    ticks = 400
    for tok in text.split():
        if "=" not in tok:
            raise ValueError(
                f"--whatif grid token {tok!r} is not KEY=VALUES; "
                "expected e.g. 'uplink_loss_prob=0.05,0.1 ticks=400'"
            )
        k, v = tok.split("=", 1)
        try:
            if k == "ticks":
                ticks = int(v)
            else:
                knobs[k] = [float(x) for x in v.split(",") if x]
        except ValueError:
            raise ValueError(
                f"--whatif grid token {tok!r} has non-numeric values"
            ) from None
    if not any(knobs.values()):
        raise ValueError(
            "--whatif needs at least one promoted knob with values, "
            "e.g. 'uplink_loss_prob=0.05,0.1 ticks=400'"
        )
    return knobs, ticks


def _json_safe(obj):
    """NaN/Inf → None, numpy scalars → python — strict-JSON payloads."""
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        f = float(obj)
        return f if math.isfinite(f) else None
    return obj


class WhatIfDoor:
    """The live session's what-if endpoint: latest-carry shadow + HTTP.

    The door never owns the chunk loop — it SHADOWS it:
    :meth:`wrap_inject` decorates the ``run_chunked`` inject hook so
    every chunk boundary (post-injection, i.e. "current state" as the
    next chunk will see it) updates the held carry, and
    :meth:`handle_http` answers ``POST /whatif`` from whatever carry is
    newest.  No chunk writes into a state in place, so answering mid-run
    from the server thread races nothing.
    """

    def __init__(
        self,
        spec,
        net,
        bounds,
        default_ticks: int = 256,
        max_cells: int = 64,
    ):
        self.spec = spec
        self.net = net
        self.bounds = bounds
        self.default_ticks = int(default_ticks)
        self.max_cells = int(max_cells)
        self._lock = threading.Lock()
        self._carry = None
        self._ticks_done = 0

    def update(self, state, ticks_done: int) -> None:
        """Install a new chunk-boundary carry (newest wins)."""
        with self._lock:
            self._carry = state
            self._ticks_done = int(ticks_done)

    def wrap_inject(self, inject=None):
        """Decorate (or stand in for) the ``run_chunked`` inject hook so
        each boundary's post-injection state becomes the door's carry."""

        def hook(state, ticks_done: int):
            if inject is not None:
                state = inject(state, ticks_done)
            self.update(state, ticks_done)
            return state

        return hook

    def ask(
        self, knobs: Mapping[str, Sequence], n_ticks: Optional[int] = None
    ) -> Dict:
        """Run the grid from the latest carry; adds ``fork_ticks_done``."""
        with self._lock:
            carry, done = self._carry, self._ticks_done
        if carry is None:
            raise ValueError(
                "what-if door holds no carry yet: the first chunk "
                "boundary has not landed (ask again after one chunk)"
            )
        n = self.default_ticks if n_ticks is None else int(n_ticks)
        n_cells = 1
        for vals in knobs.values():
            n_cells *= max(len(vals), 1)
        if n_cells > self.max_cells:
            raise ValueError(
                f"what-if grid has {n_cells} cells, over the door's "
                f"bound of {self.max_cells}: coarsen the grid or raise "
                "max_cells"
            )
        report = run_whatif(
            self.spec, carry, self.net, self.bounds, knobs, n
        )
        report["fork_ticks_done"] = done
        return report

    # ---- HTTP (the HealthServer route hook) --------------------------
    def handle_http(
        self, method: str, path: str, body: bytes
    ) -> Optional[Tuple[int, str, str]]:
        """``POST /whatif`` handler; None for any other route."""
        if not path.split("?", 1)[0].rstrip("/").endswith("/whatif"):
            return None
        if method != "POST":
            return (
                200, "application/json",
                json.dumps({
                    "usage": 'POST {"knobs": {"<promoted field>": '
                             '[values...]}, "ticks": <int>}',
                    "default_ticks": self.default_ticks,
                    "max_cells": self.max_cells,
                }) + "\n",
            )
        status, payload = self._post(body)
        return (status, "application/json", json.dumps(payload) + "\n")

    def _post(self, body: bytes) -> Tuple[int, Dict]:
        try:
            doc = json.loads(body.decode() or "null")
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            return 400, {"error": whatif_payload_error(f"invalid JSON ({e})")}
        if not isinstance(doc, dict) or not isinstance(
            doc.get("knobs"), dict
        ):
            return 400, {
                "error": whatif_payload_error("no 'knobs' object given")
            }
        knobs = doc["knobs"]
        for k, vals in knobs.items():
            if not isinstance(vals, list) or not vals or not all(
                isinstance(v, (int, float)) and not isinstance(v, bool)
                for v in vals
            ):
                return 400, {
                    "error": whatif_payload_error(
                        f"knob {k!r} needs a non-empty list of numbers"
                    )
                }
        ticks = doc.get("ticks")
        if ticks is not None and (
            isinstance(ticks, bool) or not isinstance(ticks, int)
        ):
            return 400, {
                "error": whatif_payload_error("'ticks' is not an int")
            }
        try:
            return 200, _json_safe(self.ask(knobs, ticks))
        except ValueError as e:
            return 400, {"error": str(e)}
