"""Plane 3 (exposition): run scalars as OpenMetrics text.

Counterpart of ``fognetsimpp_tpu/telemetry/openmetrics.py``.
:func:`render_openmetrics` turns a finished (or chunk-boundary) state into
OpenMetrics text exposition (one ``# HELP`` / ``# TYPE`` pair and the
samples a family, ``# EOF`` last): every ``Metrics`` counter and signal
roll-up of :func:`..runtime.signals.summarize`, and with ``spec.telemetry``
the per-fog gauges of :func:`.metrics.telemetry_summary` (the same
``busy_frac`` the recorder's ``.sca.json`` fog rows read), the TP exchange
families, the chaos and hierarchy families, the journey census, the
latency histogram and the twin's ingest families.  Non-finite values are
skipped, never emitted.  ``tools/check_openmetrics.py`` lints the text.

The text is JAX's byte for byte but for one departure, by design: JAX
renders its ``fns_compile_*`` families (the persistent compilation cache's
hits and misses, backend compile seconds, the program registry) into every
exposition.  They read XLA's program cache, which has no PyTorch
counterpart, so the port renders no such family.  The readers here take
the port's tensors on any device; each reads its leaves to the host once.
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, Dict, List, Optional

import numpy as np

from ..spec import WorldSpec

if TYPE_CHECKING:  # the state module imports this package's metrics
    from ..state import WorldState

_PREFIX = "fns"


def _sample(lines: List[str], name: str, value, labels: str = "") -> None:
    v = float(value)
    if not math.isfinite(v):
        return
    # integral values render without a trailing .0 (stable goldens)
    sv = str(int(v)) if v == int(v) and abs(v) < 2**53 else repr(v)
    lines.append(f"{_PREFIX}_{name}{labels} {sv}")


def _family(
    lines: List[str], name: str, kind: str = "gauge",
    help_text: Optional[str] = None,
) -> None:
    # every family carries both metadata comments: the lint requires a
    # # HELP next to each # TYPE
    h = help_text or name.replace("_", " ")
    lines.append(f"# HELP {_PREFIX}_{name} {h}")
    lines.append(f"# TYPE {_PREFIX}_{name} {kind}")


def _fmt_le(v: float) -> str:
    """`le` label text for a finite bucket edge (round-trips float())."""
    return repr(float(v))


def _render_latency_hist(
    lines: List[str], hist: Dict, family: str = "task_latency"
) -> None:
    """One per-fog latency histogram and its quantile gauges, from
    :func:`.health.hist_summary`'s dict (the recorder reads the same one).
    Buckets follow the OpenMetrics histogram contract: cumulative counts,
    ascending ``le``, ``+Inf`` last, ``_count`` equal to the +Inf bucket,
    ``_sum`` present.  Samples are seconds; the quantile gauges are
    milliseconds and say so in their name."""
    edges_s = hist["edges_ms"] / 1e3
    counts = hist["counts"]
    F = counts.shape[0]
    _family(
        lines, family, "histogram",
        help_text="task_time latency publish to status-6 ack (seconds)",
    )
    for f in range(F):
        cum = np.cumsum(counts[f])
        for b in range(len(edges_s)):
            _sample(
                lines, f"{family}_bucket", cum[b],
                labels=f'{{fog="{f}",le="{_fmt_le(edges_s[b])}"}}',
            )
        _sample(
            lines, f"{family}_bucket", cum[-1],
            labels=f'{{fog="{f}",le="+Inf"}}',
        )
        _sample(
            lines, f"{family}_sum", hist["per_fog_sum_ms"][f] / 1e3,
            labels=f'{{fog="{f}"}}',
        )
        _sample(
            lines, f"{family}_count", cum[-1], labels=f'{{fog="{f}"}}'
        )
    _family(
        lines, f"{family}_quantile_ms",
        help_text="latency quantiles from the device histogram (ms)",
    )
    for qname, qv in hist["quantiles_ms"].items():
        _sample(
            lines, f"{family}_quantile_ms", qv, labels=f'{{q="{qname}"}}'
        )
    for qname, vec in hist["per_fog_quantiles_ms"].items():
        for f in range(F):
            _sample(
                lines, f"{family}_quantile_ms", vec[f],
                labels=f'{{fog="{f}",q="{qname}"}}',
            )


def _render_tp_exchange(lines: List[str], ex: Dict) -> None:
    """The per-shard TP exchange families, from
    :func:`.metrics.exchange_summary`'s dict; the occupancy family is an
    OpenMetrics histogram, one label group a shard."""
    S = ex["n_shards"]
    _family(lines, "tp_shards", help_text="task-table shard count")
    _sample(lines, "tp_shards", S)
    fam = "tp_exchange_occupancy"
    _family(
        lines, fam, "histogram",
        help_text="per-tick exchange-window occupancy fraction per "
        "shard (candidates surviving the saturated-fog fast drop / "
        "window slots; > 1 defers)",
    )
    edges = ex["occ_edges"]
    for s in range(S):
        cum = np.cumsum(ex["occ_hist"][s])
        for b, e in enumerate(edges):
            _sample(
                lines, f"{fam}_bucket", cum[b],
                labels=f'{{shard="{s}",le="{_fmt_le(e)}"}}',
            )
        _sample(
            lines, f"{fam}_bucket", cum[-1],
            labels=f'{{shard="{s}",le="+Inf"}}',
        )
        _sample(
            lines, f"{fam}_sum", ex["occ_sum"][s],
            labels=f'{{shard="{s}"}}',
        )
        _sample(
            lines, f"{fam}_count", cum[-1], labels=f'{{shard="{s}"}}'
        )
    for name, vec, kind, h in (
        ("tp_exchange_candidates", ex["cand"], "counter",
         "arrival candidates produced per shard"),
        ("tp_exchange_deferred", ex["defer_sum"], "counter",
         "candidates deferred at the exchange window per shard"),
        ("tp_exchange_deferred_max", ex["defer_max"], "gauge",
         "max per-tick deferred candidates per shard"),
        ("tp_exchange_utilization", ex["util_mean"], "gauge",
         "mean ppermute payload utilization per shard"),
        ("tp_exchange_defer_age_ticks_max", ex["age_max_ticks"],
         "gauge", "max tick-age of a deferred candidate per shard"),
    ):
        _family(lines, name, kind, help_text=h)
        for s in range(S):
            _sample(lines, name, vec[s], labels=f'{{shard="{s}"}}')


def _render_journeys(lines: List[str], js: Dict) -> None:
    """The ``fns_journey_*`` families, from
    :func:`.journeys.journey_summary`'s dict.  The census labels each
    sampled task by the last decoded stage of its ring (``in_flight``:
    spawned, not yet terminal; ``unspawned``: the slot was never used)."""
    for name, key, kind, h in (
        ("journey_sampled", "sampled", "gauge",
         "task slots sampled into journey event rings"),
        ("journey_ring_rows", "ring", "gauge",
         "event rows per sampled task's ring (drop-oldest overflow)"),
        ("journey_events_total", "events_total", "counter",
         "journey lifecycle events appended across all sampled tasks"),
        ("journey_dropped_total", "dropped_total", "counter",
         "journey events overwritten by ring overflow (drop-oldest)"),
    ):
        _family(lines, name, kind, help_text=h)
        _sample(lines, name, js[key])
    _family(
        lines, "journey_tasks",
        help_text="sampled-task census by the last decoded journey "
        "stage",
    )
    census = dict(js["terminal"])
    census["in_flight"] = js["in_flight"]
    census["unspawned"] = js["unspawned"]
    for stage, n in sorted(census.items()):
        _sample(
            lines, "journey_tasks", n, labels=f'{{stage="{stage}"}}'
        )


def _render_twin_ingest(lines: List[str], st: Dict) -> None:
    """The twin's ingest-queue families, from
    :meth:`..twin.ingest.IngestQueue.stats` (the /healthz ``ingest``
    section and the watchdog's ``ingest_depth`` read the same dict)."""
    for family, key, kind, help_text in (
        ("twin_ingest_depth", "depth", "gauge",
         "arrival-queue occupancy at the last chunk boundary"),
        ("twin_ingest_capacity", "capacity", "gauge",
         "arrival-queue bound (feeds past it are dropped)"),
        ("twin_ingest_accepted_total", "accepted", "counter",
         "arrivals accepted into the queue"),
        ("twin_ingest_dropped_total", "dropped", "counter",
         "arrivals dropped at the full queue"),
        ("twin_ingest_injected_total", "injected", "counter",
         "arrivals landed into simulation state at chunk boundaries"),
        ("twin_ingest_rejected_total", "rejected", "counter",
         "drained arrivals the injector refused (dead/disconnected "
         "user or send slots exhausted)"),
        ("twin_ingest_latency_seconds", "latency_s", "gauge",
         "feed-to-injection wall latency of the last drained batch"),
    ):
        _family(lines, family, kind, help_text=help_text)
        _sample(lines, family, st.get(key, 0))


def render_openmetrics(
    spec: WorldSpec,
    final: "WorldState",
    attrs: Optional[Dict] = None,
    hist: Optional[Dict] = None,
    ingest: Optional[Dict] = None,
) -> str:
    """OpenMetrics text for one state, terminated by ``# EOF``.

    ``hist``: a :func:`.health.hist_summary` dict the caller already holds
    (derived here when omitted).  ``ingest``: the twin queue's ``stats()``
    dict, rendered as the ``fns_twin_ingest_*`` families.  ``attrs``: the
    finite numeric entries become ``fns_run_<key>`` gauges.
    """
    from ..runtime.signals import summarize
    from .metrics import telemetry_summary

    lines: List[str] = []
    for k, v in summarize(final).items():
        if isinstance(v, float) and not math.isfinite(v):
            continue
        _family(lines, k)
        _sample(lines, k, v)
    summ = telemetry_summary(spec, final)
    if summ is not None:
        per_fog = {
            "fog_busy_fraction": summ["busy_frac"],
            "fog_q_len_mean": summ["q_len_mean"],
            "fog_q_len_max": summ["q_len_max"],
            "fog_pool_occ_mean": summ["pool_occ_mean"],
            "fog_picks": summ["pick_hist"],
        }
        for name, vec in per_fog.items():
            _family(lines, name)
            for f in range(spec.n_fogs):
                _sample(lines, name, vec[f], labels=f'{{fog="{f}"}}')
        _family(lines, "phase_work")
        for phase, n in summ["phase_work"].items():
            _sample(
                lines, "phase_work", n, labels=f'{{phase="{phase}"}}'
            )
        _family(lines, "telemetry_ticks")
        _sample(lines, "telemetry_ticks", summ["ticks"])
        _family(lines, "deferred_sum")
        _sample(lines, "deferred_sum", summ["defer_sum"])
        # the per-shard exchange families of a stamped TP run
        if summ.get("tp_exchange") is not None:
            _render_tp_exchange(lines, summ["tp_exchange"])
    if spec.chaos:
        from ..chaos.faults import chaos_summary

        cs = chaos_summary(spec, final)
        _family(
            lines, "chaos_fog_down_ticks",
            help_text="ticks each fog spent crashed over the run",
        )
        for f in range(spec.n_fogs):
            _sample(
                lines, "chaos_fog_down_ticks", cs["down_ticks"][f],
                labels=f'{{fog="{f}"}}',
            )
    if spec.hier_active:
        from ..hier.federation import hier_summary

        hs = hier_summary(spec, final)
        # the broker count the lint checks every per-broker family against
        _family(
            lines, "hier_brokers",
            help_text="broker domain count of the federation",
        )
        _sample(lines, "hier_brokers", hs["n_brokers"])
        for family, key, help_text in (
            ("hier_migrations_out", "mig_out",
             "tasks migrated away from each broker domain"),
            ("hier_migrations_in", "mig_in",
             "tasks migrated into each broker domain"),
            ("hier_fogs", "fogs_per_broker",
             "fog nodes owned by each broker domain"),
            ("hier_users", "users_per_broker",
             "users publishing to each broker domain"),
        ):
            _family(lines, family, help_text=help_text)
            for b in range(hs["n_brokers"]):
                _sample(
                    lines, family, hs[key][b],
                    labels=f'{{broker="{b}"}}',
                )
        if "load_mean" in hs:
            _family(
                lines, "hier_load_mean",
                help_text="mean busy fraction of each broker domain",
            )
            for b in range(hs["n_brokers"]):
                _sample(
                    lines, "hier_load_mean", hs["load_mean"][b],
                    labels=f'{{broker="{b}"}}',
                )
    if spec.journey_active:
        from .journeys import journey_summary

        js = journey_summary(spec, final)
        if js is not None:
            _render_journeys(lines, js)
    if hist is None:
        from .health import hist_summary

        hist = hist_summary(spec, final)
    if hist is not None:
        _render_latency_hist(lines, hist)
    if ingest is not None:
        _render_twin_ingest(lines, ingest)
    for k, v in (attrs or {}).items():
        if isinstance(v, (int, float)) and math.isfinite(float(v)):
            _family(lines, f"run_{k}")
            _sample(lines, f"run_{k}", v)
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def render_twin_openmetrics(tenants: List[Dict]) -> str:
    """The front door's aggregate exposition over every admitted tenant,
    in admission order (:meth:`..twin.front.FrontDoor.tenant_rows`): each
    family carries a ``tenant="i"`` label, and ``fns_twin_tenants`` is the
    count the lint checks the labels against."""
    lines: List[str] = []
    _family(
        lines, "twin_tenants",
        help_text="tenant sessions admitted behind the front door",
    )
    _sample(lines, "twin_tenants", len(tenants))
    for family, key, kind, help_text in (
        ("twin_tenant_ticks", "ticks", "gauge",
         "simulated ticks each tenant session has completed"),
        ("twin_tenant_chunks", "chunks", "gauge",
         "serve chunks each tenant session has completed"),
        ("twin_tenant_users", "n_users", "gauge",
         "bucketed user population of each tenant world"),
        ("twin_tenant_published_total", "n_published", "counter",
         "tasks published in each tenant world"),
        ("twin_tenant_completed_total", "n_completed", "counter",
         "tasks completed in each tenant world"),
        ("twin_tenant_ingest_depth", "ingest_depth", "gauge",
         "arrival-queue occupancy of each tenant (0 when the tenant "
         "has no ingestion queue)"),
    ):
        _family(lines, family, kind, help_text=help_text)
        for i, t in enumerate(tenants):
            _sample(
                lines, family, t.get(key, 0), labels=f'{{tenant="{i}"}}'
            )
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def render_fleet_openmetrics(
    fleet_scalars: Dict,
    busy_frac: Optional[np.ndarray] = None,
    hist: Optional[Dict] = None,
    phase_work: Optional[np.ndarray] = None,
) -> str:
    """OpenMetrics text for a replica batch's scalars.

    ``fleet_scalars``: ``runtime.recorder.fleet_scalars``'s dict.
    ``busy_frac``: per-replica per-fog busy fractions ``(R, F)``, one
    ``fleet="r"`` label a replica (a 1-D vector renders without it).
    ``hist``: the replica-merged latency histogram (the
    ``fns_fleet_task_latency`` family).  ``phase_work``: per-replica phase
    counters ``(R, P)``.
    """
    lines: List[str] = []
    _family(lines, "fleet_replicas")
    _sample(lines, "fleet_replicas", fleet_scalars["n_replicas"])
    for k, agg in fleet_scalars["aggregate"].items():
        _family(lines, f"fleet_{k}")
        for stat in ("sum", "mean", "min", "max"):
            _sample(
                lines, f"fleet_{k}", agg[stat],
                labels=f'{{stat="{stat}"}}',
            )
    if busy_frac is not None:
        bf = np.asarray(busy_frac)
        _family(lines, "fleet_fog_busy_fraction")
        if bf.ndim == 2:
            for r in range(bf.shape[0]):
                for f in range(bf.shape[1]):
                    _sample(
                        lines, "fleet_fog_busy_fraction", bf[r, f],
                        labels=f'{{fleet="{r}",fog="{f}"}}',
                    )
        else:
            for f in range(len(bf)):
                _sample(
                    lines, "fleet_fog_busy_fraction", bf[f],
                    labels=f'{{fog="{f}"}}',
                )
    if phase_work is not None:
        from .metrics import PHASES

        pw = np.asarray(phase_work)
        _family(
            lines, "fleet_phase_work",
            help_text="per-replica per-phase work counters",
        )
        for r in range(pw.shape[0]):
            for p, name in enumerate(PHASES):
                _sample(
                    lines, "fleet_phase_work", pw[r, p],
                    labels=f'{{fleet="{r}",phase="{name}"}}',
                )
    if hist is not None:
        _render_latency_hist(lines, hist, family="fleet_task_latency")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def write_openmetrics(
    path: str,
    spec: WorldSpec,
    final: "WorldState",
    attrs: Optional[Dict] = None,
    hist: Optional[Dict] = None,
) -> str:
    """Render and write; returns ``path``."""
    with open(path, "w") as f:
        f.write(render_openmetrics(spec, final, attrs=attrs, hist=hist))
    return path
