"""The telemetry planes of the port (``fognetsimpp_tpu/telemetry``).

* Plane 1, :mod:`.metrics`: :class:`~.metrics.TelemetryState` on the
  world carry (zero-row when ``spec.telemetry`` is off): per-fog queue
  depths, busy and pool occupancy, the pick histogram, per-phase work, a
  strided reservoir of per-tick rows, the TP exchange gauges and the
  per-broker load of a federated world.
* The health plane, :mod:`.health`: the per-fog latency histogram
  (``spec.telemetry_hist``) and its quantiles.
* Journeys, :mod:`.journeys`: rings of sampled tasks' lifecycle events
  (``spec.telemetry_journeys``).
* Plane 3, :mod:`.profile`: the profiler and dispatch timing.

The host exporters of the JAX package (Perfetto timeline, OpenMetrics,
the live server) are not ported yet (``ROADMAP.md`` §1).
"""
from .health import (  # noqa: F401
    QUANTILES,
    hist_edges_s,
    hist_summary,
    slo_breach_count,
)
from .metrics import (  # noqa: F401
    PHASES,
    RES_FIELDS,
    TelemetryState,
    busy_fractions,
    exchange_summary,
    init_telemetry_state,
    telemetry_summary,
)
