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
* Plane 2, :mod:`.timeline`: task lifecycles as Perfetto trace-event
  JSON.
* Plane 3, :mod:`.profile` (the profiler and dispatch timing) and
  :mod:`.openmetrics` (the OpenMetrics text exposition).
* The live health plane's host half, :mod:`.live`: the serving loop over
  ``run_chunked`` and its TP twin, the pull endpoint, the EWMA watchdog
  and the flight recorder.

The exporters' modules import nothing of the state at their top, so the
state module's import of :mod:`.metrics` does not cycle through them.
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
from .live import (  # noqa: F401
    Ewma,
    FlightRecorder,
    HealthServer,
    ReconfigDoor,
    Watchdog,
    serve_run,
    serve_tp_run,
)
from .openmetrics import (  # noqa: F401
    render_fleet_openmetrics,
    render_openmetrics,
    render_twin_openmetrics,
    write_openmetrics,
)
from .timeline import build_trace, export_trace  # noqa: F401
