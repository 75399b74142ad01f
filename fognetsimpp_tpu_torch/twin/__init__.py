"""The digital-twin serving subsystem (``fognetsimpp_tpu/twin``), layered
over ``run_chunked`` and ``telemetry.live.serve_run``:

* :mod:`.ingest`: queue-fed arrivals (``POST /ingest`` and ``feed()``),
  drained at each chunk boundary through the engine's injector and
  recorded in a replayable arrival log;
* :mod:`.whatif`: promoted-knob grids forked from the live carry
  (``sweep_dyn_from``), one replica batch an ask;
* :mod:`.front`: the multi-tenant front door, N serve sessions behind one
  endpoint, round robin, each with its own recorder and watchdog.

Refusals carry the ``[TWIN-*]`` clause IDs of :mod:`.gates`.
"""
from .front import FrontDoor  # noqa: F401
from .ingest import IngestQueue, make_inject, serve_ingest_run  # noqa: F401
from .whatif import run_whatif  # noqa: F401
