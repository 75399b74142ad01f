"""Plane 3 (host): the profiler and dispatch-latency statistics.

Counterpart of ``fognetsimpp_tpu/telemetry/profile.py``:

* :func:`profile_trace` wraps a block in ``torch.profiler`` and writes a
  Chrome trace into ``outdir``.  The engine opens a
  ``record_function("phase_<name>")`` span around every phase while a
  profiler records, the counterpart of JAX's ``jax.named_scope``, so the
  trace attributes time to ``phase_broker``, ``phase_fog_arrivals`` and
  the rest.  A profiler that fails to start leaves the block running
  without it.
* :func:`latency_histogram` summarises wall-time samples.
* :func:`measure_dispatch` times calls of a callable, each waited for on
  the card.

The JAX module's ``measure_compile`` has no counterpart: the port
compiles no program of the tick (its kernels are built once, by
``ops/cuda_build``, and timed there).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional, Sequence


@contextlib.contextmanager
def profile_trace(outdir: Optional[str]):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA when a card
    is present) and write ``outdir/trace.json``; a no-op when ``outdir``
    is None.  Yields ``{"active", "dir", "error"}``."""
    info = {"active": False, "dir": outdir, "error": None}
    if not outdir:
        yield info
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=acts)
        prof.__enter__()
        info["active"] = True
    except Exception as e:  # unsupported backend or a nested session
        info["error"] = f"{type(e).__name__}: {e}"
        yield info
        return
    try:
        yield info
    finally:
        try:
            prof.__exit__(None, None, None)
            os.makedirs(outdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(outdir, "trace.json"))
        except Exception as e:
            info["error"] = f"{type(e).__name__}: {e}"


def latency_histogram(
    samples_s: Sequence[float],
    edges_ms: Sequence[float] = (1.0, 5.0, 20.0, 50.0, 100.0, 250.0),
) -> Dict:
    """Summary and bucket counts (ms) of wall-time samples."""
    ms = sorted(s * 1e3 for s in samples_s)
    n = len(ms)
    if n == 0:
        return {"n": 0}

    def q(p):
        return ms[min(n - 1, int(p * n))]

    buckets: Dict[str, int] = {}
    lo = 0.0
    for e in edges_ms:
        buckets[f"le_{e:g}ms"] = sum(1 for m in ms if lo < m <= e)
        lo = e
    buckets["gt"] = sum(1 for m in ms if m > edges_ms[-1])
    return {
        "n": n,
        "p50_ms": round(q(0.50), 3),
        "p90_ms": round(q(0.90), 3),
        "max_ms": round(ms[-1], 3),
        "buckets": buckets,
    }


def measure_dispatch(call: Callable[[], object], n: int = 10, warmup: int = 1) -> Dict:
    """Latency histogram over ``n`` calls of ``call``, each followed by a
    wait for the card (when one is in use), so a sample covers the launch
    and the device work."""
    import torch

    def sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    for _ in range(warmup):
        call()
        sync()
    samples: List[float] = []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        sync()
        samples.append(time.perf_counter() - t0)
    return latency_histogram(samples)
