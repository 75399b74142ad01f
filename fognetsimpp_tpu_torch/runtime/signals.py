"""Signal extraction: the reference's statistic vectors from a finished run
(``fognetsimpp_tpu/runtime/signals.py``, copied for the port's states).

The task table stores absolute event times with ``+inf`` meaning "never
happened"; this module turns those columns into per-task signal vectors,
masked, finite, in milliseconds:

  * ``latency``   — publish -> status-5 "assigned" ack (``mqttApp2.cc:256-267``)
  * ``latency_h1``— publish -> status-4 ack, the broker's "forwarded" and the
    relayed fog "queued" (``mqttApp2.cc:269-277``)
  * ``task_time`` — publish -> status-6 "performed" ack (``mqttApp2.cc:279-291``)
  * ``queue_time``— fog FIFO wait (``ComputeBrokerApp3.cc:238``)
  * ``delay``     — broker-side publish transit (``BrokerBaseApp3.cc:143``)

The port's tensors are read back to the host once, here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from ..spec import Stage
from ..state import WorldState


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _finite_ms(
    t_end: np.ndarray, t_start: np.ndarray, t_now: float = float("inf")
) -> np.ndarray:
    """(t_end - t_start) * 1e3 where both ends are finite and the end
    event happened by ``t_now`` (the run's end time)."""
    m = np.isfinite(t_end) & np.isfinite(t_start) & (t_end <= t_now)
    return ((t_end[m] - t_start[m]) * 1e3).astype(np.float64)


def extract_signals(final: WorldState) -> Dict[str, np.ndarray]:
    """Per-task signal vectors (milliseconds) from a finished run."""
    t = final.tasks
    t_create = _np(t.t_create)
    t_now = float(final.t)
    qt = _np(t.queue_time_ms)
    return {
        "latency": _finite_ms(_np(t.t_ack5), t_create, t_now),
        "latency_h1": np.concatenate(
            [
                _finite_ms(_np(t.t_ack4_fwd), t_create, t_now),
                _finite_ms(_np(t.t_ack4_queued), t_create, t_now),
            ]
        ),
        "task_time": _finite_ms(_np(t.t_ack6), t_create, t_now),
        "ack3": _finite_ms(_np(t.t_ack3), t_create, t_now),
        "queue_time": qt[np.isfinite(qt) & ~np.isnan(qt)].astype(np.float64),
        "delay": _finite_ms(_np(t.t_at_broker), t_create, t_now),
    }


def summarize(final: WorldState) -> Dict[str, float]:
    """Scalar roll-up: the stage census, every Metrics counter, the
    count/mean/max of each signal (ms), and the chaos, hierarchy and
    learner roll-ups of the worlds that carry them (each subsystem's
    leaves are zero-row when it is off, which doubles as its flag)."""
    sig = extract_signals(final)
    stage = _np(final.tasks.stage)
    out: Dict[str, float] = {
        f"stage_{s.name.lower()}": int((stage == int(s)).sum()) for s in Stage
    }
    m = final.metrics
    out.update(
        {f.name: int(getattr(m, f.name)) for f in dataclasses.fields(m)}
    )
    for name, v in sig.items():
        out[f"{name}_n"] = int(v.size)
        out[f"{name}_mean_ms"] = float(v.mean()) if v.size else float("nan")
        out[f"{name}_max_ms"] = float(v.max()) if v.size else float("nan")
    if final.chaos.next_down.numel():
        ch = final.chaos
        out["chaos_crashes"] = int(ch.n_crashes)
        out["chaos_recovers"] = int(ch.n_recovers)
        out["chaos_lost_crash"] = int(ch.n_lost_crash)
        out["chaos_reoffloaded"] = int(ch.n_reoffloaded)
        out["chaos_retry_exhausted"] = int(ch.n_retry_exhausted)
    if final.hier.fog_broker.numel():
        out["hier_migrated"] = int(final.hier.n_migrated)
        out["hier_hop_exhausted"] = int(final.hier.n_hop_exhausted)
    if final.learn.pick_p.numel():
        lat_cnt = float(final.learn.lat_cnt)
        out["learn_credited"] = int(lat_cnt)
        out["learn_lat_mean_ms"] = (
            float(final.learn.lat_sum) / lat_cnt * 1e3 if lat_cnt > 0 else float("nan")
        )
    return out
