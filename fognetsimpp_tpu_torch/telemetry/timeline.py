"""Plane 2: task-lifecycle tracing to Chrome/Perfetto trace-event JSON.

Counterpart of ``fognetsimpp_tpu/telemetry/timeline.py``: the task table's
absolute event times (``t_create`` -> ``t_at_broker`` -> ``t_at_fog`` ->
``t_q_enter`` -> ``t_service_start`` -> ``t_complete`` -> ``t_ack6``),
masked as :mod:`..runtime.signals` masks them, become trace-event JSON
(the ``chrome://tracing`` / Perfetto schema).

Mapping: **replica -> pid, fog -> tid**.  Each fog thread carries, per
task it served, a ``task`` span (fog arrival -> completion) with nested
``queued`` and ``service`` spans; a ``broker`` thread (tid = n_fogs)
carries the ``publish`` and ``ack`` spans and instant markers for the
terminal failures.  Timestamps are simulated microseconds, durations
clamped >= 0, only finite values emitted (strict ``json.loads`` reads the
file).  Beside the spans: per-fog counter tracks (``fogN queue_depth``,
``fogN busy_frac`` over :data:`BUSY_WINDOWS` windows), the chaos
lifecycle (``fog_down`` spans replayed from the chaos key), the per-shard
TP exchange lanes, the per-broker load lanes and the journey lanes with
their Perfetto flow chains.  The state is read to the host once.  The
events and their order are JAX's: ``json.loads`` of the two files is
equal.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from ..spec import Stage, WorldSpec

#: Windows the per-fog busy-fraction counter track averages over.
BUSY_WINDOWS = 24

#: Terminal stages that never reach a fog: shown as instant markers.
_FAIL_STAGES = {
    int(Stage.LOST): "lost",
    int(Stage.DROPPED): "dropped",
    int(Stage.REJECTED): "rejected",
    int(Stage.NO_RESOURCE): "no_resource",
    int(Stage.HOP_EXHAUSTED): "hop_exhausted",
}


def _us(t: np.ndarray) -> np.ndarray:
    """Seconds → microseconds, as float64 (trace-event ts unit)."""
    return np.asarray(t, np.float64) * 1e6


def _span(name, pid, tid, ts, dur, args=None) -> Dict:
    ev = {
        "name": name,
        "ph": "X",
        "pid": int(pid),
        "tid": int(tid),
        "ts": float(ts),
        "dur": float(max(dur, 0.0)),
        "cat": "task",
    }
    if args:
        ev["args"] = args
    return ev


def _counter(name: str, pid: int, ts: float, key: str, value) -> Dict:
    return {
        "name": name,
        "ph": "C",
        "pid": int(pid),
        "ts": float(ts),
        "cat": "health",
        "args": {key: float(value)},
    }


def _counter_events(
    spec: WorldSpec,
    tasks_np: Dict[str, np.ndarray],
    pid: int,
    ids: np.ndarray,
) -> List[Dict]:
    """Per-fog queue-depth and busy-fraction counter tracks.

    Reconstructed from the same (capped) task rows the span builder
    uses: queue depth is the cumulative sum of +1 edges at
    ``t_q_enter`` and −1 edges at ``t_service_start``; busy fraction is
    the service-interval overlap with :data:`BUSY_WINDOWS` equal
    windows of the observed span.  Pure post-run host work — no new
    device state.
    """
    events: List[Dict] = []
    if ids.size == 0:
        return events
    fog = tasks_np["fog"].astype(np.int64)[ids]
    qe = _us(tasks_np["t_q_enter"])[ids]
    ss = _us(tasks_np["t_service_start"])[ids]
    tc = _us(tasks_np["t_complete"])[ids]
    t_hi = spec.horizon * 1e6
    for f in range(spec.n_fogs):
        mine = fog == f
        # queue-depth staircase: +1 on queue enter, -1 on service start
        t_in = qe[mine & np.isfinite(qe)]
        t_out = ss[mine & np.isfinite(qe) & np.isfinite(ss)]
        if t_in.size:
            ts = np.concatenate([t_in, t_out])
            dv = np.concatenate(
                [np.ones_like(t_in), -np.ones_like(t_out)]
            )
            order = np.argsort(ts, kind="stable")
            depth = np.cumsum(dv[order])
            ts_s = ts[order]
            events.extend(
                _counter(
                    f"fog{f} queue_depth", pid, ts_s[i], "tasks",
                    max(depth[i], 0.0),
                )
                for i in range(len(ts_s))
            )
        # busy fraction: service-interval overlap per window
        svc = mine & np.isfinite(ss) & np.isfinite(tc)
        if not svc.any():
            continue
        s0, s1 = ss[svc], np.minimum(tc[svc], t_hi)
        edges = np.linspace(0.0, t_hi, BUSY_WINDOWS + 1)
        for w in range(BUSY_WINDOWS):
            w0, w1 = edges[w], edges[w + 1]
            if w1 <= w0:
                continue
            overlap = np.clip(
                np.minimum(s1, w1) - np.maximum(s0, w0), 0.0, None
            ).sum()
            events.append(
                _counter(
                    f"fog{f} busy_frac", pid, w0, "frac",
                    min(overlap / (w1 - w0), 1.0),
                )
            )
    return events


def _replica_events(
    spec: WorldSpec, tasks_np: Dict[str, np.ndarray], pid: int,
    max_tasks: Optional[int] = None,
) -> List[Dict]:
    F, S = spec.n_fogs, spec.max_sends_per_user
    stage = tasks_np["stage"].astype(np.int64)
    fog = tasks_np["fog"].astype(np.int64)
    used = stage != int(Stage.UNUSED)
    ids = np.nonzero(used)[0]
    if max_tasks is not None:
        ids = ids[:max_tasks]
    events: List[Dict] = []
    broker_tid = F
    t_create = _us(tasks_np["t_create"])
    t_at_broker = _us(tasks_np["t_at_broker"])
    t_at_fog = _us(tasks_np["t_at_fog"])
    t_q_enter = _us(tasks_np["t_q_enter"])
    t_service = _us(tasks_np["t_service_start"])
    t_complete = _us(tasks_np["t_complete"])
    t_ack6 = _us(tasks_np["t_ack6"])
    mips = np.asarray(tasks_np["mips_req"], np.float64)
    for i in ids:
        i = int(i)
        user = i // S
        args = {"task": i, "user": user, "mips_req": float(mips[i])}
        st = int(stage[i])
        if np.isfinite(t_create[i]) and np.isfinite(t_at_broker[i]):
            events.append(
                _span(
                    "publish", pid, broker_tid, t_create[i],
                    t_at_broker[i] - t_create[i], args,
                )
            )
        if st in _FAIL_STAGES and np.isfinite(t_create[i]):
            events.append(
                {
                    "name": _FAIL_STAGES[st],
                    "ph": "i",
                    "s": "t",
                    "pid": pid,
                    "tid": int(broker_tid),
                    "ts": float(t_create[i]),
                    "cat": "task",
                    "args": args,
                }
            )
        f = int(fog[i])
        if f < 0 or f >= F:
            continue
        if np.isfinite(t_at_fog[i]) and np.isfinite(t_complete[i]):
            events.append(
                _span(
                    f"task{i}", pid, f, t_at_fog[i],
                    t_complete[i] - t_at_fog[i], args,
                )
            )
        if np.isfinite(t_q_enter[i]) and np.isfinite(t_service[i]):
            events.append(
                _span(
                    "queued", pid, f, t_q_enter[i],
                    t_service[i] - t_q_enter[i],
                )
            )
        if np.isfinite(t_service[i]) and np.isfinite(t_complete[i]):
            events.append(
                _span(
                    "service", pid, f, t_service[i],
                    t_complete[i] - t_service[i],
                )
            )
        if np.isfinite(t_complete[i]) and np.isfinite(t_ack6[i]):
            events.append(
                _span(
                    "ack", pid, broker_tid, t_complete[i],
                    t_ack6[i] - t_complete[i], args,
                )
            )
    # per-fog queue-depth / busy-fraction counter tracks
    events.extend(_counter_events(spec, tasks_np, pid, ids))
    # lane names: one metadata event per thread (Perfetto track labels)
    for f in range(F):
        events.append(
            {
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": f, "args": {"name": f"fog{f}"},
            }
        )
    events.append(
        {
            "name": "thread_name", "ph": "M", "pid": pid,
            "tid": int(broker_tid), "args": {"name": "broker"},
        }
    )
    events.append(
        {
            "name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": f"replica{pid}"},
        }
    )
    return events


def _chaos_lifecycle_events(
    spec: WorldSpec, final, pid: int
) -> List[Dict]:
    """Per-fog lifecycle track: one ``fog_down`` span per
    outage on the owning fog's lane, replayed on host from the
    deterministic schedule (``chaos/faults.outage_timeline`` — the
    chaos key rides the final state, and random schedules are a pure
    function of it, so this is exact, not a reconstruction).  Empty on
    chaos-off runs: every existing trace stays byte-identical.
    """
    if not spec.chaos:
        return []
    from ..chaos.faults import outage_timeline

    events: List[Dict] = []
    for f, td, tu in outage_timeline(spec, final.chaos.key):
        events.append(
            {
                "name": "fog_down",
                "ph": "X",
                "pid": int(pid),
                "tid": int(f),
                "ts": float(td * 1e6),
                "dur": float(max(tu - td, 0.0) * 1e6),
                "cat": "chaos",
                "args": {"fog": int(f)},
            }
        )
    return events


def _tp_exchange_events(spec: WorldSpec, final, pid: int) -> List[Dict]:
    """Per-SHARD exchange-plane counter lanes.

    One dedicated "tp-exchange" process whose threads are counter
    tracks ``shard{s} exchange_occ`` — the strided per-tick
    exchange-window occupancy rows the sharded tick folded into
    ``TelemetryState.exg_occ_res``, timestamped from the matching
    reservoir rows.  Empty on non-TP (or telemetry-off) runs, so every
    existing trace is byte-identical.
    """
    from .metrics import exchange_summary

    ex = exchange_summary(spec, final)
    if ex is None or ex["occ_rows"].size == 0:
        return []
    events: List[Dict] = []
    ts = _us(ex["occ_rows_t"])
    for s in range(ex["n_shards"]):
        events.extend(
            _counter(
                f"shard{s} exchange_occ", pid, ts[i], "occ",
                ex["occ_rows"][i, s],
            )
            for i in range(len(ts))
        )
    events.append(
        {
            "name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": "tp-exchange"},
        }
    )
    return events


def _hier_broker_events(spec: WorldSpec, final, pid: int) -> List[Dict]:
    """Per-BROKER federation lanes (hier/).

    One dedicated "hier-brokers" process whose threads are counter
    tracks ``broker{b} load`` — the strided per-tick per-broker domain
    load rows the telemetry fold keeps in
    ``TelemetryState.hier_load_res``, timestamped from the matching
    reservoir rows (the TP exchange-lane discipline).  Empty on
    single-broker (or telemetry-off) runs, so every existing trace is
    byte-identical.
    """
    from ..hier.federation import hier_summary

    hs = hier_summary(spec, final)
    if hs is None or "load_rows" not in hs or hs["load_rows"].size == 0:
        return []
    events: List[Dict] = []
    ts = _us(hs["load_rows_t"])
    for b in range(hs["n_brokers"]):
        events.extend(
            _counter(
                f"broker{b} load", pid, ts[i], "load",
                hs["load_rows"][i, b],
            )
            for i in range(len(ts))
        )
    events.append(
        {
            "name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": "hier-brokers"},
        }
    )
    return events


def _journey_events(spec: WorldSpec, final, pid: int) -> List[Dict]:
    """Causal task-journey lanes + Perfetto FLOW chains.

    One dedicated "journeys" process: tids ``0..B-1`` are broker lanes,
    ``B..B+F-1`` fog lanes.  Every decoded ring event becomes one
    slice on the lane of the entity handling it (the broker owning the
    task for spawn/decide/migrate/re-offload, the fog for
    enqueue/service/terminals), sized to the gap until the task's next
    event — and the events of one task are joined by flow events
    (``ph`` ``s``/``t``/``f`` with ``id`` = task id + 1), so Perfetto
    draws ONE connected arrow chain following the task through crash,
    re-offload, broker→broker migration and completion across lanes.
    Unlike the post-run span reconstruction above, these events come
    from the device-resident rings, so restamped columns cannot erase
    the intermediate history.  Empty on journey-off runs: every
    existing trace stays byte-identical.

    On a TP-stamped world (``spec.tp_shards > 1``) each
    sampled task's chain renders in its OWNING shard's process
    (``journeys-shard{k}``, one pid per shard above ``pid``) — the
    per-shard lanes of the sharded journey plane; unsharded runs keep
    the single byte-identical "journeys" process.
    """
    from .journeys import (
        BROKER_SIDE_EVENTS,
        JourneyEvent,
        decode_rings,
        journey_owner_shards,
    )

    if not spec.journey_active:
        return []
    decoded = decode_rings(spec, final)
    if not decoded:
        return []
    owners = journey_owner_shards(
        spec, [d["task"] for d in decoded]
    )
    B = max(1, spec.n_brokers)
    F = spec.n_fogs
    ub = (
        np.asarray(final.hier.user_broker, np.int64)
        if spec.hier_active
        else None
    )
    mig = int(JourneyEvent.MIGRATE)
    dfr = int(JourneyEvent.DEFER)
    events: List[Dict] = []
    used_tids = set()
    for d_i, d in enumerate(decoded):
        evs = d["events"]
        if not evs:
            continue
        task = d["task"]
        pid_d = pid if owners is None else pid + owners[d_i]
        cur_b = (
            int(ub[d["user"]])
            if ub is not None and d["user"] < len(ub)
            else 0
        )
        flow_id = task + 1  # Perfetto treats id 0 as unset
        ts_all = [e["t"] * 1e6 for e in evs]  # seconds -> trace us
        for i, e in enumerate(evs):
            code = e["code"]
            if code == dfr and e["b"] == 0:
                # broker-side wait (matured publish not yet decided):
                # the slice sits on the broker the task waits at
                tid = min(max(e["a"], 0), B - 1)
            elif code == dfr:
                # fog-side wait (matured arrival not yet seated —
                # K-window / exchange overflow): the target fog's lane
                tid = B + min(max(e["a"], 0), max(F - 1, 0))
            elif code in BROKER_SIDE_EVENTS:
                if code == mig:
                    # the hop slice sits on the SRC lane; later events
                    # land on the destination broker's lane
                    tid = e["a"] if e["a"] >= 0 else cur_b
                    cur_b = min(max(e["b"], 0), B - 1)
                elif code == int(JourneyEvent.DECIDE):
                    cur_b = min(max(e["b"], 0), B - 1)
                    tid = cur_b
                else:
                    tid = cur_b
                tid = min(max(int(tid), 0), B - 1)
            else:
                tid = B + min(max(e["a"], 0), max(F - 1, 0))
            used_tids.add((int(pid_d), int(tid)))
            ts = ts_all[i]
            dur = (
                max(ts_all[i + 1] - ts, 0.0) if i + 1 < len(evs) else 0.0
            )
            args = {"task": task, "a": e["a"], "b": e["b"]}
            events.append(
                {
                    "name": e["name"],
                    "ph": "X",
                    "pid": int(pid_d),
                    "tid": int(tid),
                    "ts": float(ts),
                    "dur": float(dur),
                    "cat": "journey",
                    "args": args,
                }
            )
            # the flow chain: s (first) -> t ... -> f (last), bound to
            # the enclosing slice just emitted on the same lane/ts; a
            # single-event chain gets NO flow (an "s" with no "f" is a
            # dangling Perfetto binding)
            if len(evs) < 2:
                continue
            ph = "s" if i == 0 else ("f" if i + 1 == len(evs) else "t")
            flow = {
                "name": f"journey{task}",
                "ph": ph,
                "id": int(flow_id),
                "pid": int(pid_d),
                "tid": int(tid),
                "ts": float(ts),
                "cat": "journey",
            }
            if ph != "s":
                flow["bp"] = "e"
            events.append(flow)
    if not events:
        return []
    pids = sorted({p for p, _ in used_tids})
    for p in pids:
        for b in range(B):
            if (p, b) in used_tids:
                events.append(
                    {
                        "name": "thread_name", "ph": "M", "pid": int(p),
                        "tid": b, "args": {"name": f"broker{b}"},
                    }
                )
        for f in range(F):
            if (p, B + f) in used_tids:
                events.append(
                    {
                        "name": "thread_name", "ph": "M", "pid": int(p),
                        "tid": B + f, "args": {"name": f"fog{f}"},
                    }
                )
        events.append(
            {
                "name": "process_name", "ph": "M", "pid": int(p),
                "args": {
                    "name": (
                        "journeys" if owners is None
                        else f"journeys-shard{p - pid}"
                    )
                },
            }
        )
    return events


def build_trace(
    spec: WorldSpec, final, max_tasks: Optional[int] = None
) -> Dict:
    """The trace-event dict for a finished run (single world or a
    replica batch: a leading replica axis on the task columns becomes
    one pid per replica)."""
    from ..runtime.recorder import to_host

    final = to_host(final)
    cols = {
        k: np.asarray(getattr(final.tasks, k))
        for k in (
            "stage", "fog", "mips_req", "t_create", "t_at_broker",
            "t_at_fog", "t_q_enter", "t_service_start", "t_complete",
            "t_ack6",
        )
    }
    batched = cols["stage"].ndim == 2
    n_rep = cols["stage"].shape[0] if batched else 1
    events: List[Dict] = []
    for r in range(n_rep):
        rep_cols = (
            {k: v[r] for k, v in cols.items()} if batched else cols
        )
        events.extend(
            _replica_events(spec, rep_cols, pid=r, max_tasks=max_tasks)
        )
    if not batched:
        # per-shard exchange lanes on TP runs (no-op everywhere else)
        events.extend(_tp_exchange_events(spec, final, pid=n_rep))
        # fog crash/recover lifecycle spans on chaos runs
        events.extend(_chaos_lifecycle_events(spec, final, pid=0))
        # per-broker federation load lanes on hier runs
        events.extend(_hier_broker_events(spec, final, pid=n_rep + 1))
        # causal journey lanes + flow chains on journey runs
        events.extend(_journey_events(spec, final, pid=n_rep + 2))
    # metadata first, then spans by (ts, -dur): a parent span sorts
    # before its children, and Perfetto/golden checks see monotone ts
    events.sort(
        key=lambda e: (
            0 if e["ph"] == "M" else 1,
            e.get("ts", 0.0),
            -e.get("dur", 0.0),
        )
    )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_trace(
    spec: WorldSpec,
    final,
    path: str,
    max_tasks: Optional[int] = None,
) -> str:
    """Write the Perfetto trace JSON for ``final`` to ``path``."""
    trace = build_trace(spec, final, max_tasks=max_tasks)
    # compact separators: pretty-printing roughly doubles the very
    # traces the --trace-max-tasks cap exists to keep loadable
    with open(path, "w") as f:
        json.dump(trace, f, separators=(",", ":"), allow_nan=False)
    return path
