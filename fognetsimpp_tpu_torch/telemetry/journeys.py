"""Causal task journeys: device-resident rings of sampled tasks' events.

Counterpart of ``fognetsimpp_tpu/telemetry/journeys.py``.
``spec.telemetry_journeys = J`` samples J task slots from the world key
(:func:`journey_sample_ids`: folded, never split, so the main stream is
untouched); each owns a ``(spec.telemetry_journey_ring, 4)`` int32 ring of
``(t_bits, code, a, b)`` rows in :class:`~.metrics.TelemetryState`, with a
cursor a slot and drop-oldest overflow counted in ``j_dropped``.  Once a
tick, after every task-writing phase, :func:`journey_tick` diffs each
sampled row against last tick's snapshot (``j_prev``) and appends one row
an edge: spawn, re-offload, migration, decide, defer, local run, enqueue,
service start, terminal.  Under TP :func:`journey_tick_tp` runs the same
diff on each shard for the slots whose rows it owns.

:func:`journey_edges` is one rule set over an array module: the tick
passes :data:`TORCH`, the host replay (:func:`replay_tick`) numpy.

The append writes each ring position at most once a tick: when more edges
fire than the ring holds, only the last ``R`` candidates are written (the
earlier ones would be overwritten within the tick, as JAX's in-order
scatter leaves them), so the scatter never has two writers of one row.
"""
from __future__ import annotations

import enum
from typing import Dict, List, Optional

import numpy as np
import torch

from ..f32math import bitcast
from ..ops.scatter import set_drop
from ..spec import Stage, WorldSpec
from .metrics import _np

#: Domain separator folded into the world key for the journey sample.
_JOURNEY_FOLD = 0x10A7

#: Columns of one packed per-task snapshot row (all i32; time columns are
#: f32 bit patterns).
J_COLS = (
    "stage",            # 0
    "fog",              # 1
    "broker",           # 2  hier task_broker (0 when hier off; -1 = init)
    "hops",             # 3  hier migration hop count
    "retry",            # 4  chaos re-offload count
    "t_create",         # 5
    "t_at_broker",      # 6
    "t_at_fog",         # 7
    "t_q_enter",        # 8
    "t_service_start",  # 9
    "t_complete",       # 10
)

#: f32 +inf bit pattern: every time column's "not yet stamped".
INF_BITS = int(np.float32(np.inf).view(np.int32))


class JourneyEvent(enum.IntEnum):
    """Lifecycle edge codes of a ring row (operands ``a``/``b``; -1 = none)."""

    SPAWN = 1          # a=user, b=send index k (slot = u*S + k)
    REOFFLOAD = 2      # chaos bounce: a=crashed fog, b=retry count
    MIGRATE = 3        # broker to broker hop: a=src broker, b=dst broker
    DECIDE = 4         # a=chosen fog, b=owning broker
    LOCAL_RUN = 5      # v1 broker-local accept: a=-1
    ENQUEUE = 6        # a=fog
    SVC_START = 7      # a=fog
    DONE = 8           # terminal: a=fog
    NO_RESOURCE = 9    # terminal: a=broker
    REJECTED = 10      # terminal: a=fog
    DROPPED = 11       # terminal: a=fog
    LOST = 12          # terminal: uplink or link loss, a=-1
    CRASH_LOST = 13    # terminal: LOSE-mode crash, a=crashed fog
    RETRY_EXHAUST = 14  # terminal: a=crashed fog, b=retry count
    HOP_EXHAUSTED = 15  # terminal: a=broker, b=hop count
    DEFER = 16         # matured but unseated this tick: a=broker (b=0) or fog (b=1)


EVENT_NAMES: Dict[int, str] = {int(e): e.name.lower() for e in JourneyEvent}

#: Codes that end a journey.
TERMINAL_EVENTS = frozenset(int(e) for e in (
    JourneyEvent.DONE, JourneyEvent.NO_RESOURCE, JourneyEvent.REJECTED,
    JourneyEvent.DROPPED, JourneyEvent.LOST, JourneyEvent.CRASH_LOST,
    JourneyEvent.RETRY_EXHAUST, JourneyEvent.HOP_EXHAUSTED,
))

#: Events handled at a broker; the rest belong to the handling fog.
BROKER_SIDE_EVENTS = frozenset(int(e) for e in (
    JourneyEvent.SPAWN, JourneyEvent.REOFFLOAD, JourneyEvent.MIGRATE,
    JourneyEvent.DECIDE, JourneyEvent.LOCAL_RUN, JourneyEvent.NO_RESOURCE,
    JourneyEvent.LOST, JourneyEvent.HOP_EXHAUSTED,
))


class _TorchXP:
    """The few array-module functions :func:`journey_edges` calls, on
    torch tensors (numpy scalars become Python ints)."""

    @staticmethod
    def _v(x):
        return int(x) if isinstance(x, np.generic) else x

    def full_like(self, x, v):
        v = self._v(v)
        if isinstance(v, torch.Tensor):
            return v.expand_as(x).clone()
        return torch.full_like(x, v)

    @staticmethod
    def zeros_like(x):
        return torch.zeros_like(x)

    def where(self, m, a, b):
        return torch.where(m, self._v(a), self._v(b))

    @staticmethod
    def stack(cols, axis=0):
        return torch.stack(cols, dim=axis)


#: The array module the device tap passes to :func:`journey_edges`.
TORCH = _TorchXP()


# ----------------------------------------------------------------------
# sampling and init (zero-row when the plane is off)
# ----------------------------------------------------------------------

def journey_sample_ids(spec: WorldSpec, key: torch.Tensor) -> torch.Tensor:
    """The J sampled task ids, sorted: ``choice(fold_in(key, 0x10A7), T,
    (J,), replace=False)``, a prefix of a sort-based shuffle
    (:func:`..random.permutation`)."""
    from ..random import choice, fold_in

    ids = choice(fold_in(key, _JOURNEY_FOLD), spec.task_capacity, (spec.journey_slots,))
    return torch.sort(ids.to(torch.int32)).values


def _init_prev_row() -> List[int]:
    """The snapshot before the first tick: UNUSED, no fog, owner unknown
    (-1), every time column +inf."""
    return [int(Stage.UNUSED), -1, -1, 0, 0] + [INF_BITS] * 6


def init_journey_leaves(
    spec: WorldSpec, key: Optional[torch.Tensor] = None, device=None
) -> Dict[str, torch.Tensor]:
    """The t=0 journey leaves (zero-row when off), on ``key``'s device
    (else ``device``)."""
    from ..device import resolve_device
    from ..random import PRNGKey

    J, R, NC = spec.journey_slots, spec.journey_ring, len(J_COLS)
    dev = key.device if key is not None else resolve_device(device)
    i32 = torch.int32
    if J:
        if key is None:
            key = PRNGKey(0, dev)
        j_task = journey_sample_ids(spec, key)
        row = torch.tensor(_init_prev_row(), dtype=i32, device=dev)
        j_prev = row[None, :].repeat(J, 1)
    else:
        j_task = torch.zeros((0,), dtype=i32, device=dev)
        j_prev = torch.zeros((0, NC), dtype=i32, device=dev)
    return dict(
        j_task=j_task,
        j_prev=j_prev,
        j_ring=torch.zeros((J, R, 4), dtype=i32, device=dev),
        j_cursor=torch.zeros((J,), dtype=i32, device=dev),
        j_dropped=torch.zeros((), dtype=i32, device=dev),
    )


# ----------------------------------------------------------------------
# the per-tick tap
# ----------------------------------------------------------------------

def snapshot_rows(spec: WorldSpec, tasks, chaos, hier, ids: torch.Tensor) -> torch.Tensor:
    """The sampled tasks' packed ``(J, len(J_COLS))`` int32 rows: J-sized
    gathers only, time columns as their exact f32 bits."""
    i32 = torch.int32
    J = ids.shape[0]
    ix = ids.long()

    def bits(col):
        return bitcast(col[ix].to(torch.float32), i32)

    zeros = torch.zeros((J,), dtype=i32, device=ids.device)
    if spec.hier_active:
        brk, hop = hier.task_broker[ix].to(i32), hier.hops[ix].to(i32)
    else:
        brk, hop = zeros, zeros
    rty = chaos.retry[ix].to(i32) if (spec.chaos and chaos.retry.shape[0]) else zeros
    return torch.stack([
        tasks.stage[ix].to(i32), tasks.fog[ix].to(i32), brk, hop, rty,
        bits(tasks.t_create), bits(tasks.t_at_broker), bits(tasks.t_at_fog),
        bits(tasks.t_q_enter), bits(tasks.t_service_start), bits(tasks.t_complete),
    ], dim=1)


def journey_edges(xp, prev, cur, users, sends, t1_bits):
    """This tick's lifecycle edges from two snapshots
    (``journeys.journey_edges``): five ``(J, 9)`` arrays ``(valid, code,
    t_bits, a, b)``, candidates in causal order (spawn, re-offload,
    migrate, decide, defer, local, enqueue, service start, terminal).
    ``xp`` is numpy or :data:`TORCH`.  Time columns compare as int32 bits,
    which order non-negative floats and put +inf above every finite
    ``t1``."""
    i32 = np.int32
    st_p, st_c = prev[:, 0], cur[:, 0]
    fog_p, fog_c = prev[:, 1], cur[:, 1]
    brk_p, brk_c = prev[:, 2], cur[:, 2]
    rty_c = cur[:, 4]
    tc, tb, tf = cur[:, 5], cur[:, 6], cur[:, 7]
    tq, ts, td = cur[:, 8], cur[:, 9], cur[:, 10]
    inf = i32(INF_BITS)
    neg1 = xp.full_like(st_c, i32(-1))
    zero = xp.zeros_like(st_c)

    def st(v):
        return i32(int(v))

    spawn = (st_p == st(Stage.UNUSED)) & (st_c != st(Stage.UNUSED))
    rty_delta = rty_c > prev[:, 4]
    reoff = rty_delta & (st_c != st(Stage.LOST))
    mig = cur[:, 3] > prev[:, 3]
    decide = (fog_c >= 0) & ((fog_c != fog_p) | (tf != prev[:, 7]))
    local = (st_c == st(Stage.LOCAL_RUN)) & (st_p != st(Stage.LOCAL_RUN))
    enq = (tq != prev[:, 8]) & (tq != inf)
    svc = (ts != prev[:, 9]) & (ts != inf)
    defer_b = (st_c == st(Stage.PUB_INFLIGHT)) & (tb <= t1_bits)
    defer_f = (st_c == st(Stage.TASK_INFLIGHT)) & (tf <= t1_bits)
    defer = defer_b | defer_f
    changed = st_c != st_p
    was_on_fog = (
        (st_p == st(Stage.TASK_INFLIGHT))
        | (st_p == st(Stage.QUEUED))
        | (st_p == st(Stage.RUNNING))
    )
    lost = changed & (st_c == st(Stage.LOST))
    is_done = changed & (st_c == st(Stage.DONE))
    is_nores = changed & (st_c == st(Stage.NO_RESOURCE))
    is_rej = changed & (st_c == st(Stage.REJECTED))
    is_drop = changed & (st_c == st(Stage.DROPPED))
    is_hopx = changed & (st_c == st(Stage.HOP_EXHAUSTED))
    is_retryx = lost & rty_delta
    is_crash = lost & ~rty_delta & was_on_fog
    term = is_done | is_nores | is_rej | is_drop | is_hopx | lost

    def sel(pairs, default):
        out = default
        for mask, val in reversed(pairs):
            out = xp.where(mask, val, out)
        return out

    ev = JourneyEvent
    term_code = sel(
        [
            (is_done, i32(int(ev.DONE))),
            (is_nores, i32(int(ev.NO_RESOURCE))),
            (is_rej, i32(int(ev.REJECTED))),
            (is_drop, i32(int(ev.DROPPED))),
            (is_hopx, i32(int(ev.HOP_EXHAUSTED))),
            (is_retryx, i32(int(ev.RETRY_EXHAUST))),
            (is_crash, i32(int(ev.CRASH_LOST))),
        ],
        xp.full_like(st_c, i32(int(ev.LOST))),
    )
    tf_or_tb = xp.where(tf != inf, tf, tb)
    term_t = sel(
        [
            (is_done, td),
            (is_nores | is_hopx, tb),
            (is_rej | is_drop, tf_or_tb),
            # crash edges carry no time column: the observing tick's end
            (is_retryx | is_crash, xp.full_like(st_c, t1_bits)),
        ],
        tc,
    )
    term_a = sel(
        [
            (is_done | is_rej | is_drop | is_retryx | is_crash, fog_c),
            (is_nores | is_hopx, brk_c),
        ],
        neg1,
    )
    term_b = sel([(is_hopx, cur[:, 3]), (is_retryx, rty_c)], zero)

    t1_full = xp.full_like(st_c, t1_bits)
    defer_a = xp.where(defer_f, fog_c, brk_c)
    defer_bb = xp.where(defer_f, xp.full_like(st_c, i32(1)), zero)

    def stack(cols):
        return xp.stack(cols, axis=1)

    valid = stack([spawn, reoff, mig, decide, defer, local, enq, svc, term])
    code = stack([
        xp.full_like(st_c, i32(int(ev.SPAWN))),
        xp.full_like(st_c, i32(int(ev.REOFFLOAD))),
        xp.full_like(st_c, i32(int(ev.MIGRATE))),
        xp.full_like(st_c, i32(int(ev.DECIDE))),
        xp.full_like(st_c, i32(int(ev.DEFER))),
        xp.full_like(st_c, i32(int(ev.LOCAL_RUN))),
        xp.full_like(st_c, i32(int(ev.ENQUEUE))),
        xp.full_like(st_c, i32(int(ev.SVC_START))),
        term_code,
    ])
    t_bits = stack([tc, tb, tb, tb, t1_full, tb, tq, ts, term_t])
    a = stack([users, fog_p, brk_p, fog_c, defer_a, neg1, fog_c, fog_c, term_a])
    b = stack([sends, rty_c, brk_c, brk_c, defer_bb, zero, zero, zero, term_b])
    return valid, code, t_bits, a, b


def _t1_bits(t1: torch.Tensor) -> torch.Tensor:
    return bitcast(t1.to(torch.float32), torch.int32)


def journey_tick(spec: WorldSpec, telem, tasks, t1: torch.Tensor, chaos=None, hier=None):
    """Fold one finished tick into the rings (``journeys.journey_tick``)."""
    S = spec.max_sends_per_user
    ids = telem.j_task
    cur = snapshot_rows(spec, tasks, chaos, hier, ids)
    valid, code, t_bits, a, b = journey_edges(
        TORCH, telem.j_prev, cur, ids // S, ids % S, _t1_bits(t1)
    )
    telem, over = _append_edges(telem, cur, valid, code, t_bits, a, b)
    return telem.replace(j_dropped=telem.j_dropped + over)


def _append_edges(telem, cur, valid, code, t_bits, a, b):
    """Append one tick's candidates to the rings; ``(telem', over)`` with
    ``j_prev``, ``j_ring`` and ``j_cursor`` advanced and ``over`` the
    tick's overwrite count (the caller owns ``j_dropped``)."""
    J, R = telem.j_task.shape[0], telem.j_ring.shape[1]
    i32 = torch.int32
    vi = valid.to(i32)
    off = torch.cumsum(vi, dim=1, dtype=i32) - 1
    n_new = vi.sum(dim=1, dtype=i32)
    pos = (telem.j_cursor[:, None] + torch.clamp_min(off, 0)) % R
    # the last R candidates of a slot only: an earlier one shares its
    # position with a later one and would be overwritten this tick
    write = valid & (off + R >= n_new[:, None])
    slot = torch.arange(J, dtype=i32, device=cur.device)[:, None]
    flat = torch.where(write, slot * R + pos, J * R).reshape(-1)
    rows = torch.stack([t_bits, code, a, b], dim=-1).to(i32).reshape(-1, 4)
    ring = set_drop(telem.j_ring.reshape(J * R, 4), flat, rows).reshape(J, R, 4)
    cursor = telem.j_cursor + n_new
    over = (
        torch.clamp_min(cursor - R, 0) - torch.clamp_min(telem.j_cursor - R, 0)
    ).sum(dtype=i32)
    return telem.replace(j_prev=cur, j_ring=ring, j_cursor=cursor), over


def journey_tick_tp(spec_local: WorldSpec, telem, tasks, t1: torch.Tensor, t_off: int):
    """The shard-local TP tap (``journeys.journey_tick_tp``): each shard
    diffs the sampled slots whose rows it owns (``[t_off, t_off + T_loc)``),
    holds every other slot's snapshot and masks its candidates.  Returns
    ``(telem', over)``: ``over`` is this shard's overwrite count for the
    end-of-tick sum; ``j_dropped`` is not touched here."""
    S = spec_local.max_sends_per_user
    T_loc = spec_local.task_capacity
    ids = telem.j_task
    loc = ids - t_off
    owned = (loc >= 0) & (loc < T_loc)
    safe = torch.clamp(loc, 0, T_loc - 1)
    cur = snapshot_rows(spec_local, tasks, None, None, safe)
    cur = torch.where(owned[:, None], cur, telem.j_prev)
    valid, code, t_bits, a, b = journey_edges(
        TORCH, telem.j_prev, cur, ids // S, ids % S, _t1_bits(t1)
    )
    valid = valid & owned[:, None]
    return _append_edges(telem, cur, valid, code, t_bits, a, b)


# ----------------------------------------------------------------------
# host replay (numpy) and readers
# ----------------------------------------------------------------------

def replay_tick(spec: WorldSpec, prev, cur, ids, t1: float) -> List[List[Dict]]:
    """Host twin of one :func:`journey_tick` diff: per slot, this tick's
    events in append order, from the same :func:`journey_edges`."""
    S = spec.max_sends_per_user
    ids = _np(ids).astype(np.int64)
    t1_bits = int(np.float32(t1).view(np.int32))
    valid, code, t_bits, a, b = journey_edges(
        np, _np(prev).astype(np.int32), _np(cur).astype(np.int32),
        (ids // S).astype(np.int32), (ids % S).astype(np.int32), np.int32(t1_bits),
    )
    out: List[List[Dict]] = []
    for j in range(valid.shape[0]):
        out.append([
            _event_dict(int(t_bits[j, e]), int(code[j, e]), int(a[j, e]), int(b[j, e]))
            for e in range(valid.shape[1]) if valid[j, e]
        ])
    return out


def _bits_to_time(bits: int) -> float:
    return float(np.int32(bits).view(np.float32))


def _event_dict(t_bits: int, code: int, a: int, b: int) -> Dict:
    return {
        "t": _bits_to_time(t_bits),
        "code": int(code),
        "name": EVENT_NAMES.get(int(code), f"code{code}"),
        "a": int(a),
        "b": int(b),
    }


def _ring_order(n: int, R: int):
    """Ring rows in append order: ``n`` rows, or the last ``R`` from the
    oldest kept one (at ``n % R``) once the cursor wrapped."""
    return range(n) if n <= R else ((n + k) % R for k in range(R))


def decode_rings(spec: WorldSpec, final) -> List[Dict]:
    """Every sampled task's ring as its event list, in append order."""
    t = final.telem
    J = t.j_task.shape[0]
    if J == 0:
        return []
    ids = _np(t.j_task).astype(np.int64)
    cursor = _np(t.j_cursor).astype(np.int64)
    ring = _np(t.j_ring).astype(np.int64)
    R = ring.shape[1]
    S = spec.max_sends_per_user
    out = []
    for j in range(J):
        n = int(cursor[j])
        out.append({
            "task": int(ids[j]),
            "user": int(ids[j]) // S,
            "send": int(ids[j]) % S,
            "events_total": n,
            "dropped": max(0, n - R),
            "events": [_event_dict(*(int(x) for x in ring[j, k])) for k in _ring_order(n, R)],
        })
    return out


def journey_summary(spec: WorldSpec, final) -> Optional[Dict]:
    """Host roll-up of a journey-on run (None when off): totals, the
    terminal census, in-flight and unspawned counts, the decoded rings."""
    if not spec.journey_active:
        return None
    t = final.telem
    if t.j_task.shape[0] == 0:
        return None
    decoded = decode_rings(spec, final)
    terminal: Dict[str, int] = {}
    in_flight = untouched = 0
    for d in decoded:
        if not d["events"]:
            untouched += 1
            continue
        last = d["events"][-1]
        if last["code"] in TERMINAL_EVENTS:
            terminal[last["name"]] = terminal.get(last["name"], 0) + 1
        else:
            in_flight += 1
    return {
        "sampled": len(decoded),
        "ring": int(spec.journey_ring),
        "events_total": int(_np(t.j_cursor).sum()),
        "dropped_total": int(_np(t.j_dropped)),
        "terminal": dict(sorted(terminal.items())),
        "in_flight": in_flight,
        "unspawned": untouched,
        "tasks": decoded,
    }


def journey_owner_shards(spec: WorldSpec, ids) -> Optional[List[int]]:
    """The TP shard owning each sampled global slot, or None unsharded."""
    n = getattr(spec, "tp_shards", 0)
    if n <= 1:
        return None
    t_loc = spec.task_capacity // n
    return [int(i) // t_loc for i in _np(ids).astype(np.int64)]


def snapshot_rings(final, spec: Optional[WorldSpec] = None) -> Optional[Dict]:
    """JSON-safe raw rings and cursors (with each slot's owning shard on a
    stamped TP world), readable by :func:`rings_from_snapshot`."""
    t = getattr(final, "telem", None)
    if t is None or t.j_task.shape[0] == 0:
        return None
    snap = {
        "task": [int(x) for x in _np(t.j_task)],
        "cursor": [int(x) for x in _np(t.j_cursor)],
        "dropped": int(_np(t.j_dropped)),
        "ring": _np(t.j_ring).astype(np.int64).tolist(),
    }
    if spec is not None:
        owners = journey_owner_shards(spec, t.j_task)
        if owners is not None:
            snap["shard"] = owners
    return snap


def rings_from_snapshot(snap: Dict) -> List[Dict]:
    """Decode a :func:`snapshot_rings` bundle."""
    out = []
    tasks = snap.get("task") or []
    cursor = snap.get("cursor") or []
    ring = snap.get("ring") or []
    for j, task in enumerate(tasks):
        n = int(cursor[j]) if j < len(cursor) else 0
        rows = ring[j] if j < len(ring) else []
        R = len(rows)
        out.append({
            "task": int(task),
            "events_total": n,
            "dropped": max(0, n - R) if R else n,
            "events": [_event_dict(*(int(x) for x in rows[k])) for k in _ring_order(n, R)],
        })
    return out
