"""Plane 1: device-resident per-phase and per-fog metrics on the carry.

Counterpart of ``fognetsimpp_tpu/telemetry/metrics.py``.
:class:`TelemetryState` rides :class:`~..state.WorldState` next to
``LearnState``: with ``spec.telemetry`` off every array leaf has zero rows
and the scalar counters are never written, so telemetry-off worlds carry
nothing and stay bit for bit as they were.

Everything accumulates on the device inside the tick: the engine's
``_phase_telemetry`` calls :func:`accumulate_tick` once a tick and the TP
tick adds :func:`accumulate_exchange`; the host readers fetch once, after
the run or at a chunk boundary.  The reservoir is a strided sample of the
run (``spec.telemetry_slots`` rows for the whole horizon), written with the
drop-scatter of :mod:`..ops.scatter`, so it holds under ``vmap``.

Per-phase work: the engine brackets every phase call with
:func:`tick_activity` (the sum of every ``Metrics`` counter and the tick's
message buffers) and books the delta to that phase's :data:`PHASES` slot.
The sums are int32 and wrap, as JAX's do; a delta is exact modulo 2^32
whatever order the adds take.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..f32math import const, kept_tensor
from ..ops.scatter import set_drop
from ..spec import FogModel, WorldSpec
from ..struct import Struct, register_pytree

#: Engine phase slots of the ``phase_work`` counter vector, in the JAX
#: package's order: the TP exchange slots, chaos and the broker migration
#: were appended after the rest, so their index is not their place in the
#: tick (chaos runs first, the migration right after spawn).
PHASES = (
    "connect",
    "adverts",
    "spawn",
    "v2_release_pre",
    "broker",
    "v2_release_post",
    "pool_completions",
    "pool_arrivals",
    "completions",
    "fog_arrivals",
    "local_completions",
    "learn_credit",
    "latency_hist",
    "tp_exchange",  # candidate slots seated in the TP exchange window
    "tp_defer",  # candidates deferred at the exchange window
    "chaos",  # fog lifecycle edges, the in-flight sweep, re-offloads
    "broker_migrate",  # broker to broker migration
)
PHASE_INDEX: Dict[str, int] = {name: i for i, name in enumerate(PHASES)}

#: Columns of one reservoir row (all f32).  ``n_dropped``,
#: ``defer_total`` and ``lost_crash_total`` are cumulative, so a reader
#: takes rates from consecutive rows; ``n_fogs_down`` is a gauge.
RES_FIELDS = (
    "t", "q_len_total", "n_busy", "n_deferred", "n_completed", "n_dropped",
    "defer_total", "n_fogs_down", "lost_crash_total",
)

#: Finite upper bucket edges of the per-shard exchange-window occupancy
#: histogram (candidates contending for the window over its slots; past
#: 1.0 the window overflows and defers).  The last bucket is +Inf.
EXG_OCC_EDGES = (0.25, 0.5, 0.75, 0.9, 1.0)
EXG_OCC_BINS = len(EXG_OCC_EDGES) + 1


@register_pytree
@dataclasses.dataclass
class TelemetryState(Struct):
    """Carry-resident telemetry accumulators (one per world or replica).

    Array leaves are sized ``spec.telemetry_fogs`` /
    ``telemetry_phases`` / ``telemetry_slots`` and the histogram, TP,
    hierarchy and journey sizes of the spec: the real dimensions when the
    plane is on, zero rows otherwise.
    """

    ticks: torch.Tensor  # () i32 ticks accumulated
    defer_sum: torch.Tensor  # () i32 sum of the per-tick deferred gauge
    q_len_sum: torch.Tensor  # (Fm,) f32 per-fog queue-depth sum
    q_len_max: torch.Tensor  # (Fm,) i32 per-fog queue-depth running max
    q_len_min: torch.Tensor  # (Fm,) i32 per-fog queue-depth running min
    busy_ticks: torch.Tensor  # (Fm,) i32 ticks the fog server was busy
    pool_occ_sum: torch.Tensor  # (Fm,) f32 POOL occupancy-fraction sum
    pick_hist: torch.Tensor  # (Fm,) f32 copy of LearnState.pick_count
    phase_work: torch.Tensor  # (Pm,) i32 per-phase work counters
    res: torch.Tensor  # (Rm, len(RES_FIELDS)) f32 strided per-tick rows
    lat_hist: torch.Tensor  # (Fh, Bh) i32 per-fog latency bucket counts
    lat_sum: torch.Tensor  # (Fh,) f32 per-fog latency sum (seconds)
    lat_seen: torch.Tensor  # (Th,) i8 per-task counted flag
    exg_occ_hist: torch.Tensor  # (Sm, EXG_OCC_BINS) i32 occupancy histogram
    exg_occ_sum: torch.Tensor  # (Sm,) f32 occupancy-fraction sum
    exg_cand_sum: torch.Tensor  # (Sm,) i32 arrival candidates produced
    exg_defer_sum: torch.Tensor  # (Sm,) i32 candidates deferred
    exg_defer_max: torch.Tensor  # (Sm,) i32 most deferred in one tick
    exg_util_sum: torch.Tensor  # (Sm,) f32 seated / window slots, summed
    exg_age_max: torch.Tensor  # (Sm,) f32 oldest deferred candidate, ticks
    exg_occ_res: torch.Tensor  # (Rm, Sm) f32 strided occupancy rows
    hier_load_sum: torch.Tensor  # (Bm,) f32 per-broker busy-fraction sum
    hier_load_res: torch.Tensor  # (Rm, Bm) f32 strided per-broker rows
    j_task: torch.Tensor  # (Jm,) i32 sampled task ids, sorted
    j_prev: torch.Tensor  # (Jm, len(J_COLS)) i32 last tick's snapshot
    j_ring: torch.Tensor  # (Jm, Rj, 4) i32 (t_bits, code, a, b) events
    j_cursor: torch.Tensor  # (Jm,) i32 events appended per slot
    j_dropped: torch.Tensor  # () i32 ring rows overwritten


def _full(shape, v, dtype, dev) -> torch.Tensor:
    return torch.full(shape, v, dtype=dtype, device=dev)


def init_telemetry_state(
    spec: WorldSpec, key: Optional[torch.Tensor] = None, device=None
) -> TelemetryState:
    """The t=0 telemetry state for ``spec`` (zero-row when off), on the
    device of ``key`` (else ``device``).

    ``key`` is the world key: the journey plane draws its task sample from
    it (folded, never split: :func:`.journeys.journey_sample_ids`); it is
    read only when ``spec.journey_active``.
    """
    from ..device import resolve_device
    from .journeys import init_journey_leaves

    dev = key.device if key is not None else resolve_device(device)
    Fm, Pm, Rm = spec.telemetry_fogs, spec.telemetry_phases, spec.telemetry_slots
    f32, i32 = torch.float32, torch.int32
    return TelemetryState(
        ticks=_full((), 0, i32, dev),
        defer_sum=_full((), 0, i32, dev),
        q_len_sum=_full((Fm,), 0.0, f32, dev),
        q_len_max=_full((Fm,), 0, i32, dev),
        q_len_min=_full((Fm,), spec.queue_capacity, i32, dev),
        busy_ticks=_full((Fm,), 0, i32, dev),
        pool_occ_sum=_full((Fm,), 0.0, f32, dev),
        pick_hist=_full((Fm,), 0.0, f32, dev),
        phase_work=_full((Pm,), 0, i32, dev),
        res=_full((Rm, len(RES_FIELDS)), 0.0, f32, dev),
        lat_hist=_full(
            (spec.telemetry_hist_fogs, spec.telemetry_hist_nbins), 0, i32, dev
        ),
        lat_sum=_full((spec.telemetry_hist_fogs,), 0.0, f32, dev),
        lat_seen=_full((spec.telemetry_hist_tasks,), 0, torch.int8, dev),
        **init_exchange_leaves(spec, dev),
        **init_hier_leaves(spec, dev),
        **init_journey_leaves(spec, key, dev),
    )


def init_hier_leaves(spec: WorldSpec, device) -> Dict[str, torch.Tensor]:
    """The t=0 hierarchy load leaves (zero-row unless the spec is a
    telemetry-on federated world)."""
    Bm = spec.telemetry_hier_brokers
    Rm = spec.telemetry_slots if Bm else 0
    return dict(
        hier_load_sum=_full((Bm,), 0.0, torch.float32, device),
        hier_load_res=_full((Rm, Bm), 0.0, torch.float32, device),
    )


def init_exchange_leaves(spec: WorldSpec, device) -> Dict[str, torch.Tensor]:
    """The t=0 TP exchange-plane leaves (zero-row unless the spec is a
    telemetry-on TP world view, ``spec.telemetry_tp_shards > 0``).  The TP
    runner re-sizes a world's leaves with it when it stamps the shards."""
    Sm = spec.telemetry_tp_shards
    Rm = spec.telemetry_slots if Sm else 0
    f32, i32 = torch.float32, torch.int32
    return dict(
        exg_occ_hist=_full((Sm, EXG_OCC_BINS), 0, i32, device),
        exg_occ_sum=_full((Sm,), 0.0, f32, device),
        exg_cand_sum=_full((Sm,), 0, i32, device),
        exg_defer_sum=_full((Sm,), 0, i32, device),
        exg_defer_max=_full((Sm,), 0, i32, device),
        exg_util_sum=_full((Sm,), 0.0, f32, device),
        exg_age_max=_full((Sm,), 0.0, f32, device),
        exg_occ_res=_full((Rm, Sm), 0.0, f32, device),
    )


def _counters(metrics) -> list:
    return [getattr(metrics, f.name).reshape(1) for f in dataclasses.fields(metrics)]


def metrics_activity(metrics) -> torch.Tensor:
    """The int32 sum of every ``Metrics`` counter (wrapping, as JAX's)."""
    return torch.cat(_counters(metrics)).sum(dtype=torch.int32)


def tick_activity(metrics, buf) -> torch.Tensor:
    """The phase bracket: the int32 sum of every ``Metrics`` counter and
    every entry of the tick's message buffers (``engine.TickBuf``).  One
    concatenation and one reduction, whatever the number of leaves."""
    leaves = _counters(metrics) + [leaf.reshape(-1) for leaf in buf]
    return torch.cat(leaves).sum(dtype=torch.int32)


def _strided_slot(spec: WorldSpec, tick: torch.Tensor, rows: int) -> torch.Tensor:
    """(1,) row of a strided reservoir that ``tick`` writes, or ``rows``
    (dropped) on a tick between strides."""
    stride = max(1, -(-spec.n_ticks // rows))
    t = tick.to(torch.int32)
    return torch.where(t % stride == 0, t // stride, rows).reshape(1)


def accumulate_tick(
    spec: WorldSpec,
    telem: TelemetryState,
    fogs,
    learn,
    metrics,
    tick: torch.Tensor,
    t1: torch.Tensor,
    phase_work=None,
    chaos=None,
    fogs_down: Optional[torch.Tensor] = None,
    hier_load: Optional[torch.Tensor] = None,
) -> TelemetryState:
    """Fold one finished tick into the accumulators
    (``metrics.accumulate_tick``).  ``phase_work``: the tick's per-phase
    deltas as one ``(len(PHASES),)`` int32 vector (JAX passes them as a
    ``{slot: delta}`` dict)."""
    from ..ops.queues import NO_TASK

    f32, i32 = torch.float32, torch.int32
    dev = telem.ticks.device
    q = fogs.q_len.to(i32)
    if spec.fog_model == int(FogModel.POOL):
        occ = torch.clamp(
            (fogs.mips - fogs.pool_avail)
            / torch.maximum(fogs.mips, const(1e-9, dev)),
            0.0, 1.0,
        )
        busy = fogs.pool_avail < fogs.mips
    else:
        busy = fogs.current_task != NO_TASK
        occ = busy.to(f32)
    busy_i = busy.to(i32)
    defer_sum = telem.defer_sum + metrics.n_deferred
    telem = telem.replace(
        ticks=telem.ticks + 1,
        defer_sum=defer_sum,
        q_len_sum=telem.q_len_sum + q.to(f32),
        q_len_max=torch.maximum(telem.q_len_max, q),
        q_len_min=torch.minimum(telem.q_len_min, q),
        busy_ticks=telem.busy_ticks + busy_i,
        pool_occ_sum=telem.pool_occ_sum + occ,
    )
    if spec.learn_active:
        telem = telem.replace(pick_hist=learn.pick_count)
    if hier_load is not None:
        telem = telem.replace(hier_load_sum=telem.hier_load_sum + hier_load)
        Rh = telem.hier_load_res.shape[-2]
        if Rh > 0:
            telem = telem.replace(
                hier_load_res=set_drop(
                    telem.hier_load_res, _strided_slot(spec, tick, Rh),
                    hier_load[None],
                )
            )
    if phase_work is not None:
        telem = telem.replace(phase_work=telem.phase_work + phase_work)
    R = telem.res.shape[-2]
    if R > 0:
        zero = torch.zeros((), dtype=f32, device=dev)
        down_now = fogs_down.to(f32) if fogs_down is not None else zero
        lost_tot = (
            (chaos.n_lost_crash + chaos.n_retry_exhausted).to(f32)
            if chaos is not None else zero
        )
        ints = torch.stack([
            q.sum(dtype=i32), busy_i.sum(dtype=i32), metrics.n_deferred,
            metrics.n_completed, metrics.n_dropped, defer_sum,
        ]).to(f32)
        row = torch.cat([
            t1.to(f32).reshape(1), ints, down_now.reshape(1), lost_tot.reshape(1),
        ])
        telem = telem.replace(
            res=set_drop(telem.res, _strided_slot(spec, tick, R), row[None])
        )
    return telem


def accumulate_exchange(
    spec: WorldSpec,
    telem: TelemetryState,
    occ: torch.Tensor,
    util: torch.Tensor,
    age: torch.Tensor,
    cand: torch.Tensor,
    defer: torch.Tensor,
    tick: torch.Tensor,
) -> TelemetryState:
    """Fold one tick's per-shard exchange vectors, each ``(S,)`` f32 and
    the same on every shard (``metrics.accumulate_exchange``).  ``cand``
    and ``defer`` are integer-valued below 2^24 and cast back exactly."""
    i32 = torch.int32
    edges = kept_tensor(EXG_OCC_EDGES, torch.float32, occ.device)
    # first bucket whose edge >= occ, the histogram's cumulative `le`
    b = torch.searchsorted(edges, occ).to(i32)
    bins = torch.arange(EXG_OCC_BINS, dtype=i32, device=occ.device)
    onehot = (b[:, None] == bins[None, :]).to(i32)
    telem = telem.replace(
        exg_occ_hist=telem.exg_occ_hist + onehot,
        exg_occ_sum=telem.exg_occ_sum + occ,
        exg_cand_sum=telem.exg_cand_sum + cand.to(i32),
        exg_defer_sum=telem.exg_defer_sum + defer.to(i32),
        exg_defer_max=torch.maximum(telem.exg_defer_max, defer.to(i32)),
        exg_util_sum=telem.exg_util_sum + util,
        exg_age_max=torch.maximum(telem.exg_age_max, age),
    )
    Rm = telem.exg_occ_res.shape[0]
    if Rm > 0:
        telem = telem.replace(
            exg_occ_res=set_drop(
                telem.exg_occ_res, _strided_slot(spec, tick, Rm), occ[None]
            )
        )
    return telem


# ----------------------------------------------------------------------
# host readers (after a run or at a chunk boundary; one fetch each)
# ----------------------------------------------------------------------

def _np(x, dtype=None) -> np.ndarray:
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a if dtype is None else a.astype(dtype)


def reservoir_progress(
    spec: WorldSpec, telem: TelemetryState, ticks_done: int, start_row: int = 0,
) -> tuple:
    """``({field: host rows [start_row:filled]}, filled)``: the reservoir
    rows complete after ``ticks_done`` ticks that were not read before
    (``run_chunked``'s ``telemetry_stream`` reads each chunk's)."""
    R = telem.res.shape[0]
    if R == 0 or ticks_done <= 0:
        return {f: np.zeros((0,)) for f in RES_FIELDS}, start_row
    stride = max(1, -(-spec.n_ticks // R))
    filled = min(R, -(-ticks_done // stride))
    rows = _np(telem.res[start_row:filled])
    return {f: rows[:, i] for i, f in enumerate(RES_FIELDS)}, max(filled, start_row)


def busy_fractions(spec: WorldSpec, final) -> Optional[np.ndarray]:
    """Per-fog busy fraction (busy ticks / ticks), or None with the plane
    off."""
    if not spec.telemetry:
        return None
    ticks = max(int(_np(final.telem.ticks)), 1)
    return _np(final.telem.busy_ticks, np.float64) / ticks


def exchange_summary(spec: WorldSpec, final) -> Optional[Dict]:
    """Host roll-up of the per-shard TP exchange plane, or None unless the
    state carries stamped exchange leaves."""
    if not spec.telemetry or spec.telemetry_tp_shards == 0:
        return None
    t = final.telem
    S = t.exg_cand_sum.shape[0]
    if S == 0:
        return None
    ticks = max(int(_np(t.ticks)), 1)
    res = _np(t.res, np.float64)
    occ_res = _np(t.exg_occ_res, np.float64)
    Rm = occ_res.shape[0]
    stride = max(1, -(-spec.n_ticks // Rm)) if Rm else 1
    n_rows = min(Rm, -(-ticks // stride)) if Rm else 0
    return {
        "n_shards": S,
        "ticks": ticks,
        "occ_edges": list(EXG_OCC_EDGES),
        "occ_hist": _np(t.exg_occ_hist, np.int64),
        "occ_sum": _np(t.exg_occ_sum, np.float64),
        "occ_mean": _np(t.exg_occ_sum, np.float64) / ticks,
        "cand": _np(t.exg_cand_sum, np.int64),
        "defer_sum": _np(t.exg_defer_sum, np.int64),
        "defer_max": _np(t.exg_defer_max, np.int64),
        "util_mean": _np(t.exg_util_sum, np.float64) / ticks,
        "age_max_ticks": _np(t.exg_age_max, np.float64),
        "occ_rows": occ_res[:n_rows],
        "occ_rows_t": res[:n_rows, 0] if n_rows else np.zeros((0,)),
    }


def telemetry_summary(spec: WorldSpec, final) -> Optional[Dict]:
    """Host roll-up of a finished telemetry-on run (None when off): per-fog
    busy fraction and queue depths, pool occupancy, the pick histogram,
    the named phase-work counters, the reservoir and the TP exchange."""
    if not spec.telemetry:
        return None
    t = final.telem
    ticks = max(int(_np(t.ticks)), 1)
    res = _np(t.res, np.float64)
    Rm = res.shape[0]
    stride = max(1, -(-spec.n_ticks // Rm)) if Rm else 1
    n_rows = min(Rm, -(-ticks // stride))
    pw = _np(t.phase_work)
    return {
        "ticks": ticks,
        "defer_sum": int(_np(t.defer_sum)),
        "busy_frac": busy_fractions(spec, final),
        "q_len_mean": _np(t.q_len_sum, np.float64) / ticks,
        "q_len_max": _np(t.q_len_max, np.int64),
        "q_len_min": _np(t.q_len_min, np.int64),
        "pool_occ_mean": _np(t.pool_occ_sum, np.float64) / ticks,
        "pick_hist": _np(t.pick_hist, np.float64),
        "phase_work": {name: int(pw[i]) for i, name in enumerate(PHASES)},
        "reservoir": {f: res[:n_rows, i] for i, f in enumerate(RES_FIELDS)},
        "tp_exchange": exchange_summary(spec, final),
    }
