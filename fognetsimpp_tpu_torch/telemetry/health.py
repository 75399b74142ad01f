"""Live health plane, device half: the streaming latency histogram.

Counterpart of ``fognetsimpp_tpu/telemetry/health.py``.  The ``task_time``
signal (publish to the status-6 ack) streams into a per-fog histogram of
log-spaced buckets in :class:`~.metrics.TelemetryState` (zero rows unless
``spec.telemetry_hist``), once a tick, from ``core/engine._phase_latency_hist``
and from the TP tick's fold.  A persistent per-task ``lat_seen`` flag makes
it exactly-once under any completion backlog.

The bucket counts are integer sums, the same in any order.  The per-fog
latency sum is a float32 scatter-add whose bits follow the order of its
adds: XLA adds in task order, and so does
:func:`..ops.cell_kernels.cell_sum_ordered` (``csrc/cell_sum.cu`` on the
card), which takes the rows that are not due at cell -1, dropped.  JAX adds
+0.0 for them instead; a due latency ``t_ack6 - t_create`` is never -0.0,
so the two sums have the same bits.  In the single-device tick the adds
start from the running sum (:func:`accumulate_latency`), in the TP tick's
per-shard deltas from +0.0 (:func:`latency_hist_delta`).

Host half: :func:`hist_summary` is the one source of the p50/p95/p99
quantiles; :func:`slo_breach_count` reads the same buckets;
:func:`state_hash`, :func:`shard_state_hashes` and :func:`find_nonfinite`
fingerprint a state for the flight recorder.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.cell_kernels import cell_sum_ordered
from ..f32math import kept_tensor
from ..spec import Stage, WorldSpec
from .metrics import _np

#: Quantiles the health plane derives and exposes.
QUANTILES = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))

_ST_DONE = int(Stage.DONE)


def hist_edges_s(spec: WorldSpec) -> np.ndarray:
    """The histogram's ``B - 1`` finite bucket upper edges in seconds,
    log-spaced from ``telemetry_hist_min_ms`` to ``telemetry_hist_max_ms``
    (float32); bucket ``B - 1`` is the +Inf overflow."""
    B = spec.telemetry_hist_bins
    return np.geomspace(
        spec.telemetry_hist_min_ms * 1e-3, spec.telemetry_hist_max_ms * 1e-3, B - 1,
    ).astype(np.float32)


def _due(spec: WorldSpec, telem, tasks, t1: torch.Tensor):
    """``(due, lat, bucket)``: the rows this tick streams (DONE, ran on a
    fog, status-6 ack landed by ``t1``, flag clear), every row's latency
    and its bucket, the first edge >= the latency."""
    dev = tasks.fog.device
    edges = kept_tensor(tuple(float(e) for e in hist_edges_s(spec)), torch.float32, dev)
    due = (
        (tasks.stage == _ST_DONE)
        & (tasks.fog >= 0)
        & (tasks.t_ack6 <= t1)
        & (telem.lat_seen == 0)
    )
    lat = tasks.t_ack6 - tasks.t_create
    return due, lat, torch.searchsorted(edges, lat).to(torch.int32)


def _hist_counts(spec: WorldSpec, tasks, due, b) -> torch.Tensor:
    """(F, B) int32 bucket counts of the due rows."""
    B, F = spec.telemetry_hist_bins, spec.n_fogs
    fog = torch.clamp(tasks.fog, 0, F - 1)
    return torch.zeros((F * B,), dtype=torch.int32, device=b.device).index_add(
        0, (fog * B + b).long(), due.to(torch.int32)
    ).reshape(F, B)


def latency_hist_delta(spec: WorldSpec, telem, tasks, t1: torch.Tensor):
    """This tick's histogram deltas: ``(hist_delta (F, B) i32, sum_delta
    (F,) f32, lat_seen' (T,) i8)`` (``health.latency_hist_delta``), the
    TP tick's share of its task rows, summed over the shards.  Each
    fog's latency sum adds its due rows in task order from +0.0."""
    due, lat, b = _due(spec, telem, tasks, t1)
    sum_d = cell_sum_ordered(
        torch.where(due, tasks.fog, -1).to(torch.int32), lat, spec.n_fogs
    )
    seen = torch.maximum(telem.lat_seen, due.to(torch.int8))
    return _hist_counts(spec, tasks, due, b), sum_d, seen


def accumulate_latency(spec: WorldSpec, telem, tasks, t1: torch.Tensor):
    """Fold this tick's newly acked latencies into the histogram
    (``health.accumulate_latency``).

    Inside the reference's jitted tick XLA folds ``lat_sum + scatter-add
    from zeros`` into one scatter-add onto ``lat_sum``, so each fog's due
    latencies add to its running sum one by one: here the running sums go
    first, one entry a fog, ahead of the tick's rows in one ordered sum.
    """
    F = spec.n_fogs
    due, lat, b = _due(spec, telem, tasks, t1)
    cells = torch.arange(F, dtype=torch.int32, device=lat.device)
    lat_sum = cell_sum_ordered(
        torch.cat([cells, torch.where(due, tasks.fog, -1).to(torch.int32)]),
        torch.cat([telem.lat_sum, lat]), F,
    )
    return telem.replace(
        lat_hist=telem.lat_hist + _hist_counts(spec, tasks, due, b),
        lat_sum=lat_sum,
        lat_seen=torch.maximum(telem.lat_seen, due.to(torch.int8)),
    )


# ----------------------------------------------------------------------
# host readers (after a run or at a chunk boundary; one fetch each)
# ----------------------------------------------------------------------

def _quantile_from_cum(
    cum: np.ndarray, edges_ms: np.ndarray, q: float, total: int, overflow_ms: float,
) -> float:
    """The smallest bucket upper edge (ms) whose cumulative count reaches
    ``q * total``; the +Inf bucket reports ``overflow_ms``; NaN when empty."""
    if total <= 0:
        return float("nan")
    b = int(np.searchsorted(cum, q * total, side="left"))
    if b >= len(edges_ms):
        return float(overflow_ms)
    return float(edges_ms[b])


def hist_summary(spec: WorldSpec, final) -> Optional[Dict]:
    """Host roll-up of the latency histogram (None when off): bucket
    counts, sums and the global and per-fog quantiles in ms.  A leading
    replica axis is summed away (the replica-merged histogram)."""
    if not (spec.telemetry and spec.telemetry_hist):
        return None
    counts = _np(final.telem.lat_hist).astype(np.int64)
    sums = _np(final.telem.lat_sum).astype(np.float64)
    if counts.ndim == 3:
        counts = counts.sum(axis=0)
        sums = sums.sum(axis=0)
    edges_ms = hist_edges_s(spec).astype(np.float64) * 1e3
    over_ms = float(spec.telemetry_hist_max_ms)
    per_fog_cum = np.cumsum(counts, axis=1)
    g_cum = np.cumsum(counts.sum(axis=0))
    total = int(g_cum[-1]) if g_cum.size else 0
    return {
        "edges_ms": edges_ms,
        "counts": counts,
        "sum_ms": float(sums.sum() * 1e3),
        "count": total,
        "per_fog_count": counts.sum(axis=1).astype(np.int64),
        "per_fog_sum_ms": sums * 1e3,
        "quantiles_ms": {
            name: _quantile_from_cum(g_cum, edges_ms, q, total, over_ms)
            for name, q in QUANTILES
        },
        "per_fog_quantiles_ms": {
            name: np.asarray([
                _quantile_from_cum(
                    per_fog_cum[f], edges_ms, q, int(per_fog_cum[f][-1]), over_ms,
                )
                for f in range(counts.shape[0])
            ])
            for name, q in QUANTILES
        },
    }


def slo_breach_count(
    spec: WorldSpec, final, slo_ms: float, summ: Optional[Dict] = None
) -> Optional[int]:
    """Tasks whose latency exceeded ``slo_ms``, at bucket resolution: the
    threshold snaps up to its bucket's upper edge (a lower bound within one
    bucket).  None when the histogram is off."""
    if summ is None:
        summ = hist_summary(spec, final)
    if summ is None:
        return None
    g = summ["counts"].sum(axis=0)
    b = int(np.searchsorted(summ["edges_ms"], float(slo_ms), side="left"))
    return int(g[b + 1:].sum())


def _leaves(tree):
    from ..state import state_to_numpy

    return state_to_numpy(tree)


def state_hash(state) -> str:
    """sha256 over every leaf of a world state in the JAX leaf order (PRNG
    keys as uint32): the same digest JAX's ``state_hash`` gives the same
    world."""
    h = hashlib.sha256()
    for leaf in _leaves(state):
        h.update(leaf.tobytes())
    return h.hexdigest()


def shard_state_hashes(spec: WorldSpec, state, n_shards: int) -> list:
    """Per-shard sha256 of the rows shard ``s`` owns in a TP world: its
    user block, task block, user-node block and ``lat_seen`` block."""
    U, S = spec.n_users, spec.max_sends_per_user
    if n_shards <= 0 or U % n_shards:
        return []
    U_loc = U // n_shards
    T_loc = U_loc * S
    users, tasks, nodes = _leaves(state.users), _leaves(state.tasks), _leaves(state.nodes)
    seen = _np(state.telem.lat_seen)
    out = []
    for s in range(n_shards):
        u0, t0 = s * U_loc, s * T_loc
        h = hashlib.sha256()
        for leaf in users:
            h.update(leaf[u0: u0 + U_loc].tobytes())
        for leaf in tasks:
            h.update(leaf[t0: t0 + T_loc].tobytes())
        for leaf in nodes:
            h.update(leaf[u0: u0 + U_loc].tobytes())
        if seen.size:
            h.update(seen[t0: t0 + T_loc].tobytes())
        out.append(h.hexdigest())
    return out


def find_nonfinite(state) -> Dict[str, str]:
    """``{leaf path: "nan"}`` for every float leaf holding a NaN (+Inf is
    the task table's "never happened" and does not count).  Paths are
    written as JAX's ``keystr`` writes them (``.tasks.t_ack6``)."""
    from ..state import tree_leaves

    bad: Dict[str, str] = {}
    for path, leaf in tree_leaves(state):
        if leaf.is_floating_point() and bool(torch.isnan(leaf).any()):
            bad["." + path] = "nan"
    return bad
