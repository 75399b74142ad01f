"""The replica fleet on a slot mesh (``fognetsimpp_tpu/parallel/fleet.py``).

R independent worlds split over the slots of a :class:`.mesh.Mesh`, the
rows of a process's slots one batch (:func:`~..core.engine.run_batched`):

  * :func:`run_fleet` advances the fleet, promoted by default (the
    promoted knobs a device operand, one row a replica, ``dyn_rows``
    split over the processes like the batch);
  * :func:`fleet_decisions` runs ``len(keys)`` fleets, each re-keyed by
    :func:`fold_replica_keys`, and reduces their counters on the device
    to two 0-d tensors (on a process group's mesh, one ``all_reduce``
    across the processes);
  * :func:`run_fleet_series` records the per-tick series in chunks, each
    chunk's copied to the host before the next runs.

Replica r equals :func:`.replicas.run_replicated`'s replica r on every
leaf.  The port has no buffer donation: ``donate`` is kept for JAX's
signature, and a donated batch is simply not to be reused.  JAX's
``DECLARED_COLLECTIVES`` (the compiled program's audit) has no PyTorch
counterpart.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.engine import run_batched
from ..dynspec import DynSpec, dyn_rows as host_dyn_rows, dyn_to_device, promote_default, split_spec
from ..hier.federation import hier_reject_reason
from ..net.mobility import MobilityBounds
from ..net.topology import NetParams
from ..random import fold_in
from ..spec import WorldSpec
from ..state import WorldState, tree_map
from .mesh import Mesh, make_mesh, own_rows, shard_world


def fold_replica_keys(key: torch.Tensor, n_replicas: int) -> torch.Tensor:
    """(R, 2) per-replica keys ``fold_in(key, r)``: replica r's stream is
    keyed on its own id, the same whether 8 or 800 replicas run beside it."""
    ids = torch.arange(int(n_replicas), dtype=torch.int64, device=key.device)
    return fold_in(key, ids)


def _check_fleet_spec(spec: WorldSpec) -> None:
    # chaos worlds run (each replica keys its own schedule in
    # replicas.replicate_state); the federated hierarchy does not
    reason = hier_reject_reason(spec, "fleet")
    if reason is not None:
        raise ValueError(reason)


def _check_divisible(n_replicas: int, mesh: Mesh) -> None:
    d = mesh.size
    if n_replicas % d != 0:
        raise ValueError(
            f"fleet replica count {n_replicas} does not divide evenly "
            f"over the {d}-device mesh (fixed shapes: pad the replica "
            "count to a multiple of the mesh size)"
        )


def _setup(spec: WorldSpec, batch: WorldState, net, bounds, mesh: Optional[Mesh]):
    """The fleet entries' common front: the mesh (one slot on the batch's
    device by default), the checks, and :func:`.mesh.shard_world`."""
    if mesh is None:
        mesh = make_mesh(device=batch.t.device)
    R = int(batch.t.shape[0])
    _check_fleet_spec(spec)
    _check_divisible(R, mesh)
    rows, net, bounds = shard_world(batch, net, bounds, mesh)
    return mesh, R, rows, net, bounds


def _fleet_dyn_rows(spec: WorldSpec, R: int, dev, dyn_rows: Optional[DynSpec],
                    a: int = 0, b: Optional[int] = None):
    """``(run_spec, rows)``: the spec's shape key and rows ``a`` to ``b - 1``
    (default all ``R``) of promoted knobs on ``dev``, the spec's own values
    broadcast to every replica when ``dyn_rows`` is None."""
    run_spec, dyn = split_spec(spec)
    b = R if b is None else b
    if dyn_rows is None:
        return run_spec, host_dyn_rows([dyn], dev, repeats=b - a)
    Rd = int(np.shape(dyn_rows.learn_discount)[0])
    if Rd != R:
        raise ValueError(
            f"dyn_rows carries {Rd} replica rows for a {R}-replica "
            "batch — one promoted-knob row per replica"
        )
    if not isinstance(dyn_rows.learn_discount, torch.Tensor):
        dyn_rows = dyn_to_device(dyn_rows, dev)
    return run_spec, tree_map(lambda x: x[a:b].to(dev), dyn_rows)


def _run_rows(spec: WorldSpec, mesh: Mesh, R: int, rows, promote: bool,
              dyn_rows: Optional[DynSpec] = None):
    """``(run_spec, knob rows or None)`` for this process's rows."""
    if not promote:
        return spec, None
    return _fleet_dyn_rows(spec, R, mesh.device, dyn_rows, rows.start, rows.stop)


def run_fleet(
    spec: WorldSpec,
    batch: WorldState,
    net: NetParams,
    bounds: Optional[MobilityBounds],
    mesh: Optional[Mesh] = None,
    n_ticks: Optional[int] = None,
    donate: bool = True,
    promote: Optional[bool] = None,
    dyn_rows: Optional[DynSpec] = None,
):
    """Advance every replica of ``batch`` over the mesh's slots; returns
    the final batch (or, on a process group's mesh, this process's
    :class:`.mesh.AddressableRows`).

    The replica count must divide the mesh size.  ``promote`` (default
    :func:`..dynspec.promote_default`) runs the spec's shape key with the
    promoted knobs as rows of a device operand: ``dyn_rows`` (one row a
    replica, a ``sweep_dyn`` grid's cells) or the spec's own values.
    ``donate``: JAX's carry donation, which the port does not have; with
    ``donate=True`` do not reuse ``batch``, as with JAX's.
    """
    del donate
    if promote is None:
        promote = promote_default()
    if dyn_rows is not None and not promote:
        raise ValueError(
            "dyn_rows carries per-replica promoted knobs; it needs the "
            "promoted path (promote=True)"
        )
    mesh, R, rows, net, bounds = _setup(spec, batch, net, bounds, mesh)
    run_spec, knobs = _run_rows(spec, mesh, R, rows, promote, dyn_rows)
    final = run_batched(run_spec, rows.state, net, bounds, n_ticks=n_ticks, dyn_rows=knobs)[0]
    return own_rows(mesh, rows, final)


def _all_reduce_pair(mesh: Mesh, d: torch.Tensor, dm: torch.Tensor):
    """The total of ``d`` and the maximum of ``dm`` over the processes of
    the mesh, by one ``all_reduce``: rank r's pair in column r
    of a zero block, summed."""
    import torch.distributed as dist

    v = torch.zeros((2, mesh.group_size), dtype=torch.int32, device=d.device)
    v[0, mesh.rank] = d
    v[1, mesh.rank] = dm
    dist.all_reduce(v)
    return v[0].sum(dtype=torch.int32), v[1].max()


def fleet_decisions(
    spec: WorldSpec,
    batch: WorldState,
    net: NetParams,
    bounds: Optional[MobilityBounds],
    keys: torch.Tensor,
    mesh: Optional[Mesh] = None,
    promote: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``len(keys)`` complete fleets of ``batch``, fleet i's replica r
    keyed ``fold_in(keys[i], r)``, reduced on the device: ``(total
    decisions, max deferred backlog)`` as two 0-d int32 tensors, read by
    one fetch.  ``batch`` is a template: it is not changed.  Under
    promotion (the default) every replica reads the spec's knobs as one
    device operand."""
    if promote is None:
        promote = promote_default()
    mesh, R, rows, net, bounds = _setup(spec, batch, net, bounds, mesh)
    run_spec, knobs = _run_rows(spec, mesh, R, rows, promote)
    d = dm = None
    for k in keys.to(mesh.device):
        own = rows.state.replace(key=fold_replica_keys(k, R)[rows.start:rows.stop])
        m = run_batched(run_spec, own, net, bounds, dyn_rows=knobs)[0].metrics
        dk = m.n_scheduled.sum(dtype=torch.int32)
        mk = m.n_deferred_max.max()
        d = dk if d is None else d + dk
        dm = mk if dm is None else torch.maximum(dm, mk)
    if d is None:
        raise ValueError("fleet_decisions needs at least one key")
    if mesh.group_size:
        d, dm = _all_reduce_pair(mesh, d, dm)
    return d, dm


def fleet_busy_fractions_per_replica(
    spec: WorldSpec, final_batch: WorldState
) -> Optional[np.ndarray]:
    """Per-replica per-fog busy fractions ``(R, F)``, one sample a
    ``(fleet=replica, fog)`` pair in the fleet exposition; None with
    ``spec.telemetry`` off."""
    if not spec.telemetry:
        return None
    busy = final_batch.telem.busy_ticks.detach().cpu().numpy().astype(np.float64)
    ticks = np.maximum(
        final_batch.telem.ticks.detach().cpu().numpy().astype(np.float64), 1.0
    )
    return busy / ticks[:, None]


def fleet_phase_work(
    spec: WorldSpec, final_batch: WorldState
) -> Optional[np.ndarray]:
    """Per-replica per-phase work counters ``(R, P)``; None with
    ``spec.telemetry`` off."""
    if not spec.telemetry:
        return None
    return final_batch.telem.phase_work.detach().cpu().numpy().astype(np.int64)


def fleet_latency_hist(spec: WorldSpec, final_batch: WorldState) -> Optional[Dict]:
    """The replica-merged latency histogram of a finished fleet
    (:func:`..telemetry.health.hist_summary` sums the replica axis); None
    with ``spec.telemetry_hist`` off."""
    from ..telemetry.health import hist_summary

    return hist_summary(spec, final_batch)


def fleet_busy_fractions(
    spec: WorldSpec, final_batch: WorldState
) -> Optional[np.ndarray]:
    """The replica-mean per-fog busy fraction of a finished fleet; None
    with ``spec.telemetry`` off."""
    per = fleet_busy_fractions_per_replica(spec, final_batch)
    return None if per is None else per.mean(axis=0)


def run_fleet_series(
    spec: WorldSpec,
    batch: WorldState,
    net: NetParams,
    bounds: Optional[MobilityBounds],
    mesh: Optional[Mesh] = None,
    chunk_ticks: int = 4096,
    promote: Optional[bool] = None,
) -> Tuple[object, Dict[str, np.ndarray]]:
    """The fleet with its per-tick series, in chunks of ``chunk_ticks``.

    The process's rows record a chunk's series on the device; the finished chunk
    is copied to the host before the next one runs, so the device holds
    one chunk at a time.  Returns ``(final, series)``: the final batch
    (or this process's :class:`.mesh.AddressableRows`) and each series
    as a host array ``(R, n_ticks, ...)`` (this process's rows on a
    process group's mesh), equal to one straight batched run with
    recording.  Promoted by default, every replica on the spec's knobs.
    """
    if not spec.record_tick_series:
        raise ValueError(
            "run_fleet_series needs spec.record_tick_series=True; for "
            "counters-only fleets use run_fleet"
        )
    if promote is None:
        promote = promote_default()
    mesh, R, rows, net, bounds = _setup(spec, batch, net, bounds, mesh)
    run_spec, knobs = _run_rows(spec, mesh, R, rows, promote)
    total = spec.n_ticks
    chunk = min(chunk_ticks, total)
    state = rows.state
    chunks = []
    done = 0
    while done < total:
        n = min(chunk, total - done)
        state, series = run_batched(run_spec, state, net, bounds, n_ticks=n, dyn_rows=knobs)
        chunks.append({k: v.numpy() for k, v in series.items()})
        done += n
    gathered = {k: np.concatenate([c[k] for c in chunks], axis=1) for k in chunks[0]}
    return own_rows(mesh, rows, state), gathered

