"""What the port runs today: the one place that knows the slice's limits.

A spec that enables a branch not yet ported raises ``NotImplementedError``
naming the ``ROADMAP.md`` §1 item that will port it; nothing runs down a
wrong path silently.
"""
from __future__ import annotations

from typing import Optional

from .spec import FogModel, Policy, WorldSpec


def broker_dense_ok(spec: WorldSpec) -> bool:
    """The dense broker's gate (``engine._broker_dense_ok``): with the
    faithful ``mips0_divisor`` quirk the argmin winner is task-independent,
    one scalar decision per tick, as it is for the MAX_MIPS scan.  Every
    other policy takes the compacted broker."""
    if spec.policy == int(Policy.MAX_MIPS):
        return True
    return spec.policy in (
        int(Policy.MIN_BUSY),
        int(Policy.MIN_LATENCY),
        int(Policy.ENERGY_AWARE),
    ) and spec.bug_compat.mips0_divisor


def slice_reject_reason(spec: WorldSpec, net=None) -> Optional[str]:
    """Why the port cannot run ``spec`` (and ``net``) yet; None = it can."""
    if not spec.two_stage_arrivals:
        return "the full arrival front (ROADMAP.md §1 item 7)"
    if (
        spec.fog_model != int(FogModel.FIFO)
        or spec.policy == int(Policy.LOCAL_FIRST)
        or spec.v2_local_broker or spec.adv_periodic or spec.app_gen != 3
    ):
        return "the v1/v2 apps, POOL fogs and LOCAL_FIRST (ROADMAP.md §1 item 10)"
    if spec.link_up_s > 0:
        return "the link warm-up of the v1/v2 example world (ROADMAP.md §1 item 10)"
    if spec.wired_queue_enabled:
        return "DropTail link queues (ROADMAP.md §1 item 25)"
    if spec.chaos:
        return "chaos worlds (ROADMAP.md §1 item 12)"
    if spec.hier_active:
        return "federated multi-broker worlds (ROADMAP.md §1 item 13)"
    if spec.telemetry or spec.telemetry_hist or spec.journey_active:
        return "the telemetry planes (ROADMAP.md §1 item 14)"
    if spec.record_tick_series or spec.record_trails:
        return "per-tick series recording (ROADMAP.md §1 item 15)"
    if spec.ingest:
        return "twin ingestion (ROADMAP.md §1 item 16)"
    if spec.tp_shards:
        return "the task-sharded telemetry plane (ROADMAP.md §1 item 23)"
    return None


def check_slice(spec: WorldSpec, net=None) -> None:
    """Raise ``NotImplementedError`` for a spec outside the port's slice."""
    why = slice_reject_reason(spec, net)
    if why is not None:
        raise NotImplementedError(f"not ported yet: {why}")


def check_replicas(spec: WorldSpec, dyn_rows=None) -> None:
    """The replica axis's envelope (:mod:`.parallel.replicas`): the
    single-device slice, with one spec for every replica."""
    if dyn_rows is not None:
        raise NotImplementedError(
            "not ported yet: per-replica promoted knobs, run_replicated("
            "dyn_rows=) (ROADMAP.md §1 item 11)"
        )
    if spec.chaos:
        raise NotImplementedError(
            "not ported yet: per-replica chaos schedules "
            "(fold_replica_chaos_keys; ROADMAP.md §1 item 12)"
        )
    check_slice(spec)


def check_one_card(mesh) -> None:
    """The sweeps run on one card: a device mesh is refused."""
    if mesh is not None:
        raise NotImplementedError(
            "not ported yet: replicas across cards, mesh= (run_sharded, "
            "shard_replicas, parallel/fleet.py; ROADMAP.md §1 item 27)"
        )


def refuse_dyn_sweep(name: str) -> None:
    """``sweep_dyn`` and ``sweep_dyn_from`` grid promoted knobs, which the
    port does not carry as tensors yet."""
    raise NotImplementedError(
        f"not ported yet: {name}, a grid of promoted knobs (dynspec.DynSpec "
        "rows; ROADMAP.md §1 item 11)"
    )


def check_tp_slice(spec: WorldSpec, net=None) -> None:
    """The task-sharded runner's envelope: the single-device slice, less
    the planes the TP tick does not carry yet.  The TP family itself is
    the JAX gate's (``engine.tp_reject_reason``)."""
    if (
        spec.telemetry or spec.telemetry_hist or spec.journey_active
        or spec.tp_shards
    ):
        raise NotImplementedError(
            "not ported yet: telemetry, the latency histogram and journeys "
            "under the task-sharded tick (ROADMAP.md §1 items 14 and 23)"
        )
    if spec.n_aps > 0 or (net is not None and net.ap_nodes.shape[0] > 0):
        raise NotImplementedError(
            "not ported yet: access points under the task-sharded tick "
            "(ROADMAP.md §1 item 26)"
        )
    check_slice(spec, net)
