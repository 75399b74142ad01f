"""What the port runs today: the one place that knows the slice's limits.

A spec that enables a branch not yet ported raises ``NotImplementedError``
naming the ``ROADMAP.md`` §1 item that will port it; nothing runs down a
wrong path silently.
"""
from __future__ import annotations

from typing import Optional

from .spec import Policy, WorldSpec


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
    if spec.ingest:
        return "twin ingestion (ROADMAP.md §1 item 16)"
    return None


def check_slice(spec: WorldSpec, net=None) -> None:
    """Raise ``NotImplementedError`` for a spec outside the port's slice."""
    why = slice_reject_reason(spec, net)
    if why is not None:
        raise NotImplementedError(f"not ported yet: {why}")


def check_one_card(mesh) -> None:
    """The sweeps run on one card: a device mesh is refused."""
    if mesh is not None:
        raise NotImplementedError(
            "not ported yet: replicas across cards, mesh= (run_sharded, "
            "shard_replicas, parallel/fleet.py; ROADMAP.md §1 item 27)"
        )


def check_tp_slice(spec: WorldSpec, net=None) -> None:
    """The task-sharded runner's envelope: the single-device slice (the
    telemetry planes included).  The TP family itself is the JAX gate's
    (``engine.tp_reject_reason``)."""
    check_slice(spec, net)
