"""The port's envelope: the dense broker's gate and what the port cannot
run (nothing, since every spec field is ported: what is left,
``ROADMAP.md`` §1 item 21, is refused where it is asked for)."""
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
    """Why the port cannot run ``spec`` (and ``net``) yet; None = it can.
    Every spec field is ported: what is left (``ROADMAP.md`` §1 item 21)
    is shards and slots on distinct cards, refused where they are asked
    for (``ops/ring_kernels.py``, ``parallel/mesh.make_mesh``)."""
    return None
