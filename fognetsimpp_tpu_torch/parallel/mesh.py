"""Replica meshes on one card (``fognetsimpp_tpu/parallel/mesh.py``).

A JAX mesh is a list of devices, and ``NamedSharding(mesh, P('replica'))``
gives each device ``R / D`` rows of a replica batch.  Replicas never
communicate, so the same split on ONE device is exact: a :class:`Mesh`
here is ``D`` slots on the caller's device.  Slot ``s`` of a batch of
``R`` rows holds rows ``s * R / D`` to ``(s + 1) * R / D - 1``, as device
``s`` of the JAX mesh does, and a process advances the rows of all its
slots as one batch (:func:`.replicas.run_replicated`): on one card,
splitting them further would only run the slots one after another.  The
mesh decides what the split decides in JAX: that the replica count
divides the slot count, which rows a process owns, and ``n_devices``.

A mesh laid over a process group (:func:`.multihost.global_mesh`) records
the rank that owns each slot: a process advances only its own slots'
rows and returns them as :class:`AddressableRows`, JAX's addressable
shards.

A mesh whose slots would sit on distinct cards in one process raises
``NotImplementedError``: that is ``ROADMAP.md`` §1 item 21.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..net.mobility import MobilityBounds
from ..net.topology import NetParams
from ..spec import WorldSpec
from ..state import WorldState, tree_map
from .replicas import run_replicated

REPLICA_AXIS = "replica"

_DISTINCT_CARDS = (
    "not ported yet: the slots of one process on distinct cards "
    "(ROADMAP.md §1 item 21)"
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``size`` slots along one axis, all on ``device``.

    ``owners[s]`` is the rank of the process that advances slot ``s``
    (all 0 in one process), ``rank`` is this process's rank and
    ``group_size`` the size of the process group the mesh is laid over
    (0: none)."""

    axis_name: str
    size: int
    device: torch.device
    owners: Tuple[int, ...]
    rank: int = 0
    group_size: int = 0

    @property
    def shape(self) -> dict:
        """``{axis_name: size}``, as ``jax.sharding.Mesh.shape``."""
        return {self.axis_name: self.size}

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis_name,)

    @property
    def devices(self) -> np.ndarray:
        """The device of each slot, as ``Mesh.devices`` lists JAX's."""
        out = np.empty((self.size,), dtype=object)
        out[:] = [self.device] * self.size
        return out

    def local_slots(self) -> List[int]:
        """The slots this process advances, in slot order."""
        return [s for s, r in enumerate(self.owners) if r == self.rank]


class AddressableRows(NamedTuple):
    """A process's rows of a batch on a process group's mesh: ``state``
    holds global rows ``start`` to ``stop - 1`` (JAX's addressable
    shards)."""

    state: WorldState
    start: int
    stop: int


def make_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = REPLICA_AXIS,
    device: Union[None, str, torch.device, Sequence] = None,
) -> Mesh:
    """A 1-D mesh of ``n_devices`` slots (default 1) on ``device``.

    ``device`` is the card unless the caller names one (without a card it
    raises, as the entry points do); a sequence names each slot's device,
    and must name one device throughout."""
    if device is not None and not isinstance(device, (str, torch.device)):
        devs = {torch.device(d) for d in device}
        if len(devs) > 1:
            raise NotImplementedError(_DISTINCT_CARDS)
        if n_devices is None:
            n_devices = len(device)
        (device,) = devs
    dev = resolve_device(device)
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one slot, got {n}")
    return Mesh(axis_name, n, dev, (0,) * n)


def _slot_ranges(n_rows: int, n_slots: int) -> List[Tuple[int, int]]:
    per = n_rows // n_slots
    return [(s * per, (s + 1) * per) for s in range(n_slots)]


def _check_divisible(n_rows: int, mesh: Mesh, axis_name: str) -> int:
    d = mesh.shape[axis_name]
    if n_rows % d:
        raise ValueError(
            f"the replica count {n_rows} does not divide evenly over the "
            f"{d}-slot mesh (fixed shapes: pad the replica count to a "
            "multiple of the mesh size)"
        )
    return d


def replica_sharding(
    mesh: Mesh, axis_name: str = REPLICA_AXIS
) -> Callable[[torch.Tensor], List[Tuple[int, int]]]:
    """Leaf -> each slot's ``(start, stop)`` rows of its leading axis: the
    counterpart of ``NamedSharding(mesh, P(axis_name, ...))``."""

    def leaf(x: torch.Tensor) -> List[Tuple[int, int]]:
        n = int(x.shape[0])
        return _slot_ranges(n, _check_divisible(n, mesh, axis_name))

    return leaf


def on_device(tree, dev: torch.device):
    """``tree``'s tensors on ``dev`` (None stays None)."""
    if tree is None:
        return None
    return tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x, tree)


def shard_replicas(
    batch: WorldState, mesh: Mesh, axis_name: str = REPLICA_AXIS
) -> AddressableRows:
    """This process's rows of the batch (its slots' rows, consecutive) on
    the mesh's device, with their global range.  The replica count must
    divide the mesh size (``ValueError`` otherwise)."""
    ranges = replica_sharding(mesh, axis_name)(batch.t)
    slots = mesh.local_slots()
    a, b = ranges[slots[0]][0], ranges[slots[-1]][1]
    return AddressableRows(tree_map(lambda x: x[a:b].to(mesh.device), batch), a, b)


def shard_world(
    batch: WorldState,
    net: NetParams,
    bounds: Optional[MobilityBounds],
    mesh: Mesh,
    axis_name: str = REPLICA_AXIS,
):
    """``(rows, net, bounds)``: :func:`shard_replicas`' rows and the shared
    topology on the mesh's device (the one source of the layout for
    :func:`run_sharded` and the fleet)."""
    return (shard_replicas(batch, mesh, axis_name), on_device(net, mesh.device),
            on_device(bounds, mesh.device))


def own_rows(mesh: Mesh, rows: AddressableRows, final):
    """A run's result: the final batch, or on a process group's mesh this
    process's rows of it as :class:`AddressableRows`."""
    return AddressableRows(final, rows.start, rows.stop) if mesh.group_size else final


def run_sharded(
    spec: WorldSpec,
    batch: WorldState,
    net: NetParams,
    bounds: Optional[MobilityBounds],
    mesh: Mesh,
    n_ticks: Optional[int] = None,
    axis_name: str = REPLICA_AXIS,
):
    """Advance every replica of this process's slots as one batch.

    Replica r equals :func:`.replicas.run_replicated`'s replica r, leaf
    for leaf.  Returns the final batch, or on a process group's mesh this
    process's :class:`AddressableRows`.  The replica count must divide
    the mesh size.
    """
    rows, net, bounds = shard_world(batch, net, bounds, mesh, axis_name)
    return own_rows(mesh, rows, run_replicated(spec, rows.state, net, bounds, n_ticks=n_ticks))
