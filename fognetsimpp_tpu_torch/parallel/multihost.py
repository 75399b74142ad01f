"""Replicas across processes (``fognetsimpp_tpu/parallel/multihost.py``).

JAX joins a ``jax.distributed`` cluster and lays one mesh over every
device of every process; here the processes join a ``torch.distributed``
process group and :func:`global_mesh` lays the slots of every process end
to end.  Every process runs the same program on the same global batch: a
process advances only the replica rows of its own slots
(:func:`.mesh.run_sharded`, :func:`.fleet.run_fleet`: its
:class:`.mesh.AddressableRows`), and :func:`.fleet.fleet_decisions` sums
across processes with one ``all_reduce``.  Replicas never communicate,
so nothing else crosses between processes.

The backend is gloo on the CPU and NCCL on a card, one card a process
(``cuda:LOCAL_RANK``).  NCCL takes one rank a card, so a process group
on a one-card machine has one rank; groups of more than one card are
``ROADMAP.md`` §1 item 21.  Two processes run over gloo on the CPU
(``tests/test_torch_multihost.py``).
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

from ..device import resolve_device
from .mesh import REPLICA_AXIS, Mesh

#: Seconds a process waits for the others to join or at a collective.
TIMEOUT_S = 300.0

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    auto: bool = False,
    device=None,
) -> int:
    """Join the process group; returns the process count.

    Three modes, as JAX's:
      * coordinator arguments given: ``init_process_group`` at
        ``tcp://<coordinator_address>`` with ``num_processes`` ranks, this
        one ``process_id``;
      * ``auto=True``: ``env://``, the launcher's ``MASTER_ADDR``,
        ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``; raises
        ``RuntimeError`` when they are absent, so a mis-launched job fails
        instead of running N single-process copies;
      * neither: the single-process passthrough, 1 (or the size of a
        group joined before).
    ``device``: the card by default (NCCL), ``"cpu"`` for gloo.
    """
    import torch.distributed as dist

    if coordinator_address is not None or num_processes is not None:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError(
                "initialize needs coordinator_address, num_processes and "
                "process_id together"
            )
        init = dict(init_method=f"tcp://{coordinator_address}",
                    world_size=int(num_processes), rank=int(process_id))
    elif auto:
        missing = [k for k in _ENV if k not in os.environ]
        if missing:
            raise RuntimeError(
                "initialize(auto=True) found no launcher environment "
                f"({', '.join(missing)} unset)"
            )
        init = dict(init_method="env://")
    else:
        init = None
    if init is not None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
        if backend == "nccl":
            # one card a process: cuda:LOCAL_RANK
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=TIMEOUT_S), **init)
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def global_mesh(
    axis_name: str = REPLICA_AXIS, local_slots: int = 1, device=None
) -> Mesh:
    """A 1-D mesh over the slots of every process, ``local_slots`` a
    process, process r owning slots ``r * local_slots`` to ``(r + 1) *
    local_slots - 1``.  ``device``: the process's card under NCCL, else
    the card unless the caller names one.  Without a process group it is
    this process's ``local_slots`` slots, and the runners return whole
    batches."""
    import torch.distributed as dist

    n = int(local_slots)
    if n < 1:
        raise ValueError(f"a process needs at least one slot, got {n}")
    world, rank = 1, 0
    grouped = dist.is_available() and dist.is_initialized()
    if grouped:
        world, rank = dist.get_world_size(), dist.get_rank()
        if device is None and dist.get_backend() == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
    owners = tuple(r for r in range(world) for _ in range(n))
    return Mesh(axis_name, world * n, resolve_device(device), owners, rank,
                group_size=world if grouped else 0)
