"""The MIN_BUSY decision over a fog axis split across slots
(``fognetsimpp_tpu/parallel/tp.py``).

Each slot of the mesh scores its own fog columns of the broker's (K, F)
matrix and reduces them to a per-task (local minimum, global index) pair;
the slots' pairs are then gathered and the lowest score wins, ties going
to the lowest slot.  Both the local argmin and the cross-slot pick keep
the first index, so the winner is the reference's first-wins ``<`` scan
(``src/mqttapp/BrokerBaseApp3.cc:272-279``), as
:func:`..ops.sched.schedule_batch` picks it.

The slots are the bodies of a :class:`.shards.ShardGroup` on the mesh's
device, and the gather is the group's :meth:`~.shards.ShardGroup.ring_all_gather`
of each slot's pairs packed in int32 columns: the ring kernel
(``csrc/ring_gather.cu``) on a card.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .mesh import Mesh
from .shards import ShardGroup

FOG_AXIS = "fog"

#: ``jnp.float32(3.4e38)``: the score of an unregistered fog.
_BIG = float(np.float32(3.4e38))


def sharded_min_busy(
    mesh: Mesh,
    mask: torch.Tensor,  # (K,) bool: tasks being decided
    mips_req: torch.Tensor,  # (K,) f32
    view_busy: torch.Tensor,  # (F,) f32, split over the fog axis
    view_mips: torch.Tensor,  # (F,) f32, split over the fog axis
    registered: torch.Tensor,  # (F,) bool, split over the fog axis
    divisor: Optional[torch.Tensor] = None,  # () f32: brokers[0] MIPS (the
    #   mips0_divisor quirk, BrokerBaseApp3.cc:268); None = per-fog MIPS
    axis_name: str = FOG_AXIS,
) -> torch.Tensor:
    """MIN_BUSY over a fog axis split across the mesh's slots: (K,) int32,
    -1 for a task not decided and for every task when no fog is
    registered.  Equal to :func:`..ops.sched.schedule_batch` with
    ``policy=MIN_BUSY``."""
    n = mesh.shape[axis_name]
    F = int(view_busy.shape[0])
    if F % n:
        raise ValueError(f"the fog count {F} must divide the {n}-slot mesh axis")
    f_loc = F // n
    group = ShardGroup(n, mesh.device)
    dev = mesh.device
    mask, req = mask.to(dev), mips_req.to(dev)
    busy_all, mips_all, reg_all = view_busy.to(dev), view_mips.to(dev), registered.to(dev)
    div = None if divisor is None else divisor.to(dev)

    def body(s: int) -> torch.Tensor:
        cols = slice(s * f_loc, (s + 1) * f_loc)
        busy, mips, reg = busy_all[cols], mips_all[cols], reg_all[cols]
        if div is None:
            est = torch.where(
                mips > 0, req[:, None] / torch.clamp_min(mips, 1e-30)[None, :], torch.inf
            )
        else:
            est = torch.where(
                div > 0, req[:, None] / torch.clamp_min(div, 1e-30), torch.inf
            ).expand(-1, f_loc)
        scores = torch.where(reg[None, :], busy[None, :] + est, _BIG)
        scores = torch.nan_to_num(scores, nan=0.0, posinf=_BIG)
        loc_min = torch.amin(scores, dim=1)
        glob = s * f_loc + torch.argmin(scores, dim=1).to(torch.int32)
        avail = reg.any().to(torch.int32).expand_as(glob)
        block = torch.stack([loc_min.contiguous().view(torch.int32), glob, avail], dim=1)
        got = group.ring_all_gather(s, block.contiguous()).reshape(n, -1, 3)
        mins = got[:, :, 0].contiguous().view(torch.float32)  # (S, K)
        # lowest score wins; ties go to the lowest slot
        win = torch.argmin(mins, dim=0)
        choice = torch.gather(got[:, :, 1], 0, win[None, :])[0]
        choice = torch.where(got[:, 0, 2].any(), choice, -1)
        return torch.where(mask, choice, -1).to(torch.int32)

    return group.run(body)[0]
