"""Batched ring-buffer FIFO ops for fog-node queues
(``fognetsimpp_tpu/ops/queues.py``).

Every fog's FIFO is one row of a fixed ``(F, Q)`` ring; same-tick
arrivals are ranked within their fog by (arrival time, position) and
scattered into their slots in one batched operation.  The rank and the
per-fog reductions come from :mod:`.arrival_kernels`: the CUDA kernels on
the card, their plain versions (and the stable-sort branch above K = 4096)
on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import arrival_kernels as ak
from .scatter import set_drop

NO_TASK = -1

# Above this window the CPU path ranks by stable sort instead of the
# O(K^2) pairwise compare (the card's kernel takes any K).
_PAIRWISE_MAX = 4096


class ArrivalPlan(NamedTuple):
    """Per-fog plan of one tick's arrivals.

    assign_task: (F,) i32 window position an idle fog takes now, else
      NO_TASK.  rank: (K,) i32 within-fog arrival rank, -1 masked out.
    counts: (F,) i32 masked-in arrivals per fog (None with ``fused``).
    """

    assign_task: torch.Tensor
    rank: torch.Tensor
    counts: Optional[torch.Tensor]


def row_lexmin(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row ``(min, first argmin)`` of a NaN-free 2-D tensor."""
    return keys.amin(dim=1), keys.argmin(dim=1).to(torch.int32)


def topk_merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two ``(K, W)`` i32 windows sorted ascending on their last
    column and keep the best ``K`` rows (``queues.topk_merge_sorted``).

    Each row's merged rank is its own index plus a binary-search count on
    the other side (``a`` wins ties), and two drop-mode scatters place
    the rows; for unique keys the result does not depend on which window
    is ``a``.
    """
    K = a.shape[0]
    av, bv = a[:, -1].contiguous(), b[:, -1].contiguous()
    k = torch.arange(K, dtype=torch.int32, device=a.device)
    rank_a = k + torch.searchsorted(bv, av, side="left").to(torch.int32)
    rank_b = k + torch.searchsorted(av, bv, side="right").to(torch.int32)
    out = set_drop(torch.zeros_like(a), rank_a, a)
    return set_drop(out, rank_b, b)


def _sort_rank(mask, f_key, t_arrive) -> torch.Tensor:
    """The K > 4096 branch: ``jnp.lexsort((ids, t_arrive, f_key))`` as
    three stable sorts, then each row's offset in its fog segment."""
    K = mask.shape[0]
    dev = mask.device
    order = torch.arange(K, device=dev)
    for col in (t_arrive, f_key):
        order = order[torch.sort(col[order], stable=True).indices]
    f_sorted = f_key[order]
    idx = torch.arange(K, dtype=torch.int32, device=dev)
    is_start = torch.cat(
        [torch.ones((1,), dtype=torch.bool, device=dev),
         f_sorted[1:] != f_sorted[:-1]]
    )
    seg_start = torch.cummax(
        torch.where(is_start, idx, torch.zeros_like(idx)), dim=0
    ).values
    rank_sorted = torch.where(mask[order], idx - seg_start, -1).to(torch.int32)
    # out of place, so that a replica batch (vmap) can pass through
    return torch.zeros((K,), dtype=torch.int32, device=dev).scatter(
        0, order, rank_sorted
    )


def plan_arrivals(
    mask: torch.Tensor,  # (K,) bool
    fog: torch.Tensor,  # (K,) i32
    t_arrive: torch.Tensor,  # (K,) f32
    n_fogs: int,
    fog_idle: torch.Tensor,  # (F,) bool
    per_fog: Optional[torch.Tensor] = None,  # (F, K) bool membership
    fused: bool = False,
) -> ArrivalPlan:
    """Per-fog arrival order for one tick's window (``queues.plan_arrivals``).

    On the card the fused kernel gives rank, counts and the earliest
    (time, position) per fog in one launch while ``n_fogs`` fits its
    shared-memory tables; wider fog axes take the rank kernel plus torch
    reductions.  On the CPU the plain versions run, or the stable-sort
    rank above K = 4096.  ``fused`` keeps the JAX fused tick's contract:
    arrival presence from a finite ``t_min`` and ``counts=None``.
    """
    K = mask.shape[0]
    dev = mask.device
    F = int(n_fogs)
    inf = float("inf")
    f_key = torch.where(mask, fog, F).to(torch.int32)
    t_key = torch.where(mask, t_arrive, inf)
    card = mask.is_cuda
    small = card or K <= _PAIRWISE_MAX

    if small and 0 < F <= ak.FUSED_MAX_FOGS:
        rank, counts, t_min, first = ak.fused_arrival_plan(
            mask, f_key, t_key, F
        )
    else:
        if small:
            rank = ak.pairwise_rank(mask, f_key, t_key, F)
        else:
            rank = _sort_rank(mask, f_key, t_arrive)
        if per_fog is None:
            fid = torch.arange(F, dtype=torch.int32, device=dev)
            per_fog = (fog[None, :] == fid[:, None]) & mask[None, :]
        counts = per_fog.sum(dim=1, dtype=torch.int32)
        tmat = torch.where(per_fog, t_key[None, :], inf)
        t_min, first = row_lexmin(tmat)
    has_arrival = torch.isfinite(t_min) if fused else counts > 0
    assign_task = torch.where(
        fog_idle & has_arrival, first, NO_TASK
    ).to(torch.int32)
    return ArrivalPlan(
        assign_task=assign_task, rank=rank, counts=None if fused else counts
    )


def enqueue_scatter(
    queue: torch.Tensor,  # (F, Q) i32
    q_head: torch.Tensor,  # (F,) i32
    q_len: torch.Tensor,  # (F,) i32
    mask: torch.Tensor,  # (K,) bool
    fog: torch.Tensor,  # (K,) i32
    eff_rank: torch.Tensor,  # (K,) i32
    task_ids: Optional[torch.Tensor] = None,  # (K,) i32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write the fitting tasks into their rings; returns ``(queue, fits)``."""
    F, Q = queue.shape
    fc = fog.clamp(0, F - 1).long()
    head_g = q_head[fc]
    len_g = q_len[fc]
    slot = head_g + len_g + eff_rank
    fits = mask & (len_g + eff_rank < Q) & (eff_rank >= 0)
    flat_idx = torch.where(fits, fc * Q + slot % Q, F * Q)
    if task_ids is None:
        task_ids = torch.arange(mask.shape[0], dtype=torch.int32, device=fog.device)
    flat = set_drop(queue.reshape(F * Q), flat_idx, task_ids)
    return flat.reshape(F, Q), fits


def batched_enqueue(
    queue: torch.Tensor,
    q_head: torch.Tensor,
    q_len: torch.Tensor,
    mask: torch.Tensor,
    fog: torch.Tensor,
    eff_rank: torch.Tensor,
    task_ids: Optional[torch.Tensor] = None,
):
    """Enqueue at ``head + len + rank``; returns (queue, q_len, fits,
    dropped_per_fog).  Tasks past the ring's capacity are dropped."""
    F, Q = queue.shape
    queue, fits = enqueue_scatter(
        queue, q_head, q_len, mask, fog, eff_rank, task_ids
    )
    fid = torch.arange(F, dtype=torch.int32, device=fog.device)
    fog_eq = fog[None, :] == fid[:, None]
    added = (fog_eq & fits[None, :]).sum(dim=1, dtype=torch.int32)
    dropped = (fog_eq & (mask & ~fits)[None, :]).sum(dim=1, dtype=torch.int32)
    return queue, q_len + added, fits, dropped


def batched_pop(
    queue: torch.Tensor,  # (F, Q) i32
    q_head: torch.Tensor,  # (F,) i32
    q_len: torch.Tensor,  # (F,) i32
    pop_mask: torch.Tensor,  # (F,) bool
):
    """Pop the head of each masked ring: (task, q_head, q_len)."""
    F, Q = queue.shape
    can = pop_mask & (q_len > 0)
    head = torch.gather(queue, 1, (q_head % Q).long()[:, None])[:, 0]
    head_task = torch.where(can, head, NO_TASK)
    q_head = torch.where(can, (q_head + 1) % Q, q_head)
    q_len = torch.where(can, q_len - 1, q_len)
    return head_task, q_head, q_len
