"""The dense broker's scheduling decision (``fognetsimpp_tpu/ops/sched.py``).

Only :func:`scalar_winner` is ported: the task-independent winner of the
dense-broker policy family.  The per-task ``schedule_batch`` and the
learned policies are ``ROADMAP.md`` §1 item 8.
"""
from __future__ import annotations

import torch

from ..f32math import const, fma
from ..spec import Policy

_BIG = 3.4e38


def scalar_winner(
    policy: int,
    view_busy: torch.Tensor,  # (F,) f32
    view_mips: torch.Tensor,  # (F,) f32
    registered: torch.Tensor,  # (F,) bool
    fog_alive: torch.Tensor,  # (F,) bool
    fog_energy_frac: torch.Tensor,  # (F,) f32
    rtt_broker_fog: torch.Tensor,  # (F,) f32
    v1_max_scan: bool,
) -> torch.Tensor:
    """() i32 winning fog, -1 = no resource.

    ``brokers[0]`` anchors to the FIRST REGISTERED fog; argmin/argmax take
    the first occurrence, as the reference's strict-< scan does.
    """
    F = view_busy.shape[0]
    dev = view_busy.device
    i32 = torch.int32
    if F == 0:
        return torch.full((), -1, dtype=i32, device=dev)
    avail = registered
    first_reg = torch.argmax(avail.to(torch.uint8)).to(i32)
    if policy == int(Policy.MAX_MIPS):
        idx = torch.arange(F, dtype=i32, device=dev)
        if v1_max_scan:
            cand = avail & (idx > first_reg) & (view_mips > view_mips[first_reg])
            last = torch.where(cand, idx, -1).amax()
            return torch.where(last >= 0, last, first_reg).to(i32)
        return torch.argmax(
            torch.where(avail, view_mips, float("-inf"))
        ).to(i32)
    if policy == int(Policy.MIN_BUSY):
        base, avail_ = view_busy, avail
    elif policy == int(Policy.MIN_LATENCY):
        base, avail_ = rtt_broker_fog + view_busy, avail
    elif policy == int(Policy.ENERGY_AWARE):
        base = fma(const(10.0, dev), 1.0 - fog_energy_frac, view_busy)
        avail_ = avail & fog_alive
    else:
        raise ValueError(f"no scalar winner for policy {policy}")
    big = const(_BIG, dev)
    scores = torch.nan_to_num(
        torch.where(avail_, base, big), posinf=float(big)
    )
    choice0 = torch.argmin(scores).to(i32)
    choice0 = torch.where(view_mips[first_reg] > 0, choice0, first_reg)
    return torch.where(avail_.any(), choice0, -1).to(i32)
