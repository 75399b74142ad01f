"""Energy and lifecycle (``fognetsimpp_tpu/net/energy.py``): INET's
battery, consumer, harvester and management modules as one masked vector
update a tick.

Alive nodes drain idle power, per-message tx/rx energy and, for a fog in
service, compute power; a square-wave harvester charges every node in
the model; the management hysteresis shuts a node down at or below
``shutdown_frac`` of its capacity and restarts it at or above
``start_frac``.  The drain's products and sums are fused multiply-adds
where XLA fuses them (:func:`~..f32math.fma`).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..dynspec import DynSpec, div_knob, knob
from ..f32math import const, fma


def step_energy(
    dv: DynSpec,
    energy: torch.Tensor,  # (N,) f32 joules
    capacity: torch.Tensor,  # (N,) f32
    has_energy: torch.Tensor,  # (N,) bool: the node is in the model
    alive: torch.Tensor,  # (N,) bool
    t: torch.Tensor,  # () f32, the tick's end
    tx_count: torch.Tensor,  # (N,) i32 messages sent this tick
    rx_count: torch.Tensor,  # (N,) i32 messages received this tick
    computing: torch.Tensor,  # (N,) bool: a fog serving a task
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One energy tick: ``(energy', alive')``; nodes outside the model
    keep their energy and liveness.  ``dv``'s leaves are host constants or
    device operands (:mod:`..dynspec`)."""
    dev = energy.device

    def c(x):
        return knob(x, dev)

    idle = c(dv.energy_idle_dt).expand_as(energy)
    drain = fma(c(dv.energy_rx_j).expand_as(energy), rx_count.float(),
                fma(c(dv.energy_tx_j).expand_as(energy), tx_count.float(), idle))
    drain = drain + torch.where(computing, c(dv.energy_compute_dt), 0.0)
    # square-wave harvester: on for the first `duty` of each period
    phase = div_knob(torch.fmod(t, c(dv.harvest_period_s)), dv.harvest_period_s)
    gain = torch.where(phase < c(dv.harvest_duty), c(dv.energy_harvest_dt), 0.0)
    e = torch.where(
        has_energy,
        torch.minimum(
            torch.clamp_min(energy - torch.where(alive, drain, 0.0) + gain, 0.0),
            capacity,
        ),
        energy,
    )
    frac = e / torch.clamp_min(capacity, const(1e-12, dev))
    shut = has_energy & alive & (frac <= c(dv.shutdown_frac))
    boot = has_energy & ~alive & (frac >= c(dv.start_frac))
    alive2 = torch.where(shut, False, torch.where(boot, True, alive))
    return e, alive2
