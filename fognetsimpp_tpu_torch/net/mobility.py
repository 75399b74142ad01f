"""Node mobility (``fognetsimpp_tpu/net/mobility.py``): INET's
LinearMobility and CircleMobility, all nodes in one vectorised update a
tick.

LINEAR nodes integrate ``pos + vel * dt`` and reflect off the constraint
area's edges; CIRCLE nodes sit at ``center + r * (cos, sin)(phase + omega
* t)``, closed form at absolute time.  Each ``a * b + c`` is one fused
multiply-add, as XLA compiles it (:func:`~..f32math.fma`), and the sine
and cosine are glibc's (:func:`~..f32math.sinf`), as XLA's CPU backend
calls them.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..f32math import const, cosf, fma, sinf
from ..spec import Mobility
from ..state import Struct


@dataclasses.dataclass
class MobilityBounds(Struct):
    lo: torch.Tensor  # (2,) f32 constraint area min (x, y)
    hi: torch.Tensor  # (2,) f32 constraint area max


def default_bounds(extent: float = 1000.0, device=None) -> MobilityBounds:
    dev = resolve_device(device)
    return MobilityBounds(
        lo=torch.zeros((2,), dtype=torch.float32, device=dev),
        hi=torch.full((2,), extent, dtype=torch.float32, device=dev),
    )


def step_mobility(nodes, bounds: MobilityBounds, t_next: torch.Tensor, dt: float):
    """Advance every node one tick to ``t_next``: ``(pos, vel)``."""
    mob = nodes.mobility
    pos, vel = nodes.pos, nodes.vel

    # linear + reflective bounce
    p_lin = fma(vel, const(dt, pos.device).expand_as(vel), pos)
    lo, hi = bounds.lo[None, :], bounds.hi[None, :]
    over_hi = p_lin > hi
    under_lo = p_lin < lo
    p_lin = torch.where(over_hi, 2 * hi - p_lin, p_lin)
    p_lin = torch.where(under_lo, 2 * lo - p_lin, p_lin)
    v_lin = torch.where(over_hi | under_lo, -vel, vel)

    # circle, closed form at absolute time t_next
    ang = fma(nodes.circle_omega, t_next.expand_as(nodes.circle_omega), nodes.circle_phase)
    trig = torch.stack([cosf(ang), sinf(ang)], dim=-1)
    p_circ = fma(nodes.circle_radius[:, None].expand_as(trig), trig, nodes.circle_center)

    is_lin = (mob == int(Mobility.LINEAR))[:, None]
    is_circ = (mob == int(Mobility.CIRCLE))[:, None]
    new_pos = torch.where(is_circ, p_circ, torch.where(is_lin, p_lin, pos))
    new_vel = torch.where(is_lin, v_lin, vel)
    return new_pos, new_vel
