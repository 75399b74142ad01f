"""Bandit index kernels for the in-loop learned schedulers
(``fognetsimpp_tpu/learn/bandits.py``).

Each fog node is an arm and the base broker the learner.  The learner's
state, :class:`~fognetsimpp_tpu_torch.state.LearnState`, rides in the
world state; this module scores it: UCB and discounted UCB are one
masked argmax over a per-fog index vector, EXP3 samples each task's arm
from the softmax weights by the task-id-keyed uniform stream.

The float32 arithmetic is XLA's on the CPU, so every leaf the learners
touch matches the JAX engine's bits on the CPU and on the card:
``exp``/``log1p`` are :func:`~..f32math.expf`/:func:`~..f32math.log1pf`,
the sums and the cumulative sum add in XLA's order
(:func:`~..f32math.xla_sum`, :func:`~..f32math.xla_cumsum`), the
``mean + explore * sqrt(...)`` and the EXP3 mixing step are single-rounded
multiply-adds, and ``sqrt`` is taken in float64 and rounded once.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..f32math import const, expf, fma, ftz, log1pf, xla_cumsum, xla_sum
from ..state import LearnState

# Score of a never-picked arm: one exploratory pull per arm comes first.
_UNTRIED = 3.4e38
# Floor of the discounted counts: caps the bonus of an abandoned arm.
_DISC_FLOOR = 1e-3
_NEG_BIG = -3.4e38


class BanditArms(NamedTuple):
    """The read-only arm view the scheduler scores against."""

    pick_count: torch.Tensor  # (F,) f32
    reward_cnt: torch.Tensor  # (F,) f32
    reward_sum: torch.Tensor  # (F,) f32
    disc_cnt: torch.Tensor  # (F,) f32
    disc_sum: torch.Tensor  # (F,) f32
    logw: torch.Tensor  # (F,) f32
    explore: torch.Tensor  # () f32


def arms_view(learn: LearnState) -> BanditArms:
    """The scheduler-facing slice of a :class:`LearnState`."""
    return BanditArms(
        pick_count=learn.pick_count,
        reward_cnt=learn.reward_cnt,
        reward_sum=learn.reward_sum,
        disc_cnt=learn.disc_cnt,
        disc_sum=learn.disc_sum,
        logw=learn.logw,
        explore=learn.explore,
    )


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``sqrt`` (torch's CPU one is not)."""
    return torch.sqrt(x.double()).float()


def _index(mean, explore, ratio):
    """``mean + explore * sqrt(ratio)``, one rounding for the multiply-add
    as XLA contracts it; a subnormal mean counts as 0 (:func:`ftz`)."""
    return fma(explore.expand_as(mean), _sqrt(ratio), ftz(mean))


def ucb_scores(arms: BanditArms, avail: torch.Tensor) -> torch.Tensor:
    """UCB1 index per arm, higher is better: ``mean + c sqrt(ln(1 + t) /
    n)`` over play counts ``n``, credited rewards for the mean; a
    never-picked arm scores ``_UNTRIED``."""
    n = arms.pick_count
    total = xla_sum(torch.where(avail, n, 0.0))
    mean = arms.reward_sum / torch.clamp_min(arms.reward_cnt, 1.0)
    ratio = log1pf(total) / torch.clamp_min(n, 1.0)
    return torch.where(n > 0, _index(mean, arms.explore, ratio), _UNTRIED)


def ducb_scores(arms: BanditArms, avail: torch.Tensor) -> torch.Tensor:
    """Discounted UCB: the UCB index over the gamma-decayed statistics."""
    n = torch.clamp_min(arms.disc_cnt, const(_DISC_FLOOR, arms.disc_cnt.device))
    total = xla_sum(torch.where(avail, n, 0.0))
    mean = arms.disc_sum / n
    ratio = log1pf(total) / n
    return torch.where(
        arms.pick_count > 0, _index(mean, arms.explore, ratio), _UNTRIED
    )


def exp3_probs(
    logw: torch.Tensor, avail: torch.Tensor, gamma: torch.Tensor
) -> torch.Tensor:
    """EXP3 arm distribution over the available fogs: ``(1 - gamma)
    softmax(logw | avail) + gamma / |avail|``, renormalised; unavailable
    arms get exactly 0, and no available arm gives the zero vector."""
    dev = logw.device
    z = torch.where(avail, logw, const(_NEG_BIG, dev))
    z = z - z.max()
    w = torch.where(avail, expf(z), 0.0)
    sm = ftz(w / torch.clamp_min(xla_sum(w), const(1e-30, dev)))
    a = avail.to(torch.float32)
    n_avail = xla_sum(a)
    mix = torch.clamp(gamma, 0.0, 1.0)
    p = ftz(fma((1.0 - mix).expand_as(sm), sm, mix * a / torch.clamp_min(n_avail, 1.0)))
    return ftz(p / torch.clamp_min(xla_sum(p), const(1e-30, dev)))


def exp3_sample(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF sample a task, inside the support of ``p``: the target
    is ``clip(u, 1e-7, 1) * cdf[-1]``, so neither ``u = 0`` nor a float32
    cumsum that tops out below 1 can pick a zero-probability arm; -1 where
    ``p`` is all zero."""
    dev = p.device
    cdf = xla_cumsum(p)
    total = cdf[-1]
    target = torch.clamp(u, const(1e-7, dev), const(1.0, dev))[:, None] * total
    arm = torch.argmax((cdf[None, :] >= target).to(torch.uint8), dim=1)
    return torch.where(total > 0, arm.to(torch.int32), -1)
