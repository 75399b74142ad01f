"""Delayed-reward credit assignment for the bandit schedulers
(``fognetsimpp_tpu/learn/rewards.py``).

A decision earns its reward when its status-6 "performed" ack reaches the
client: ``r = exp(-latency / learn_reward_scale)`` in (0, 1], credited to
the fog picked at publish time (``core/engine._phase_learn_credit``).  The
raw latency is accumulated beside it for the regret harness.  The float32
steps are XLA's CPU ones (see :mod:`.bandits`): its division by a
constant is a product with the float32 reciprocal, and its
``disc * g + new`` and ``logw + eta * gain`` updates are single-rounded
multiply-adds.
"""
from __future__ import annotations

import numpy as np
import torch

from ..f32math import const, expf, fma, ftz, xla_sum
from ..state import LearnState


def _recip(x) -> float:
    """The float32 reciprocal of a float32 constant: XLA multiplies by it
    where the source divides by the constant."""
    return float(np.float32(1.0) / np.float32(x))


def reward_from_latency(lat: torch.Tensor, scale) -> torch.Tensor:
    """Bounded reward in (0, 1] from an ack latency in seconds, for a host
    float ``scale``."""
    arg = -torch.clamp_min(lat, 0.0) * const(_recip(scale), lat.device)
    return expf(arg)


def _credit_counts_exact(k_rows: int) -> None:
    """The float32 credit counts sum booleans: exact integers only while
    the credit window stays below 2^24 rows."""
    if k_rows >= 2 ** 24:
        raise ValueError(
            f"credit window of {k_rows} rows >= 2^24: the f32 credit "
            "count sums lose integer exactness — shrink the compaction "
            "window or switch the counters to int32"
        )


def penalize_counts(learn: LearnState, cnt_f: torch.Tensor) -> LearnState:
    """Zero-reward resolution of crashed picks (the chaos hook): each
    swept pick grows the credit counters with no reward mass; the
    latency accumulators and EXP3 weights stay as they are."""
    return learn.replace(
        reward_cnt=learn.reward_cnt + cnt_f,
        disc_cnt=learn.disc_cnt + cnt_f,
    )


def credit_batch(
    learn: LearnState,
    valid: torch.Tensor,  # (K,) bool
    memb: torch.Tensor,  # (F, K) bool
    lat: torch.Tensor,  # (K,) f32
    pick_p_g: torch.Tensor,  # (K,) f32
    n_fogs: int,
    discount,  # host float
    reward_scale,  # host float
) -> LearnState:
    """Fold one tick's credit window into the arm statistics, every
    per-fog sum a membership select over the (F, K) matrix added in
    XLA's order.  The per-task ``credited`` flags are the caller's."""
    dev = lat.device
    _credit_counts_exact(int(valid.shape[0]))
    r01 = torch.where(valid, reward_from_latency(lat, reward_scale), 0.0)
    # booleans: exact integers in any order
    cnt_f = memb.sum(dim=1, dtype=torch.int32).to(torch.float32)
    sum_f = xla_sum(torch.where(memb, r01[None, :], 0.0))

    # EXP3 importance-weighted gain eta * r / p(pick), eta = gamma / F
    eta = learn.explore * const(_recip(max(n_fogs, 1)), dev)
    gain = r01 / torch.clamp_min(pick_p_g, const(1e-6, dev))
    gain_sum = xla_sum(torch.where(memb, gain[None, :], 0.0))
    # XLA contracts logw + eta * sum into one multiply-add
    logw = ftz(fma(eta.expand_as(gain_sum), gain_sum, learn.logw))
    # mean-centring (a softmax invariant) pins the weights' drift
    mean = xla_sum(logw) * const(_recip(logw.shape[0]), dev)
    logw = ftz(logw - mean)

    g = const(float(discount), dev).expand_as(cnt_f)
    return learn.replace(
        reward_cnt=learn.reward_cnt + cnt_f,
        reward_sum=learn.reward_sum + sum_f,
        disc_cnt=ftz(fma(learn.disc_cnt, g, cnt_f)),
        disc_sum=ftz(fma(learn.disc_sum, g, sum_f)),
        logw=logw,
        lat_sum=learn.lat_sum + xla_sum(torch.where(valid, lat, 0.0)),
        lat_cnt=learn.lat_cnt + valid.sum(dtype=torch.int32).to(torch.float32),
    )
