"""Regret harness: replay one world under learned and static policies
(``fognetsimpp_tpu/learn/eval.py``).

Every policy replays the same scenario (same seed, topology and publish
schedule up to policy-dependent feedback); the static runs give the
world's oracle, the best fixed policy by mean task latency.  The per-tick
regret curves of the JAX harness read the recorded tick series, which is
``ROADMAP.md`` §1 item 15 in the port: ``run_policy(record_series=True)``
and :func:`evaluate` raise until then.

Host-side module: it drives :func:`~..core.engine.run` and reads results
back once a run.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from ..spec import Policy

#: Static policies the oracle is taken over (the argmin family without
#: ENERGY_AWARE, which differs only in energy-enabled worlds).
DEFAULT_STATICS: Tuple[Policy, ...] = (
    Policy.MIN_BUSY,
    Policy.ROUND_ROBIN,
    Policy.MIN_LATENCY,
    Policy.RANDOM,
)

_SERIES = "per-tick series recording (ROADMAP.md §1 item 15)"


def mean_task_latency_s(final) -> float:
    """Mean publish -> status-6 ack latency (s) over completed tasks."""
    from ..runtime.signals import extract_signals

    v = extract_signals(final)["task_time"]
    return float(v.mean() / 1e3) if v.size else float("nan")


def run_policy(build, policy: int, record_series: bool = False, **kw):
    """Replay the world ``build(policy=..., **kw)`` makes under ``policy``;
    returns ``(spec, final, series)`` (``series`` is None)."""
    from ..core.engine import run

    if record_series:
        raise NotImplementedError(f"not ported yet: {_SERIES}")
    spec, state, net, bounds = build(policy=int(policy), **kw)
    final, series = run(spec, state, net, bounds)
    return spec, final, series


def static_oracle(
    build, statics: Sequence[Policy] = DEFAULT_STATICS, **kw
) -> Tuple[int, Dict[int, float]]:
    """Mean latency of each static policy on this world: ``(best policy
    id, {policy id: mean latency s})``.  A NaN mean (a policy that
    completed nothing) loses against any finite one."""
    means: Dict[int, float] = {}
    for pol in statics:
        _, final, _ = run_policy(build, int(pol), **kw)
        means[int(pol)] = mean_task_latency_s(final)
    finite = {p: m for p, m in means.items() if np.isfinite(m)}
    if not finite:
        raise ValueError(
            "no static policy completed any task on this world — the "
            "regret baseline is undefined (grow the horizon or lower "
            "the load)"
        )
    best = min(finite, key=finite.get)
    return best, means


def regret_curves(series, oracle_mean_s: float) -> Dict[str, np.ndarray]:
    """Per-tick regret and pick curves from a learned run's tick series
    (``learn_lat_sum``, ``learn_lat_cnt``, ``learn_picks``): the mean
    credited latency up to each tick less the oracle's, 0 before the
    first credit."""
    lat_sum = np.asarray(series["learn_lat_sum"], np.float64)
    lat_cnt = np.asarray(series["learn_lat_cnt"], np.float64)
    mean = lat_sum / np.maximum(lat_cnt, 1.0)
    regret = np.where(lat_cnt > 0, mean - oracle_mean_s, 0.0)
    return {
        "learnRegret": regret.astype(np.float64),
        "learnPicks": np.asarray(series["learn_picks"], np.float64),
    }


def evaluate(build, *args, **kw) -> Dict:
    """The full harness (oracle plus one recorded run a learned policy)
    needs the tick series and the recorder."""
    raise NotImplementedError(f"not ported yet: {_SERIES}")
