"""Regret harness: replay one world under learned and static policies
(``fognetsimpp_tpu/learn/eval.py``).

Every policy replays the same scenario (same seed, topology and publish
schedule up to policy-dependent feedback); the static runs give the
world's oracle, the best fixed policy by mean task latency.  A learned
run's per-tick credited-latency accumulators (``learn_lat_sum``,
``learn_lat_cnt`` in the tick series) give its regret curve against that
oracle without re-reading the task table; :func:`evaluate` persists them
through the recorder as the ``learnRegret`` and ``learnPicks`` vectors.

Host-side module: it drives :func:`~..core.engine.run` and reads results
back once a run.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..spec import LEARNED_POLICIES, Policy

#: Static policies the oracle is taken over (the argmin family without
#: ENERGY_AWARE, which differs only in energy-enabled worlds).
DEFAULT_STATICS: Tuple[Policy, ...] = (
    Policy.MIN_BUSY,
    Policy.ROUND_ROBIN,
    Policy.MIN_LATENCY,
    Policy.RANDOM,
)

def mean_task_latency_s(final) -> float:
    """Mean publish -> status-6 ack latency (s) over completed tasks."""
    from ..runtime.signals import extract_signals

    v = extract_signals(final)["task_time"]
    return float(v.mean() / 1e3) if v.size else float("nan")


def run_policy(build, policy: int, record_series: bool = False, **kw):
    """Replay the world ``build(policy=..., **kw)`` makes under ``policy``;
    returns ``(spec, final, series)`` (``series`` None unless
    ``record_series``)."""
    from ..core.engine import run

    if record_series:
        kw = dict(kw, record_tick_series=True)
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


def evaluate(
    build,
    learned: Sequence[Policy] = LEARNED_POLICIES,
    statics: Sequence[Policy] = DEFAULT_STATICS,
    outdir: Optional[str] = None,
    run_id_prefix: str = "learn",
    **kw,
) -> Dict:
    """The full harness: the oracle and one recorded run a learned policy.

    Returns ``{"oracle": {"policy", "policy_name", "mean_latency_s",
    "statics"}, "learned": {name: {"mean_latency_s", "final_regret_s",
    "picks", "credited", "paths"?}}}``.  With ``outdir`` each learned run
    is recorded (``<prefix>-<name>.sca.json`` / ``.vec.npz``) with the
    ``learnRegret`` / ``learnPicks`` curves as extra signal vectors.
    """
    best, static_means = static_oracle(build, statics=statics, **kw)
    oracle_mean = static_means[best]
    out: Dict = {
        "oracle": {
            "policy": int(best),
            "policy_name": Policy(best).name.lower(),
            "mean_latency_s": oracle_mean,
            "statics": static_means,
        },
        "learned": {},
    }
    for pol in learned:
        name = Policy(int(pol)).name.lower()
        spec, final, series = run_policy(build, int(pol), record_series=True, **kw)
        curves = regret_curves(series, oracle_mean)
        entry = {
            "mean_latency_s": mean_task_latency_s(final),
            "final_regret_s": float(curves["learnRegret"][-1]),
            "picks": final.learn.pick_count.cpu().numpy().tolist(),
            "credited": float(final.learn.lat_cnt.cpu()),
        }
        if outdir is not None:
            from ..runtime.recorder import record_run

            entry["paths"] = record_run(
                outdir, spec, final, series=series,
                run_id=f"{run_id_prefix}-{name}",
                attrs={"policy": name, "oracle": out["oracle"]},
                extra_vectors=curves,
            )
        out["learned"][name] = entry
    return out
