"""The port's regret harness (``learn/eval.py``) against the JAX one.

The static oracle replays one small world under each static policy and
must name the same best policy with the same mean latencies; the regret
curves are host arithmetic on a tick series.  The recorded learned runs
(``run_policy(record_series=True)``, ``evaluate``) need the per-tick
series, ``ROADMAP.md`` §1 item 15, and raise until it is ported.
"""
import functools

import numpy as np
import pytest

from fognetsimpp_tpu.learn import eval as jeval
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu_torch.learn import eval as teval
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.spec import Policy
from tests.test_torch_policies import one_torch_thread  # noqa: F401 (a fixture)

WORLD = dict(
    n_users=12, n_fogs=3, fog_mips=(40000.0, 80000.0, 20000.0),
    send_interval=0.02, horizon=0.15, start_time_max=0.01, queue_capacity=8,
)


def test_static_oracle_matches_jax():
    best_j, means_j = jeval.static_oracle(functools.partial(jsmoke.build, **WORLD))
    best_t, means_t = teval.static_oracle(
        functools.partial(tsmoke.build, device="cpu", **WORLD)
    )
    assert best_t == best_j
    assert means_t.keys() == means_j.keys()
    for k in means_j:
        assert means_t[k] == means_j[k], k
    assert all(np.isfinite(m) for m in means_t.values())


def test_run_policy_runs_a_learned_policy():
    build = functools.partial(tsmoke.build, device="cpu", derive_acks=False, **WORLD)
    spec, final, series = teval.run_policy(build, int(Policy.UCB))
    assert spec.learn_active and series is None
    assert float(final.learn.lat_cnt) > 0
    assert np.isfinite(teval.mean_task_latency_s(final))


def test_regret_curves_match_jax():
    rng = np.random.default_rng(0)
    cnt = np.cumsum(rng.integers(0, 3, 50)).astype(np.float32)
    series = {
        "learn_lat_sum": np.cumsum(rng.random(50)).astype(np.float32) * (cnt > 0),
        "learn_lat_cnt": cnt,
        "learn_picks": rng.integers(0, 9, (50, 3)).astype(np.float32),
    }
    want, got = jeval.regret_curves(series, 0.3), teval.regret_curves(series, 0.3)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype and want[k].tobytes() == got[k].tobytes()


def test_recorded_runs_wait_for_the_tick_series():
    build = functools.partial(tsmoke.build, device="cpu", **WORLD)
    with pytest.raises(NotImplementedError, match="item 15"):
        teval.run_policy(build, int(Policy.UCB), record_series=True)
    with pytest.raises(NotImplementedError, match="item 15"):
        teval.evaluate(build)
