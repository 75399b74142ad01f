"""The port's regret harness (``learn/eval.py``) against the JAX one.

The static oracle replays one small world under each static policy and
must name the same best policy with the same mean latencies; the regret
curves are host arithmetic on a tick series.  The recorded learned runs
(``run_policy(record_series=True)``, ``evaluate``) carry the per-tick
series and equal JAX's, the recorded files included.
"""
import functools

import numpy as np
import pytest
import torch

from fognetsimpp_tpu.learn import eval as jeval
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu_torch.learn import eval as teval
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.spec import Policy


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


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


def test_recorded_runs_wait_for_the_tick_series(tmp_path):
    """The recorded learned run and the full harness (the tick series
    are ported): ``run_policy(record_series=True)``'s series and
    ``evaluate``'s summary and files equal JAX's."""
    kw = dict(WORLD, derive_acks=False)
    _, jfinal, jser = jeval.run_policy(
        functools.partial(jsmoke.build, **kw), int(Policy.UCB), record_series=True)
    _, tfinal, tser = teval.run_policy(
        functools.partial(tsmoke.build, device="cpu", **kw), int(Policy.UCB),
        record_series=True)
    assert sorted(tser) == sorted(jser) and "learn_lat_cnt" in tser
    for k, v in jser.items():
        assert tser[k].numpy().tobytes() == np.asarray(v).tobytes(), k
    assert float(tfinal.learn.lat_cnt) > 0
    pick = dict(learned=(Policy.UCB,), statics=(Policy.MIN_BUSY, Policy.ROUND_ROBIN))
    want = jeval.evaluate(functools.partial(jsmoke.build, **kw),
                          outdir=str(tmp_path / "jax"), **pick)
    got = teval.evaluate(functools.partial(tsmoke.build, device="cpu", **kw),
                         outdir=str(tmp_path / "port"), **pick)
    assert got["oracle"] == want["oracle"]
    paths_j = want["learned"]["ucb"].pop("paths")
    paths_t = got["learned"]["ucb"].pop("paths")
    assert got == want
    vj = np.load(paths_j["vec"])
    vt = np.load(paths_t["vec"])
    assert sorted(vt.files) == sorted(vj.files) and "learnRegret" in vt.files
    for k in vj.files:
        assert vt[k].dtype == vj[k].dtype and vt[k].tobytes() == vj[k].tobytes(), k
