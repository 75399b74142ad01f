"""The port's sweeps against the JAX package, grid for grid.

``sweep_policies`` (one batch a policy, and ``dynamic=True``: one
``Policy.DYNAMIC`` batch for the whole grid, the policy id a replica's
data) and ``sweep_explore`` (a learned policy's exploration rate as a
replica's data, NaN where nothing was credited) against JAX's on the
same small worlds: every counter of every cell, same dtype and bits.
Functorch's per-replica fallback is off (``strict_vmap``).
"""
import numpy as np
import pytest
import torch

from fognetsimpp_tpu import Policy
from fognetsimpp_tpu.parallel import sweep as jsweep
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu_torch.parallel import sweep as tsweep
from fognetsimpp_tpu_torch.parallel.replicas import strict_vmap as _strict
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke


@pytest.fixture(autouse=True, scope="module")
def strict_vmap():
    """No per-replica fallback loop, and the port on one thread beside
    the other test workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with _strict():
        yield
    torch.set_num_threads(old)


#: A small wired world whose fogs keep up, so tasks complete and ack.
WORLD = dict(
    n_users=16, n_fogs=4, fog_mips=(40000.0, 80000.0, 20000.0, 60000.0),
    horizon=0.03, start_time_max=0.02, queue_capacity=16, arrival_window=32,
)
LOADS = [0.004, 0.02]
POLICIES = [int(Policy.MIN_LATENCY), int(Policy.ROUND_ROBIN)]


def _assert_grids_equal(got, want):
    assert list(got) == list(want)
    for key in want:
        assert sorted(got[key]) == sorted(want[key]), key
        for name, w in want[key].items():
            g = got[key][name]
            w = np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, (key, name)
            assert np.array_equal(g, w, equal_nan=True), (key, name)


@pytest.mark.parametrize("dynamic", [False, True])
def test_sweep_policies_matches_jax(dynamic):
    kw = dict(WORLD, n_replicas_per_load=2, seed=3, dynamic=dynamic)
    want = jsweep.sweep_policies(jsmoke.build, POLICIES, LOADS, **kw)
    got = tsweep.sweep_policies(tsmoke.build, POLICIES, LOADS, device="cpu", **kw)
    _assert_grids_equal(got, want)
    n = got[POLICIES[0]]["n_published"]
    assert n.shape == (2, 2) and (n[0] > n[1]).all()  # the heavier load publishes more
    assert all((g["n_scheduled"] > 0).all() for g in got.values())


def test_dynamic_sweep_refuses_a_policy_outside_its_families():
    with pytest.raises(ValueError, match="traced-dispatch"):
        tsweep.sweep_policies(tsmoke.build, [int(Policy.MAX_MIPS)], LOADS,
                              dynamic=True, device="cpu", **WORLD)
    with pytest.raises(ValueError, match="learned policies"):
        tsweep.sweep_explore(tsmoke.build, int(Policy.MIN_BUSY), [0.1], LOADS,
                             device="cpu", **WORLD)


def test_sweep_explore_matches_jax_with_nan_cells():
    # 12 ticks: some cells have credited acks, the others none (NaN)
    kw = dict(WORLD, derive_acks=False, horizon=0.012, seed=1, n_replicas_per_load=2)
    rates = [0.05, 0.5]
    want = jsweep.sweep_explore(jsmoke.build, int(Policy.EXP3), rates, LOADS, **kw)
    got = tsweep.sweep_explore(tsmoke.build, int(Policy.EXP3), rates, LOADS,
                               device="cpu", **kw)
    _assert_grids_equal(got, want)
    means = np.stack([g["lat_mean_s"] for g in got.values()])
    assert np.isnan(means).any() and np.isfinite(means).any()
