"""The telemetry plane (plane 1), port against JAX, on the CPU.

Telemetry-on worlds (the wired world with JAX's fused slot-window front
end on and off, a v1 POOL world, a learner) run through the port's
``run`` and JAX ``run``; every leaf of the final states, the telemetry
leaves included, must be equal (dtype, shape, bits), and so must the
host readers' roll-ups.  Then the profile helpers and the constants.  The runners (the reservoir
stream, the sweeps, the phase spans) are in
``tests/test_torch_telemetry_runs.py``; replica batches in
``tests/test_torch_health.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from fognetsimpp_tpu import Policy
from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu.scenarios import wired_v1 as jv1
from fognetsimpp_tpu.telemetry import metrics as jmetrics
from fognetsimpp_tpu.telemetry import profile as jprofile
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.scenarios import wired_v1 as tv1
from fognetsimpp_tpu_torch.telemetry import metrics as tmetrics
from fognetsimpp_tpu_torch.telemetry import profile as tprofile
from tests.test_torch_v1v2 import assert_same


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


#: ``tests/test_telemetry.py``'s small wired world, cut to 100 ticks.
SMALL = dict(n_users=16, n_fogs=3, send_interval=0.01, horizon=0.1, start_time_max=0.05)
WORLDS = {
    # the dense broker, where JAX's fused front end runs (or not)
    "wired-fused": (jsmoke, tsmoke, dict(SMALL, telemetry=True)),
    "wired-unfused": (jsmoke, tsmoke, dict(SMALL, telemetry=True, fused_slots=False)),
    # POOL fogs and LOCAL_FIRST: pool_occ_sum and the pool phase slots
    # (60 ticks of 10 ms: the pools fill from 0.5 s on)
    "v1-pool": (jv1, tv1, dict(horizon=0.6, dt=1e-2, telemetry=True)),
    # a learner: pick_hist
    "ucb": (jsmoke, tsmoke, dict(
        n_users=24, n_fogs=4, fog_mips=(40000.0, 80000.0), policy=int(Policy.UCB),
        derive_acks=False, horizon=0.08, send_interval=0.02, telemetry=True,
    )),
}


def _summaries_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _summaries_equal(g, w)
        elif w is None:
            assert g is None, k
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=k)


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_telemetry_world_matches_jax(name):
    jm, tm, kw = WORLDS[name]
    spec, state, net, bounds = tm.build(device="cpu", **kw)
    final, _ = tengine.run(spec, state, net, bounds)
    js, jst, jn, jb = jm.build(**kw)
    jfinal, _ = jengine.run(js, jst, jn, jb)
    assert_same(final, jfinal, name)
    summ = tmetrics.telemetry_summary(spec, final)
    _summaries_equal(summ, jmetrics.telemetry_summary(js, jfinal))
    assert summ["ticks"] == spec.n_ticks and sum(summ["phase_work"].values()) > 0
    if name == "v1-pool":
        assert summ["pool_occ_mean"].max() > 0
        assert summ["phase_work"]["pool_arrivals"] > 0
    if name == "ucb":
        assert summ["pick_hist"].sum() > 0


def test_profile_helpers_and_constants_are_the_references():
    samples = [0.0004, 0.003, 0.003, 0.017, 0.06, 0.2, 0.9]
    assert tprofile.latency_histogram(samples) == jprofile.latency_histogram(samples)
    assert tprofile.latency_histogram([]) == {"n": 0}
    with tprofile.profile_trace(None) as info:
        pass
    assert info == {"active": False, "dir": None, "error": None}
    assert tprofile.measure_dispatch(lambda: None, n=3)["n"] == 3
    assert not hasattr(tprofile, "measure_compile")
    assert tmetrics.PHASES == jmetrics.PHASES
    assert tmetrics.PHASE_INDEX == jmetrics.PHASE_INDEX
    assert tmetrics.RES_FIELDS == jmetrics.RES_FIELDS
    assert tmetrics.EXG_OCC_EDGES == jmetrics.EXG_OCC_EDGES
    assert tmetrics.EXG_OCC_BINS == jmetrics.EXG_OCC_BINS
    # telemetry off: every accumulator zero-row, the summary None
    spec, st, _, _ = tsmoke.build(device="cpu", **SMALL)
    assert tmetrics.telemetry_summary(spec, st) is None
    assert all(
        getattr(st.telem, f.name).numel() <= 1 for f in dataclasses.fields(st.telem)
    )
    assert tmetrics.busy_fractions(spec, st) is None
