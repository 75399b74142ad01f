"""The v1/v2 app generations, port against JAX: POOL fogs, LOCAL_FIRST
(v1) and MAX_MIPS worlds.

Every world of ``tests/test_v1v2.py`` that runs a whole horizon, built as
that file builds it, runs through the port's ``run`` and JAX ``run`` on
the CPU; every leaf of the final states must be equal (dtype, shape and
bits), and the port's state must meet that file's own assertions.  The
hand-placed v2 timer worlds, the pool depth past ``pool_phases``, the
local-pool scan and the v2 hybrid replica batch are in
``tests/test_torch_v2_timer.py``.
"""
import jax
import numpy as np
import pytest
import torch

from fognetsimpp_tpu import BugCompat, FogModel, Policy, Stage
from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.spec import BugCompat as TBugCompat
from fognetsimpp_tpu_torch.state import state_to_numpy, tree_leaves


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _pool_kw(**kw):
    """``tests/test_v1v2.py::_pool_world``'s arguments."""
    kw.setdefault("n_users", 2)
    kw.setdefault("n_fogs", 3)
    kw.setdefault("fog_mips", (1000.0, 3000.0, 2000.0))
    kw.setdefault("horizon", 0.4)
    kw.setdefault("send_interval", 0.05)
    kw.setdefault("fog_model", int(FogModel.POOL))
    kw.setdefault("policy", int(Policy.MAX_MIPS))
    kw.setdefault("adv_periodic", True)
    kw.setdefault("adv_on_completion", False)
    kw.setdefault("app_gen", 2)
    return kw


#: Each world: its ``_pool_world`` arguments, bug-compat switches kept
#: apart (each package has its own ``BugCompat``).
WORLDS = {
    # test_pool_accept_and_release
    "accept_and_release": (_pool_kw(), None),
    # test_pool_rejects_oversized_tasks
    "rejects_oversized": (
        _pool_kw(fog_mips=(500.0, 500.0, 500.0), fixed_mips_required=800),
        dict(v1_max_scan=False),
    ),
    # test_v1_max_scan_bug_compat, both halves
    "v1_max_scan": (_pool_kw(fixed_mips_required=100, horizon=0.3), None),
    "true_max_scan": (
        _pool_kw(fixed_mips_required=100, horizon=0.3), dict(v1_max_scan=False),
    ),
    # test_local_first_runs_small_tasks_on_broker
    "local_first": (
        _pool_kw(policy=int(Policy.LOCAL_FIRST), broker_mips=10000.0,
                 fixed_mips_required=400, horizon=0.3),
        None,
    ),
    # test_local_pool_leak_bug_compat
    "local_pool_leak": (
        _pool_kw(policy=int(Policy.LOCAL_FIRST), broker_mips=1000.0,
                 fixed_mips_required=400, horizon=0.3),
        dict(local_pool_leak=True),
    ),
}


def assert_same(port_tree, ref_tree, what):
    """Every leaf of the port's tree equals the JAX tree's (dtype, shape,
    bits)."""
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref_tree)]
    got = state_to_numpy(port_tree)
    paths = [p for p, _ in tree_leaves(port_tree)]
    assert len(got) == len(ref) == len(paths)
    for p, a, b in zip(paths, got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, p)
        assert a.tobytes() == b.tobytes(), f"{what}: leaf {p} differs"


def run_both(name):
    kw, bug = WORLDS[name]
    jkw = dict(kw, **({"bug_compat": BugCompat(**bug)} if bug else {}))
    tkw = dict(kw, **({"bug_compat": TBugCompat(**bug)} if bug else {}))
    spec, state, net, bounds = tsmoke.build(device="cpu", **tkw)
    final, _ = tengine.run(spec, state, net, bounds)
    js, jst, jn, jb = jsmoke.build(**jkw)
    jfinal, _ = jengine.run(js, jst, jn, jb)
    assert_same(final, jfinal, name)
    return spec, final


def _np(x):
    return x.numpy()


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_pool_world_matches_jax_every_leaf(name):
    spec, final = run_both(name)
    stage = _np(final.tasks.stage)
    done = stage == int(Stage.DONE)
    m = final.metrics
    if name == "accept_and_release":
        assert done.sum() > 0
        svc = _np(final.tasks.t_complete)[done] - _np(final.tasks.t_service_start)[done]
        np.testing.assert_allclose(svc, spec.required_time, rtol=1e-4)
        assert np.isfinite(_np(final.tasks.t_ack6)[done]).all()
    elif name == "rejects_oversized":
        assert (stage[stage != int(Stage.UNUSED)] != int(Stage.DONE)).all()
        assert int(m.n_rejected) > 0 and int(m.n_completed) == 0
    elif name in ("v1_max_scan", "true_max_scan"):
        fog = _np(final.tasks.fog)
        informed = (fog >= 0) & (_np(final.tasks.t_at_broker) > 0.05)
        assert informed.any()
        # the faithful scan keeps fog 0's MIPS as its mark: the last fog
        # beating it (2), not the largest (1)
        assert (fog[informed] == (2 if name == "v1_max_scan" else 1)).all()
    elif name == "local_first":
        created = np.isfinite(_np(final.tasks.t_create))
        assert int(m.n_local) == created.sum() > 0
        assert np.isfinite(_np(final.tasks.t_ack3)[done]).all()
        assert np.isfinite(_np(final.tasks.t_ack6)[done]).all()
        svc = _np(final.tasks.t_complete)[done] - _np(final.tasks.t_service_start)[done]
        np.testing.assert_allclose(svc, spec.required_time, rtol=1e-4)
    else:  # local_pool_leak: 1000 -> 600 -> 200, then never below 400
        assert int(m.n_local) == 2
        assert float(final.broker.local_pool) <= 200.0 + 1e-6
