"""The knob grids of the replica axis (``sweep_dyn``, ``sweep_dyn_from``,
``run_replicated(dyn_rows=)``) against the JAX package: counters and final
batches equal, bit for bit.  The families and helpers are
``tests/test_torch_dynspec.py``'s; a file of its own so that a test
worker runs the grids beside that file's single worlds.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from fognetsimpp_tpu import Policy
from fognetsimpp_tpu import dynspec as jdyn
from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.parallel import mesh as jmesh
from fognetsimpp_tpu.parallel import replicas as jreplicas
from fognetsimpp_tpu.parallel import sweep as jsweep
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu.scenarios import wireless as jw
from fognetsimpp_tpu_torch import dynspec as tdyn
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.parallel import mesh as tmesh
from fognetsimpp_tpu_torch.parallel import replicas as treplicas
from fognetsimpp_tpu_torch.parallel import sweep as tsweep
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.scenarios import wireless as tw
from fognetsimpp_tpu_torch.state import state_to_numpy, tree_map
from tests.test_torch_dynspec import FAMILIES, _differing, _jleaves


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ----------------------------------------------------------------------
# knob grids on the replica axis
# ----------------------------------------------------------------------

#: The worlds and grids of the knob sweeps, cut to CPU size.
GRIDS = {
    "loss": (jw.wireless5, tw.wireless5, dict(
        numb_users=24, horizon=0.1, dt=5e-3, extra_aps=4,
        policy=int(Policy.ENERGY_AWARE), mac_model="bianchi"),
        {"uplink_loss_prob": [0.05, 0.2]}),
    "energy": (jw.wireless5, tw.wireless5, dict(
        numb_users=24, horizon=0.5, dt=0.01, extra_aps=4,
        policy=int(Policy.ENERGY_AWARE), idle_power_w=2e-3,
        harvest_period_s=0.07),
        {"idle_power_w": [2e-3, 6e-3], "shutdown_frac": [0.1, 0.2]}),
    "reward": (jsmoke.build, tsmoke.build, dict(
        FAMILIES["learned_ducb"][2], horizon=0.3, policy=int(Policy.UCB)),
        {"learn_reward_scale": [0.25, 0.3], "learn_discount": [0.99, 0.995]}),
}
NRC = 2


def _spy(monkeypatch, module, into):
    real = module.run_replicated

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        into.append(out)
        return out

    monkeypatch.setattr(module, "run_replicated", spy)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_sweep_dyn_matches_jax(name, monkeypatch):
    jbuild, tbuild, kw, knobs = GRIDS[name]
    jfinal, tfinal = [], []
    _spy(monkeypatch, jsweep, jfinal)
    _spy(monkeypatch, tsweep, tfinal)
    jgrid = jsweep.sweep_dyn(jbuild, knobs, n_replicas_per_cell=NRC, seed=3, **kw)
    tgrid = tsweep.sweep_dyn(tbuild, knobs, n_replicas_per_cell=NRC, seed=3,
                             device="cpu", **kw)
    assert len(tgrid) == len(jgrid) == np.prod([len(v) for v in knobs.values()])
    for tc, jc in zip(tgrid, jgrid):
        assert {k: tc[k] for k in knobs} == {k: jc[k] for k in knobs}
        assert set(tc["counters"]) == set(jc["counters"])
        for k, v in jc["counters"].items():
            assert np.asarray(v).tobytes() == tc["counters"][k].tobytes(), (tc, k)
    assert _differing(tfinal[0], _jleaves(jfinal[0])) == []
    # the knobs reached the tick: the first replica of the first and of
    # the last cell share a key and part
    last = (len(tgrid) - 1) * NRC
    assert _differing(tree_map(lambda x: x[0], tfinal[0]),
                      state_to_numpy(tree_map(lambda x: x[last], tfinal[0]))) != []
    if name == "reward":
        assert (tfinal[0].learn.lat_cnt > 0).all()


def test_sweep_dyn_refusals_equal_jax():
    kw = dict(n_users=4, n_fogs=2, horizon=0.01)
    for knobs in ({"dt": [1e-3]}, {"uplink_loss_prob": [0.0, 0.2]}):
        with pytest.raises(ValueError) as je:
            jsweep.sweep_dyn(jsmoke.build, knobs, **kw)
        with pytest.raises(ValueError) as te:
            tsweep.sweep_dyn(tsmoke.build, knobs, device="cpu", **kw)
        assert str(te.value) == str(je.value)
    assert tsweep.sweep_dyn(tsmoke.build, {"uplink_loss_prob": []}, device="cpu") == []
    # a grid that does not divide the mesh, in JAX's words (item 27 is ported)
    with pytest.raises(ValueError, match="divide") as je:
        jsweep.sweep_dyn(jsmoke.build, {"uplink_loss_prob": [0.1]}, mesh=jmesh.make_mesh(2),
                         **kw)
    with pytest.raises(ValueError, match="divide") as te:
        tsweep.sweep_dyn(tsmoke.build, {"uplink_loss_prob": [0.1]},
                         mesh=tmesh.make_mesh(2, device="cpu"), device="cpu", **kw)
    assert str(te.value) == str(je.value)


def test_sweep_dyn_from_a_live_carry_matches_jax():
    """The what-if: a mid-run state forked onto a loss × stop-time grid."""
    jbuild, tbuild, kw = FAMILIES["smoke_stop"]
    knobs = {"uplink_loss_prob": [0.05, 0.3], "send_stop_time": [0.04, 0.08]}
    jspec, jst, jnet, jb = jbuild(**kw)
    jmid, _ = jengine.run(jspec, jst, jnet, jb, n_ticks=40)
    jg, jfinal = jsweep.sweep_dyn_from(jspec, jmid, jnet, jb, knobs, 40)
    spec, st, net, b = tbuild(device="cpu", **kw)
    mid, _ = tengine.run(spec, st, net, b, n_ticks=40)
    assert _differing(mid, _jleaves(jmid)) == []
    grid, final = tsweep.sweep_dyn_from(spec, mid, net, b, knobs, 40)
    assert grid == jg
    assert _differing(final, _jleaves(jfinal)) == []
    # row i is a direct run of cell i's retuned spec from the carry
    key = tdyn.shape_key(spec)
    for i in (0, len(grid) - 1):
        dyn = tdyn.dyn_to_device(tdyn.dyn_of(dataclasses.replace(spec, **grid[i])), "cpu")
        one, _ = tengine.run(key, mid, net, b, n_ticks=40, dyn=dyn)
        assert _differing(tree_map(lambda x: x[i], final), state_to_numpy(one)) == []
    assert tsweep.sweep_dyn_from(spec, mid, net, b, {"send_stop_time": []}, 5) == ([], None)
    with pytest.raises(ValueError, match="leaves the live session's shape"):
        tsweep.sweep_dyn_from(spec, mid, net, b, {"send_stop_time": [float("inf")]}, 5)


def test_run_replicated_dyn_rows_matches_jax():
    """Host rows (numpy leaves with the replica axis) and device rows
    give JAX's ``run_replicated(dyn_rows=)``."""
    jbuild, tbuild, kw = FAMILIES["smoke_stop"]
    cells = [{"send_stop_time": 0.03}, {"send_stop_time": 0.05}, {"send_stop_time": 0.09}]
    jspec, jst, jnet, jb = jbuild(**kw)
    jbatch = jreplicas.replicate_state(jspec, jst, 3, seed=2)
    jrows = jax.tree.map(lambda *xs: np.stack(xs), *(
        jdyn.dyn_of(dataclasses.replace(jspec, **c)) for c in cells))
    jfinal = jreplicas.run_replicated(jdyn.shape_key(jspec), jbatch, jnet, jb, dyn_rows=jrows)
    spec, st, net, b = tbuild(device="cpu", **kw)
    batch = treplicas.replicate_state(spec, st, 3, seed=2)
    host = tdyn.DynSpec(**{f.name: np.asarray(getattr(jrows, f.name))
                           for f in dataclasses.fields(jrows)})
    key = tdyn.shape_key(spec)
    final = treplicas.run_replicated(key, batch, net, b, dyn_rows=host)
    assert _differing(final, _jleaves(jfinal)) == []
    rows = tdyn.dyn_rows([tdyn.dyn_of(dataclasses.replace(spec, **c)) for c in cells], "cpu")
    again = treplicas.run_replicated(key, batch, net, b, dyn_rows=rows)
    assert _differing(again, _jleaves(jfinal)) == []
    n_pub = again.metrics.n_published.tolist()
    assert n_pub[0] < n_pub[1] < n_pub[2]  # the stop time reached each row
