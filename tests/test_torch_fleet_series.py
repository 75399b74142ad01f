"""The fleet's reductions and records against JAX's (``tests/test_fleet.py``
at a small size, on the conftest's 8-device CPU mesh): ``fleet_decisions``
on the same keys, ``run_fleet_series`` at a chunk that splits the horizon
unevenly and its refusal, ``python -m fognetsimpp_tpu_torch --replicas 8
--mesh 8 --ticks`` against ``python -m fognetsimpp_tpu``'s JSON line and
files, and the sweeps with ``mesh=``.  The fleet's states:
``tests/test_torch_fleet.py``.
"""
import jax
import numpy as np
import pytest
import torch

from fognetsimpp_tpu import Policy
from fognetsimpp_tpu.parallel import fleet as jfleet
from fognetsimpp_tpu.parallel import mesh as jmesh
from fognetsimpp_tpu.parallel import sweep as jsweep
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu_torch.parallel import fleet as tfleet
from fognetsimpp_tpu_torch.parallel import mesh as tmesh
from fognetsimpp_tpu_torch.parallel import sweep as tsweep
from fognetsimpp_tpu_torch.random import PRNGKey, split
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from tests.test_torch_fleet import SMALL, _worlds
from tests.test_torch_v1v2 import assert_same
from tests.torch_cli_support import assert_same_files, assert_same_summary, run_both


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_fleet_decisions_match_jax():
    """Two fleets on folded keys, reduced on the device: the same total
    decisions and deferred maximum as JAX's pipeline, and the template
    batch unchanged."""
    (js, jbatch, jn, jb), (spec, batch, net, b) = _worlds(SMALL, 4)
    jd, jdm = jfleet.fleet_decisions(js, jbatch, jn, jb, jax.random.split(
        jax.random.PRNGKey(5), 2), jmesh.make_mesh(4))
    keys = split(PRNGKey(5), 2)
    np.testing.assert_array_equal(keys.numpy().astype(np.uint32),
                                  np.asarray(jax.random.split(jax.random.PRNGKey(5), 2)))
    before = batch.key.clone()
    d, dm = tfleet.fleet_decisions(spec, batch, net, b, keys, tmesh.make_mesh(2, device="cpu"))
    assert d.shape == dm.shape == () and d.dtype == dm.dtype == torch.int32
    assert (int(d), int(dm)) == (int(jd), int(jdm)) and int(d) > 0
    assert torch.equal(batch.key, before)
    keys8 = tfleet.fold_replica_keys(keys[0], 8)
    np.testing.assert_array_equal(keys8.numpy().astype(np.uint32), np.asarray(
        jfleet.fold_replica_keys(jax.random.split(jax.random.PRNGKey(5), 2)[0], 8)))


def test_fleet_series_matches_jax_at_an_uneven_chunk():
    """5-tick chunks of a 12-tick horizon on 4 slots: JAX's series and
    final states; a spec that records nothing is refused in JAX's words."""
    kw = dict(SMALL, record_tick_series=True)
    (js, jbatch, jn, jb), (spec, batch, net, b) = _worlds(kw, 8)
    jfinal, jseries = jfleet.run_fleet_series(js, jbatch, jn, jb, jmesh.make_mesh(8),
                                              chunk_ticks=5)
    final, series = tfleet.run_fleet_series(spec, batch, net, b,
                                            tmesh.make_mesh(4, device="cpu"), chunk_ticks=5)
    assert sorted(series) == sorted(jseries)
    for k, v in jseries.items():
        assert series[k].dtype == v.dtype and series[k].shape == v.shape, k
        assert series[k].tobytes() == np.asarray(v).tobytes(), k
    assert series["t"].shape[:2] == (8, spec.n_ticks)
    assert_same(final, jfinal, "series fleet")
    (js, jbatch, jn, jb), (spec, batch, net, b) = _worlds(dict(SMALL, horizon=0.01), 8)
    with pytest.raises(ValueError, match="record_tick_series") as je:
        jfleet.run_fleet_series(js, jbatch, jn, jb, jmesh.make_mesh(8))
    with pytest.raises(ValueError, match="record_tick_series") as te:
        tfleet.run_fleet_series(spec, batch, net, b, tmesh.make_mesh(8, device="cpu"))
    assert str(te.value) == str(je.value)


def test_cli_mesh_matches_jax(tmp_path, capsys):
    """``--replicas 8 --mesh 8 --ticks``: JAX's JSON line less its wall
    fields (``n_devices`` 8 in both), its fleet files; a replica count
    that does not divide the mesh exits 2 with JAX's error."""
    argv = ["-s", "smoke", "--set", "scenario.n_users=6", "--set", "scenario.horizon=0.03",
            "--set", "scenario.start_time_max=0.02", "--replicas", "8", "--mesh", "8",
            "--ticks"]
    (jrc, jout, _, jdir), (trc, tout, _, tdir) = run_both(argv, capsys, tmp_path)
    assert jrc == trc == 0
    jsum, tsum = assert_same_summary(jout, tout)
    assert tsum["n_devices"] == 8 and tsum["n_replicas"] == 8 and tsum["n_published_sum"] > 0
    assert sorted(assert_same_files(jsum, tsum, jdir, tdir)) == ["om", "sca", "vec"]
    bad = ["-s", "smoke", "--set", "scenario.n_users=4", "--set", "scenario.horizon=0.01",
           "--replicas", "3", "--mesh", "2"]
    (jrc, _, jerr, _), (trc, _, terr, _) = run_both(bad, capsys)
    assert jrc == trc == 2
    assert terr.strip().splitlines()[-1] == jerr.strip().splitlines()[-1]
    assert "does not divide evenly over the 2-device mesh" in terr


def _grids_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert sorted(got[k]) == sorted(want[k]), k
        for c in want[k]:
            np.testing.assert_array_equal(got[k][c], np.asarray(want[k][c]), err_msg=f"{k}:{c}")


def test_sweeps_on_a_mesh_match_jax():
    """``sweep_policies`` (dynamic) and ``sweep_explore`` through
    ``run_sharded``, ``sweep_dyn`` through ``run_fleet``, each grid of 4
    replicas over 2 slots against JAX's over 4 devices."""
    mesh, jm = tmesh.make_mesh(2, device="cpu"), jmesh.make_mesh(4)
    pols = [int(Policy.MIN_BUSY), int(Policy.ROUND_ROBIN)]
    kw = dict(load_intervals=[0.02, 0.01], n_replicas_per_load=1, dynamic=True, **SMALL)
    _grids_equal(tsweep.sweep_policies(tsmoke.build, pols, mesh=mesh, device="cpu", **kw),
                 jsweep.sweep_policies(jsmoke.build, pols, mesh=jm, **kw))
    kw = dict(load_intervals=[0.02, 0.01], n_replicas_per_load=1, derive_acks=False, **SMALL)
    _grids_equal(
        tsweep.sweep_explore(tsmoke.build, int(Policy.UCB), [0.1, 0.5], mesh=mesh,
                             device="cpu", **kw),
        jsweep.sweep_explore(jsmoke.build, int(Policy.UCB), [0.1, 0.5], mesh=jm, **kw))
    knobs = {"uplink_loss_prob": [0.05, 0.2]}
    got = tsweep.sweep_dyn(tsmoke.build, knobs, n_replicas_per_cell=2, mesh=mesh,
                           device="cpu", **SMALL)
    want = jsweep.sweep_dyn(jsmoke.build, knobs, n_replicas_per_cell=2, mesh=jm, **SMALL)
    assert [c["uplink_loss_prob"] for c in got] == [c["uplink_loss_prob"] for c in want]
    for g, w in zip(got, want):
        _grids_equal({"c": g["counters"]}, {"c": w["counters"]})
