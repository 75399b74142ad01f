"""The port's promoted knobs (``dynspec.py``) against the JAX package.

The catalogue (fields, reasons, canonical values, shape keys, retunes,
classification, population buckets) equals the reference's on the same
specs.  Each family the port runs is held against JAX in both of the
reference's arithmetic modes, every leaf, bit for bit: the spec's values
as host constants (``run(spec)`` against JAX ``run``) and as a device
operand (``run(shape_key, dyn=operand)`` against JAX's promoted
``run_chunked``).  The knob grids of the replica axis (``sweep_dyn``,
``sweep_dyn_from``, ``run_replicated(dyn_rows=)``) equal JAX's counters
and final batches.  A leak check holds the tick's modules to reading a
promoted field from the spec only at a gate.
"""
import ast
import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from fognetsimpp_tpu import Policy
from fognetsimpp_tpu import dynspec as jdyn
from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.parallel import replicas as jreplicas
from fognetsimpp_tpu.parallel import sweep as jsweep
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu.scenarios import wireless as jw
from fognetsimpp_tpu_torch import dynspec as tdyn
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.parallel import replicas as treplicas
from fognetsimpp_tpu_torch.parallel import sweep as tsweep
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.scenarios import wireless as tw
from fognetsimpp_tpu_torch.state import state_to_numpy, tree_leaves, tree_map

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are small; one thread beside the other
    test workers, and no per-replica fallback under ``vmap``."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with treplicas.strict_vmap():
        yield
    torch.set_num_threads(old)


#: The families, each with promoted knobs that reach its tick.
FAMILIES = {
    # tests/test_torch_policies.py's LEARN world under DUCB, long enough
    # for credits to land: the discount and the reward scale (a divisor
    # that is not a power of two) ride the operand
    "learned_ducb": (jsmoke.build, tsmoke.build, dict(
        n_users=24, n_fogs=4, fog_mips=(40000.0, 80000.0, 20000.0, 60000.0),
        send_interval=0.02, horizon=0.6, start_time_max=0.02,
        queue_capacity=16, derive_acks=False, policy=int(Policy.DUCB),
        learn_discount=0.99, learn_reward_scale=0.3)),
    # a small wireless5: the energy knobs (the harvest phase divides by
    # its period) and the uplink loss beside the Bianchi loss
    "wireless5": (jw.wireless5, tw.wireless5, dict(
        numb_users=24, horizon=0.5, dt=0.01, extra_aps=4,
        policy=int(Policy.ENERGY_AWARE), idle_power_w=3e-3, harvest_duty=0.4,
        harvest_period_s=0.07, uplink_loss_prob=0.05, shutdown_frac=0.3)),
    # the smoke world with the loss gate on and a finite stop time
    "smoke_stop": (jsmoke.build, tsmoke.build, dict(
        n_users=16, n_fogs=3, send_interval=0.01, horizon=0.1,
        start_time_max=0.02, uplink_loss_prob=0.05, send_stop_time=0.06)),
}


def _jleaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _differing(port_tree, ref_leaves):
    """The leaf paths where the port's tree and the JAX leaves part."""
    paths = [p for p, _ in tree_leaves(port_tree)]
    got = state_to_numpy(port_tree)
    assert len(got) == len(ref_leaves) == len(paths)
    out = []
    for p, a, b in zip(paths, got, ref_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        if a.tobytes() != b.tobytes():
            out.append(p)
    return out


def _spec_dict(spec):
    return dataclasses.asdict(spec)


def _noop(state, done):
    """A callback: JAX's chunked runner then takes its undonated program
    (the donated one is not a usable oracle on this tree, ROADMAP §3)."""


# ----------------------------------------------------------------------
# the catalogue
# ----------------------------------------------------------------------

def test_catalogue_equals_jax():
    assert tdyn.DYN_FIELDS == jdyn.DYN_FIELDS
    assert tdyn.STATIC_REASONS == jdyn.STATIC_REASONS
    assert tdyn._CANONICAL == jdyn._CANONICAL
    assert tdyn._GATED_POSITIVE == jdyn._GATED_POSITIVE
    assert tdyn.BUCKET_FLOOR == jdyn.BUCKET_FLOOR
    assert tdyn._BUCKET_STEPS == jdyn._BUCKET_STEPS
    assert [f.name for f in dataclasses.fields(tdyn.DynSpec)] == [
        f.name for f in dataclasses.fields(jdyn.DynSpec)]


SPECS = {
    "smoke": dict(n_users=8, n_fogs=2, horizon=0.05),
    "stop_loss": dict(n_users=8, n_fogs=2, horizon=0.05, send_stop_time=0.03,
                      uplink_loss_prob=0.2, learn_reward_scale=0.3),
    "energy": dict(n_users=8, n_fogs=2, horizon=0.05, energy_enabled=True,
                   idle_power_w=3e-3, harvest_period_s=0.07, shutdown_frac=0.2),
    "brokers": dict(n_users=8, n_fogs=4, horizon=0.05),
}
#: Fields set on the built spec (a federated world the port cannot build).
EDITS = {"brokers": dict(n_brokers=2, hier_rtt_matrix=((0.0, 0.01), (0.02, 0.0)))}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_shape_key_split_and_dyn_of_equal_jax(name):
    kw, edits = SPECS[name], EDITS.get(name, {})
    tspec = dataclasses.replace(tsmoke.build(device="cpu", **kw)[0], **edits)
    jspec = dataclasses.replace(jsmoke.build(**kw)[0], **edits)
    assert _spec_dict(tdyn.shape_key(tspec)) == _spec_dict(jdyn.shape_key(jspec))
    tkey, tdv = tdyn.split_spec(tspec)
    jkey, jdv = jdyn.split_spec(jspec)
    assert _spec_dict(tkey) == _spec_dict(jkey)
    for f in dataclasses.fields(tdyn.DynSpec):
        a, b = np.asarray(getattr(tdv, f.name)), np.asarray(getattr(jdv, f.name))
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), f.name
    # the operand on the device carries the same bits
    dev = tdyn.dyn_to_device(tdv, "cpu")
    for f in dataclasses.fields(tdyn.DynSpec):
        a, b = getattr(dev, f.name).numpy(), np.asarray(getattr(jdv, f.name))
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), f.name
    other = dataclasses.replace(tspec, learn_discount=0.5)
    assert tdyn.same_program(tspec, other) == jdyn.same_program(
        jspec, dataclasses.replace(jspec, learn_discount=0.5))


def _error(fn, *args):
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


@pytest.mark.parametrize("knobs", [
    {"uplink_loss_prob": 0.3, "learn_reward_scale": 0.2},
    {"send_stop_time": 0.04, "idle_power_w": 1e-3},
])
def test_apply_knobs_equals_jax(knobs):
    kw = SPECS["stop_loss"]
    tspec = tsmoke.build(device="cpu", **kw)[0]
    jspec = jsmoke.build(**kw)[0]
    assert _spec_dict(tdyn.apply_knobs(tspec, knobs)) == _spec_dict(
        jdyn.apply_knobs(jspec, knobs))


@pytest.mark.parametrize("knobs", [
    {"dt": 2e-3},  # shape-defining, with its reason
    {"no_such_knob": 1.0},  # unknown
    {"uplink_loss_prob": 0.0},  # a gate flip
    {"send_stop_time": float("inf"), "learn_discount": 0.5},  # a gate flip
])
def test_apply_knobs_refuses_with_jax_text(knobs):
    kw = SPECS["stop_loss"]
    tspec = tsmoke.build(device="cpu", **kw)[0]
    jspec = jsmoke.build(**kw)[0]
    assert _error(tdyn.apply_knobs, tspec, knobs) == _error(jdyn.apply_knobs, jspec, knobs)


def test_classify_field_equals_jax():
    names = [f.name for f in dataclasses.fields(jsmoke.build(n_users=2, horizon=0.01)[0])]
    for name in names:
        assert tdyn.classify_field(name) == jdyn.classify_field(name), name
    assert _error(tdyn.classify_field, "nope") == _error(jdyn.classify_field, "nope")


def test_bucket_users_and_bucket_spec_equal_jax():
    for n in list(range(1, 40)) + [1024, 1025, 1536, 1537, 2048, 3071, 3073, 10_000, 99_999]:
        assert tdyn.bucket_users(n) == jdyn.bucket_users(n), n
        assert tdyn.bucket_users(n, floor=8) == jdyn.bucket_users(n, floor=8), n
    kw = dict(n_users=1100, n_fogs=2, horizon=0.01, max_sends_per_user=2)
    tspec, tst, tnet, _ = tsmoke.build(device="cpu", **kw)
    jspec, jst, jnet, _ = jsmoke.build(**kw)
    tspec2, tst2, tnet2 = tdyn.bucket_spec(tspec, tst, tnet)
    jspec2, jst2, jnet2 = jdyn.bucket_spec(jspec, jst, jnet)
    assert tspec2.n_users == jspec2.n_users == 1536
    assert _spec_dict(tspec2) == _spec_dict(jspec2)
    assert _differing(tst2, _jleaves(jst2)) == []
    assert _differing(tnet2, _jleaves(jnet2)) == []
    same = tdyn.bucket_spec(tspec2, tst2, tnet2)
    assert same[0] is tspec2 and same[1] is tst2


@pytest.mark.parametrize("env, want", [
    (None, True), ("1", True), ("0", False), ("off", False), ("no", False), ("", False),
])
def test_promote_default_reads_the_same_variable(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("FNS_SPEC_PROMOTE", raising=False)
    else:
        monkeypatch.setenv("FNS_SPEC_PROMOTE", env)
    assert tdyn.promote_default() == jdyn.promote_default() == want


def test_dyn_rows_lay_cells_end_to_end():
    spec = tsmoke.build(device="cpu", **SPECS["stop_loss"])[0]
    cells = [dataclasses.replace(spec, learn_discount=d, hier_max_hops=h)
             for d, h in ((0.5, 2), (0.25, 7))]
    rows = tdyn.dyn_rows([tdyn.dyn_of(c) for c in cells], "cpu", repeats=3)
    assert rows.learn_discount.tolist() == [0.5] * 3 + [0.25] * 3
    assert rows.hier_max_hops.dtype == torch.int32
    assert rows.hier_max_hops.tolist() == [2] * 3 + [7] * 3
    assert rows.hier_rtt.shape == (6, 1, 1)
    back = tdyn.dyn_to_device(tdyn.DynSpec(**{
        f.name: getattr(rows, f.name).numpy() for f in dataclasses.fields(rows)}), "cpu")
    assert all(torch.equal(getattr(back, f.name), getattr(rows, f.name))
               for f in dataclasses.fields(rows))


# ----------------------------------------------------------------------
# both arithmetic modes, per family
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_modes():
    """Each family's JAX ``run`` (host constants) and promoted
    ``run_chunked`` (a device operand), computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            jbuild, _, kw = FAMILIES[name]
            spec, st, net, b = jbuild(**kw)
            static, _ = jengine.run(spec, st, net, b)
            promoted = jengine.run_chunked(spec, st, net, b, promote=True, callback=_noop)
            cache[name] = (_jleaves(static), _jleaves(promoted))
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_host_constant_path_matches_jax_run(name, jax_modes):
    static, _ = jax_modes(name)
    _, tbuild, kw = FAMILIES[name]
    spec, st, net, b = tbuild(device="cpu", **kw)
    final, _ = tengine.run(spec, st, net, b)
    assert _differing(final, static) == []
    final_jit = tengine.run_jit(spec, st, net, b, promote=False)
    assert _differing(final_jit, static) == []


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_operand_path_matches_jax_promoted_run(name, jax_modes):
    static, promoted = jax_modes(name)
    _, tbuild, kw = FAMILIES[name]
    spec, st, net, b = tbuild(device="cpu", **kw)
    key, dyn = tdyn.split_spec(spec)
    final, _ = tengine.run(key, st, net, b, dyn=tdyn.dyn_to_device(dyn, "cpu"))
    assert _differing(final, promoted) == []
    assert _differing(tengine.run_jit(spec, st, net, b), promoted) == []
    if name == "learned_ducb":
        # the reward scale 0.3 divides: the promoted discounted sum parts
        # from the host constants' reciprocal product, as JAX's does
        assert float(final.learn.lat_cnt.sum()) > 0
        assert _differing(final, static) == ["learn.disc_sum"]
    if name == "wireless5":
        assert int(final.metrics.n_lost) > 0
        assert not bool(final.nodes.alive.all())


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
    with pytest.raises(NotImplementedError, match="item 27"):
        tsweep.sweep_dyn(tsmoke.build, {"uplink_loss_prob": [0.1]}, mesh=object(),
                         device="cpu", **kw)


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


# ----------------------------------------------------------------------
# the leak check (the counterpart of simlint R13)
# ----------------------------------------------------------------------

#: The modules of the port's tick.
TICK_MODULES = [
    "core/engine.py", "net/energy.py", "net/topology.py", "net/mobility.py",
    "learn/rewards.py", "learn/bandits.py", "ops/sched.py", "ops/queues.py",
    "parallel/taskshard.py", "parallel/shards.py",
]
#: The gate reads the tick may make of a promoted field on the spec
#: (``dynspec._GATED_POSITIVE`` and the finite stop time).
GATES = {("send_stop_time", "!=")} | {(f, ">") for f in tdyn._GATED_POSITIVE}


def _spec_reads(tree):
    """(field, comparison or None, line) of every ``spec.<promoted>``
    attribute read, and of ``spec_l`` / ``run_spec`` / ``key_spec``."""
    parents = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute) and node.attr in tdyn.DYN_FIELDS
                and isinstance(node.value, ast.Name)
                and node.value.id in ("spec", "spec_l", "run_spec", "key_spec")):
            up = parents.get(node)
            op = None
            if isinstance(up, ast.Compare) and up.left is node and len(up.ops) == 1:
                op = {ast.NotEq: "!=", ast.Gt: ">"}.get(type(up.ops[0]))
            out.append((node.attr, op, node.lineno))
    return out


def test_tick_reads_promoted_fields_from_the_spec_only_at_gates():
    pkg = REPO / "fognetsimpp_tpu_torch"
    leaks = []
    for rel in TICK_MODULES:
        tree = ast.parse((pkg / rel).read_text())
        for field, op, line in _spec_reads(tree):
            if (field, op) not in GATES:
                leaks.append(f"{rel}:{line} reads spec.{field}")
    assert leaks == []
    # the check sees a read: a leaked one fails it
    leaky = ast.parse("def f(spec, t):\n    return t < spec.send_stop_time\n")
    assert _spec_reads(leaky) == [("send_stop_time", None, 2)]
