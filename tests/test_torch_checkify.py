"""The runtime sanitizer (``engine.run_checkified``, ``--checkify``,
``FNS_CHECKIFY``) against JAX's ``jax.experimental.checkify`` run.

The world is ``tests/test_engine_smoke.py``'s, ``smoke.build(horizon=0.3,
seed=7)``: under ``div`` both runs are clean and the port's final state
equals its plain run and JAX's, every leaf; ``nan`` trips in both; a bad
set name raises the same ``ValueError`` in both.  ``oob`` is the
departure by design (``core/sanitizer.py``): JAX's trips on its drop-mode
scatter sentinel, the port's is clean, and a planted out-of-range index
trips it.  Small functions hold each set's rule to checkify's verdicts,
the departures pinned beside them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify
from jax.experimental.checkify import JaxRuntimeError

from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.core.sanitizer import CheckifyError, Sanitizer
from fognetsimpp_tpu_torch.ops.scatter import set_drop
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.scenarios import wireless as twireless
from fognetsimpp_tpu_torch.state import state_to_numpy
from tests.torch_cli_support import run_main


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


WORLD = dict(horizon=0.3, seed=7)


def _jax(errors):
    """JAX's verdict on the smoke world: ``(final leaves, None)`` or
    ``(None, error)``."""
    try:
        final, _ = jengine.run_checkified(*jsmoke.build(**WORLD), errors=errors)
    except (JaxRuntimeError, ValueError) as e:
        return None, e
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(final)], None


def _port(errors):
    try:
        final, _ = tengine.run_checkified(*tsmoke.build(device="cpu", **WORLD), errors=errors)
    except (CheckifyError, ValueError) as e:
        return None, e
    return state_to_numpy(final), None


@pytest.fixture(scope="module")
def plain():
    """The port's plain run and JAX's, every leaf."""
    final, _ = tengine.run(*tsmoke.build(device="cpu", **WORLD))
    jfinal, _ = jengine.run(*jsmoke.build(**WORLD))
    return state_to_numpy(final), [np.asarray(x) for x in jax.tree_util.tree_leaves(jfinal)]


def _same(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), i


def test_div_is_clean_and_every_leaf_equals_the_plain_runs(plain):
    port, err = _port("div")
    jax_leaves, jerr = _jax("div")
    assert err is None and jerr is None
    _same(port, plain[0])
    _same(port, jax_leaves)
    _same(plain[0], plain[1])


def test_nan_trips_in_both_at_a_subtraction():
    """The engine's masked-lane ``inf - inf`` (the documented benign
    class): JAX names ``sub``, the port ``aten::sub``."""
    _, err = _port("nan")
    _, jerr = _jax("nan")
    assert isinstance(err, CheckifyError) and isinstance(jerr, JaxRuntimeError)
    assert err.set == "nan" and err.op == "aten::sub"
    assert "primitive: sub" in str(jerr) and "aten::sub" in str(err)


@pytest.mark.parametrize("names", ["bogus", "nan,bogus", "0", "div,oob,x"])
def test_bad_set_names_raise_the_same_message(names):
    _, err = _port(names)
    _, jerr = _jax(names)
    assert type(err) is ValueError and type(jerr) is ValueError
    assert str(err) == str(jerr)


_JAX_SETS = {
    next(iter(checkify.nan_checks)): "nan",
    next(iter(checkify.div_checks)): "div",
    next(iter(checkify.index_checks)): "oob",
}


@pytest.mark.parametrize("names", [
    None, "", "1", "on", "true", "div", "all", "nan", "oob", "nan,oob", " oob , div ",
    "div,div",
])
def test_set_spellings_pick_what_jax_picks(names):
    want = {_JAX_SETS[e] for e in jengine._checkify_errors(names) if e in _JAX_SETS}
    assert set(tengine._checkify_errors(names)) == want


def test_oob_departure_jax_trips_on_its_drop_sentinel_the_port_is_clean(plain):
    port, err = _port("oob")
    _, jerr = _jax("oob")
    assert isinstance(jerr, JaxRuntimeError) and "out-of-bounds" in str(jerr)
    assert err is None
    _same(port, plain[0])


def test_a_planted_out_of_range_index_trips_the_ports_oob():
    """An access point's node index past the node table: the plain run
    refuses it (``IndexError``); the sanitized run gets to its end on a
    repaired index and raises naming ``oob`` and ``aten::index``."""
    spec, st, net, b = twireless.wireless5(device="cpu", numb_users=12, horizon=0.4)
    ap = net.ap_nodes.clone()
    ap[0] = spec.n_nodes + 3
    bad = net.replace(ap_nodes=ap)
    tengine.run_checkified(spec, st, net, b, n_ticks=3, errors="oob")
    with pytest.raises(IndexError):
        tengine.run(spec, st, bad, b, n_ticks=3)
    with pytest.raises(CheckifyError, match="oob") as e:
        tengine.run_checkified(spec, st, bad, b, n_ticks=3, errors="all")
    assert e.value.op == "aten::index"


# ----------------------------------------------------------------------
# each set's rule on small functions, against checkify's verdicts
# ----------------------------------------------------------------------

def _jax_verdict(fn, errors, *args):
    err, _ = jax.jit(checkify.checkify(fn, errors=errors))(*args)
    return err.get() is not None


def _port_verdict(fn, sets, *args):
    with Sanitizer(sets) as s:
        fn(*args)
    try:
        s.throw()
    except CheckifyError:
        return True
    return False


_F = np.array([1.0, np.inf], np.float32)
_I = np.array([7, 5], np.int32)
_Z = np.array([2, 0], np.int32)

#: name -> (set, JAX function, port function, inputs, JAX trips, port trips)
_RULES = {
    "inf_minus_inf": ("nan", lambda x: x - x, lambda x: x - x, (_F,), True, True),
    # the engine's idiom: the untaken lane of a select computes inf - inf
    "untaken_lane_inf_minus_inf": (
        "nan", lambda x: jnp.where(x > 5, 0.0, x - jnp.inf),
        lambda x: torch.where(x > 5, 0.0, x - float("inf")), (_F,), True, True),
    "inf_times_zero": ("nan", lambda x: x * 0.0, lambda x: x * 0.0, (_F,), True, True),
    "nan_through_max": (
        "nan", lambda x: jnp.maximum(x, jnp.nan),
        lambda x: torch.maximum(x, torch.tensor(float("nan"))), (_F,), False, False),
    "nan_through_neg_and_abs": (
        "nan", lambda x: jnp.abs(-x),
        lambda x: torch.abs(-x), (np.array([np.nan], np.float32),), False, False),
    "int_floor_division_by_zero": (
        "div", lambda a, b: a // b, lambda a, b: torch.div(a, b, rounding_mode="floor"),
        (_I, _Z), True, True),
    "int_division_by_a_nonzero": (
        "div", lambda a, b: a // b, lambda a, b: a // b, (_I, _I), False, False),
    "index_past_the_end": (
        "oob", lambda x: x[jnp.array([5])], lambda x: x[torch.tensor([5])], (_F,), True, True),
    "negative_index": (
        "oob", lambda x: x[jnp.array([-1])], lambda x: x[torch.tensor([-1])], (_F,), False, False),
    "gather_past_the_end": (
        "oob", lambda x: jnp.take_along_axis(x, jnp.array([2]), 0),
        lambda x: torch.gather(x, 0, torch.tensor([2])), (_F,), True, True),
    # the departures by design (core/sanitizer.py): the drop-mode
    # scatter's sentinel, a float division by zero (an IEEE inf in
    # torch), an integer remainder by zero (an error or garbage in torch)
    "drop_scatter_sentinel": (
        "oob", lambda x: x.at[jnp.array([2])].set(0.0, mode="drop"),
        lambda x: set_drop(x, torch.tensor([2]), 0.0), (_F,), True, False),
    "float_division_by_zero": (
        "div", lambda x: x / jnp.array([1.0, 0.0], jnp.float32),
        lambda x: x / torch.tensor([1.0, 0.0]), (_F,), True, False),
    "int_remainder_by_zero": (
        "div", lambda a, b: jnp.remainder(a, b), lambda a, b: torch.remainder(a, b),
        (_I, _Z), False, True),
}
_JAX_ERRORS = {"nan": checkify.nan_checks, "div": checkify.div_checks, "oob": checkify.index_checks}


@pytest.mark.parametrize("name", sorted(_RULES))
def test_set_rule_against_checkify(name):
    sets, jfn, tfn, args, jax_trips, port_trips = _RULES[name]
    assert _jax_verdict(jfn, _JAX_ERRORS[sets], *[jnp.asarray(a) for a in args]) is jax_trips
    from fognetsimpp_tpu_torch.device import host_routes

    with host_routes(False):
        got = _port_verdict(tfn, {sets}, *[torch.from_numpy(a.copy()) for a in args])
    assert got is port_trips


def test_a_trip_repairs_the_operand_and_names_the_first_operator():
    a = torch.tensor([7, 5], dtype=torch.int32)
    with Sanitizer({"div", "oob"}) as s:
        q = torch.div(a, torch.tensor([2, 0], dtype=torch.int32), rounding_mode="floor")
        r = a % torch.zeros(2, dtype=torch.int32)  # a later trip, on another operator
    assert q.tolist() == [3, 5] and r.tolist() == [0, 0]
    with pytest.raises(CheckifyError, match="div") as e:
        s.throw()
    assert e.value.op == "aten::div"


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------

_CLI_WORLD = ["-s", "smoke", "--set", "spec.horizon=0.02", "--set", "scenario.n_users=4",
              "--platform", "cpu"]


def _both(argv, capsys):
    from fognetsimpp_tpu.__main__ import main as jmain
    from fognetsimpp_tpu_torch.__main__ import main as tmain

    return run_main(jmain, argv, capsys), run_main(tmain, argv, capsys)


def _last_line(err):
    return err.strip().splitlines()[-1].split(": error: ")[-1]


@pytest.mark.parametrize("extra, env", [
    (["--checkify", "--replicas", "2"], None),
    (["--checkify", "nan", "--progress", "5"], None),
    (["--sweep", "policies=min_busy loads=0.01"], "1"),
    (["--tp", "2"], "div"),
])
def test_cli_checkify_solo_refusal_matches_jax(extra, env, capsys, monkeypatch):
    if env is not None:
        monkeypatch.setenv("FNS_CHECKIFY", env)
    (jrc, _, jerr), (trc, _, terr) = _both(_CLI_WORLD + extra, capsys)
    assert trc == jrc == 2
    assert _last_line(terr) == _last_line(jerr)
    assert _last_line(terr).startswith("[CLI-CHECKIFY-SOLO] --checkify/FNS_CHECKIFY is the")


@pytest.mark.parametrize("extra, env, rc", [
    (["--checkify"], None, 0),
    ([], "div", 0),
    ([], "0", 0),
    (["--checkify", "nan"], None, 1),
    (["--checkify", "bogus"], None, 1),
])
def test_cli_checkify_run_matches_jax(extra, env, rc, capsys, monkeypatch):
    from tests.torch_cli_support import assert_same_summary

    if env is not None:
        monkeypatch.setenv("FNS_CHECKIFY", env)
    (jrc, jout, jerr), (trc, tout, terr) = _both(_CLI_WORLD + extra, capsys)
    assert trc == jrc == rc
    if rc == 0:
        assert_same_summary(jout, tout)
        return
    jline, tline = jerr.strip().splitlines()[-1], terr.strip().splitlines()[-1]
    assert jline.startswith("error: checkify: ") and tline.startswith("error: checkify: ")
    if "bogus" in extra:
        assert tline == jline
    else:
        assert "primitive: sub" in jline and tline == "error: checkify: nan: nan generated by operator aten::sub"
