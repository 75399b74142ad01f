"""Checkpoints across the two packages (``runtime/checkpoint.py``).

Both write one npz: ``leaf_<i>`` in JAX's leaf order and ``spec_json``.
A checkpoint written by JAX and resumed by the port continues as JAX's
own resume does, every leaf bit for bit, and the other way round; the
port writes the same file JAX writes for the same state; a leaf whose
shape or dtype is not the spec's is refused.
"""
import jax
import numpy as np
import pytest
import torch

from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.runtime import checkpoint as jckpt
from fognetsimpp_tpu.scenarios import wireless as jwireless
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.runtime import checkpoint as tckpt
from fognetsimpp_tpu_torch.scenarios import wireless as twireless
from fognetsimpp_tpu_torch.state import state_to_numpy


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


#: A moving, battery-powered world: positions, energy and the PRNG key
#: all carry over the checkpoint.
WORLD = dict(numb_users=12, horizon=0.4)
FIRST = REST = 20  # one program a package: JAX compiles a run per length


def _jax_leaves(state):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


def _same(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), i


@pytest.fixture(scope="module")
def worlds():
    jspec, jst, jnet, jb = jwireless.wireless5(**WORLD)
    tspec, tst, tnet, tb = twireless.wireless5(device="cpu", **WORLD)
    return (jspec, jst, jnet, jb), (tspec, tst, tnet, tb)


def test_jax_checkpoint_resumed_by_the_port(worlds, tmp_path):
    (jspec, jst, jnet, jb), (_, _, tnet, tb) = worlds
    mid, _ = jengine.run(jspec, jst, jnet, jb, n_ticks=FIRST)
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, jspec, mid)
    spec_j, state_j = jckpt.load(path)
    want, _ = jengine.run(spec_j, state_j, jnet, jb, n_ticks=REST)
    spec_t, state_t = tckpt.load(path, device="cpu")
    assert spec_t.n_ticks == spec_j.n_ticks and int(state_t.tick) == FIRST
    got, _ = tengine.run(spec_t, state_t, tnet, tb, n_ticks=REST)
    _same(state_to_numpy(got), _jax_leaves(want))


def test_port_checkpoint_resumed_by_jax(worlds, tmp_path):
    (_, _, jnet, jb), (tspec, tst, tnet, tb) = worlds
    mid, _ = tengine.run(tspec, tst, tnet, tb, n_ticks=FIRST)
    path = str(tmp_path / "port.npz")
    tckpt.save(path, tspec, mid)
    spec_t, state_t = tckpt.load(path, device="cpu")
    got, _ = tengine.run(spec_t, state_t, tnet, tb, n_ticks=REST)
    spec_j, state_j = jckpt.load(path)
    want, _ = jengine.run(spec_j, state_j, jnet, jb, n_ticks=REST)
    _same(state_to_numpy(got), _jax_leaves(want))
    # the same file JAX writes for that state
    jpath = str(tmp_path / "again.npz")
    jckpt.save(jpath, spec_j, state_j)
    a, b = np.load(path), np.load(jpath)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def test_load_refuses_a_leaf_off_the_spec(worlds, tmp_path):
    _, (tspec, tst, _, _) = worlds
    path = str(tmp_path / "x.npz")
    tckpt.save(path, tspec, tst)
    z = dict(np.load(path))
    z["leaf_3"] = z["leaf_3"][:-1]
    np.savez(path, **z)
    with pytest.raises(ValueError, match="leaf"):
        tckpt.load(path, device="cpu")
    z.pop(f"leaf_{len(z) - 2}")
    np.savez(path, **z)
    with pytest.raises(ValueError, match="state leaves"):
        tckpt.load(path, device="cpu")
