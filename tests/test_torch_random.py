"""The port's threefry2x32 against ``jax.random``, bit for bit."""
import jax
import numpy as np
import pytest
import torch

from fognetsimpp_tpu_torch import random as trandom
from fognetsimpp_tpu_torch.f32math import fma


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


SEEDS = [0, 1, 42, 123456789, 2 ** 31 - 1, -7]
SHAPES = [(), (1,), (7,), (3, 4), (1001, 2), (20000,)]


def _key_np(k):
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_fold_in(seed):
    kj = jax.random.PRNGKey(seed)
    kt = trandom.PRNGKey(seed)
    np.testing.assert_array_equal(_key_np(kj), kt.numpy())
    for n in (2, 3, 4, 5, 17):
        np.testing.assert_array_equal(
            _key_np(jax.random.split(kj, n)), trandom.split(kt, n).numpy()
        )
    for d in (0, 1, 0x0B57, 12345, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            _key_np(jax.random.fold_in(kj, d)), trandom.fold_in(kt, d).numpy()
        )
    # chains: a split of a fold of a split
    kj2 = jax.random.split(jax.random.fold_in(jax.random.split(kj, 3)[2], 9))[1]
    kt2 = trandom.split(trandom.fold_in(trandom.split(kt, 3)[2], 9))[1]
    np.testing.assert_array_equal(_key_np(kj2), kt2.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (0.0, 1e-9), (0.9, 1.1), (1e-7, 1.0), (0.0, 0.05)])
def test_uniform_bit_exact(seed, bounds):
    kj = jax.random.split(jax.random.PRNGKey(seed), 3)[1]
    kt = trandom.split(trandom.PRNGKey(seed), 3)[1]
    lo, hi = bounds
    for shape in SHAPES:
        want = np.asarray(
            jax.random.uniform(kj, shape, np.float32, minval=lo, maxval=hi)
        )
        got = trandom.uniform(kt, shape, lo, hi).numpy()
        assert want.dtype == got.dtype and want.shape == got.shape
        assert want.tobytes() == got.tobytes(), (shape, bounds)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bounds", [(200, 901), (0, 7), (-5, 5), (3, 3), (0, 2 ** 31 - 1)])
def test_randint_bit_exact(seed, bounds):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    kt = trandom.fold_in(trandom.PRNGKey(seed), 3)
    lo, hi = bounds
    for shape in SHAPES:
        want = np.asarray(jax.random.randint(kj, shape, lo, hi))
        got = trandom.randint(kt, shape, lo, hi).numpy()
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(want, got)


def _nearest_f32(exact):
    """The float32 nearest to a rational, ties to even."""
    from fractions import Fraction

    near = np.float32(float(exact))
    cands = (
        np.nextafter(near, np.float32(-np.inf)), near,
        np.nextafter(near, np.float32(np.inf)),
    )
    return min(
        cands,
        key=lambda v: (abs(Fraction(float(v)) - exact), int(v.view(np.int32)) & 1),
    )


def test_fma_is_singly_rounded():
    """``fma`` equals the exact ``a * b + c`` rounded once to float32,
    including a sum that double rounding (float64, then float32) gets
    wrong: 1 + 2^-11 + 2^-24 + 2^-60 lies just above a float32 midpoint."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    n = 3000
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    c = (rng.standard_normal(n) * 10.0 ** rng.integers(-12, 4, n)).astype(np.float32)
    h = np.float32(1 + 2 ** -12)
    a = np.append(a, h)
    b = np.append(b, h)
    c = np.append(c, np.float32(2 ** -60))
    got = fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    assert got[-1] == np.float32(1 + 2 ** -11 + 2 ** -23)
    for i in range(a.shape[0]):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        assert got[i] == _nearest_f32(exact), (a[i], b[i], c[i])


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_over_a_tensor_of_data(seed):
    """The tensor form of ``fold_in``: one key folded with each datum
    (data at and past 2^31 included), and a batch of keys folded with a
    datum each, equal to the vmapped ``jax.random.fold_in``."""
    kj, kt = jax.random.PRNGKey(seed), trandom.PRNGKey(seed)
    data = np.array([0, 1, 7, 0x0C4A05, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 5,
                     2 ** 32 - 1], np.uint32)
    want = jax.vmap(lambda d: jax.random.fold_in(kj, d))(data)
    got = trandom.fold_in(kt, torch.from_numpy(data.astype(np.int64)))
    np.testing.assert_array_equal(_key_np(want), got.numpy())
    # int32 data wraps to its uint32 bits, as jnp.uint32 wraps it
    got32 = trandom.fold_in(kt, torch.from_numpy(data.view(np.int32)))
    np.testing.assert_array_equal(_key_np(want), got32.numpy())
    for d in data.tolist():
        np.testing.assert_array_equal(
            _key_np(jax.random.fold_in(kj, d)), trandom.fold_in(kt, d).numpy()
        )
    # per-fog keys folded with a per-fog epoch, then a (2,) draw a key
    keys_j = jax.vmap(lambda f: jax.random.fold_in(kj, f))(np.arange(5, dtype=np.int32))
    epochs = np.array([0, 3, 2 ** 31, 9, 1], np.uint32)
    want = jax.vmap(jax.random.fold_in)(keys_j, epochs)
    keys_t = trandom.fold_in(kt, torch.arange(5))
    got = trandom.fold_in(keys_t, torch.from_numpy(epochs.astype(np.int64)))
    np.testing.assert_array_equal(_key_np(want), got.numpy())
    draws = jax.vmap(lambda k: jax.random.uniform(k, (2,), np.float32, 1e-7, 1.0))(want)
    assert np.asarray(draws).tobytes() == trandom.uniform(got, (2,), 1e-7, 1.0).numpy().tobytes()
