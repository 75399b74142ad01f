"""The port's float32 primitives against XLA's CPU ones, bit for bit.

* ``sinf``/``cosf`` (XLA calls the C library's; the port has glibc's
  algorithm in float64 and int64 torch ops) on the CIRCLE mobility's
  range [-120, 120], signed zeros and tiny values, values beside
  multiples of pi/2, and the integer reduction past 120;
* ``expf``, ``logf`` and ``log1pf`` (XLA inlines Cephes-style
  polynomials with contracted multiply-adds, and flushes subnormals):
  2^21 inputs over [-104, 89], the reward domain ``-lat / 0.25`` for lat
  in [0, 60] s, the integers 0..2^22 and 2^21 log-uniform positives;
* ``xla_sum`` and ``xla_cumsum`` (XLA's tree of padded windows of 32,
  and its blocks of 16) on the shapes the learners reduce;
* the multiply-adds XLA contracts in the learners and the scheduler.

Every primitive's test also shows that the torch builtin parts from XLA
on the same inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fognetsimpp_tpu_torch.f32math import (
    cosf, expf, fma, log1pf, logf, sinf, xla_cumsum, xla_sum,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


_SIN = jax.jit(jnp.sin)
_COS = jax.jit(jnp.cos)


def _inputs(kind: str) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "range":  # 2^20 + 2^18 inputs where CIRCLE angles live
        return rng.uniform(-120.0, 120.0, (1 << 20) + (1 << 18)).astype(np.float32)
    if kind == "special":
        f = np.finfo(np.float32)
        vals = [0.0, -0.0, f.tiny, -f.tiny, 1e-45, 1e-40, 2.0 ** -12, 2.0 ** -13,
                0.74, 0.75, 0.7853981, 0.7853982, 119.99999, 120.0, -120.0,
                np.inf, -np.inf, np.nan]
        return np.array(vals, np.float32)
    if kind == "near_half_pi":  # the reduction's cancellation
        k = np.arange(-80, 81, dtype=np.float64)
        x = (k * (np.pi / 2)).astype(np.float32)
        near = [x]
        for _ in range(4):
            near.append(np.nextafter(near[-1], np.float32(np.inf)))
        lo = [x]
        for _ in range(4):
            lo.append(np.nextafter(lo[-1], np.float32(-np.inf)))
        return np.concatenate(near + lo[1:]).astype(np.float32)
    if kind == "past_120":
        big = rng.uniform(120.0, 2.0e5, 4000)
        huge = 10.0 ** rng.uniform(5.0, 38.0, 2000)
        x = np.concatenate([big, huge])
        return (x * rng.choice([-1.0, 1.0], x.size)).astype(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["range", "special", "near_half_pi", "past_120"])
@pytest.mark.parametrize("fn", ["sin", "cos"])
def test_sinf_cosf_match_jax_bit_for_bit(fn, kind):
    x = _inputs(kind)
    want = np.asarray((_SIN if fn == "sin" else _COS)(x))
    got = (sinf if fn == "sin" else cosf)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    bad = np.nonzero(want.view(np.int32) != got.view(np.int32))[0]
    if kind == "special":  # NaN payloads may differ; NaN must stay NaN
        nan = np.isnan(want)
        assert np.array_equal(nan, np.isnan(got))
        bad = bad[~nan[bad]]
    assert bad.size == 0, (
        f"{fn}: {bad.size} of {x.size} differ, first x={x[bad[0]]!r}: "
        f"JAX {want[bad[0]]!r}, port {got[bad[0]]!r}"
    )


def test_torch_sin_is_not_enough():
    """The reason for the port's own ``sinf``: ``torch.sin`` parts from XLA
    in the last bit on a share of the CIRCLE range."""
    x = _inputs("range")[:200_000]
    want = np.asarray(_SIN(x)).view(np.int32)
    assert (torch.sin(torch.from_numpy(x)).numpy().view(np.int32) != want).any()
    assert (sinf(torch.from_numpy(x)).numpy().view(np.int32) == want).all()


def test_sinf_refuses_other_dtypes():
    with pytest.raises(TypeError):
        sinf(torch.zeros(3, dtype=torch.float64))


# ----------------------------------------------------------------------
# exp, log, log1p
# ----------------------------------------------------------------------

def _assert_bits(want, got, x, what):
    want, got = np.asarray(want).ravel(), np.asarray(got).ravel()
    x = np.asarray(x).ravel()
    assert got.dtype == np.float32 and got.shape == want.shape
    bad = np.nonzero(want.view(np.int32) != got.view(np.int32))[0]
    bad = bad[~(np.isnan(want[bad]) & np.isnan(got[bad]))]
    assert bad.size == 0, (
        f"{what}: {bad.size} of {want.size} differ, first x={x[bad[0]]!r}: "
        f"JAX {want[bad[0]]!r}, port {got[bad[0]]!r}"
    )


def _differs(want, got) -> bool:
    want, got = np.asarray(want), np.asarray(got)
    return bool((want.view(np.int32) != got.view(np.int32)).any())


def _exp_inputs(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "range":  # past both clamps and the flush to zero
        return rng.uniform(-104.0, 89.0, 1 << 21).astype(np.float32)
    if kind == "reward":  # -lat / 0.25 for lat in [0, 60] s, as the engine
        lat = rng.uniform(0.0, 60.0, 1 << 20).astype(np.float32)
        return -lat * np.float32(4.0)
    if kind == "special":
        return np.array([0.0, -0.0, 1e-45, -1e-40, 1.0, -87.3, -87.7, -87.8,
                         -88.0, 88.7, 88.8, 89.0, np.inf, -np.inf, np.nan],
                        np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["range", "reward", "special"])
def test_expf_matches_jax_bit_for_bit(kind):
    x = _exp_inputs(kind)
    want = jax.jit(jnp.exp)(x)
    _assert_bits(want, expf(torch.from_numpy(x)).numpy(), x, "exp")
    if kind != "special":
        assert _differs(want, torch.exp(torch.from_numpy(x)).numpy())


def _log_inputs(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "integers":  # UCB's log1p(total) sees integer totals
        return np.arange(0, (1 << 22) + 1, dtype=np.float32)
    if kind == "positives":  # log-uniform, subnormals included
        return np.exp(rng.uniform(-103.0, 88.0, 1 << 21)).astype(np.float32)
    if kind == "small":  # log1p's rational branch, |x| < sqrt(2) - 1
        return rng.uniform(-0.5, 0.5, 1 << 20).astype(np.float32)
    if kind == "special":
        return np.array([0.0, -0.0, 1e-45, 1e-40, 1.17549435e-38, 1.0, -1.0,
                         -1e-30, 0.41421354, 0.41421357, np.inf, -np.inf,
                         np.nan], np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["integers", "positives", "small", "special"])
@pytest.mark.parametrize("fn", ["log", "log1p"])
def test_logf_log1pf_match_jax_bit_for_bit(fn, kind):
    x = _log_inputs(kind)
    if fn == "log" and kind == "small":
        x = np.abs(x)
    ours, builtin = (logf, torch.log) if fn == "log" else (log1pf, torch.log1p)
    want = jax.jit(getattr(jnp, fn))(x)
    _assert_bits(want, ours(torch.from_numpy(x)).numpy(), x, fn)
    if kind != "special":
        assert _differs(want, builtin(torch.from_numpy(x)).numpy())


def test_exp_log_refuse_other_dtypes():
    for f in (expf, logf, log1pf, xla_cumsum, xla_sum):
        with pytest.raises(TypeError):
            f(torch.zeros(3, dtype=torch.float64))


# ----------------------------------------------------------------------
# reductions and scans
# ----------------------------------------------------------------------

def _rows(F, K, seed):
    """Rows of mixed magnitude and sign with zeros: the order shows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((F, K)) * 10.0 ** rng.uniform(-3, 3, (F, K))
    x[rng.random((F, K)) < 0.3] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("K", [33, 100, 1024, 1556, 4096])
@pytest.mark.parametrize("F", [4, 32, 64])
def test_xla_sum_rows_match_jax(F, K):
    x = _rows(F, K, seed=F * 7919 + K)
    want = jax.jit(lambda a: jnp.sum(a, axis=1))(x)
    _assert_bits(want, xla_sum(torch.from_numpy(x)).numpy(), x, "sum")
    assert _differs(want, torch.from_numpy(x).sum(dim=1).numpy())


@pytest.mark.parametrize("n", [3, 32, 33, 40000])
def test_xla_sum_of_a_vector_matches_jax(n):
    """The (F,) and (K,) full sums: the pick totals, the softmax's mass."""
    x = _rows(1, n, seed=n)[0]
    want = jax.jit(jnp.sum)(x)
    _assert_bits(want, xla_sum(torch.from_numpy(x)).numpy(), x, "sum")
    # along another axis too: the (F, K) membership sums over F
    m = _rows(n if n < 100 else 64, 5, seed=n + 1)
    want = jax.jit(lambda a: jnp.sum(a, axis=0))(m)
    _assert_bits(want, xla_sum(torch.from_numpy(m), dim=0).numpy(), m, "sum0")


@pytest.mark.parametrize("F", [4, 32, 64, 100, 300])
def test_xla_cumsum_matches_jax(F):
    rng = np.random.default_rng(F)
    x = (rng.random((50, F)) * 10.0 ** rng.uniform(-3, 3, (50, F))).astype(np.float32)
    cs = jax.jit(jnp.cumsum)
    want = np.stack([np.asarray(cs(r)) for r in x])
    _assert_bits(want, xla_cumsum(torch.from_numpy(x)).numpy(), x, "cumsum")
    # torch's CPU cumsum accumulates in float64: other bits even at F = 4
    assert _differs(want, torch.cumsum(torch.from_numpy(x), dim=1).numpy())


# ----------------------------------------------------------------------
# contracted multiply-adds
# ----------------------------------------------------------------------

def _contraction(name, rng, n=1 << 16):
    """(XLA's expression as the source writes it, its inputs, the port's
    single-rounded form, the twice-rounded form)."""
    f32 = np.float32
    t = torch.from_numpy
    a, b, c = (rng.standard_normal(n).astype(f32) * 3 for _ in range(3))
    if name == "discount":  # rewards.py:118-119, disc * g + new
        g = f32(0.995)
        c = np.abs(np.round(c)).astype(f32)
        return (lambda a, c: a * g + c, (a, c),
                fma(t(a), torch.full((n,), g), t(c)), t(a) * g + t(c))
    if name == "ucb_index":  # bandits.py:137, mean + explore * sqrt(...)
        e, r = f32(0.37), np.abs(b)
        sq = torch.sqrt(t(r).double()).float()
        return (lambda m, r: m + e * jnp.sqrt(r), (a, r),
                fma(torch.full((n,), e), sq, t(a)), t(a) + e * sq)
    if name == "exp3_mix":  # bandits.py:175, (1 - mix) * sm + mix * a / n
        mix, sm = f32(0.3), np.abs(a) / 10
        av = (b > 0).astype(f32)
        nav = f32(7.0)

        def xla(sm, av, nv):
            return (1.0 - mix) * sm + mix * av / nv
        q = mix * t(av) / torch.tensor(nav)
        return (xla, (sm, av, np.full(n, nav, f32)),
                fma(torch.full((n,), 1 - mix), t(sm), q), (1 - mix) * t(sm) + q)
    if name == "energy":  # sched.py:329-333, busy + est + 10 * (1 - frac)
        busy, est, frac = np.abs(a), np.abs(b), np.abs(c) % 1

        def xla(busy, est, frac):
            return busy + est + 10.0 * (1.0 - frac)
        base = t(busy) + t(est)
        return (xla, (busy, est, frac),
                fma(torch.full((n,), 10.0), 1.0 - t(frac), base),
                base + 10.0 * (1.0 - t(frac)))
    if name == "exp3_gain":  # rewards.py:106-109, logw + eta * gain
        eta = f32(0.37) / f32(32)
        return (lambda w, s: w + eta * s, (a, np.abs(b)),
                fma(torch.full((n,), eta), t(np.abs(b)), t(a)), t(a) + eta * t(np.abs(b)))
    raise ValueError(name)


@pytest.mark.parametrize(
    "name", ["discount", "ucb_index", "exp3_mix", "energy", "exp3_gain"]
)
def test_contracted_multiply_adds_match_jax(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    xla, args, single, twice = _contraction(name, rng)
    want = jax.jit(xla)(*args)
    _assert_bits(want, single.numpy(), args[0], name)
    assert _differs(want, twice.numpy())
