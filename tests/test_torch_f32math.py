"""The port's float32 ``sin``/``cos`` against ``jnp.sin``/``jnp.cos``.

XLA's CPU backend calls the C library's ``sinf``/``cosf``;
``f32math.sinf``/``cosf`` are glibc's algorithm in float64 and int64
torch ops, held here bit for bit (0 ulp) against JAX on seeded inputs:
the CIRCLE mobility's range [-120, 120], signed zeros and tiny values,
values beside multiples of pi/2, and the integer reduction past 120.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fognetsimpp_tpu_torch.f32math import cosf, sinf

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
