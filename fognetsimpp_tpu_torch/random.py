"""threefry2x32 in PyTorch, bit-exact with ``jax.random``.

The JAX engine draws every random number from ``jax.random`` with the
default threefry2x32 implementation and ``jax_threefry_partitionable=True``.
The port must draw the same bits, or no leaf downstream can match, so this
module re-implements the functions the slice needs:

* :func:`PRNGKey`, :func:`split`, :func:`fold_in` — the key algebra
  (``jax/_src/prng.py``: ``threefry_seed``, ``_threefry_split_foldlike``,
  ``threefry_fold_in``);
* :func:`random_bits`, :func:`uniform`, :func:`randint` — the samplers
  (``jax/_src/random.py``: ``_uniform``, ``_randint``).

A key is an ``int64`` tensor of shape ``(2,)`` holding the two uint32
words; every intermediate is an ``int64`` tensor masked with
``& 0xFFFFFFFF`` after each add and shift, which is uint32 arithmetic
without relying on PyTorch's partial unsigned-dtype support.  The
functions run on whatever device the key lies on.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from .f32math import bitcast, fma

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(
    k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 block cipher on uint32 words held in int64.

    ``k1``/``k2`` are 0-d key words, ``x1``/``x2`` the counter words
    (any shape, broadcast together); returns the two output words.
    Same 20 rounds and key injections as
    ``jax._src.prng._threefry2x32_lowering``.
    """
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _M32
    x1_ = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1_) & _M32
            x1_ = _rotl(x1_, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1_ = (x1_ + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1_


def PRNGKey(seed: int, device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]``."""
    s = int(seed)
    if not -(2 ** 31) <= s < 2 ** 31:
        raise ValueError(f"seed {seed} is outside the int32 range")
    # fills on the device: a tensor from host data would be a copy
    # that waits for the card
    return torch.cat([
        torch.zeros((1,), dtype=torch.int64, device=device),
        torch.full((1,), s & _M32, dtype=torch.int64, device=device),
    ])


def _counts(shape: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iota_2x32_shape``: the row-major flat index as (hi, lo) words."""
    n = int(np.prod(shape)) if len(shape) else 1
    flat = torch.arange(n, dtype=torch.int64, device=device)
    return (flat >> 32).reshape(shape), (flat & _M32).reshape(shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` (partitionable): ``(num, 2)`` keys."""
    c1, c2 = _counts((num,), key.device)
    b1, b2 = threefry2x32(key[0], key[1], c1, c2)
    return torch.stack([b1, b2], dim=1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    d = torch.tensor([0, int(data) & _M32], dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], d[:1], d[1:])
    return torch.cat([b1, b2])


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element (partitionable): ``bits1 ^ bits2``."""
    c1, c2 = _counts(tuple(shape), key.device)
    b1, b2 = threefry2x32(key[0], key[1], c1, c2)
    return b1 ^ b2


def _bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """Reinterpret uint32 words (in int64) as float32 bit patterns."""
    return bitcast(
        torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32),
        torch.float32,
    )


def uniform(
    key: torch.Tensor,
    shape: Sequence[int] = (),
    minval: float = 0.0,
    maxval: float = 1.0,
) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``.

    The mantissa trick of ``_uniform``: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled and shifted in float32 (``minval``
    and ``maxval`` are rounded to float32 first, as ``convert_element_type``
    does), then clamped below by ``minval``.
    """
    dev = key.device
    lo = torch.full((), minval, dtype=torch.float32, device=dev)
    hi = torch.full((), maxval, dtype=torch.float32, device=dev)
    bits = random_bits(key, shape)
    fbits = (bits >> 9) | 0x3F800000
    floats = _bits_to_f32(fbits) - 1.0
    # XLA fuses the scale-and-shift into one fused multiply-add
    return torch.maximum(lo, fma(floats, hi - lo, lo))


def randint(
    key: torch.Tensor, shape: Sequence[int], minval: int, maxval: int
) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` as int32.

    Two 32-bit draws from ``split(key)`` combined modulo the span, the
    ``_randint`` recipe for in-range int32 bounds.
    """
    lo, hi = int(minval), int(maxval)
    if not (-(2 ** 31) <= lo < 2 ** 31 and -(2 ** 31) <= hi < 2 ** 31):
        raise ValueError("randint bounds must lie in the int32 range")
    k = split(key, 2)
    higher = random_bits(k[0], shape)
    lower = random_bits(k[1], shape)
    span = (hi - lo) & _M32 if hi > lo else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span  # uint32 product wraps, as in JAX
    off = ((higher % span) * mult + (lower % span)) & _M32
    off = off % span
    return (off + lo).to(torch.int32)
