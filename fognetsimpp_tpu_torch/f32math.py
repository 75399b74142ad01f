"""float32 arithmetic helpers that keep the port bit-exact with XLA.

XLA's CPU backend contracts ``a * b + c`` inside one fused loop into a
single fused multiply-add (one rounding).  Eager PyTorch rounds twice
(after the product and after the sum), which differs in the last bit
often enough to break bit-equality.  :func:`fma` computes the singly
rounded result on any device with float64 tensor ops only.

XLA's CPU backend computes a float32 ``sin``/``cos`` by calling the C
library's ``sinf``/``cosf``; :func:`sinf` and :func:`cosf` are glibc's
algorithm in float64 and int64 tensor ops, so they give its bits on any
device (``torch.sin`` on the CPU and CUDA's ``sinf`` are other
algorithms and differ in the last bit).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .device import plain_host


def const(x: float, device) -> torch.Tensor:
    """A Python float rounded to a 0-d float32 tensor, as JAX rounds a
    weakly typed constant before it meets a float32 array.  Made by a
    fill on the device (``torch.tensor`` would copy from the host and
    wait for the card)."""
    return torch.full((), x, dtype=torch.float32, device=device)


@torch.library.custom_op("fns::bitcast", mutates_args=())
def _bitcast_op(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.view(dtype).clone()


@_bitcast_op.register_vmap
def _bitcast_vmap(info, in_dims, x, dtype):
    return _bitcast_op(x, dtype), in_dims[0]


@_bitcast_op.register_fake
def _bitcast_fake(x, dtype):
    """The shape and dtype alone (``core/contracts.py``)."""
    return x.new_empty(x.shape, dtype=dtype)


#: Whether this PyTorch has a batching rule for a dtype view (2.13 on).
_VIEW_BATCHES = tuple(int(v) for v in torch.__version__.split(".")[:2]) >= (2, 13)


def bitcast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.view(dtype)`` for a dtype of the same width: the same bits read
    as another type.  A tensor of a replica batch (``vmap``) goes through
    a custom operator whose batching rule views the whole batch at once,
    since PyTorch releases before 2.13 have no batching rule for a dtype
    view; from 2.13 on the view's own rule does it, without the custom
    operator's dispatch (milliseconds a call on the CPU)."""
    if not _VIEW_BATCHES and torch._C._functorch.is_functorch_wrapped_tensor(x):
        return _bitcast_op(x, dtype)
    return x.view(dtype)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``round_f32(a * b + c)`` with a single rounding, for float32 inputs.

    The float32 product is exact in float64.  The float64 sum is then
    taken in round-to-odd (TwoSum gives the error of the nearest sum; an
    inexact sum with an even last bit moves one float64 ulp toward the
    error), and round-to-odd in 53 bits followed by round-to-nearest in
    24 bits is the correctly rounded result, since 53 >= 2 * 24 + 2.
    """
    if plain_host(a, b, c):
        out = _fma_host(a.numpy(), b.numpy(), c.numpy())
        if out is not None:
            return out
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    even = (bitcast(s, torch.int64) & 1) == 0
    inf = torch.full_like(s, float("inf"))
    toward = torch.where(err > 0, inf, -inf)
    nudge = torch.isfinite(s) & (err != 0) & even
    return torch.where(nudge, torch.nextafter(s, toward), s).float()


def _fma_host(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> Optional[torch.Tensor]:
    """:func:`fma`'s steps in numpy float64 for plain CPU tensors: the same
    IEEE operations, at a fraction of torch's dispatch cost.  None where a
    result is NaN, whose bits the two libraries may propagate from
    different operands: the tensor path then decides them."""
    with np.errstate(all="ignore"):
        p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
        c64 = np.asarray(c, np.float64)
        s = np.asarray(p + c64)
        bv = s - p
        err = (p - (s - bv)) + (c64 - bv)
        even = (s.view(np.int64) & 1) == 0
        nudge = np.isfinite(s) & (err != 0) & even
        out = np.asarray(
            np.where(nudge, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s),
            np.float32)
    if np.isnan(out).any():
        return None
    return torch.from_numpy(out)


# ----------------------------------------------------------------------
# sinf / cosf
# ----------------------------------------------------------------------
#
# glibc's sinf/cosf (sysdeps/ieee754/flt-32/s_sinf.c, s_cosf.c,
# sincosf.h, sincosf_data.c), contributed by Arm from its
# optimized-routines library: the float32 argument is widened to double,
# reduced to [-pi/4, pi/4] and a quadrant, and a double polynomial is
# rounded once to float32.  On x86-64 glibc runs its FMA build of the
# routines, where ``x - n * pi/2`` is one fused multiply-subtract; here
# pi/2 is split into a 46-bit head and a 7-bit tail, so ``(x - n * hi) -
# n * lo`` is exact up to its last subtraction and rounds once, as the
# fused operation does.

#: ``abstop12`` thresholds: the top 12 bits (sign cleared) of pi/4 as a
#: float32, 2^-12, 120 and infinity.
_TOP_PIO4, _TOP_TINY, _TOP_120, _TOP_INF = 0x3F4, 0x398, 0x42F, 0x7F8
#: 2/pi scaled by 2^24: the quadrant lands in bits 24..31 of the product.
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")
#: pi/2 (``0x1.921FB54442D18p0``) as a 46-bit head and its 7-bit tail.
_HPI_HI = float.fromhex("0x1.921FB54442D00p0")
_HPI_LO = float.fromhex("0x1.8p-48")
#: 2 pi * 2^-64, the scale of ``reduce_large``'s fixed-point result.
_PI63 = float.fromhex("0x1.921FB54442D18p-62")
#: Sine signs of quadrants 0..3.
_SIGN = (1.0, -1.0, -1.0, 1.0)
#: The cosine (c0..c4) and sine (s1..s3) coefficients; the second table,
#: taken when bit 1 of the quadrant is set, negates the cosine's.
_C = tuple(float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16",
))
_S = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13",
))
#: 4/pi to 192 bits, a new byte an entry (``__inv_pio4``).
_INV_PIO4 = (
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e,
    0xf9836e4e, 0x836e4e44, 0x6e4e4415, 0x4e441529,
    0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1,
    0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0,
    0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599,
    0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041,
)
_M32 = 0xFFFFFFFF


def _poly(x: torch.Tensor, x2: torch.Tensor, cos_tab: torch.Tensor, odd: torch.Tensor):
    """``sinf_poly``: the sine polynomial where ``odd`` is False, the
    cosine one (sign ``cos_tab`` = +-1) where it is True; float64."""
    x3 = x * x2
    s1 = _S[1] + x2 * _S[2]
    x7 = x3 * x2
    s = x + x3 * _S[0]
    sin_p = s + x7 * s1
    x4 = x2 * x2
    c2 = _C[3] + x2 * _C[4]
    c1 = _C[0] + x2 * _C[1]
    x6 = x4 * x2
    c = c1 + x4 * _C[2]
    cos_p = (c + x6 * c2) * cos_tab
    return torch.where(odd, cos_p, sin_p)


_TABLES: dict = {}


def kept_tensor(values: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """``values`` as a tensor on ``device``, copied there at the first call
    and kept: a copy from the host waits for the card, so later calls (the
    tick's) read the kept tensor."""
    key = (values, dtype, torch.device(device))
    t = _TABLES.get(key)
    if t is None:
        # setdefault is atomic: two threads that race here keep one copy
        t = _TABLES.setdefault(key, torch.tensor(values, dtype=dtype, device=device))
    return t


def _reduce_large(xi: torch.Tensor):
    """``reduce_large`` for |x| >= 120: (x mod pi/2 in [-pi/4, pi/4],
    quadrant), from the float's bits ``xi`` (uint32 in int64) and 4/pi in
    fixed point, in int64 ops that never overflow."""
    tab = kept_tensor(_INV_PIO4, torch.int64, xi.device)
    k = (xi >> 26) & 15
    shift = (xi >> 23) & 7
    m = ((xi & 0xFFFFFF) | 0x800000) << shift  # < 2^31
    r0 = (m * tab[k]) & _M32  # uint32 product
    r1 = m * tab[k + 4]  # < 2^63
    r2 = m * tab[k + 8]
    # res0 = (r2 >> 32 | r0 << 32) + r1 mod 2^64, as (hi, lo) words
    lo = (r2 >> 32) + (r1 & _M32)
    hi = (r0 + (r1 >> 32) + (lo >> 32)) & _M32
    lo = lo & _M32
    n = ((hi + (1 << 29)) & _M32) >> 30  # (res0 + 2^61) >> 62
    hi = (hi - (n << 30)) & _M32  # res0 -= n << 62
    hi = torch.where(hi >= 1 << 31, hi - (1 << 32), hi)  # as int64_t
    return (hi * (1 << 32) + lo).double() * _PI63, n


def _sincosf(y: torch.Tensor, cos: bool) -> torch.Tensor:
    if y.dtype != torch.float32:
        raise TypeError(f"sinf/cosf take float32, got {y.dtype}")
    if plain_host(y):
        return torch.from_numpy(_sincosf_host(y.numpy(), cos))
    xi = bitcast(y, torch.int32).long() & _M32
    top = (xi >> 20) & 0x7FF
    x = y.double()
    # |y| < 120: reduce_fast, with the single-rounded x - n * pi/2
    n_f = ((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    nd = n_f.double()
    r_f = (x - nd * _HPI_HI) - nd * _HPI_LO
    # |y| >= 120: reduce_large, its sign folded into the quadrant
    r_l, n_l = _reduce_large(xi)
    sgn_q = (n_l + (xi >> 31)) & 3
    big = top >= _TOP_120
    n = torch.where(big, n_l, n_f.long() & 3)
    q = torch.where(big, sgn_q, n)
    r = torch.where(big, r_l, r_f)
    sign = kept_tensor(_SIGN, torch.float64, y.device)[q]
    cos_tab = torch.where((q & 2) != 0, -1.0, 1.0).double()
    odd = ((n ^ 1) if cos else n) & 1 != 0
    out = _poly(r * sign, r * r, cos_tab, odd)
    # |y| < pi/4 (by the top bits): no reduction, quadrant 0
    small = _poly(x, x * x, torch.ones_like(x), torch.full_like(odd, cos))
    out = torch.where(top < _TOP_PIO4, small, out).float()
    tiny = torch.ones_like(y) if cos else y
    out = torch.where(top < _TOP_TINY, tiny, out)
    return torch.where(top >= _TOP_INF, torch.full_like(y, float("nan")), out)


def _sincosf_host(y: np.ndarray, cos: bool) -> np.ndarray:
    """:func:`_sincosf`'s steps in numpy for a plain CPU tensor's values:
    the same integer and float64 operations in the same order."""
    shape = y.shape
    y = np.atleast_1d(y)
    with np.errstate(all="ignore"):
        xi = y.view(np.int32).astype(np.int64) & _M32
        top = (xi >> 20) & 0x7FF
        x = y.astype(np.float64)
        n_f = ((x * _HPI_INV).astype(np.int32) + np.int32(0x800000)) >> 24
        nd = n_f.astype(np.float64)
        r_f = (x - nd * _HPI_HI) - nd * _HPI_LO
        # reduce_large
        tab = np.asarray(_INV_PIO4, np.int64)
        k = (xi >> 26) & 15
        m = ((xi & 0xFFFFFF) | 0x800000) << ((xi >> 23) & 7)
        r0 = (m * tab[k]) & _M32
        r1 = m * tab[k + 4]
        r2 = m * tab[k + 8]
        lo = (r2 >> 32) + (r1 & _M32)
        hi = (r0 + (r1 >> 32) + (lo >> 32)) & _M32
        lo = lo & _M32
        n_l = ((hi + (1 << 29)) & _M32) >> 30
        hi = (hi - (n_l << 30)) & _M32
        hi = np.where(hi >= 1 << 31, hi - (1 << 32), hi)
        r_l = (hi * (1 << 32) + lo).astype(np.float64) * _PI63
        big = top >= _TOP_120
        n = np.where(big, n_l, n_f.astype(np.int64) & 3)
        q = np.where(big, (n_l + (xi >> 31)) & 3, n)
        r = np.where(big, r_l, r_f)
        cos_tab = np.where((q & 2) != 0, -1.0, 1.0)
        odd = (((n ^ 1) if cos else n) & 1) != 0

        def poly(x, x2, cos_tab, odd):
            x3 = x * x2
            s1 = _S[1] + x2 * _S[2]
            x7 = x3 * x2
            sin_p = (x + x3 * _S[0]) + x7 * s1
            x4 = x2 * x2
            c2 = _C[3] + x2 * _C[4]
            c = (_C[0] + x2 * _C[1]) + x4 * _C[2]
            cos_p = (c + (x4 * x2) * c2) * cos_tab
            return np.where(odd, cos_p, sin_p)

        out = poly(r * np.asarray(_SIGN)[q], r * r, cos_tab, odd)
        small = poly(x, x * x, np.ones_like(x), np.full(odd.shape, cos))
        out = np.where(top < _TOP_PIO4, small, out).astype(np.float32)
        out = np.where(top < _TOP_TINY, np.ones_like(y) if cos else y, out)
        out = np.where(top >= _TOP_INF, np.float32(np.nan), out)
    return np.ascontiguousarray(out, np.float32).reshape(shape)


def sinf(y: torch.Tensor) -> torch.Tensor:
    """float32 ``sin`` with glibc's bits (XLA's on the CPU), any device."""
    return _sincosf(y, cos=False)


def cosf(y: torch.Tensor) -> torch.Tensor:
    """float32 ``cos`` with glibc's bits (XLA's on the CPU), any device."""
    return _sincosf(y, cos=True)


# ----------------------------------------------------------------------
# exp / log / log1p
# ----------------------------------------------------------------------
#
# XLA's CPU backend does not call the C library for a float32 ``exp`` or
# ``log``: it inlines its own vectorised Cephes-style polynomials (the
# ``exp_f32``/``log_f32`` routines its LLVM IR names), and LLVM contracts
# each multiply feeding one add into a fused multiply-add.  The functions
# below are those routines step for step, every contracted pair through
# :func:`fma`, every other step a float32 op, so they give XLA's bits on
# any device.

def _c32(h: str) -> float:
    """A float32 constant given by its float hex, as a Python float."""
    return float.fromhex(h)


#: ``exp_f32``: input clamp, log2(e), ln 2 in two parts, the Cephes
#: polynomial's coefficients p0..p4 (p5 is 0.5).
_EXP_LO, _EXP_HI = _c32("-0x1.5f3334p+6"), _c32("0x1.633334p+6")
_LOG2E = _c32("0x1.715476p+0")
_LN2_HI, _LN2_LO = _c32("0x1.63p-1"), _c32("-0x1.bd0106p-13")
_EXP_P = tuple(_c32(h) for h in (
    "0x1.a0d2cep-13", "0x1.6e879cp-10", "0x1.111210p-7", "0x1.555382p-5",
    "0x1.555554p-3",
))
#: ``log_f32``: the smallest normal, sqrt(1/2), the polynomial's
#: coefficients p0..p8 and ln 2 in two parts (q1, q2).
_TINY_NORMAL = _c32("0x1p-126")
_SQRTHF = _c32("0x1.6a09e6p-1")
_LOG_P = tuple(_c32(h) for h in (
    "0x1.204376p-4", "-0x1.d7a370p-4", "0x1.de4a34p-4", "-0x1.fcba9ep-4",
    "0x1.23d37ep-3", "-0x1.555ca0p-3", "0x1.999d58p-3", "-0x1.fffff8p-3",
    "0x1.555554p-2",
))
_LOG_Q1, _LOG_Q2 = _c32("-0x1.bd0106p-13"), _c32("0x1.63p-1")
#: ``log1p`` below |x| < sqrt(2) - 1: the numerator's and the
#: denominator's coefficients, highest power first.
_LOG1P_SMALL = _c32("0x1.a8279ap-2")
_LOG1P_NUM = tuple(_c32(h) for h in (
    "0x1.7bc096p-15", "0x1.fe818ap-2", "0x1.a509f4p+2", "0x1.de9738p+4",
    "0x1.e798ecp+5", "0x1.c8e75ap+5", "0x1.40a202p+4",
))
_LOG1P_DEN = tuple(_c32(h) for h in (
    "0x1p0", "0x1.e2035ap+3", "0x1.4c30b6p+6", "0x1.bb865ap+7",
    "0x1.351946p+8", "0x1.b0db14p+7", "0x1.e0f304p+5",
))


def _f32(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"expects float32, got {x.dtype}")


def ftz(x: torch.Tensor) -> torch.Tensor:
    """``x`` with float32 subnormals flushed to a zero of their sign.

    XLA's CPU runtime computes with the flush-to-zero and
    denormals-are-zero modes on: a subnormal result is 0 and a subnormal
    input counts as 0.  Torch keeps subnormals on the CPU and on the card,
    so a step whose result can fall below 2^-126 flushes it here.
    """
    return torch.where(torch.abs(x) < _TINY_NORMAL, x * 0.0, x)


def expf(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` with XLA's CPU bits, any device.

    ``x`` is clamped to [-87.8, 88.8]; ``m = floor(x log2(e) + 1/2)``,
    clamped to [-127, 127]; ``r = x - m ln 2`` in two fused steps; the
    degree-5 polynomial by fused steps; ``2^m`` built from the exponent
    bits, so ``m = -127`` gives 0 (XLA flushes where the exact result
    would be subnormal).
    """
    _f32(x)
    dev = x.device
    xc = torch.clamp(x, _EXP_LO, _EXP_HI)
    m = torch.floor(fma(xc, const(_LOG2E, dev), const(0.5, dev)))
    m = torch.clamp(m, -127.0, 127.0)
    r = fma(-m, const(_LN2_HI, dev), xc)
    r = fma(-m, const(_LN2_LO, dev), r)
    y = fma(r, const(_EXP_P[0], dev), const(_EXP_P[1], dev))
    for c in _EXP_P[2:] + (0.5,):
        y = fma(y, r, const(c, dev))
    y = fma(y, r * r, r) + 1.0
    bits = m.to(torch.int64) * (1 << 23) + 0x3F800000
    out = ftz(y * bitcast(bits.to(torch.int32), torch.float32))
    return torch.where(torch.isnan(x), x, out)


def _log_core(t: torch.Tensor) -> torch.Tensor:
    """``log_f32`` on positive normal float32 ``t`` (no special cases)."""
    dev = t.device
    bits = bitcast(t, torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    mant = bitcast((bits & 0x007FFFFF) | 0x3F000000, torch.float32)
    small = mant < _SQRTHF
    xr = (mant - 1.0) + torch.where(small, mant, 0.0)
    e = e - torch.where(small, 1.0, 0.0)
    x2 = xr * xr
    x3 = x2 * xr
    p = [const(c, dev) for c in _LOG_P]
    y = fma(xr, p[0], p[1])
    y1 = fma(xr, p[3], p[4])
    y = fma(y, xr, p[2])
    y1 = fma(y1, xr, p[5])
    y = fma(y, x3, y1)
    y2 = fma(xr, p[6], p[7])
    y2 = fma(y2, xr, p[8])
    y = fma(y, x3, y2)
    y = fma(y, x3, e * _LOG_Q1)
    t0 = fma(const(-0.5, dev).expand_as(x2), x2, xr) + y
    return fma(const(_LOG_Q2, dev).expand_as(e), e, t0)


def logf(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log`` with XLA's CPU bits, any device: Cephes' range
    reduction to [sqrt(1/2), sqrt(2)), its degree-8 polynomial by fused
    steps, subnormal inputs count as 0 (:func:`ftz`); ``log(0)`` is
    ``-inf``, ``log(inf)`` is ``inf``, a negative or NaN input NaN."""
    _f32(x)
    x = ftz(x)
    out = _log_core(torch.clamp_min(x, _TINY_NORMAL))
    out = torch.where(x == 0.0, float("-inf"), out)
    out = torch.where(x == float("inf"), float("inf"), out)
    return torch.where((x < 0.0) | torch.isnan(x), float("nan"), out)


def log1pf(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log1p`` with XLA's CPU bits, any device: ``log(1 + x)``
    by :func:`logf`, and below |x| < sqrt(2) - 1 Cephes' rational form
    ``x - x^2/2 + x^3 P(x)/Q(x)`` by fused steps."""
    _f32(x)
    dev = x.device
    x = ftz(x)
    large = logf(x + 1.0)

    def horner(coefs):
        acc = torch.full_like(x, coefs[0])
        for c in coefs[1:]:
            acc = fma(acc, x, const(c, dev))
        return acc

    x2 = x * x
    ratio = horner(_LOG1P_NUM) / horner(_LOG1P_DEN)
    small = x + fma(const(-0.5, dev).expand_as(x2), x2, (x * x2) * ratio)
    return torch.where(torch.abs(x) < _LOG1P_SMALL, small, large)


# ----------------------------------------------------------------------
# reductions and scans in XLA's CPU order
# ----------------------------------------------------------------------
#
# A float32 sum's bits follow the order of its adds.  XLA's CPU pipeline
# rewrites a reduction over more than 32 elements into a tree: the axis
# is zero-padded to a multiple of 32, the padding split low/high as
# ``p // 2`` / ``p - p // 2``, each window of 32 summed left to right
# from 0, and the same again on the window sums until 32 or fewer remain,
# which one loop adds left to right.  A cumulative sum over more than 16
# elements becomes blocks of 16 (the axis zero-padded at its end): an
# inclusive left-to-right scan in each block, plus the exclusive scan of
# the block totals, itself computed by the same rule.

_SUM_WINDOW = 32
_SCAN_BLOCK = 16


def _serial_sum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right sum from 0 over the last axis."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def xla_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """float32 sum of ``x`` over ``dim`` with XLA's CPU bits."""
    _f32(x)
    x = x.movedim(dim, -1)
    while x.shape[-1] > _SUM_WINDOW:
        n = x.shape[-1]
        pad = -n % _SUM_WINDOW
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = _serial_sum(x.reshape(*x.shape[:-1], -1, _SUM_WINDOW))
    return _serial_sum(x)


def _serial_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive left-to-right scan from 0 over the last axis."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    out = []
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
        out.append(acc)
    return torch.stack(out, dim=-1)


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """float32 inclusive cumulative sum of ``x`` over its last axis with
    XLA's CPU bits (``jnp.cumsum``)."""
    _f32(x)
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _serial_scan(x)
    blocks = torch.nn.functional.pad(x, (0, -n % _SCAN_BLOCK))
    blocks = blocks.reshape(*x.shape[:-1], -1, _SCAN_BLOCK)
    inner = _serial_scan(blocks)
    totals = inner[..., -1]
    # exclusive scan of the totals: 0, then their inclusive scan
    before = torch.nn.functional.pad(xla_cumsum(totals)[..., :-1], (1, 0))
    out = inner + before[..., None]
    return out.reshape(*x.shape[:-1], -1)[..., :n]
