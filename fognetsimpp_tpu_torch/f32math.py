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

import torch


def const(x: float, device) -> torch.Tensor:
    """A Python float rounded to a 0-d float32 tensor, as JAX rounds a
    weakly typed constant before it meets a float32 array."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``round_f32(a * b + c)`` with a single rounding, for float32 inputs.

    The float32 product is exact in float64.  The float64 sum is then
    taken in round-to-odd (TwoSum gives the error of the nearest sum; an
    inexact sum with an even last bit moves one float64 ulp toward the
    error), and round-to-odd in 53 bits followed by round-to-nearest in
    24 bits is the correctly rounded result, since 53 >= 2 * 24 + 2.
    """
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.full_like(s, float("inf"))
    toward = torch.where(err > 0, inf, -inf)
    nudge = torch.isfinite(s) & (err != 0) & even
    return torch.where(nudge, torch.nextafter(s, toward), s).float()


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


def _reduce_large(xi: torch.Tensor):
    """``reduce_large`` for |x| >= 120: (x mod pi/2 in [-pi/4, pi/4],
    quadrant), from the float's bits ``xi`` (uint32 in int64) and 4/pi in
    fixed point, in int64 ops that never overflow."""
    tab = torch.tensor(_INV_PIO4, dtype=torch.int64, device=xi.device)
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
    xi = y.view(torch.int32).long() & _M32
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
    sign = torch.tensor(_SIGN, dtype=torch.float64, device=y.device)[q]
    cos_tab = torch.where((q & 2) != 0, -1.0, 1.0).double()
    odd = ((n ^ 1) if cos else n) & 1 != 0
    out = _poly(r * sign, r * r, cos_tab, odd)
    # |y| < pi/4 (by the top bits): no reduction, quadrant 0
    small = _poly(x, x * x, torch.ones_like(x), torch.full_like(odd, cos))
    out = torch.where(top < _TOP_PIO4, small, out).float()
    tiny = torch.ones_like(y) if cos else y
    out = torch.where(top < _TOP_TINY, tiny, out)
    return torch.where(top >= _TOP_INF, torch.full_like(y, float("nan")), out)


def sinf(y: torch.Tensor) -> torch.Tensor:
    """float32 ``sin`` with glibc's bits (XLA's on the CPU), any device."""
    return _sincosf(y, cos=False)


def cosf(y: torch.Tensor) -> torch.Tensor:
    """float32 ``cos`` with glibc's bits (XLA's on the CPU), any device."""
    return _sincosf(y, cos=True)
