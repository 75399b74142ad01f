"""The broker's local-pool scan: CUDA on the card, a Python loop on the CPU.

:func:`local_pool_scan` debits LOCAL_FIRST's MIPS pool over one tick's
window in arrival order (the ``jax.lax.scan`` bodies of the JAX engine's
broker phase, ``fognetsimpp_tpu/core/engine.py:1689-1692`` for v1 and
``:1723-1735`` for v2).  The rows come sorted by (arrival time, slot).
Row k is taken when it is valid and its MIPS lies strictly below the pool
(``BrokerBaseApp.cc:171``, ``BrokerBaseApp2.cc:181``), and a take debits
the pool.  Under v2 the broker's one RELEASERESOURCE self-message, armed
at ``fire_t0`` when that is finite, pops before the first valid row at
or after its time, so the pool gains ``refund0`` first, and every take
cancels it.  No TPU kernel stands behind it: a chain of dependent float32
adds and subtracts has no elementwise or reduction form, and a loop of
tensor ops over the rows would be thousands of launches a tick.

On a CUDA tensor the wrapper launches ``csrc/pool_scan.cu`` on the
current stream (built on first use by :mod:`.cuda_build`): one warp a
world, which steps only the rows that can change the pool (a warp ballot
finds them) with single-rounded adds.  It never waits for the card and
raises if the launch fails; on a CPU tensor it runs
:func:`local_pool_scan_plain`.  Each call on the card adds one to
:data:`LAUNCHES`.  The wrapper is a ``torch.library`` custom operator
whose batching rule scans a replica batch (``vmap``) in one launch, one
warp a replica.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import plain_host
from . import cuda_build

#: Kernel launches since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"local_pool_scan": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _f32(x: float) -> float:
    """A double rounded to float32 (kept as a Python float)."""
    return float(np.float32(x))


def local_pool_scan_plain(
    mips: torch.Tensor, valid: torch.Tensor, t: torch.Tensor,
    pool0: torch.Tensor, fire_t0: torch.Tensor, refund0: torch.Tensor, v2: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scan as a loop over the rows of each of the R worlds (inputs
    ``(R, K)`` and ``(R,)``).  Every value is a float32 held in a Python
    float: a float32 sum or difference taken in double precision and
    rounded once is the float32 operation's result, and comparisons of
    such values are exact."""
    R, K = mips.shape
    m_all, v_all = mips.tolist(), valid.tolist()
    t_all = t.tolist() if v2 else None
    p0, f0, r0 = pool0.tolist(), fire_t0.tolist(), refund0.tolist()
    take = [[False] * K for _ in range(R)]
    pools, fireds = [], []
    for r in range(R):
        pool, fired = p0[r], False
        armed = v2 and bool(np.isfinite(f0[r]))
        m_r, v_r, tk_r = m_all[r], v_all[r], take[r]
        for k in range(K):
            v = v_r[k]
            if v2:
                fire_now = armed and v and t_all[r][k] >= f0[r]
                pool = _f32(pool + (r0[r] if fire_now else 0.0))
                fired = fired or fire_now
                armed = armed and not fire_now
            tk = v and m_r[k] < pool
            pool = _f32(pool - (m_r[k] if tk else 0.0))
            if v2:
                armed = armed and not tk
            tk_r[k] = tk
        pools.append(pool)
        fireds.append(fired)
    dev = mips.device
    return (
        torch.tensor(take, dtype=torch.bool, device=dev).reshape(R, K),
        torch.tensor(pools, dtype=torch.float32, device=dev),
        torch.tensor(fireds, dtype=torch.bool, device=dev),
    )


def _check(mips, valid, t, pool0, fire_t0, refund0) -> Tuple[int, int]:
    R, K = mips.shape
    for name, x, dt, shape in (
        ("mips", mips, torch.float32, (R, K)), ("valid", valid, torch.bool, (R, K)),
        ("t", t, torch.float32, (R, K)), ("pool0", pool0, torch.float32, (R,)),
        ("fire_t0", fire_t0, torch.float32, (R,)),
        ("refund0", refund0, torch.float32, (R,)),
    ):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != mips.device:
            raise ValueError("the scan's inputs must lie on one device")
    if K >= 2 ** 31 or R >= 2 ** 31:
        raise ValueError(f"window ({K}) or worlds ({R}) out of range")
    return R, K


def _scan_impl(mips, valid, t, pool0, fire_t0, refund0, v2, one):
    """The scan of R worlds (inputs ``(R, K)`` and ``(R,)``); ``one``
    gives the outputs one world's shapes (R = 1)."""
    cuda_build.tap("local_pool_scan", mips, valid, t, pool0, fire_t0, refund0, v2)
    if not mips.is_cuda:
        out = local_pool_scan_plain(mips, valid, t, pool0, fire_t0, refund0, v2)
        return tuple(x[0].clone() for x in out) if one else out
    R, K = _check(mips, valid, t, pool0, fire_t0, refund0)
    dev = mips.device
    lead = () if one else (R,)
    take = torch.empty(lead + (K,), dtype=torch.bool, device=dev)
    pool = torch.empty(lead, dtype=torch.float32, device=dev)
    fired = torch.empty(lead, dtype=torch.bool, device=dev)
    fn = cuda_build.function(
        "fns_local_pool_scan",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4,
    )
    err = fn(
        mips.data_ptr(), valid.data_ptr(), t.data_ptr(), pool0.data_ptr(),
        fire_t0.data_ptr(), refund0.data_ptr(), K, R, int(bool(v2)),
        take.data_ptr(), pool.data_ptr(), fired.data_ptr(),
        cuda_build.stream_of(dev),
    )
    cuda_build.raise_on(err, "local_pool_scan")
    cuda_build.count_launch(LAUNCHES, "local_pool_scan")
    return take, pool, fired


def _scan_one(mips, valid, t, pool0, fire_t0, refund0, v2):
    return _scan_impl(
        mips[None], valid[None], t[None], pool0.reshape(1), fire_t0.reshape(1),
        refund0.reshape(1), v2, True,
    )


@torch.library.custom_op("fns::local_pool_scan", mutates_args=())
def _scan_op(
    mips: torch.Tensor, valid: torch.Tensor, t: torch.Tensor,
    pool0: torch.Tensor, fire_t0: torch.Tensor, refund0: torch.Tensor, v2: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _scan_one(mips, valid, t, pool0, fire_t0, refund0, v2)


@torch.library.custom_op("fns::local_pool_scan_rows", mutates_args=())
def _scan_rows_op(
    mips: torch.Tensor, valid: torch.Tensor, t: torch.Tensor,
    pool0: torch.Tensor, fire_t0: torch.Tensor, refund0: torch.Tensor, v2: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _scan_impl(mips, valid, t, pool0, fire_t0, refund0, v2, False)


def local_pool_scan(
    mips: torch.Tensor, valid: torch.Tensor, t: torch.Tensor,
    pool0: torch.Tensor, fire_t0: torch.Tensor, refund0: torch.Tensor, v2: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(take (K,) bool, pool () f32, fired () bool)`` for one world's
    window sorted by (time, slot): ``mips`` (K,) float32, ``valid`` (K,)
    bool, ``t`` (K,) float32 (read under ``v2`` only), the starting pool
    and, under ``v2``, the timer's fire time and its refund (0-d float32).
    ``fired``: the timer popped inside the window (always False for v1).
    Under ``vmap`` the R replicas' windows are scanned in one launch."""
    if plain_host(mips, valid, t, pool0, fire_t0, refund0):
        return _scan_one(mips, valid, t, pool0, fire_t0, refund0, bool(v2))
    return _scan_op(mips, valid, t, pool0, fire_t0, refund0, bool(v2))


def local_pool_scan_rows(
    mips: torch.Tensor, valid: torch.Tensor, t: torch.Tensor,
    pool0: torch.Tensor, fire_t0: torch.Tensor, refund0: torch.Tensor, v2: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`local_pool_scan` of R worlds laid out as rows (inputs ``(R,
    K)`` and ``(R,)``, outputs likewise) in one launch: what the batching
    rule calls, and the layout :data:`cuda_build.TAPS` sees."""
    if plain_host(mips, valid, t, pool0, fire_t0, refund0):
        return _scan_impl(mips, valid, t, pool0, fire_t0, refund0, bool(v2), False)
    return _scan_rows_op(mips, valid, t, pool0, fire_t0, refund0, bool(v2))


@_scan_op.register_vmap
def _scan_vmap(info, in_dims, mips, valid, t, pool0, fire_t0, refund0, v2):
    R = info.batch_size
    rows = [cuda_build.batch_first(x, d, R) for x, d in zip(
        (mips, valid, t, pool0, fire_t0, refund0), in_dims[:6])]
    return _scan_rows_op(*rows, v2), (0, 0, 0)
