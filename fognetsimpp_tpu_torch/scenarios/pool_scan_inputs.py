"""Inputs of the local-pool scan (``ops.pool_kernels.local_pool_scan``):
the first real windows of the v1/v2 worlds, kept by a tap on the card,
and synthetic windows made from seeds that reach each branch of the
kernel.  ``chip_smoke.py``, the card tests, ``tools/pool_scan_ab.py`` and
the CPU tests share them.  A window is the wrapper's six inputs as rows,
``(mips (R, K) f32, valid (R, K) bool, t (R, K) f32, pool0 (R,),
fire_t0 (R,), refund0 (R,))``.
"""
from __future__ import annotations

import numpy as np

#: The bench world at dt 5 ms, as ``bench.py::_build_bench_world`` builds
#: it on an accelerator: 10,000 users x 32 fogs, K = 4,096, 20 ticks.
BENCH5 = dict(
    n_users=10_000, n_fogs=32, fog_mips=[1000.0, 2000.0, 3000.0, 4000.0],
    send_interval=0.0025, horizon=0.1, dt=5e-3, max_sends_per_user=44,
    max_sends_per_tick=2, queue_capacity=128, start_time_max=0.025,
    derive_acks=True, arrival_window=4096,
)
#: The bench world's v1 and v2 variants (``chip_smoke.py``'s v1_bench and
#: v2_bench): POOL fogs, LOCAL_FIRST on a 50,000-MIPS broker pool,
#: periodic adverts; v2 with the hybrid broker's shared release timer.
V1V2 = {
    "v1_bench": dict(app_gen=1, fog_model=1, policy=5, broker_mips=50_000.0,
                     adv_periodic=True, adv_on_completion=False, derive_acks=False),
    "v2_bench": dict(app_gen=2, fog_model=1, policy=5, broker_mips=50_000.0,
                     v2_local_broker=True, adv_periodic=True,
                     adv_on_completion=False, derive_acks=False),
}
#: The synthetic kinds of :func:`rows`.
KINDS = ("uniform", "dense", "timer_fire", "neg_zero_pool", "ties",
         "fire_first_row", "take_before_fire", "all_invalid", "nan_mips",
         "unsorted_fire")


def first_window(run_world, dev):
    """The first scan call of ``run_world()`` whose window holds a valid
    row, as the kernel sees it (rows on ``dev``): a tap keeps every call."""
    from ..ops import cuda_build

    kept = []

    def tap(name, *args):
        if name == "local_pool_scan" and not kept and bool(args[1].any()):
            kept.append([a.clone() for a in args[:6]])

    cuda_build.TAPS.append(tap)
    try:
        run_world()
    finally:
        cuda_build.TAPS.remove(tap)
    if not kept:
        raise RuntimeError("no scan call held a valid row")
    return [a.to(dev) for a in kept[0]]


def bench_window(name, dev):
    """The first real window of the bench world's ``name`` variant
    (``v1_bench`` or ``v2_bench``) run on ``dev``."""
    from ..core import engine
    from . import smoke

    def go():
        spec, st, net, b = smoke.build(device=dev, **dict(BENCH5, **V1V2[name]))
        engine.run(spec, st, net, b)

    return first_window(go, dev)


def rows(kind, R, K, seed):
    """R sorted windows of K rows, numpy: MIPS on a coarse grid, 80 % of
    the rows valid, times on a 1 ms grid (ties), pools 5,000 x (r + 1) / R,
    the timer at 4 ms (off in every third world), a refund of 333.
    ``kind`` changes one thing: ``dense`` (a pool of 1e9: every valid row
    is taken), ``timer_fire`` (a pool below every MIPS until the timer
    fires at the middle row's time with a refund of 5,000),
    ``neg_zero_pool`` (-0.0), ``ties`` (the pool equals the first valid
    row's MIPS), ``fire_first_row`` (the timer due at the first row),
    ``take_before_fire`` (due at the last row: the first take disarms
    it), ``all_invalid``, ``nan_mips`` (every seventh MIPS NaN),
    ``unsorted_fire`` (times in falling order, a pool below every MIPS,
    the timer due at the first row with a refund of 1e6: the fire makes
    rows after it candidates that the timer did not)."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    rng = np.random.default_rng(seed)
    mips = rng.choice(np.float32([100, 250, 400, 733]), (R, K)).astype(np.float32)
    valid = rng.random((R, K)) < 0.8
    t = np.sort(np.round(rng.random((R, K)) * 0.01, 3), axis=1).astype(np.float32)
    pool0 = (5000.0 * (1 + np.arange(R)) / R).astype(np.float32)
    fire_t0 = np.full((R,), 0.004, np.float32)
    fire_t0[::3] = np.inf
    refund0 = np.full((R,), 333.0, np.float32)
    if kind == "dense":
        pool0[:] = 1e9
    elif kind == "timer_fire":
        pool0[:] = 50.0
        fire_t0 = t[:, K // 2].copy()
        refund0[:] = 5000.0
    elif kind == "neg_zero_pool":
        pool0[:] = -0.0
    elif kind == "ties":
        first = np.argmax(valid, axis=1)
        pool0 = np.where(valid.any(axis=1), mips[np.arange(R), first], pool0)
    elif kind == "fire_first_row":
        fire_t0 = t[:, 0].copy()
    elif kind == "take_before_fire":
        fire_t0 = t[:, -1].copy()
    elif kind == "all_invalid":
        valid[:] = False
    elif kind == "nan_mips":
        mips[:, ::7] = np.nan
    elif kind == "unsorted_fire":
        t = t[:, ::-1].copy()
        pool0[:] = 50.0
        fire_t0 = t[:, min(64, K - 1)].copy()
        refund0[:] = 1e6
    return mips, valid, t, pool0.astype(np.float32), fire_t0, refund0


def replicas(window, R):
    """``R`` replicas of a one-world window (torch rows), their pools
    spread as pool0 x (r + 1) / R: the batching rule's layout."""
    import torch

    mips, valid, t, pool0, fire_t0, refund0 = window
    scale = torch.arange(1, R + 1, device=mips.device, dtype=torch.float32)
    return [x.expand(R, *x.shape[1:]).contiguous() for x in (mips, valid, t)] + [
        pool0 * scale / R, fire_t0.expand(R).contiguous(),
        refund0.expand(R).contiguous()]
