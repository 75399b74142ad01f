"""Inputs of the ordered per-cell sum (``ops.cell_kernels.cell_sum_ordered``)
at the wireless world's shapes, numpy ``(cell, vals, n_cells)``, made
from seeds: the world of ``chip_smoke.py``'s wireless phase, its tick-0
input, config 4's replicas flattened, cells past the warp tier, and the
sweep of N and A that sets the tier crossover.  ``chip_smoke.py``, the
card tests and ``tools/cell_sum_ab.py`` share them.
"""
from __future__ import annotations

import numpy as np

#: ``benchmarks.py::config4`` at one replica, the world of
#: ``chip_smoke.py``'s wireless phase: 10,000 mobile users, 64 APs with
#: the Bianchi MAC keyed by offered load (ENERGY_AWARE is added by
#: :func:`wireless_kw`).
WIRELESS = dict(
    numb_users=10_000, horizon=0.5, dt=5e-3, send_interval=0.05,
    queue_capacity=64, extra_aps=59, mac_model="bianchi",
)
#: ``benchmarks.py``'s ``CONFIG4_R``: config 4's replicas.
REPLICAS = 128


def wireless_kw() -> dict:
    """The wireless world's builder arguments, with the spec's own
    arrival window."""
    from ..spec import Policy
    from . import wireless

    kw = dict(WIRELESS, policy=int(Policy.ENERGY_AWARE))
    kw["arrival_window"] = wireless.wireless5(device="cpu", **kw)[0].auto_arrival_window
    return kw


def tick0_input(dev):
    """``(cell, vals, A)``, numpy: the per-cell sum's input at the wireless
    world's tick 0 on ``dev``."""
    from ..core import engine
    from ..ops import cell_kernels as ck
    from . import wireless

    spec, st, net, b = wireless.wireless5(device=dev, **wireless_kw())
    kept, real = [], ck.cell_sum_ordered

    def keep(*args):
        kept.append(args)
        return real(*args)

    ck.cell_sum_ordered = keep
    try:
        engine.make_step(spec)(st, net, b)
    finally:
        ck.cell_sum_ordered = real
    cell, vals, A = kept[0]
    return cell.cpu().numpy(), vals.cpu().numpy(), int(A)


def replicas(cell0, vals0, A, R):
    """Config 4's ``R`` replicas flattened, as the replica axis would hand
    them to the sum: replica r takes the (cell, rate) pairs in an order
    drawn from ``np.random.default_rng(r)``, its kept cells offset by
    r * A; dropped entries get cell R * A."""
    cells, vs = [], []
    for r in range(R):
        perm = np.random.default_rng(r).permutation(cell0.shape[0])
        c = cell0[perm]
        kept = (c >= 0) & (c < A)
        cells.append(np.where(kept, c + r * A, R * A).astype(np.int32))
        vs.append(vals0[perm])
    return np.concatenate(cells), np.concatenate(vs), R * A


def large_cells(seed=11):
    """Cells past a warp's sort (1,024 entries) and past one sorted run
    (4,096): 1,500, 4,096, 4,097 and 9,000 entries at random places among
    40,000, whose other entries fall in 60 small cells or are dropped."""
    n, A = 40_000, 64
    rng = np.random.default_rng(seed)
    cell = rng.integers(4, A + 2, n)
    pos = rng.permutation(n)
    at = 0
    for c, size in enumerate((1500, 4096, 4097, 9000)):
        cell[pos[at:at + size]] = c
        at += size
    vals = (rng.random(n) * 40 + 0.3).astype(np.float32)
    return cell.astype(np.int32), vals, A


def kernel_cases(cell0, vals0, A0):
    """``chip_smoke.py``'s kernel-phase cases of the per-cell sum,
    ``(name, cell, vals, A)``: tick 0's input, every entry in one cell,
    cells outside ``[0, A)``, rates whose sum depends on the order, the
    128 replicas, and cells past the warp tier."""
    rng = np.random.default_rng(7)
    N0 = cell0.shape[0]
    rates = np.array([1 / 1.5, 1 / 0.05, 0.1, 1 / 3, 1 / 7], np.float32)
    return [
        ("wireless tick 0", cell0, vals0, A0),
        ("one cell", np.full(N0, A0 // 2, np.int32), rng.choice(rates, N0), A0),
        ("dropped", rng.integers(-2, A0 + 3, N0).astype(np.int32),
         rng.choice(rates, N0), A0),
        ("inexact rates", rng.integers(0, A0, N0).astype(np.int32),
         (rng.random(N0) * 40 + 0.3).astype(np.float32), A0),
        ("128 replicas", *replicas(cell0, vals0, A0, REPLICAS)),
        ("large cells", *large_cells()),
    ]


def sweep_cases():
    """Shapes around the crossover of the one-block and segments tiers,
    ``(name, cell, vals, A)``, with cells drawn uniformly (the drop cell
    among them) unless named: 64 cells (the wireless world's) at 1-48
    tiles of 4,096 entries, and with every entry in one cell; 8,192
    entries over 132-1,024 cells, across the card's block slots; and
    16-63 waves of blocks over the slots at 1-6 tiles, where the cells
    are small."""
    rng = np.random.default_rng(13)
    out = []

    def uniform(n, A):
        cell = rng.integers(0, A + 1, n).astype(np.int32)
        return cell, (rng.random(n) * 40 + 0.3).astype(np.float32), A

    for n in (4096, 8192, 12288, 16384, 20480, 24576, 32768, 40960, 49152, 65536,
              98304, 131072, 196608):
        out.append((f"N={n} A=64 uniform", *uniform(n, 64)))
    for n in (4096, 16384, 40960):
        vals = (rng.random(n) * 40 + 0.3).astype(np.float32)
        out.append((f"N={n} A=64 one cell", np.full(n, 5, np.int32), vals, 64))
    for n, A in ((8192, 132), (8192, 133), (8192, 264), (8192, 265), (8192, 528),
                 (8192, 1024), (12288, 1024), (16384, 1024), (24576, 1024),
                 (4096, 2048), (8192, 2048), (12288, 2048), (49152, 264),
                 (65536, 264), (98304, 264), (4096, 8192)):
        out.append((f"N={n} A={A} uniform", *uniform(n, A)))
    return out
