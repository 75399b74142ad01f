"""The ordered per-cell float32 sum: CUDA on the card, plain torch on the CPU.

:func:`cell_sum_ordered` sums ``vals`` into ``n_cells`` cells by
``cell``, each cell's entries added one by one in index order from 0.0,
and drops entries whose cell lies outside ``[0, n_cells)``: the bits of
XLA's float32 scatter-add on the CPU (``jnp.zeros(A + 1).at[cell].add(v,
mode="drop")[:A]``), which the wireless tick uses to sum each 802.11
cell's offered load (:func:`..net.topology.associate`).  No TPU kernel
stands behind it; an atomic scatter-add on the card adds in no fixed
order, and a float32 sum's bits follow the order of its adds.

On a CUDA tensor the wrapper launches ``csrc/cell_sum.cu`` once on the
current stream (built on first use by :mod:`.cuda_build`), never waits
for the card, and raises if the launch fails; on a CPU tensor it runs
:func:`cell_sum_ordered_plain`.  Each launch adds one to
:data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import cuda_build

#: Kernel launches since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"cell_sum_ordered": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def cell_sum_ordered_plain(
    cell: torch.Tensor, vals: torch.Tensor, n_cells: int
) -> torch.Tensor:
    """The sum in rounds: round r adds each cell's r-th entry (in index
    order, from a stable sort by cell) to its running float32 sum."""
    n = cell.shape[0]
    dev = vals.device
    out = torch.zeros((n_cells,), dtype=torch.float32, device=dev)
    if n == 0 or n_cells == 0:
        return out
    kept = (cell >= 0) & (cell < n_cells)
    key = torch.where(kept, cell, n_cells).long()
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=n_cells + 1)[:n_cells]
    start = torch.cumsum(counts, 0) - counts
    v = vals[order]
    for r in range(int(counts.max())):
        take = r < counts
        out = torch.where(take, out + v[torch.clamp(start + r, max=n - 1)], out)
    return out


def _check(cell: torch.Tensor, vals: torch.Tensor, n_cells: int) -> int:
    n = cell.shape[0]
    for name, x, dt in (("cell", cell, torch.int32), ("vals", vals, torch.float32)):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if x.dim() != 1 or x.shape[0] != n:
            raise ValueError(f"{name} must have shape ({n},), got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if vals.device != cell.device:
        raise ValueError("cell and vals must lie on one device")
    if not 0 <= n_cells < 2 ** 31 or n >= 2 ** 31 - 4096:
        raise ValueError(f"n_cells ({n_cells}) or entries ({n}) out of range")
    return n


def cell_sum_ordered(
    cell: torch.Tensor, vals: torch.Tensor, n_cells: int
) -> torch.Tensor:
    """(n_cells,) float32: the index-order sum of ``vals`` (N,) float32
    in each cell of ``cell`` (N,) int32; out-of-range cells dropped."""
    if not (cell.is_cuda or vals.is_cuda):
        return cell_sum_ordered_plain(cell, vals, n_cells)
    n_cells = int(n_cells)
    n = _check(cell, vals, n_cells)
    out = torch.empty((n_cells,), dtype=torch.float32, device=vals.device)
    if n_cells == 0:
        return out
    fn = cuda_build.function(
        "fns_cell_sum_ordered",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p],
    )
    err = fn(
        cell.data_ptr(), vals.data_ptr(), n, n_cells, out.data_ptr(),
        cuda_build.stream_of(vals.device),
    )
    cuda_build.raise_on(err, "cell_sum_ordered")
    cuda_build.count_launch(LAUNCHES, "cell_sum_ordered")
    return out
