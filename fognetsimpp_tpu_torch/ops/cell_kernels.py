"""The ordered per-cell float32 sum: CUDA on the card, plain torch on the CPU.

:func:`cell_sum_ordered` sums ``vals`` into ``n_cells`` cells by
``cell``, each cell's entries added one by one in index order from +0.0,
and drops entries whose cell lies outside ``[0, n_cells)``.  On cells
``>= 0`` these are the bits of XLA's float32 scatter-add on the CPU
(``jnp.zeros(A + 1).at[cell].add(v, mode="drop")[:A]``), which the
wireless tick uses to sum each 802.11 cell's offered load
(:func:`..net.topology.associate`).  No TPU kernel stands behind it; an
atomic scatter-add on the card adds in no fixed order, and a float32
sum's bits follow the order of its adds.

The domain is ``cell >= 0``.  XLA's ``.at[]`` wraps a negative index as
NumPy does, so in that helper cell -1 lands in the spare slot ``A`` (cut
by the slice), cells -2 to -(A + 1) are added to cells A - 1 to 0, and
cells below -(A + 1) are dropped; here every negative cell is dropped.
:func:`..net.topology.associate` passes only cells in ``[0, A]``.

On a CUDA tensor the wrapper launches ``csrc/cell_sum.cu`` on the current
stream (built on first use by :mod:`.cuda_build`), in one of two tiers
chosen from N and A (:func:`one_block_tiles`): one block a cell, one
launch, where each of the card's block slots walks at most
:data:`ONE_BLOCK_MAX_TILES` tiles of the entries (the wireless tick);
else cell segments, four launches with scratch from ``torch.empty``,
whose work follows the entries.  It never waits for the card and raises
if a launch fails; on a CPU tensor it runs :func:`cell_sum_ordered_plain`.
Each call on the card adds one to :data:`LAUNCHES`.  The wrapper is a
``torch.library`` custom operator whose batching rule sums a replica
batch (``vmap``) in one call, the replicas' cells laid end to end.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..device import plain_host
from . import cuda_build

#: Kernel launches since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"cell_sum_ordered": 0}
#: Entries a tile of the one-block kernel (``kTile`` in ``csrc/cell_sum.cu``).
ONE_BLOCK_TILE = 4096
#: The most tiles a block slot walks (:func:`one_block_tiles`) for which
#: the one-block tier is taken: the crossover with the segments tier that
#: ``tools/cell_sum_ab.py --sweep`` measured on an H100 (PERF.md).
#: One block a cell won at every shape up to 16 and lost by at most 1.10x
#: at 24; past 24 the segments tier won but for 1.17x at 32.
ONE_BLOCK_MAX_TILES = 24

_slots: Dict[int, int] = {}


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


def one_block_tiles(n: int, n_cells: int, slots: int) -> int:
    """Tiles of :data:`ONE_BLOCK_TILE` entries that a block slot of the
    card walks in the one-block tier: ``n_cells`` blocks over ``slots``
    slots, each block walking all ``n`` entries."""
    return -(-n_cells // slots) * -(-n // ONE_BLOCK_TILE)


def _one_block_slots(dev: torch.device) -> int:
    """Blocks of the one-block kernel that ``dev`` holds at once."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _slots:
        slots = cuda_build.function("fns_cell_sum_one_block_slots", [ctypes.c_int])(index)
        if slots <= 0:
            cuda_build.raise_on(-slots or 1, "cell_sum_ordered (occupancy)")
        _slots[index] = slots
    return _slots[index]


def _cell_sum_impl(cell: torch.Tensor, vals: torch.Tensor, n_cells: int) -> torch.Tensor:
    cuda_build.tap("cell_sum_ordered", cell, vals, n_cells)
    if not (cell.is_cuda or vals.is_cuda):
        return cell_sum_ordered_plain(cell, vals, n_cells)
    n_cells = int(n_cells)
    n = _check(cell, vals, n_cells)
    out = torch.empty((n_cells,), dtype=torch.float32, device=vals.device)
    if n_cells == 0:
        return out
    dev, stream = vals.device, cuda_build.stream_of(vals.device)
    args = (cell.data_ptr(), vals.data_ptr(), n, n_cells, out.data_ptr())
    if one_block_tiles(n, n_cells, _one_block_slots(dev)) <= ONE_BLOCK_MAX_TILES:
        fn = cuda_build.function(
            "fns_cell_sum_one_block",
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p],
        )
        err = fn(*args, stream)
    else:
        n_words = cuda_build.function(
            "fns_cell_sum_words", [ctypes.c_int, ctypes.c_int], ctypes.c_longlong
        )(n, n_cells)
        words = torch.empty((n_words,), dtype=torch.int32, device=dev)
        fn = cuda_build.function(
            "fns_cell_sum_segments",
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
        )
        err = fn(*args, words.data_ptr(), stream)
    cuda_build.raise_on(err, "cell_sum_ordered")
    cuda_build.count_launch(LAUNCHES, "cell_sum_ordered")
    return out


@torch.library.custom_op("fns::cell_sum_ordered", mutates_args=())
def _cell_sum_op(cell: torch.Tensor, vals: torch.Tensor, n_cells: int) -> torch.Tensor:
    return _cell_sum_impl(cell, vals, n_cells)


def cell_sum_ordered(
    cell: torch.Tensor, vals: torch.Tensor, n_cells: int
) -> torch.Tensor:
    """(n_cells,) float32: the index-order sum of ``vals`` (N,) float32
    in each cell of ``cell`` (N,) int32; cells outside ``[0, n_cells)``,
    negative ones included, dropped.  Under ``vmap`` the R replicas' entries
    are laid end to end, replica r's cell a at ``r * A + a`` and every
    dropped entry at ``R * A``, and one call sums all R * A cells."""
    if plain_host(cell, vals):
        return _cell_sum_impl(cell, vals, int(n_cells))
    return _cell_sum_op(cell, vals, int(n_cells))


@_cell_sum_op.register_vmap
def _cell_sum_vmap(info, in_dims, cell, vals, n_cells):
    R, A = info.batch_size, n_cells
    cell, vals = (
        cuda_build.batch_first(x, d, R) for x, d in zip((cell, vals), in_dims[:2])
    )
    kept = (cell >= 0) & (cell < A)
    off = torch.arange(R, dtype=torch.int32, device=cell.device)[:, None] * A
    flat = torch.where(kept, cell + off, R * A).reshape(-1)
    out = cell_sum_ordered(flat, vals.reshape(-1), R * A)
    return out.reshape(R, A), 0
