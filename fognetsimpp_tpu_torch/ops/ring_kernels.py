"""The task-sharded tick's arrival exchange: CUDA on the card, plain torch
on the CPU.

Counterpart of ``ring_all_gather_pallas`` in
``fognetsimpp_tpu/ops/pallas_kernels.py``, the TP no-window exchange: each
shard's packed ``(K, C)`` int32 block of arrival candidates becomes every
shard's ``(n*K, C)`` window, the blocks in global shard order.

:func:`ring_all_gather` takes the ``n`` shards' blocks at once (the shard
group calls it from one thread, :mod:`..parallel.shards`) and returns one
output per shard.  On CUDA tensors it launches ``csrc/ring_gather.cu``
once on the current stream (built on first use by :mod:`.cuda_build`) and
raises if the launch fails; on CPU tensors it runs
:func:`ring_all_gather_plain`.  Each kernel launch adds one to
:data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import torch

from . import cuda_build

#: Kernel launches since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"ring_all_gather": 0}

#: Most shards one launch takes: the kernel's parameters hold the pointers.
MAX_SHARDS = 64

_CROSS_DEVICE = (
    "not ported yet: shards on distinct cards with peer access "
    "(ROADMAP.md §1 item 21)"
)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def ring_all_gather_plain(blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per shard, the blocks concatenated in shard order."""
    return [torch.cat(list(blocks), dim=0) for _ in blocks]


def _check(blocks: Sequence[torch.Tensor]) -> None:
    if len(blocks) == 0:
        raise ValueError("ring_all_gather needs at least one block")
    b0 = blocks[0]
    for i, b in enumerate(blocks):
        if b.dtype != torch.int32:
            raise TypeError(f"block {i} must be int32, got {b.dtype}")
        if b.dim() != 2 or b.shape != b0.shape:
            raise ValueError(
                f"block {i} has shape {tuple(b.shape)}; every block must be "
                f"2-D and of block 0's shape {tuple(b0.shape)}"
            )
        if not b.is_contiguous():
            raise ValueError(f"block {i} must be contiguous")
        if b.device != b0.device:
            if b.is_cuda and b0.is_cuda:
                raise NotImplementedError(_CROSS_DEVICE)
            raise ValueError("blocks must lie on one device")


def ring_all_gather(blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``n`` blocks ``(K, C)`` int32 -> ``n`` windows ``(n*K, C)``, block
    ``s`` at rows ``s*K`` of every window."""
    _check(blocks)
    b0 = blocks[0]
    if not b0.is_cuda:
        return ring_all_gather_plain(blocks)
    n = len(blocks)
    if n > MAX_SHARDS:
        raise ValueError(f"the kernel takes at most {MAX_SHARDS} blocks, got {n}")
    K, C = b0.shape
    dev = b0.device
    outs = [torch.empty((n * K, C), dtype=torch.int32, device=dev) for _ in range(n)]
    if K * C == 0:
        return outs
    fn = cuda_build.function(
        "fns_ring_all_gather",
        [ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_longlong,
         ctypes.c_void_p],
    )
    # sources then destinations, a host array the launch passes by value
    ptrs = (ctypes.c_uint64 * (2 * n))(
        *[b.data_ptr() for b in blocks], *[o.data_ptr() for o in outs]
    )
    err = fn(ptrs, n, K * C, cuda_build.stream_of(dev))
    cuda_build.raise_on(err, "ring_all_gather")
    cuda_build.count_launch(LAUNCHES, "ring_all_gather")
    return outs
