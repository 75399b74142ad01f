"""JAX's out-of-range index semantics on torch tensors.

``x.at[idx].set(v, mode="drop")`` and ``.add(..., mode="drop")`` ignore
indices outside ``[0, len)``; the engine uses one past the end as its
"write nothing" sentinel.  ``index_put_`` raises on such an index, so the
helpers below route every dropped write into one spare slot past the end
and cut it off again.  No boolean-mask indexing: nothing here waits for
the device.
"""
from __future__ import annotations

import torch


def _padded(col: torch.Tensor, idx: torch.Tensor):
    n = col.shape[0]
    pad = torch.cat([col, col.new_zeros((1,) + tuple(col.shape[1:]))])
    ok = (idx >= 0) & (idx < n)
    return pad, torch.where(ok, idx, n).long(), n


def set_drop(col: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``col.at[idx].set(vals, mode="drop")`` along axis 0 (a new tensor).

    Kept indices must be distinct, as every caller's are; the spare slot
    takes the dropped writes in any order.
    """
    pad, i, n = _padded(col, idx)
    v = torch.as_tensor(vals, dtype=col.dtype, device=col.device)
    pad = pad.index_put((i,), v.expand(i.shape + tuple(col.shape[1:])))
    return pad[:n]


def add_drop(col: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``col.at[idx].add(vals, mode="drop")`` along axis 0 (a new tensor).

    Duplicate indices accumulate; on the card the integer adds are
    atomic, so the result does not depend on their order.
    """
    pad, i, n = _padded(col, idx)
    v = torch.as_tensor(vals, dtype=col.dtype, device=col.device)
    pad = pad.index_add(0, i, v.expand(i.shape + tuple(col.shape[1:])))
    return pad[:n]
