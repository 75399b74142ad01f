"""JAX's out-of-range index semantics on torch tensors.

``x.at[idx].set(v, mode="drop")`` and ``.add(..., mode="drop")`` ignore
indices outside ``[0, len)``; the engine uses one past the end as its
"write nothing" sentinel.  ``index_put_`` raises on such an index, so the
helpers below route every dropped write into one spare slot past the end
and cut it off again.  No boolean-mask indexing: nothing here waits for
the device.  Plain CPU tensors take the same writes in numpy
(:func:`_host_drop`), whose small-array operations cost a fraction of
torch's dispatch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import plain_host


def _host_drop(col: torch.Tensor, idx: torch.Tensor, vals, add: bool) -> torch.Tensor:
    """:func:`set_drop` / :func:`add_drop` of plain CPU tensors in numpy:
    the kept rows written (or added, one by one in index order, as
    ``index_add`` adds on the CPU) into a copy."""
    out = col.numpy().copy()
    i = idx.numpy()
    ok = (i >= 0) & (i < out.shape[0])
    v = np.asarray(vals.numpy() if isinstance(vals, torch.Tensor) else vals)
    v = v.astype(out.dtype, copy=False)
    if v.ndim:
        full = i.shape + out.shape[1:]
        v = (v if v.shape == full else np.broadcast_to(v, full))[ok]
    if add:
        np.add.at(out, i[ok], v)
    else:
        out[i[ok]] = v
    return torch.from_numpy(out)


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
    if plain_host(col, idx) and not (isinstance(vals, torch.Tensor) and not plain_host(vals)):
        return _host_drop(col, idx, vals, add=False)
    pad, i, n = _padded(col, idx)
    v = torch.as_tensor(vals, dtype=col.dtype, device=col.device)
    pad = pad.index_put((i,), v.expand(i.shape + tuple(col.shape[1:])))
    return pad[:n]


def add_drop(col: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``col.at[idx].add(vals, mode="drop")`` along axis 0 (a new tensor).

    Duplicate indices accumulate; on the card the integer adds are
    atomic, so the result does not depend on their order.
    """
    if plain_host(col, idx) and not (isinstance(vals, torch.Tensor) and not plain_host(vals)):
        return _host_drop(col, idx, vals, add=True)
    pad, i, n = _padded(col, idx)
    v = torch.as_tensor(vals, dtype=col.dtype, device=col.device)
    pad = pad.index_add(0, i, v.expand(i.shape + tuple(col.shape[1:])))
    return pad[:n]
