"""The fog-arrival planner's kernels: CUDA on the card, plain torch on the CPU.

Counterparts of the two Pallas kernels in
``fognetsimpp_tpu/ops/pallas_kernels.py`` that the main path runs:

* :func:`fused_arrival_plan` — for a K-slot arrival window, each row's
  within-fog rank (masked rows to the same fog earlier in (time, index)
  order; -1 where masked out), the per-fog arrival counts and each fog's
  earliest (time, position) lex-min as ``t_min``/``first`` (an empty fog
  gives ``+inf``/``K``);
* :func:`pairwise_rank` — the rank output alone.

On a CUDA tensor each wrapper launches its kernel from
``csrc/arrival_plan.cu`` (built on first use by :mod:`.cuda_build` and
bound with ``ctypes``) and raises if the build or the launch fails: the
masked rows are bucketed by fog, each bucket sorted, and a row's rank read
off its sorted position, in at most five launches whose grids follow K
and the bucket count (no host synchronisation).  The wrapper allocates the
kernels' scratch.  On a CPU tensor it runs the plain version beside it,
which the tests hold against the Pallas kernels in interpret mode.  Each
wrapper call that launches the kernels adds one to :data:`LAUNCHES`.

Each wrapper is a ``torch.library`` custom operator with a batching rule,
so a replica batch (``vmap`` over the tick) reaches the kernels once for
all R replicas: the rule lays the R windows end to end (rows ``r * K +
k``, fog keys ``r * F + f``, masked-out rows keyed past every replica's
fogs) and calls the wrapper on them, with the fused kernel while R * F
fits it and the rank kernel plus the per-fog reductions window by
window past it.  On the CPU the same rule runs the plain versions.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..device import plain_host
from . import cuda_build

#: Kernel calls per wrapper (one a wrapper call, whatever its launches)
#: since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"fused_arrival_plan": 0, "pairwise_rank": 0}

#: Largest fog axis the fused kernel's per-block shared-memory tables hold.
FUSED_MAX_FOGS = 1024

#: Rows of the plain rank's pairwise compare taken at once.
_PLAIN_ROWS = 2048

#: Most bucket bits the kernels take (``kMaxBucketBits`` in the source).
_MAX_BUCKET_BITS = 11


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ----------------------------------------------------------------------
# plain versions (the CPU path; the card's yardstick)
# ----------------------------------------------------------------------

def pairwise_rank_plain(
    mask: torch.Tensor, fog_key: torch.Tensor, t_key: torch.Tensor
) -> torch.Tensor:
    """(K,) i32 within-fog rank, -1 where masked out: the O(K^2) pairwise
    compare and row sum of ``ops/queues.plan_arrivals``, taken
    ``_PLAIN_ROWS`` rows at a time so that a wide window fits in memory."""
    K = mask.shape[0]
    ids = torch.arange(K, dtype=torch.int32, device=mask.device)
    parts = []
    for r0 in range(0, K, _PLAIN_ROWS):
        r = slice(r0, r0 + _PLAIN_ROWS)
        same = fog_key[None, :] == fog_key[r, None]
        earlier = (t_key[None, :] < t_key[r, None]) | (
            (t_key[None, :] == t_key[r, None]) & (ids[None, :] < ids[r, None])
        )
        before = same & earlier & mask[None, :]
        parts.append(before.sum(dim=1, dtype=torch.int32))
    cnt = torch.cat(parts) if parts else ids
    return torch.where(mask, cnt, torch.full_like(cnt, -1))


def fog_reductions(
    mask: torch.Tensor, fog_key: torch.Tensor, t_key: torch.Tensor, n_fogs: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(counts, t_min, first), each (..., F): the per-fog reductions of
    :func:`fused_arrival_plan_plain` over the last axis of (..., K)
    inputs, so that a batch of windows is reduced window by window (an
    empty fog gives +inf and K; -0.0 kept as XLA's min keeps it)."""
    K = mask.shape[-1]
    dev = mask.device
    fid = torch.arange(n_fogs, dtype=torch.int32, device=dev)[:, None]
    per_fog = (fog_key[..., None, :] == fid) & mask[..., None, :]
    counts = per_fog.sum(dim=-1, dtype=torch.int32)
    lead = per_fog.shape[:-1]
    if K == 0:
        return (counts, torch.full(lead, float("inf"), device=dev),
                torch.full(lead, K, dtype=torch.int32, device=dev))
    tmat = torch.where(per_fog, t_key[..., None, :], float("inf"))
    t_min = tmat.amin(dim=-1)
    # XLA's min orders -0.0 below +0.0; amin returns either zero
    neg = (t_key == 0) & torch.signbit(t_key)
    neg_zero = (per_fog & neg[..., None, :]).any(dim=-1)
    t_min = torch.where(neg_zero & (t_min == 0), torch.full_like(t_min, -0.0), t_min)
    is_min = per_fog & (tmat == t_min[..., None])
    ids = torch.arange(K, dtype=torch.int32, device=dev)
    first = torch.where(is_min, ids, K).amin(dim=-1).to(torch.int32)
    return counts, t_min, first


def fused_arrival_plan_plain(
    mask: torch.Tensor, fog_key: torch.Tensor, t_key: torch.Tensor, n_fogs: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rank, counts, t_min, first) with the Pallas contract: an empty fog
    has ``t_min = +inf`` and ``first = K``; a fog whose earliest time is a
    zero has ``t_min = -0.0`` if one of its rows holds -0.0, bit for bit as
    the Pallas kernel's (XLA's) min gives it."""
    rank = pairwise_rank_plain(mask, fog_key, t_key)
    return (rank, *fog_reductions(mask, fog_key, t_key, n_fogs))


# ----------------------------------------------------------------------
# the CUDA binding
# ----------------------------------------------------------------------

_VP, _CI = ctypes.c_void_p, ctypes.c_int


def _bucket_bits(K: int, n_fogs: Optional[int]) -> int:
    """log2 of the kernels' bucket count B: the least power of two >= F
    for the fused kernel, so that each fog has its own bucket; for
    ``pairwise_rank``, which is not told F, >= 2K up to 2,048 (1,040 fogs at
    the wide-fog window's K = 1,024 still get a bucket each).  Fogs that
    share a bucket stay exact, on the kernels' slower (fog, key) order."""
    n = n_fogs if n_fogs is not None else 2 * K
    return min(_MAX_BUCKET_BITS, max(1, (n - 1).bit_length()))


def _scratch(K: int, b: int, n_fogs: int, dev):
    """The kernels' scratch: int32 words (bucket counts, cursors, offsets,
    run bases, a flag, a word a row, and for the fused kernel a -0.0 flag
    a fog) and int64 keys (a row each, plus a fog's lex-min key each for
    the fused kernel)."""
    words = torch.empty(
        (4 * (1 << b) + 3 + K + n_fogs,), dtype=torch.int32, device=dev
    )
    keys = torch.empty((K + n_fogs,), dtype=torch.int64, device=dev)
    return words, keys


def _check_inputs(mask, fog_key, t_key) -> int:
    K = mask.shape[0]
    for name, x, dt in (
        ("mask", mask, torch.bool),
        ("fog_key", fog_key, torch.int32),
        ("t_key", t_key, torch.float32),
    ):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if x.dim() != 1 or x.shape[0] != K:
            raise ValueError(f"{name} must have shape ({K},), got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != mask.device:
            raise ValueError("inputs must lie on one device")
    if K >= 2 ** 31 - 1:
        raise ValueError("window too large for int32 positions")
    return K


def _fused_impl(
    mask: torch.Tensor, fog_key: torch.Tensor, t_key: torch.Tensor, n_fogs: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    cuda_build.tap("fused_arrival_plan", mask, fog_key, t_key, n_fogs)
    if not mask.is_cuda:
        return fused_arrival_plan_plain(mask, fog_key, t_key, n_fogs)
    K = _check_inputs(mask, fog_key, t_key)
    F = int(n_fogs)
    if not 0 < F <= FUSED_MAX_FOGS:
        raise ValueError(
            f"fused_arrival_plan takes 1..{FUSED_MAX_FOGS} fogs, got {F}"
        )
    fn = cuda_build.function(
        "fns_fused_arrival_plan",
        [_VP, _VP, _VP, _CI, _CI, _CI, _VP, _VP, _VP, _VP, _VP, _VP, _VP],
    )
    dev = mask.device
    b = _bucket_bits(K, F)
    rank = torch.empty((K,), dtype=torch.int32, device=dev)
    counts = torch.empty((F,), dtype=torch.int32, device=dev)
    t_min = torch.empty((F,), dtype=torch.float32, device=dev)
    first = torch.empty((F,), dtype=torch.int32, device=dev)
    words, keys = _scratch(K, b, F, dev)
    err = fn(
        mask.data_ptr(), fog_key.data_ptr(), t_key.data_ptr(), K, F, b,
        rank.data_ptr(), counts.data_ptr(), t_min.data_ptr(),
        first.data_ptr(), words.data_ptr(), keys.data_ptr(),
        cuda_build.stream_of(dev),
    )
    cuda_build.raise_on(err, "fused_arrival_plan")
    cuda_build.count_launch(LAUNCHES, "fused_arrival_plan")
    return rank, counts, t_min, first


def _pairwise_impl(
    mask: torch.Tensor, fog_key: torch.Tensor, t_key: torch.Tensor
) -> torch.Tensor:
    cuda_build.tap("pairwise_rank", mask, fog_key, t_key)
    if not mask.is_cuda:
        return pairwise_rank_plain(mask, fog_key, t_key)
    K = _check_inputs(mask, fog_key, t_key)
    fn = cuda_build.function(
        "fns_pairwise_rank", [_VP, _VP, _VP, _CI, _CI, _VP, _VP, _VP, _VP]
    )
    dev = mask.device
    rank = torch.empty((K,), dtype=torch.int32, device=dev)
    if K:
        b = _bucket_bits(K, None)
        words, keys = _scratch(K, b, 0, dev)
        err = fn(
            mask.data_ptr(), fog_key.data_ptr(), t_key.data_ptr(), K, b,
            rank.data_ptr(), words.data_ptr(), keys.data_ptr(),
            cuda_build.stream_of(dev),
        )
        cuda_build.raise_on(err, "pairwise_rank")
        cuda_build.count_launch(LAUNCHES, "pairwise_rank")
    return rank


# The wrappers are custom operators so that a replica batch (``vmap``
# over the tick) reaches them through the batching rules below, which
# launch one kernel for all replicas on their windows laid end to end.

@torch.library.custom_op("fns::fused_arrival_plan", mutates_args=())
def _fused_op(
    mask: torch.Tensor, fog_key: torch.Tensor, t_key: torch.Tensor, n_fogs: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    return _fused_impl(mask, fog_key, t_key, n_fogs)


@torch.library.custom_op("fns::pairwise_rank", mutates_args=())
def _pairwise_op(
    mask: torch.Tensor, fog_key: torch.Tensor, t_key: torch.Tensor, n_fogs: int
) -> torch.Tensor:
    return _pairwise_impl(mask, fog_key, t_key)


def fused_arrival_plan(
    mask: torch.Tensor, fog_key: torch.Tensor, t_key: torch.Tensor, n_fogs: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rank (K,), counts (F,), t_min (F,), first (F,)) in one kernel.

    Inputs: ``mask`` (K,) bool, ``fog_key`` (K,) i32 (``n_fogs`` where
    masked out), ``t_key`` (K,) f32 (+inf where masked out).  Under
    ``vmap`` the R windows are laid end to end, R * F fogs: one call of
    the fused kernel up to :data:`FUSED_MAX_FOGS` of them, past it one
    call of the rank kernel and the per-fog reductions window by window.
    """
    if plain_host(mask, fog_key, t_key):
        return _fused_impl(mask, fog_key, t_key, int(n_fogs))
    return _fused_op(mask, fog_key, t_key, int(n_fogs))


def pairwise_rank(
    mask: torch.Tensor, fog_key: torch.Tensor, t_key: torch.Tensor,
    n_fogs: int = -1,
) -> torch.Tensor:
    """(K,) i32 within-fog arrival rank; -1 where masked out.  Under
    ``vmap`` the caller names ``n_fogs``, the bound of the masked rows'
    keys, so that the replicas' keys can be told apart end to end."""
    if plain_host(mask, fog_key, t_key):
        return _pairwise_impl(mask, fog_key, t_key)
    return _pairwise_op(mask, fog_key, t_key, int(n_fogs))


def _flat_keys(mask: torch.Tensor, fog_key: torch.Tensor, n_fogs: int) -> torch.Tensor:
    """(R * K,) fog keys of R windows end to end: replica r's fog f is
    ``r * F + f``; a masked-out row (key F, which would be replica r + 1's
    fog 0) gets ``R * F``, past every replica's fogs."""
    R = mask.shape[0]
    off = torch.arange(R, dtype=torch.int32, device=mask.device)[:, None] * n_fogs
    return torch.where(mask, fog_key + off, R * n_fogs).reshape(-1)


def _compare_ok(mask: torch.Tensor) -> bool:
    """Whether a window this wide takes the kernels: always on the card;
    on the CPU only up to the plain compare's width
    (``queues._PAIRWISE_MAX``), past which the stable-sort rank runs, as
    ``queues.plan_arrivals`` picks for one world."""
    from .queues import _PAIRWISE_MAX

    return mask.is_cuda or mask.shape[0] <= _PAIRWISE_MAX


def _flat_rank(mask, f_flat, t_flat) -> torch.Tensor:
    """The rank of the end-to-end window (:func:`_compare_ok`)."""
    from .queues import _sort_rank

    if _compare_ok(mask):
        return pairwise_rank(mask, f_flat, t_flat)
    return _sort_rank(mask, f_flat, t_flat)


@_fused_op.register_vmap
def _fused_vmap(info, in_dims, mask, fog_key, t_key, n_fogs):
    R = info.batch_size
    mask, fog_key, t_key = (
        cuda_build.batch_first(x, d, R) for x, d in zip((mask, fog_key, t_key), in_dims[:3])
    )
    K, F = mask.shape[1], n_fogs
    f_flat = _flat_keys(mask, fog_key, F)
    m_flat, t_flat = mask.reshape(-1), t_key.reshape(-1)
    if 0 < R * F <= FUSED_MAX_FOGS and _compare_ok(m_flat):
        rank, counts, t_min, first = fused_arrival_plan(m_flat, f_flat, t_flat, R * F)
        counts, t_min, first = (x.reshape(R, F) for x in (counts, t_min, first))
        off = torch.arange(R, dtype=torch.int32, device=mask.device)[:, None] * K
        # an empty fog's first is R * K end to end, K in its own window
        first = torch.where(first >= R * K, K, first - off).to(torch.int32)
    else:
        # the (F, K) membership a replica, never (R F, R K) end to end
        rank = _flat_rank(m_flat, f_flat, t_flat)
        counts, t_min, first = fog_reductions(mask, fog_key, t_key, F)
    return (rank.reshape(R, K), counts, t_min, first), (0, 0, 0, 0)


@_pairwise_op.register_vmap
def _pairwise_vmap(info, in_dims, mask, fog_key, t_key, n_fogs):
    if n_fogs < 0:
        raise ValueError("pairwise_rank under vmap needs n_fogs, the key bound")
    R = info.batch_size
    mask, fog_key, t_key = (
        cuda_build.batch_first(x, d, R) for x, d in zip((mask, fog_key, t_key), in_dims[:3])
    )
    rank = _flat_rank(mask.reshape(-1), _flat_keys(mask, fog_key, n_fogs),
                      t_key.reshape(-1))
    return rank.reshape(mask.shape), 0
