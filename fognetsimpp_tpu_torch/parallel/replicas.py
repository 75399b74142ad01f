"""Monte-Carlo replica fan-out on one card (``fognetsimpp_tpu/parallel/replicas.py``).

A replica is one more leading axis on the world tree: R worlds that share
one spec, ``NetParams`` and ``MobilityBounds`` advance together, one
``vmap`` of the tick at a time (:func:`~..core.engine.run_batched`).
Replicas differ in PRNG key, hence in task sizes and, with a start-time
window, in app start times; a sweep (:mod:`.sweep`) also gives each its
own publish interval, policy id or exploration rate.

Chaos worlds (their per-replica fault schedules) are ``ROADMAP.md`` §1
item 12 and per-replica promoted knobs (``dyn_rows``) item 11: both
raise.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..core.engine import run_batched
from ..envelope import check_replicas
from ..net.mobility import MobilityBounds
from ..net.topology import NetParams
from ..random import PRNGKey, fold_in, split, uniform
from ..spec import WorldSpec
from ..state import WorldState, tree_map


@contextlib.contextmanager
def strict_vmap():
    """Within the block an operation that has no batching rule raises
    instead of running once a replica in a hidden Python loop (functorch's
    fallback), which would launch R kernels where one was meant."""
    set_fallback = torch._C._functorch._set_vmap_fallback_enabled
    was = torch._C._functorch._is_vmap_fallback_enabled()
    set_fallback(False)
    try:
        yield
    finally:
        set_fallback(was)


def broadcast_state(state: WorldState, n: int) -> WorldState:
    """``n`` identical rows of ``state``: every leaf gains a leading axis."""
    return tree_map(lambda x: x.expand((n,) + tuple(x.shape)).clone(), state)


def replicate_state(
    spec: WorldSpec,
    state: WorldState,
    n_replicas: int,
    seed: int = 0,
    resample_starts: bool = True,
) -> WorldState:
    """Broadcast one world to ``n_replicas`` with per-replica PRNG keys
    (``split(PRNGKey(seed), R)``).

    When ``resample_starts`` and the spec declares a start-time window,
    replica r redraws its user app start times from ``fold_in(key_r, 1)``,
    and without the connect handshake its first publish with them.
    """
    check_replicas(spec)
    R = int(n_replicas)
    keys = split(PRNGKey(seed, state.t.device), R)
    batch = broadcast_state(state, R).replace(key=keys)
    if resample_starts and spec.start_time_max > spec.start_time_min:
        starts = torch.func.vmap(
            lambda k: uniform(
                fold_in(k, 1), (spec.n_users,),
                spec.start_time_min, spec.start_time_max,
            )
        )(keys)
        users = batch.users.replace(start_t=starts)
        if not spec.connect_gating:
            # without the connect handshake the first publish fires at the
            # app start time directly
            users = users.replace(next_send=starts.clone())
        batch = batch.replace(users=users)
    return batch


def run_replicated(
    spec: WorldSpec,
    batch: WorldState,
    net: NetParams,
    bounds: Optional[MobilityBounds] = None,
    n_ticks: Optional[int] = None,
    dyn_rows=None,
) -> WorldState:
    """Advance every replica over the horizon (or ``n_ticks``); returns
    the batched final state.  ``net`` and ``bounds`` are shared."""
    check_replicas(spec, dyn_rows=dyn_rows)
    return run_batched(spec, batch, net, bounds, n_ticks=n_ticks)[0]


def replica_counters(final_batch: WorldState) -> Dict[str, np.ndarray]:
    """Per-replica metric counters as host numpy arrays, keyed by name
    (every ``Metrics`` field)."""
    m = final_batch.metrics
    return {
        f.name: getattr(m, f.name).cpu().numpy()
        for f in dataclasses.fields(m)
    }
