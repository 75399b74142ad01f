"""Policy × load and exploration × load sweeps (``fognetsimpp_tpu/parallel/sweep.py``).

The load axis is always data: the per-user publish interval is a state
column (``users.send_interval``), so every load level × Monte-Carlo
replica is one more row of one replica batch.  The policy axis is either
static (one batch a policy) or ``dynamic=True`` (``Policy.DYNAMIC``: the
policy id rides in ``broker.policy_id``, a device tensor, so the whole
grid is one batch).  For a learned policy the exploration rate is data
too (``learn.explore``): :func:`sweep_explore` runs a rate × load grid
as one batch.

Grids over promoted knobs (``sweep_dyn``, ``sweep_dyn_from``) are
``ROADMAP.md`` §1 item 11, and ``mesh=`` (replicas across cards) item 27:
they raise.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..envelope import check_one_card, refuse_dyn_sweep
from ..spec import ARGMIN_FAMILY, LEARNED_POLICIES, Policy, WorldSpec
from ..state import WorldState, tree_map
from .replicas import broadcast_state, replica_counters, replicate_state, run_replicated


def _tile(batch: WorldState, n: int) -> WorldState:
    """``n`` copies of the replica block ``batch``, one after another."""
    return tree_map(lambda x: torch.cat([x] * n, dim=0), batch)


def _f32_col(values: Sequence[float], dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.float32), device=dev)


def _with_loads(batch: WorldState, loads: Sequence[float], n_rep: int) -> WorldState:
    """Each replica's publish interval: the load levels, each repeated
    ``n_rep`` times, tiled over the batch's blocks."""
    R, U = batch.users.send_interval.shape
    block = _f32_col(loads, batch.t.device).repeat_interleave(n_rep)
    si = block.repeat(R // block.shape[0])
    return batch.replace(
        users=batch.users.replace(send_interval=si[:, None].expand(R, U).clone())
    )


def _split_grid(counters: Dict[str, np.ndarray], keys, n_loads: int, n_rep: int):
    """Counters cut into one (n_loads, n_rep) grid per consecutive block."""
    nlr = n_loads * n_rep
    return {
        k: {
            name: v[i * nlr: (i + 1) * nlr].reshape(n_loads, n_rep)
            for name, v in counters.items()
        }
        for i, k in enumerate(keys)
    }


def policy_batches(
    build: Callable[..., tuple],
    policies: Sequence[int],
    load_intervals: Sequence[float],
    n_replicas_per_load: int = 1,
    seed: int = 0,
    dynamic: bool = False,
    **build_kwargs,
) -> Iterator[Tuple[List[int], WorldSpec, WorldState, object, object]]:
    """The replica batches of a policy × load grid, one at a time, as
    ``(policies, spec, batch, net, bounds)``: one a policy, or with
    ``dynamic=True`` one for the whole grid in (policy, load, rep) order.
    See :func:`sweep_policies`."""
    n_loads, n_rep = len(load_intervals), n_replicas_per_load
    nlr = n_loads * n_rep
    build_kwargs.setdefault("send_interval", min(load_intervals))
    if not dynamic:
        for pol in policies:
            spec, state, net, bounds = build(policy=int(pol), **build_kwargs)
            batch = replicate_state(spec, state, nlr, seed=seed)
            yield [int(pol)], spec, _with_loads(batch, load_intervals, n_rep), net, bounds
        return
    argmin_ids = {int(p) for p in ARGMIN_FAMILY}
    learned_ids = {int(p) for p in LEARNED_POLICIES}
    if any(int(p) not in argmin_ids | learned_ids for p in policies):
        names = ", ".join(
            f"{p.name.lower()}={int(p)}" for p in ARGMIN_FAMILY + LEARNED_POLICIES
        )
        raise ValueError(
            f"dynamic sweeps cover the traced-dispatch families ({names})"
        )
    if any(int(p) in learned_ids for p in policies):
        build_kwargs.setdefault("learn_in_dynamic", True)
    spec, state, net, bounds = build(policy=int(Policy.DYNAMIC), **build_kwargs)
    # every policy's block sees the keys and start times a static sweep
    # gives it, so dynamic equals static
    batch = _tile(replicate_state(spec, state, nlr, seed=seed), len(policies))
    pol_ids = torch.as_tensor(
        np.asarray([int(p) for p in policies], np.int32), device=state.t.device
    ).repeat_interleave(nlr)
    batch = batch.replace(broker=batch.broker.replace(policy_id=pol_ids))
    yield [int(p) for p in policies], spec, _with_loads(batch, load_intervals, n_rep), net, bounds


def sweep_policies(
    build: Callable[..., tuple],
    policies: Sequence[int],
    load_intervals: Sequence[float],
    n_replicas_per_load: int = 1,
    seed: int = 0,
    mesh=None,
    n_ticks=None,
    dynamic: bool = False,
    **build_kwargs,
) -> Dict[int, Dict[str, np.ndarray]]:
    """Run every (policy, load, replica) combination; return counter grids.

    ``build`` is a scenario builder (``scenarios.smoke.build``) taking
    ``policy=`` and returning ``(spec, state, net, bounds)``; its other
    arguments (``device=`` among them) come from ``build_kwargs``.  The
    world is built for the heaviest load (the least interval), so its
    send budget and window fit every level.  ``dynamic=True`` builds it
    with ``Policy.DYNAMIC`` and runs the whole grid as one batch, the
    policy id a replica's data (the argmin family, plus the learned ids
    with ``learn_in_dynamic``).

    Returns ``{policy: {counter: (n_loads, n_replicas) array}}``.
    """
    check_one_card(mesh)
    out: Dict[int, Dict[str, np.ndarray]] = {}
    for pols, spec, batch, net, bounds in policy_batches(
        build, policies, load_intervals, n_replicas_per_load, seed, dynamic,
        **build_kwargs,
    ):
        final = run_replicated(spec, batch, net, bounds, n_ticks=n_ticks)
        out.update(_split_grid(
            replica_counters(final), pols, len(load_intervals), n_replicas_per_load
        ))
    return out


def sweep_explore(
    build: Callable[..., tuple],
    policy: int,
    explore_rates: Sequence[float],
    load_intervals: Sequence[float],
    n_replicas_per_load: int = 1,
    seed: int = 0,
    mesh=None,
    n_ticks=None,
    **build_kwargs,
) -> Dict[float, Dict[str, np.ndarray]]:
    """Exploration-rate × load grid for ONE learned policy, one batch in
    (explore, load, rep) order, each rate's block seeing the same keys and
    start times.

    Returns ``{explore_rate: {counter: (n_loads, n_replicas) array}}``;
    each grid also carries ``lat_cnt`` and ``lat_mean_s``, the mean
    credited task latency, NaN where nothing was credited (a zero would
    read as the best latency for the emptiest cell).
    """
    if int(policy) not in {int(p) for p in LEARNED_POLICIES}:
        names = ", ".join(p.name.lower() for p in LEARNED_POLICIES)
        raise ValueError(
            f"sweep_explore sweeps the learned policies ({names}); got "
            f"policy id {int(policy)}"
        )
    check_one_card(mesh)
    n_loads, n_rep = len(load_intervals), n_replicas_per_load
    nlr = n_loads * n_rep
    build_kwargs.setdefault("send_interval", min(load_intervals))
    spec, state, net, bounds = build(policy=int(policy), **build_kwargs)
    batch = _tile(replicate_state(spec, state, nlr, seed=seed), len(explore_rates))
    exp_col = _f32_col(explore_rates, state.t.device).repeat_interleave(nlr)
    batch = batch.replace(learn=batch.learn.replace(explore=exp_col))
    batch = _with_loads(batch, load_intervals, n_rep)
    final = run_replicated(spec, batch, net, bounds, n_ticks=n_ticks)
    counters = replica_counters(final)
    cnt = final.learn.lat_cnt.cpu().numpy()
    counters["lat_cnt"] = cnt
    counters["lat_mean_s"] = np.where(
        cnt > 0, final.learn.lat_sum.cpu().numpy() / np.maximum(cnt, 1.0), np.nan
    )
    return _split_grid(counters, [float(e) for e in explore_rates], n_loads, n_rep)


def fork_state(state: WorldState, n: int) -> WorldState:
    """``n`` bit-identical rows of one live state: no re-keying and no
    start-time resampling, the opposite of :func:`.replicate_state`."""
    return broadcast_state(state, n)


def sweep_dyn(build: Callable[..., tuple], knobs: Mapping[str, Sequence], *args, **kwargs):
    """Not ported yet: a grid of promoted knobs (``ROADMAP.md`` §1 item 11)."""
    refuse_dyn_sweep("sweep_dyn")


def sweep_dyn_from(spec, state, net, bounds, knobs: Mapping[str, Sequence], n_ticks: int):
    """Not ported yet: a grid of promoted knobs forked from a live state
    (``ROADMAP.md`` §1 item 11)."""
    refuse_dyn_sweep("sweep_dyn_from")
