"""Policy × load and exploration × load sweeps (``fognetsimpp_tpu/parallel/sweep.py``).

The load axis is always data: the per-user publish interval is a state
column (``users.send_interval``), so every load level × Monte-Carlo
replica is one more row of one replica batch.  The policy axis is either
static (one batch a policy) or ``dynamic=True`` (``Policy.DYNAMIC``: the
policy id rides in ``broker.policy_id``, a device tensor, so the whole
grid is one batch).  For a learned policy the exploration rate is data
too (``learn.explore``): :func:`sweep_explore` runs a rate × load grid
as one batch.

Any promoted knob (:data:`..dynspec.DYN_FIELDS`) is data as well:
:func:`sweep_dyn` runs a knob grid as one batch whose replicas carry
their cell's DynSpec row, and :func:`sweep_dyn_from` forks a live state
onto such a grid (the what-if).

``mesh=`` splits a grid's batch over the slots of a :class:`.mesh.Mesh`
(:func:`.mesh.run_sharded`; :func:`.fleet.run_fleet` for a knob grid);
the counters equal the unsplit grid's.  The
grid's replica count must divide the mesh size.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..chaos.faults import init_chaos_state, refold_chaos_state
from ..dynspec import DYN_FIELDS, dyn_of, dyn_rows, shape_key
from ..spec import ARGMIN_FAMILY, LEARNED_POLICIES, Policy, WorldSpec
from ..state import WorldState, tree_map
from .fleet import run_fleet
from .mesh import make_mesh, run_sharded
from .replicas import (
    broadcast_state, fold_replica_chaos_keys, replica_counters, replicate_state,
    run_replicated,
)


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


def _advance(spec: WorldSpec, batch: WorldState, net, bounds, mesh, n_ticks):
    """A grid's batch advanced over ``mesh`` (default: one slot)."""
    mesh = mesh or make_mesh(device=batch.t.device)
    return run_sharded(spec, batch, net, bounds, mesh, n_ticks=n_ticks)


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

    ``mesh`` splits each batch over the mesh's slots (:func:`.mesh.run_sharded`).

    Returns ``{policy: {counter: (n_loads, n_replicas) array}}``.
    """
    out: Dict[int, Dict[str, np.ndarray]] = {}
    for pols, spec, batch, net, bounds in policy_batches(
        build, policies, load_intervals, n_replicas_per_load, seed, dynamic,
        **build_kwargs,
    ):
        final = _advance(spec, batch, net, bounds, mesh, n_ticks)
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
    n_loads, n_rep = len(load_intervals), n_replicas_per_load
    nlr = n_loads * n_rep
    build_kwargs.setdefault("send_interval", min(load_intervals))
    spec, state, net, bounds = build(policy=int(policy), **build_kwargs)
    batch = _tile(replicate_state(spec, state, nlr, seed=seed), len(explore_rates))
    exp_col = _f32_col(explore_rates, state.t.device).repeat_interleave(nlr)
    batch = batch.replace(learn=batch.learn.replace(explore=exp_col))
    batch = _with_loads(batch, load_intervals, n_rep)
    final = _advance(spec, batch, net, bounds, mesh, n_ticks)
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


def _knob_grid(knobs: Mapping[str, Sequence], what: str) -> List[Dict]:
    """The cartesian grid of ``knobs`` in sorted-name order, each cell a
    ``{knob: value}`` dict; ``ValueError`` for a field that is not a
    promoted knob."""
    bad = sorted(set(knobs) - set(DYN_FIELDS))
    if bad:
        raise ValueError(
            f"{what} grids promoted knobs only; {', '.join(bad)} "
            "is shape-defining (see dynspec.DYN_FIELDS / the README "
            "'one program, many worlds' table)"
        )
    names = sorted(knobs)
    return [
        dict(zip(names, vals))
        for vals in itertools.product(*(knobs[k] for k in names))
    ]


def _cell_chaos(spec: WorldSpec, state: WorldState, n_rep: int):
    """A grid cell's ``n_rep`` chaos rows: ``spec``'s t=0 schedule on the
    world key of ``state``, re-keyed a replica (:func:`.replicate_state`)."""
    ch0 = init_chaos_state(spec, state.key)
    return refold_chaos_state(spec, ch0, fold_replica_chaos_keys(ch0.key, n_rep))


def dyn_batch(
    build: Callable[..., tuple],
    knobs: Mapping[str, Sequence],
    n_replicas_per_cell: int = 1,
    seed: int = 0,
    **build_kwargs,
):
    """The replica batch of a grid of promoted knobs, as :func:`sweep_dyn`
    runs it: ``(grid, key, batch, net, bounds, dyn_rows)``, ``key`` the
    grid's shared shape key and ``dyn_rows`` each replica's cell of knobs
    on the batch's device.  ``(grid, None, None, None, None, None)`` for
    an empty grid."""
    grid = _knob_grid(knobs, "sweep_dyn")
    if not grid:
        return grid, None, None, None, None, None
    spec0, state, net, bounds = build(**{**build_kwargs, **grid[0]})
    cells = [dataclasses.replace(spec0, **cell).validate() for cell in grid]
    key0 = shape_key(cells[0])
    for cell, sp in zip(grid, cells):
        if shape_key(sp) != key0:
            raise ValueError(
                f"grid cell {cell} leaves the shape bucket (a knob "
                "crossed a trace gate, e.g. 0 vs positive): split the "
                "sweep per gate class"
            )
    nrc = int(n_replicas_per_cell)
    batch = _tile(replicate_state(spec0, state, nrc, seed=seed), len(cells))
    if spec0.chaos:
        # the t=0 schedule (the first crash gap) is drawn from the cell's
        # MTBF: each cell's rows start where replicate_state of a direct
        # build of its spec would, keyed on the built world's key
        batch = batch.replace(chaos=tree_map(
            lambda *xs: torch.cat(xs), *[_cell_chaos(sp, state, nrc) for sp in cells]
        ))
    rows = dyn_rows([dyn_of(sp) for sp in cells], state.t.device, nrc)
    return grid, key0, batch, net, bounds, rows


def sweep_dyn(
    build: Callable[..., tuple],
    knobs: Mapping[str, Sequence],
    n_replicas_per_cell: int = 1,
    seed: int = 0,
    n_ticks: Optional[int] = None,
    mesh=None,
    **build_kwargs,
) -> List[Dict]:
    """A grid of promoted knobs as one replica batch (``sweep.sweep_dyn``).

    ``knobs`` maps promoted fields to value lists; the world is built at
    the first cell's values (``build(**build_kwargs, **cell0)``), every
    cell must keep its shape key (a grid that crosses a gate, e.g. loss 0
    and 0.2, raises), and the batch runs the shared key with each
    replica's cell row of knobs as an operand (:func:`dyn_batch`).  Cell
    i holds replicas ``i * n_replicas_per_cell`` to
    ``(i + 1) * n_replicas_per_cell - 1``, keyed as :func:`.replicate_state`
    keys one cell.

    ``mesh`` splits the batch over the mesh's slots
    (:func:`.fleet.run_fleet`, promoted with these rows).

    Returns ``[{knob: value, ..., "counters": {name: (n_rep,) array}}]``
    in grid order.
    """
    grid, key0, batch, net, bounds, rows = dyn_batch(
        build, knobs, n_replicas_per_cell, seed, **build_kwargs
    )
    if not grid:
        return []
    if mesh is not None:
        final = run_fleet(key0, batch, net, bounds, mesh=mesh, n_ticks=n_ticks,
                          promote=True, dyn_rows=rows)
    else:
        final = run_replicated(key0, batch, net, bounds, n_ticks=n_ticks, dyn_rows=rows)
    counters = replica_counters(final)
    nrc = int(n_replicas_per_cell)
    return [
        {**cell, "counters": {k: v[i * nrc: (i + 1) * nrc] for k, v in counters.items()}}
        for i, cell in enumerate(grid)
    ]


def sweep_dyn_from(
    spec: WorldSpec,
    state: WorldState,
    net,
    bounds,
    knobs: Mapping[str, Sequence],
    n_ticks: int,
) -> Tuple[List[Dict], Optional[WorldState]]:
    """A grid of promoted knobs forked from a live state (``sweep.sweep_dyn_from``):
    row i of the batch is ``state`` itself (:func:`fork_state`: the same
    key, nothing resampled) run ``n_ticks`` ticks under cell i's knobs,
    which equals a direct run of the retuned spec from ``state``.  Every
    cell must keep ``spec``'s shape key.

    Returns ``(grid, final_batch)``; ``([], None)`` for an empty grid.
    """
    grid = _knob_grid(knobs, "what-if")
    if not grid:
        return [], None
    cells = [dataclasses.replace(spec, **cell).validate() for cell in grid]
    key0 = shape_key(spec)
    for cell, sp in zip(grid, cells):
        if shape_key(sp) != key0:
            raise ValueError(
                f"what-if cell {cell} leaves the live session's shape "
                "bucket (a knob crossed a trace gate, e.g. 0 vs "
                "positive): such a retuning needs a recompile and "
                "cannot be answered from the live program"
            )
    batch = fork_state(state, len(cells))
    rows = dyn_rows([dyn_of(sp) for sp in cells], state.t.device)
    final = run_replicated(key0, batch, net, bounds, n_ticks=n_ticks, dyn_rows=rows)
    return grid, final
