"""Device-resident world state: dataclasses of tensors, leaf for leaf.

Counterpart of ``fognetsimpp_tpu/state.py``.  Every class lists the same
fields in the same order with the same shapes and dtypes as its JAX
twin, including the zero-row sub-states of subsystems the port does not
carry yet (``ChaosState``, ``HierState``, ``TelemetryState``), so a flattened port state lines up with
``jax.tree_util.tree_leaves`` of the JAX state leaf by leaf.

One representation differs: a PRNG key (``WorldState.key``,
``ChaosState.key``) holds its two uint32 words in an ``int64`` tensor
(see :mod:`fognetsimpp_tpu_torch.random`); :func:`state_to_numpy` hands it
back as uint32.

Every dataclass here is registered as a ``torch.utils._pytree`` node
(:func:`register_pytree`), so ``torch.func.vmap`` takes and returns a
whole world: a replica batch is the same tree with a leading axis on
every leaf (:mod:`..parallel.replicas`).

The carry-across functions :func:`state_to_numpy`,
:func:`state_from_numpy` and :func:`net_from_numpy` move a world between
the two packages as a flat list of numpy arrays in leaf order.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from . import random as trandom
from .device import resolve_device
from .envelope import check_slice
from .spec import NodeKind, Policy, WorldSpec
from .telemetry.metrics import EXG_OCC_BINS, J_NCOLS, RES_FIELDS

# Sentinel for "no task": valid task ids are [0, T).
NO_TASK = -1


class Struct:
    """Mixin: functional field replacement, as flax's ``.replace``."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def register_pytree(cls):
    """Class decorator: ``cls``, a dataclass of tensors and dataclasses,
    becomes a torch pytree node whose children are its fields in order."""
    pytree.register_dataclass(cls)
    return cls


@register_pytree
@dataclasses.dataclass
class NodeState(Struct):
    """Per-node state, length N, layout [users | fogs | broker | aps | routers]."""

    kind: torch.Tensor  # (N,) int8 NodeKind
    pos: torch.Tensor  # (N, 2) f32
    alive: torch.Tensor  # (N,) bool
    mobility: torch.Tensor  # (N,) int8
    vel: torch.Tensor  # (N, 2) f32
    circle_center: torch.Tensor  # (N, 2) f32
    circle_radius: torch.Tensor  # (N,) f32
    circle_omega: torch.Tensor  # (N,) f32
    circle_phase: torch.Tensor  # (N,) f32
    energy: torch.Tensor  # (N,) f32
    energy_capacity: torch.Tensor  # (N,) f32
    has_energy: torch.Tensor  # (N,) bool
    link_backlog: torch.Tensor  # (N,) f32
    link_drop_p: torch.Tensor  # (N,) f32
    tx_count: torch.Tensor  # (N,) i32
    rx_count: torch.Tensor  # (N,) i32
    assoc_sum: torch.Tensor  # (N,) i32


@register_pytree
@dataclasses.dataclass
class UserState(Struct):
    """Per-user application state, length U."""

    next_send: torch.Tensor  # (U,) f32
    send_count: torch.Tensor  # (U,) i32
    send_interval: torch.Tensor  # (U,) f32
    connected: torch.Tensor  # (U,) bool
    start_t: torch.Tensor  # (U,) f32
    connack_at: torch.Tensor  # (U,) f32
    publisher: torch.Tensor  # (U,) bool
    pub_topic: torch.Tensor  # (U,) i32
    sub_mask: torch.Tensor  # (U, n_topics) bool
    n_delivered: torch.Tensor  # (U,) i32


@register_pytree
@dataclasses.dataclass
class FogState(Struct):
    """Per-fog FIFO server state, length F; ``queue`` is an (F, Q) ring."""

    mips: torch.Tensor  # (F,) f32
    busy_time: torch.Tensor  # (F,) f32
    current_task: torch.Tensor  # (F,) i32
    busy_until: torch.Tensor  # (F,) f32
    free_since: torch.Tensor  # (F,) f32
    queue: torch.Tensor  # (F, Q) i32
    q_head: torch.Tensor  # (F,) i32
    q_len: torch.Tensor  # (F,) i32
    q_drops: torch.Tensor  # (F,) i32
    pool_avail: torch.Tensor  # (F,) f32


@register_pytree
@dataclasses.dataclass
class BrokerView(Struct):
    """The base broker's (possibly stale) table of fog nodes."""

    view_mips: torch.Tensor  # (F,) f32
    view_busy: torch.Tensor  # (F,) f32
    registered: torch.Tensor  # (F,) bool
    register_t: torch.Tensor  # (F,) f32
    adv_val_mips: torch.Tensor  # (F,) f32
    adv_val_busy: torch.Tensor  # (F,) f32
    adv_arrive_t: torch.Tensor  # (F,) f32
    rr_next: torch.Tensor  # () i32
    local_pool: torch.Tensor  # () f32
    release_timer_t: torch.Tensor  # () f32
    policy_id: torch.Tensor  # () i32


@register_pytree
@dataclasses.dataclass
class TaskState(Struct):
    """Task lifecycle table, capacity T = U * max_sends_per_user; slot
    ``u * S + k`` belongs to user ``u``'s ``k``-th publish."""

    stage: torch.Tensor  # (T,) int8 Stage
    user: torch.Tensor  # (T,) i32
    fog: torch.Tensor  # (T,) i32
    mips_req: torch.Tensor  # (T,) f32
    t_create: torch.Tensor  # (T,) f32
    t_at_broker: torch.Tensor  # (T,) f32
    t_at_fog: torch.Tensor  # (T,) f32
    t_service_start: torch.Tensor  # (T,) f32
    t_complete: torch.Tensor  # (T,) f32
    t_q_enter: torch.Tensor  # (T,) f32
    t_ack3: torch.Tensor  # (T,) f32
    t_ack4_fwd: torch.Tensor  # (T,) f32
    t_ack4_queued: torch.Tensor  # (T,) f32
    t_ack5: torch.Tensor  # (T,) f32
    t_ack6: torch.Tensor  # (T,) f32
    queue_time_ms: torch.Tensor  # (T,) f32
    req_open: torch.Tensor  # (T,) int8


@register_pytree
@dataclasses.dataclass
class Metrics(Struct):
    """Running counters, all () i32."""

    n_published: torch.Tensor
    n_scheduled: torch.Tensor
    n_completed: torch.Tensor
    n_dropped: torch.Tensor
    n_no_resource: torch.Tensor
    n_connected: torch.Tensor
    n_subscribed: torch.Tensor
    n_fanout: torch.Tensor
    n_rejected: torch.Tensor
    n_local: torch.Tensor
    n_adverts: torch.Tensor
    n_lost: torch.Tensor
    n_link_drops: torch.Tensor
    n_deferred: torch.Tensor
    n_deferred_max: torch.Tensor


@register_pytree
@dataclasses.dataclass
class LearnState(Struct):
    """Bandit learner state (``fognetsimpp_tpu/learn/bandits.LearnState``):
    the per-fog arm statistics, and per-task decision provenance sized
    ``spec.learn_capacity`` (zero rows unless the learn subsystem is on)."""

    pick_count: torch.Tensor  # (F,) f32
    reward_cnt: torch.Tensor  # (F,) f32
    reward_sum: torch.Tensor  # (F,) f32
    disc_cnt: torch.Tensor  # (F,) f32
    disc_sum: torch.Tensor  # (F,) f32
    logw: torch.Tensor  # (F,) f32
    explore: torch.Tensor  # () f32
    lat_sum: torch.Tensor  # () f32
    lat_cnt: torch.Tensor  # () f32
    pick_p: torch.Tensor  # (Tl,) f32
    credited: torch.Tensor  # (Tl,) int8


@register_pytree
@dataclasses.dataclass
class ChaosState(Struct):
    """Fault-injection state (inert: zero-row per-fog/per-task leaves)."""

    key: torch.Tensor  # (2,) PRNG key words (int64)
    next_down: torch.Tensor  # (Fc,) f32
    next_up: torch.Tensor  # (Fc,) f32
    epoch: torch.Tensor  # (Fc,) i32
    down_ticks: torch.Tensor  # (Fc,) i32
    rtt_phase: torch.Tensor  # (Fc,) f32
    retry: torch.Tensor  # (Tc,) int8
    n_crashes: torch.Tensor  # () i32
    n_recovers: torch.Tensor  # () i32
    n_lost_crash: torch.Tensor  # () i32
    n_reoffloaded: torch.Tensor  # () i32
    n_retry_exhausted: torch.Tensor  # () i32


@register_pytree
@dataclasses.dataclass
class HierState(Struct):
    """Federated multi-broker state (inert: zero-row on one broker)."""

    user_broker: torch.Tensor  # (Uh,) i32
    fog_broker: torch.Tensor  # (Fh,) i32
    task_broker: torch.Tensor  # (Th,) i32
    hops: torch.Tensor  # (Th,) int8
    peer_load: torch.Tensor  # (Bh, Bh) f32
    peer_t: torch.Tensor  # (Bh, Bh) f32
    mig_out: torch.Tensor  # (Bh,) i32
    mig_in: torch.Tensor  # (Bh,) i32
    n_migrated: torch.Tensor  # () i32
    n_hop_exhausted: torch.Tensor  # () i32


@register_pytree
@dataclasses.dataclass
class TelemetryState(Struct):
    """Device telemetry accumulators (inert: zero-row when off)."""

    ticks: torch.Tensor
    defer_sum: torch.Tensor
    q_len_sum: torch.Tensor
    q_len_max: torch.Tensor
    q_len_min: torch.Tensor
    busy_ticks: torch.Tensor
    pool_occ_sum: torch.Tensor
    pick_hist: torch.Tensor
    phase_work: torch.Tensor
    res: torch.Tensor
    lat_hist: torch.Tensor
    lat_sum: torch.Tensor
    lat_seen: torch.Tensor
    exg_occ_hist: torch.Tensor
    exg_occ_sum: torch.Tensor
    exg_cand_sum: torch.Tensor
    exg_defer_sum: torch.Tensor
    exg_defer_max: torch.Tensor
    exg_util_sum: torch.Tensor
    exg_age_max: torch.Tensor
    exg_occ_res: torch.Tensor
    hier_load_sum: torch.Tensor
    hier_load_res: torch.Tensor
    j_task: torch.Tensor
    j_prev: torch.Tensor
    j_ring: torch.Tensor
    j_cursor: torch.Tensor
    j_dropped: torch.Tensor


@register_pytree
@dataclasses.dataclass
class WorldState(Struct):
    """The full world.  ``t`` is the tick-boundary clock."""

    t: torch.Tensor  # () f32
    tick: torch.Tensor  # () i32
    key: torch.Tensor  # (2,) PRNG key words (int64)
    nodes: NodeState
    users: UserState
    fogs: FogState
    broker: BrokerView
    tasks: TaskState
    metrics: Metrics
    learn: LearnState
    chaos: ChaosState
    hier: HierState
    telem: TelemetryState


def init_learn_state(spec: WorldSpec, device) -> LearnState:
    """The t=0 learner for ``spec``: zero-row provenance columns when the
    learn subsystem is off."""
    F, Tl = spec.n_fogs, spec.learn_capacity
    f32 = torch.float32

    def full(shape, v, dt=f32):
        return torch.full(shape, v, dtype=dt, device=device)

    return LearnState(
        pick_count=full((F,), 0.0),
        reward_cnt=full((F,), 0.0),
        reward_sum=full((F,), 0.0),
        disc_cnt=full((F,), 0.0),
        disc_sum=full((F,), 0.0),
        logw=full((F,), 0.0),
        explore=full((), spec.learn_explore),
        lat_sum=full((), 0.0),
        lat_cnt=full((), 0.0),
        pick_p=full((Tl,), 1.0),
        credited=full((Tl,), 0, torch.int8),
    )


def init_state(
    spec: WorldSpec,
    key: Optional[torch.Tensor] = None,
    device=None,
) -> WorldState:
    """The t=0 world for ``spec`` (``fognetsimpp_tpu.state.init_state``)."""
    check_slice(spec)
    dev = resolve_device(device)
    if key is None:
        key = trandom.PRNGKey(0, dev)
    key = key.to(dev)
    N, U, F, T, Q = (
        spec.n_nodes, spec.n_users, spec.n_fogs, spec.task_capacity,
        spec.queue_capacity,
    )
    f32, i32, i8 = torch.float32, torch.int32, torch.int8
    inf = float("inf")

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=dev)

    kind = torch.zeros((N,), dtype=i8, device=dev)
    kind[spec.fog_slice[0]: spec.fog_slice[1]] = int(NodeKind.FOG)
    kind[spec.broker_index] = int(NodeKind.BROKER)
    if spec.n_aps:
        kind[spec.ap_slice[0]: spec.ap_slice[1]] = int(NodeKind.AP)
    if spec.n_routers:
        kind[spec.ap_slice[1]:] = int(NodeKind.ROUTER)

    nodes = NodeState(
        kind=kind,
        pos=full((N, 2), 0.0, f32),
        alive=full((N,), True, torch.bool),
        mobility=full((N,), 0, i8),
        vel=full((N, 2), 0.0, f32),
        circle_center=full((N, 2), 0.0, f32),
        circle_radius=full((N,), 0.0, f32),
        circle_omega=full((N,), 0.0, f32),
        circle_phase=full((N,), 0.0, f32),
        energy=full((N,), spec.energy_capacity_j, f32),
        energy_capacity=full((N,), spec.energy_capacity_j, f32),
        has_energy=full((N,), False, torch.bool),
        link_backlog=full((N,), 0.0, f32),
        link_drop_p=full((N,), 0.0, f32),
        tx_count=full((N,), 0, i32),
        rx_count=full((N,), 0, i32),
        assoc_sum=full((N,), 0, i32),
    )

    keys = trandom.split(key, 2)
    key, k_start = keys[0], keys[1]
    start = trandom.uniform(
        k_start, (U,), spec.start_time_min,
        max(spec.start_time_max, spec.start_time_min + 1e-9),
    )
    gating = spec.connect_gating
    users = UserState(
        next_send=full((U,), inf, f32) if gating else start.clone(),
        send_count=full((U,), 0, i32),
        send_interval=full((U,), spec.send_interval, f32),
        connected=full((U,), not gating, torch.bool),
        start_t=start,
        connack_at=full((U,), inf, f32),
        publisher=full((U,), True, torch.bool),
        pub_topic=full((U,), 0, i32),
        sub_mask=full((U, spec.n_topics), False, torch.bool),
        n_delivered=full((U,), 0, i32),
    )
    fogs = FogState(
        mips=full((F,), 1000.0, f32),
        busy_time=full((F,), 0.0, f32),
        current_task=full((F,), NO_TASK, i32),
        busy_until=full((F,), inf, f32),
        free_since=full((F,), -inf, f32),
        queue=full((F, Q), NO_TASK, i32),
        q_head=full((F,), 0, i32),
        q_len=full((F,), 0, i32),
        q_drops=full((F,), 0, i32),
        pool_avail=full((F,), 1000.0, f32),
    )
    view_mips0 = 0.0 if spec.bug_compat.zero_initial_view_mips else 1000.0
    broker = BrokerView(
        view_mips=full((F,), view_mips0, f32),
        view_busy=full((F,), 0.0, f32),
        registered=full((F,), not gating, torch.bool),
        register_t=full((F,), inf if gating else 0.0, f32),
        adv_val_mips=full((F,), 0.0, f32),
        adv_val_busy=full((F,), 0.0, f32),
        adv_arrive_t=full((F,), inf, f32),
        rr_next=full((), 0, i32),
        local_pool=full((), spec.broker_mips, f32),
        release_timer_t=full((), inf, f32),
        policy_id=full(
            (), 0 if spec.policy == int(Policy.DYNAMIC) else spec.policy, i32
        ),
    )
    S = spec.max_sends_per_user
    tasks = TaskState(
        stage=full((T,), 0, i8),
        user=torch.arange(U, dtype=i32, device=dev).repeat_interleave(S),
        fog=full((T,), NO_TASK, i32),
        mips_req=full((T,), 0.0, f32),
        t_create=full((T,), inf, f32),
        t_at_broker=full((T,), inf, f32),
        t_at_fog=full((T,), inf, f32),
        t_service_start=full((T,), inf, f32),
        t_complete=full((T,), inf, f32),
        t_q_enter=full((T,), inf, f32),
        t_ack3=full((T,), inf, f32),
        t_ack4_fwd=full((T,), inf, f32),
        t_ack4_queued=full((T,), inf, f32),
        t_ack5=full((T,), inf, f32),
        t_ack6=full((T,), inf, f32),
        queue_time_ms=full((T,), inf, f32),
        req_open=full((T,), 0, i8),
    )
    metrics = Metrics(
        **{f.name: full((), 0, i32) for f in dataclasses.fields(Metrics)}
    )
    learn = init_learn_state(spec, dev)
    Fc, Tc = spec.chaos_fogs, spec.chaos_tasks
    chaos = ChaosState(
        key=trandom.PRNGKey(0, dev),
        next_down=full((Fc,), 0.0, f32),
        next_up=full((Fc,), 0.0, f32),
        epoch=full((Fc,), 0, i32),
        down_ticks=full((Fc,), 0, i32),
        rtt_phase=full((Fc,), 0.0, f32),
        retry=full((Tc,), 0, i8),
        n_crashes=full((), 0, i32),
        n_recovers=full((), 0, i32),
        n_lost_crash=full((), 0, i32),
        n_reoffloaded=full((), 0, i32),
        n_retry_exhausted=full((), 0, i32),
    )
    B = spec.hier_brokers
    hier = HierState(
        user_broker=full((0,), 0, i32),
        fog_broker=full((0,), 0, i32),
        task_broker=full((0,), 0, i32),
        hops=full((spec.hier_tasks,), 0, i8),
        peer_load=full((B, B), 0.0, f32),
        peer_t=full((B, B), 0.0, f32),
        mig_out=full((B,), 0, i32),
        mig_in=full((B,), 0, i32),
        n_migrated=full((), 0, i32),
        n_hop_exhausted=full((), 0, i32),
    )
    Fm, Pm, Rm = (
        spec.telemetry_fogs, spec.telemetry_phases, spec.telemetry_slots
    )
    Sm, Bm, J, Rj = (
        spec.telemetry_tp_shards, spec.telemetry_hier_brokers,
        spec.journey_slots, spec.journey_ring,
    )
    telem = TelemetryState(
        ticks=full((), 0, i32),
        defer_sum=full((), 0, i32),
        q_len_sum=full((Fm,), 0.0, f32),
        q_len_max=full((Fm,), 0, i32),
        q_len_min=full((Fm,), spec.queue_capacity, i32),
        busy_ticks=full((Fm,), 0, i32),
        pool_occ_sum=full((Fm,), 0.0, f32),
        pick_hist=full((Fm,), 0.0, f32),
        phase_work=full((Pm,), 0, i32),
        res=full((Rm, len(RES_FIELDS)), 0.0, f32),
        lat_hist=full(
            (spec.telemetry_hist_fogs, spec.telemetry_hist_nbins), 0, i32
        ),
        lat_sum=full((spec.telemetry_hist_fogs,), 0.0, f32),
        lat_seen=full((spec.telemetry_hist_tasks,), 0, i8),
        exg_occ_hist=full((Sm, EXG_OCC_BINS), 0, i32),
        exg_occ_sum=full((Sm,), 0.0, f32),
        exg_cand_sum=full((Sm,), 0, i32),
        exg_defer_sum=full((Sm,), 0, i32),
        exg_defer_max=full((Sm,), 0, i32),
        exg_util_sum=full((Sm,), 0.0, f32),
        exg_age_max=full((Sm,), 0.0, f32),
        exg_occ_res=full((Rm if Sm else 0, Sm), 0.0, f32),
        hier_load_sum=full((Bm,), 0.0, f32),
        hier_load_res=full((Rm if Bm else 0, Bm), 0.0, f32),
        j_task=full((0,), 0, i32),
        j_prev=full((0, J_NCOLS), 0, i32),
        j_ring=full((J, Rj, 4), 0, i32),
        j_cursor=full((J,), 0, i32),
        j_dropped=full((), 0, i32),
    )
    return WorldState(
        t=full((), 0.0, f32),
        tick=full((), 0, i32),
        key=key,
        nodes=nodes,
        users=users,
        fogs=fogs,
        broker=broker,
        tasks=tasks,
        metrics=metrics,
        learn=learn,
        chaos=chaos,
        hier=hier,
        telem=telem,
    )


# ----------------------------------------------------------------------
# leaf order and the numpy carry-across
# ----------------------------------------------------------------------

def _child_types(cls) -> dict:
    hints = typing.get_type_hints(cls)
    return {
        f.name: hints[f.name]
        for f in dataclasses.fields(cls)
        if dataclasses.is_dataclass(hints[f.name])
    }


def tree_leaves(obj, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` pairs in the JAX pytree's leaf order."""
    out: List[Tuple[str, torch.Tensor]] = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        path = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v):
            out.extend(tree_leaves(v, path + "."))
        else:
            out.append((path, v))
    return out


def tree_map(fn, tree, *rest):
    """``fn`` leaf by leaf over dataclass trees of one structure (the
    first tree's), like ``jax.tree.map``."""
    vals = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        others = [getattr(r, f.name) for r in rest]
        vals[f.name] = (
            tree_map(fn, v, *others) if dataclasses.is_dataclass(v)
            else fn(v, *others)
        )
    return type(tree)(**vals)


def _is_key(path: str) -> bool:
    return path == "key" or path.endswith(".key")


def _to_numpy(path: str, x: torch.Tensor) -> np.ndarray:
    a = x.detach().cpu().numpy()
    return a.astype(np.uint32) if _is_key(path) else a


def state_to_numpy(tree) -> List[np.ndarray]:
    """Flat numpy leaves of a port state (or any port dataclass tree), in
    the JAX leaf order; PRNG keys come back as uint32."""
    return [_to_numpy(p, x) for p, x in tree_leaves(tree)]


def _from_numpy(path: str, a: np.ndarray, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        if not _is_key(path):
            raise TypeError(f"unexpected uint32 leaf {path}")
        a = a.astype(np.int64)
    return torch.as_tensor(np.array(a, copy=True), device=dev)


def _unflatten(cls, it: Iterator[np.ndarray], dev, prefix: str = ""):
    kids = _child_types(cls)
    vals = {}
    for f in dataclasses.fields(cls):
        path = prefix + f.name
        if f.name in kids:
            vals[f.name] = _unflatten(kids[f.name], it, dev, path + ".")
        else:
            vals[f.name] = _from_numpy(path, next(it), dev)
    return cls(**vals)


def tree_from_numpy(cls, leaves: Sequence[np.ndarray], device=None):
    """Rebuild a port dataclass tree of type ``cls`` from flat numpy
    leaves in the JAX leaf order (``jax.tree_util.tree_leaves``)."""
    dev = resolve_device(device)
    it = iter(list(leaves))
    out = _unflatten(cls, it, dev)
    if next(it, None) is not None:
        raise ValueError(f"too many leaves for {cls.__name__}")
    return out


def state_from_numpy(leaves: Sequence[np.ndarray], device=None) -> WorldState:
    """A port :class:`WorldState` from the JAX state's numpy leaves."""
    return tree_from_numpy(WorldState, leaves, device)


def net_from_numpy(leaves: Sequence[np.ndarray], device=None):
    """A port ``NetParams`` from the JAX ``NetParams``' numpy leaves."""
    from .net.topology import NetParams

    return tree_from_numpy(NetParams, leaves, device)
