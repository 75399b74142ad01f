"""The task-sharded (TP) tick and its runner: one world's user and task
rows split over ``n`` shards.

Counterpart of the explicit ``shard_map`` TP tick of
``fognetsimpp_tpu/parallel/taskshard.py`` for the dense-broker FIFO
static family (:func:`..core.engine.tp_reject_reason`).  It is the same
algorithm: each shard runs the engine's phases, given the shard context
``tp``, on its LOCAL world view (a
spec with ``n_users = U / n``, its rows of the user, task and user-node
tables; fog, broker, metrics and PRNG state replicated, one copy per
shard), with the collectives at the places the JAX tick has them:

- spawn and connect: none (per-user draws at the global width, cut);
- dense broker: one ``psum`` of the per-topic fan-out counts;
- completions: one ``psum`` a pass gathers the task columns the
  replicated fog state points at (``engine._task_gather``);
- fog arrivals: one ``psum`` of the saturated-fog drop sums, then the
  exchange (:func:`_exchange`): the no-window ring (:meth:`ShardGroup.ring_all_gather`, the
  CUDA kernel of ``csrc/ring_gather.cu``) or, for a windowed spec, the
  distributed top-K merge (:meth:`ShardGroup.ring_topk_merge`); every
  shard runs the reference assignment and FIFO tail on the assembled
  window, and task writes land on the owning shard only;
- counters: one end-of-tick ``psum``; a static access-point world adds
  the hoisted cache's per-AP association counts to every shard's copy of
  the AP rows (its uplink loss is the cut ``mac_loss_p``).

The shards run as threads of one process on one device
(:mod:`.shards`), the way ``shard_map`` runs one body per device.  Every
leaf is bit-equal to the single-device engine where the JAX TP tick is
(no exchange window, or a windowed spec), and to the JAX TP runner with
a bounded exchange window.  By default the runners take the promoted
knobs as a device operand shared by the shards (``promote``, as the JAX
TP runner does; :mod:`..dynspec`), and :func:`run_tp_chunked` may retune
them between chunks.  Donation has no counterpart.

With the telemetry plane on, the runner stamps the shard axis on the
spec (:func:`stamp_tp_telemetry`: ``tp_shards`` and the per-shard
exchange gauges), each shard books its part of every phase bracket, the
latency histogram's deltas over its task rows and the journeys of the
sampled slots it owns, and one int32 and one float32 sum over the shards
fold them at the end of the tick (:func:`_tp_telemetry_fold`).  The sums
go in shard order on one device; the float32 latency sums of the
histogram agree with the JAX TP runner's to the 1e-6 the reference
documents, every other leaf bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from ..core.engine import (
    _F32,
    _I32,
    _INF,
    _M32,
    TickBuf,
    TpCtx,
    _compact,
    _compact_lane_width,
    _finalize_derived_acks,
    _isum,
    _phase_adverts,
    _phase_broker_dense,
    _phase_completions,
    _phase_connect,
    _phase_fog_arrivals,
    _phase_spawn,
    _phase_spawn_multi,
    _PhaseBook,
    _run,
    _span,
    tp_ok,
    tp_reject_reason,
)
from ..dynspec import (
    DynSpec, apply_knobs, div_knob, dyn_of, dyn_to_device, promote_default, split_spec,
)
from ..f32math import const, kept_tensor
from ..net.mobility import MobilityBounds
from ..net.topology import LinkCache, NetParams, associate
from ..ops.queues import NO_TASK
from ..ops.scatter import set_drop
from ..spec import WorldSpec
from ..state import Metrics, NodeState, TaskState, UserState, WorldState, tree_map
from ..telemetry.health import latency_hist_delta
from ..telemetry.journeys import journey_tick_tp
from ..telemetry.metrics import (
    PHASE_INDEX, PHASES, accumulate_exchange, accumulate_tick, init_exchange_leaves,
)
from .mesh import Mesh, on_device
from .shards import ShardGroup

_METRIC_FIELDS = tuple(f.name for f in dataclasses.fields(Metrics))
#: The counters a shard's fog phases book as replicated values (the
#: deferral of its own candidates is partial).
_REP_FIELDS = tuple(f for f in _METRIC_FIELDS if f != "n_deferred")


# ----------------------------------------------------------------------
# population padding
# ----------------------------------------------------------------------

def pad_users_to_multiple(
    spec: WorldSpec, state: WorldState, net: NetParams, n: int
) -> Tuple[WorldSpec, WorldState, NetParams]:
    """Pad the population up to a multiple of ``n`` with INERT users
    (``taskshard.pad_users_to_multiple``): never started, not publishers,
    unconnected, their task rows UNUSED, their node rows unattached, so no
    phase ever touches them."""
    U = spec.n_users
    pad = (-U) % n
    if pad == 0:
        return spec, state, net
    if spec.learn_active:
        raise ValueError(
            "pad_users_to_multiple does not extend per-task learner "
            "state; pick a divisible population for learned policies"
        )
    S = spec.max_sends_per_user
    U2 = U + pad
    spec2 = dataclasses.replace(spec, n_users=U2).validate()

    def block(x, rows, fill):
        return torch.full(
            (rows,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device
        )

    def ins_nodes(x, fill):
        return torch.cat([x[:U], block(x, pad, fill), x[U:]])

    def app_users(x, fill):
        return torch.cat([x, block(x, pad, fill)])

    def app_tasks(x, fill):
        return torch.cat([x, block(x, pad * S, fill)])

    nd = state.nodes
    e_cap = spec.energy_capacity_j
    nodes = NodeState(
        kind=ins_nodes(nd.kind, 0),  # NodeKind.USER
        pos=ins_nodes(nd.pos, 0.0),
        alive=ins_nodes(nd.alive, True),
        mobility=ins_nodes(nd.mobility, 0),
        vel=ins_nodes(nd.vel, 0.0),
        circle_center=ins_nodes(nd.circle_center, 0.0),
        circle_radius=ins_nodes(nd.circle_radius, 0.0),
        circle_omega=ins_nodes(nd.circle_omega, 0.0),
        circle_phase=ins_nodes(nd.circle_phase, 0.0),
        energy=ins_nodes(nd.energy, e_cap),
        energy_capacity=ins_nodes(nd.energy_capacity, e_cap),
        has_energy=ins_nodes(nd.has_energy, False),
        link_backlog=ins_nodes(nd.link_backlog, 0.0),
        link_drop_p=ins_nodes(nd.link_drop_p, 0.0),
        tx_count=ins_nodes(nd.tx_count, 0),
        rx_count=ins_nodes(nd.rx_count, 0),
        assoc_sum=ins_nodes(nd.assoc_sum, 0),
    )
    us = state.users
    users = UserState(
        next_send=app_users(us.next_send, _INF),
        send_count=app_users(us.send_count, 0),
        send_interval=app_users(us.send_interval, spec.send_interval),
        connected=app_users(us.connected, False),
        start_t=app_users(us.start_t, _INF),
        connack_at=app_users(us.connack_at, _INF),
        publisher=app_users(us.publisher, False),
        pub_topic=app_users(us.pub_topic, 0),
        sub_mask=app_users(us.sub_mask, False),
        n_delivered=app_users(us.n_delivered, 0),
    )
    tk = state.tasks
    inf_cols = (
        "t_create", "t_at_broker", "t_at_fog", "t_service_start",
        "t_complete", "t_q_enter", "t_ack3", "t_ack4_fwd", "t_ack4_queued",
        "t_ack5", "t_ack6", "queue_time_ms",
    )
    tasks = TaskState(
        stage=app_tasks(tk.stage, 0),  # Stage.UNUSED
        user=torch.arange(U2, dtype=_I32, device=tk.user.device).repeat_interleave(S),
        fog=app_tasks(tk.fog, NO_TASK),
        mips_req=app_tasks(tk.mips_req, 0.0),
        req_open=app_tasks(tk.req_open, 0),
        **{c: app_tasks(getattr(tk, c), _INF) for c in inf_cols},
    )
    net2 = net.replace(
        node_attach=ins_nodes(net.node_attach, -1),  # unattached ghosts
        node_acc=ins_nodes(net.node_acc, 0.0),
        is_wireless=ins_nodes(net.is_wireless, False),
        ap_nodes=torch.where(net.ap_nodes >= U, net.ap_nodes + pad, net.ap_nodes),
    )
    state2 = state.replace(nodes=nodes, users=users, tasks=tasks)
    if spec.telemetry and spec.telemetry_hist:
        # the exactly-once flag grows with the task table; ghost rows stay
        # UNUSED, so their flags stay 0.  The J-sized journey leaves stay
        # as they are: ghost rows append at the table's end, so the sampled
        # ids keep their (user, send) slots (dynspec.bucket_spec's rule)
        seen = state.telem.lat_seen
        state2 = state2.replace(telem=state2.telem.replace(
            lat_seen=torch.cat([seen, torch.zeros((pad * S,), dtype=seen.dtype, device=seen.device)])
        ))
    return spec2, state2, net2


def stamp_tp_telemetry(
    spec: WorldSpec, state: WorldState, n: int
) -> Tuple[WorldSpec, WorldState]:
    """Stamp the shard axis on a telemetry-on world
    (``taskshard.stamp_tp_telemetry``): ``spec.tp_shards = n`` and the
    per-shard exchange leaves sized for it.  Idempotent; a no-op with the
    plane off.  The population must already divide over ``n``."""
    if not spec.telemetry:
        return spec, state
    if spec.tp_shards != n:
        spec = dataclasses.replace(spec, tp_shards=n).validate()
    if state.telem.exg_cand_sum.shape[0] != n:
        state = state.replace(telem=state.telem.replace(
            **init_exchange_leaves(spec, state.t.device)
        ))
    cap = (spec.n_users // n) * min(spec.arrival_cands, spec.max_sends_per_user)
    if cap >= 2 ** 24:
        # the exchange gauges ride an f32 one-hot sum over the shards:
        # per-tick candidate counts must stay exact integers in f32
        raise ValueError(
            f"per-shard candidate capacity {cap} >= 2^24: the "
            "telemetry exchange fold loses f32 integer exactness — "
            "run telemetry off at this shape or raise the shard count"
        )
    return spec, state


# ----------------------------------------------------------------------
# exchange helpers
# ----------------------------------------------------------------------

def ring_all_gather(x: torch.Tensor, tp: TpCtx) -> torch.Tensor:
    """Every shard's ``(K, C)`` block as ``(n*K, C)``, in global shard
    order (``taskshard.ring_all_gather``)."""
    if tp.n_shards == 1:
        return x
    return tp.group.ring_all_gather(tp.shard, x)


def ring_topk_merge(win: torch.Tensor, tp: TpCtx) -> torch.Tensor:
    """The globally best ``K`` rows of every shard's ``(K, W)`` window
    sorted on its last column (``taskshard.ring_topk_merge``)."""
    if tp.n_shards == 1:
        return win
    return tp.group.ring_topk_merge(tp.shard, win)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """f32 -> i32 bit pattern (floats packed into the one exchange array)."""
    return x.view(_I32)


def _floats(x: torch.Tensor) -> torch.Tensor:
    return x.view(_F32)


# ----------------------------------------------------------------------
# the arrival exchange
# ----------------------------------------------------------------------

class ExgStats(NamedTuple):
    """One shard's exchange-plane scalars of a tick (``taskshard.ExgStats``),
    made by :func:`_exchange` when the telemetry plane is on."""

    occ: torch.Tensor  # () f32 contending candidates / window slots
    util: torch.Tensor  # () f32 seated / window slots
    age: torch.Tensor  # () f32 ticks the oldest deferred candidate waited
    cand: torch.Tensor  # () f32 candidates made (before the fast drop)
    defer: torch.Tensor  # () f32 candidates deferred at the window
    seated: torch.Tensor  # () i32 candidates seated in the window


def _exg_stats(spec, t1, made, cand_v, cand_t, seat, n_set, seated, defer, slots):
    """The shard's :class:`ExgStats` (``occ`` and ``util`` over ``slots``,
    the age of the oldest candidate left waiting, in ticks)."""
    waiting = cand_v & ~seat
    age_t = torch.where(waiting, t1 - cand_t, -_INF).amax()
    # XLA divides by a literal as a product with its float32 reciprocal
    age = torch.clamp_min(div_knob(age_t, spec.dt), 0.0)
    return ExgStats(
        occ=div_knob(n_set.to(_F32), slots),
        util=div_knob(seated.to(_F32), slots),
        age=torch.where(waiting.any(), age, 0.0),
        cand=_isum(made).to(_F32),
        defer=defer.to(_F32),
        seated=seated.to(_I32),
    )


def _exchange(
    spec, tp, k_exchange: int, window_k: Optional[int], stats: Optional[dict],
    state, t1, made, cand_v, cand_slot, cand_f, cand_t, cand_m,
):
    """The window every shard's fog tail plans, from each shard's
    surviving candidates (``taskshard._tp_fog_arrivals``' exchange), and
    this shard's deferred count: ``((ids, fog, t, mips), deferred)``.

    With no window, this shard's first ``k_exchange`` candidates in the
    tick-keyed scan order ride the ring all-gather, packed into one int32
    array, and arrive in global candidate order.  A windowed spec gives
    every candidate its global scan-order position under the engine's
    tick-keyed rotation (``pos``), keeps each shard's best ``K`` and
    merges them into the globally best ``K``, so the window is the one
    the single-device engine compacts.  Sentinel rows carry the invalid
    id ``T_g``.  With ``stats`` (a telemetry-on tick) the shard's
    :class:`ExgStats` land in ``stats["exg"]``; ``made`` is its candidate
    list before the saturated-fog fast drop.
    """
    S = spec.max_sends_per_user
    T_g = tp.n_users_global * S
    UR = cand_v.shape[0]
    dev = cand_v.device
    n_set = _isum(cand_v)

    if window_k is not None:
        # each candidate's rank in _compact's rotated scan of the GLOBAL
        # candidate list; the rotation's modulus is the GLOBAL capacity
        K_w = window_k
        R = UR // spec.n_users
        UR_g = tp.n_users_global * R
        C_g = _compact_lane_width(UR_g)
        B_g = -(-UR_g // C_g)
        maxpos = B_g * C_g
        rot = ((state.tick.long() * 2654435761) & _M32) % T_g
        rot_b = rot % B_g
        c0 = ((rot * 7919) & _M32) % C_g
        g = torch.arange(UR, dtype=torch.int64, device=dev) + tp.u_off * R
        pos = (((g // C_g - rot_b) % B_g) * C_g + ((g % C_g - c0) % C_g)).to(_I32)
        # the local best K in ascending pos: top-k of the flipped key
        # (valid keys >= 1; invalid rows sink to -1 and become sentinels,
        # so the order topk gives their ties never reaches the window)
        k_loc = min(K_w, UR)
        vals, sel = torch.topk(torch.where(cand_v, maxpos - pos, -1), k_loc)
        valid_w = vals > 0
        sel = sel.long()
        win = torch.stack([
            torch.where(valid_w, cand_slot[sel], T_g),
            torch.where(valid_w, cand_f[sel], 0),
            _bits(torch.where(valid_w, cand_t[sel], _INF)),
            _bits(torch.where(valid_w, cand_m[sel], 0.0)),
            torch.where(valid_w, pos[sel], maxpos),
        ], dim=1)  # (k_loc, 5) i32
        if k_loc < K_w:
            sent = torch.tensor(
                [T_g, 0, 0x7F800000, 0, maxpos], dtype=_I32, device=dev
            )  # slot, fog, bits(+inf), bits(0.0), pos
            win = torch.cat([win, sent.expand(K_w - k_loc, 5)])
        with _span("tp_exchange"):
            full = ring_topk_merge(win, tp)
        # window-overflow deferral: a local candidate seats iff its pos is
        # within the merged window's largest valid key
        w_max = torch.where(full[:, 0] < T_g, full[:, 4], -1).amax()
        seat = cand_v & (pos <= w_max)
        seated = _isum(seat)
        deferred = n_set - seated
        slots = K_w
    else:
        # exchange-window compaction (no-window regime)
        deferred = torch.clamp_min(n_set - k_exchange, 0)
        if k_exchange >= UR:
            rot = None  # overflow impossible: plain ascending order
        else:
            # bounded window: the engine's tick-keyed scan origin, modulo
            # the LOCAL candidate count; the tick is replicated, so every
            # shard rotates alike
            rot = (((state.tick.long() * 2654435761) & _M32) % UR).to(_I32)
        _, idxc_l, valid_l = _compact(cand_v, k_exchange, UR, rot)
        gl = idxc_l.long()
        packed = torch.stack([
            torch.where(valid_l, cand_slot[gl], T_g),
            torch.where(valid_l, cand_f[gl], 0),
            _bits(torch.where(valid_l, cand_t[gl], _INF)),
            _bits(torch.where(valid_l, cand_m[gl], 0.0)),
        ], dim=1)  # (K_ex, 4) i32: one array around the ring
        with _span("tp_exchange"):
            full = ring_all_gather(packed, tp)
        if stats is not None:
            seat = set_drop(
                torch.zeros((UR,), dtype=torch.bool, device=dev),
                torch.where(valid_l, idxc_l, UR), torch.ones((), dtype=torch.bool, device=dev),
            )
            seated = torch.clamp_max(n_set, k_exchange)
        slots = k_exchange
    if stats is not None:
        stats["exg"] = _exg_stats(
            spec, t1, made, cand_v, cand_t, seat, n_set, seated, deferred, slots
        )
    return (full[:, 0], full[:, 1], _floats(full[:, 2]), _floats(full[:, 3])), deferred


# ----------------------------------------------------------------------
# the sharded tick
# ----------------------------------------------------------------------

def _zero_metrics(m: Metrics) -> Metrics:
    return tree_map(torch.zeros_like, m)


def _zero_buf(U: int, F: int, dev) -> TickBuf:
    def z(*shape):
        return torch.zeros(shape, dtype=_I32, device=dev)

    return TickBuf(tx_u=z(U), rx_u=z(U), tx_f=z(F), rx_f=z(F), tx_b=z(), rx_b=z())


def _tp_tick(
    spec: WorldSpec, tp: TpCtx, state: WorldState, net: NetParams,
    cache: LinkCache, k_exchange: int, window_k: Optional[int], dv: DynSpec,
) -> WorldState:
    """One sharded tick over the LOCAL world view (``taskshard._tp_tick``):
    connect -> adverts -> spawn -> dense decide -> completions xN ->
    arrivals (the engine's phases with ``tp``, the exchange from
    :func:`_exchange`) -> latency histogram -> journeys -> counters ->
    telemetry.  Every shard-partial counter rides ONE end-of-tick
    ``psum``; with the telemetry plane on, one int32 and one float32 psum
    more carry the phase deltas, the histogram deltas and the exchange
    gauges."""
    dev = state.t.device
    dt = const(spec.dt, dev)
    t0 = state.tick.to(_F32) * dt
    t1 = (state.tick + 1).to(_F32) * dt
    U, F = spec.n_users, spec.n_fogs
    telem_on = spec.telemetry
    hist_on = spec.telemetry and spec.telemetry_hist
    jour_on = spec.journey_active

    m_carry = state.metrics
    m_rep = _zero_metrics(m_carry)
    buf_p = _zero_buf(U, F, dev)
    buf_r = _zero_buf(U, F, dev)
    state = state.replace(metrics=_zero_metrics(m_carry))  # partial acc

    # the phase brackets: each shard books the delta of its partial
    # counters (its users' acks and its deferrals among them), shard 0
    # also that of the replicated ones, so the sum over the shards is the
    # single-device bracket (integer adds commute).  ``state.metrics`` is
    # the partial accumulator until the fog phases, which run on the
    # replicated one
    fog_side = False

    def activity():
        m_part_v, m_rep_v = (m_part, state.metrics) if fog_side else (state.metrics, m_rep)
        part = [getattr(m_part_v, f).reshape(1) for f in _METRIC_FIELDS]
        part += [x.reshape(-1) for x in buf_p] + [buf_r.tx_u, buf_r.rx_u]
        part.append(m_rep_v.n_deferred.reshape(1))
        if tp.shard == 0:
            part += [getattr(m_rep_v, f).reshape(1) for f in _REP_FIELDS]
            part += [buf_r.tx_f, buf_r.rx_f, buf_r.tx_b.reshape(1), buf_r.rx_b.reshape(1)]
        return torch.cat(part).sum(dtype=_I32)

    book = _PhaseBook(activity if telem_on else None)
    # the static world's hoisted cache stands in for mobility + association
    if spec.connect_gating:
        with book.phase("connect"):
            state, buf_p = _phase_connect(spec, state, cache, buf_p, t0, t1)
    # advert delivery counts an F-sum, identical on every shard: it goes
    # to the REPLICATED accumulator
    with book.phase("adverts"):
        m_part = state.metrics
        state = _phase_adverts(state.replace(metrics=m_rep), t1)
        m_rep, state = state.metrics, state.replace(metrics=m_part)
    with book.phase("spawn"):
        if spec.max_sends_per_tick > 1:
            state, buf_p = _phase_spawn_multi(spec, state, net, cache, buf_p, t0, t1, dv, tp=tp)
        else:
            state, buf_p = _phase_spawn(spec, state, net, cache, buf_p, t0, t1, dv, tp=tp)
    with book.phase("broker"):
        state, buf_p = _phase_broker_dense(spec, state, cache, buf_p, t1, tp=tp)

    # the fog phases run on the replicated fog state, so their counters
    # are replicated, save the acks to this shard's users and the
    # deferral of its candidates, which are shard-partial
    m_part = state.metrics
    state, fog_side = state.replace(metrics=m_rep), True
    for _ in range(spec.completions_per_tick):
        with book.phase("completions"):
            state, buf_r = _phase_completions(spec, state, cache, buf_r, t1, tp=tp)
    stats = {} if telem_on else None
    with book.phase("fog_arrivals"):
        state, buf_r = _phase_fog_arrivals(
            spec, state, cache, buf_r, t1, tp=tp,
            exchange=functools.partial(_exchange, spec, tp, k_exchange, window_k, stats),
        )
    m_rep = state.metrics
    m_part = m_part.replace(n_deferred=m_part.n_deferred + m_rep.n_deferred)
    m_rep = m_rep.replace(n_deferred=torch.zeros_like(m_rep.n_deferred))
    buf_p = buf_p._replace(rx_u=buf_p.rx_u + buf_r.rx_u)

    # the latency histogram's deltas over this shard's task rows (its
    # exactly-once flags stay shard-local: each task has one owner)
    if hist_on:
        with _span("latency_hist"):
            hist_d, sum_d, seen = latency_hist_delta(spec, state.telem, state.tasks, t1)
        state = state.replace(telem=state.telem.replace(lat_seen=seen))
    # journeys: the slots this shard owns; only the overwrite count
    # crosses the shards, in the end-of-tick psum
    if jour_on:
        with _span("journeys"):
            telem_j, j_over = journey_tick_tp(spec, state.telem, state.tasks, t1, tp.t_off)
        state = state.replace(telem=telem_j)

    # THE end-of-tick combine: every shard-partial scalar in one psum
    nf = len(_METRIC_FIELDS)
    tot = tp.psum(torch.stack(
        [getattr(m_part, f) for f in _METRIC_FIELDS] + [buf_p.tx_b, buf_p.rx_b]
        + ([j_over] if jour_on else [])
    ))
    delta = {f: tot[i] + getattr(m_rep, f) for i, f in enumerate(_METRIC_FIELDS)}
    n_def = delta["n_deferred"]
    vals = {
        f: getattr(m_carry, f) + delta[f]
        for f in _METRIC_FIELDS
        if f not in ("n_deferred", "n_deferred_max")
    }
    vals["n_deferred"] = n_def  # per-tick gauge
    vals["n_deferred_max"] = torch.maximum(m_carry.n_deferred_max, n_def)
    tx_b = tot[nf] + buf_r.tx_b
    rx_b = tot[nf + 1] + buf_r.rx_b
    if jour_on:
        # the summed count is the same on every shard: j_dropped stays
        # replicated
        state = state.replace(telem=state.telem.replace(
            j_dropped=state.telem.j_dropped + tot[nf + 2]
        ))

    # per-node counters: the user segment shard-local, the rest replicated
    rest = torch.zeros((spec.n_aps + spec.n_routers,), dtype=_I32, device=dev)
    nodes = state.nodes.replace(
        tx_count=state.nodes.tx_count + torch.cat([buf_p.tx_u, buf_r.tx_f, tx_b[None], rest]),
        rx_count=state.nodes.rx_count + torch.cat([buf_p.rx_u, buf_r.rx_f, rx_b[None], rest]),
    )
    if spec.n_aps > 0:
        # the hoisted cache's per-AP counts are global: every shard adds
        # them into its replicated AP rows
        a0, a1 = spec.ap_slice
        nodes = nodes.replace(
            assoc_sum=torch.cat([
                nodes.assoc_sum[:a0], nodes.assoc_sum[a0:a1] + cache.n_assoc,
                nodes.assoc_sum[a1:],
            ])
        )
    state = state.replace(nodes=nodes, metrics=Metrics(**vals))
    if telem_on:
        with _span("tp_fold"):
            state = _tp_telemetry_fold(
                spec, tp, state, t1, book.vector(len(PHASES), dev), stats["exg"],
                (hist_d, sum_d) if hist_on else None,
            )
    return state.replace(t=t1, tick=state.tick + 1)


def _tp_telemetry_fold(spec, tp, state, t1, ph, exg: ExgStats, hist):
    """The end-of-tick telemetry fold (``taskshard._tp_tick`` 9a-9b): one
    int32 psum of the phase deltas (``ph``, this shard's bracket vector)
    and histogram counts, one float32 psum of the exchange gauges (shard
    ``s`` fills column ``s`` only, so the sum is a gather) and the latency
    sums; then :func:`..telemetry.metrics.accumulate_exchange` on a
    stamped world and :func:`..telemetry.metrics.accumulate_tick`."""
    dev = t1.device
    n_ph = len(PHASES)
    tp_slots = kept_tensor(
        (PHASE_INDEX["tp_exchange"], PHASE_INDEX["tp_defer"]), torch.long, dev
    )
    ph = ph.index_put((tp_slots,), torch.stack([exg.seated, exg.defer.to(_I32)]))
    ints, flts = [ph], []
    S_n = tp.n_shards
    exg_on = spec.telemetry_tp_shards > 0
    if exg_on:
        col = torch.stack([exg.occ, exg.util, exg.age, exg.cand, exg.defer])
        onehot = torch.arange(S_n, device=dev) == tp.shard
        flts.append(torch.where(onehot[None, :], col[:, None], 0.0).reshape(-1))
    if hist is not None:
        ints.append(hist[0].reshape(-1))
        flts.append(hist[1])
    int_tot = tp.psum(torch.cat(ints))
    flt_tot = tp.psum(torch.cat(flts)) if flts else None
    telem = state.telem
    if hist is not None:
        F = spec.n_fogs
        telem = telem.replace(
            lat_hist=telem.lat_hist + int_tot[n_ph:].reshape(F, spec.telemetry_hist_bins),
            lat_sum=telem.lat_sum + flt_tot[-F:],
        )
    if exg_on:
        g = flt_tot[: 5 * S_n].reshape(5, S_n)
        telem = accumulate_exchange(spec, telem, g[0], g[1], g[2], g[3], g[4], state.tick)
    with _span("telemetry"):
        telem = accumulate_tick(
            spec, telem, state.fogs, state.learn, state.metrics, state.tick, t1,
            int_tot[:n_ph],
        )
    return state.replace(telem=telem)


# ----------------------------------------------------------------------
# set-up and the runners
# ----------------------------------------------------------------------

def _tp_setup(spec, state, net, n_shards, exchange_window, pad, stamp=True):
    """Gate, pad, stamp a telemetry-on world's shard axis
    (:func:`stamp_tp_telemetry`, unless not ``stamp``) and size the
    exchange: ``(spec, state, net, k_exchange, window_k)``
    (``taskshard._tp_setup``, less placement)."""
    spec.validate()
    reason = tp_reject_reason(spec)
    if reason is not None:
        raise ValueError(f"run_tp_sharded: {reason}")
    n = int(n_shards)
    if n < 1:
        raise ValueError(f"n_shards must be >= 1, got {n}")
    if spec.n_users % n:
        if not pad:
            raise ValueError(
                f"the {n} shards must divide n_users ({spec.n_users}) — "
                "pad_users_to_multiple(spec, state, net, n) pads with inert "
                "users (pad=True does it for you)"
            )
        spec, state, net = pad_users_to_multiple(spec, state, net, n)
    cap = (spec.n_users // n) * min(spec.arrival_cands, spec.max_sends_per_user)
    if spec.window < spec.task_capacity:
        # a windowed spec: its own global K bounds the exchange
        if exchange_window is not None:
            raise ValueError(
                "exchange_window tunes the no-window exchange ring; a "
                f"windowed spec (arrival_window={spec.arrival_window}) "
                "already bounds the hop-pruned exchange to its global "
                "K-window — drop exchange_window or the arrival window"
            )
        window_k, k_ex = spec.window, cap
    else:
        window_k = None
        k_ex = cap if exchange_window is None else max(1, min(exchange_window, cap))
    if stamp:
        spec, state = stamp_tp_telemetry(spec, state, n)
    return spec, state, net, k_ex, window_k


def _shard_view(spec, state, net, cache, n: int, s: int):
    """Shard ``s``'s local spec, state, net and link cache: its rows of
    the user, task and user-node tables; a copy of everything else."""
    U_g, S = spec.n_users, spec.max_sends_per_user
    U_loc = U_g // n
    u0, t0 = s * U_loc, s * U_loc * S

    def cut(x):
        return torch.cat([x[u0: u0 + U_loc], x[U_g:]])

    def copy(x):
        return x.clone()

    st = state.replace(
        t=copy(state.t), tick=copy(state.tick), key=copy(state.key),
        nodes=tree_map(cut, state.nodes),
        users=tree_map(lambda x: x[u0: u0 + U_loc], state.users),
        tasks=tree_map(lambda x: x[t0: t0 + U_loc * S], state.tasks),
        **{
            k: tree_map(copy, getattr(state, k))
            for k in ("fogs", "broker", "metrics", "learn", "chaos", "hier", "telem")
        },
    )
    if spec.telemetry and spec.telemetry_hist:
        # the exactly-once flags of the shard's own task rows; every shard
        # holds a whole copy of the J-sized journey leaves and advances
        # only the slots it owns
        seen = state.telem.lat_seen[t0: t0 + U_loc * S].clone()
        st = st.replace(telem=st.telem.replace(lat_seen=seen))
    cache_l = cache.replace(
        assoc=cut(cache.assoc), attach_now=cut(cache.attach_now),
        acc_delay=cut(cache.acc_delay), reachable=cut(cache.reachable),
        d2b=cut(cache.d2b), mac_loss_p=cut(cache.mac_loss_p),
    )
    net_l = net.replace(
        node_attach=cut(net.node_attach), node_acc=cut(net.node_acc),
        is_wireless=cut(net.is_wireless),
    )
    return dataclasses.replace(spec, n_users=U_loc), st, net_l, cache_l


def run_tp_shards(
    spec: WorldSpec,
    state: WorldState,
    net: NetParams,
    n_shards: int = 4,
    n_ticks: Optional[int] = None,
    exchange_window: Optional[int] = None,
    pad: bool = True,
    promote: Optional[bool] = None,
    stamp: bool = True,
) -> Tuple[WorldSpec, List[WorldState]]:
    """Run the sharded horizon and return every shard's final LOCAL state
    (its rows, and its own copy of the replicated leaves), with the
    padded spec.  :func:`run_tp_sharded` joins them.  ``promote``: the
    shards run the padded spec's shape key with its knobs as one device
    operand, read by every shard."""
    spec, state, net, k_ex, window_k = _tp_setup(
        spec, state, net, n_shards, exchange_window, pad, stamp
    )
    if promote is None:
        promote = promote_default()
    if promote:
        # split after padding: the key describes the world that runs
        run_spec, dyn = split_spec(spec)
        dv = dyn_to_device(dyn, state.t.device)
    else:
        run_spec, dv = spec, dyn_of(spec)
    n = int(n_shards)
    ticks = spec.n_ticks if n_ticks is None else n_ticks
    # the run's one association, op by op as the reference builds it
    cache = associate(
        net, state.nodes.pos, state.nodes.alive, spec.broker_index, fused=False
    )
    group = ShardGroup(n, state.t.device)
    U_loc, S = spec.n_users // n, spec.max_sends_per_user

    def body(s: int) -> WorldState:
        spec_l, st, net_l, cache_l = _shard_view(run_spec, state, net, cache, n, s)
        tp = TpCtx(
            group=group, n_shards=n, shard=s, n_users_global=spec.n_users,
            u_off=s * U_loc, t_off=s * U_loc * S, d2b_full=cache.d2b,
        )
        for _ in range(ticks):
            st = _tp_tick(spec_l, tp, st, net_l, cache_l, k_ex, window_k, dv)
        if spec.derive_acks:
            st = _finalize_derived_acks(spec_l, st, cache_l)
        return st

    return spec, group.run(body)


def run_tp_sharded(
    spec: WorldSpec,
    state: WorldState,
    net: NetParams,
    bounds: Optional[MobilityBounds] = None,
    n_shards: int = 4,
    n_ticks: Optional[int] = None,
    exchange_window: Optional[int] = None,
    pad: bool = True,
    promote: Optional[bool] = None,
    stamp: bool = True,
) -> Tuple[WorldSpec, WorldState]:
    """Advance ONE world whose user and task rows span ``n_shards``
    shards, on the state's device (``taskshard.run_tp_sharded``).

    Requires a TP-admissible spec (a ``ValueError`` naming its ``[TP-*]``
    clause otherwise).  Returns ``(spec, final)``: the spec describes the
    returned state (``pad=True`` pads a non-divisible population with
    inert users), and ``final`` is the joined global state, the
    replicated leaves from shard 0.  ``exchange_window`` bounds the
    per-shard candidates exchanged a tick (default: all of them, never
    deferring); a windowed spec runs the distributed K-window instead and
    takes no ``exchange_window``.  ``bounds`` is unused: the TP family is
    static.  ``promote`` (default :func:`..dynspec.promote_default`):
    the knobs ride a device operand; ``promote=False`` folds the spec's
    values as host constants.  ``stamp=False`` leaves a telemetry-on spec
    unstamped: the caller's spec describes the returned state (no
    per-shard exchange leaves; the phase brackets and the histogram still
    book).
    """
    del bounds
    spec, finals = run_tp_shards(
        spec, state, net, n_shards, n_ticks, exchange_window, pad, promote, stamp
    )
    U_loc = spec.n_users // int(n_shards)

    def cat_rows(*xs):
        return torch.cat(xs)

    def cat_nodes(*xs):
        return torch.cat([x[:U_loc] for x in xs] + [xs[0][U_loc:]])

    f0 = finals[0]
    final = f0.replace(
        nodes=tree_map(cat_nodes, *[f.nodes for f in finals]),
        users=tree_map(cat_rows, *[f.users for f in finals]),
        tasks=tree_map(cat_rows, *[f.tasks for f in finals]),
        telem=_join_telem(spec, [f.telem for f in finals]),
    )
    return spec, final


def _join_telem(spec: WorldSpec, telems: list):
    """The shards' telemetry joined: shard 0's replicated leaves, the
    shards' ``lat_seen`` blocks end to end and each journey slot's leaves
    from the shard that owns its task row (the others never advanced it)."""
    t = telems[0]
    if spec.telemetry and spec.telemetry_hist:
        t = t.replace(lat_seen=torch.cat([x.lat_seen for x in telems]))
    if spec.journey_active:
        J = t.j_task.shape[0]
        owner = (t.j_task // (spec.task_capacity // len(telems))).long()
        slot = torch.arange(J, device=owner.device)

        def by_owner(name):
            return torch.stack([getattr(x, name) for x in telems])[owner, slot]

        t = t.replace(**{k: by_owner(k) for k in ("j_prev", "j_ring", "j_cursor")})
    return t


def run_tp_chunked(
    spec: WorldSpec,
    state: WorldState,
    net: NetParams,
    bounds: Optional[MobilityBounds] = None,
    n_shards: int = 4,
    chunk_ticks: int = 1000,
    callback: Optional[Callable[[WorldState, int], None]] = None,
    n_ticks: Optional[int] = None,
    exchange_window: Optional[int] = None,
    promote: Optional[bool] = None,
    reconfigure: Optional[Callable[[int], Optional[dict]]] = None,
) -> Tuple[WorldSpec, WorldState]:
    """The sharded horizon in chunks of ``chunk_ticks``, with
    ``callback(state, ticks_done)`` between them
    (``taskshard.run_tp_chunked``); equal to one :func:`run_tp_sharded`
    call.  The population is padded once, before the first chunk.

    With ``promote`` (the default), ``reconfigure(ticks_done)``, called
    at every interior chunk boundary after ``callback``, may return
    ``{field: value}`` of promoted knobs for the rest of the horizon; they
    land in the returned spec (:func:`..dynspec.apply_knobs` refuses a
    shape-defining field or a gate flip).
    """
    if promote is None:
        promote = promote_default()
    if reconfigure is not None and not promote:
        raise ValueError(
            "reconfigure re-configures the DynSpec operand between "
            "chunks; it needs the promoted path (promote=True)"
        )
    spec, state, net = pad_users_to_multiple(spec, state, net, int(n_shards))
    total = spec.n_ticks if n_ticks is None else n_ticks
    chunk = max(1, min(chunk_ticks, total))
    done = 0
    while done < total:
        ticks = min(chunk, total - done)
        spec, state = run_tp_sharded(
            spec, state, net, bounds, n_shards=n_shards, n_ticks=ticks,
            exchange_window=exchange_window, promote=promote,
        )
        done += ticks
        if callback is not None:
            callback(state, done)
        if reconfigure is not None and done < total:
            knobs = reconfigure(done)
            if knobs:
                spec = apply_knobs(spec, knobs)
    return spec, state


def unstamp_tp_carry(spec: WorldSpec, state: WorldState) -> Tuple[WorldSpec, WorldState]:
    """A TP chunk-boundary carry re-described by the unsharded spec
    (``tp_shards`` 0), the fork point of the TP what-if
    (``taskshard.unstamp_tp_carry``).  The joined carry already lies on
    one device; padded users stay, inert.  A telemetry-on carry's
    per-shard exchange leaves go back to the unsharded (zero-row) shape:
    they describe the sharded run, not the forked world."""
    if spec.tp_shards:
        spec = dataclasses.replace(spec, tp_shards=0).validate()
        if spec.telemetry:
            state = state.replace(telem=state.telem.replace(
                **init_exchange_leaves(spec, state.t.device)
            ))
    return spec, state


# ----------------------------------------------------------------------
# the node-sharded entry (``taskshard.run_node_sharded``)
# ----------------------------------------------------------------------

#: The mesh axis of a node-sharded world.
NODE_AXIS = "node"


def shard_state_by_node(
    spec: WorldSpec, state: WorldState, mesh: Mesh, axis_name: str = NODE_AXIS,
) -> WorldState:
    """The world on the mesh's device, once the mesh axis is known to
    divide its user and task rows (``ValueError`` otherwise, in JAX's
    words).  JAX splits those rows over the devices and replicates the
    rest; here every slot is on one device, so the state moves whole."""
    n = mesh.shape[axis_name]
    if spec.n_users % n or spec.task_capacity % n:
        raise ValueError(
            f"the {n}-device mesh axis must divide n_users "
            f"({spec.n_users}) and task capacity ({spec.task_capacity}) — "
            "pad_users_to_multiple(spec, state, net, n) pads with inert "
            "users"
        )
    return on_device(state, mesh.device)


def run_node_sharded(
    spec: WorldSpec,
    state: WorldState,
    net: NetParams,
    bounds: Optional[MobilityBounds],
    mesh: Mesh,
    n_ticks: Optional[int] = None,
    axis_name: str = NODE_AXIS,
) -> WorldState:
    """Advance a world over the mesh's axis on the mesh's device (the
    state, ``net`` and ``bounds`` move there); returns the final state.

    A TP-admissible spec (:func:`..core.engine.tp_ok`) runs the task-sharded
    tick at ``mesh.size`` shards, unpadded and unstamped, so ``spec`` keeps
    describing the result; any other spec, once the axis divides its rows
    (:func:`shard_state_by_node`), runs the engine unmodified, as JAX's
    GSPMD fallback does: one jitted ``run``, whose static link cache is
    built fused.  Both equal the single-device engine.
    """
    tp, n = tp_ok(spec), mesh.shape[axis_name]
    if tp and spec.n_users % n:
        raise ValueError(
            f"the {n}-device mesh axis must divide n_users "
            f"({spec.n_users}) — pad_users_to_multiple(spec, state, "
            "net, n) pads with inert users (pad=True does it for you)"
        )
    state = on_device(state, mesh.device) if tp else shard_state_by_node(
        spec, state, mesh, axis_name)
    net, bounds = on_device(net, mesh.device), on_device(bounds, mesh.device)
    if tp:
        return run_tp_sharded(
            spec, state, net, bounds, n_shards=n, n_ticks=n_ticks, pad=False, stamp=False,
        )[1]
    return _run(spec, state, net, bounds, n_ticks, None, fused_cache=True)[0]
