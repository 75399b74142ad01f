"""The tick engine: one call of ``step`` advances the whole world one tick.

Counterpart of ``fognetsimpp_tpu/core/engine.py`` for the per-phase
(unfused) tick: mobility and association (every tick unless the world is
static) -> chaos (the RTT factor on the broker->fog delays, the fog
lifecycle and the sweep of crashed fogs' tasks) -> connect -> adverts ->
spawn (``_phase_spawn`` at one send per tick, ``_phase_spawn_multi``
above, both with the 802.11 uplink loss) -> broker-to-broker migration
(federated worlds) -> broker (dense for the task-independent policies,
``broker_dense_ok``; compacted for the rest; a winner or a candidate set
a broker domain when federated) -> ``completions_per_tick`` completion
passes -> fog arrivals (two-stage candidate front, K-window compaction,
shared tail) -> the bandit learners' reward credit (learned policies
only) -> the latency histogram -> per-node message counters -> energy and
lifecycle -> the journey tap -> the telemetry fold (each telemetry phase
with its plane on only; with ``spec.telemetry`` a bracket after every
phase books its work, ``_PhaseBook``).  While a profiler records, each
phase runs under ``record_function("phase_<name>")``.  The JAX package's
fused slot-window front-end is bit-identical to this tick
(``tests/test_fused.py``) and is not ported.  :func:`run` replaces the
``lax.scan`` with a Python loop and hoists the static link cache out of
it, as the JAX ``run`` does; :func:`run_chunked` and :func:`run_jit` are
its chunked and whole-run entry points, which by default take the
promoted knobs as a device operand (:mod:`..dynspec`).

Every leaf is held bit-exact against the JAX engine.  Three habits keep
it so: Python float constants are rounded to float32 before they meet
a float32 tensor (:func:`~fognetsimpp_tpu_torch.f32math.const`); a
``a * b + c`` that XLA fuses into one multiply-add uses
:func:`~fognetsimpp_tpu_torch.f32math.fma`; scatters with JAX's
``mode="drop"`` go through :mod:`..ops.scatter`.  Integer sums ask for
int32 explicitly (torch would widen them to int64).

Every spec field is ported.  The carry contracts (:mod:`.contracts`)
hold every phase and the whole tick to the state's shapes and dtypes,
and :func:`run_checkified` runs :func:`run` under the runtime sanitizer
(:mod:`.sanitizer`), a debug run that stops at the first integer
division by zero, NaN or out-of-range index.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..dynspec import (
    DynSpec, apply_knobs, div_knob, dyn_of, dyn_to_device, int_knob, knob,
    promote_default, split_spec,
)
from ..chaos.faults import rtt_factor, step_lifecycle
from ..envelope import broker_dense_ok
from ..f32math import const, fma, kept_tensor, xla_sum
from ..hier.federation import hier_reject_reason
from ..learn.bandits import arms_view, exp3_probs
from ..learn.rewards import credit_batch, penalize_counts
from ..net.energy import step_energy
from ..net.mobility import MobilityBounds, default_bounds, step_mobility
from ..net.topology import LinkCache, NetParams, associate
from ..ops.pool_kernels import local_pool_scan
from ..ops.queues import NO_TASK, batched_enqueue, batched_pop, plan_arrivals
from ..ops.scatter import add_drop, set_drop
from ..ops.sched import at, scalar_winner, schedule_batch, task_uniform
from ..random import PRNGKey, randint, split, uniform
from ..spec import (
    STATIC_MAC_ERR, ChaosMode, FogModel, HierPolicy, Policy, Stage, WorldSpec,
)
from ..state import WorldState
from ..telemetry.health import accumulate_latency
from ..telemetry.journeys import journey_tick
from ..telemetry.metrics import (
    PHASE_INDEX, accumulate_tick, reservoir_progress, tick_activity,
)

_ST_UNUSED = int(Stage.UNUSED)
_ST_PUB_INFLIGHT = int(Stage.PUB_INFLIGHT)
_ST_TASK_INFLIGHT = int(Stage.TASK_INFLIGHT)
_ST_QUEUED = int(Stage.QUEUED)
_ST_RUNNING = int(Stage.RUNNING)
_ST_DONE = int(Stage.DONE)
_ST_NO_RESOURCE = int(Stage.NO_RESOURCE)
_ST_DROPPED = int(Stage.DROPPED)
_ST_REJECTED = int(Stage.REJECTED)
_ST_LOST = int(Stage.LOST)
_ST_LOCAL_RUN = int(Stage.LOCAL_RUN)
_ST_HOP_EXHAUSTED = int(Stage.HOP_EXHAUSTED)

_I32 = torch.int32
_F32 = torch.float32
_INF = float("inf")
_M32 = 0xFFFFFFFF


class TpCtx(NamedTuple):
    """Shard context threaded through the TP-aware phases (``TpCtx``).

    Built by :mod:`..parallel.taskshard` for each shard's body; ``None``
    everywhere else.  The per-user and per-task phases run on the shard's
    LOCAL world view (a spec with ``n_users = U / n_shards`` and its rows
    of the user and task tables); this context carries what that view
    cannot: the shard group that runs the collectives (in place of JAX's
    mesh axis name), the global population (per-user draws keep the
    reference's full width), the shard's row offsets and the full
    broker-delay vector for gathers at global ids.
    """

    group: Any  # parallel.shards.ShardGroup
    n_shards: int
    shard: int  # this shard's index
    n_users_global: int  # U of the unsharded world
    u_off: int  # first global user this shard owns
    t_off: int  # first global task row this shard owns
    d2b_full: torch.Tensor  # (N_global,) f32 delay to the broker

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the shards (``lax.psum``)."""
        return self.group.psum(self.shard, x)


def _tp_user_draw(tp: Optional[TpCtx], draw, n_local: int, *trailing):
    """A per-user draw at the reference width, cut to the shard's users.

    A shard-local draw of shape ``(U_loc, ...)`` would use other counters
    than the reference's ``(U, ...)`` draw, so every shard draws the full
    width and keeps its own rows: the local lanes are the reference lanes.
    """
    if tp is None:
        return draw((n_local,) + tuple(trailing))
    full = draw((tp.n_users_global,) + tuple(trailing))
    return full[tp.u_off: tp.u_off + n_local]


def _task_id_end(spec: WorldSpec, tp: Optional[TpCtx]) -> int:
    """One past the last task id the fog phases see, and their invalid id:
    the table's capacity, or under ``tp`` the global world's."""
    if tp is None:
        return spec.task_capacity
    return tp.n_users_global * spec.max_sends_per_user


def _own_rows(idx: torch.Tensor, tp: Optional[TpCtx]) -> torch.Tensor:
    """Task ids -> rows of this task table to scatter at.  The invalid id,
    and under ``tp`` another shard's ids, fall outside the table, where
    the drop-mode scatters discard them (never clamped)."""
    return idx if tp is None else idx - tp.t_off


def _user_rows(user: torch.Tensor, tp: Optional[TpCtx]) -> torch.Tensor:
    """User ids -> rows of this user table; another shard's users fall
    outside it, where the drop-mode adds discard them."""
    return user if tp is None else user - tp.u_off


def _task_gather(spec: WorldSpec, tp: Optional[TpCtx], cols: list, idx: torch.Tensor):
    """The task columns ``cols`` at ids ``idx``, stacked ``(len(cols),
    len(idx))``; an invalid id gives any value, which callers mask.  Under
    ``tp`` the shard that owns an id gives its value and every other shard
    0, and one ``psum`` is the gather (x + 0 is exact)."""
    T = spec.task_capacity
    if tp is None:
        ic = idx.clamp(0, T - 1).long()
        return torch.stack([c[ic] for c in cols])
    loc = idx - tp.t_off
    owned = (loc >= 0) & (loc < T)
    locc = loc.clamp(0, T - 1).long()
    return tp.psum(torch.stack([torch.where(owned, c[locc], 0.0) for c in cols]))


def _user_delays(cache: LinkCache, tp: Optional[TpCtx]) -> torch.Tensor:
    """Delay to the broker, indexed by (global) user id."""
    return cache.d2b if tp is None else tp.d2b_full


def tp_reject_reason(spec: WorldSpec) -> Optional[str]:
    """Why ``spec`` cannot run on the task-sharded tick (None = it can),
    with the JAX gate's ``[TP-*]`` IDs in its order of clauses."""
    if spec.n_fogs <= 0:
        return "[TP-NOFOGS] TP tick needs fog nodes (n_fogs >= 1)"
    if spec.chaos:
        return (
            "[TP-CHAOS] TP tick does not carry the chaos fault-injection "
            "subsystem yet (run chaos worlds on single-device run/run_jit/"
            "run_chunked)"
        )
    if spec.hier_active:
        return hier_reject_reason(spec, "TP")
    if spec.fog_model != int(FogModel.FIFO):
        return (
            "[TP-POOL] TP tick covers FIFO fogs only (POOL pools are "
            "sequential)"
        )
    if not broker_dense_ok(spec):
        return (
            "[TP-POLICY] TP tick covers the dense-broker policy family "
            "(MIN_BUSY/MIN_LATENCY/ENERGY_AWARE with bug_compat."
            "mips0_divisor, or MAX_MIPS); sequential-pool and learned "
            "policies keep the single-device / GSPMD paths"
        )
    if not spec.two_stage_arrivals:
        return "[TP-ARRIVALS] TP tick needs the two-stage arrival front-end"
    if not spec.assume_static:
        return (
            "[TP-DYNTOPO] TP tick hoists one association/delay cache for "
            "the whole run: needs assume_static"
        )
    if spec.energy_enabled:
        return (
            "[TP-ENERGY] TP tick does not carry the energy/lifecycle "
            "model yet"
        )
    if spec.wired_queue_enabled:
        return "[TP-WIRED] TP tick does not carry DropTail backpressure yet"
    if spec.learn_active:
        return "[TP-LEARN] TP tick does not carry bandit learner state yet"
    if spec.record_tick_series:
        return (
            "[TP-SERIES] TP tick records no per-tick series (record via "
            "summary)"
        )
    return None


def tp_ok(spec: WorldSpec) -> bool:
    """Static gate for the task-sharded tick (see tp_reject_reason)."""
    return tp_reject_reason(spec) is None


class TickBuf(NamedTuple):
    """Per-tick message counts by node role ([users | fogs | broker])."""

    tx_u: torch.Tensor  # (U,) i32
    rx_u: torch.Tensor  # (U,) i32
    tx_f: torch.Tensor  # (F,) i32
    rx_f: torch.Tensor  # (F,) i32
    tx_b: torch.Tensor  # () i32
    rx_b: torch.Tensor  # () i32


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------

def _i8(v: int, dev) -> torch.Tensor:
    return torch.full((), v, dtype=torch.int8, device=dev)


def _isum(x: torch.Tensor, dim=None) -> torch.Tensor:
    """int32 sum (JAX's ``jnp.sum(..., dtype=int32)``)."""
    x = x.to(_I32) if x.dtype == torch.bool else x
    if dim is None:
        return x.sum(dtype=_I32)
    return x.sum(dim=dim, dtype=_I32)


def _mips_sum64(member: torch.Tensor, mips: torch.Tensor) -> torch.Tensor:
    """(F,) float64 sums of ``mips`` over each row of ``member`` (F, K).

    Taken in float64, so a sum of integer MIPS is exact below 2^53 and
    the same on every device and in any order.  A float32 sum of one
    tick's MIPS to one fog passes 2^24 at full width (the dense broker
    sends a tick's tasks to one winner), and then its bits follow the
    order of the adds.  Rounded once to float32 it is JAX's float32 sum
    wherever that sum is exact; past 2^24 the two part, by design, and
    ``fogs.busy_time`` with the broker's copies of it (``adv_val_busy``,
    ``view_busy``) depart from JAX by float32 rounding.
    """
    return torch.where(member, mips.double()[None, :], 0.0).sum(dim=1)


def _per_fog(mask: torch.Tensor, fog: torch.Tensor, n_fogs: int) -> torch.Tensor:
    """(F, K) membership: row f marks masked rows bound for fog f."""
    fid = torch.arange(n_fogs, dtype=_I32, device=fog.device)
    return (fog[None, :] == fid[:, None]) & mask[None, :]


def _candidates(spec: WorldSpec, b, fog_alive: torch.Tensor) -> torch.Tensor:
    """The fogs a broker may pick: the registered ones, and under chaos
    only those up (the reference never evicts a dead fog, so a world
    without chaos keeps its view as it is)."""
    return b.registered & fog_alive if spec.chaos else b.registered


def _owned(spec: WorldSpec, hier) -> torch.Tensor:
    """(B, F) bool: row b marks the fogs broker b owns."""
    bid = torch.arange(spec.n_brokers, dtype=_I32, device=hier.fog_broker.device)
    return hier.fog_broker[None, :] == bid[:, None]


def _task_brokers(spec: WorldSpec, task_broker: torch.Tensor) -> torch.Tensor:
    """Owning brokers clamped into [0, B), as gather indices."""
    return torch.clamp(task_broker, 0, spec.n_brokers - 1).long()


def _svc_time(mips_req: torch.Tensor, fog_mips: torch.Tensor) -> torch.Tensor:
    """Service time requiredMIPS / MIPS (ComputeBrokerApp3.cc:276)."""
    return mips_req / torch.clamp_min(fog_mips, const(1e-9, fog_mips.device))


def _compact_lane_width(T: int) -> int:
    """Power-of-two in-block lane width minimising B + C (B = T/C)."""
    return min((128, 256, 512, 1024), key=lambda c: -(-T // c) + c)


def _compact(
    mask: torch.Tensor, K: int, T: int, rot: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Indices of up to K set bits of ``mask`` (length T): ``(idx,
    idx_clipped, valid)``, ``idx`` padded with T.

    A two-level prefix sum and first-True argmax, with the scan origin
    rotated by ``rot`` (block order starts at ``rot % B``, each block's
    scan at a decorrelated column), exactly as the JAX ``_compact``.
    """
    dev = mask.device
    C = _compact_lane_width(T)
    B = -(-T // C)
    # out of place, so that a replica batch (vmap) can pass through
    m2 = torch.cat([mask.to(_I32), torch.zeros((B * C - T,), dtype=_I32, device=dev)])
    wcs = torch.cumsum(m2.reshape(B, C), dim=1).to(_I32)
    bsum = wcs[:, -1]
    k = torch.arange(K, dtype=_I32, device=dev)
    if rot is not None:
        rot_b = (rot % B).to(_I32)
        c0 = (((rot.long() * 7919) & _M32) % C).to(_I32)
        bsum_sel = bsum[(torch.arange(B, device=dev) + rot_b) % B]
    else:
        rot_b = None
        bsum_sel = bsum
    bcs = torch.cumsum(bsum_sel, dim=0).to(_I32)
    blk = torch.argmax(
        (bcs[None, :] >= (k + 1)[:, None]).to(torch.uint8), dim=1
    ).to(_I32)
    base = bcs[blk.long()] - bsum_sel[blk.long()]
    rank = k + 1 - base
    if rot_b is not None:
        blk = (blk + rot_b) % B
    rows = wcs[blk.long()]  # (K, C)
    if rot_b is None:
        inb = torch.argmax(
            (rows >= rank[:, None]).to(torch.uint8), dim=1
        ).to(_I32)
    else:
        cols = torch.arange(C, dtype=_I32, device=dev)[None, :]
        prev = rows.index_select(1, torch.clamp_min(c0 - 1, 0).long().reshape(1))
        off = torch.where(c0 > 0, prev, torch.zeros_like(prev))
        tail = cols >= c0
        prefix_rot = torch.where(tail, rows - off, rows + (rows[:, -1:] - off))
        pos_rot = torch.where(tail, cols - c0, cols + (C - c0))
        ok = prefix_rot >= rank[:, None]
        inb_pos = torch.where(ok, pos_rot, C).amin(dim=1)
        inb = ((inb_pos + c0) % C).to(_I32)
    idx = blk * C + inb
    valid = k < bcs[-1]
    idx = torch.where(valid, torch.clamp_max(idx, T - 1), T).to(_I32)
    return idx, torch.clamp_max(idx, T - 1), valid


def _rot_and_defer(
    spec: WorldSpec, state: WorldState, mask: torch.Tensor, K: int
) -> Tuple[Optional[torch.Tensor], WorldState]:
    """Tick-keyed compaction origin plus the deferred-backlog gauge."""
    T = spec.task_capacity
    if K >= T:
        return None, state
    rot = (((state.tick.long() * 2654435761) & _M32) % T).to(_I32)
    deferred = torch.clamp_min(_isum(mask) - K, 0)
    state = state.replace(
        metrics=state.metrics.replace(
            n_deferred=state.metrics.n_deferred + deferred
        )
    )
    return rot, state


def offered_rate_vector(
    spec: WorldSpec, alive_u: torch.Tensor, users, t0: torch.Tensor, dv: DynSpec,
) -> torch.Tensor:
    """(N,) f32 offered frame rate a node for the Bianchi keying: a user's
    publish rate while it is publishing, 0 otherwise."""
    publishing = (
        alive_u
        & users.connected
        & users.publisher
        & (users.send_count < spec.max_sends_per_user)
        & torch.isfinite(users.next_send)
    )
    if spec.send_stop_time != _INF:
        publishing = publishing & (t0 < knob(dv.send_stop_time, t0.device))
    # an IEEE division (torch's ``1.0 / x`` is a reciprocal times 1.0)
    rate = torch.where(
        publishing, torch.ones_like(users.send_interval) / users.send_interval, 0.0
    )
    rest = torch.zeros((spec.n_nodes - spec.n_users,), dtype=_F32, device=t0.device)
    return torch.cat([rate, rest])


def _uplink_loss_p(spec, net: NetParams, cache: LinkCache, dv: DynSpec, U: int, dev):
    """(U,) f32 loss probability of a publish, or None when nothing can be
    lost: the fitted residual ``uplink_loss_prob`` combined with the
    sender's 802.11 retry-exhaustion loss, ``1 - (1 - p)(1 - mac)`` (one
    fused multiply-add, as XLA compiles it)."""
    has_mac = net.mac_loss_tab.shape[0] > 0
    if not (spec.uplink_loss_prob > 0 or has_mac):
        return None
    p_eff = knob(dv.uplink_loss_prob, dev).expand(U)
    if has_mac:
        one = const(1.0, dev).expand(U)
        p_eff = fma(-(1.0 - p_eff), 1.0 - cache.mac_loss_p[:U], one)
    return p_eff


def _link_warmup(spec, dv: DynSpec, k_f, k_i, t_create, t_arrive):
    """The link warm-up of the v1/v2 example world (``link_up_s``): a
    publish that would arrive before the link is up arrives at its drain
    slot instead, ``link_up_s`` plus ``k * link_drain_s`` for send index
    ``k``, or, past the first ``link_burst_n`` sends, the burst's end plus
    ``(k - nb) * link_drain2_s`` (one fused multiply-add, as XLA compiles
    it).  With ``link_buffer_frames`` the creations before link-up are
    buffered up to that send index and the rest overflow.  Returns
    ``(t_arrive, buffered, warm_lost)``, the last two None without the
    buffer."""
    dev = t_create.device
    up = knob(dv.link_up_s, dev)
    drain = knob(dv.link_drain_s, dev)
    if spec.link_burst_n > 0:
        nb = float(spec.link_burst_n - 1)
        k_b, d2 = torch.broadcast_tensors(k_f - nb, knob(dv.link_drain2_s, dev))
        pos = torch.where(
            k_f <= nb, k_f * drain,
            fma(k_b, d2, knob(dv.link_burst_base, dev).expand_as(k_b)),
        )
        drained = up + pos
    else:
        drained = fma(k_f, drain.expand_as(k_f), up.expand_as(k_f))
    if spec.link_buffer_frames > 0:
        pre = t_create < up
        buffered = pre & (k_i < spec.link_buffer_frames)
        return torch.where(buffered, drained, t_arrive), buffered, pre & ~buffered
    return torch.where(t_arrive < up, drained, t_arrive), None, None


def _droptail_p(spec, drop_p: torch.Tensor, U: int) -> torch.Tensor:
    """(U,) tail-drop probability of a publish: its user's egress queue or
    the broker's, ``1 - (1 - p_u)(1 - p_b)`` (one fused multiply-add)."""
    p_u = drop_p[:U]
    p_b = drop_p[spec.broker_index].expand(U)
    one = const(1.0, drop_p.device).expand(U)
    return fma(-(1.0 - p_u), 1.0 - p_b, one)


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

def _phase_connect(spec, state, cache, buf, t0, t1):
    """MQTT connect handshake: fog registrations mature, users' Connect
    round-trips are stamped, arrived Connacks connect and publish."""
    users, b = state.users, state.broker
    U = spec.n_users
    b = b.replace(registered=b.register_t <= t1)
    pending = (
        state.nodes.alive[:U]
        & ~users.connected
        & torch.isinf(users.connack_at)
        & (users.start_t < t1)
    )
    d_ub = cache.d2b[:U]
    t_send = torch.maximum(users.start_t, t0)
    connack_at = torch.where(pending, t_send + 2.0 * d_ub, users.connack_at)
    acked = ~users.connected & (connack_at <= t1)
    n_subs = _isum(users.sub_mask, 1)
    users = users.replace(
        connected=users.connected | acked,
        connack_at=connack_at,
        next_send=torch.where(acked, connack_at, users.next_send),
    )
    acked_subs = torch.where(acked, n_subs, 0)
    up_msgs = pending.to(_I32) + acked_subs
    down_msgs = acked.to(_I32) * (1 + n_subs)
    sums = _isum(
        torch.stack([down_msgs, up_msgs, acked.to(_I32), acked_subs]), 1
    )
    buf = buf._replace(
        tx_u=buf.tx_u + up_msgs,
        rx_u=buf.rx_u + down_msgs,
        tx_b=buf.tx_b + sums[0],
        rx_b=buf.rx_b + sums[1],
    )
    metrics = state.metrics.replace(
        n_connected=state.metrics.n_connected + sums[2],
        n_subscribed=state.metrics.n_subscribed + sums[3],
    )
    return state.replace(users=users, broker=b, metrics=metrics), buf


def _phase_adverts(state, t1):
    """Deliver in-flight MIPS advertisements (latest wins)."""
    b = state.broker
    arrived = b.adv_arrive_t <= t1
    broker = b.replace(
        view_mips=torch.where(arrived, b.adv_val_mips, b.view_mips),
        view_busy=torch.where(arrived, b.adv_val_busy, b.view_busy),
        adv_arrive_t=torch.where(arrived, _INF, b.adv_arrive_t),
    )
    metrics = state.metrics.replace(
        n_adverts=state.metrics.n_adverts + _isum(arrived)
    )
    return state.replace(broker=broker, metrics=metrics)


def _phase_spawn(spec, state, net, cache, buf, t0, t1, dv: DynSpec, tp=None):
    """Users whose send timer fired publish one task into slot
    ``u * S + send_count[u]``, as elementwise selects over the (U, S)
    view of the task table.  A wireless sender's publish is lost on the
    uplink with the probability of :func:`_uplink_loss_p` (``LOST``,
    never reaching the broker).  Under ``tp`` the draws are the global
    width's, cut to the shard's users."""
    U, T, S = spec.n_users, spec.task_capacity, spec.max_sends_per_user
    users, tasks = state.users, state.tasks
    dev = t1.device
    due = (
        state.nodes.alive[:U]
        & users.connected
        & users.publisher
        & (users.next_send < t1)
        & (users.send_count < S)
    )
    t_create = torch.maximum(users.next_send, t0)
    if spec.send_stop_time != _INF:
        due = due & (t_create < knob(dv.send_stop_time, dev))
    keys = split(state.key, 5 if spec.wired_queue_enabled else 4)
    key, k_mips, k_jit, k_loss = keys[0], keys[1], keys[2], keys[3]
    if spec.fixed_mips_required is not None:
        mips_req = torch.full((U,), float(spec.fixed_mips_required), dtype=_F32, device=dev)
    else:
        mips_req = _tp_user_draw(
            tp,
            lambda s: randint(
                k_mips, s, spec.mips_required_min, spec.mips_required_max + 1
            ),
            U,
        ).to(_F32)
    d_ub = cache.d2b[:U]
    t_arrive = t_create + d_ub
    buffered = warm_lost = None
    if spec.link_up_s > 0:
        t_arrive, buffered, warm_lost = _link_warmup(
            spec, dv, users.send_count.to(_F32), users.send_count, t_create,
            t_arrive,
        )
    p_loss = _uplink_loss_p(spec, net, cache, dv, U, dev)
    if p_loss is None:
        lost = torch.zeros((U,), dtype=torch.bool, device=dev)
    else:
        lost = (
            _tp_user_draw(tp, lambda s: uniform(k_loss, s), U) < p_loss
        ) & net.is_wireless[:U]
        if buffered is not None:
            # frames the pending queue kept deliver reliably at their slot
            lost = lost & ~buffered
        elif spec.link_up_s > 0:
            lost = lost & (t_create + d_ub >= knob(dv.link_up_s, dev))
    if spec.wired_queue_enabled:
        # DropTail: a publish entering a full egress queue (its own or the
        # broker's) is tail-dropped with last tick's overflow fraction
        p_tail = _droptail_p(spec, state.nodes.link_drop_p, U)
        lost = lost | (
            _tp_user_draw(tp, lambda s: uniform(keys[4], s), U) < p_tail
        )
    if warm_lost is not None:
        lost = lost | (warm_lost & net.is_wireless[:U])
    sel = due[:, None] & (
        torch.arange(S, dtype=_I32, device=dev)[None, :]
        == users.send_count[:, None]
    )

    def put(col, val_u):
        return torch.where(sel, val_u[:, None], col.reshape(U, S)).reshape(T)

    tasks = tasks.replace(
        stage=put(tasks.stage, torch.where(lost, _i8(_ST_LOST, dev), _i8(_ST_PUB_INFLIGHT, dev))),
        mips_req=put(tasks.mips_req, mips_req),
        t_create=put(tasks.t_create, t_create),
        t_at_broker=put(tasks.t_at_broker, torch.where(lost, _INF, t_arrive)),
    )
    if spec.send_interval_jitter > 0:
        jit = _tp_user_draw(
            tp,
            lambda s: uniform(
                k_jit, s, 1.0 - spec.send_interval_jitter,
                1.0 + spec.send_interval_jitter,
            ),
            U,
        )
        # XLA fuses interval * jitter + t_create into one multiply-add
        nxt = fma(users.send_interval, jit, t_create)
    else:
        nxt = t_create + users.send_interval
    users = users.replace(
        next_send=torch.where(due, nxt, users.next_send),
        send_count=torch.where(due, users.send_count + 1, users.send_count),
    )
    sums = _isum(torch.stack([due, due & lost]), 1)
    metrics = state.metrics.replace(
        n_published=state.metrics.n_published + sums[0],
        n_lost=state.metrics.n_lost + sums[1],
    )
    buf = buf._replace(tx_u=buf.tx_u + due.to(_I32))
    return state.replace(users=users, tasks=tasks, metrics=metrics, key=key), buf


def _phase_inject(spec, state, cache, batch=None):
    """Chunk-boundary arrival injection, the twin's input phase
    (``engine._phase_inject``).

    ``batch`` maps ``user`` (i32 ``(spec.ingest_batch,)``, -1 a padding
    row) and ``mips`` (f32, each request's MIPSRequired).  Row j for user
    u claims slot ``u * S + send_count[u] + rank``, ``rank`` the count of
    earlier rows for u (the (B, B) lower triangle), so a batch may carry
    several requests a user.  The publish is stamped at ``state.t`` and
    reaches the broker at ``state.t + d2b[u]``.  Draw-free: no key is
    split, no loss drawn, so a recorded arrival log replays bit for bit.
    Rows for a dead or disconnected user, or past its ``S`` send slots,
    are rejected and write nothing (the drop-mode scatter of slot ``T``).
    Returns ``(state, n_injected, n_rejected)``, the counts int32 tensors.
    JAX's phase also books the publishes into a ``TickBuf`` for its
    contract trace, which its host entry discards; the port keeps none.
    """
    U, T, S = spec.n_users, spec.task_capacity, spec.max_sends_per_user
    B = spec.ingest_batch
    users, tasks = state.users, state.tasks
    dev = state.t.device
    alive_u = state.nodes.alive[:U]
    if batch is None:  # an all-padding batch
        uid = torch.full((B,), -1, dtype=_I32, device=dev)
        mips = torch.zeros((B,), dtype=_F32, device=dev)
    else:
        uid = batch["user"].to(_I32)
        mips = batch["mips"].to(_F32)
    ok0 = (uid >= 0) & (uid < U)
    ui = torch.clamp(uid, 0, max(U - 1, 0)).long()
    same = (uid[:, None] == uid[None, :]) & ok0[:, None] & ok0[None, :]
    rank = _isum(torch.tril(same, diagonal=-1), 1)
    slot_k = users.send_count[ui] + rank
    ok = ok0 & alive_u[ui] & users.connected[ui] & (slot_k < S)
    t_now = state.t
    t_arrive = t_now + cache.d2b[:U][ui]
    slot = torch.where(ok, ui.to(_I32) * S + torch.clamp(slot_k, 0, S - 1),
                       torch.full_like(slot_k, T))
    tasks = tasks.replace(
        stage=set_drop(tasks.stage, slot, torch.full((B,), _ST_PUB_INFLIGHT,
                                                     dtype=torch.int8, device=dev)),
        mips_req=set_drop(tasks.mips_req, slot, mips),
        t_create=set_drop(tasks.t_create, slot, t_now.expand(B)),
        t_at_broker=set_drop(tasks.t_at_broker, slot, t_arrive),
    )
    usafe = torch.where(ok, ui.to(_I32), torch.full_like(uid, U))
    ones = torch.ones((B,), dtype=_I32, device=dev)
    users = users.replace(send_count=add_drop(users.send_count, usafe, ones))
    n_inj = _isum(ok)
    metrics = state.metrics.replace(n_published=state.metrics.n_published + n_inj)
    state = state.replace(users=users, tasks=tasks, metrics=metrics)
    return state, n_inj, _isum(ok0 & ~ok)


def inject_arrivals(
    spec: WorldSpec, state: WorldState, net: NetParams, user, mips,
) -> Tuple[WorldState, int, int]:
    """Host entry of the chunk-boundary injector (``engine.inject_arrivals``,
    the twin's drain): pads ``user`` / ``mips`` (at most
    ``spec.ingest_batch`` rows) to the batch width and applies
    :func:`_phase_inject` on the state's device.  The association is the
    contracted one (``fused=True``), as JAX's jitted injector computes it.
    Returns ``(state, n_injected, n_rejected)`` as Python ints."""
    if not spec.ingest:
        raise ValueError(
            "inject_arrivals needs the ingestion gate: build the world "
            "with spec.ingest=True (the injection phase is compiled "
            "out otherwise)"
        )
    B = spec.ingest_batch
    u = np.full((B,), -1, np.int32)
    m = np.zeros((B,), np.float32)
    n = len(user)
    if n > B:
        raise ValueError(
            f"injection batch of {n} rows exceeds spec.ingest_batch="
            f"{B}: drain at most ingest_batch rows per boundary"
        )
    u[:n] = np.asarray(user, np.int32)
    m[:n] = np.asarray(mips, np.float32)
    dev = state.t.device
    cache = associate(net, state.nodes.pos, state.nodes.alive, spec.broker_index,
                      fused=True)
    batch = {"user": torch.from_numpy(u).to(dev), "mips": torch.from_numpy(m).to(dev)}
    state, n_inj, n_rej = _phase_inject(spec, state, cache, batch)
    return state, int(n_inj), int(n_rej)


def _phase_spawn_multi(spec, state, net, cache, buf, t0, t1, dv: DynSpec, tp=None):
    """Up to ``max_sends_per_tick`` publishes per user per tick, send ``j``
    at ``max(next_send, t0) + j * interval``; per-send MIPS and uplink
    loss draws come from ``(U, R)`` lanes mapped onto slots by the send
    offset."""
    U, T, S = spec.n_users, spec.task_capacity, spec.max_sends_per_user
    R = spec.max_sends_per_tick
    users, tasks = state.users, state.tasks
    dev = t1.device
    can = state.nodes.alive[:U] & users.connected & users.publisher
    base = torch.maximum(users.next_send, t0)
    interval = users.send_interval
    k = torch.arange(S, dtype=_I32, device=dev)[None, :]
    j = k - users.send_count[:, None]
    jc = torch.clamp(j, 0, R - 1)
    # XLA fuses j * interval + base into one multiply-add
    fire = fma(j.to(_F32), interval[:, None], base[:, None])
    due2 = can[:, None] & (j >= 0) & (j < R) & (fire < t1)
    if spec.send_stop_time != _INF:
        due2 = due2 & (fire < knob(dv.send_stop_time, dev))
    keys = split(state.key, 4 if spec.wired_queue_enabled else 3)
    key, k_mips, k_loss = keys[0], keys[1], keys[2]

    def lane_select(draws, fill):
        """(U, R) lanes -> (U, S) slots by the send offset."""
        out = torch.full((U, S), fill, dtype=draws.dtype, device=dev)
        for r in range(R):
            out = torch.where(jc == r, draws[:, r: r + 1], out)
        return out

    if spec.fixed_mips_required is not None:
        mips2 = torch.full((U, S), float(spec.fixed_mips_required), dtype=_F32, device=dev)
    else:
        draws = _tp_user_draw(
            tp,
            lambda s: randint(
                k_mips, s, spec.mips_required_min, spec.mips_required_max + 1
            ),
            U, R,
        ).to(_F32)
        mips2 = lane_select(draws, 0.0)
    d_ub = cache.d2b[:U][:, None]
    t_arrive = fire + d_ub
    buffered2 = warm_lost2 = None
    if spec.link_up_s > 0:
        t_arrive, buffered2, warm_lost2 = _link_warmup(
            spec, dv, k.to(_F32), k, fire, t_arrive,
        )
    p_loss = _uplink_loss_p(spec, net, cache, dv, U, dev)
    if p_loss is None:
        lost2 = torch.zeros((U, S), dtype=torch.bool, device=dev)
    else:
        draws_l = _tp_user_draw(tp, lambda s: uniform(k_loss, s), U, R) < p_loss[:, None]
        lost2 = lane_select(draws_l, False) & net.is_wireless[:U, None]
        if buffered2 is not None:
            lost2 = lost2 & ~buffered2  # buffered frames deliver reliably
        elif spec.link_up_s > 0:
            lost2 = lost2 & (fire + d_ub >= knob(dv.link_up_s, dev))
    if spec.wired_queue_enabled:
        p_tail = _droptail_p(spec, state.nodes.link_drop_p, U)
        draws_d = _tp_user_draw(tp, lambda s: uniform(keys[3], s), U, R)
        lost2 = lost2 | (lane_select(draws_d, 1.0) < p_tail[:, None])
    if warm_lost2 is not None:
        lost2 = lost2 | (warm_lost2 & net.is_wireless[:U, None])
    st2 = tasks.stage.reshape(U, S)
    stage_new = torch.where(lost2, _i8(_ST_LOST, dev), _i8(_ST_PUB_INFLIGHT, dev))
    tasks = tasks.replace(
        stage=torch.where(due2, stage_new, st2).reshape(T),
        mips_req=torch.where(due2, mips2, tasks.mips_req.reshape(U, S)).reshape(T),
        t_create=torch.where(due2, fire, tasks.t_create.reshape(U, S)).reshape(T),
        t_at_broker=torch.where(
            due2, torch.where(lost2, _INF, t_arrive), tasks.t_at_broker.reshape(U, S)
        ).reshape(T),
    )
    n_fired = _isum(due2, 1)
    lost_u = _isum(due2 & lost2, 1)
    users = users.replace(
        next_send=torch.where(
            n_fired > 0, fma(n_fired.to(_F32), interval, base), users.next_send
        ),
        send_count=users.send_count + n_fired,
    )
    sums = _isum(torch.stack([n_fired, lost_u]), 1)
    metrics = state.metrics.replace(
        n_published=state.metrics.n_published + sums[0],
        n_lost=state.metrics.n_lost + sums[1],
    )
    buf = buf._replace(tx_u=buf.tx_u + n_fired)
    return state.replace(users=users, tasks=tasks, metrics=metrics, key=key), buf


def _fanout(users, metrics, buf: TickBuf, per_topic: torch.Tensor):
    """Topic fan-out (``publishAll``): every publish of a topic is
    delivered to each of its subscribers; ``per_topic`` holds this tick's
    publishes a topic as exact float32 integers.  Returns the users,
    metrics, buffer and the delivery count."""
    # a masked row sum rather than a matmul, so no TF32 setting reaches it
    deliveries = (users.sub_mask.to(_F32) * per_topic[None, :]).sum(dim=1).to(_I32)
    n_del = _isum(deliveries)
    users = users.replace(n_delivered=users.n_delivered + deliveries)
    metrics = metrics.replace(n_fanout=metrics.n_fanout + n_del)
    return users, metrics, buf._replace(rx_u=buf.rx_u + deliveries), n_del


def _phase_broker_dense(spec, state, cache, buf, t1, tp=None):
    """The dense broker: every matured publish is decided this tick
    against one scalar winner over the (stale) fog view; topic fan-out
    to subscribers rides along (under ``tp`` on the global per-topic
    counts, one ``psum``)."""
    tasks, b = state.tasks, state.broker
    U, S, F = spec.n_users, spec.max_sends_per_user, spec.n_fogs
    T = spec.task_capacity
    dev = t1.device
    st2 = tasks.stage.reshape(U, S)
    tab2 = tasks.t_at_broker.reshape(U, S)
    mask2 = (st2 == _ST_PUB_INFLIGHT) & (tab2 <= t1)

    metrics = state.metrics
    users = state.users
    n_del = torch.zeros((), dtype=_I32, device=dev)
    cnt_u = _isum(mask2, 1)
    if spec.fanout_enabled:
        topics = torch.arange(spec.n_topics, dtype=_I32, device=dev)
        per_topic = torch.where(
            users.pub_topic[None, :] == topics[:, None],
            cnt_u[None, :].to(_F32), 0.0,
        ).sum(dim=1)
        if tp is not None:
            # exact f32 integers: the sum does not depend on its order
            per_topic = tp.psum(per_topic)
        users, metrics, buf, n_del = _fanout(users, metrics, buf, per_topic)

    # key split kept for stream alignment with the compacted broker
    key = split(state.key, 2)[0]

    fog_alive = state.nodes.alive[U: U + F]
    reg_eff = _candidates(spec, b, fog_alive)
    fog_efrac = state.nodes.energy[U: U + F] / torch.clamp_min(
        state.nodes.energy_capacity[U: U + F], const(1e-12, dev)
    )
    rtt_bf = 2.0 * cache.d2b[U: U + F]

    def winner(reg):
        return scalar_winner(
            spec.policy, b.view_busy, b.view_mips, reg, fog_alive,
            fog_efrac, rtt_bf, spec.bug_compat.v1_max_scan,
        )

    if spec.hier_active:
        # one winner a broker domain, over its own fogs; each task takes
        # its own broker's (two (B,)-table gathers over the (U, S) view)
        reg_b = reg_eff[None, :] & _owned(spec, state.hier)
        tb2 = _task_brokers(spec, state.hier.task_broker).reshape(U, S)
        choice_s = torch.func.vmap(winner)(reg_b)[tb2]
        any_fog = reg_b.any(dim=1)[tb2]
    else:
        any_fog = reg_eff.any()
        choice_s = winner(reg_eff)
    choice_ok = choice_s >= 0
    if spec.policy == int(Policy.MAX_MIPS) and F > 0:
        win_mips = at(b.view_mips, torch.clamp(choice_s, 0, F - 1))
        guard2 = mask2 & choice_ok & ~(tasks.mips_req.reshape(U, S) < win_mips)
    else:
        guard2 = torch.zeros((U, S), dtype=torch.bool, device=dev)
    sched2 = mask2 & any_fog & choice_ok & ~guard2
    rejected2 = mask2 & any_fog & guard2
    no_res2 = mask2 & ~(sched2 | rejected2)
    new_stage2 = torch.where(
        sched2, _i8(_ST_TASK_INFLIGHT, dev),
        torch.where(rejected2, _i8(_ST_REJECTED, dev), _i8(_ST_NO_RESOURCE, dev)),
    )
    if F > 0:
        d_bf_c = at(cache.d2b, U + torch.clamp(choice_s, 0, F - 1))
    else:
        d_bf_c = torch.zeros((), dtype=_F32, device=dev)
    tasks = tasks.replace(
        stage=torch.where(mask2, new_stage2, st2).reshape(T),
        fog=torch.where(sched2, choice_s, tasks.fog.reshape(U, S)).reshape(T),
        t_at_fog=torch.where(
            sched2, tab2 + d_bf_c, tasks.t_at_fog.reshape(U, S)
        ).reshape(T),
    )
    if not spec.derive_acks:
        tasks = tasks.replace(
            t_ack4_fwd=torch.where(
                mask2, tab2 + cache.d2b[:U][:, None],
                tasks.t_ack4_fwd.reshape(U, S),
            ).reshape(T),
        )
    sums = _isum(torch.stack([sched2, no_res2, rejected2, mask2]).to(_I32), (1, 2))
    metrics = metrics.replace(
        n_scheduled=metrics.n_scheduled + sums[0],
        n_no_resource=metrics.n_no_resource + sums[1],
        n_rejected=metrics.n_rejected + sums[2],
    )
    buf = buf._replace(
        tx_b=buf.tx_b + sums[0] + sums[3] + n_del,
        rx_b=buf.rx_b + sums[3],
        rx_u=buf.rx_u + cnt_u,
    )
    return state.replace(tasks=tasks, users=users, metrics=metrics, key=key), buf


def _lexsort_time_slot(t_key: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((idx, t_key))``: the order by time, ties by slot, as
    two stable sorts.  ``+ 0.0`` folds -0.0 into +0.0: JAX's sort ties
    them, and the card's radix sort would not."""
    by_slot = torch.sort(idx, stable=True).indices
    by_time = torch.sort((t_key + 0.0)[by_slot], stable=True).indices
    return by_slot[by_time]


def _local_first(spec, state, mips_g, valid, idx, t_ab_g):
    """LOCAL_FIRST's local branch (``BrokerBaseApp.cc:196-224``, v2's
    ``BrokerBaseApp2.cc:181-224``): the window in arrival order debits
    the broker's own MIPS pool (:func:`..ops.pool_kernels.local_pool_scan`).
    Under ``v2_local_broker`` the shared release timer is interleaved with
    the accepts in event order: the first accept before its fire time
    cancels it, and a timer still armed pops before a later arrival, its
    refund (the first stored request that expired before the fire, chosen
    on the state before this tick's decisions) visible to the accepts
    after it.  Returns ``(local, broker, v2_resched)``, the last ``(the
    after pass's next fire time, the refund already applied)`` or None."""
    tasks, b = state.tasks, state.broker
    T = spec.task_capacity
    dev = mips_g.device
    inf = const(_INF, dev)
    t_key = torch.where(valid, t_ab_g, inf)
    order = _lexsort_time_slot(t_key, idx)
    mips_s, valid_s = mips_g[order], valid[order]
    if not spec.v2_local_broker:
        take_s, pool_after, _ = local_pool_scan(
            mips_s, valid_s, mips_s, b.local_pool, b.local_pool, b.local_pool, False
        )
    else:
        fire_t0 = b.release_timer_t
        req_t = const(spec.required_time, dev)
        open0 = (tasks.req_open > 0) & (tasks.t_at_broker + req_t < fire_t0)
        key0 = torch.where(open0, tasks.t_at_broker, inf)
        cand0 = open0 & (key0 == key0.amin())
        sel0 = torch.where(cand0, torch.arange(T, dtype=_I32, device=dev), T).amin()
        refund0 = torch.where(
            sel0 < T, at(tasks.mips_req, torch.clamp(sel0, 0, T - 1)), 0.0
        )
        take_s, pool_after, fired = local_pool_scan(
            mips_s, valid_s, t_key[order], b.local_pool, fire_t0, refund0, True
        )
    local = torch.zeros_like(valid).scatter(0, order, take_s)
    b = b.replace(local_pool=pool_after)
    if not spec.v2_local_broker:
        return local, b, None
    # the timer's disposition: a fire inside the scan leaves it armed at
    # the old time for the after pass (its refund already applied), which
    # then installs the last accept's reschedule; accepts alone install it
    # here; neither leaves it as it was
    any_local = local.any()
    t_last = torch.where(local, t_ab_g, -_INF).amax()
    resched = torch.where(any_local, t_last + req_t, inf)
    b = b.replace(
        release_timer_t=torch.where(any_local & ~fired, resched, b.release_timer_t)
    )
    return local, b, (torch.where(fired, resched, inf), fired)


def _phase_broker(spec, state, cache, buf, t1):
    """The compacted broker: up to K matured publishes a tick (the
    tick-keyed rotated window, the rest deferred).  LOCAL_FIRST first
    runs what the broker's own pool covers (:func:`_local_first`); the
    rest are decided one by one by :func:`~..ops.sched.schedule_batch`
    against the broker's stale fog view and partitioned into scheduled,
    rejected by the MIPS guard (MAX_MIPS and LOCAL_FIRST: a task whose
    MIPS is not below the winner's advertised MIPS is never sent,
    ``BrokerBaseApp.cc:244-252``) and no-resource.  With a learned policy
    the pick counts advance at the end of the window and an EXP3-capable
    world records each pick's probability for the credit phase.  Returns
    ``(state, buf, v2_resched)`` (:func:`_local_first`)."""
    tasks, b = state.tasks, state.broker
    T, F, K = spec.task_capacity, spec.n_fogs, spec.window
    U, S = spec.n_users, spec.max_sends_per_user
    dev = t1.device
    mask = (tasks.stage == _ST_PUB_INFLIGHT) & (tasks.t_at_broker <= t1)
    rot, state = _rot_and_defer(spec, state, mask, K)
    idx, idxc, valid = _compact(mask, K, T, rot)
    g = idxc.long()
    mips_g = tasks.mips_req[g]
    user_g = torch.div(g, S, rounding_mode="floor")
    t_ab_g = tasks.t_at_broker[g]

    n_del = torch.zeros((), dtype=_I32, device=dev)
    metrics, users = state.metrics, state.users
    if spec.fanout_enabled:
        topics = torch.arange(spec.n_topics, dtype=_I32, device=dev)
        topic_g = users.pub_topic[user_g]
        per_topic = _isum(
            (topic_g[None, :] == topics[:, None]) & valid[None, :], 1
        ).to(_F32)
        users, metrics, buf, n_del = _fanout(users, metrics, buf, per_topic)

    local_first = spec.policy == int(Policy.LOCAL_FIRST)
    local = torch.zeros_like(valid)
    v2_resched = None
    if local_first:
        local, b, v2_resched = _local_first(spec, state, mips_g, valid, idx, t_ab_g)

    keys = split(state.key, 2)
    key, k_sched = keys[0], keys[1]
    fog_alive = state.nodes.alive[U: U + F]
    reg_eff = _candidates(spec, b, fog_alive)
    fog_efrac = state.nodes.energy[U: U + F] / torch.clamp_min(
        state.nodes.energy_capacity[U: U + F], const(1e-12, dev)
    )
    hier_kw = {}
    if spec.hier_active:
        # each task of the window is decided by its own broker, over that
        # broker's fogs (ops/sched.py); "no resource" is judged a domain
        tb_g = _task_brokers(spec, state.hier.task_broker[g])
        hier_kw = dict(
            fog_owner=state.hier.fog_broker, task_broker=tb_g,
            n_brokers=spec.n_brokers,
        )
        owned = _owned(spec, state.hier)
        any_fog = (reg_eff[None, :] & owned).any(dim=1)[tb_g]
    else:
        any_fog = reg_eff.any()
    offl = valid & ~local
    rand_u = None
    if spec.policy in (int(Policy.RANDOM), int(Policy.DYNAMIC), int(Policy.EXP3)):
        # the task-id-keyed stream shared with the native DES
        rand_u = task_uniform(PRNGKey(spec.policy_seed, dev), idxc)
    choice, rr_new = schedule_batch(
        spec.policy, offl, mips_g, b.view_busy, b.view_mips, reg_eff,
        fog_alive, fog_efrac, 2.0 * cache.d2b[U: U + F], b.rr_next, k_sched,
        spec.bug_compat.mips0_divisor, spec.bug_compat.v1_max_scan,
        policy_id=b.policy_id, order_t=t_ab_g, rand_u=rand_u,
        learn=arms_view(state.learn) if spec.learn_active else None,
        **hier_kw,
    )
    choice_ok = choice >= 0
    guard_fail = torch.zeros_like(valid)
    if spec.policy in (int(Policy.MAX_MIPS), int(Policy.LOCAL_FIRST)) and F > 0:
        win_mips = b.view_mips[torch.clamp(choice, 0, F - 1).long()]
        guard_fail = choice_ok & ~(mips_g < win_mips)
    fog_node = U + torch.clamp(choice, 0, F - 1).long()
    sched = offl & any_fog & choice_ok & ~guard_fail
    rejected = offl & any_fog & guard_fail
    no_res = offl & (~any_fog | (~choice_ok & ~guard_fail))

    learn = state.learn
    if spec.learn_active:
        picked = _per_fog(sched, choice, F)
        learn = learn.replace(
            pick_count=learn.pick_count + _isum(picked, 1).to(_F32)
        )
        if spec.policy == int(Policy.EXP3) or (
            spec.policy == int(Policy.DYNAMIC) and spec.learn_in_dynamic
        ):
            if spec.hier_active:
                # the pick's probability within its own broker's softmax
                p_bf = torch.func.vmap(
                    lambda av: exp3_probs(learn.logw, av, learn.explore)
                )((b.registered & fog_alive)[None, :] & owned)
                p_row = p_bf[tb_g, torch.clamp(choice, 0, F - 1).long()]
            else:
                p_vec = exp3_probs(learn.logw, b.registered & fog_alive, learn.explore)
                # p at each row's chosen fog: one nonzero a column, so exact
                p_row = torch.where(picked, p_vec[:, None], 0.0).sum(dim=0)
            if spec.policy == int(Policy.DYNAMIC):
                p_row = torch.where(b.policy_id == int(Policy.EXP3), p_row, 1.0)
            learn = learn.replace(
                pick_p=set_drop(learn.pick_p, idx, torch.where(sched, p_row, 1.0))
            )

    inf_t = torch.full((), _INF, dtype=_F32, device=dev)
    new_stage = torch.where(
        sched, _i8(_ST_TASK_INFLIGHT, dev),
        torch.where(
            local, _i8(_ST_LOCAL_RUN, dev),
            torch.where(rejected, _i8(_ST_REJECTED, dev), _i8(_ST_NO_RESOURCE, dev)),
        ),
    )
    tasks = tasks.replace(
        stage=set_drop(tasks.stage, idx, new_stage),
        fog=set_drop(tasks.fog, idx, torch.where(sched, choice, NO_TASK)),
        t_at_fog=set_drop(
            tasks.t_at_fog, idx, torch.where(sched, t_ab_g + cache.d2b[fog_node], inf_t)
        ),
    )
    if not spec.derive_acks:
        # v1's local branch acks status-3 "processing" instead of the
        # forwarded status-4 (BrokerBaseApp.cc:200-212)
        a_bu = t_ab_g + cache.d2b[user_g]
        tasks = tasks.replace(
            t_ack4_fwd=set_drop(tasks.t_ack4_fwd, idx, torch.where(~local, a_bu, inf_t)),
            t_ack3=set_drop(tasks.t_ack3, idx, torch.where(local, a_bu, inf_t)),
        )
    if local_first:
        tasks = tasks.replace(
            t_service_start=set_drop(
                tasks.t_service_start, idx, torch.where(local, t_ab_g, inf_t)
            ),
        )
        if spec.v2_local_broker:
            # v2 stores a request for each local accept and each decided
            # offload when fogs exist, guard refusals included
            # (BrokerBaseApp2.cc:212,244); they complete at a release fire
            store = local | (offl & any_fog)
            tasks = tasks.replace(
                req_open=set_drop(
                    tasks.req_open, torch.where(store, idx, T),
                    torch.ones((), dtype=torch.int8, device=dev),
                ),
            )
        else:
            tasks = tasks.replace(
                t_complete=set_drop(
                    tasks.t_complete, idx,
                    torch.where(local, t_ab_g + const(spec.required_time, dev), inf_t),
                ),
            )
    sums = _isum(torch.stack([sched, no_res, rejected, local, valid]), 1)
    metrics = metrics.replace(
        n_scheduled=metrics.n_scheduled + sums[0],
        n_no_resource=metrics.n_no_resource + sums[1],
        n_rejected=metrics.n_rejected + sums[2],
        n_local=metrics.n_local + sums[3],
    )
    buf = buf._replace(
        tx_b=buf.tx_b + sums[0] + sums[4] + n_del,
        rx_b=buf.rx_b + sums[4],
        rx_u=add_drop(buf.rx_u, user_g, valid.to(_I32)),
    )
    return state.replace(
        tasks=tasks, users=users, broker=b.replace(rr_next=rr_new),
        metrics=metrics, key=key, learn=learn,
    ), buf, v2_resched


def _phase_learn_credit(spec, state, t1, dv: DynSpec):
    """Delayed-reward credit: the DONE tasks whose status-6 ack has landed
    by ``t1`` and is not yet credited (up to K a tick, the tick-keyed
    rotated window; the rest credit a later tick) fold ``exp(-latency /
    scale)`` into the arms of the fogs picked at publish time, exactly
    once each.  The discounted statistics decay every tick."""
    tasks, learn = state.tasks, state.learn
    T, F, K = spec.task_capacity, spec.n_fogs, spec.window
    due = (
        (tasks.stage == _ST_DONE)
        & (learn.credited == 0)
        & (tasks.fog >= 0)
        & (tasks.t_ack6 <= t1)
    )
    rot = None
    if K < T:
        rot = (((state.tick.long() * 2654435761) & _M32) % T).to(_I32)
    idx, idxc, valid = _compact(due, K, T, rot)
    g = idxc.long()
    fog_g = tasks.fog[g]
    # the latency is counted from the publish, save for a task the chaos
    # phase bounced back (retry > 0) or the federation migrated (hops >
    # 0): its t_at_broker was restamped, and the pick that served it is
    # charged only its own leg
    lat0 = tasks.t_ack6[g] - tasks.t_create[g]
    if spec.chaos:
        lat0 = torch.where(
            state.chaos.retry[g] > 0, tasks.t_ack6[g] - tasks.t_at_broker[g], lat0
        )
    if spec.hier_active:
        lat0 = torch.where(
            state.hier.hops[g] > 0, tasks.t_ack6[g] - tasks.t_at_broker[g], lat0
        )
    lat = torch.where(valid, lat0, 0.0)
    memb = _per_fog(valid, fog_g, F)
    learn = credit_batch(
        learn, valid, memb, lat, learn.pick_p[g], F,
        dv.learn_discount, dv.learn_reward_scale,
    )
    learn = learn.replace(
        credited=set_drop(learn.credited, idx, torch.ones((), dtype=torch.int8, device=t1.device))
    )
    return state.replace(learn=learn)


def _phase_chaos(spec, state, cache, buf, t0, t1, dv: DynSpec):
    """Fault injection, first of the protocol phases (so an edge inside
    ``[t0, t1)`` is in ``nodes.alive`` before any dispatch of the tick):

    * advance the outage schedules (:func:`..chaos.faults.step_lifecycle`)
      and write the fogs' up mask into ``nodes.alive``;
    * sweep the in-flight tasks off the fogs that crashed: LOSE drops them
      into LOST (``n_lost_crash``); REOFFLOAD bounces them back to the
      broker as publishes arriving at ``crash time + d(fog, broker)``,
      within a per-task retry budget, and loses the rest
      (``n_retry_exhausted``).  A crashed fog reboots clean; a recovered
      one puts a fresh advertisement in flight;
    * resolve each swept pick of a learned policy once, as a zero-reward
      penalty (:func:`..learn.rewards.penalize_counts`).

    The per-task reads of the per-fog edges are gathers on the device."""
    U, F, T = spec.n_users, spec.n_fogs, spec.task_capacity
    dev = t1.device
    tasks = state.tasks
    alive = state.nodes.alive
    ch, up_new, crashed, recovered, crash_t, recover_t = step_lifecycle(
        spec, state.chaos, alive[U: U + F], t0, t1, dv
    )
    nodes = state.nodes.replace(alive=torch.cat([alive[:U], up_new, alive[U + F:]]))

    st = tasks.stage
    fog_c = torch.clamp(tasks.fog, 0, F - 1).long()
    live = (st == _ST_TASK_INFLIGHT) | (st == _ST_QUEUED) | (st == _ST_RUNNING)
    swept = (tasks.fog >= 0) & live & crashed[fog_c]

    learn = state.learn
    if spec.learn_active:
        # booked on the picked arm before the fog column is cleared; the
        # float32 counts are small integers, exact in any order
        cnt_f = add_drop(
            torch.zeros((F,), dtype=_F32, device=dev),
            torch.where(swept, fog_c, F), torch.ones((), dtype=_F32, device=dev),
        )
        learn = penalize_counts(learn, cnt_f)

    inf = const(_INF, dev)
    reoffload = spec.chaos_mode == int(ChaosMode.REOFFLOAD)
    if reoffload:
        retry_new = ch.retry + swept.to(torch.int8)
        exhausted = swept & (retry_new.to(_I32) > int_knob(dv.chaos_max_retries))
        bounce = swept & ~exhausted
        terminal = exhausted
        # back to the broker: the fog->broker hop stands for the orphan
        # notice's round trip
        t_back = crash_t[fog_c] + cache.d2b[U + fog_c]
        tasks = tasks.replace(
            stage=torch.where(
                bounce, _i8(_ST_PUB_INFLIGHT, dev),
                torch.where(exhausted, _i8(_ST_LOST, dev), st),
            ),
            t_at_broker=torch.where(bounce, t_back, tasks.t_at_broker),
            fog=torch.where(bounce, NO_TASK, tasks.fog),
            t_at_fog=torch.where(bounce, inf, tasks.t_at_fog),
            t_q_enter=torch.where(bounce, inf, tasks.t_q_enter),
            t_service_start=torch.where(bounce, inf, tasks.t_service_start),
            t_complete=torch.where(swept, inf, tasks.t_complete),
        )
        ch = ch.replace(retry=retry_new)
    else:
        bounce = exhausted = torch.zeros_like(swept)
        terminal = swept
        # LOSE keeps the fog column: which arm the task died on
        tasks = tasks.replace(
            stage=torch.where(swept, _i8(_ST_LOST, dev), st),
            t_complete=torch.where(swept, inf, tasks.t_complete),
        )
    if spec.learn_active:
        # terminal rows resolve here, once; bounced rows at their ack
        learn = learn.replace(
            credited=torch.maximum(learn.credited, terminal.to(torch.int8))
        )

    fogs = state.fogs
    fogs = fogs.replace(
        current_task=torch.where(crashed, NO_TASK, fogs.current_task),
        busy_until=torch.where(crashed, inf, fogs.busy_until),
        busy_time=torch.where(crashed, 0.0, fogs.busy_time),
        free_since=torch.where(recovered, recover_t, fogs.free_since),
        queue=torch.where(crashed[:, None], NO_TASK, fogs.queue),
        q_head=torch.where(crashed, 0, fogs.q_head),
        q_len=torch.where(crashed, 0, fogs.q_len),
        pool_avail=torch.where(crashed, fogs.mips, fogs.pool_avail),
    )
    b = state.broker
    adv_mips = fogs.pool_avail if spec.fog_model == int(FogModel.POOL) else fogs.mips
    b = b.replace(
        adv_val_mips=torch.where(recovered, adv_mips, b.adv_val_mips),
        adv_val_busy=torch.where(recovered, 0.0, b.adv_val_busy),
        adv_arrive_t=torch.where(
            recovered, recover_t + cache.d2b[U: U + F], b.adv_arrive_t
        ),
    )
    sums = _isum(torch.stack([bounce, exhausted, swept]), 1)
    if reoffload:
        ch = ch.replace(
            n_reoffloaded=ch.n_reoffloaded + sums[0],
            n_retry_exhausted=ch.n_retry_exhausted + sums[1],
        )
    else:
        ch = ch.replace(n_lost_crash=ch.n_lost_crash + sums[2])
    # a bounce is one orphan notice at the broker; a recovery one advert
    buf = buf._replace(rx_b=buf.rx_b + sums[0], tx_f=buf.tx_f + recovered.to(_I32))
    return state.replace(
        nodes=nodes, tasks=tasks, fogs=fogs, broker=b, learn=learn, chaos=ch
    ), buf


def _chaos_rtt(spec, state, cache, t0, dv: DynSpec) -> LinkCache:
    """The tick's delay cache with its broker->fog rows degraded by
    :func:`..chaos.faults.rtt_factor`."""
    U, F = spec.n_users, spec.n_fogs
    fac = rtt_factor(spec, state.chaos, state.tick, t0, dv)
    d2b = cache.d2b
    return cache.replace(
        d2b=torch.cat([d2b[:U], d2b[U: U + F] * fac, d2b[U + F:]])
    )


def _hier_migrate_on(spec: WorldSpec) -> bool:
    """The migrate phase runs in a federated world whose policy is not
    NEVER (NEVER keeps the domain-masked decisions, nothing moves)."""
    return spec.hier_active and spec.hier_policy != int(HierPolicy.NEVER)


def _hier_rtt(dv: DynSpec, dev) -> torch.Tensor:
    """The (B, B) inter-broker RTT matrix on ``dev``: the operand as
    given, host values copied at the first tick and kept."""
    if isinstance(dv.hier_rtt, torch.Tensor):
        return dv.hier_rtt
    rows = np.asarray(dv.hier_rtt, np.float32)
    return kept_tensor(tuple(rows.ravel().tolist()), _F32, dev).reshape(rows.shape)


def _phase_broker_migrate(spec, state, buf, t1, dv: DynSpec):
    """Broker-to-broker migration of the federated hierarchy, after the
    spawn and before the decide phase, so a publish maturing at a
    saturated or dead domain this tick can leave before its broker
    decides it:

    * each broker's view of a peer's busy fraction refreshes only when
      their RTT has elapsed since the last read (a stale view, as the
      fogs' adverts are);
    * a broker fires (THRESHOLD: its live busy fraction above
      ``hier_threshold``; LEAST_LOADED: a peer looks less loaded; a dead
      domain, no usable fog, always) and sends every matured publish it
      holds to the least-loaded peer by its view (ties to the lowest id),
      ``t_at_broker`` one hop later;
    * a matured publish in a dead domain that cannot move (hop budget
      spent, or no live peer) becomes HOP_EXHAUSTED.

    No draws: the destinations are argmins."""
    U, F, T, B = spec.n_users, spec.n_fogs, spec.task_capacity, spec.n_brokers
    S = spec.max_sends_per_user
    dev = t1.device
    hier, tasks, b = state.hier, state.tasks, state.broker
    owned = _owned(spec, hier)
    usable = _candidates(spec, b, state.nodes.alive[U: U + F])
    if spec.fog_model == int(FogModel.POOL):
        busy = state.fogs.pool_avail < state.fogs.mips
    else:
        busy = state.fogs.current_task != NO_TASK
    up_b = owned & usable[None, :]
    n_up = _isum(up_b, 1)
    n_busy = _isum(up_b & busy[None, :], 1)
    dead = n_up == 0
    # a dead domain's load is +inf: it repels its peers
    load = torch.where(
        dead, _INF, n_busy.to(_F32) / torch.clamp_min(n_up.to(_F32), 1.0)
    )

    rtt = _hier_rtt(dv, dev)
    due = t1 >= hier.peer_t
    peer_load = torch.where(due, load[None, :], hier.peer_load)
    peer_t = torch.where(due, t1 + rtt, hier.peer_t)

    has_fog = owned.any(dim=1)
    eye = kept_tensor(tuple(np.eye(B, dtype=bool).ravel().tolist()), torch.bool, dev)
    eye = eye.reshape(B, B)
    score = torch.where(~eye & has_fog[None, :], peer_load, _INF)
    dest = torch.argmin(score, dim=1)  # ties to the lowest broker id
    best = score.amin(dim=1)
    has_dest = torch.isfinite(best)
    if spec.hier_policy == int(HierPolicy.THRESHOLD):
        fire = dead | (load > knob(dv.hier_threshold, dev))
    else:  # LEAST_LOADED
        fire = dead | (best < load)

    st2 = tasks.stage.reshape(U, S)
    tab2 = tasks.t_at_broker.reshape(U, S)
    matured2 = (st2 == _ST_PUB_INFLIGHT) & (tab2 <= t1)
    tb = _task_brokers(spec, hier.task_broker)
    tb2 = tb.reshape(U, S)
    hops_ok2 = (hier.hops.to(_I32) < int_knob(dv.hier_max_hops)).reshape(U, S)
    can_go2 = has_dest[tb2] & hops_ok2
    mig2 = matured2 & fire[tb2] & can_go2
    # exhaustion is a dead domain's only: the task can neither be served
    # where it is nor move
    exhaust2 = matured2 & dead[tb2] & ~can_go2
    dst2 = dest[tb2]
    tasks = tasks.replace(
        stage=torch.where(exhaust2, _i8(_ST_HOP_EXHAUSTED, dev), st2).reshape(T),
        t_at_broker=torch.where(mig2, tab2 + rtt[tb2, dst2], tab2).reshape(T),
    )
    mig = mig2.reshape(T)
    dst = dst2.reshape(T)
    bid = kept_tensor(tuple(range(B)), torch.int64, dev)
    out_b = _isum((tb[None, :] == bid[:, None]) & mig[None, :], 1)
    in_b = _isum((dst[None, :] == bid[:, None]) & mig[None, :], 1)
    sums = _isum(torch.stack([mig2, exhaust2]), (1, 2))
    hier = hier.replace(
        task_broker=torch.where(mig, dst.to(_I32), hier.task_broker),
        hops=hier.hops + mig.to(torch.int8),
        peer_load=peer_load,
        peer_t=peer_t,
        mig_out=hier.mig_out + out_b,
        mig_in=hier.mig_in + in_b,
        n_migrated=hier.n_migrated + sums[0],
        n_hop_exhausted=hier.n_hop_exhausted + sums[1],
    )
    # a migration is one task forward over the federation link, both ends
    # on the one broker node
    buf = buf._replace(tx_b=buf.tx_b + sums[0], rx_b=buf.rx_b + sums[0])
    return state.replace(tasks=tasks, hier=hier), buf


def _phase_completions(spec, state, cache, buf, t1, tp=None):
    """FIFO fogs whose in-service task finished release it: status-6 ack
    relayed, busyTime decremented, FIFO head promoted at ``busy_until +
    svc``, a fresh advertisement put in flight.  Under ``tp`` the fog
    state is replicated and the task rows are the shard's: the finished
    and promoted tasks' columns come through one ``psum`` gather, task
    writes land on the owning shard, acks count for its users only."""
    tasks, fogs, b = state.tasks, state.fogs, state.broker
    F, U, S = spec.n_fogs, spec.n_users, spec.max_sends_per_user
    T_id = _task_id_end(spec, tp)
    dev = t1.device
    fog_alive = state.nodes.alive[U: U + F]
    comp = (fogs.current_task != NO_TASK) & (fogs.busy_until <= t1) & fog_alive
    done_task = torch.where(comp, fogs.current_task, T_id)
    t_done = fogs.busy_until
    head, q_head, q_len = batched_pop(fogs.queue, fogs.q_head, fogs.q_len, comp)
    promoted = comp & (head != NO_TASK)
    prom_idx = torch.where(promoted, head, T_id)
    cols = _task_gather(
        spec, tp, [tasks.mips_req, tasks.t_q_enter], torch.cat([done_task, prom_idx])
    )
    mips_done, mips_head, tq_head = cols[0, :F], cols[0, F:], cols[1, F:]
    user_of = torch.div(done_task.clamp(0, T_id - 1).long(), S, rounding_mode="floor")
    d_fb = cache.d2b[U: U + F]
    svc_done = _svc_time(mips_done, fogs.mips)
    zero = torch.zeros((), dtype=_F32, device=dev)
    done_rows = _own_rows(done_task, tp)
    prom_rows = _own_rows(prom_idx, tp)
    tasks = tasks.replace(
        t_complete=set_drop(tasks.t_complete, done_rows, torch.where(comp, t_done, zero)),
    )
    if not spec.derive_acks:
        t_ack6 = t_done + d_fb + _user_delays(cache, tp)[user_of]
        tasks = tasks.replace(
            t_ack6=set_drop(tasks.t_ack6, done_rows, torch.where(comp, t_ack6, zero)),
        )
    busy_time = torch.where(comp, fogs.busy_time - svc_done, fogs.busy_time)

    svc_new = _svc_time(mips_head, fogs.mips)
    stage_vals = torch.cat([
        torch.full((F,), _ST_DONE, dtype=torch.int8, device=dev),
        torch.full((F,), _ST_RUNNING, dtype=torch.int8, device=dev),
    ])
    tasks = tasks.replace(
        stage=set_drop(tasks.stage, torch.cat([done_rows, prom_rows]), stage_vals),
        t_service_start=set_drop(
            tasks.t_service_start, prom_rows, torch.where(comp, t_done, zero)
        ),
    )
    if not spec.derive_acks:
        qt = (t_done - tq_head) * 1e3
        tasks = tasks.replace(
            queue_time_ms=set_drop(
                tasks.queue_time_ms, prom_rows, torch.where(promoted, qt, zero)
            ),
        )
    fogs = fogs.replace(
        busy_time=busy_time,
        current_task=torch.where(
            comp, torch.where(promoted, head, NO_TASK), fogs.current_task
        ).to(_I32),
        busy_until=torch.where(
            comp, torch.where(promoted, t_done + svc_new, _INF), fogs.busy_until
        ),
        free_since=torch.where(comp & ~promoted, t_done, fogs.free_since),
        q_head=q_head,
        q_len=q_len,
    )
    if spec.adv_on_completion:
        b = b.replace(
            adv_val_mips=torch.where(comp, fogs.mips, b.adv_val_mips),
            adv_val_busy=torch.where(comp, busy_time, b.adv_val_busy),
            adv_arrive_t=torch.where(comp, t_done + d_fb, b.adv_arrive_t),
        )
    n_comp = _isum(comp)
    metrics = state.metrics.replace(n_completed=state.metrics.n_completed + n_comp)
    n_adv = n_comp if spec.adv_on_completion else 0
    buf = buf._replace(
        tx_f=buf.tx_f + comp.to(_I32) * (2 if spec.adv_on_completion else 1),
        tx_b=buf.tx_b + n_comp,
        rx_b=buf.rx_b + n_comp + n_adv,
        rx_u=add_drop(buf.rx_u, _user_rows(user_of, tp), comp.to(_I32)),
    )
    return state.replace(tasks=tasks, fogs=fogs, broker=b, metrics=metrics), buf


def _arrival_candidates(st2, taf2, fog2, mip2, t1, R: int):
    """The R earliest matured (TASK_INFLIGHT, ``t_at_fog <= t1``) slots per
    user; argmin takes the first minimum, so ties break by slot id."""
    S = st2.shape[1]
    kk = torch.arange(S, dtype=_I32, device=st2.device)[None, :]
    m = (st2 == _ST_TASK_INFLIGHT) & (taf2 <= t1)
    cks, cts, cfs, cms, cvs = [], [], [], [], []
    for _ in range(R):
        key = torch.where(m, taf2, _INF)
        ck = torch.argmin(key, dim=1).to(_I32)
        ct = key.amin(dim=1)
        cv = torch.isfinite(ct)
        sel = m & (kk == ck[:, None])
        cf = _isum(torch.where(sel, fog2, 0), 1)
        cm = torch.where(sel, mip2, 0.0).sum(dim=1)
        cks.append(ck); cts.append(ct); cfs.append(cf)
        cms.append(cm); cvs.append(cv)
        m = m & ~sel
    return cks, cts, cfs, cms, cvs, _isum(m)


def _phase_fog_arrivals(spec, state, cache, buf, t1, tp=None, exchange=None):
    """Tasks reaching their FIFO fog are assigned or queued
    (ComputeBrokerApp3.cc:269-320), through the two-stage front: R
    candidates per user, the saturated-fog fast drop on the candidate
    list, then the K-window compaction and the shared tail; with
    ``two_stage_arrivals`` off, through :func:`_fog_arrivals_front_full`.

    Under ``tp`` the candidates are the shard's users', the fast drop's
    per-fog sums are summed over the shards, and ``exchange`` (from
    :mod:`..parallel.taskshard`) turns every shard's surviving candidates
    into the window each shard's tail plans: ``exchange(state, t1, made,
    valid, ids, fog, t, mips) -> ((ids, fog, t, mips) of the window,
    deferred)``, ``made`` being the candidates before the fast drop.
    """
    if not spec.two_stage_arrivals:
        return _fog_arrivals_front_full(spec, state, cache, buf, t1)
    tasks, fogs = state.tasks, state.fogs
    T, F, K = spec.task_capacity, spec.n_fogs, spec.window
    U, S = spec.n_users, spec.max_sends_per_user
    R = min(spec.arrival_cands, S)
    dev = t1.device
    fog_alive = state.nodes.alive[U: U + F]
    st2 = tasks.stage.reshape(U, S)
    kk = torch.arange(S, dtype=_I32, device=dev)[None, :]
    cks, cts, cfs, cms, cvs, n_left = _arrival_candidates(
        st2, tasks.t_at_fog.reshape(U, S), tasks.fog.reshape(U, S),
        tasks.mips_req.reshape(U, S), t1, R,
    )
    UR = U * R
    cand_t = torch.stack(cts, dim=1).reshape(UR)
    cand_f = torch.stack(cfs, dim=1).reshape(UR)
    cand_m = torch.stack(cms, dim=1).reshape(UR)
    cand_v = torch.stack(cvs, dim=1).reshape(UR)
    cand_u = torch.arange(U, dtype=_I32, device=dev).repeat_interleave(R)
    cand_slot = cand_u * S + torch.stack(cks, dim=1).reshape(UR)
    if tp is not None:
        cand_slot = cand_slot + tp.t_off  # global task ids

    cand_made = cand_v  # before the fast drop: the TP exchange gauges count it
    # saturated-fog fast drop on the candidate list
    n_fast = torch.zeros((), dtype=_I32, device=dev)
    n_fast_f = torch.zeros((F,), dtype=_I32, device=dev)
    if F > 0:
        droppy = (
            (fogs.q_len >= spec.queue_capacity)
            & (fogs.current_task != NO_TASK)
            & fog_alive
        )
        # JAX's one-hot matmuls as masked reductions, so no TF32 setting
        # reaches them; the MIPS sums are exact (_mips_sum64)
        memb = _per_fog(cand_v, cand_f, F)  # (F, UR)
        fast_drop = cand_v & (memb & droppy[:, None]).any(dim=0)
        memb_fast = memb & fast_drop[None, :]
        n_fast_f = _isum(memb_fast, 1)
        mips_fast = _mips_sum64(memb_fast, cand_m)
        if tp is not None:
            # the decision is local (replicated fog state), its sums global
            sums = tp.psum(torch.stack([n_fast_f.double(), mips_fast], dim=1))
            n_fast_f, mips_fast = sums[:, 0].to(_I32), sums[:, 1]
        svc_fast_f = mips_fast.float() / torch.clamp_min(fogs.mips, const(1e-9, dev))
        fogs = fogs.replace(
            busy_time=fogs.busy_time + svc_fast_f,
            q_drops=fogs.q_drops + n_fast_f,
        )
        n_fast = _isum(n_fast_f)
        fast2 = fast_drop.reshape(U, R)
        sel_fast = torch.zeros((U, S), dtype=torch.bool, device=dev)
        for r in range(R):
            sel_fast = sel_fast | ((kk == cks[r][:, None]) & fast2[:, r: r + 1])
        st2 = torch.where(sel_fast, _i8(_ST_DROPPED, dev), st2)
        tasks = tasks.replace(stage=st2.reshape(T))
        cand_v = cand_v & ~fast_drop

    state = state.replace(
        metrics=state.metrics.replace(n_deferred=state.metrics.n_deferred + n_left)
    )
    if exchange is None:
        # K-window compaction over the candidate list
        rot, state = _rot_and_defer(spec, state, cand_v, K)
        _, idxc_c, valid = _compact(cand_v, K, UR, rot)
        g = idxc_c.long()
        win = (torch.where(valid, cand_slot[g], T).to(_I32), cand_f[g], cand_t[g], cand_m[g])
    else:
        win, deferred = exchange(
            state, t1, cand_made, cand_v, cand_slot, cand_f, cand_t, cand_m
        )
        state = state.replace(
            metrics=state.metrics.replace(
                n_deferred=state.metrics.n_deferred + deferred
            )
        )
    return _fog_arrivals_tail(
        spec, state, cache, buf, tasks, fogs, *win, n_fast, n_fast_f, tp=tp
    )


#: Widest fog axis of the full front's dense fast drop (an (F, T)
#: membership); wider worlds seat every arrival in the window.
_FAST_DROP_MAX_F = 256


def _fog_arrivals_front_full(spec, state, cache, buf, t1):
    """The classic arrival front (``two_stage_arrivals`` off): the whole
    table's matured arrivals, the saturated-fog fast drop decided densely
    over it, then the K-window compaction of the rest and the shared tail.
    JAX's (F, T) GEMV and (F, T) @ (T, 2) matmul are masked reductions
    here (no TF32 setting reaches them); the per-fog MIPS sums are exact
    (:func:`_mips_sum64`)."""
    tasks, fogs = state.tasks, state.fogs
    T, F, K = spec.task_capacity, spec.n_fogs, spec.window
    U = spec.n_users
    dev = t1.device
    fog_alive = state.nodes.alive[U: U + F]
    arr_full = (tasks.stage == _ST_TASK_INFLIGHT) & (tasks.t_at_fog <= t1)
    n_fast = torch.zeros((), dtype=_I32, device=dev)
    n_fast_f = torch.zeros((F,), dtype=_I32, device=dev)
    if 0 < F <= _FAST_DROP_MAX_F:
        fog_dst = torch.clamp(tasks.fog, 0, F - 1)
        droppy = (
            (fogs.q_len >= spec.queue_capacity)
            & (fogs.current_task != NO_TASK)
            & fog_alive
        )
        fast_drop = arr_full & droppy[fog_dst.long()]
        tasks = tasks.replace(
            stage=torch.where(fast_drop, _i8(_ST_DROPPED, dev), tasks.stage)
        )
        arr_full = arr_full & ~fast_drop
        memb = _per_fog(fast_drop, fog_dst, F)  # (F, T)
        n_fast_f = _isum(memb, 1)
        svc_fast_f = _mips_sum64(memb, tasks.mips_req).float() / torch.clamp_min(
            fogs.mips, const(1e-9, dev)
        )
        fogs = fogs.replace(
            busy_time=fogs.busy_time + svc_fast_f,
            q_drops=fogs.q_drops + n_fast_f,
        )
        n_fast = _isum(n_fast_f)
    rot, state = _rot_and_defer(spec, state, arr_full, K)
    idx, idxc, _ = _compact(arr_full, K, T, rot)
    g = idxc.long()
    return _fog_arrivals_tail(
        spec, state, cache, buf, tasks, fogs, idx, tasks.fog[g],
        tasks.t_at_fog[g], tasks.mips_req[g], n_fast, n_fast_f,
    )


def _fog_arrivals_tail(
    spec, state, cache, buf, tasks, fogs, idx, fog_g, t_af_g, mips_g,
    n_fast, n_fast_f, tp=None,
):
    """Assignment and queueing over the window (task ids ``idx``, padded
    with the invalid id, and their fog, arrival time and MIPS): idle fogs
    take their earliest arrival, the rest enter the FIFO in (time,
    position) order, ranks and per-fog reductions from
    :func:`plan_arrivals`.  Under ``tp`` every shard runs it on the same
    window, which keeps the replicated fog and queue state coherent, and
    task writes land on the owning shard."""
    F, U, S = spec.n_fogs, spec.n_users, spec.max_sends_per_user
    T_id = _task_id_end(spec, tp)
    W = idx.shape[0]
    dev = idx.device
    inf_t = torch.full((), _INF, dtype=_F32, device=dev)
    zero = torch.zeros((), dtype=_F32, device=dev)
    fog_alive = state.nodes.alive[U: U + F]
    valid = idx < T_id
    fog_gc = torch.clamp(fog_g, 0, F - 1).long()
    user_g = torch.div(idx.clamp(0, T_id - 1).long(), S, rounding_mode="floor")
    d2b_u = _user_delays(cache, tp)

    idle = fogs.current_task == NO_TASK
    dead_dst = valid & ~fog_alive[fog_gc]
    arr = valid & ~dead_dst
    per_fog_arr = _per_fog(arr, fog_g, F)
    mips_sum = _mips_sum64(per_fog_arr, mips_g).float()
    plan = plan_arrivals(arr, fog_g, t_af_g, F, idle, per_fog=per_fog_arr)

    # immediate assignment on idle fogs; the head's arrival time and MIPS
    # are window columns
    a_pos = plan.assign_task
    assigned = a_pos != NO_TASK
    a_posc = torch.clamp(a_pos, 0, W - 1).long()
    a_task = torch.where(assigned, idx[a_posc], NO_TASK).to(_I32)
    a_taskc = torch.clamp(a_task, 0, T_id - 1).long()
    t_start = torch.maximum(t_af_g[a_posc], fogs.free_since)
    svc_a = _svc_time(mips_g[a_posc], fogs.mips)
    d_fb = cache.d2b[U: U + F]
    scat_a = _own_rows(torch.where(assigned, a_task, T_id), tp)
    tasks = tasks.replace(
        t_service_start=set_drop(
            tasks.t_service_start, scat_a, torch.where(assigned, t_start, zero)
        ),
    )
    if not spec.derive_acks:
        t_ack5 = t_start + d_fb + d2b_u[torch.div(a_taskc, S, rounding_mode="floor")]
        tasks = tasks.replace(
            t_ack5=set_drop(tasks.t_ack5, scat_a, torch.where(assigned, t_ack5, zero)),
        )
    fogs = fogs.replace(
        current_task=torch.where(assigned, a_task, fogs.current_task),
        busy_until=torch.where(assigned, t_start + svc_a, fogs.busy_until),
    )

    # queue the rest (rank shifts by 1 where the head got assigned)
    assigned_g = assigned[fog_gc]
    a_task_g = a_task[fog_gc]
    got_head = assigned_g & idle[fog_gc]
    eff_rank = torch.where(arr, plan.rank - got_head.to(_I32), -1).to(_I32)
    to_queue = arr & (eff_rank >= 0) & (idx != a_task_g)
    queue, q_len, enq_ok, dropped = batched_enqueue(
        fogs.queue, fogs.q_head, fogs.q_len, to_queue, fog_g, eff_rank, idx,
    )
    assigned_row = arr & (idx == a_task_g)
    stage_k = torch.where(
        enq_ok, _i8(_ST_QUEUED, dev),
        torch.where(
            (to_queue & ~enq_ok) | dead_dst, _i8(_ST_DROPPED, dev),
            torch.where(
                assigned_row, _i8(_ST_RUNNING, dev), _i8(_ST_TASK_INFLIGHT, dev)
            ),
        ),
    )
    rows = _own_rows(idx, tp)
    tasks = tasks.replace(
        stage=set_drop(tasks.stage, rows, stage_k),
        t_q_enter=set_drop(tasks.t_q_enter, rows, torch.where(enq_ok, t_af_g, inf_t)),
    )
    if not spec.derive_acks:
        a4 = t_af_g + d_fb[fog_gc] + d2b_u[user_g]
        tasks = tasks.replace(
            t_ack4_queued=set_drop(
                tasks.t_ack4_queued, rows, torch.where(enq_ok, a4, inf_t)
            ),
        )
    acked = (assigned_g & (idx == a_task_g)) | enq_ok
    sums = _isum(torch.stack([to_queue & ~enq_ok, dead_dst, acked]).to(_I32), 1)
    arr_per_fog = plan.counts + n_fast_f
    fogs = fogs.replace(
        queue=queue,
        q_len=q_len,
        q_drops=fogs.q_drops + dropped,
        busy_time=fogs.busy_time + mips_sum / torch.clamp_min(
            fogs.mips, const(1e-9, dev)
        ),
    )
    metrics = state.metrics.replace(
        n_dropped=state.metrics.n_dropped + sums[0] + sums[1] + n_fast
    )
    buf = buf._replace(
        tx_f=buf.tx_f + arr_per_fog,
        rx_f=buf.rx_f + arr_per_fog,
        tx_b=buf.tx_b + sums[2],
        rx_b=buf.rx_b + sums[2],
        rx_u=add_drop(buf.rx_u, _user_rows(user_g, tp), acked.to(_I32)),
    )
    return state.replace(tasks=tasks, fogs=fogs, metrics=metrics), buf


# ----------------------------------------------------------------------
# the v1/v2 app generations: POOL fogs, the broker's own pool, adverts
# ----------------------------------------------------------------------

def _adv_periods(spec, tick: torch.Tensor) -> torch.Tensor:
    """``floor(t / adv_interval)`` at ``t = tick * dt``, as XLA compiles
    it: the division by a literal becomes a product with its float32
    reciprocal, and the two constant factors fold into one, so the tick
    (as float32) is multiplied once by ``float32(dt * (1 / adv_interval))``
    (the dumped CPU program of ``floor(tick * dt / adv)``)."""
    f32 = np.float32
    rate = f32(spec.dt) * (f32(1.0) / f32(spec.adv_interval))
    return torch.floor(tick.to(_F32) * const(float(rate), tick.device))


def _phase_periodic_adverts(spec, state, cache):
    """v1/v2 fogs re-advertise every ``adv_interval``
    (ComputeBrokerApp2.cc:219): fired on the tick holding each multiple of
    the interval, carrying the fog's current MIPS (in the POOL model the
    remaining pool) and landing one fog-to-broker hop after the fire."""
    F, U = spec.n_fogs, spec.n_users
    k0 = _adv_periods(spec, state.tick)
    fire = (_adv_periods(spec, state.tick + 1) > k0) & state.nodes.alive[U: U + F]
    t_fire = (k0 + 1.0) * const(spec.adv_interval, k0.device)
    pool = spec.fog_model == int(FogModel.POOL)
    adv_mips = state.fogs.pool_avail if pool else state.fogs.mips
    b = state.broker
    return state.replace(broker=b.replace(
        adv_val_mips=torch.where(fire, adv_mips, b.adv_val_mips),
        adv_val_busy=torch.where(fire, state.fogs.busy_time, b.adv_val_busy),
        adv_arrive_t=torch.where(fire, t_fire + cache.d2b[U: U + F], b.adv_arrive_t),
    ))


def _phase_pool_completions(spec, state, cache, buf, t1):
    """POOL tasks whose requiredTime expired release their MIPS
    (``releaseResource``, ComputeBrokerApp2.cc:222-245), all that expired
    by ``t1`` (up to K a tick, the rest a later tick); v2 relays the
    status-6 Puback to the client, v1's broker drops the fog's TaskAck
    (BrokerBaseApp.cc:142-147), so ``app_gen == 1`` records no t_ack6.
    The per-fog refunds are sums of integer MIPS below 2^24: exact."""
    tasks = state.tasks
    T, F, K = spec.task_capacity, spec.n_fogs, spec.window
    U, S = spec.n_users, spec.max_sends_per_user
    dev = t1.device
    comp_full = (
        (tasks.stage == _ST_RUNNING) & (tasks.fog >= 0) & (tasks.t_complete <= t1)
    )
    rot, state = _rot_and_defer(spec, state, comp_full, K)
    idx, idxc, valid = _compact(comp_full, K, T, rot)
    g = idxc.long()
    fog_g = torch.clamp(tasks.fog[g], 0, F - 1)
    mips_g = tasks.mips_req[g]
    user_g = torch.div(g, S, rounding_mode="floor")
    per_fog_v = _per_fog(valid, fog_g, F)
    pool_avail = state.fogs.pool_avail + torch.where(
        per_fog_v, mips_g[None, :], 0.0
    ).sum(dim=1)
    tasks = tasks.replace(stage=set_drop(tasks.stage, idx, _i8(_ST_DONE, dev)))
    if spec.app_gen >= 2:
        t_ack6 = tasks.t_complete[g] + cache.d2b[fog_g.long() + U] + cache.d2b[user_g]
        tasks = tasks.replace(
            t_ack6=set_drop(tasks.t_ack6, idx, torch.where(valid, t_ack6, _INF)),
        )
    n_comp = _isum(valid)
    metrics = state.metrics.replace(n_completed=state.metrics.n_completed + n_comp)
    buf = buf._replace(tx_f=buf.tx_f + _isum(per_fog_v, 1), rx_b=buf.rx_b + n_comp)
    if spec.app_gen >= 2:
        buf = buf._replace(
            tx_b=buf.tx_b + n_comp, rx_u=add_drop(buf.rx_u, user_g, valid.to(_I32)),
        )
    return state.replace(
        tasks=tasks, fogs=state.fogs.replace(pool_avail=pool_avail), metrics=metrics,
    ), buf


def _phase_pool_arrivals(spec, state, cache, buf, t1):
    """POOL fogs accept or reject arriving tasks against their MIPS pool
    (ComputeBrokerApp2.cc:258-310): accept iff the task's MIPS lies
    strictly below the pool (:269), which it debits, expiring at ``now +
    requiredTime``; a rejection's TaskAck is ignored by every broker.
    Same-tick arrivals at one fog are checked in arrival order, rank r in
    sub-phase r of ``spec.pool_phases``; deeper ranks stay in flight and
    are ranked again next tick.  The ranks come from :func:`plan_arrivals`
    (the arrival kernel on the card)."""
    tasks = state.tasks
    T, F, K = spec.task_capacity, spec.n_fogs, spec.window
    U = spec.n_users
    dev = t1.device
    fog_alive = state.nodes.alive[U: U + F]
    arr_full = (tasks.stage == _ST_TASK_INFLIGHT) & (tasks.t_at_fog <= t1)
    rot, state = _rot_and_defer(spec, state, arr_full, K)
    idx, idxc, valid = _compact(arr_full, K, T, rot)
    g = idxc.long()
    fog_g = tasks.fog[g]
    fog_gc = torch.clamp(fog_g, 0, F - 1).long()
    t_af_g = tasks.t_at_fog[g]
    mips_g = tasks.mips_req[g]
    dead_dst = valid & ~fog_alive[fog_gc]
    arr = valid & ~dead_dst
    per_fog_arr = _per_fog(arr, fog_g, F)
    plan = plan_arrivals(
        arr, fog_g, t_af_g, F, torch.ones((F,), dtype=torch.bool, device=dev),
        per_fog=per_fog_arr,
    )
    pool = state.fogs.pool_avail
    accept = torch.zeros_like(valid)
    reject = torch.zeros_like(valid)
    for r in range(spec.pool_phases):
        at_r = plan.rank == r
        sel_f = per_fog_arr & at_r[None, :]
        # one row a fog at most: the sum is that row's MIPS
        req_f = torch.where(sel_f, mips_g[None, :], 0.0).sum(dim=1)
        has_f = sel_f.any(dim=1)
        acc_f = has_f & (req_f < pool)  # strict <, ComputeBrokerApp2.cc:269
        pool = pool - torch.where(acc_f, req_f, 0.0)
        sel = arr & at_r
        accept = accept | (sel & acc_f[fog_gc])
        reject = reject | (sel & has_f[fog_gc] & ~acc_f[fog_gc])
    inf_t = const(_INF, dev)
    stage_k = torch.where(
        accept, _i8(_ST_RUNNING, dev),
        torch.where(
            reject, _i8(_ST_REJECTED, dev),
            torch.where(dead_dst, _i8(_ST_DROPPED, dev), tasks.stage[g]),
        ),
    )
    tasks = tasks.replace(
        stage=set_drop(tasks.stage, idx, stage_k),
        t_service_start=set_drop(
            tasks.t_service_start, idx, torch.where(accept, t_af_g, inf_t)
        ),
        t_complete=set_drop(
            tasks.t_complete, idx,
            torch.where(accept, t_af_g + const(spec.required_time, dev), inf_t),
        ),
    )
    sums = _isum(torch.stack([reject, dead_dst, accept | reject]), 1)
    metrics = state.metrics.replace(
        n_rejected=state.metrics.n_rejected + sums[0],
        n_dropped=state.metrics.n_dropped + sums[1],
    )
    # arrivals are fog rx; each decided arrival sends a TaskAck to the broker
    buf = buf._replace(
        tx_f=buf.tx_f + _isum(per_fog_arr & (accept | reject)[None, :], 1),
        rx_f=buf.rx_f + _isum(per_fog_arr, 1),
        rx_b=buf.rx_b + sums[2],
    )
    return state.replace(
        tasks=tasks, fogs=state.fogs.replace(pool_avail=pool), metrics=metrics,
    ), buf


def _phase_local_completions(spec, state, cache, buf, t1):
    """v1 broker-local tasks expire: status-6 straight to the client
    (``releaseResource``, BrokerBaseApp.cc:369-394), the pool refunded
    unless ``bug_compat.local_pool_leak`` (the reference never stores the
    request, :208, so its pool only shrinks)."""
    tasks = state.tasks
    T, K, S = spec.task_capacity, spec.window, spec.max_sends_per_user
    dev = t1.device
    comp_full = (tasks.stage == _ST_LOCAL_RUN) & (tasks.t_complete <= t1)
    rot, state = _rot_and_defer(spec, state, comp_full, K)
    idx, idxc, valid = _compact(comp_full, K, T, rot)
    g = idxc.long()
    user_g = torch.div(g, S, rounding_mode="floor")
    t_ack6 = tasks.t_complete[g] + cache.d2b[user_g]
    tasks = tasks.replace(
        stage=set_drop(tasks.stage, idx, _i8(_ST_DONE, dev)),
        t_ack6=set_drop(tasks.t_ack6, idx, torch.where(valid, t_ack6, _INF)),
    )
    b = state.broker
    if not spec.bug_compat.local_pool_leak:
        # integer MIPS below 2^24: exact in any order
        b = b.replace(
            local_pool=b.local_pool + torch.where(valid, tasks.mips_req[g], 0.0).sum()
        )
    n_comp = _isum(valid)
    metrics = state.metrics.replace(n_completed=state.metrics.n_completed + n_comp)
    buf = buf._replace(
        tx_b=buf.tx_b + n_comp, rx_u=add_drop(buf.rx_u, user_g, valid.to(_I32)),
    )
    return state.replace(tasks=tasks, broker=b, metrics=metrics), buf


def _phase_v2_release(spec, state, cache, buf, t1, before_broker,
                      resched_t=None, prerefunded=None):
    """The v2 broker's shared-timer releaseResource (BrokerBaseApp2.cc:
    284-312 through the self-message of :221-224).  One RELEASERESOURCE
    self-message is pending at a time and each local accept reschedules
    it, so only the last accept's expiry fires; a firing releases one
    stored request, the first in decision order (ties by slot) whose
    requiredTime passed before the fire: the pool gains its MIPS (an
    offloaded request was stored without a debit, so its release inflates
    the pool), a status-6 goes to the client, and a local task completes.

    Called before the broker for a fire that precedes every pending
    arrival, and after it for a fire this tick's decisions did not cancel
    (``resched_t``: the timer that replaces a fire the broker's scan
    already saw; ``prerefunded``: that scan applied the refund)."""
    tasks, b = state.tasks, state.broker
    T, S, U = spec.task_capacity, spec.max_sends_per_user, spec.n_users
    dev = t1.device
    inf = const(_INF, dev)
    fire_t = b.release_timer_t
    if before_broker:
        tab2 = tasks.t_at_broker.reshape(U, S)
        arr2 = (tasks.stage.reshape(U, S) == _ST_PUB_INFLIGHT) & (tab2 <= t1)
        t_first = torch.where(arr2, tab2, inf).amin()
        fire = (fire_t <= t1) & (fire_t <= t_first)
    else:
        fire = fire_t <= t1
    expiry = tasks.t_at_broker + const(spec.required_time, dev)
    open_m = (tasks.req_open > 0) & (expiry < fire_t)
    key1 = torch.where(open_m, tasks.t_at_broker, inf)
    cand = open_m & (key1 == key1.amin())
    sel = torch.where(cand, torch.arange(T, dtype=_I32, device=dev), T).amin()
    have = fire & (sel < T)
    selc = torch.clamp(sel, 0, T - 1)
    user_sel = torch.div(selc, S, rounding_mode="floor")
    ack_t = fire_t + at(cache.d2b, user_sel)
    was_local = at(tasks.stage, selc) == _ST_LOCAL_RUN
    next_t = inf if resched_t is None else resched_t
    refund = have if prerefunded is None else have & ~prerefunded
    b = b.replace(
        local_pool=b.local_pool + torch.where(refund, at(tasks.mips_req, selc), 0.0),
        release_timer_t=torch.where(fire, next_t, fire_t),
    )
    scat = torch.where(have, sel, T).reshape(1)
    scat_local = torch.where(have & was_local, sel, T).reshape(1)
    # a duplicate status-6 for an offloaded request: the client keeps the
    # first to land (mqttApp2.cc:279-291)
    ack6 = at(tasks.t_ack6, selc)
    tasks = tasks.replace(
        req_open=set_drop(tasks.req_open, scat, torch.zeros((), dtype=torch.int8, device=dev)),
        t_ack6=set_drop(tasks.t_ack6, scat, torch.minimum(ack6, ack_t).reshape(1)),
        stage=set_drop(tasks.stage, scat_local, _i8(_ST_DONE, dev)),
        t_complete=set_drop(tasks.t_complete, scat_local, fire_t.reshape(1)),
    )
    metrics = state.metrics.replace(
        n_completed=state.metrics.n_completed + (have & was_local).to(_I32)
    )
    buf = buf._replace(
        tx_b=buf.tx_b + have.to(_I32),
        rx_u=add_drop(buf.rx_u, user_sel.reshape(1), have.to(_I32).reshape(1)),
    )
    return state.replace(tasks=tasks, broker=b, metrics=metrics), buf


def _link_queues(spec, state, net, tx_all, dv: DynSpec):
    """The wired links' DropTail queues (``wireless5.ini:72-73``): this
    tick's egress bytes join each wired node's backlog, the link drains
    ``link_drain_bytes`` a tick, and what passes ``link_queue_frames``
    frames overflows; the overflow's share of the tick's bytes is next
    tick's tail-drop probability, and the overflow in frames is counted.
    Its float32 total is XLA's CPU reduction (:func:`..f32math.xla_sum`),
    and the division by the frame size a product with its reciprocal."""
    dev = tx_all.device
    tb = float(spec.task_bytes)
    add_bytes = tx_all.to(_F32) * const(tb, dev)
    raw = state.nodes.link_backlog + add_bytes - knob(dv.link_drain_bytes, dev)
    cap = const(float(spec.link_queue_frames * spec.task_bytes), dev)
    wired = ~net.is_wireless
    zero = const(0.0, dev)
    backlog = torch.where(wired, torch.minimum(torch.clamp_min(raw, 0.0), cap), zero)
    overflow = torch.where(wired, torch.clamp_min(raw - cap, 0.0), zero)
    drop_p = torch.clamp(overflow / torch.clamp_min(add_bytes, 1.0), 0.0, 1.0)
    n_drops = div_knob(xla_sum(overflow), tb).to(_I32)
    return state.replace(
        nodes=state.nodes.replace(link_backlog=backlog, link_drop_p=drop_p),
        metrics=state.metrics.replace(
            n_link_drops=state.metrics.n_link_drops + n_drops
        ),
    )


# ----------------------------------------------------------------------
# set-up, the tick and the runner
# ----------------------------------------------------------------------

def prime_initial_advertisements(
    spec: WorldSpec, state: WorldState, net: NetParams, t_adv: float = 0.01,
    fog_start_t: float = 0.0,
) -> WorldState:
    """Stamp fog registration and first advertisement arrival times."""
    cache = associate(net, state.nodes.pos, state.nodes.alive, spec.broker_index)
    F, U = spec.n_fogs, spec.n_users
    dev = state.t.device
    d_fb = cache.d2b[U: U + F]
    adv_mips = (
        state.fogs.pool_avail if spec.fog_model == int(FogModel.POOL)
        else state.fogs.mips
    )
    fs = const(fog_start_t, dev)
    b = state.broker
    if spec.connect_gating:
        b = b.replace(
            register_t=fs + d_fb,
            registered=torch.zeros((F,), dtype=torch.bool, device=dev),
        )
        adv0 = fs + 2.0 * d_fb
    else:
        adv0 = torch.zeros((), dtype=_F32, device=dev)
    b = b.replace(
        adv_val_mips=adv_mips.clone(),
        adv_val_busy=state.fogs.busy_time.clone(),
        adv_arrive_t=adv0 + const(t_adv, dev) + d_fb,
    )
    return state.replace(broker=b)


def _span(name: str):
    """``record_function("phase_<name>")`` while a profiler records (the
    counterpart of JAX's ``named_scope``), else nothing at all."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function("phase_" + name)
    return contextlib.nullcontext()


class _PhaseBook:
    """The phase harness of a tick (JAX ``make_step``'s ``_ph``): each
    phase runs under its profiler span; with an ``activity`` (telemetry
    on: a thunk reading the tick's counters, such as
    :func:`..telemetry.metrics.tick_activity`) it is read after every
    phase (a phase's closing bracket is the next one's opening bracket),
    and the deltas are stacked, differenced and added into their slots
    once, at the end of the tick.  No value leaves the device."""

    def __init__(self, activity: Optional[Callable[[], torch.Tensor]] = None):
        self.activity = activity
        self.acts: List[torch.Tensor] = [] if activity is None else [activity()]
        self.slots: List[int] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        """``with book.phase(name): <the phase>``: its span, then its
        bracket, read after the body has rebound the tick's state."""
        with _span(name):
            yield
        if self.activity is not None:
            self.acts.append(self.activity())
            self.slots.append(PHASE_INDEX[name])

    def vector(self, n_phases: int, dev) -> torch.Tensor:
        """(n_phases,) int32: each slot's summed deltas (wrapping, as
        JAX's int32 sums do)."""
        acts = torch.stack(self.acts)
        idx = kept_tensor(tuple(self.slots), torch.long, dev)
        return torch.zeros((n_phases,), dtype=_I32, device=dev).index_add(
            0, idx, acts[1:] - acts[:-1]
        )


def _phase_latency_hist(spec: WorldSpec, state: WorldState, t1) -> WorldState:
    """The streaming latency histogram (``engine._phase_latency_hist``):
    every task whose status-6 ack landed by ``t1`` and not yet counted."""
    return state.replace(telem=accumulate_latency(spec, state.telem, state.tasks, t1))


def _phase_journeys(spec: WorldSpec, state: WorldState, t1) -> WorldState:
    """The journey tap (``engine._phase_journeys``): the sampled tasks'
    rows diffed against last tick's, one ring row an edge."""
    return state.replace(telem=journey_tick(
        spec, state.telem, state.tasks, t1,
        chaos=state.chaos if spec.chaos else None,
        hier=state.hier if spec.hier_active else None,
    ))


def _phase_telemetry(spec: WorldSpec, state: WorldState, t1, phase_work) -> WorldState:
    """Plane-1 accumulation (``engine._phase_telemetry``): the end-of-tick
    fog, learner and counter snapshot, the phase deltas, the chaos columns
    (fogs down, crash losses) and a federated world's per-broker load
    (busy owned fogs over owned fogs)."""
    U, F = spec.n_users, spec.n_fogs
    chaos = fogs_down = hier_load = None
    if spec.chaos:
        chaos = state.chaos
        fogs_down = _isum(~state.nodes.alive[U: U + F])
    if spec.telemetry_hier_brokers > 0:
        owned = state.hier.fog_broker[None, :] == torch.arange(
            spec.n_brokers, dtype=_I32, device=t1.device
        )[:, None]
        if spec.fog_model == int(FogModel.POOL):
            busy = state.fogs.pool_avail < state.fogs.mips
        else:
            busy = state.fogs.current_task != NO_TASK
        n_owned = _isum(owned, dim=1).to(_F32)
        hier_load = _isum(owned & busy[None, :], dim=1).to(_F32) / torch.clamp_min(
            n_owned, 1.0
        )
    return state.replace(telem=accumulate_tick(
        spec, state.telem, state.fogs, state.learn, state.metrics, state.tick,
        t1, phase_work, chaos=chaos, fogs_down=fogs_down, hier_load=hier_load,
    ))


def make_step(spec: WorldSpec, with_aux: bool = False):
    """The single-tick transition ``step(state, net, bounds, static_cache,
    dyn)`` for ``spec`` (the per-phase order of the JAX ``make_step``).
    ``with_aux``: the same tick returning ``(state, aux)``, ``aux``
    holding the tick's per-AP association counts (``{"n_assoc": (A,)
    int32}``) for the series recorder.

    ``dyn``: the promoted knobs as a device operand
    (:func:`..dynspec.dyn_to_device`; under ``vmap`` one row of
    :func:`..dynspec.dyn_rows`), with ``spec`` their shape key.  ``None``
    reads the spec's own values as host constants.  The two differ where
    the reference divides by a knob (:func:`..dynspec.div_knob`)."""
    spec.validate()
    dv_spec = dyn_of(spec)

    def step(
        state: WorldState, net: NetParams, bounds: MobilityBounds,
        static_cache: Optional[LinkCache] = None, dyn: Optional[DynSpec] = None,
    ) -> WorldState:
        dv = dv_spec if dyn is None else dyn
        dev = state.t.device
        dt = const(spec.dt, dev)
        t0 = state.tick.to(_F32) * dt
        t1 = (state.tick + 1).to(_F32) * dt
        U, F = spec.n_users, spec.n_fogs
        buf = TickBuf(
            tx_u=torch.zeros((U,), dtype=_I32, device=dev),
            rx_u=torch.zeros((U,), dtype=_I32, device=dev),
            tx_f=torch.zeros((F,), dtype=_I32, device=dev),
            rx_f=torch.zeros((F,), dtype=_I32, device=dev),
            tx_b=torch.zeros((), dtype=_I32, device=dev),
            rx_b=torch.zeros((), dtype=_I32, device=dev),
        )
        state = state.replace(
            metrics=state.metrics.replace(
                n_deferred=torch.zeros((), dtype=_I32, device=dev)
            )
        )
        # mobility, then this tick's association on the new positions
        if spec.assume_static and static_cache is not None:
            cache = static_cache
        else:
            if spec.assume_static and net.mac_loss_tab.shape[0] > 0:
                raise ValueError(STATIC_MAC_ERR)
            pos, vel = step_mobility(state.nodes, bounds, t1, spec.dt)
            state = state.replace(nodes=state.nodes.replace(pos=pos, vel=vel))
            offered = None
            if net.mac_loss_tab.shape[0] > 0:
                # Bianchi worlds key each cell's MAC on its offered load
                offered = offered_rate_vector(
                    spec, state.nodes.alive[:U], state.users, t0, dv
                )
            cache = associate(
                net, pos, state.nodes.alive, spec.broker_index, offered
            )

        if spec.wired_queue_enabled:
            # DropTail backpressure: last tick's egress backlog serialises
            # ahead of new messages, both endpoints' backlogs on the
            # shared node-to-broker delay (the reference's symmetric
            # simplification); XLA contracts the node's own term into a
            # multiply-add
            backlog = state.nodes.link_backlog
            inv_rate = knob(dv.link_inv_rate, dev)
            qdelay_b = backlog[spec.broker_index] * inv_rate
            cache = cache.replace(
                d2b=fma(backlog, inv_rate.expand_as(backlog), cache.d2b) + qdelay_b
            )

        # the phase harness: every phase under its span; with telemetry on,
        # its work delta booked to its PHASES slot at the end of the tick
        book = _PhaseBook(
            (lambda: tick_activity(state.metrics, buf)) if spec.telemetry else None
        )

        if spec.chaos:
            # the degraded broker->fog delays, then the lifecycle, so this
            # tick's edges are in nodes.alive before any dispatch
            if spec.chaos_rtt_amp > 0 or spec.chaos_rtt_burst_prob > 0:
                cache = _chaos_rtt(spec, state, cache, t0, dv)
            with book.phase("chaos"):
                state, buf = _phase_chaos(spec, state, cache, buf, t0, t1, dv)

        if spec.connect_gating:
            with book.phase("connect"):
                state, buf = _phase_connect(spec, state, cache, buf, t0, t1)
        with book.phase("adverts"):
            state = _phase_adverts(state, t1)
        pool = spec.fog_model == int(FogModel.POOL)
        if spec.adv_periodic and not pool:
            with book.phase("adverts"):
                state = _phase_periodic_adverts(spec, state, cache)
        with book.phase("spawn"):
            if spec.max_sends_per_tick > 1:
                state, buf = _phase_spawn_multi(spec, state, net, cache, buf, t0, t1, dv)
            else:
                state, buf = _phase_spawn(spec, state, net, cache, buf, t0, t1, dv)
        if _hier_migrate_on(spec):
            # matured publishes leave a saturated or dead domain before
            # its broker decides them
            with book.phase("broker_migrate"):
                state, buf = _phase_broker_migrate(spec, state, buf, t1, dv)
        v2_local = spec.policy == int(Policy.LOCAL_FIRST) and spec.v2_local_broker
        if v2_local:  # shared-timer fires that precede every arrival
            with book.phase("v2_release_pre"):
                state, buf = _phase_v2_release(spec, state, cache, buf, t1, True)
        v2_resched = None
        with book.phase("broker"):
            if broker_dense_ok(spec):
                state, buf = _phase_broker_dense(spec, state, cache, buf, t1)
            else:
                state, buf, v2_resched = _phase_broker(spec, state, cache, buf, t1)
        if v2_local:  # fires this tick's decisions did not cancel
            rs, pre = (None, None) if v2_resched is None else v2_resched
            with book.phase("v2_release_post"):
                state, buf = _phase_v2_release(
                    spec, state, cache, buf, t1, False, resched_t=rs, prerefunded=pre
                )
        if F > 0 and pool:
            if spec.adv_periodic:
                # the periodic advert carries the pool at its fire time:
                # the fog events up to the boundary settle first
                t_fire = (_adv_periods(spec, state.tick) + 1.0) * const(spec.adv_interval, dev)
                t_a = torch.minimum(t_fire, t1)
                with book.phase("pool_completions"):
                    state, buf = _phase_pool_completions(spec, state, cache, buf, t_a)
                with book.phase("pool_arrivals"):
                    state, buf = _phase_pool_arrivals(spec, state, cache, buf, t_a)
                with book.phase("adverts"):
                    state = _phase_periodic_adverts(spec, state, cache)
            with book.phase("pool_completions"):
                state, buf = _phase_pool_completions(spec, state, cache, buf, t1)
            with book.phase("pool_arrivals"):
                state, buf = _phase_pool_arrivals(spec, state, cache, buf, t1)
        elif F > 0:
            for _ in range(spec.completions_per_tick):
                with book.phase("completions"):
                    state, buf = _phase_completions(spec, state, cache, buf, t1)
            with book.phase("fog_arrivals"):
                state, buf = _phase_fog_arrivals(spec, state, cache, buf, t1)
        if spec.policy == int(Policy.LOCAL_FIRST) and not spec.v2_local_broker:
            with book.phase("local_completions"):
                state, buf = _phase_local_completions(spec, state, cache, buf, t1)
        if spec.learn_active:
            # after the fog phases, so an ack landing this tick credits now
            with book.phase("learn_credit"):
                state = _phase_learn_credit(spec, state, t1, dv)
        if spec.telemetry_hist:
            # after the fog phases and the credit, so an ack landing this
            # tick streams now (it books no counter: no bracket needed)
            with _span("latency_hist"):
                state = _phase_latency_hist(spec, state, t1)

        rest = torch.zeros((spec.n_aps + spec.n_routers,), dtype=_I32, device=dev)
        tx_all = torch.cat([buf.tx_u, buf.tx_f, buf.tx_b[None], rest])
        rx_all = torch.cat([buf.rx_u, buf.rx_f, buf.rx_b[None], rest])
        nodes = state.nodes.replace(
            tx_count=state.nodes.tx_count + tx_all,
            rx_count=state.nodes.rx_count + rx_all,
        )
        if spec.n_aps > 0:
            a0, a1 = spec.ap_slice
            nodes = nodes.replace(
                assoc_sum=torch.cat([
                    nodes.assoc_sum[:a0], nodes.assoc_sum[a0:a1] + cache.n_assoc,
                    nodes.assoc_sum[a1:],
                ])
            )
        state = state.replace(nodes=nodes)
        if spec.wired_queue_enabled:
            state = _link_queues(spec, state, net, tx_all, dv)
            nodes = state.nodes
        if spec.energy_enabled:
            # battery drain and harvest; a fog in service (a POOL fog with
            # any of its pool lent out) draws compute power
            fog_busy = (
                state.fogs.pool_avail < state.fogs.mips if pool
                else state.fogs.current_task != NO_TASK
            )
            computing = torch.cat([
                torch.zeros((U,), dtype=torch.bool, device=dev),
                fog_busy,
                torch.zeros((spec.n_nodes - U - F,), dtype=torch.bool, device=dev),
            ])
            with _span("energy"):
                energy, alive = step_energy(
                    dv, nodes.energy, nodes.energy_capacity, nodes.has_energy,
                    nodes.alive, t1, tx_all, rx_all, computing,
                )
            nodes = nodes.replace(energy=energy, alive=alive)
        state = state.replace(nodes=nodes)
        if spec.journey_active:
            # after every task-writing phase, before the telemetry fold
            with _span("journeys"):
                state = _phase_journeys(spec, state, t1)
        if spec.telemetry:
            # after every phase booked its work, before the tick advances
            # (the reservoir row is keyed on this tick's index)
            with _span("telemetry"):
                state = _phase_telemetry(
                    spec, state, t1, book.vector(spec.telemetry_phases, dev)
                )
        state = state.replace(
            t=t1,
            tick=state.tick + 1,
            metrics=state.metrics.replace(
                n_deferred_max=torch.maximum(
                    state.metrics.n_deferred_max, state.metrics.n_deferred
                )
            ),
        )
        if with_aux:
            return state, {"n_assoc": cache.n_assoc}
        return state

    return step


def _finalize_derived_acks(
    spec: WorldSpec, state: WorldState, cache: LinkCache
) -> WorldState:
    """Reconstruct the ack columns skipped under ``spec.derive_acks``, with
    the per-tick phases' float32 arithmetic and operand order."""
    t = state.tasks
    U, S, F, T = spec.n_users, spec.max_sends_per_user, spec.n_fogs, spec.task_capacity
    dev = t.stage.device
    d_bu = cache.d2b[:U][:, None]
    if F > 0:
        d_bf = cache.d2b[U + torch.clamp(t.fog, 0, F - 1).long()].reshape(U, S)
    else:
        d_bf = torch.zeros((U, S), dtype=_F32, device=dev)
    st2 = t.stage.reshape(U, S)
    qe2 = t.t_q_enter.reshape(U, S)
    ss2 = t.t_service_start.reshape(U, S)
    decided = (st2 != _ST_UNUSED) & (st2 != _ST_PUB_INFLIGHT) & (st2 != _ST_LOST)
    if spec.n_brokers > 1:
        # a hop-exhausted task never reached a decide phase: no ack
        decided = decided & (st2 != _ST_HOP_EXHAUSTED)
    queued = torch.isfinite(qe2)
    assigned = torch.isfinite(ss2) & ~queued
    done = st2 == _ST_DONE
    return state.replace(
        tasks=t.replace(
            t_ack4_fwd=torch.where(
                decided, t.t_at_broker.reshape(U, S) + d_bu, _INF
            ).reshape(T),
            t_ack4_queued=torch.where(queued, qe2 + d_bf + d_bu, _INF).reshape(T),
            t_ack5=torch.where(assigned, ss2 + d_bf + d_bu, _INF).reshape(T),
            t_ack6=torch.where(
                done, t.t_complete.reshape(U, S) + d_bf + d_bu, _INF
            ).reshape(T),
            queue_time_ms=torch.where(
                queued & torch.isfinite(ss2), (ss2 - qe2) * 1e3, _INF
            ).reshape(T),
        )
    )


def _runner_setup(spec: WorldSpec, net: NetParams, dev, bounds, n_ticks):
    """``run``'s checks and defaults: ``(bounds, n_ticks)``."""
    if spec.derive_acks and not spec.assume_static:
        raise ValueError("derive_acks needs assume_static (one static link cache)")
    if spec.assume_static and net.mac_loss_tab.shape[0] > 0:
        raise ValueError(STATIC_MAC_ERR)
    if bounds is None:
        bounds = default_bounds(device=dev)
    return bounds, spec.n_ticks if n_ticks is None else n_ticks


def _static_cache(
    spec: WorldSpec, net: NetParams, state: WorldState, fused: bool = True
) -> LinkCache:
    """One association for the whole run: positions and liveness are
    constant, so no mobility or association runs a tick.  ``fused``: as
    the reference's jitted runners (``run_jit``, ``run_chunked``, the
    replica batch) compute it, inside their program; ``False``: as JAX
    ``run`` does, op by op before its scan, no multiply-add contracted
    (:func:`..net.topology.associate`)."""
    return associate(
        net, state.nodes.pos, state.nodes.alive, spec.broker_index, fused=fused
    )


def series_row(spec: WorldSpec, state: WorldState, n_assoc: torch.Tensor) -> dict:
    """One tick's row of the per-tick series (``engine.run``'s scan body
    under ``spec.record_tick_series``), read from the state after the
    tick and the tick's own association counts."""
    nodes = state.nodes
    energy = nodes.energy
    # jnp.mean: XLA's float32 sum, then the product with the reciprocal
    # of the constant count
    mean = xla_sum(energy) * const(float(np.float32(1.0) / np.float32(energy.shape[0])),
                                   energy.device)
    row = {
        "t": state.t,
        "busy_time": state.fogs.busy_time,
        "q_len": state.fogs.q_len,
        "pool_avail": state.fogs.pool_avail,
        "n_alive": _isum(nodes.alive),
        "energy_mean": mean,
        "n_assoc": n_assoc,
    }
    if spec.learn_active:
        row["learn_picks"] = state.learn.pick_count
        row["learn_lat_sum"] = state.learn.lat_sum
        row["learn_lat_cnt"] = state.learn.lat_cnt
    if spec.record_trails:
        row["pos"] = nodes.pos
    return row


class SeriesBuffer:
    """The per-tick series on the state's device: one preallocated
    ``(n, ...)`` tensor a key, one row written a tick (a device copy, no
    wait for the card), moved to the host once by :meth:`host`."""

    def __init__(self, row: dict, n: int):
        self.cols = {k: torch.empty((n,) + tuple(v.shape), dtype=v.dtype, device=v.device)
                     for k, v in row.items()}

    def write(self, i: int, row: dict) -> None:
        for k, v in row.items():
            self.cols[k][i].copy_(v)

    def host(self) -> dict:
        # keys in sorted order, as JAX's scan hands back its dict (a
        # pytree's dict children are sorted)
        return {k: self.cols[k].cpu() for k in sorted(self.cols)}


def run(
    spec: WorldSpec,
    state: WorldState,
    net: NetParams,
    bounds: Optional[MobilityBounds] = None,
    n_ticks: Optional[int] = None,
    dyn: Optional[DynSpec] = None,
) -> Tuple[WorldState, Optional[dict]]:
    """Run ``n_ticks`` (default: the spec's horizon) on the state's device.

    Returns ``(final_state, series)``: ``series`` is None unless
    ``spec.record_tick_series``, then ``{name: (n_ticks, ...) CPU tensor}``
    with JAX ``run``'s keys (``t``, ``busy_time``, ``q_len``,
    ``pool_avail``, ``n_alive``, ``energy_mean``, ``n_assoc``; a learned
    policy adds ``learn_picks``, ``learn_lat_sum``, ``learn_lat_cnt``,
    ``spec.record_trails`` adds ``pos``).  The state stays on its device;
    the loop never waits for it.  ``dyn``: the promoted knobs as a device
    operand, ``spec`` then being their shape key (``dynspec.split_spec``);
    ``None`` takes the spec's own values as host constants.
    """
    return _run(spec, state, net, bounds, n_ticks, dyn, fused_cache=False,
                record=spec.record_tick_series)


def _run(spec, state, net, bounds, n_ticks, dyn, fused_cache: bool, record: bool = False):
    """:func:`run`'s loop, the static cache built as :func:`_static_cache`
    with ``fused_cache``: ``(final, series)``, ``series`` None unless
    ``record`` (the tick with its aux, each row written into a
    :class:`SeriesBuffer`)."""
    bounds, n = _runner_setup(spec, net, state.t.device, bounds, n_ticks)
    step = make_step(spec, with_aux=record)
    static_cache = (
        _static_cache(spec, net, state, fused_cache) if spec.assume_static else None
    )
    buf = None
    if record:
        # the row's shapes and dtypes, read from the initial state
        a0, a1 = spec.ap_slice
        buf = SeriesBuffer(series_row(spec, state, torch.zeros(
            (a1 - a0,), dtype=torch.int32, device=state.t.device)), n)
    for i in range(n):
        if record:
            state, aux = step(state, net, bounds, static_cache, dyn)
            buf.write(i, series_row(spec, state, aux["n_assoc"]))
        else:
            state = step(state, net, bounds, static_cache, dyn)
    if spec.derive_acks:
        state = _finalize_derived_acks(spec, state, static_cache)
    return state, (buf.host() if record else None)


def batched_tick(
    spec: WorldSpec, net: NetParams, bounds: MobilityBounds, batch: WorldState,
    dyn_rows: Optional[DynSpec] = None, with_aux: bool = False,
):
    """``(tick, cache)``: ``tick(batch) -> batch`` advances R worlds like
    ``batch`` one tick, one ``torch.func.vmap`` of ``make_step(spec)``;
    ``cache`` is each replica's static link cache (None on a moving
    world), computed from ``batch`` as JAX computes it inside its vmap.
    ``dyn_rows`` gives each replica its own row of promoted knobs
    (``dynspec.dyn_rows``), mapped beside the state.  ``with_aux``: the
    tick returns ``(batch, aux)`` (:func:`make_step`).  The port draws no
    numbers from torch's generator, so the vmap refuses randomness."""
    step = make_step(spec, with_aux=with_aux)
    vmap = torch.func.vmap
    d_dim = None if dyn_rows is None else 0
    if not spec.assume_static:
        tick = vmap(lambda s, d: step(s, net, bounds, None, d),
                    in_dims=(0, d_dim), randomness="error")
        return (lambda s: tick(s, dyn_rows)), None
    cache = vmap(lambda s: _static_cache(spec, net, s))(batch)
    tick = vmap(lambda s, c, d: step(s, net, bounds, c, d),
                in_dims=(0, 0, d_dim), randomness="error")
    return (lambda s: tick(s, cache, dyn_rows)), cache


def run_batched(
    spec: WorldSpec,
    batch: WorldState,
    net: NetParams,
    bounds: Optional[MobilityBounds] = None,
    n_ticks: Optional[int] = None,
    dyn_rows: Optional[DynSpec] = None,
) -> Tuple[WorldState, Optional[dict]]:
    """:func:`run` for R worlds at once: ``batch`` carries a leading
    replica axis on every leaf, and ``net`` and ``bounds`` are shared.
    ``dyn_rows``: each replica's promoted knobs, every leaf with the same
    leading axis (``dynspec.dyn_rows``), ``spec`` then their shape key.

    Each tick is one call of :func:`batched_tick`, so every operation of
    the tick launches once for all R worlds; the kernels' batching rules
    (:mod:`..ops.arrival_kernels`, :mod:`..ops.cell_kernels`) lay the
    replicas' windows end to end for one kernel call.  Replica r of the
    result equals :func:`run` on replica r of ``batch``, leaf for leaf.
    With ``spec.record_tick_series`` the second item is each replica's
    series, ``(R, n_ticks, ...)`` CPU tensors under :func:`run`'s keys.
    """
    bounds, n = _runner_setup(spec, net, batch.t.device, bounds, n_ticks)
    record = spec.record_tick_series
    tick, cache = batched_tick(spec, net, bounds, batch, dyn_rows, with_aux=record)
    series = None
    if record:
        rows = torch.func.vmap(lambda s, a: series_row(spec, s, a))
        a0, a1 = spec.ap_slice
        no_assoc = torch.zeros((batch.t.shape[0], a1 - a0), dtype=torch.int32,
                               device=batch.t.device)
        buf = SeriesBuffer(rows(batch, no_assoc), n)
        for i in range(n):
            batch, aux = tick(batch)
            buf.write(i, rows(batch, aux["n_assoc"]))
        series = {k: v.transpose(0, 1) for k, v in buf.host().items()}
    else:
        for _ in range(n):
            batch = tick(batch)
    if spec.derive_acks:
        batch = torch.func.vmap(
            lambda s, c: _finalize_derived_acks(spec, s, c)
        )(batch, cache)
    return batch, series


def _promoted(spec: WorldSpec, dev) -> Tuple[WorldSpec, DynSpec]:
    """The shape key of ``spec`` and its knobs as a device operand."""
    key_spec, dyn = split_spec(spec)
    return key_spec, dyn_to_device(dyn, dev)


def run_chunked(
    spec: WorldSpec,
    state: WorldState,
    net: NetParams,
    bounds: Optional[MobilityBounds] = None,
    chunk_ticks: int = 10_000,
    callback: Optional[Callable[[WorldState, int], None]] = None,
    telemetry_stream=None,
    promote: Optional[bool] = None,
    reconfigure: Optional[Callable[[int], Optional[dict]]] = None,
    inject=None,
) -> WorldState:
    """The spec's horizon in chunks of ``chunk_ticks`` (``engine.run_chunked``),
    ``callback(state, ticks_done)`` after each; equal to one :func:`run`
    of the same path, leaf for leaf.

    ``promote`` (default :func:`..dynspec.promote_default`): the chunks
    run the shape key with the knobs as a device operand, and
    ``reconfigure(ticks_done)``, called at every interior chunk boundary,
    may return ``{field: value}`` of promoted knobs for the rest of the
    horizon (:func:`..dynspec.apply_knobs` refuses a shape-defining field
    or a gate flip).  ``promote=False`` takes the spec's values as host
    constants.  No chunk writes into a state in place, so a state kept by
    ``callback`` stays as it was handed over.  ``telemetry_stream(rows,
    ticks_done)`` (a telemetry-on spec only) gets the reservoir rows each
    chunk completed (:func:`..telemetry.metrics.reservoir_progress`).
    ``inject(state, ticks_done)``, called at every interior boundary after
    the others, returns the state the next chunk starts from (the twin's
    drain hands its queue to :func:`inject_arrivals` there).
    """
    if promote is None:
        promote = promote_default()
    if reconfigure is not None and not promote:
        raise ValueError(
            "reconfigure re-configures the DynSpec operand between "
            "chunks; it needs the promoted path (promote=True)"
        )
    if spec.record_tick_series:
        raise ValueError(
            "run_chunked does not collect per-tick series; run() per chunk "
            "or record snapshots via the callback"
        )
    if telemetry_stream is not None and not spec.telemetry:
        raise ValueError(
            "telemetry_stream needs spec.telemetry=True (the reservoir "
            "is zero-row when the plane is off)"
        )
    dev = state.t.device
    live_spec = spec
    run_spec, dyn = _promoted(spec, dev) if promote else (spec, None)
    total = spec.n_ticks
    chunk = min(chunk_ticks, total)
    done = 0
    next_row = 0
    while done < total:
        n = min(chunk, total - done)
        state = _run(run_spec, state, net, bounds, n, dyn, fused_cache=True)[0]
        done += n
        if telemetry_stream is not None:
            rows, next_row = reservoir_progress(spec, state.telem, done, next_row)
            telemetry_stream(rows, done)
        if callback is not None:
            callback(state, done)
        if reconfigure is not None and done < total:
            knobs = reconfigure(done)
            if knobs:
                live_spec = apply_knobs(live_spec, knobs)
                dyn = dyn_to_device(dyn_of(live_spec), dev)
        if inject is not None and done < total:
            state = inject(state, done)
    return state


def run_jit(
    spec: WorldSpec, state: WorldState, net: NetParams,
    bounds: Optional[MobilityBounds] = None, promote: Optional[bool] = None,
) -> WorldState:
    """The whole horizon in one call (``engine.run_jit``), returning the
    final state.  ``promote`` (default :func:`..dynspec.promote_default`)
    runs the shape key with the knobs as a device operand;
    ``promote=False`` takes them as host constants."""
    if promote is None:
        promote = promote_default()
    if promote:
        key_spec, dyn = _promoted(spec, state.t.device)
        return _run(key_spec, state, net, bounds, None, dyn, fused_cache=True)[0]
    return _run(spec, state, net, bounds, None, None, fused_cache=True)[0]


#: ``FNS_CHECKIFY`` / ``--checkify`` set names (:mod:`.sanitizer`).
#: ``div`` is the default: ``nan`` trips on the engine's deliberate
#: inf-sentinel arithmetic in masked lanes (the ack columns subtract
#: ``inf - inf`` there by design, as JAX's do), and ``oob`` is kept for
#: targeted debugging (the port's drop-mode scatters stay in range, so
#: unlike JAX's it is clean on the stock engine).
CHECKIFY_SETS = ("nan", "div", "oob")


def _checkify_errors(names: Optional[str]) -> Tuple[str, ...]:
    """The sets ``names`` picks, in JAX's spellings: None, ``""``,
    ``"1"``, ``"on"``, ``"true"`` and ``"div"`` mean ``div``; ``"all"``
    means every set; otherwise a comma-joined list of
    :data:`CHECKIFY_SETS`.  A ``"0"`` reaching here is a ``--checkify
    0`` that meant "off" (the env layer treats 0 as disabled): rejected
    loudly, not run on the default set."""
    if names is None or names in ("", "1", "on", "true", "div"):
        return ("div",)
    if names == "all":
        return CHECKIFY_SETS
    picked = [t.strip() for t in names.split(",") if t.strip()]
    bad = sorted(set(picked) - set(CHECKIFY_SETS))
    if bad:
        raise ValueError(
            f"unknown checkify set(s) {bad} "
            f"(have {list(CHECKIFY_SETS)} or 'all')"
        )
    return tuple(dict.fromkeys(picked))


def run_checkified(
    spec: WorldSpec,
    state: WorldState,
    net: NetParams,
    bounds: Optional[MobilityBounds] = None,
    n_ticks: Optional[int] = None,
    errors: Optional[str] = None,
) -> Tuple[WorldState, Optional[dict]]:
    """The opt-in runtime sanitizer: :func:`run` under
    :class:`.sanitizer.Sanitizer` with the sets ``errors`` names
    (:func:`_checkify_errors`; default ``div``).

    SLOW PATH, debug runs only: every operator of the run goes through a
    Python dispatch mode, and each checked one launches a few more
    kernels; never benchmark or gate on it.  Enabled by
    ``FNS_CHECKIFY=1`` or the CLI's ``--checkify``.  On the card the
    checks keep their flags on the device and the run waits for them
    once, at its end (plus the per-tick series' copies, where the spec
    records them); on the CPU it runs the tensor route, which the
    dispatcher sees.  Raises :class:`.sanitizer.CheckifyError` naming the
    set and the operator that tripped first; else returns :func:`run`'s
    ``(final, series)``, every leaf equal to a plain run's."""
    from ..device import host_routes
    from .sanitizer import Sanitizer

    sets = _checkify_errors(errors)
    if bounds is None:
        bounds = default_bounds(device=state.t.device)
    with host_routes(False), Sanitizer(sets, state.t.device) as sanitizer:
        final, series = run(spec, state, net, bounds, n_ticks=n_ticks)
    sanitizer.throw()
    return final, series
