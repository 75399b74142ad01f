"""The tick engine: one call of ``step`` advances the whole world one tick.

Counterpart of ``fognetsimpp_tpu/core/engine.py`` for the per-phase
(unfused) tick: mobility and association (every tick unless the world is
static) -> connect -> adverts -> spawn (``_phase_spawn`` at one send per
tick, ``_phase_spawn_multi`` above, both with the 802.11 uplink loss) ->
broker (dense for the task-independent policies, ``broker_dense_ok``;
compacted for the rest) -> ``completions_per_tick`` completion passes ->
fog arrivals (two-stage candidate front, K-window compaction, shared
tail) -> the bandit learners' reward credit (learned policies only) ->
per-node message counters -> energy and lifecycle.  The JAX package's
fused slot-window front-end is bit-identical to this tick
(``tests/test_fused.py``) and is not ported.  :func:`run` replaces the
``lax.scan`` with a Python loop and hoists the static link cache out of
it, as the JAX ``run`` does.

Every leaf is held bit-exact against the JAX engine.  Three habits keep
it so: Python float constants are rounded to float32 before they meet
a float32 tensor (:func:`~fognetsimpp_tpu_torch.f32math.const`); a
``a * b + c`` that XLA fuses into one multiply-add uses
:func:`~fognetsimpp_tpu_torch.f32math.fma`; scatters with JAX's
``mode="drop"`` go through :mod:`..ops.scatter`.  Integer sums ask for
int32 explicitly (torch would widen them to int64).

A spec that enables anything outside this slice raises
``NotImplementedError`` naming the ``ROADMAP.md`` item that will port it
(:mod:`..envelope`).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..dynspec import DynSpec, dyn_of
from ..envelope import broker_dense_ok, check_slice
from ..f32math import const, fma
from ..learn.bandits import arms_view, exp3_probs
from ..learn.rewards import credit_batch
from ..net.energy import step_energy
from ..net.mobility import MobilityBounds, default_bounds, step_mobility
from ..net.topology import LinkCache, NetParams, associate
from ..ops.queues import NO_TASK, batched_enqueue, batched_pop, plan_arrivals
from ..ops.scatter import add_drop, set_drop
from ..ops.sched import at, scalar_winner, schedule_batch, task_uniform
from ..random import PRNGKey, randint, split, uniform
from ..spec import STATIC_MAC_ERR, FogModel, Policy, Stage, WorldSpec
from ..state import WorldState

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
        return (
            "[TP-HIER] the TP runner does not carry the multi-broker "
            "hierarchy yet (per-domain decide masks and the migrate phase "
            "need cross-shard load summaries); run "
            f"n_brokers={spec.n_brokers} worlds on single-device "
            "run/run_jit/run_chunked"
        )
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
        publishing = publishing & (t0 < const(float(dv.send_stop_time), t0.device))
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
    p_eff = torch.full((U,), float(dv.uplink_loss_prob), dtype=_F32, device=dev)
    if has_mac:
        one = const(1.0, dev).expand(U)
        p_eff = fma(-(1.0 - p_eff), 1.0 - cache.mac_loss_p[:U], one)
    return p_eff


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
        due = due & (t_create < const(float(dv.send_stop_time), dev))
    keys = split(state.key, 4)
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
    t_arrive = t_create + cache.d2b[:U]
    p_loss = _uplink_loss_p(spec, net, cache, dv, U, dev)
    if p_loss is None:
        lost = torch.zeros((U,), dtype=torch.bool, device=dev)
    else:
        lost = (
            _tp_user_draw(tp, lambda s: uniform(k_loss, s), U) < p_loss
        ) & net.is_wireless[:U]
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
        due2 = due2 & (fire < const(float(dv.send_stop_time), dev))
    keys = split(state.key, 3)
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
    t_arrive = fire + cache.d2b[:U][:, None]
    p_loss = _uplink_loss_p(spec, net, cache, dv, U, dev)
    if p_loss is None:
        lost2 = torch.zeros((U, S), dtype=torch.bool, device=dev)
    else:
        draws_l = _tp_user_draw(tp, lambda s: uniform(k_loss, s), U, R) < p_loss[:, None]
        lost2 = lane_select(draws_l, False) & net.is_wireless[:U, None]
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
    reg_eff = b.registered
    fog_efrac = state.nodes.energy[U: U + F] / torch.clamp_min(
        state.nodes.energy_capacity[U: U + F], const(1e-12, dev)
    )
    any_fog = reg_eff.any()
    choice_s = scalar_winner(
        spec.policy, b.view_busy, b.view_mips, reg_eff, fog_alive,
        fog_efrac, 2.0 * cache.d2b[U: U + F], spec.bug_compat.v1_max_scan,
    )
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


def _phase_broker(spec, state, cache, buf, t1):
    """The compacted broker: up to K matured publishes a tick (the
    tick-keyed rotated window, the rest deferred) are decided one by one
    by :func:`~..ops.sched.schedule_batch` against the broker's stale fog
    view, and partitioned into scheduled and no-resource (the MIPS
    guard's rejections belong to MAX_MIPS and LOCAL_FIRST, which never
    come here).  With a learned policy the pick counts advance at the end
    of the window and an EXP3-capable world records each pick's
    probability for the credit phase."""
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

    keys = split(state.key, 2)
    key, k_sched = keys[0], keys[1]
    fog_alive = state.nodes.alive[U: U + F]
    reg_eff = b.registered
    fog_efrac = state.nodes.energy[U: U + F] / torch.clamp_min(
        state.nodes.energy_capacity[U: U + F], const(1e-12, dev)
    )
    any_fog = reg_eff.any()
    rand_u = None
    if spec.policy in (int(Policy.RANDOM), int(Policy.DYNAMIC), int(Policy.EXP3)):
        # the task-id-keyed stream shared with the native DES
        rand_u = task_uniform(PRNGKey(spec.policy_seed, dev), idxc)
    choice, rr_new = schedule_batch(
        spec.policy, valid, mips_g, b.view_busy, b.view_mips, reg_eff,
        fog_alive, fog_efrac, 2.0 * cache.d2b[U: U + F], b.rr_next, k_sched,
        spec.bug_compat.mips0_divisor,
        policy_id=b.policy_id, order_t=t_ab_g, rand_u=rand_u,
        learn=arms_view(state.learn) if spec.learn_active else None,
    )
    choice_ok = choice >= 0
    fog_node = U + torch.clamp(choice, 0, F - 1).long()
    sched = valid & any_fog & choice_ok
    no_res = valid & ~sched

    learn = state.learn
    if spec.learn_active:
        picked = _per_fog(sched, choice, F)
        learn = learn.replace(
            pick_count=learn.pick_count + _isum(picked, 1).to(_F32)
        )
        if spec.policy == int(Policy.EXP3) or (
            spec.policy == int(Policy.DYNAMIC) and spec.learn_in_dynamic
        ):
            p_vec = exp3_probs(learn.logw, b.registered & fog_alive, learn.explore)
            # p at each row's chosen fog: one nonzero a column, so exact
            p_row = torch.where(picked, p_vec[:, None], 0.0).sum(dim=0)
            if spec.policy == int(Policy.DYNAMIC):
                p_row = torch.where(b.policy_id == int(Policy.EXP3), p_row, 1.0)
            learn = learn.replace(
                pick_p=set_drop(learn.pick_p, idx, torch.where(sched, p_row, 1.0))
            )

    inf_t = torch.full((), _INF, dtype=_F32, device=dev)
    tasks = tasks.replace(
        stage=set_drop(
            tasks.stage, idx,
            torch.where(sched, _i8(_ST_TASK_INFLIGHT, dev), _i8(_ST_NO_RESOURCE, dev)),
        ),
        fog=set_drop(tasks.fog, idx, torch.where(sched, choice, NO_TASK)),
        t_at_fog=set_drop(
            tasks.t_at_fog, idx, torch.where(sched, t_ab_g + cache.d2b[fog_node], inf_t)
        ),
    )
    if not spec.derive_acks:
        tasks = tasks.replace(
            t_ack4_fwd=set_drop(tasks.t_ack4_fwd, idx, t_ab_g + cache.d2b[user_g]),
            t_ack3=set_drop(tasks.t_ack3, idx, inf_t),
        )
    sums = _isum(torch.stack([sched, no_res, valid]), 1)
    metrics = metrics.replace(
        n_scheduled=metrics.n_scheduled + sums[0],
        n_no_resource=metrics.n_no_resource + sums[1],
    )
    buf = buf._replace(
        tx_b=buf.tx_b + sums[0] + sums[2] + n_del,
        rx_b=buf.rx_b + sums[2],
        rx_u=add_drop(buf.rx_u, user_g, valid.to(_I32)),
    )
    return state.replace(
        tasks=tasks, users=users, broker=b.replace(rr_next=rr_new),
        metrics=metrics, key=key, learn=learn,
    ), buf


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
    lat = torch.where(valid, tasks.t_ack6[g] - tasks.t_create[g], 0.0)
    memb = _per_fog(valid, fog_g, F)
    learn = credit_batch(
        learn, valid, memb, lat, learn.pick_p[g], F,
        dv.learn_discount, dv.learn_reward_scale,
    )
    learn = learn.replace(
        credited=set_drop(learn.credited, idx, torch.ones((), dtype=torch.int8, device=t1.device))
    )
    return state.replace(learn=learn)


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
    list, then the K-window compaction and the shared tail.

    Under ``tp`` the candidates are the shard's users', the fast drop's
    per-fog sums are summed over the shards, and ``exchange`` (from
    :mod:`..parallel.taskshard`) turns every shard's surviving candidates
    into the window each shard's tail plans: ``exchange(state, valid,
    ids, fog, t, mips) -> ((ids, fog, t, mips) of the window, deferred)``.
    """
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
        win, deferred = exchange(state, cand_v, cand_slot, cand_f, cand_t, cand_m)
        state = state.replace(
            metrics=state.metrics.replace(
                n_deferred=state.metrics.n_deferred + deferred
            )
        )
    return _fog_arrivals_tail(
        spec, state, cache, buf, tasks, fogs, *win, n_fast, n_fast_f, tp=tp
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


def make_step(spec: WorldSpec):
    """The single-tick transition ``step(state, net, bounds, static_cache)``
    for ``spec`` (the per-phase order of the JAX ``make_step``)."""
    spec.validate()
    check_slice(spec)
    dv = dyn_of(spec)

    def step(
        state: WorldState, net: NetParams, bounds: MobilityBounds,
        static_cache: Optional[LinkCache] = None,
    ) -> WorldState:
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

        if spec.connect_gating:
            state, buf = _phase_connect(spec, state, cache, buf, t0, t1)
        state = _phase_adverts(state, t1)
        if spec.max_sends_per_tick > 1:
            state, buf = _phase_spawn_multi(spec, state, net, cache, buf, t0, t1, dv)
        else:
            state, buf = _phase_spawn(spec, state, net, cache, buf, t0, t1, dv)
        if broker_dense_ok(spec):
            state, buf = _phase_broker_dense(spec, state, cache, buf, t1)
        else:
            state, buf = _phase_broker(spec, state, cache, buf, t1)
        if F > 0:
            for _ in range(spec.completions_per_tick):
                state, buf = _phase_completions(spec, state, cache, buf, t1)
            state, buf = _phase_fog_arrivals(spec, state, cache, buf, t1)
        if spec.learn_active:
            # after the fog phases, so an ack landing this tick credits now
            state = _phase_learn_credit(spec, state, t1, dv)

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
        if spec.energy_enabled:
            # battery drain and harvest; a fog in service draws compute power
            computing = torch.cat([
                torch.zeros((U,), dtype=torch.bool, device=dev),
                state.fogs.current_task != NO_TASK,
                torch.zeros((spec.n_nodes - U - F,), dtype=torch.bool, device=dev),
            ])
            energy, alive = step_energy(
                dv, nodes.energy, nodes.energy_capacity, nodes.has_energy,
                nodes.alive, t1, tx_all, rx_all, computing,
            )
            nodes = nodes.replace(energy=energy, alive=alive)
        state = state.replace(nodes=nodes)
        return state.replace(
            t=t1,
            tick=state.tick + 1,
            metrics=state.metrics.replace(
                n_deferred_max=torch.maximum(
                    state.metrics.n_deferred_max, state.metrics.n_deferred
                )
            ),
        )

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
    check_slice(spec, net)
    if spec.derive_acks and not spec.assume_static:
        raise ValueError("derive_acks needs assume_static (one static link cache)")
    if spec.assume_static and net.mac_loss_tab.shape[0] > 0:
        raise ValueError(STATIC_MAC_ERR)
    if bounds is None:
        bounds = default_bounds(device=dev)
    return bounds, spec.n_ticks if n_ticks is None else n_ticks


def _static_cache(spec: WorldSpec, net: NetParams, state: WorldState) -> LinkCache:
    """One association for the whole run: positions and liveness are
    constant, so no mobility or association runs a tick."""
    return associate(net, state.nodes.pos, state.nodes.alive, spec.broker_index)


def run(
    spec: WorldSpec,
    state: WorldState,
    net: NetParams,
    bounds: Optional[MobilityBounds] = None,
    n_ticks: Optional[int] = None,
) -> Tuple[WorldState, None]:
    """Run ``n_ticks`` (default: the spec's horizon) on the state's device.

    Returns ``(final_state, None)``: per-tick series recording is not
    ported.  The state stays on its device; the loop never waits for it.
    """
    bounds, n = _runner_setup(spec, net, state.t.device, bounds, n_ticks)
    step = make_step(spec)
    static_cache = _static_cache(spec, net, state) if spec.assume_static else None
    for _ in range(n):
        state = step(state, net, bounds, static_cache)
    if spec.derive_acks:
        state = _finalize_derived_acks(spec, state, static_cache)
    return state, None


def batched_tick(
    spec: WorldSpec, net: NetParams, bounds: MobilityBounds, batch: WorldState
):
    """``(tick, cache)``: ``tick(batch) -> batch`` advances R worlds like
    ``batch`` one tick, one ``torch.func.vmap`` of ``make_step(spec)``;
    ``cache`` is each replica's static link cache (None on a moving
    world), computed from ``batch`` as JAX computes it inside its vmap.
    The port draws no numbers from torch's generator, so the vmap refuses
    randomness."""
    step = make_step(spec)
    vmap = torch.func.vmap
    if not spec.assume_static:
        return vmap(lambda s: step(s, net, bounds), randomness="error"), None
    cache = vmap(lambda s: _static_cache(spec, net, s))(batch)
    tick = vmap(lambda s, c: step(s, net, bounds, c), randomness="error")
    return (lambda s: tick(s, cache)), cache


def run_batched(
    spec: WorldSpec,
    batch: WorldState,
    net: NetParams,
    bounds: Optional[MobilityBounds] = None,
    n_ticks: Optional[int] = None,
) -> Tuple[WorldState, None]:
    """:func:`run` for R worlds at once: ``batch`` carries a leading
    replica axis on every leaf, and ``net`` and ``bounds`` are shared.

    Each tick is one call of :func:`batched_tick`, so every operation of
    the tick launches once for all R worlds; the kernels' batching rules
    (:mod:`..ops.arrival_kernels`, :mod:`..ops.cell_kernels`) lay the
    replicas' windows end to end for one kernel call.  Replica r of the
    result equals :func:`run` on replica r of ``batch``, leaf for leaf.
    """
    bounds, n = _runner_setup(spec, net, batch.t.device, bounds, n_ticks)
    tick, cache = batched_tick(spec, net, bounds, batch)
    for _ in range(n):
        batch = tick(batch)
    if spec.derive_acks:
        batch = torch.func.vmap(
            lambda s, c: _finalize_derived_acks(spec, s, c)
        )(batch, cache)
    return batch, None
