"""The broker's placement decision, batched (``fognetsimpp_tpu/ops/sched.py``).

:func:`scalar_winner` is the dense broker's task-independent winner;
:func:`schedule_batch` decides each task of a compacted window: a (K, F)
score matrix and a row argmin for MIN_BUSY, MIN_LATENCY and ENERGY_AWARE,
round-robin slots in event order, the task-id-keyed RANDOM stream, the
bandit policies UCB, DUCB and EXP3 (:mod:`..learn.bandits`), DYNAMIC
over them by the device tensor ``policy_id``, and the one-winner MAX_MIPS
scan of LOCAL_FIRST's offloads.  Every same-window arrival
sees one snapshot of the broker's (stale) fog view, as the reference's
broker between two advertisements does.  Given the federated broker
domains (``fog_owner``, ``task_broker``, :mod:`..hier`), each task is
decided over its own broker's fogs only: per-domain ``brokers[0]``
anchors, one-winner scans, RANDOM slot tables and bandit slices.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..f32math import const, fma, xla_cumsum
from ..learn.bandits import (
    BanditArms, ducb_scores, exp3_probs, exp3_sample, ucb_scores,
)
from ..random import _bits_to_f32, threefry2x32
from ..spec import Policy

_BIG = 3.4e38
_I32 = torch.int32
_M32 = 0xFFFFFFFF


def at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for an index tensor ``i`` of any shape (0-d included)
    along axis 0, without reading ``i`` on the host (``x[i]`` with a 0-d
    ``i`` would turn it into a Python int and wait for the card)."""
    return x.index_select(0, i.reshape(-1).long()).reshape(i.shape)


def task_uniform(base_key: torch.Tensor, task_ids: torch.Tensor) -> torch.Tensor:
    """Per-task unit draws ``U(fold_in(base_key, task_ids[i]))``: a pure
    function of the task id, the RANDOM policy's stream (and EXP3's)."""
    ids = task_ids.long() & _M32
    zero = torch.zeros_like(ids)
    k1, k2 = threefry2x32(base_key[0], base_key[1], zero, ids)  # fold_in
    b1, b2 = threefry2x32(k1, k2, zero, zero)  # 32 bits of shape ()
    floats = _bits_to_f32(((b1 ^ b2) >> 9) | 0x3F800000) - 1.0
    return torch.clamp_min(floats, 0.0)


def scalar_winner(
    policy: int,
    view_busy: torch.Tensor,  # (F,) f32
    view_mips: torch.Tensor,  # (F,) f32
    registered: torch.Tensor,  # (F,) bool
    fog_alive: torch.Tensor,  # (F,) bool
    fog_energy_frac: torch.Tensor,  # (F,) f32
    rtt_broker_fog: torch.Tensor,  # (F,) f32
    v1_max_scan: bool,
) -> torch.Tensor:
    """() i32 winning fog, -1 = no resource.

    ``brokers[0]`` anchors to the FIRST REGISTERED fog; argmin/argmax take
    the first occurrence, as the reference's strict-< scan does.
    """
    F = view_busy.shape[0]
    dev = view_busy.device
    i32 = torch.int32
    if F == 0:
        return torch.full((), -1, dtype=i32, device=dev)
    avail = registered
    first_reg = torch.argmax(avail.to(torch.uint8)).to(i32)
    if policy == int(Policy.MAX_MIPS):
        idx = torch.arange(F, dtype=i32, device=dev)
        if v1_max_scan:
            cand = avail & (idx > first_reg) & (view_mips > at(view_mips, first_reg))
            last = torch.where(cand, idx, -1).amax()
            return torch.where(last >= 0, last, first_reg).to(i32)
        return torch.argmax(
            torch.where(avail, view_mips, float("-inf"))
        ).to(i32)
    if policy == int(Policy.MIN_BUSY):
        base, avail_ = view_busy, avail
    elif policy == int(Policy.MIN_LATENCY):
        base, avail_ = rtt_broker_fog + view_busy, avail
    elif policy == int(Policy.ENERGY_AWARE):
        base = fma(const(10.0, dev), 1.0 - fog_energy_frac, view_busy)
        avail_ = avail & fog_alive
    else:
        raise ValueError(f"no scalar winner for policy {policy}")
    big = const(_BIG, dev)
    scores = torch.nan_to_num(
        torch.where(avail_, base, big), posinf=_BIG
    )
    choice0 = torch.argmin(scores).to(i32)
    choice0 = torch.where(at(view_mips, first_reg) > 0, choice0, first_reg)
    return torch.where(avail_.any(), choice0, -1).to(i32)


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` with ``b == 0`` giving +inf, as C++ double division does
    (the broker registers fogs at MIPS 0 until their first advert)."""
    ok = b > 0
    return torch.where(ok, a / torch.where(ok, b, 1.0), float("inf"))


def _slot_table(ok: torch.Tensor) -> torch.Tensor:
    """(..., F) the fog index of each rank among the ``ok`` fogs of each
    row (zeros past the last)."""
    F = ok.shape[-1]
    rank = torch.cumsum(ok.to(_I32), dim=-1).to(_I32) - 1
    fids = torch.arange(F, dtype=torch.int64, device=ok.device).expand(ok.shape)
    # ranks are distinct within a row; the spare column F takes the rest
    table = torch.zeros(ok.shape[:-1] + (F + 1,), dtype=torch.int64, device=ok.device)
    table = table.scatter(-1, torch.where(ok, rank, F).long(), fids)
    return table[..., :F].to(_I32)


def schedule_batch(
    policy: int,  # static; Policy.DYNAMIC dispatches on policy_id instead
    mask: torch.Tensor,  # (T,) bool publishes decided this tick
    mips_req: torch.Tensor,  # (T,) f32
    view_busy: torch.Tensor,  # (F,) f32 stale busyTime view
    view_mips: torch.Tensor,  # (F,) f32 stale MIPS view
    registered: torch.Tensor,  # (F,) bool
    fog_alive: torch.Tensor,  # (F,) bool (ENERGY_AWARE, RANDOM, bandits)
    fog_energy_frac: torch.Tensor,  # (F,) f32 in [0, 1]
    rtt_broker_fog: torch.Tensor,  # (F,) f32 (MIN_LATENCY)
    rr_cursor: torch.Tensor,  # () i32
    key: torch.Tensor,  # PRNG key, for RANDOM without rand_u
    mips0_divisor: bool,  # static bug-compat switch
    v1_max_scan: bool = True,  # static bug-compat switch (MAX_MIPS scan)
    policy_id: Optional[torch.Tensor] = None,  # () i32 (DYNAMIC)
    order_t: Optional[torch.Tensor] = None,  # (T,) f32 arrival times
    rand_u: Optional[torch.Tensor] = None,  # (T,) f32 per-task draws
    learn: Optional[BanditArms] = None,  # arm view (UCB/DUCB/EXP3)
    fog_owner: Optional[torch.Tensor] = None,
    task_broker: Optional[torch.Tensor] = None,
    n_brokers: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A fog for every masked task: ``((T,) i32 fog or -1, rr')``.

    MIN_BUSY reproduces ``BrokerBaseApp3.cc:267-281``: the first-wins
    tie-break of its strict ``<`` and, with ``mips0_divisor``, the bug of
    dividing every estimate by ``brokers[0]``'s MIPS.  MAX_MIPS and
    LOCAL_FIRST's offload branch take one winner for the whole window,
    the v1/v2 scan of :func:`scalar_winner` (``BrokerBaseApp.cc:228-240``);
    the engine applies their per-task MIPS guard and LOCAL_FIRST's local
    branch.
    """
    T = mask.shape[0]
    F = view_busy.shape[0]
    dev = mask.device
    if F == 0:
        return torch.full((T,), -1, dtype=_I32, device=dev), rr_cursor
    avail = registered  # the reference never evicts dead fogs
    first_reg = torch.argmax(avail.to(torch.uint8)).to(_I32)
    hier = fog_owner is not None
    if hier:
        # each task sees its own broker's fogs: (B, F) ownership, the
        # domain's brokers[0] (its first registered fog) and (T, F)
        # membership rows
        B = int(n_brokers)
        owned = fog_owner[None, :] == torch.arange(B, dtype=_I32, device=dev)[:, None]
        tb = torch.clamp(task_broker, 0, B - 1).long()
        avail_b = avail[None, :] & owned
        first_reg_b = torch.argmax(avail_b.to(torch.uint8), dim=1).to(_I32)
        first_reg_t = first_reg_b[tb]
        allowed = owned[tb]
    if hier and mips0_divisor:
        # the mips0 quirk a domain: every candidate of a task divides by
        # the MIPS of its own domain's anchor
        est = _safe_div(mips_req[:, None], view_mips[first_reg_t.long()][:, None])
    else:
        divisor = at(view_mips, first_reg).expand(F) if mips0_divisor else view_mips
        est = _safe_div(mips_req[:, None], divisor[None, :])
    none = torch.full((T,), -1, dtype=_I32, device=dev)

    def decided(choice):
        return torch.where(mask, choice.to(_I32), none)

    def per_domain(winner_of, ok_bf):
        """Each task takes its own domain's winner (``winner_of`` maps a
        domain's (F,) usable mask to its () winner), -1 where its domain
        has no usable fog."""
        win_b = torch.func.vmap(winner_of)(ok_bf)
        return torch.where(ok_bf.any(dim=1)[tb], win_b[tb], -1)

    if policy in (int(Policy.MAX_MIPS), int(Policy.LOCAL_FIRST)):
        def scan_winner(av):
            return scalar_winner(
                int(Policy.MAX_MIPS), view_busy, view_mips, av, fog_alive,
                fog_energy_frac, rtt_broker_fog, v1_max_scan,
            )

        if hier:
            return decided(per_domain(scan_winner, avail_b)), rr_cursor
        return decided(scan_winner(registered).expand(T)), rr_cursor

    def from_scores(scores, avail_):
        if hier:
            # fogs outside the task's domain score _BIG, and "no fog" and
            # the all-big anchor are the task's own domain's
            scores = torch.where(avail_[None, :] & allowed, scores, const(_BIG, dev))
            anchor = first_reg_t
            any_fog = (avail_[None, :] & owned).any(dim=1)[tb]
        else:
            scores = torch.where(avail_[None, :], scores, const(_BIG, dev))
            anchor, any_fog = first_reg, avail_.any()
        scores = torch.nan_to_num(scores, posinf=_BIG)
        choice = torch.argmin(scores, dim=1).to(_I32)
        # an all-inf row (before any advert): the strict-< scan keeps its
        # initial winner, brokers[0], the first registered fog
        all_big = (scores >= _BIG).all(dim=1)
        choice = torch.where(all_big, anchor, choice)
        choice = torch.where(any_fog, choice, -1)
        return decided(choice), rr_cursor

    def b_min_busy():
        return from_scores(view_busy[None, :] + est, avail)

    def b_round_robin():
        if hier:
            raise ValueError(
                "ROUND_ROBIN does not federate (single shared cursor); "
                "WorldSpec.validate() should have rejected this spec"
            )
        # the k-th masked task gets fog (rr + k) % n among the available,
        # k in event order (arrival time, ties by index) given order_t
        if order_t is None:
            k = torch.cumsum(mask.to(_I32), dim=0).to(_I32) - 1
        else:
            # (+0.0 folds -0.0 into +0.0: they tie, as in a comparison sort)
            t_key = torch.where(mask, order_t + 0.0, float("inf"))
            order = torch.sort(t_key, stable=True).indices
            rank_sorted = torch.cumsum(mask[order].to(_I32), dim=0).to(_I32) - 1
            k = torch.zeros((T,), dtype=_I32, device=dev).scatter(0, order, rank_sorted)
        n_avail = torch.clamp_min(avail.sum(dtype=_I32), 1)
        slot = torch.remainder(rr_cursor + k, n_avail)
        choice = _slot_table(avail)[slot.long()]
        choice = torch.where(avail.any(), choice, -1)
        rr_new = torch.remainder(rr_cursor + mask.sum(dtype=_I32), n_avail).to(_I32)
        return decided(choice), rr_new

    def b_min_latency():
        return from_scores(rtt_broker_fog[None, :] + view_busy[None, :] + est, avail)

    def b_energy_aware():
        # dead fogs are unusable; XLA contracts the energy term's
        # multiply with the last add
        base = view_busy[None, :] + est
        ten = const(10.0, dev).expand_as(base)
        scores = fma(ten, (1.0 - fog_energy_frac)[None, :].expand_as(base), base)
        return from_scores(scores, avail & fog_alive)

    def units():
        if rand_u is not None:
            return rand_u
        return task_uniform(key, torch.arange(T, dtype=_I32, device=dev))

    def b_random():
        ok = avail & fog_alive
        if hier:
            # the task-id-keyed draw indexes its own domain's slot table
            ok_bf = ok[None, :] & owned
            n_ok = ok_bf.sum(dim=1, dtype=_I32)[tb]
        else:
            n_ok = ok.sum(dtype=_I32)
        # floor(u * n) in float32, as the native DES computes it
        slot = (units() * n_ok.to(torch.float32)).to(_I32)
        slot = torch.minimum(torch.clamp_min(slot, 0), torch.clamp_min(n_ok - 1, 0))
        if hier:
            choice = _slot_table(ok_bf)[tb, slot.long()]
        else:
            choice = _slot_table(ok)[slot.long()]
        return decided(torch.where(n_ok > 0, choice, -1)), rr_cursor

    ok_b = avail & fog_alive  # a dead fog never acks, so bandits skip it

    def index_winner(score_fn):
        def winner_of(av):
            scores = score_fn(learn, av)
            win = torch.argmax(torch.where(av, scores, const(-_BIG, dev))).to(_I32)
            return torch.where(av.any(), win, -1)

        if hier:
            # one bandit a broker over its own arms (its own exploration
            # total), on the one shared (F,) statistics table
            return decided(per_domain(winner_of, ok_b[None, :] & owned)), rr_cursor
        return decided(winner_of(ok_b).expand(T)), rr_cursor

    def b_ucb():
        return index_winner(ucb_scores)

    def b_ducb():
        return index_winner(ducb_scores)

    def b_exp3():
        if not hier:
            p = exp3_probs(learn.logw, ok_b, learn.explore)
            return decided(exp3_sample(p, units())), rr_cursor
        # each task samples from its own broker's softmax over its arms
        p_b = torch.func.vmap(lambda av: exp3_probs(learn.logw, av, learn.explore))(
            ok_b[None, :] & owned
        )
        cdf = xla_cumsum(p_b)[tb]  # (T, F)
        total = cdf[:, -1]
        target = torch.clamp(units(), const(1e-7, dev), const(1.0, dev)) * total
        arm = torch.argmax((cdf >= target[:, None]).to(torch.uint8), dim=1)
        return decided(torch.where(total > 0, arm.to(_I32), -1)), rr_cursor

    branches = {
        int(Policy.MIN_BUSY): b_min_busy,
        int(Policy.ROUND_ROBIN): b_round_robin,
        int(Policy.MIN_LATENCY): b_min_latency,
        int(Policy.ENERGY_AWARE): b_energy_aware,
        int(Policy.RANDOM): b_random,
        int(Policy.UCB): b_ucb,
        int(Policy.DUCB): b_ducb,
        int(Policy.EXP3): b_exp3,
    }
    if policy == int(Policy.DYNAMIC):
        if hier:
            raise ValueError(
                "Policy.DYNAMIC does not federate (n_brokers > 1); "
                "WorldSpec.validate() should have rejected this spec"
            )
        if policy_id is None:
            raise ValueError("Policy.DYNAMIC needs a policy_id tensor")
        # every branch is computed and the one policy_id names is kept:
        # the branches have no side effects, so this is lax.switch's
        # result without reading the id on the host
        outs = [branches[p]() for p in range(5)]
        outs.append((none, rr_cursor))  # an invalid id: nothing schedules
        pid = policy_id.to(_I32)
        sel = torch.where((pid < 0) | (pid > 4), 5, pid)
        if learn is not None:
            outs += [b_ucb(), b_ducb(), b_exp3()]
            bandit = (pid >= int(Policy.UCB)) & (pid <= int(Policy.EXP3))
            sel = torch.where(bandit, pid - 2, sel)
        sel = sel.long().reshape(1)
        choice = torch.stack([c for c, _ in outs]).index_select(0, sel)[0]
        rr = torch.stack([r.reshape(()) for _, r in outs]).index_select(0, sel)[0]
        return choice, rr.to(_I32)
    if policy in (int(Policy.UCB), int(Policy.DUCB), int(Policy.EXP3)):
        if learn is None:
            raise ValueError(
                f"policy {Policy(policy).name} needs the bandit arm view "
                "(learn=BanditArms)"
            )
    if policy not in branches:
        raise ValueError(f"unknown policy {policy}")
    return branches[policy]()
