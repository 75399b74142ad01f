"""Federated multi-broker hierarchy: ownership, the TP refusal, readers
(``fognetsimpp_tpu/hier/federation.py``).

``spec.n_brokers = B > 1`` splits users and fogs into B broker domains by
the ownership columns of :class:`~..state.HierState` (block-contiguous by
default, :func:`default_ownership`; a scenario or a test restamps them
with :func:`stamp_ownership` before the first tick).  Each broker decides
over its own fogs with its own slice of the stale view (the engine's
broker phases and :func:`..ops.sched.schedule_batch`), and the engine's
migrate phase (``core/engine._phase_broker_migrate``) moves matured
publishes from a saturated or dead domain to the least-loaded peer, one
inter-broker hop later, within a hop budget.  With ``B == 1`` every leaf
is zero-row and none of it runs.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..spec import HierPolicy, WorldSpec
from ..state import HierState

_I32 = torch.int32


def default_ownership(spec: WorldSpec):
    """Block-contiguous domains on the host: user u to broker ``u*B // U``,
    fog f to broker ``f*B // F`` (every broker owns a fog: ``validate()``
    asks ``n_brokers <= n_fogs``)."""
    B = spec.n_brokers
    ub = (np.arange(spec.n_users, dtype=np.int64) * B) // max(spec.n_users, 1)
    fb = (np.arange(spec.n_fogs, dtype=np.int64) * B) // max(spec.n_fogs, 1)
    return ub.astype(np.int32), fb.astype(np.int32)


def _task_broker_of(spec: WorldSpec, user_broker: torch.Tensor) -> torch.Tensor:
    """Each task's owning broker from the slot layout u*S + k."""
    return user_broker.repeat_interleave(spec.max_sends_per_user)


def _owner_column(owner: np.ndarray, device) -> torch.Tensor:
    """An ownership vector on ``device`` (built once, at init)."""
    return torch.as_tensor(owner, dtype=_I32).to(device)


def init_hier_state(spec: WorldSpec, device) -> HierState:
    """The t=0 federation state of ``spec`` (zero-row with one broker)."""
    B = spec.hier_brokers
    f32 = torch.float32

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    if spec.hier_active:
        ub, fb = default_ownership(spec)
        user_broker = _owner_column(ub, device)
        fog_broker = _owner_column(fb, device)
        task_broker = _task_broker_of(spec, user_broker)
    else:
        user_broker = fog_broker = task_broker = full((0,), 0, _I32)
    return HierState(
        user_broker=user_broker,
        fog_broker=fog_broker,
        task_broker=task_broker,
        hops=full((spec.hier_tasks,), 0, torch.int8),
        # peer_t 0: the first tick reads every peer's live load
        peer_load=full((B, B), 0.0, f32),
        peer_t=full((B, B), 0.0, f32),
        mig_out=full((B,), 0, _I32),
        mig_in=full((B,), 0, _I32),
        n_migrated=full((), 0, _I32),
        n_hop_exhausted=full((), 0, _I32),
    )


def stamp_ownership(
    spec: WorldSpec,
    state,
    user_broker: Optional[Sequence[int]] = None,
    fog_broker: Optional[Sequence[int]] = None,
):
    """Restamp a built world's domains (and each task's broker from the new
    user ownership); ``None`` keeps an axis as it is.  Before the first
    tick only: the engine never derives ``task_broker`` again."""
    if not spec.hier_active:
        raise ValueError("stamp_ownership needs a federated world (n_brokers > 1)")
    h = state.hier
    B = spec.n_brokers
    dev = h.hops.device
    if user_broker is not None:
        ub = np.asarray(user_broker, np.int32)
        if ub.shape != (spec.n_users,) or ub.min(initial=0) < 0 or (
            ub.max(initial=0) >= B
        ):
            raise ValueError(f"user_broker must be ({spec.n_users},) ints in [0, {B})")
        col = _owner_column(ub, dev)
        h = h.replace(user_broker=col, task_broker=_task_broker_of(spec, col))
    if fog_broker is not None:
        fb = np.asarray(fog_broker, np.int32)
        if fb.shape != (spec.n_fogs,) or fb.min(initial=0) < 0 or (
            fb.max(initial=0) >= B
        ):
            raise ValueError(f"fog_broker must be ({spec.n_fogs},) ints in [0, {B})")
        h = h.replace(fog_broker=_owner_column(fb, dev))
    return state.replace(hier=h)


def hier_reject_reason(spec: WorldSpec, runner: str = "TP") -> Optional[str]:
    """Why a federated spec cannot run on a sharded runner, ``runner``
    the task-sharded tick (``"TP"``) or the fleet (``"fleet"``); None when
    the hierarchy is off.  The reference's ``[{RUNNER}-HIER]`` IDs and
    words."""
    if not spec.hier_active:
        return None
    return (
        f"[{runner.upper()}-HIER] the {runner} runner does not carry the "
        "multi-broker hierarchy yet (per-domain decide masks and the "
        "migrate phase need cross-shard load summaries); run "
        f"n_brokers={spec.n_brokers} worlds on single-device "
        "run/run_jit/run_chunked"
    )


# ----------------------------------------------------------------------
# host readers (after a run or a chunk; one fetch each)
# ----------------------------------------------------------------------

def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def hier_counters(final) -> dict:
    """The two scalar counters of a federated run (one small fetch)."""
    h = final.hier
    return {
        "migrated": int(_np(h.n_migrated)),
        "hop_exhausted": int(_np(h.n_hop_exhausted)),
    }


def hier_summary(spec: WorldSpec, final) -> Optional[dict]:
    """The roll-up of a finished federated run (None with one broker):
    policy, hop budget, counters, per-broker migrations and domain sizes,
    as plain ints; with the telemetry plane on, each broker's mean load
    (busy owned fogs over owned fogs) and the strided per-tick load rows
    with their reservoir times."""
    if not spec.hier_active:
        return None
    h = final.hier
    B = spec.n_brokers
    fb = _np(h.fog_broker).astype(np.int64)
    ub = _np(h.user_broker).astype(np.int64)
    c = hier_counters(final)
    out = {
        "n_brokers": B,
        "policy": HierPolicy(spec.hier_policy).name.lower(),
        "max_hops": int(spec.hier_max_hops),
        "migrated": c["migrated"],
        "hop_exhausted": c["hop_exhausted"],
        "mig_out": [int(x) for x in _np(h.mig_out)],
        "mig_in": [int(x) for x in _np(h.mig_in)],
        "fogs_per_broker": [int((fb == b).sum()) for b in range(B)],
        "users_per_broker": [int((ub == b).sum()) for b in range(B)],
    }
    t = getattr(final, "telem", None)
    if t is not None and t.hier_load_sum.shape[0] == B:
        ticks = max(int(_np(t.ticks)), 1)
        res = _np(t.res).astype(np.float64)
        rows = _np(t.hier_load_res).astype(np.float64)
        Rm = rows.shape[0]
        stride = max(1, -(-spec.n_ticks // Rm)) if Rm else 1
        n_rows = min(Rm, -(-ticks // stride)) if Rm else 0
        out["load_mean"] = [float(x) / ticks for x in _np(t.hier_load_sum)]
        out["load_rows"] = rows[:n_rows]
        out["load_rows_t"] = res[:n_rows, 0] if n_rows else np.zeros((0,))
    return out
