"""One tick, many knob values: the promoted numeric knobs of a spec.

Counterpart of ``fognetsimpp_tpu/dynspec.py``.  A spec splits into

* a **shape key** (:func:`shape_key`): the spec with every promoted knob
  replaced by a gate-preserving canonical value, so two worlds that
  differ only in knob values have one key; and
* a :class:`DynSpec` (:func:`dyn_of`): the knob values as float32/int32
  scalars, every derived quantity rounded to float32 on the host in the
  reference's order.

The engine reads a knob either as a host constant (``dyn=None``: the
spec's own values, folded as the JAX engine folds them into its trace)
or as a device operand (:func:`dyn_to_device`: 0-d tensors, or rows with
a leading replica axis from :func:`dyn_rows`).  The two modes are the
reference's two arithmetics: XLA multiplies by the float32 reciprocal
where the source divides by a constant, and divides where the divisor is
an operand (:func:`div_knob`).  Gates (``uplink_loss_prob > 0``, a finite
``send_stop_time``) are read from the spec, that is the shape key, whose
canonical values keep each gate's class; values come only from the
DynSpec.

XLA's jit-program registry (``registry_note``, ``registry_stats``,
``registry_reset``) has no counterpart: the port compiles no programs.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Sequence, Tuple, Union

import numpy as np
import torch
import torch.utils._pytree as pytree

from .f32math import const
from .spec import WorldSpec

# ----------------------------------------------------------------------
# the promoted-field catalogue (the reference's, unchanged)
# ----------------------------------------------------------------------

#: WorldSpec fields whose value (never their shape) reaches the tick.
DYN_FIELDS: Tuple[str, ...] = (
    # wireless / link scalars
    "uplink_loss_prob",
    "send_stop_time",
    "link_up_s",
    "link_drain_s",
    "link_drain2_s",
    "link_rate_bps",
    # chaos fault-injection knobs
    "chaos_mtbf_s",
    "chaos_mttr_s",
    "chaos_rtt_amp",
    "chaos_rtt_period_s",
    "chaos_rtt_burst_prob",
    "chaos_rtt_burst_mult",
    "chaos_max_retries",
    # learned-scheduler reward weights
    "learn_discount",
    "learn_reward_scale",
    # federated-hierarchy migration knobs
    "hier_threshold",
    "hier_max_hops",
    "hier_rtt_s",
    "hier_rtt_matrix",
    # energy-model scalars
    "idle_power_w",
    "tx_energy_j",
    "rx_energy_j",
    "compute_power_w",
    "harvest_power_w",
    "harvest_period_s",
    "harvest_duty",
    "shutdown_frac",
    "start_frac",
)

#: Numeric knobs kept static, each with its one-line reason.  Every
#: field neither here nor in DYN_FIELDS is shape-, gate- or
#: policy-defining by construction.
STATIC_REASONS: Dict[str, str] = {
    "dt": "sets n_ticks (the scan length) — shape-defining",
    "horizon": "sets n_ticks (the scan length) — shape-defining",
    "send_interval": "already dynamic: rides users.send_interval in the "
    "state (the sweep load axis)",
    "send_interval_jitter": "resample gate is trace structure "
    "(volatile-par draw per send)",
    "start_time_min": "folded into users.start_t at state init",
    "start_time_max": "folded into users.start_t at state init",
    "mips_required_min": "jax.random.randint bound — the draw pipeline "
    "is specialized on the static bound",
    "mips_required_max": "jax.random.randint bound — the draw pipeline "
    "is specialized on the static bound",
    "fixed_mips_required": "None-vs-value selects the draw-free spawn "
    "trace",
    "required_time": "v2 release pre-selection compares it to dt at "
    "trace time (validate() contract)",
    "adv_interval": "advert-boundary sub-phasing derives per-tick fire "
    "times whose trace the boundary count depends on",
    "broker_mips": "folded into broker pool state at init",
    "learn_explore": "already dynamic: rides LearnState.explore in the "
    "carry (sweep_explore's axis)",
    "policy_seed": "folded into the per-task threefry stream key",
    "chaos_seed": "folded into the chaos PRNG key at state init",
    "energy_capacity_j": "folded into nodes.energy/energy_capacity at "
    "state init",
    "task_bytes": "static int folded into DropTail byte constants with "
    "link_queue_frames",
    "link_queue_frames": "static int — frameCapacity folds into the "
    "DropTail cap constant",
    "link_burst_n": "static int gate selecting the one- vs two-phase "
    "drain trace",
    "link_buffer_frames": "static int gate selecting the mechanistic- "
    "buffer trace",
    "telemetry_hist_min_ms": "bucket edges are trace-time constants of "
    "the histogram compare ladder",
    "telemetry_hist_max_ms": "bucket edges are trace-time constants of "
    "the histogram compare ladder",
    "ingest_batch": "static int — sizes the fixed-width injection batch "
    "arrays the chunk-boundary injector is compiled for",
}

#: Promoted fields whose value also selects code (zero vs positive).
_GATED_POSITIVE = (
    "uplink_loss_prob",
    "link_up_s",
    "chaos_mtbf_s",
    "chaos_mttr_s",
    "chaos_rtt_amp",
    "chaos_rtt_burst_prob",
)

#: Canonical values: exact float32 numbers, deliberately unlike common
#: settings, so a tick that reads the shape key's value instead of the
#: operand fails the bit-exact comparisons loudly.
_CANONICAL: Dict[str, float] = {
    "uplink_loss_prob": 0.4375,
    "send_stop_time": 7.0,  # only when finite (gate: != inf)
    "link_up_s": 0.5,
    "link_drain_s": 0.03125,
    "link_drain2_s": 0.0625,
    "link_rate_bps": 64e6,
    "chaos_mtbf_s": 3.0,
    "chaos_mttr_s": 1.5,
    "chaos_rtt_amp": 0.75,
    "chaos_rtt_period_s": 2.0,
    "chaos_rtt_burst_prob": 0.4375,
    "chaos_rtt_burst_mult": 2.5,
    "chaos_max_retries": 3,
    "learn_discount": 0.875,
    "learn_reward_scale": 0.625,
    "hier_threshold": 0.8125,
    "hier_max_hops": 3,
    "hier_rtt_s": 0.015625,
    # hier_rtt_matrix depends on the broker count: see _canonical_value
    "hier_rtt_matrix": None,
    "idle_power_w": 0.25,
    "tx_energy_j": 0.25,
    "rx_energy_j": 0.25,
    "compute_power_w": 0.25,
    "harvest_power_w": 0.25,
    "harvest_period_s": 1.0,
    "harvest_duty": 0.5,
    "shutdown_frac": 0.125,
    "start_frac": 0.625,
}


@dataclasses.dataclass(frozen=True)
class DynSpec:
    """The promoted knobs: host numpy scalars (:func:`dyn_of`) or device
    tensors (:func:`dyn_to_device`, :func:`dyn_rows`).  A torch pytree
    node, so ``torch.func.vmap`` maps over a row of every leaf."""

    uplink_loss_prob: Union[np.float32, torch.Tensor]
    send_stop_time: Union[np.float32, torch.Tensor]
    link_up_s: Union[np.float32, torch.Tensor]
    link_drain_s: Union[np.float32, torch.Tensor]
    link_drain2_s: Union[np.float32, torch.Tensor]
    link_burst_base: Union[np.float32, torch.Tensor]  # (burst_n - 1) * drain_s
    link_inv_rate: Union[np.float32, torch.Tensor]  # 8 / link_rate_bps
    link_drain_bytes: Union[np.float32, torch.Tensor]  # rate / 8 * dt
    chaos_mtbf_s: Union[np.float32, torch.Tensor]
    chaos_mttr_s: Union[np.float32, torch.Tensor]  # max(mttr, 0)
    chaos_rtt_amp: Union[np.float32, torch.Tensor]
    chaos_rtt_omega: Union[np.float32, torch.Tensor]  # 2 pi / period
    chaos_rtt_burst_prob: Union[np.float32, torch.Tensor]
    chaos_rtt_burst_mult: Union[np.float32, torch.Tensor]
    chaos_max_retries: Union[np.int32, torch.Tensor]
    learn_discount: Union[np.float32, torch.Tensor]
    learn_reward_scale: Union[np.float32, torch.Tensor]
    hier_threshold: Union[np.float32, torch.Tensor]
    hier_max_hops: Union[np.int32, torch.Tensor]
    hier_rtt: Union[np.ndarray, torch.Tensor]  # (B, B) f32
    energy_idle_dt: Union[np.float32, torch.Tensor]  # idle_power_w * dt
    energy_tx_j: Union[np.float32, torch.Tensor]
    energy_rx_j: Union[np.float32, torch.Tensor]
    energy_compute_dt: Union[np.float32, torch.Tensor]  # compute_power_w * dt
    energy_harvest_dt: Union[np.float32, torch.Tensor]  # harvest_power_w * dt
    harvest_period_s: Union[np.float32, torch.Tensor]
    harvest_duty: Union[np.float32, torch.Tensor]
    shutdown_frac: Union[np.float32, torch.Tensor]
    start_frac: Union[np.float32, torch.Tensor]


pytree.register_dataclass(DynSpec)
_LEAVES = tuple(f.name for f in dataclasses.fields(DynSpec))


def dyn_of(spec: WorldSpec) -> DynSpec:
    """The host float32 knobs of ``spec`` (``fognetsimpp_tpu.dynspec.dyn_of``)."""
    f32 = np.float32
    return DynSpec(
        uplink_loss_prob=f32(spec.uplink_loss_prob),
        send_stop_time=f32(spec.send_stop_time),
        link_up_s=f32(spec.link_up_s),
        link_drain_s=f32(spec.link_drain_s),
        link_drain2_s=f32(spec.link_drain2_s),
        link_burst_base=f32(
            float(max(spec.link_burst_n - 1, 0)) * f32(spec.link_drain_s)
        ),
        link_inv_rate=f32(8.0 / spec.link_rate_bps),
        link_drain_bytes=f32(spec.link_rate_bps / 8.0 * spec.dt),
        chaos_mtbf_s=f32(spec.chaos_mtbf_s),
        chaos_mttr_s=f32(max(spec.chaos_mttr_s, 0.0)),
        chaos_rtt_amp=f32(spec.chaos_rtt_amp),
        chaos_rtt_omega=f32(2.0 * np.pi / spec.chaos_rtt_period_s),
        chaos_rtt_burst_prob=f32(spec.chaos_rtt_burst_prob),
        chaos_rtt_burst_mult=f32(spec.chaos_rtt_burst_mult),
        chaos_max_retries=np.int32(spec.chaos_max_retries),
        learn_discount=f32(spec.learn_discount),
        learn_reward_scale=f32(spec.learn_reward_scale),
        hier_threshold=f32(spec.hier_threshold),
        hier_max_hops=np.int32(spec.hier_max_hops),
        hier_rtt=_hier_rtt_of(spec),
        energy_idle_dt=f32(spec.idle_power_w * spec.dt),
        energy_tx_j=f32(spec.tx_energy_j),
        energy_rx_j=f32(spec.rx_energy_j),
        energy_compute_dt=f32(spec.compute_power_w * spec.dt),
        energy_harvest_dt=f32(spec.harvest_power_w * spec.dt),
        harvest_period_s=f32(spec.harvest_period_s),
        harvest_duty=f32(spec.harvest_duty),
        shutdown_frac=f32(spec.shutdown_frac),
        start_frac=f32(spec.start_frac),
    )


def _hier_rtt_of(spec: WorldSpec) -> np.ndarray:
    """The (B, B) float32 inter-broker RTT matrix."""
    B = max(spec.n_brokers, 1)
    if spec.hier_rtt_matrix is not None:
        return np.asarray(spec.hier_rtt_matrix, np.float32)
    rtt = np.full((B, B), np.float32(spec.hier_rtt_s), np.float32)
    np.fill_diagonal(rtt, np.float32(0.0))
    return rtt


# ----------------------------------------------------------------------
# the operand on the device
# ----------------------------------------------------------------------

def _lead(dyn: DynSpec) -> Tuple[int, ...]:
    """The leading (replica) shape of ``dyn``'s leaves: () for one world."""
    return tuple(np.shape(dyn.learn_discount))


def _host_rows(dyn: DynSpec) -> np.ndarray:
    """Every leaf of a host DynSpec as float32 words, (rows, words): one
    row a world of its leading shape, int32 leaves by their bits."""
    n = int(np.prod(_lead(dyn), dtype=np.int64))
    words = []
    for name in _LEAVES:
        a = np.asarray(getattr(dyn, name))
        if a.dtype == np.int32:
            a = a.view(np.float32)
        words.append(a.astype(np.float32, copy=False).reshape(n, -1))
    return np.concatenate(words, axis=1)


def _unpack(buf: torch.Tensor, like: DynSpec, lead: Tuple[int, ...]) -> DynSpec:
    """``like``'s leaves, each with the leading shape ``lead``, as views of
    the device buffer ``buf`` (rows, words)."""
    k = len(_lead(like))
    out, at = {}, 0
    for name in _LEAVES:
        a = np.asarray(getattr(like, name))
        inner = a.shape[k:]
        n = int(np.prod(inner, dtype=np.int64))
        col = buf[:, at: at + n]
        at += n
        if a.dtype == np.int32:
            col = col.view(torch.int32)
        out[name] = col.reshape(lead + inner)
    return DynSpec(**out)


def _upload(host: np.ndarray, device) -> torch.Tensor:
    """One copy of ``host`` to ``device``; to a card from pinned memory
    without waiting for it."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    dev = torch.device(device)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def dyn_to_device(dyn: DynSpec, device) -> DynSpec:
    """The host DynSpec ``dyn`` as tensors on ``device`` (float32, int32,
    and the (B, B) ``hier_rtt``; 0-d, or with ``dyn``'s leading replica
    axis): one packed copy, which does not synchronise with the card."""
    return _unpack(_upload(_host_rows(dyn), device), dyn, _lead(dyn))


def dyn_rows(dyns: Sequence[DynSpec], device, repeats: int = 1) -> DynSpec:
    """Host DynSpecs of one world each stacked into device leaves with a
    leading replica axis, each repeated ``repeats`` times in a row (cell
    i's rows are ``i * repeats`` to ``(i + 1) * repeats - 1``): one packed
    copy."""
    host = np.repeat(np.concatenate([_host_rows(d) for d in dyns]), int(repeats), axis=0)
    return _unpack(_upload(host, device), dyns[0], (host.shape[0],))


def knob(x, device) -> torch.Tensor:
    """A knob as the tick reads it: a host value as a float32 constant on
    ``device``, an operand tensor as given."""
    if isinstance(x, torch.Tensor):
        return x
    return const(float(x), device)


def int_knob(x):
    """An integer knob as a comparison operand: an operand tensor as
    given, a host value as a Python int."""
    return x if isinstance(x, torch.Tensor) else int(x)


def div_knob(num: torch.Tensor, x) -> torch.Tensor:
    """``num / x`` as the reference computes it: a host constant divides
    as a product with its float32 reciprocal (XLA's rewrite of a division
    by a literal), an operand as an IEEE division."""
    if isinstance(x, torch.Tensor):
        return num / x
    return num * const(float(np.float32(1.0) / np.float32(x)), num.device)


# ----------------------------------------------------------------------
# shape keys and retunes
# ----------------------------------------------------------------------

def _canonical_value(spec: WorldSpec, field: str):
    v = getattr(spec, field)
    if field == "send_stop_time":
        # gate: finite vs inf selects the stop-gated spawn
        return v if v == float("inf") else _CANONICAL[field]
    if field == "hier_rtt_matrix":
        # None (the uniform derivation) and explicit matrices keep
        # separate representatives, each canonical within its class
        if v is None:
            return None
        B = spec.n_brokers
        return ((0.0234375,) * B,) * B
    if field in _GATED_POSITIVE and not (v > 0):
        return 0.0
    return _CANONICAL[field]


def shape_key(spec: WorldSpec) -> WorldSpec:
    """The representative of ``spec``'s shape bucket: promoted knobs at
    gate-preserving canonical values, every other field untouched."""
    return dataclasses.replace(
        spec, **{f: _canonical_value(spec, f) for f in DYN_FIELDS}
    )


def split_spec(spec: WorldSpec) -> Tuple[WorldSpec, DynSpec]:
    """``(shape_key(spec), dyn_of(spec))``: the host half of promotion."""
    return shape_key(spec), dyn_of(spec)


def same_program(a: WorldSpec, b: WorldSpec) -> bool:
    """True when ``a`` and ``b`` differ only in promoted knob values."""
    return shape_key(a) == shape_key(b)


def apply_knobs(spec: WorldSpec, knobs: Mapping[str, float]) -> WorldSpec:
    """Retune promoted knobs of a live spec.

    Raises ``ValueError`` (one line) for an unknown or shape-defining
    field, or when the new values change the shape key (flip a gate).
    """
    for k in knobs:
        if k not in DYN_FIELDS:
            why = STATIC_REASONS.get(k)
            if why is not None:
                raise ValueError(
                    f"spec.{k} is shape-defining ({why}): changing it "
                    "needs a recompile — rebuild the world instead of "
                    "re-configuring the live one"
                )
            raise ValueError(
                f"unknown dynamic knob {k!r} (promoted knobs: "
                + ", ".join(DYN_FIELDS) + ")"
            )
    spec2 = dataclasses.replace(spec, **dict(knobs)).validate()
    if shape_key(spec2) != shape_key(spec):
        changed = [
            k for k in knobs
            if _canonical_value(spec2, k) != _canonical_value(spec, k)
        ]
        raise ValueError(
            "knob change flips a trace gate (zero vs positive / finite "
            f"vs inf) on {', '.join(sorted(changed)) or 'a spec field'}: "
            "this needs a recompile — rebuild the world to cross gate "
            "classes"
        )
    return spec2


def promote_default() -> bool:
    """Whether the runners promote by default: ``FNS_SPEC_PROMOTE=0``
    (or off/false/no/empty) keeps the host-constant path, anything else,
    unset included, promotes, as the reference's runners do."""
    env = os.environ.get("FNS_SPEC_PROMOTE", "1")
    return env.strip().lower() not in ("0", "off", "false", "no", "")


def classify_field(field: str) -> Tuple[bool, str]:
    """``(recompiles, reason)`` for a WorldSpec field name, in the
    reference's words; ``ValueError`` for an unknown field."""
    if field in _GATED_POSITIVE or field == "send_stop_time":
        gate = (
            "inf vs finite" if field == "send_stop_time"
            else "zero vs positive"
        )
        return False, (
            "dynamic operand — compiled programs are reused within its "
            f"gate class; crossing {gate} still recompiles"
        )
    if field in DYN_FIELDS:
        return False, "dynamic operand — compiled programs are reused"
    names = {f.name for f in dataclasses.fields(WorldSpec)}
    if field not in names:
        raise ValueError(f"unknown WorldSpec field {field!r}")
    why = STATIC_REASONS.get(field)
    if why is not None:
        return True, why
    return True, "shape/gate/policy-defining — selects a different trace"


# ----------------------------------------------------------------------
# population buckets
# ----------------------------------------------------------------------

#: Populations at or below this are left alone.
BUCKET_FLOOR = 1024

#: Bucket boundaries an octave: powers of two and the 1.5x midpoint.
_BUCKET_STEPS = (1.0, 1.5)


def bucket_users(n: int, floor: int = BUCKET_FLOOR) -> int:
    """Smallest bucket >= ``n`` on the ladder {2^k, 1.5 * 2^k}; ``n``
    itself at or below ``floor``."""
    if n <= floor:
        return n
    p = 1 << (int(n - 1).bit_length() - 1)  # largest power of two <= n-1
    while True:
        for s in _BUCKET_STEPS:
            b = int(p * s)
            if b >= n:
                return b
        p *= 2


def bucket_spec(spec: WorldSpec, state, net, floor: int = BUCKET_FLOOR):
    """Pad ``n_users`` up to its bucket with inert users
    (:func:`~.parallel.taskshard.pad_users_to_multiple`); returns
    ``(spec, state, net)``, unchanged on a bucket boundary or below the
    floor.  Padding changes the per-user draws' width, so a padded world
    is not bit-identical to the unpadded one."""
    from .parallel.taskshard import pad_users_to_multiple

    b = bucket_users(spec.n_users, floor=floor)
    if b == spec.n_users:
        return spec, state, net
    return pad_users_to_multiple(spec, state, net, b)
