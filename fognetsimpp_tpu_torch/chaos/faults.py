"""Chaos schedules (device half) and their host readers
(``fognetsimpp_tpu/chaos/faults.py``).

* **Fog lifecycle**: per-fog crash/recover schedules.  A random outage
  draws its (gap, duration) from ``fold_in(fold_in(chaos_key, fog),
  epoch)``, a pure function of (chaos key, fog, outage index), so the
  device machine (:func:`step_lifecycle`) and the host replay
  (:func:`outage_timeline`) read one stream.  Scripted ``(fog, t_down,
  t_up)`` intervals (``spec.chaos_script``) compose on top: a fog is down
  while any source holds it down.
* **Link degradation**: a periodic and a burst factor on the broker->fog
  rows of the tick's delay cache (:func:`rtt_factor`), the bursts keyed
  on the tick index.

The chaos key is folded from the world key, never split from it, so the
world's own stream is the same with chaos on or off.  Every function
here runs on the device its tensors lie on, with no host copy: each draw
is one batched threefry pass over the fogs (the JAX module's vmaps).

Float32 arithmetic is XLA's on the CPU: ``log`` is its inlined Cephes
polynomial (:func:`..f32math.logf`), ``sin`` libm's ``sinf``
(:func:`..f32math.sinf`), and each ``a * b + c`` that XLA contracts is
one fused multiply-add (:func:`..f32math.fma`).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..dynspec import DynSpec, dyn_of, knob
from ..f32math import const, fma, kept_tensor, logf, sinf
from ..random import PRNGKey, fold_in, uniform
from ..spec import ChaosMode, WorldSpec
from ..state import ChaosState

#: Domain separator folded into the world key to derive the chaos stream
#: (so chaos_seed 0 still decorrelates from the world's draws).
_CHAOS_FOLD = 0x0C4A05
#: Separator of the static per-fog RTT phase draw.
_RTT_PHASE_FOLD = 0x0B17
#: Separator of the per-tick RTT burst draws.
_RTT_BURST_FOLD = 0x0B57

_F32 = torch.float32
_I32 = torch.int32
_INF = float("inf")


def _dv(spec: WorldSpec, dyn: Optional[DynSpec]) -> DynSpec:
    """The promoted knobs when the engine passes them, else the spec's
    own values as host constants."""
    return dyn if dyn is not None else dyn_of(spec)


def _chaos_key(spec: WorldSpec, key: torch.Tensor) -> torch.Tensor:
    """The chaos stream of ``spec`` on world key ``key``: folded, so
    turning chaos on consumes nothing of the world's stream."""
    return fold_in(fold_in(key, _CHAOS_FOLD), spec.chaos_seed)


def _outage_draws(
    spec: WorldSpec, key: torch.Tensor, epoch: torch.Tensor,
    dyn: Optional[DynSpec] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gap, duration) exponential draws of each fog's ``epoch``-th
    outage, each at least ``dt``, so an outage spans at least one tick.
    ``epoch`` is (..., F): leading axes draw several epochs a fog in one
    threefry pass.  The uniforms depend on (key, fog, epoch) only: a
    retuned MTBF/MTTR rescales the same stream."""
    dev = key.device
    dv = _dv(spec, dyn)
    fogs = torch.arange(epoch.shape[-1], dtype=torch.int64, device=dev)
    u = uniform(fold_in(fold_in(key, fogs), epoch), (2,), 1e-7, 1.0)  # (..., F, 2)
    dt = const(spec.dt, dev)
    gap = torch.maximum(-knob(dv.chaos_mtbf_s, dev) * logf(u[..., 0]), dt)
    dur = torch.maximum(-knob(dv.chaos_mttr_s, dev) * logf(u[..., 1]), dt)
    return gap, dur


def _rtt_phases(key: torch.Tensor, n_fogs: int) -> torch.Tensor:
    """Each fog's phase offset of the periodic RTT term, in [0, 2 pi)."""
    return uniform(fold_in(key, _RTT_PHASE_FOLD), (n_fogs,), 0.0, 2.0 * np.pi)


def init_chaos_state(spec: WorldSpec, key: torch.Tensor) -> ChaosState:
    """The t=0 chaos state of ``spec`` on world key ``key``, on the key's
    device (zero-row leaves when chaos is off)."""
    dev = key.device
    F, Tc = spec.chaos_fogs, spec.chaos_tasks

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=dev)

    if spec.chaos:
        ck = _chaos_key(spec, key)
        epoch0 = full((F,), 0, _I32)
        if spec.chaos_mtbf_s > 0:
            next_down = _outage_draws(spec, ck, epoch0)[0]
        else:
            next_down = full((F,), _INF, _F32)
        rtt_phase = _rtt_phases(ck, F)
        next_up = full((F,), _INF, _F32)
    else:
        ck = PRNGKey(0, dev)
        epoch0 = full((F,), 0, _I32)
        next_down = full((F,), 0.0, _F32)
        rtt_phase = full((F,), 0.0, _F32)
        next_up = full((F,), 0.0, _F32)
    return ChaosState(
        key=ck,
        next_down=next_down,
        next_up=next_up,
        epoch=epoch0,
        down_ticks=full((F,), 0, _I32),
        rtt_phase=rtt_phase,
        retry=full((Tc,), 0, torch.int8),
        n_crashes=full((), 0, _I32),
        n_recovers=full((), 0, _I32),
        n_lost_crash=full((), 0, _I32),
        n_reoffloaded=full((), 0, _I32),
        n_retry_exhausted=full((), 0, _I32),
    )


def refold_chaos_state(
    spec: WorldSpec, ch: ChaosState, new_key: torch.Tensor
) -> ChaosState:
    """A t=0 chaos state re-keyed onto ``new_key``: the first crash gaps
    and the RTT phases are drawn again from it, so the whole schedule is
    a pure function of the new key (what :func:`outage_timeline`
    replays).  Keys may carry a leading replica axis, ``(R, 2)``: every
    leaf of the result then has it.  Only for a state whose counters
    have not moved (the contract is the reference's, not checked)."""
    if not spec.chaos:
        return ch
    F = ch.epoch.shape[-1]
    if new_key.dim() > 1:
        return torch.func.vmap(lambda k: refold_chaos_state(spec, ch, k))(new_key)
    epoch0 = torch.zeros_like(ch.epoch)
    if spec.chaos_mtbf_s > 0:
        next_down = _outage_draws(spec, new_key, epoch0)[0]
    else:
        next_down = torch.full_like(ch.next_down, _INF)
    return ch.replace(
        key=new_key,
        next_down=next_down,
        next_up=torch.full_like(ch.next_up, _INF),
        rtt_phase=_rtt_phases(new_key, F),
    )


def _script_tensors(spec: WorldSpec, dev):
    """``spec.chaos_script`` as (S,) fog, t_down and t_up tensors on
    ``dev``, the times rounded to float32; copied at the first tick and
    kept, so later ticks copy nothing from the host."""
    fog, td, tu = zip(*spec.chaos_script)
    return (
        kept_tensor(tuple(int(f) for f in fog), torch.int64, dev),
        kept_tensor(tuple(float(t) for t in td), _F32, dev),
        kept_tensor(tuple(float(t) for t in tu), _F32, dev),
    )


def step_lifecycle(
    spec: WorldSpec,
    ch: ChaosState,
    up_prev: torch.Tensor,  # (F,) bool: fog liveness entering this tick
    t0: torch.Tensor,
    t1: torch.Tensor,
    dyn: Optional[DynSpec] = None,
):
    """Advance the outage schedules one tick: ``(ch', up_new, crashed,
    recovered, crash_t, recover_t)``, the edges against ``up_prev`` and
    the per-fog event times clamped into ``[t0, t1]``.

    Recoveries fire first, then crashes.  Every draw is at least ``dt``,
    so neither can fire twice in one tick and every outage is seen by at
    least one tick's dispatch."""
    F = spec.n_fogs
    dev = t1.device
    next_down, next_up, epoch = ch.next_down, ch.next_up, ch.epoch
    inf = const(_INF, dev)

    if spec.chaos_mtbf_s > 0:
        # this outage's duration and the next one's gap, in one pass
        gaps, durs = _outage_draws(spec, ch.key, torch.stack([epoch, epoch + 1]), dyn)
        dur_e, gap_next = durs[0], gaps[1]
        rand_down = torch.isfinite(next_up)
        # 1. recoveries
        rec = rand_down & (next_up < t1)
        rand_rec_t = torch.where(rec, next_up, inf)
        epoch = torch.where(rec, epoch + 1, epoch)
        next_down = torch.where(rec, next_up + gap_next, next_down)
        next_up = torch.where(rec, inf, next_up)
        rand_down = rand_down & ~rec
        # 2. crashes
        crash = ~rand_down & (next_down < t1)
        rand_crash_t = torch.where(crash, next_down, inf)
        next_up = torch.where(crash, next_down + dur_e, next_up)
        next_down = torch.where(crash, inf, next_down)
        rand_down = rand_down | crash
    else:
        rand_down = torch.zeros((F,), dtype=torch.bool, device=dev)
        rand_crash_t = torch.full((F,), _INF, dtype=_F32, device=dev)
        rand_rec_t = rand_crash_t

    # a scripted interval holds its fog down for the tick ending at t1
    # iff t_down < t1 <= t_up; a fog's crash (recovery) time is the
    # earliest start (latest end) of its intervals inside [t0, t1)
    if spec.chaos_script:
        s_fog, s_td, s_tu = _script_tensors(spec, dev)
        onehot = s_fog[:, None] == torch.arange(F, device=dev)[None, :]  # (S, F)
        held = (s_td < t1) & (s_tu >= t1)
        started = (s_td >= t0) & (s_td < t1)
        ended = (s_tu >= t0) & (s_tu < t1)
        scripted_down = (onehot & held[:, None]).any(dim=0)
        s_crash_t = torch.where(onehot & started[:, None], s_td[:, None], _INF).amin(dim=0)
        s_rec_t = torch.where(onehot & ended[:, None], s_tu[:, None], -_INF).amax(dim=0)
    else:
        scripted_down = torch.zeros((F,), dtype=torch.bool, device=dev)
        s_crash_t = torch.full((F,), _INF, dtype=_F32, device=dev)
        s_rec_t = torch.full((F,), -_INF, dtype=_F32, device=dev)

    up_new = ~(rand_down | scripted_down)
    crashed = up_prev & ~up_new
    recovered = ~up_prev & up_new
    crash_t = torch.clamp(torch.minimum(rand_crash_t, s_crash_t), t0, t1)
    # a fog recovers when the last source that held it releases it
    rand_rec = torch.where(torch.isfinite(rand_rec_t), rand_rec_t, -inf)
    recover_t = torch.clamp(torch.maximum(rand_rec, s_rec_t), t0, t1)
    counts = torch.stack([crashed, recovered]).sum(dim=1, dtype=_I32)
    ch = ch.replace(
        next_down=next_down,
        next_up=next_up,
        epoch=epoch,
        down_ticks=ch.down_ticks + (~up_new).to(_I32),
        n_crashes=ch.n_crashes + counts[0],
        n_recovers=ch.n_recovers + counts[1],
    )
    return ch, up_new, crashed, recovered, crash_t, recover_t


def rtt_factor(
    spec: WorldSpec, ch: ChaosState, tick: torch.Tensor, t0: torch.Tensor,
    dyn: Optional[DynSpec] = None,
) -> torch.Tensor:
    """(F,) multiplier of the broker->fog rows of the delay cache.

    Periodic term ``1 + amp * (1 + sin(omega * t + phase_f)) / 2``, each
    fog's phase a static draw of the chaos stream; burst term: a
    Bernoulli(``chaos_rtt_burst_prob``) draw a fog keyed on the tick
    index, multiplying by ``chaos_rtt_burst_mult``.

    ``t0`` is ``tick * dt``, and with ``omega`` a literal XLA folds the two
    constants into one, ``tick * float32(dt * omega)`` (its dumped CPU
    program); the phase is added apart (the product is shared by every
    fog, so it is not contracted), and ``amp / 2 * (1 + sin) + 1`` is one
    fused multiply-add."""
    F = spec.n_fogs
    dev = t0.device
    dv = _dv(spec, dyn)
    fac = torch.ones((F,), dtype=_F32, device=dev)
    if spec.chaos_rtt_amp > 0:
        if isinstance(dv.chaos_rtt_omega, torch.Tensor):
            arg = dv.chaos_rtt_omega * t0
        else:
            rate = np.float32(spec.dt) * np.float32(dv.chaos_rtt_omega)
            arg = tick.to(_F32) * const(float(rate), dev)
        wave = 1.0 + sinf(arg + ch.rtt_phase)
        half_amp = (knob(dv.chaos_rtt_amp, dev) * 0.5).expand(F)
        fac = fma(half_amp, wave, fac)
    if spec.chaos_rtt_burst_prob > 0:
        kb = fold_in(fold_in(ch.key, _RTT_BURST_FOLD), tick.to(_I32))
        burst = uniform(kb, (F,)) < knob(dv.chaos_rtt_burst_prob, dev)
        fac = torch.where(burst, fac * knob(dv.chaos_rtt_burst_mult, dev), fac)
    return fac


# ----------------------------------------------------------------------
# host readers (after a run or a chunk; one fetch each)
# ----------------------------------------------------------------------

def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def outage_timeline(
    spec: WorldSpec,
    chaos_key,
    horizon: Optional[float] = None,
    max_outages_per_fog: int = 10_000,
) -> List[Tuple[int, float, float]]:
    """The full ``(fog, t_down, t_up)`` outage list, replayed on the host.

    Random schedules are the same ``fold_in`` draws the device machine
    reads, accumulated in float32 as the carry is, so the replay is exact;
    scripted intervals are appended as given (clipped to the horizon).
    ``chaos_key`` is ``final.chaos.key`` (constant through a run), a
    tensor on any device or the two words as an array."""
    hz = float(spec.horizon if horizon is None else horizon)
    out: List[Tuple[int, float, float]] = []
    for f, td, tu in spec.chaos_script:
        if float(td) < hz:
            out.append((int(f), float(td), min(float(tu), hz)))
    if spec.chaos and spec.chaos_mtbf_s > 0:
        key = torch.from_numpy(_np(chaos_key).astype(np.int64))
        dt32 = np.float32(spec.dt)
        mtbf32 = np.float32(spec.chaos_mtbf_s)
        mttr32 = np.float32(spec.chaos_mttr_s)
        chunk = 64  # draws fetched 64 epochs at a time
        for f in range(spec.n_fogs):
            kf = fold_in(key, f)
            t = np.float32(0.0)
            done = False
            for e0 in range(0, max_outages_per_fog, chunk):
                epochs = torch.arange(e0, e0 + chunk, dtype=torch.int64)
                u = uniform(fold_in(kf, epochs), (2,), 1e-7, 1.0).numpy()
                gaps = np.maximum(-mtbf32 * np.log(u[:, 0]), dt32)
                durs = np.maximum(-mttr32 * np.log(u[:, 1]), dt32)
                for i in range(chunk):
                    down = np.float32(t + gaps[i])
                    if float(down) >= hz:
                        done = True
                        break
                    up = np.float32(down + durs[i])
                    out.append((f, float(down), min(float(up), hz)))
                    t = up
                if done:
                    break
    out.sort(key=lambda x: (x[0], x[1]))
    return out


def chaos_counters(final) -> dict:
    """The five scalar counters of a chaos run (one small fetch)."""
    ch = final.chaos
    return {
        "crashes": int(_np(ch.n_crashes)),
        "recovers": int(_np(ch.n_recovers)),
        "lost_crash": int(_np(ch.n_lost_crash)),
        "reoffloaded": int(_np(ch.n_reoffloaded)),
        "retry_exhausted": int(_np(ch.n_retry_exhausted)),
    }


def chaos_summary(spec: WorldSpec, final) -> Optional[dict]:
    """The roll-up of a finished chaos run (None when chaos is off): the
    mode, the counters and each fog's ticks down, as plain ints."""
    if not spec.chaos:
        return None
    return {
        "mode": ChaosMode(spec.chaos_mode).name.lower(),
        **chaos_counters(final),
        "down_ticks": [int(x) for x in _np(final.chaos.down_ticks)],
    }
