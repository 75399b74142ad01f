"""Shape and dtype contracts on the tick's phases
(``fognetsimpp_tpu/core/contracts.py``).

Every phase, the whole tick, the telemetry fold and the replica-batched
tick must be endomorphisms over :class:`~..state.WorldState` and
:class:`~.engine.TickBuf`: the same tree structure, the same shapes, the
same dtypes.  A phase that promotes a carry leaf (int8 ``stage`` to
int32, a float32 time to float64) does not crash in eager PyTorch: the
next tick runs on the wider leaf, the run parts from the reference, and a
CUDA graph of the tick (replayed into fixed buffers) would be unsound.
Torch widens integer sums to int64 unless told otherwise, so the hazard
is more common here than under XLA.

The structure is the port's own: a PRNG key is a pair of int64 words
(JAX holds uint32), and the contract holds the port's state to the
port's skeleton.

How a contract is checked.  The callable runs under
``torch._subclasses.FakeTensorMode`` on fake copies of the state's
tensors: shapes and dtypes propagate, no arithmetic runs and no device
memory is taken, on the CPU or the card alike.  It runs on the tensor
route (``device.host_routes(False)``), since the numpy host routes read
a tensor's data; the custom operators of ``ops/`` and ``f32math`` have
fake kernels for it.  Every entry of :data:`PHASE_CONTRACTS`, the tick
(:func:`check_step_contract`), the telemetry fold and the batched tick
(:func:`check_fleet_contract`) take this path; none falls back to a
real run.  The kept device tables of :mod:`..f32math` that a trace
creates are dropped after it.

JAX's registry also traces the fused slot-window front-end; the port
carries the per-phase tick only (``ROADMAP.md`` §1), so those entries
are left out.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..spec import FogModel, Policy, WorldSpec


class ContractError(AssertionError):
    """A tree violated its declared shape/dtype contract."""


def _dtype_name(x) -> str:
    dt = x.dtype
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


def _leaf_struct(x) -> Tuple[tuple, str]:
    return (tuple(x.shape), _dtype_name(x))


def assert_same_struct(expected, got, what: str = "tree") -> None:
    """Raise :class:`ContractError` unless ``got`` has exactly the tree
    structure, shapes and dtypes of ``expected``.  Leaves are tensors
    (real or fake) or numpy arrays; a drifted leaf is named by its dotted
    path."""
    exp_paths, exp_def = pytree.tree_flatten_with_path(expected)
    got_paths, got_def = pytree.tree_flatten_with_path(got)
    if exp_def != got_def:
        raise ContractError(
            f"{what}: tree structure changed\n"
            f"  expected: {exp_def}\n  got:      {got_def}"
        )
    errs = []
    for (path, e), (_, g) in zip(exp_paths, got_paths):
        se, sg = _leaf_struct(e), _leaf_struct(g)
        if se != sg:
            errs.append(
                f"  {pytree.keystr(path)}: expected "
                f"{se[1]}{list(se[0])}, got {sg[1]}{list(sg[0])}"
            )
    if errs:
        raise ContractError(
            f"{what}: {len(errs)} leaf contract violation(s)\n"
            + "\n".join(errs)
        )


def _trace(fn: Callable, tree):
    """``fn(fake copy of tree)`` under ``FakeTensorMode`` on the tensor
    route: shapes and dtypes only, no arithmetic.  The kept tables the
    trace puts into ``f32math`` (fake tensors) are dropped after it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from .. import f32math
    from ..device import host_routes

    kept = dict(f32math._TABLES)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    try:
        with host_routes(False):
            fake = pytree.tree_map_only(torch.Tensor, mode.from_tensor, tree)
            with mode:
                return fn(fake)
    finally:
        f32math._TABLES.clear()
        f32math._TABLES.update(kept)


def _zero_buf(spec: WorldSpec, device):
    from .engine import TickBuf

    def z(shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    U, F = spec.n_users, spec.n_fogs
    return TickBuf(tx_u=z((U,)), rx_u=z((U,)), tx_f=z((F,)), rx_f=z((F,)),
                   tx_b=z(()), rx_b=z(()))


@dataclasses.dataclass(frozen=True)
class PhaseContract:
    """One engine phase and how to call it for a shape-only trace.

    ``call(spec, state, net, cache, buf, t0, t1, dv)`` returns the phase's
    result (``state`` or ``(state, buf)``); ``when`` is the gate under
    which the tick calls the phase (``engine.make_step``)."""

    name: str
    call: Callable
    when: Callable[[WorldSpec], bool] = lambda spec: True


def _contracts() -> Tuple[PhaseContract, ...]:
    from . import engine as E
    from ..envelope import broker_dense_ok

    fifo = lambda sp: sp.n_fogs > 0 and sp.fog_model != int(FogModel.POOL)
    pool = lambda sp: sp.n_fogs > 0 and sp.fog_model == int(FogModel.POOL)
    v2_local = lambda sp: sp.policy == int(Policy.LOCAL_FIRST) and sp.v2_local_broker

    return (
        PhaseContract(
            "_phase_connect",
            lambda sp, s, n, c, b, t0, t1, dv: E._phase_connect(sp, s, c, b, t0, t1),
            when=lambda sp: sp.connect_gating,
        ),
        PhaseContract(
            "_phase_adverts",
            lambda sp, s, n, c, b, t0, t1, dv: E._phase_adverts(s, t1),
        ),
        PhaseContract(
            "_phase_spawn",
            lambda sp, s, n, c, b, t0, t1, dv: E._phase_spawn(sp, s, n, c, b, t0, t1, dv),
            when=lambda sp: sp.max_sends_per_tick <= 1,
        ),
        PhaseContract(
            "_phase_spawn_multi",
            lambda sp, s, n, c, b, t0, t1, dv: E._phase_spawn_multi(
                sp, s, n, c, b, t0, t1, dv),
            when=lambda sp: sp.max_sends_per_tick > 1,
        ),
        PhaseContract(
            # the chunk-boundary injector (``inject_arrivals``), with its
            # default all-padding batch: the padded rows take the same
            # masked writes as real ones
            "_phase_inject",
            lambda sp, s, n, c, b, t0, t1, dv: E._phase_inject(sp, s, c)[0],
            when=lambda sp: sp.ingest,
        ),
        PhaseContract(
            "_phase_v2_release",
            lambda sp, s, n, c, b, t0, t1, dv: E._phase_v2_release(sp, s, c, b, t1, True),
            when=v2_local,
        ),
        PhaseContract(
            "_phase_broker",
            lambda sp, s, n, c, b, t0, t1, dv: E._phase_broker(sp, s, c, b, t1)[:2],
            when=lambda sp: not broker_dense_ok(sp),
        ),
        PhaseContract(
            "_phase_broker_dense",
            lambda sp, s, n, c, b, t0, t1, dv: E._phase_broker_dense(sp, s, c, b, t1),
            when=broker_dense_ok,
        ),
        PhaseContract(
            "_phase_completions",
            lambda sp, s, n, c, b, t0, t1, dv: E._phase_completions(sp, s, c, b, t1),
            when=fifo,
        ),
        PhaseContract(
            "_phase_fog_arrivals",
            lambda sp, s, n, c, b, t0, t1, dv: E._phase_fog_arrivals(sp, s, c, b, t1),
            when=fifo,
        ),
        PhaseContract(
            "_phase_pool_completions",
            lambda sp, s, n, c, b, t0, t1, dv: E._phase_pool_completions(sp, s, c, b, t1),
            when=pool,
        ),
        PhaseContract(
            "_phase_pool_arrivals",
            lambda sp, s, n, c, b, t0, t1, dv: E._phase_pool_arrivals(sp, s, c, b, t1),
            when=pool,
        ),
        PhaseContract(
            "_phase_chaos",
            lambda sp, s, n, c, b, t0, t1, dv: E._phase_chaos(sp, s, c, b, t0, t1, dv),
            when=lambda sp: sp.chaos,
        ),
        PhaseContract(
            "_phase_broker_migrate",
            lambda sp, s, n, c, b, t0, t1, dv: E._phase_broker_migrate(sp, s, b, t1, dv),
            when=E._hier_migrate_on,
        ),
        PhaseContract(
            "_phase_learn_credit",
            lambda sp, s, n, c, b, t0, t1, dv: E._phase_learn_credit(sp, s, t1, dv),
            when=lambda sp: sp.learn_active,
        ),
        PhaseContract(
            "_phase_journeys",
            lambda sp, s, n, c, b, t0, t1, dv: E._phase_journeys(sp, s, t1),
            when=lambda sp: sp.journey_active,
        ),
        PhaseContract(
            "_phase_telemetry",
            lambda sp, s, n, c, b, t0, t1, dv: E._phase_telemetry(
                sp, s, t1, torch.zeros((sp.telemetry_phases,), dtype=torch.int32,
                                       device=t1.device)),
            when=lambda sp: sp.telemetry,
        ),
        PhaseContract(
            "_phase_latency_hist",
            lambda sp, s, n, c, b, t0, t1, dv: E._phase_latency_hist(sp, s, t1),
            when=lambda sp: sp.telemetry_hist,
        ),
        # The tick calls these two under LOCAL_FIRST without the v2
        # broker and under ``adv_periodic``; like JAX's registry, they are
        # traced on every world, where each is a well-defined no-op (no
        # broker-local task runs, or the advert is not due) whose carry
        # must still keep its shapes.
        PhaseContract(
            "_phase_local_completions",
            lambda sp, s, n, c, b, t0, t1, dv: E._phase_local_completions(sp, s, c, b, t1),
        ),
        PhaseContract(
            "_phase_periodic_adverts",
            lambda sp, s, n, c, b, t0, t1, dv: E._phase_periodic_adverts(sp, s, c),
        ),
    )


# Every ``_phase_*`` function of ``core/engine.py``, each once;
# tests/test_torch_contracts.py reads the module to hold the two lists
# equal and traces each entry on at least one world.
PHASE_CONTRACTS: Tuple[PhaseContract, ...] = _contracts()


def check_phase_contracts(spec: WorldSpec, state, net) -> Tuple[str, ...]:
    """Trace every phase whose gate holds under ``spec`` (shapes only);
    raise :class:`ContractError` on any change of the carry's structure.
    Returns the names of the phases checked."""
    from ..dynspec import dyn_of
    from ..net.topology import associate

    dv = dyn_of(spec)
    checked = []
    for pc in PHASE_CONTRACTS:
        if not pc.when(spec):
            continue

        def trace(s, _call=pc.call):
            dev = s.t.device
            cache = associate(net, s.nodes.pos, s.nodes.alive, spec.broker_index)
            t0 = torch.zeros((), dtype=torch.float32, device=dev)
            t1 = torch.full((), spec.dt, dtype=torch.float32, device=dev)
            return _call(spec, s, net, cache, _zero_buf(spec, dev), t0, t1, dv)

        out = _trace(trace, state)
        new_state = out[0] if isinstance(out, tuple) else out
        assert_same_struct(state, new_state, what=f"{pc.name}: WorldState")
        if isinstance(out, tuple) and len(out) >= 2:
            assert_same_struct(_zero_buf(spec, "meta"), out[1], what=f"{pc.name}: TickBuf")
        checked.append(pc.name)
    return tuple(checked)


def check_step_contract(
    spec: WorldSpec, state, net, bounds=None, step: Optional[Callable] = None
) -> None:
    """The whole tick's contract: ``step(state, net, bounds)`` (default
    :func:`.engine.make_step`) returns a state of ``state``'s structure,
    shapes and dtypes.  Pass a wrapper to check an instrumented step."""
    from ..net.mobility import default_bounds
    from .engine import make_step

    if bounds is None:
        bounds = default_bounds(device=state.t.device)
    if step is None:
        step = make_step(spec)
    got = _trace(lambda s: step(s, net, bounds), state)
    assert_same_struct(state, got, what="tick carry (step endomorphism)")


def check_telemetry_contract(spec: WorldSpec, state) -> None:
    """The ``TelemetryState`` carry contract, in two halves: (a) the
    sizing gate: with ``spec.telemetry`` off every telemetry array leaf
    has zero rows, with it on the leaves carry the per-fog, per-phase and
    reservoir sizes (each optional plane under its own gate); (b) with
    telemetry on, ``_phase_telemetry`` keeps the whole state's
    structure."""
    from ..telemetry.journeys import J_COLS
    from ..telemetry.metrics import EXG_OCC_BINS, PHASES, RES_FIELDS

    t = state.telem
    F = spec.n_fogs if spec.telemetry else 0
    P = len(PHASES) if spec.telemetry else 0
    R = spec.telemetry_slots
    # the TP exchange plane: zero rows unless a stamped TP world view
    S = spec.telemetry_tp_shards
    Rs = R if S else 0
    expect = {
        "q_len_sum": (F,), "q_len_max": (F,), "q_len_min": (F,),
        "busy_ticks": (F,), "pool_occ_sum": (F,), "pick_hist": (F,),
        "phase_work": (P,), "res": (R, len(RES_FIELDS)),
        "ticks": (), "defer_sum": (),
        "lat_hist": (spec.telemetry_hist_fogs, spec.telemetry_hist_nbins),
        "lat_sum": (spec.telemetry_hist_fogs,),
        "lat_seen": (spec.telemetry_hist_tasks,),
        "exg_occ_hist": (S, EXG_OCC_BINS),
        "exg_occ_sum": (S,), "exg_cand_sum": (S,),
        "exg_defer_sum": (S,), "exg_defer_max": (S,),
        "exg_util_sum": (S,), "exg_age_max": (S,),
        "exg_occ_res": (Rs, S),
        "hier_load_sum": (spec.telemetry_hier_brokers,),
        "hier_load_res": (
            R if spec.telemetry_hier_brokers else 0,
            spec.telemetry_hier_brokers,
        ),
        "j_task": (spec.journey_slots,),
        "j_prev": (spec.journey_slots, len(J_COLS)),
        "j_ring": (spec.journey_slots, spec.journey_ring, 4),
        "j_cursor": (spec.journey_slots,),
        "j_dropped": (),
    }
    for name, shape in expect.items():
        got = tuple(getattr(t, name).shape)
        if got != shape:
            raise ContractError(
                f"TelemetryState.{name}: expected shape {shape} under "
                f"telemetry={spec.telemetry}, got {got}"
            )
    if spec.telemetry:
        from . import engine as E

        def trace(s):
            dev = s.t.device
            t1 = torch.full((), spec.dt, dtype=torch.float32, device=dev)
            work = torch.zeros((spec.telemetry_phases,), dtype=torch.int32, device=dev)
            return E._phase_telemetry(spec, s, t1, work)

        assert_same_struct(state, _trace(trace, state), what="_phase_telemetry: WorldState")


def check_fleet_contract(spec: WorldSpec, batch, net, bounds=None) -> None:
    """The replica batch's contract: the batched tick
    (:func:`.engine.batched_tick`, one ``torch.func.vmap`` of the step
    over the leading replica axis) keeps every leaf's shape and dtype.
    ``batch`` is a replicated world
    (:func:`..parallel.replicas.replicate_state`); a slot mesh cuts rows
    of it and never changes a shape or a dtype, so one trace covers every
    mesh."""
    from ..net.mobility import default_bounds
    from .engine import batched_tick

    if bounds is None:
        bounds = default_bounds(device=batch.t.device)

    def trace(b):
        tick, _ = batched_tick(spec, net, bounds, b)
        return tick(b)

    assert_same_struct(batch, _trace(trace, batch), what="fleet carry (vmap(step) endomorphism)")
