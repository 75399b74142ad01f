"""Results recorder: the ``.sca`` / ``.vec`` output layer
(``fognetsimpp_tpu/runtime/recorder.py``, copied for the port's states).

The reference's L5 (SURVEY.md §1): OMNeT++ records ``@statistic`` signals
into ``results/General-0.sca`` (scalars at finish) and ``.vec`` (sample
vectors), which ``.anf`` descriptors then analyse.  Here a finished run is
persisted as

  * ``<run>.sca.json`` — run attributes (scenario, seed, spec) + every
    scalar :func:`~.signals.summarize` produces (counts, per-signal
    mean/max), per-module rows and the telemetry, chaos, hierarchy and
    journey sections;
  * ``<run>.vec.npz`` — the per-task signal vectors
    (:func:`~.signals.extract_signals`) plus any per-tick series from
    ``spec.record_tick_series`` under ``tick.<name>``;
  * ``<run>.om.txt`` — the OpenMetrics exposition
    (:mod:`..telemetry.openmetrics`);
  * with ``scave=True`` the OMNeT++ text twins (:mod:`.scave`).

The keys and values are JAX's, with one
part left out by design: the ``compile_cache`` section (XLA's program
cache, which has no PyTorch counterpart).  A finished state is read back
to the host once, at the top of each writer.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional

import numpy as np

from ..spec import WorldSpec
from ..parallel.fleet import fleet_busy_fractions_per_replica, fleet_phase_work
from ..state import WorldState, tree_map
from .signals import extract_signals, summarize


def to_host(tree):
    """A port state (or any dataclass tree of tensors) with every leaf
    on the CPU: one copy a leaf, after which ``np.asarray`` reads it."""
    return tree_map(lambda x: x.detach().cpu(), tree)


def spec_to_dict(spec: WorldSpec) -> Dict:
    """JSON-safe spec dict: non-finite floats become the string "inf".

    ``json.dump`` would otherwise emit the non-standard ``Infinity`` token
    (invalid per RFC 8259) for fields like ``send_stop_time``;
    :func:`dict_to_spec` reverses the encoding.
    """
    d = dataclasses.asdict(spec)  # recurses into BugCompat
    for k, v in d.items():
        if isinstance(v, float) and not np.isfinite(v):
            d[k] = "inf" if v > 0 else "-inf"
    return d


def dict_to_spec(d: Dict) -> WorldSpec:
    """Inverse of :func:`spec_to_dict`."""
    from ..spec import BugCompat

    d = dict(d)
    for k, v in d.items():
        if v == "inf":
            d[k] = float("inf")
        elif v == "-inf":
            d[k] = float("-inf")
    d["bug_compat"] = BugCompat(**d["bug_compat"])
    if "chaos_script" in d:
        # JSON round-trips the scripted-outage tuples as lists, which
        # would make the reconstructed spec unhashable under jit
        d["chaos_script"] = tuple(
            (int(f), float(td), float(tu))
            for f, td, tu in d["chaos_script"]
        )
    if d.get("hier_rtt_matrix") is not None:
        # same listification hazard for the inter-broker RTT matrix
        d["hier_rtt_matrix"] = tuple(
            tuple(float(x) for x in row) for row in d["hier_rtt_matrix"]
        )
    return WorldSpec(**d).validate()


def per_module_scalars(
    spec: WorldSpec, final: WorldState, hist: Optional[Dict] = None
) -> Dict:
    """Per-module scalar rows: the reference's per-host ``.sca`` section.

    OMNeT++ records scalars per module path (the example run has ~1.5k
    rows, e.g. ``WirelessNet.ComputeBroker1.udpApp[0] echoedPk:count``);
    here every user and fog node gets its own scalar dict reconstructed
    from the task table and node state.
    """
    from ..spec import Stage

    final = to_host(final)
    t = final.tasks
    user = np.asarray(t.user)
    stage = np.asarray(t.stage)
    fog = np.asarray(t.fog)
    used = stage != int(Stage.UNUSED)
    ack6 = np.isfinite(np.asarray(t.t_ack6))
    done = stage == int(Stage.DONE)
    U, F = spec.n_users, spec.n_fogs

    # one bincount pass per statistic (O(U + F + T), not per-module scans)
    u_sent = np.bincount(user[used], minlength=U)
    u_done = np.bincount(user[used & done], minlength=U)
    u_ack6 = np.bincount(user[used & ack6], minlength=U)
    fmask = fog >= 0
    f_assigned = np.bincount(fog[fmask], minlength=F)
    f_done = np.bincount(fog[fmask & done], minlength=F)
    n_delivered = np.asarray(final.users.n_delivered)
    energy = np.asarray(final.nodes.energy)
    alive = np.asarray(final.nodes.alive)
    busy = np.asarray(final.fogs.busy_time)
    pool = np.asarray(final.fogs.pool_avail)
    q_len = np.asarray(final.fogs.q_len)
    q_drops = np.asarray(final.fogs.q_drops)
    learn_picks = (
        np.asarray(final.learn.pick_count) if spec.learn_active else None
    )
    # plane-1 telemetry rows (telemetry/metrics.py): the per-fog busy
    # fraction comes from busy_fractions() — the SAME call the
    # OpenMetrics exposition uses, so .sca.json and the scrape output
    # can never drift
    from ..telemetry.metrics import telemetry_summary

    telem = telemetry_summary(spec, final)
    busy_frac = telem["busy_frac"] if telem is not None else None
    # streaming latency histogram: the per-fog quantile rows
    # come from hist_summary() — the SAME call the OpenMetrics quantile
    # gauges read, so .sca.json and the scrape agree exactly (record_run
    # computes the dict once and passes it in; standalone callers derive
    # it here)
    if hist is None:
        from ..telemetry.health import hist_summary

        hist = hist_summary(spec, final)
    # stack-level rows: per-node message counters — the
    # "packets sent"/"packets received" and per-NIC traffic rows of the
    # reference's ~1.5k-scalar .sca — plus per-AP association occupancy.
    # (Unlike the reference's numSent, which skips advertisement sends —
    # ComputeBrokerApp2.cc:202-219 has no numSent++ — these counters see
    # every message the simulation moves.)
    tx = np.asarray(final.nodes.tx_count)
    rx = np.asarray(final.nodes.rx_count)
    # int64 before the multiply: int32 * python int stays int32 under
    # NumPy 2 promotion and wraps negative at benchmark scale
    link_bytes = (tx.astype(np.int64) + rx) * int(spec.task_bytes)
    n_ticks = max(int(np.asarray(final.tick)), 1)
    assoc_sum = np.asarray(final.nodes.assoc_sum)
    broker_i = spec.broker_index

    users = [
        {
            "sent": int(u_sent[u]),
            "completed": int(u_done[u]),
            "acked6": int(u_ack6[u]),
            "delivered": int(n_delivered[u]),
            "energy_j": float(energy[u]),
            "alive": bool(alive[u]),
            "tx_msgs": int(tx[u]),
            "rx_msgs": int(rx[u]),
            "link_bytes": int(link_bytes[u]),
        }
        for u in range(U)
    ]
    fogs = [
        {
            "assigned": int(f_assigned[f]),
            "completed": int(f_done[f]),
            "busy_time": float(busy[f]),
            "pool_avail": float(pool[f]),
            "q_len": int(q_len[f]),
            "q_drops": int(q_drops[f]),
            "tx_msgs": int(tx[U + f]),
            "rx_msgs": int(rx[U + f]),
            "link_bytes": int(link_bytes[U + f]),
            # bandit-scheduler arm row (the learnPicks[f] scalar): only
            # present when the learn subsystem is live for this spec
            **(
                {"learn_picks": float(learn_picks[f])}
                if learn_picks is not None
                else {}
            ),
            # device-resident telemetry rows (spec.telemetry)
            **(
                {
                    "busy_frac": float(busy_frac[f]),
                    "q_len_mean": float(telem["q_len_mean"][f]),
                    "q_len_peak": int(telem["q_len_max"][f]),
                }
                if telem is not None
                else {}
            ),
            # streaming latency-histogram rows (spec.telemetry_hist)
            **(
                {
                    "lat_count": int(hist["per_fog_count"][f]),
                    "lat_sum_ms": float(hist["per_fog_sum_ms"][f]),
                    **{
                        f"lat_{q}_ms": float(vec[f])
                        for q, vec in hist[
                            "per_fog_quantiles_ms"
                        ].items()
                    },
                }
                if hist is not None
                else {}
            ),
        }
        for f in range(F)
    ]
    broker = {
        "tx_msgs": int(tx[broker_i]),
        # the reference's BaseBroker `echoedPk:count` analog: everything
        # the broker app processed
        "rx_msgs": int(rx[broker_i]),
        "link_bytes": int(link_bytes[broker_i]),
        "local_pool": float(np.asarray(final.broker.local_pool)),
    }
    a0, a1 = spec.ap_slice
    aps = [
        {
            "assoc_mean": float(assoc_sum[a] / n_ticks),
            "assoc_sum": int(assoc_sum[a]),
        }
        for a in range(a0, a1)
    ]
    out = {"user": users, "fog": fogs, "broker": broker, "ap": aps}
    # per-shard TP exchange-plane rows: present only on
    # stamped TP runs — same exchange_summary() dict the OpenMetrics
    # fns_tp_exchange_* families render, so the two cannot drift
    ex = telem.get("tp_exchange") if telem is not None else None
    if ex is not None:
        out["tp_shard"] = [
            {
                "occ_mean": float(ex["occ_mean"][s]),
                "occ_hist": [int(c) for c in ex["occ_hist"][s]],
                "candidates": int(ex["cand"][s]),
                "deferred": int(ex["defer_sum"][s]),
                "deferred_max": int(ex["defer_max"][s]),
                "util_mean": float(ex["util_mean"][s]),
                "defer_age_ticks_max": float(ex["age_max_ticks"][s]),
            }
            for s in range(ex["n_shards"])
        ]
    return out


def _json_sanitize(obj):
    """Recursively map non-finite floats to None (JSON null)."""
    if isinstance(obj, dict):
        return {k: _json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_sanitize(v) for v in obj]
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


def record_run(
    outdir: str,
    spec: WorldSpec,
    final: WorldState,
    series: Optional[Dict] = None,
    run_id: str = "General-0",
    attrs: Optional[Dict] = None,
    scave: bool = True,
    extra_vectors: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, str]:
    """Persist one finished run. Returns {'sca': path, 'vec': path}.

    ``scave=True`` additionally emits OMNeT++ text-format twins
    (``<run_id>.sca`` / ``.vec`` + a ``General.anf`` descriptor) readable
    by the reference's Scave tooling (:mod:`.scave`).

    ``extra_vectors`` adds caller-computed signal vectors to the
    ``.vec.npz`` under their given names (unlike ``series``, whose keys
    get the ``tick.`` prefix) — the regret harness emits its
    ``learnRegret``/``learnPicks`` curves this way (learn/eval.py).
    """
    os.makedirs(outdir, exist_ok=True)
    sca_path = os.path.join(outdir, f"{run_id}.sca.json")
    vec_path = os.path.join(outdir, f"{run_id}.vec.npz")

    from ..telemetry.health import hist_summary

    final = to_host(final)

    hist = hist_summary(spec, final)
    if spec.chaos:
        from ..chaos.faults import chaos_summary

        chaos_sca = chaos_summary(spec, final)
    else:
        chaos_sca = None
    if spec.hier_active:
        from ..hier.federation import hier_summary

        hier_sca = hier_summary(spec, final)
        # the strided load lanes are Perfetto/live material, not .sca
        # scalars — drop the arrays, keep the per-broker means
        hier_sca = {
            k: v for k, v in hier_sca.items()
            if k not in ("load_rows", "load_rows_t")
        }
    else:
        hier_sca = None
    if spec.journey_active:
        from ..telemetry.journeys import journey_summary

        journey_sca = journey_summary(spec, final)
    else:
        journey_sca = None
    sca = {
        "run": run_id,
        "recorded_at": time.strftime("%Y-%m-%d %H:%M:%S"),
        "attrs": attrs or {},
        "spec": spec_to_dict(spec),
        "scalars": summarize(final),
        "modules": per_module_scalars(spec, final, hist=hist),
        # chaos fault-injection section (spec.chaos): the
        # same chaos_summary() dict the fns_chaos_* exposition and the
        # flight-recorder manifests read, so the outputs cannot drift
        **({"chaos": chaos_sca} if chaos_sca is not None else {}),
        # federated-hierarchy section (spec.n_brokers > 1, hier/): the
        # same hier_summary() dict the fns_hier_* exposition and the
        # Perfetto broker lanes read, so the outputs cannot drift
        **({"hier": hier_sca} if hier_sca is not None else {}),
        # causal task-journey section (spec.telemetry_journeys): the
        # same journey_summary() dict the fns_journey_*
        # exposition and the Perfetto journey lanes read — per-task
        # decoded event chains included (J and the ring bound it)
        **(
            {"journeys": journey_sca}
            if journey_sca is not None
            else {}
        ),
        # global latency-histogram roll-up (spec.telemetry_hist): the
        # quantiles are hist_summary()'s — identical to the OpenMetrics
        # quantile gauges by construction
        **(
            {
                "hist": {
                    "count": hist["count"],
                    "sum_ms": hist["sum_ms"],
                    "edges_ms": [float(e) for e in hist["edges_ms"]],
                    "counts": hist["counts"].tolist(),
                    "quantiles_ms": {
                        k: float(v)
                        for k, v in hist["quantiles_ms"].items()
                    },
                }
            }
            if hist is not None
            else {}
        ),
    }
    # RFC-8259-valid output: summarize() yields nan means for
    # empty signal vectors and json.dump would emit literal NaN tokens —
    # encode non-finite scalars as null instead
    sca = _json_sanitize(sca)
    with open(sca_path, "w") as f:
        json.dump(sca, f, indent=1, default=str, allow_nan=False)

    vectors = dict(extract_signals(final))
    if series is not None:
        for k, v in series.items():
            vectors[f"tick.{k}"] = np.asarray(v)
    if extra_vectors is not None:
        for k, v in extra_vectors.items():
            vectors[k] = np.asarray(v)
    np.savez_compressed(vec_path, **vectors)
    paths = {"sca": sca_path, "vec": vec_path}
    # the OpenMetrics exposition, always written: the run counters exist
    # on every run, the per-fog gauges join with spec.telemetry
    from ..telemetry.openmetrics import write_openmetrics

    paths["om"] = write_openmetrics(
        os.path.join(outdir, f"{run_id}.om.txt"), spec, final, hist=hist
    )
    if scave:
        from .scave import NETWORK_NAMES, export_scave

        network = (attrs or {}).get(
            "network",
            NETWORK_NAMES.get((attrs or {}).get("scenario", ""), "Network"),
        )
        sc = export_scave(
            outdir, spec, final, series=series, run_id=run_id,
            attrs=attrs, network=network,
        )
        paths.update(
            {"sca_txt": sc["sca"], "vec_txt": sc["vec"], "anf": sc["anf"]}
        )
    return paths


def fleet_scalars(spec: WorldSpec, final_batch: WorldState) -> Dict:
    """Aggregate a fleet run's metric counters across the replica axis.

    ``final_batch`` is the replica-batched final state of
    :func:`..parallel.replicas.run_replicated` (``replica_counters`` is
    the single host gather).  Returns ``{"n_replicas", "per_replica",
    "aggregate"}`` where ``aggregate`` carries sum/mean/min/max per
    counter — the Monte-Carlo summary the reference would need N
    process launches plus a results-merging script to produce.
    """
    from ..parallel.replicas import replica_counters

    counters = replica_counters(final_batch)
    n_replicas = int(next(iter(counters.values())).shape[0])
    per_replica = {k: np.asarray(v).tolist() for k, v in counters.items()}
    aggregate = {
        k: {
            "sum": float(np.sum(v)),
            "mean": float(np.mean(v)),
            "min": float(np.min(v)),
            "max": float(np.max(v)),
        }
        for k, v in counters.items()
    }
    return {
        "n_replicas": n_replicas,
        "per_replica": per_replica,
        "aggregate": aggregate,
    }


def record_fleet_run(
    outdir: str,
    spec: WorldSpec,
    final_batch: WorldState,
    series: Optional[Dict] = None,
    run_id: str = "Fleet-0",
    attrs: Optional[Dict] = None,
    scalars: Optional[Dict] = None,
) -> Dict[str, str]:
    """Persist one finished fleet run: ``<run_id>.fleet.sca.json`` (spec +
    replica-aggregated scalars) and, when per-tick ``series`` were
    recorded (host arrays of shape ``(R, n_ticks, ...)``), a
    ``.fleet.vec.npz``
    with one ``tick.<name>`` entry per series vector.

    A fleet is R worlds, so the per-task signal extraction of
    :func:`record_run` (single-world ``.sca``/``.vec`` twins) does not
    apply; slice one replica out of the batch and use :func:`record_run`
    for a full single-world record.

    ``scalars``: a precomputed :func:`fleet_scalars` dict — pass it when
    the caller already gathered the counters (the CLI does, for its JSON
    summary) so the host gather is not repeated.  Beside them
    ``<run_id>.fleet.om.txt``, the OpenMetrics exposition: the aggregated
    counters and each replica's per-fog busy fractions and phase work.
    """
    from ..telemetry.health import hist_summary

    os.makedirs(outdir, exist_ok=True)
    sca_path = os.path.join(outdir, f"{run_id}.fleet.sca.json")
    # replica-merged latency histogram (hist_summary sums the leading
    # replica axis of the batched TelemetryState)
    hist = hist_summary(spec, final_batch)
    sca = {
        "run": run_id,
        "recorded_at": time.strftime("%Y-%m-%d %H:%M:%S"),
        "attrs": attrs or {},
        "spec": spec_to_dict(spec),
        "fleet": (
            scalars if scalars is not None
            else fleet_scalars(spec, final_batch)
        ),
        **(
            {
                "hist": {
                    "count": hist["count"],
                    "sum_ms": hist["sum_ms"],
                    "quantiles_ms": {
                        k: float(v)
                        for k, v in hist["quantiles_ms"].items()
                    },
                }
            }
            if hist is not None
            else {}
        ),
    }
    with open(sca_path, "w") as f:
        json.dump(_json_sanitize(sca), f, indent=1, default=str,
                  allow_nan=False)
    paths = {"sca": sca_path}
    from ..telemetry.openmetrics import render_fleet_openmetrics

    # .fleet.-namespaced, so a record_run into the same directory and
    # run id never overwrites it
    om_path = os.path.join(outdir, f"{run_id}.fleet.om.txt")
    with open(om_path, "w") as f:
        f.write(render_fleet_openmetrics(
            sca["fleet"],
            fleet_busy_fractions_per_replica(spec, final_batch),
            hist=hist,
            phase_work=fleet_phase_work(spec, final_batch),
        ))
    paths["om"] = om_path
    if series is not None:
        vec_path = os.path.join(outdir, f"{run_id}.fleet.vec.npz")
        np.savez_compressed(
            vec_path, **{f"tick.{k}": np.asarray(v) for k, v in series.items()}
        )
        paths["vec"] = vec_path
    return paths


def load_scalars(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_vectors(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
