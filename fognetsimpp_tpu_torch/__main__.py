"""Launcher CLI of the PyTorch port: the ``simulations/run`` analog.

The reference launches ``../src/fognetsim -n .:../src <ini>``
(``simulations/run:1-4``); here::

    python -m fognetsimpp_tpu_torch --config run.ini
    python -m fognetsimpp_tpu_torch --scenario wireless5 \\
        --set spec.horizon=30 --out results/

builds the world from the config tier (:mod:`.config.ini`), runs it on
the card (``--platform cpu`` on the CPU), persists the ``.sca.json`` /
``.vec.npz`` results and their Scave twins (:mod:`.runtime.recorder`) and
prints a one-line JSON summary.  Flags, guard-rail messages and the
summary's keys are ``python -m fognetsimpp_tpu``'s (``--mesh D`` is D
slots on the card, :mod:`.parallel.mesh`).  One function a run mode:
:func:`_run_sweep`, :func:`_run_tp`, :func:`_run_tp_serve`,
:func:`_run_serve` (the live health plane, the twin's ingest session and
the tenant front door), :func:`_run_fleet` and :func:`_run_single`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

def _fleet(args) -> bool:
    """A fleet run: ``--replicas`` or ``--mesh``."""
    return args.replicas is not None or args.mesh is not None


def _parser() -> argparse.ArgumentParser:
    """``python -m fognetsimpp_tpu``'s flags; ``--checkify`` runs the
    world under the port's runtime sanitizer (``core/sanitizer.py``)."""
    from .spec import ARGMIN_FAMILY, LEARNED_POLICIES, Policy

    _policy_catalogue = ", ".join(f"{p.name.lower()}={int(p)}" for p in Policy)
    ap = argparse.ArgumentParser(
        prog="python -m fognetsimpp_tpu_torch",
        description="Fog-computing simulator (FogNetSim++ capability set), "
        "PyTorch/CUDA port",
    )
    ap.add_argument("--config", "-c", help="ini-style config file")
    ap.add_argument("--scenario", "-s", help="scenario builder name")
    ap.add_argument(
        "--policy", "-p", default=None, metavar="NAME|ID",
        help="scheduling policy by name or id (shorthand for "
        f"scenario.policy): {_policy_catalogue}",
    )
    ap.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="config override (e.g. spec.horizon=2.0, fog.0.mips=4000); "
        "repeatable; takes precedence over --config",
    )
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--out", "-o", default=None, help="results directory")
    ap.add_argument("--run-id", default=None,
                    help="defaults to config output.run_id, else General-0")
    ap.add_argument("--ticks", action="store_true",
                    help="record per-tick series vectors")
    ap.add_argument("--telemetry", action="store_true",
                    help="carry device-resident telemetry (per-fog busy "
                    "fractions, queue depths, per-phase work counters, a "
                    "bounded per-tick reservoir) through the run; "
                    "shorthand for spec.telemetry=true — adds the "
                    "per-fog rows to .sca.json and the OpenMetrics "
                    "output")
    ap.add_argument("--hist", action="store_true",
                    help="carry the device-resident streaming latency "
                    "histogram (per-fog log buckets of the task_time "
                    "signal); shorthand for spec.telemetry_hist=true "
                    "(implies --telemetry) — adds '# TYPE histogram' "
                    "series and p50/p95/p99 quantile gauges to the "
                    "OpenMetrics output, lat_* rows to .sca.json and the "
                    "quantiles to the summary")
    ap.add_argument("--journeys", type=int, metavar="N", default=None,
                    help="sample N task slots into device-resident "
                    "journey event rings (telemetry/journeys.py), decoded "
                    "into .sca.json, fns_journey_* families and Perfetto "
                    "flow chains in --trace-out; shorthand for "
                    "spec.telemetry_journeys=N (needs --telemetry)")
    ap.add_argument("--serve", type=int, metavar="PORT", default=None,
                    help="live health plane (telemetry/live.py): run "
                    "the horizon in chunks behind an OpenMetrics pull "
                    "endpoint (GET /metrics, GET /healthz) with an "
                    "EWMA z-score watchdog on queue depth / drop rate "
                    "/ busy fraction; 0 binds an ephemeral port; "
                    "implies --telemetry")
    ap.add_argument("--serve-chunk", type=int, metavar="N", default=1000,
                    help="ticks per serving chunk (default 1000): the "
                    "scrape/watchdog refresh granularity")
    ap.add_argument("--ingest", type=int, nargs="?", const=1024,
                    default=None, metavar="CAP",
                    help="open the live ingestion door under --serve "
                    "(twin/): POST /ingest + in-process arrivals land "
                    "at chunk boundaries through the injector; CAP "
                    "bounds the drop-counted queue (default 1024); "
                    "implies spec.ingest")
    ap.add_argument("--ingest-batch", type=int, metavar="B", default=None,
                    help="max arrivals injected per chunk boundary "
                    "(spec.ingest_batch, default 64)")
    ap.add_argument("--arrival-log", metavar="JSON", default=None,
                    help="write the session's recorded arrival log on "
                    "exit (the replayable input record)")
    ap.add_argument("--replay-arrivals", metavar="JSON", default=None,
                    help="re-inject a recorded arrival log instead of "
                    "serving the live queue: the session reproduces "
                    "the original chunk state hashes bit-exactly")
    ap.add_argument("--whatif", metavar="GRID", default=None,
                    help="answer a promoted-knob grid from the final "
                    "carry, e.g. 'uplink_loss_prob=0.05,0.1 "
                    "ticks=400': K retunings forked from current "
                    "state, H ticks ahead, one replica batch; one "
                    "JSON line per run")
    ap.add_argument("--tenants", type=int, metavar="N", default=None,
                    help="multiplex N tenant sessions of the scenario "
                    "(seeds seed..seed+N-1) behind one endpoint: "
                    "round-robin chunks, per-tenant /t/<label>/metrics|"
                    "healthz|ingest|whatif routing; needs --serve")
    ap.add_argument("--tenant-cap", type=int, metavar="M", default=None,
                    help="front-door admission bound (default: N); "
                    "admitting past it is the one-line [TWIN-CAP] "
                    "rejection")
    ap.add_argument("--slo", type=float, metavar="MS", default=None,
                    help="task-latency SLO in milliseconds: breaches "
                    "derive from the streaming histogram (implies "
                    "--hist) and trip the flight recorder under "
                    "--serve")
    ap.add_argument("--postmortem", metavar="DIR", default=None,
                    help="flight-recorder dump directory: on NaN, SLO "
                    "breach, watchdog anomaly or crash the serving "
                    "loop writes a post-mortem bundle here (inspect "
                    "with tools/postmortem.py)")
    ap.add_argument("--trace-out", metavar="JSON", default=None,
                    help="export the run's task-lifecycle spans as "
                    "Chrome/Perfetto trace-event JSON to this path "
                    "(replica→pid, fog→tid; open in ui.perfetto.dev)")
    ap.add_argument("--trace-max-tasks", type=int, metavar="N",
                    default=100_000,
                    help="cap on tasks per replica in the --trace-out "
                    "export (default 100000: Perfetto chokes on "
                    "multi-hundred-MB traces; 0 = unbounded)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="capture a torch.profiler trace of the run into "
                    "DIR/trace.json (phases show up as record_function "
                    "spans; open with Perfetto)")
    ap.add_argument("--trails", metavar="SVG", default=None,
                    help="render movement/communication trails to this "
                    "SVG (the Tkenv-animation analog; implies --ticks)")
    ap.add_argument("--progress", type=int, metavar="N", default=None,
                    help="run in N-tick chunks, printing a progress line "
                    "per chunk (the Cmdenv status-line analog; excludes "
                    "--ticks)")
    ap.add_argument("--tp", type=int, default=None, metavar="N",
                    help="task-table tensor parallelism: split ONE "
                    "world's user/task axis into N shards on the card "
                    "(parallel/taskshard.run_tp_sharded); dense-broker "
                    "FIFO worlds only — composes with --policy/"
                    "--telemetry/--hist and --serve (the sharded health "
                    "plane: per-shard fns_tp_exchange_* gauges + "
                    "defer-rate watchdog); non-divisible populations are "
                    "padded with inert users")
    ap.add_argument("--tp-window", type=int, metavar="K", default=None,
                    help="per-shard TP arrival-exchange window (slots "
                    "per shard per tick; default: the full candidate "
                    "list, which never defers).  Applies to NO-WINDOW "
                    "specs only")
    ap.add_argument("--replicas", type=int, default=None, metavar="R",
                    help="Monte-Carlo fleet: advance R replica worlds "
                    "(per-replica PRNG streams) split over the mesh's "
                    "slots on the card (parallel/fleet.py); R must "
                    "divide evenly over the mesh")
    ap.add_argument("--mesh", type=int, default=None, metavar="D",
                    help="slots of the replica mesh on the card (default "
                    "1), each advancing R/D replicas as one batch; "
                    "implies --replicas D when --replicas is omitted")
    ap.add_argument("--brokers", type=int, metavar="B", default=None,
                    help="federated multi-broker hierarchy (hier/): "
                    "partition users and fogs into B broker domains "
                    "with broker↔broker task migration; shorthand for "
                    "spec.n_brokers=B; B must be in [1, n_fogs]")
    ap.add_argument("--hier-policy", metavar="NAME", default=None,
                    help="broker↔broker migration policy: never, "
                    "threshold, or least_loaded; needs --brokers B with "
                    "B > 1; refine knobs with --set spec.hier_*=...")
    ap.add_argument("--chaos", metavar="PROFILE", default=None,
                    help="deterministic fault injection (chaos/): run "
                    "the scenario under a named chaos profile (light, "
                    "heavy, flaky, degraded, hostile, scripted); refine "
                    "any knob with --set spec.chaos_*=...")
    ap.add_argument("--chaos-seed", type=int, metavar="N", default=None,
                    help="seed of the chaos PRNG stream; needs --chaos")
    ap.add_argument("--chaos-mode", metavar="MODE", default=None,
                    help="in-flight task handling on a crash: 'lose' "
                    "or 'reoffload' (overrides the profile); needs "
                    "--chaos")
    ap.add_argument("--chaos-script", metavar="FILE", default=None,
                    help="scripted outage schedule: JSON list of "
                    "[fog, t_down, t_up] triples (or the compact "
                    "'fog:td:tu;...' text form); needs --chaos")
    ap.add_argument("--platform", default=None,
                    help="'cpu' runs on the CPU; default the CUDA card")
    ap.add_argument("--checkify", nargs="?", const="div", default=None,
                    metavar="SETS",
                    help="debug SLOW PATH: run under the runtime sanitizer "
                    "with the named error sets (comma-joined from "
                    "nan,div,oob, or 'all'; default div — "
                    "engine.CHECKIFY_SETS documents why nan/oob are not "
                    "the default); also enabled by FNS_CHECKIFY=1 or "
                    "FNS_CHECKIFY=<SETS>")
    ap.add_argument("--analyze", metavar="DIR", default=None,
                    help="analyse recorded runs in DIR and exit (.anf analog)")
    _dyn_names = ", ".join(
        p.name.lower() for p in tuple(ARGMIN_FAMILY) + tuple(LEARNED_POLICIES)
    )
    ap.add_argument("--sweep", metavar="GRID", default=None,
                    help="policy x load sweep over the scenario, e.g. "
                    "'policies=min_busy,ucb loads=0.01,0.02,0.05 reps=4 "
                    "dynamic=1' — policies by name or id; one JSON line "
                    "per (policy, load); dynamic=1 runs the whole grid "
                    f"as ONE batch (Policy.DYNAMIC: {_dyn_names}); "
                    "'policy=ucb explores=0.1,0.5 loads=...' instead "
                    "sweeps a learned policy's exploration-rate x load "
                    "grid")
    return ap


def _device(args):
    """The run's device: the CPU for ``--platform cpu``, else the card."""
    from .device import resolve_device

    if args.platform is None:
        return resolve_device(None)
    if args.platform.lower() == "cpu":
        return resolve_device("cpu")
    if args.platform.lower() in ("cuda", "gpu"):
        return resolve_device(None)
    raise ValueError(f"unknown platform {args.platform!r} (have cpu, cuda)")


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _guard(ap, args):
    """JAX's guard rails for the paths the port runs: ``ap.error`` for the
    ``[CLI-*]`` / ``[TP-*]`` cells, else an exit code for the one-line
    ``error:`` refusals, or None to go on."""
    # the opt-in runtime sanitizer: --checkify wins, else the
    # FNS_CHECKIFY env knob ("1"/set names; "0"/"" = off)
    if args.checkify is None:
        env = os.environ.get("FNS_CHECKIFY", "")
        if env.lower() not in ("", "0", "off", "false", "no"):
            args.checkify = env
    if args.checkify is not None and (
        args.serve is not None
        or args.replicas is not None
        or args.mesh is not None
        or args.tp is not None
        or args.sweep
        or args.progress
    ):
        ap.error("[CLI-CHECKIFY-SOLO] --checkify/FNS_CHECKIFY is the "
                 "single-world debug slow path; it does not combine with "
                 "--serve/--replicas/--mesh/--tp/--sweep/--progress")
    if args.tp is not None:
        if _fleet(args):
            ap.error("[CLI-TP-FLEET] --tp shards ONE world's task table "
                     "over the mesh; --replicas/--mesh fan out "
                     "independent worlds — pick one parallel axis per run")
        if args.sweep:
            ap.error("[CLI-SWEEP-TP] --sweep owns its own replica "
                     "fan-out; it does not combine with --tp")
        if args.progress or args.ticks or args.trails:
            ap.error("[TP-SERIES] --tp runs one jitted sharded scan; "
                     "--progress/--ticks/--trails do not apply")
    elif args.tp_window is not None:
        ap.error("[CLI-TPWINDOW] --tp-window sizes the TP arrival "
                 "exchange; it needs --tp N")

    # the twin's rails cite the gate module's [TWIN-*] clauses
    if args.ingest is not None or args.replay_arrivals is not None:
        from .twin.gates import ingest_needs_serve_error, ingest_reject_reason

        if args.tp is not None:
            ap.error(ingest_reject_reason("tp"))
        if _fleet(args):
            ap.error(ingest_reject_reason("fleet"))
        if args.serve is None:
            ap.error(ingest_needs_serve_error())
        if args.ingest is not None and args.ingest < 1:
            ap.error(f"--ingest queue capacity must be >= 1, got "
                     f"{args.ingest}")
    if args.whatif is not None:
        from .dynspec import promote_default
        from .twin.gates import whatif_reject_reason

        reason = whatif_reject_reason(
            fleet=_fleet(args), promote=promote_default(),
        )
        if reason:
            ap.error(reason)
        if args.sweep:
            ap.error("[CLI-SWEEP-TWIN] --sweep builds every cell's "
                     "world at t=0; --whatif forks a LIVE carry — they "
                     "do not combine")
    if args.tenants is not None:
        from .twin.gates import front_reject_reason

        if args.tenants < 1:
            ap.error(f"--tenants must be >= 1, got {args.tenants}")
        if args.tp is not None:
            ap.error(front_reject_reason("tp"))
        if _fleet(args):
            ap.error(front_reject_reason("fleet"))
        if args.serve is None:
            ap.error(front_reject_reason("solo"))
        if args.whatif is not None:
            ap.error("[CLI-TENANTS-WHATIF] per-tenant what-ifs ride "
                     "the front door's /t/<label>/whatif routes; the "
                     "--whatif one-shot applies to single-session runs")
        if args.replay_arrivals is not None or args.arrival_log:
            ap.error("[CLI-TENANTS-REPLAY] arrival logs are per "
                     "session; record/replay a tenant through the "
                     "single-session --serve --ingest path")
    elif args.tenant_cap is not None:
        ap.error("[CLI-TENANTCAP] --tenant-cap bounds front-door "
                 "admission; it needs --tenants N")

    if args.brokers is not None:
        if args.brokers < 1:
            print(
                f"error: --brokers must be >= 1, got {args.brokers} "
                "(1 = the single base broker, B > 1 federates)",
                file=sys.stderr,
            )
            return 2
        if args.tp is not None:
            ap.error("[TP-HIER] --brokers federates ONE world's decide "
                     "phase; the TP sharded tick does not carry the "
                     "hierarchy yet — pick one of --brokers/--tp per run")
        if _fleet(args):
            ap.error("[FLEET-HIER] --brokers federates ONE world; the "
                     "fleet runner does not carry the hierarchy yet — "
                     "run federated worlds without --replicas/--mesh")
        if args.sweep:
            ap.error("[CLI-SWEEP-HIER] --sweep grids own their replica "
                     "fan-out and do not carry the hierarchy; run "
                     "federated worlds without --sweep")
    if args.hier_policy is not None:
        if args.brokers is None or args.brokers < 2:
            print(
                "error: [CLI-HIERPOLICY] --hier-policy selects the "
                "broker↔broker migration policy; it needs --brokers B "
                "with B > 1",
                file=sys.stderr,
            )
            return 2
        from .spec import hier_policy_from_name

        try:
            args.hier_policy = int(hier_policy_from_name(args.hier_policy))
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    if args.chaos is None:
        for flag, val in (("--chaos-seed", args.chaos_seed),
                          ("--chaos-mode", args.chaos_mode),
                          ("--chaos-script", args.chaos_script)):
            if val is not None:
                ap.error(f"[CLI-CHAOS-KNOBS] {flag} refines a chaos "
                         "profile; it needs --chaos <profile>")
    elif args.sweep:
        ap.error("[CLI-SWEEP-CHAOS] --chaos perturbs one world's fault "
                 "schedule; --sweep grids own their replica fan-out — "
                 "run chaos worlds without --sweep")

    if args.journeys is not None:
        if args.journeys < 1:
            print(
                f"error: --journeys samples N >= 1 task slots, got "
                f"{args.journeys} (omit the flag to disable the "
                "journey plane)",
                file=sys.stderr,
            )
            return 2
        if not (args.telemetry or args.hist or args.serve is not None
                or args.slo is not None):
            print(
                "error: [SPEC-JOURNEYS-TELEM] --journeys rides the "
                "device-resident telemetry plane (the event rings live "
                "in TelemetryState); add --telemetry (or --serve/--hist)",
                file=sys.stderr,
            )
            return 2
    return None


def _config_lines(ap, args):
    """The config lines the flags stand for, above the ``--config`` file
    (first match wins): ``(lines, None)`` or ``(None, exit code)``."""
    pre = []
    if args.scenario:
        pre.append(f"scenario = {args.scenario}")
    if args.policy is not None:
        pre.append(f"scenario.policy = {args.policy}")
    for o in args.set:
        if "=" not in o:
            ap.error(f"--set needs KEY=VALUE, got {o!r}")
        pre.append(o.replace("=", " = ", 1))
        key = o.split("=", 1)[0].strip()
        if key.startswith("spec.") and "*" not in key:
            # which knobs re-use the run's shapes and which define them,
            # said before the run; an unknown field fails here
            from .dynspec import classify_field

            try:
                recompiles, why = classify_field(key[5:])
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return None, 2
            print(
                f"recompile: {'yes' if recompiles else 'no'} "
                f"({key}: {why})",
                file=sys.stderr,
            )
    if args.chaos is not None:
        # profile lines land BELOW the --set overrides (first match
        # wins), so --set spec.chaos_*=... refines any profile knob
        from .chaos.profiles import chaos_config_lines, load_script_file

        try:
            script = (
                load_script_file(args.chaos_script)
                if args.chaos_script is not None else None
            )
            pre += chaos_config_lines(
                args.chaos, seed=args.chaos_seed,
                mode=args.chaos_mode, script=script,
            )
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return None, 2
    if args.brokers is not None:
        pre.append(f"spec.n_brokers = {args.brokers}")
    if args.hier_policy is not None:
        pre.append(f"spec.hier_policy = {args.hier_policy}")
    if args.ticks or args.trails:
        pre.append("spec.record_tick_series = true")
    if args.trails:
        pre.append("spec.record_trails = true")
    if args.ingest is not None or args.replay_arrivals is not None:
        pre.append("spec.ingest = true")
    if args.ingest_batch is not None:
        pre.append(f"spec.ingest_batch = {args.ingest_batch}")
    if args.telemetry or args.serve is not None:
        pre.append("spec.telemetry = true")
    if args.hist or args.slo is not None:
        pre.append("spec.telemetry = true")
        pre.append("spec.telemetry_hist = true")
    if args.journeys is not None:
        pre.append(f"spec.telemetry_journeys = {args.journeys}")
    return pre, None


def main(argv=None) -> int:
    from .spec import policy_from_name

    ap = _parser()
    args = ap.parse_args(argv)
    if args.policy is not None:
        try:
            args.policy = int(policy_from_name(args.policy))
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    if args.analyze:
        from .runtime.analysis import analyze, render_report

        print(render_report(analyze(args.analyze)))
        return 0

    try:
        dev = _device(args)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    code = _guard(ap, args)
    if code is not None:
        return code
    pre, code = _config_lines(ap, args)
    if code is not None:
        return code
    text = ""
    if args.config:
        with open(args.config) as f:
            text = f.read()
    from .config.ini import Config, build_from_config

    cfg = Config.from_str("\n".join(pre) + "\n" + text)
    if args.sweep:
        return _run_sweep(ap, args, cfg, dev)
    try:
        world = build_from_config(cfg, seed=args.seed, device=dev)
    except ValueError as e:
        # e.g. an .ini naming an unknown scenario: one line, listing the
        # known names
        print(f"error: {e}", file=sys.stderr)
        return 2
    attrs = {
        "argv": sys.argv[1:] if argv is None else list(argv),
        "scenario": cfg.lookup("scenario", "smoke"),
    }
    if args.tp is not None and args.serve is not None:
        return _run_tp_serve(args, cfg, world, argv, dev)
    if args.tp is not None:
        return _run_tp(args, cfg, world, attrs, dev)
    if args.serve is not None:
        return _run_serve(ap, args, cfg, world, argv, dev)
    if _fleet(args):
        return _run_fleet(ap, args, cfg, world, attrs, dev)
    return _run_single(ap, args, cfg, world, attrs, dev)


def _outdir(args, cfg):
    return args.out or cfg.lookup("output.dir")


def _profile_keys(out: dict, args, prof) -> None:
    if args.profile:
        out["profile_dir"] = prof["dir"] if prof["active"] else None
        if prof["error"]:
            out["profile_error"] = prof["error"]


def _run_sweep(ap, args, cfg, dev) -> int:
    """``--sweep``: a policy x load (or exploration-rate x load) grid of
    replica batches, one JSON line a cell."""
    import numpy as np

    from .config.ini import scenario_builders
    from .parallel import sweep_explore, sweep_policies
    from .spec import LEARNED_POLICIES, policy_from_name

    if args.ticks or args.trails:
        ap.error("[CLI-SWEEP-SERIES] --sweep is incompatible with "
                 "--ticks/--trails (sweeps return counter grids, "
                 "not series)")
    if args.telemetry or args.trace_out or args.profile:
        ap.error("[CLI-SWEEP-TELEM] --sweep returns counter grids, "
                 "not a final world; --telemetry/--trace-out/"
                 "--profile apply to single-scenario runs")
    if args.serve is not None or args.slo is not None or args.hist:
        ap.error("[CLI-SWEEP-SERVE] --sweep returns counter grids, "
                 "not a live world; --serve/--slo/--hist apply to "
                 "single-scenario runs")
    if _fleet(args):
        ap.error("[CLI-SWEEP-FLEET] --sweep owns its own replica "
                 "fan-out (reps=); --replicas/--mesh apply to "
                 "single-scenario runs")
    if args.policy is not None:
        print(
            "error: [CLI-SWEEP-POLICY] --policy conflicts with "
            "--sweep (the sweep owns the policy axis: use "
            "'policies=...' or 'policy=...' inside the grid spec)",
            file=sys.stderr,
        )
        return 2
    opts = dict(kv.split("=", 1) for kv in args.sweep.split())
    try:
        policies = [
            int(policy_from_name(p)) for p in opts.get("policies", "0").split(",")
        ]
        explores = (
            [float(x) for x in opts["explores"].split(",")]
            if "explores" in opts else None
        )
        exp_policy = (
            int(policy_from_name(opts["policy"])) if "policy" in opts else None
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if explores is not None and exp_policy is None:
        print(
            "error: explores= sweeps need policy=<learned policy> "
            f"(one of {', '.join(p.name.lower() for p in LEARNED_POLICIES)})",
            file=sys.stderr,
        )
        return 2
    if exp_policy is not None and explores is None:
        print(
            "error: policy= selects the exploration-rate sweep and "
            "needs explores=<rates>; for a plain policy grid use "
            "policies=... instead",
            file=sys.stderr,
        )
        return 2
    loads = [float(x) for x in opts.get("loads", "0.05").split(",")]
    reps = int(opts.get("reps", "1"))
    dynamic = opts.get("dynamic", "0") not in ("0", "false", "")
    name = cfg.lookup("scenario", "smoke")
    builders = scenario_builders()
    if name not in builders:
        ap.error(f"unknown scenario {name!r} (have {sorted(builders)})")
    # the sweep passes only scenario.* kwargs to the builder: refuse
    # override tiers it cannot honour rather than run another world
    unsupported = sorted({
        pat.split(".", 1)[0] for pat, _, _ in cfg.entries
        if pat.split(".", 1)[0] in ("spec", "fog", "user")
    })
    if unsupported:
        ap.error(
            "--sweep supports scenario.* overrides only; "
            f"{', '.join(u + '.*' for u in unsupported)} overrides "
            "are not applied in sweep mode — move them into the "
            "scenario builder's kwargs or run without --sweep"
        )
    build_kwargs = cfg.matching("scenario")
    build_kwargs.pop("seed", None)
    # the sweep owns the policy axis
    build_kwargs.pop("policy", None)
    build_kwargs["device"] = dev
    t0 = time.perf_counter()
    if explores is not None:
        try:
            grids = sweep_explore(
                builders[name], policy=exp_policy, explore_rates=explores,
                load_intervals=loads, n_replicas_per_load=reps,
                seed=args.seed or 0, **build_kwargs,
            )
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        for rate, g in grids.items():
            for li, load in enumerate(loads):
                # the mean over the replicas that credited anything; null
                # where none did
                cell = g["lat_mean_s"][li]
                lm = float(np.nanmean(cell)) if np.isfinite(cell).any() else None
                print(json.dumps({
                    "policy": exp_policy, "explore": rate,
                    "send_interval": load,
                    "n_scheduled_mean": float(g["n_scheduled"][li].mean()),
                    "n_completed_mean": float(g["n_completed"][li].mean()),
                    "lat_mean_s": lm,
                    "reps": reps,
                }))
        print(json.dumps({"sweep_wall_s": round(time.perf_counter() - t0, 2),
                          "explores": explores, "scenario": name}))
        return 0
    try:
        grids = sweep_policies(
            builders[name], policies=policies, load_intervals=loads,
            n_replicas_per_load=reps, dynamic=dynamic, seed=args.seed or 0,
            **build_kwargs,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for pol, g in grids.items():
        for li, load in enumerate(loads):
            print(json.dumps({
                "policy": pol, "send_interval": load,
                "n_scheduled_mean": float(g["n_scheduled"][li].mean()),
                "n_completed_mean": float(g["n_completed"][li].mean()),
                "n_dropped_mean": float(g["n_dropped"][li].mean()),
                "reps": reps,
            }))
    print(json.dumps({"sweep_wall_s": round(time.perf_counter() - t0, 2),
                      "dynamic": dynamic, "scenario": name}))
    return 0


def _trace_key(out: dict, args, spec, final) -> None:
    """``--trace-out``: the Perfetto export's path under ``trace``."""
    if args.trace_out:
        from .telemetry.timeline import export_trace

        out["trace"] = export_trace(
            spec, final, args.trace_out, max_tasks=args.trace_max_tasks or None,
        )


def _whatif_extra(args, spec, carry, net, bounds) -> dict:
    """``--whatif``: the knob grid answered from the run's final carry
    (``{}`` without the flag); raises ``ValueError`` with the grid's and
    the knobs' one-line errors."""
    if args.whatif is None:
        return {}
    from .twin.whatif import _json_safe, parse_grid, run_whatif

    knobs, ticks = parse_grid(args.whatif)
    return {"whatif": _json_safe(run_whatif(spec, carry, net, bounds, knobs, ticks))}


def _tp_whatif(args, spec, final, net, bounds) -> dict:
    """``--whatif`` from a TP run's carry, re-described unsharded."""
    if args.whatif is None:
        return {}
    from .parallel.taskshard import unstamp_tp_carry

    sp_w, carry = unstamp_tp_carry(spec, final)
    return _whatif_extra(args, sp_w, carry, net, bounds)


def _prepad_for_whatif(args, world):
    """Pads the population to the shard count before a TP run that a
    ``--whatif`` forks, so the fork's net is the padded world's."""
    spec, state, net, bounds = world
    if args.whatif is not None and spec.n_users % args.tp:
        from .parallel.taskshard import pad_users_to_multiple

        spec, state, net = pad_users_to_multiple(spec, state, net, args.tp)
    return spec, state, net, bounds


def _run_tp(args, cfg, world, attrs, dev) -> int:
    """``--tp N``: one world's task table in N shards on the card."""
    from .parallel.taskshard import run_tp_sharded
    from .runtime.recorder import record_run
    from .runtime.signals import summarize
    from .telemetry.profile import profile_trace

    spec, state, net, bounds = _prepad_for_whatif(args, world)
    t0 = time.perf_counter()
    try:
        with profile_trace(args.profile) as prof:
            spec, final = run_tp_sharded(
                spec, state, net, bounds, n_shards=args.tp,
                exchange_window=args.tp_window, pad=True,
            )
            _sync(dev)
    except ValueError as e:
        # e.g. a policy outside the dense-broker TP family: one line
        print(f"error: {e}", file=sys.stderr)
        return 2
    wall = time.perf_counter() - t0
    try:
        wi = _tp_whatif(args, spec, final, net, bounds)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    out = {
        "scenario": cfg.lookup("scenario", "smoke"),
        "wall_s": round(wall, 3),
        "tp_shards": args.tp,
        "n_users": spec.n_users,  # post-padding population
        **wi,
    }
    outdir = _outdir(args, cfg)
    if outdir:
        run_id = args.run_id or cfg.lookup("output.run_id", "General-0")
        out.update(record_run(outdir, spec, final, run_id=run_id,
                              attrs={**attrs, "tp_shards": args.tp}))
    _trace_key(out, args, spec, final)
    _profile_keys(out, args, prof)
    s = summarize(final)
    out.update(n_published=s["n_published"], n_completed=s["n_completed"])
    print(json.dumps(out))
    return 0


def _announce(health) -> None:
    """One status line a served chunk (the Cmdenv progress analog)."""
    print(json.dumps(health), flush=True)


def _finish_serve(args, cfg, argv, spec, final, status, t0, prof, extra=None) -> int:
    """The ``--serve`` epilogue of every serving branch: the summary line,
    the recording, the trace and profile keys, the server closed."""
    from .runtime.recorder import record_run
    from .runtime.signals import summarize

    out = {
        "scenario": cfg.lookup("scenario", "smoke"),
        "wall_s": round(time.perf_counter() - t0, 3),
        **(extra or {}),
        "port": status["port"],
        "chunks": status["chunks"],
        "anomalies": status["anomalies"],
        "slo_breaches": status["slo_breaches"],
        "dumps": status["dumps"],
    }
    outdir = _outdir(args, cfg)
    if outdir:
        run_id = args.run_id or cfg.lookup("output.run_id", "General-0")
        out.update(record_run(
            outdir, spec, final, run_id=run_id,
            attrs={
                "argv": sys.argv[1:] if argv is None else list(argv),
                "scenario": cfg.lookup("scenario", "smoke"),
                "served_port": status["port"],
                **{k: v for k, v in (extra or {}).items() if k == "tp_shards"},
            },
        ))
    _trace_key(out, args, spec, final)
    _profile_keys(out, args, prof)
    s = summarize(final)
    out.update(n_published=s["n_published"], n_completed=s["n_completed"])
    if status["server"] is not None:
        status["server"].close()
    print(json.dumps(out))
    return 0


def _retune_door(args, spec):
    """The ``POST /reconfigure`` door and its server (promoted runners
    only), or ``(None, None)``."""
    from .dynspec import promote_default
    from .telemetry.live import HealthServer, ReconfigDoor

    if not promote_default():
        return None, None
    door = ReconfigDoor(spec)
    server = HealthServer(port=args.serve)
    server.set_handler(door.handle_http)
    return door, server


def _run_tp_serve(args, cfg, world, argv, dev) -> int:
    """``--serve --tp N``: the sharded health plane (``serve_tp_run``)."""
    from .telemetry.live import serve_tp_run
    from .telemetry.profile import profile_trace

    t0 = time.perf_counter()
    spec, state, net, bounds = _prepad_for_whatif(args, world)
    door, server = _retune_door(args, spec)
    try:
        with profile_trace(args.profile) as prof:
            spec, final, status = serve_tp_run(
                spec, state, net, bounds, n_shards=args.tp,
                exchange_window=args.tp_window,
                chunk_ticks=args.serve_chunk,
                port=args.serve,
                slo_ms=args.slo,
                dump_dir=args.postmortem,
                on_chunk=_announce,
                server=server,
                **({"reconfigure": door.as_reconfigure()} if door is not None else {}),
            )
    except ValueError as e:
        if server is not None:
            server.close()
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        wi = _tp_whatif(args, spec, final, net, bounds)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return _finish_serve(
        args, cfg, argv, spec, final, status, t0, prof,
        extra={
            "tp_shards": args.tp,
            "n_users": spec.n_users,  # post-padding population
            **({"reconfigured": door.applied_batches} if door is not None else {}),
            **wi,
        },
    )


def _run_serve(ap, args, cfg, world, argv, dev) -> int:
    """``--serve PORT``: the tenant front door (``--tenants``), the twin's
    ingest session (``--ingest`` / ``--replay-arrivals``) or the plain
    serving loop with its retune door."""
    from .telemetry.profile import profile_trace

    if args.progress or args.ticks or args.trails:
        ap.error("[CLI-SERVE-SERIES] --serve owns the chunking "
                 "(--serve-chunk); --progress/--ticks/--trails do "
                 "not apply")
    if _fleet(args):
        ap.error("[CLI-SERVE-FLEET] --serve is a single-world loop; "
                 "fleet serving is a follow-up (run --replicas "
                 "without --serve)")
    spec, state, net, bounds = world
    if args.tenants is not None:
        from .config.ini import build_from_config
        from .twin.front import FrontDoor

        t0 = time.perf_counter()
        cap = args.tenant_cap if args.tenant_cap is not None else args.tenants
        door = FrontDoor(capacity=cap, chunk_ticks=args.serve_chunk, port=args.serve)
        try:
            for i in range(args.tenants):
                sp_i, st_i, net_i, b_i = build_from_config(
                    cfg, seed=(args.seed or 0) + i, device=dev)
                door.admit(f"t{i}", sp_i, st_i, net_i, b_i,
                           ingest_capacity=args.ingest or 1024)
        except ValueError as e:
            # a duplicate label, a telemetry-less spec, [TWIN-CAP]
            door.close()
            print(f"error: {e}", file=sys.stderr)
            return 2
        rounds = -(-spec.n_ticks // args.serve_chunk)
        ticks = door.serve(rounds)
        out = {
            "scenario": cfg.lookup("scenario", "smoke"),
            "tenants": args.tenants,
            "tenant_cap": cap,
            "port": door.server.port if door.server else None,
            "rounds": rounds,
            "ticks": ticks,
            "published": {r["label"]: r["n_published"] for r in door.tenant_rows()},
            "wall_s": round(time.perf_counter() - t0, 3),
        }
        door.close()
        print(json.dumps(out))
        return 0

    t0 = time.perf_counter()
    if args.ingest is not None or args.replay_arrivals is not None:
        from .twin.ingest import load_log, serve_ingest_run

        replay = load_log(args.replay_arrivals) if args.replay_arrivals else None
        with profile_trace(args.profile) as prof:
            final, status = serve_ingest_run(
                spec, state, net, bounds,
                capacity=args.ingest or 1024,
                chunk_ticks=args.serve_chunk,
                port=args.serve,
                replay_log=replay,
                slo_ms=args.slo,
                dump_dir=args.postmortem,
                on_chunk=_announce,
            )
        if args.arrival_log:
            with open(args.arrival_log, "w") as f:
                json.dump({"capacity": status["ingest"]["capacity"],
                           "entries": status["arrival_log"]}, f, indent=1)
        try:
            wi = _whatif_extra(args, spec, final, net, bounds)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        return _finish_serve(args, cfg, argv, spec, final, status, t0, prof,
                             extra={"ingest": status["ingest"], **wi})

    from .telemetry.live import serve_run

    door, server = _retune_door(args, spec)
    with profile_trace(args.profile) as prof:
        final, status = serve_run(
            spec, state, net, bounds,
            chunk_ticks=args.serve_chunk,
            port=args.serve,
            slo_ms=args.slo,
            dump_dir=args.postmortem,
            on_chunk=_announce,
            server=server,
            **({"reconfigure": door.as_reconfigure()} if door is not None else {}),
        )
    try:
        wi = _whatif_extra(args, spec, final, net, bounds)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if door is not None:
        wi = {"reconfigured": door.applied_batches, **wi}
    return _finish_serve(args, cfg, argv, spec, final, status, t0, prof, extra=wi)


def _run_fleet(ap, args, cfg, world, attrs, dev) -> int:
    """``--replicas R`` / ``--mesh D``: R replica worlds over a mesh of D
    slots on the card (``run_fleet``; ``run_fleet_series`` with
    ``--ticks``), promoted as ``run_fleet`` is by default."""
    from .parallel import make_mesh, replicate_state
    from .parallel.fleet import run_fleet, run_fleet_series
    from .runtime.recorder import fleet_scalars, record_fleet_run
    from .telemetry.profile import profile_trace

    if args.progress:
        ap.error("[CLI-FLEET-PROGRESS] --replicas/--mesh and "
                 "--progress are mutually exclusive (the fleet scan "
                 "is one jitted call)")
    if args.trails:
        ap.error("[CLI-FLEET-TRAILS] --trails renders one world's "
                 "movement; slice a replica out of a fleet run "
                 "instead")
    spec, state, net, bounds = world
    try:
        mesh = make_mesh(args.mesh, device=dev)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    n_devices = mesh.size
    n_replicas = args.replicas if args.replicas is not None else n_devices
    batch = replicate_state(spec, state, n_replicas, seed=args.seed or 0)
    t0 = time.perf_counter()
    try:
        with profile_trace(args.profile) as prof:
            if args.ticks:
                final, series = run_fleet_series(spec, batch, net, bounds, mesh)
            else:
                final = run_fleet(spec, batch, net, bounds, mesh)
                series = None
            _sync(dev)
    except ValueError as e:
        # e.g. a replica count that does not divide over the mesh
        print(f"error: {e}", file=sys.stderr)
        return 2
    wall = time.perf_counter() - t0
    fs = fleet_scalars(spec, final)
    out = {
        "scenario": cfg.lookup("scenario", "smoke"),
        "wall_s": round(wall, 3),
        "n_replicas": n_replicas,
        "n_devices": n_devices,
        "n_published_sum": int(fs["aggregate"]["n_published"]["sum"]),
        "n_completed_sum": int(fs["aggregate"]["n_completed"]["sum"]),
        "n_completed_minmax": [
            int(fs["aggregate"]["n_completed"]["min"]),
            int(fs["aggregate"]["n_completed"]["max"]),
        ],
    }
    outdir = _outdir(args, cfg)
    if outdir:
        run_id = args.run_id or cfg.lookup("output.run_id", "Fleet-0")
        out.update(record_fleet_run(
            outdir, spec, final, series=series, run_id=run_id,
            attrs={**attrs, "n_devices": n_devices}, scalars=fs,
        ))
    _trace_key(out, args, spec, final)
    _profile_keys(out, args, prof)
    print(json.dumps(out))
    return 0


def _run_single(ap, args, cfg, world, attrs, dev) -> int:
    """One world: ``engine.run`` (series with ``--ticks``/``--trails``),
    ``run_chunked`` with a progress line a chunk (``--progress``), or
    ``run_checkified`` (``--checkify``)."""
    from .core.engine import _checkify_errors, run, run_checkified, run_chunked
    from .core.sanitizer import CheckifyError
    from .runtime.recorder import record_run
    from .runtime.signals import summarize
    from .telemetry.profile import profile_trace

    spec, state, net, bounds = world
    t0 = time.perf_counter()
    with profile_trace(args.profile) as prof:
        if args.progress:
            if args.ticks or args.trails:
                ap.error("[CLI-PROGRESS-SERIES] --progress and "
                         "--ticks/--trails are mutually exclusive "
                         "(chunked runs record via snapshots, not "
                         "series)")

            def _cb(s, tick):
                m = summarize(s)
                print(json.dumps({
                    "tick": tick, "t": round(tick * spec.dt, 6),
                    "n_published": m["n_published"],
                    "n_completed": m["n_completed"],
                    "wall_s": round(time.perf_counter() - t0, 2),
                }), flush=True)

            final = run_chunked(spec, state, net, bounds,
                                chunk_ticks=args.progress, callback=_cb)
            series = None
        elif args.checkify is not None:
            try:
                _checkify_errors(args.checkify)  # unknown set names
            except ValueError as e:
                print(f"error: checkify: {e}", file=sys.stderr)
                return 1
            try:
                final, series = run_checkified(
                    spec, state, net, bounds, errors=args.checkify
                )
            except CheckifyError as e:
                # a tripped check: one line naming the set and the
                # operator; any other error keeps its traceback
                print(f"error: checkify: {e}", file=sys.stderr)
                return 1
        else:
            final, series = run(spec, state, net, bounds)
        _sync(dev)
    wall = time.perf_counter() - t0

    out = {"scenario": cfg.lookup("scenario", "smoke"), "wall_s": round(wall, 3)}
    outdir = _outdir(args, cfg)
    if outdir:
        run_id = args.run_id or cfg.lookup("output.run_id", "General-0")
        out.update(record_run(outdir, spec, final, series=series,
                              run_id=run_id, attrs=attrs))
    if args.trails:
        from .runtime.trails import render_trails_svg

        out["trails"] = render_trails_svg(spec, final, series, args.trails, net=net)
    _trace_key(out, args, spec, final)
    _profile_keys(out, args, prof)
    s = summarize(final)
    out.update(
        n_published=s["n_published"], n_completed=s["n_completed"],
        task_time_mean_ms=round(s["task_time_mean_ms"], 3)
        if s["task_time_mean_ms"] == s["task_time_mean_ms"] else None,
    )
    if spec.telemetry_hist:
        # the streaming histogram's roll-up (the recorder's hist_summary)
        from .telemetry.health import hist_summary, slo_breach_count

        hist = hist_summary(spec, final)
        out["lat_quantiles_ms"] = {
            k: (round(v, 3) if v == v else None)
            for k, v in hist["quantiles_ms"].items()
        }
        if args.slo is not None:
            out["slo_ms"] = args.slo
            out["slo_breaches"] = slo_breach_count(spec, final, args.slo, summ=hist)
    try:
        out.update(_whatif_extra(args, spec, final, net, bounds))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
