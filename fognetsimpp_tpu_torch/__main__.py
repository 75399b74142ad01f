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
summary's keys are ``python -m fognetsimpp_tpu``'s; the flags of modules
still to port raise ``NotImplementedError`` naming their ``ROADMAP.md``
item (:data:`NOT_PORTED`).  One function a run mode: :func:`_run_sweep`,
:func:`_run_tp`, :func:`_run_fleet` and :func:`_run_single`.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

#: Flags whose modules are later items: ``(argparse dest, flag, what)``.
NOT_PORTED = (
    ("serve", "--serve", "the live health plane, telemetry/live.py (ROADMAP.md §1 item 29)"),
    ("serve_chunk", "--serve-chunk", "the live health plane, telemetry/live.py (ROADMAP.md §1 item 29)"),
    ("postmortem", "--postmortem", "the flight recorder, telemetry/live.py (ROADMAP.md §1 item 29)"),
    ("trace_out", "--trace-out", "the Perfetto exporter, telemetry/timeline.py (ROADMAP.md §1 item 29)"),
    ("trace_max_tasks", "--trace-max-tasks", "the Perfetto exporter, telemetry/timeline.py (ROADMAP.md §1 item 29)"),
    ("ingest", "--ingest", "twin ingestion, twin/ingest.py (ROADMAP.md §1 item 16)"),
    ("ingest_batch", "--ingest-batch", "twin ingestion, twin/ingest.py (ROADMAP.md §1 item 16)"),
    ("arrival_log", "--arrival-log", "twin ingestion, twin/ingest.py (ROADMAP.md §1 item 16)"),
    ("replay_arrivals", "--replay-arrivals", "twin ingestion, twin/ingest.py (ROADMAP.md §1 item 16)"),
    ("whatif", "--whatif", "the twin's what-if fork, twin/whatif.py (ROADMAP.md §1 item 16)"),
    ("tenants", "--tenants", "the twin's tenant front door, twin/front.py (ROADMAP.md §1 item 16)"),
    ("tenant_cap", "--tenant-cap", "the twin's tenant front door, twin/front.py (ROADMAP.md §1 item 16)"),
    ("mesh", "--mesh", "replicas across cards, parallel/fleet.py and mesh.py (ROADMAP.md §1 item 27)"),
)


def _parser() -> argparse.ArgumentParser:
    """``python -m fognetsimpp_tpu``'s flags (``--checkify``, a run under
    ``jax.experimental.checkify``, has no PyTorch counterpart)."""
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
                    "per-fog rows to .sca.json")
    ap.add_argument("--hist", action="store_true",
                    help="carry the device-resident streaming latency "
                    "histogram (per-fog log buckets of the task_time "
                    "signal); shorthand for spec.telemetry_hist=true "
                    "(implies --telemetry) — adds lat_* rows to "
                    ".sca.json and the quantiles to the summary")
    ap.add_argument("--journeys", type=int, metavar="N", default=None,
                    help="sample N task slots into device-resident "
                    "journey event rings (telemetry/journeys.py), decoded "
                    "into .sca.json; shorthand for "
                    "spec.telemetry_journeys=N (needs --telemetry)")
    ap.add_argument("--slo", type=float, metavar="MS", default=None,
                    help="task-latency SLO in milliseconds: breaches "
                    "derive from the streaming histogram (implies --hist)")
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
                    "--telemetry/--hist; non-divisible populations are "
                    "padded with inert users")
    ap.add_argument("--tp-window", type=int, metavar="K", default=None,
                    help="per-shard TP arrival-exchange window (slots "
                    "per shard per tick; default: the full candidate "
                    "list, which never defers).  Applies to NO-WINDOW "
                    "specs only")
    ap.add_argument("--replicas", type=int, default=None, metavar="R",
                    help="Monte-Carlo fleet: advance R replica worlds "
                    "(per-replica PRNG streams) on the card in one batch "
                    "(parallel/replicas.run_replicated)")
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
    # flags of modules still to port: parsed, then refused by name
    for _, flag, what in NOT_PORTED:
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help=f"not ported yet: {what}")
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
    if args.tp is not None:
        if args.replicas is not None:
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
        if args.replicas is not None:
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
        if not (args.telemetry or args.hist or args.slo is not None):
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
    if args.telemetry:
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
    for dest, flag, what in NOT_PORTED:
        if getattr(args, dest) is not None:
            raise NotImplementedError(f"not ported yet: {flag}, {what}")
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
    if args.tp is not None:
        return _run_tp(args, cfg, world, attrs, dev)
    if args.replicas is not None:
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
    if args.telemetry or args.profile:
        ap.error("[CLI-SWEEP-TELEM] --sweep returns counter grids, "
                 "not a final world; --telemetry/--trace-out/"
                 "--profile apply to single-scenario runs")
    if args.slo is not None or args.hist:
        ap.error("[CLI-SWEEP-SERVE] --sweep returns counter grids, "
                 "not a live world; --serve/--slo/--hist apply to "
                 "single-scenario runs")
    if args.replicas is not None:
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


def _run_tp(args, cfg, world, attrs, dev) -> int:
    """``--tp N``: one world's task table in N shards on the card."""
    from .parallel.taskshard import run_tp_sharded
    from .runtime.recorder import record_run
    from .runtime.signals import summarize
    from .telemetry.profile import profile_trace

    spec, state, net, bounds = world
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
    out = {
        "scenario": cfg.lookup("scenario", "smoke"),
        "wall_s": round(time.perf_counter() - t0, 3),
        "tp_shards": args.tp,
        "n_users": spec.n_users,  # post-padding population
    }
    outdir = _outdir(args, cfg)
    if outdir:
        run_id = args.run_id or cfg.lookup("output.run_id", "General-0")
        out.update(record_run(outdir, spec, final, run_id=run_id,
                              attrs={**attrs, "tp_shards": args.tp}))
    _profile_keys(out, args, prof)
    s = summarize(final)
    out.update(n_published=s["n_published"], n_completed=s["n_completed"])
    print(json.dumps(out))
    return 0


def _run_fleet(ap, args, cfg, world, attrs, dev) -> int:
    """``--replicas R``: R replica worlds in one batch on the card (JAX's
    ``run_fleet`` on a one-device mesh, which equals its
    ``run_replicated``), promoted as ``run_fleet`` is by default."""
    from .core.engine import run_batched
    from .dynspec import dyn_rows, promote_default, split_spec
    from .parallel import replicate_state
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
    n_devices = 1
    n_replicas = args.replicas
    batch = replicate_state(spec, state, n_replicas, seed=args.seed or 0)
    run_spec, rows = spec, None
    if promote_default():
        run_spec, dyn = split_spec(spec)
        rows = dyn_rows([dyn], dev, repeats=n_replicas)
    t0 = time.perf_counter()
    with profile_trace(args.profile) as prof:
        final, series = run_batched(run_spec, batch, net, bounds, dyn_rows=rows)
        _sync(dev)
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
    _profile_keys(out, args, prof)
    print(json.dumps(out))
    return 0


def _run_single(ap, args, cfg, world, attrs, dev) -> int:
    """One world: ``engine.run`` (series with ``--ticks``/``--trails``),
    or ``run_chunked`` with a progress line a chunk (``--progress``)."""
    from .core.engine import run, run_chunked
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
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
