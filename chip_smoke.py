#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits nonzero:

1. device: the card, its power limit (``nvidia-smi``), TF32 off;
2. build: ``nvcc`` compiles ``fognetsimpp_tpu_torch/csrc/*.cu`` for sm_90a,
   one process a source, all at once (seconds, registers and shared memory
   from ``-Xptxas -v``);
3. kernels: each CUDA kernel against its plain PyTorch version on the same
   card inputs (bit for bit), on the windows the main paths meet and
   on windows that take the kernels' other paths: ``fused_arrival_plan``
   at the bench's K = 4096 and at the tp world's gathered window of
   4 x 34,142 rows, 64 fogs, each with every masked row in one fog (tick
   0's count of them) and empty (the later ticks), and with fogs drawn
   uniformly, all times equal, +0.0 and -0.0 among the times, and one
   bucket at and one past a sorted run; the device time per call of each
   (from ``torch.profiler``), its launches a call (at most 5), the
   wrapper's wall time per call, no host synchronisation in the wrapper,
   and the least time the function could take on these inputs, with its
   counts; beside the arrival kernels the port's torch sort composition
   ``ops/queues._sort_rank`` (a composition, not one library call: none
   computes this function), and beside the ring all-gather one
   ``torch.cat(blocks, out=...)`` a shard, the library call that computes
   the same function;
4. smoke: ``smoke.build(horizon=0.5)`` on the card against the same world on
   the CPU, every leaf equal, and the run's summary;
5. bench: the bench world at full width (10,000 users x 32 fogs, K = 4096,
   queue 128, derive_acks, 0.1 s) at dt 5 ms and dt 1 ms: card against CPU
   every leaf, decisions per second and ms per tick on the card after a
   warm-up run, and the arrival kernel's launches on that run;
6. wide_fog: 2,048 users x 1,040 fogs, where the fog axis is past the
   fused kernel's envelope and ``pairwise_rank`` carries the plan;
7. profile: where a bench tick's time goes on the card (kernel launches,
   device time and idle share per tick, the heaviest kernels, the window's
   masked rows a tick), and the arrival kernel timed on the first window
   of the run that holds rows;
8. tp: ``bench.py::tp_measurement``'s world (2^20 users x 64 fogs, 50
   ticks of 5 ms, 9,437,184 task rows) under ``run_tp_sharded`` at four
   shards with the bench's exchange window: card against CPU every leaf
   over the first ``TP_CHECK_TICKS`` ticks (also the warm-up), then the
   whole horizon timed (decisions per second, ms per tick, the ring and
   arrival kernels' launches), and profiles of two ticks from tick 0 and
   from the horizon (``tp_profile``), where the arrival kernel is also
   held against its plain version on every window that holds rows, and
   timed on the first of them;
9. tp_window: the bench world of phase 5 (dt 5 ms, K = 4096) under
   ``run_tp_sharded`` at four shards, the windowed top-K exchange, against
   the single-device ``engine.run`` on the card, every leaf;
10. wireless: ``benchmarks.py::config4``'s world at one replica, full
   width (``wireless5``: 10,000 mobile, battery-powered users, 64 APs with
   the Bianchi MAC keyed by offered load, ENERGY_AWARE, 100 ticks of
   5 ms, T = 140,000 task rows): a stepped card run that keeps every
   arrival window and tick 0's per-cell sum input, ``fused_arrival_plan``
   against its plain version on every non-empty window, ``engine.run``
   timed after it (decisions per second, ms per tick, launches), card
   against CPU every leaf, ``n_lost``, the least alive count and the
   handovers; ``cell_sum_ordered`` against its plain version (bit for
   bit) on tick 0's real input, on every entry in one cell, on dropped
   entries, on inexact rates, on config 4's 128 replicas flattened
   (1,288,832 entries, 8,192 cells) and on cells past the warp tier
   (``scenarios/cell_sum_inputs.kernel_cases``), timed beside
   ``index_add_``, its launches a call (at most 4) and the largest cell's
   chain of adds at the SM clock; and the profile of a wireless tick
   (``wireless_profile``);
11. wireless_churn: ``tests/test_parity_wireless.py``'s fast-cycling
   battery world at dt 10 ms under MIN_BUSY (8 users, 400 ticks), stepped
   on the card watching ``nodes.alive`` (at least one user shut down and
   one restarted), card against CPU every leaf;

12. rr_grid: ``benchmarks.py::config2`` (96 users x 4 fogs, ROUND_ROBIN
   on the compacted broker, K = 1,024), cut to 250 of its 1,000 ticks of
   1 ms: a stepped card run that keeps every arrival window, with
   ``fused_arrival_plan`` held against its plain version on every
   non-empty one (and timed on the first), then ``engine.run`` timed
   (decisions per second, ms per tick, launches), card against CPU every
   leaf, and a short profile (device events a tick);
13. policies: the bench world of phase 5 (dt 5 ms) under MIN_BUSY
   without the ``mips0_divisor`` quirk, RANDOM, UCB, DUCB, EXP3 and
   DYNAMIC (``learn_in_dynamic``, its id set to EXP3), ``derive_acks``
   off for the learned ones as ``bench.py`` sets it, the learned ones at
   ``LEARN_HORIZON``: each timed after a warm-up run, card against CPU
   every leaf, its short profile, and for the learned ones the credited
   count ``learn.lat_cnt``, which must be above 0;
14. replicas_small: the replica axis (``run_batched``: one ``vmap`` of
   the tick a tick, the kernels' batching rules laying the replicas'
   windows end to end) on 4 replicas of config 3's world cut to 32 users
   x 6 fogs and of config 4's cut to 40 users, card against CPU every
   leaf, one wrapper call of each kernel a tick;
15. config3: ``benchmarks.py::config3`` at full width, 64 replicas of
   1,000 users x 24 fogs (1,536 fogs end to end: ``pairwise_rank`` and
   the per-fog reductions a replica), 250 ticks of 1 ms;
16. config4: ``benchmarks.py::config4`` at its 128 replicas (512 fogs
   end to end: ``fused_arrival_plan``; 8,192 cells: ``cell_sum_ordered``
   on 1,288,832 entries every tick), 100 ticks of 5 ms;
17. config5: one chunk of 32 of ``benchmarks.py::config5``'s 256 load
   levels at full width (10,000 users x 32 fogs, K = 4,096, 50 ticks of
   5 ms): a batch of 32 replicas for each of its four policies (1,024
   fogs end to end: ``fused_arrival_plan``), then the four as one
   ``Policy.DYNAMIC`` batch of 128 (5b: 4,096 fogs, ``pairwise_rank``).
   Phases 15-17 each run a batch once to warm up (its first 10 ticks)
   and once timed (ms a
   tick, decisions per second over all replicas, peak device memory,
   each wrapper's calls a tick, which must be the single world's one),
   hold replicas 0, 1 and R - 1 against single-world card runs of their
   states (every leaf), profile a few batched ticks (device events and
   busy share), and hold each kernel against its plain version on the
   first non-empty end-to-end input of the timed run, timed beside its
   bound; functorch's per-replica fallback is off throughout, and a
   kernel input on the CPU fails the phase;

then the ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` prints them, and ``{"ok": true, "device": {...}}`` last.
Without a CUDA device it prints no result and exits 2.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

#: Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
#: HBM bytes/s, and float32 operations/s outside the tensor cores (the
#: kernels' compares and adds run on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
#: Name fragments of the arrival kernels' five launches in a device trace.
OUR_KERNELS = (
    "arrival_init_kernel", "arrival_pass_kernel", "arrival_scatter_kernel",
    "arrival_sort_kernel", "arrival_rank_kernel",
)
#: Most launches a call of an arrival-kernel wrapper may make.
MAX_ARRIVAL_LAUNCHES = 5
#: Keys of one sorted run of the arrival kernels (``kRun`` in the source).
ARRIVAL_RUN = 4096
#: The ring all-gather's one launch in a device trace.
RING_KERNEL = "ring_gather_kernel"
#: Name fragments of the ordered per-cell sum's launches in a device trace:
#: one (one block a cell) or four (cell segments).
CELL_KERNELS = (
    "cell_sum_kernel", "cell_sum_init_kernel", "cell_sum_count_kernel",
    "cell_sum_scatter_kernel", "cell_sum_order_kernel",
)
MAX_CELL_LAUNCHES = 4
#: Cycles of one dependent float32 add, the unit of a cell's chain.
CYCLES_PER_ADD = 4
#: Cycles of the sleep kernel that holds the stream while the host queues
#: the calls ``stream_ms`` times (about 25 ms at the H100's boost clock).
SLEEP_CYCLES = 50_000_000

SOURCES = {
    "fused_arrival_plan": "fognetsimpp_tpu_torch/csrc/arrival_plan.cu",
    "pairwise_rank": "fognetsimpp_tpu_torch/csrc/arrival_plan.cu",
    "ring_all_gather": "fognetsimpp_tpu_torch/csrc/ring_gather.cu",
    "cell_sum_ordered": "fognetsimpp_tpu_torch/csrc/cell_sum.cu",
}
REPLACES = {
    "fused_arrival_plan": "fognetsimpp_tpu/ops/pallas_kernels.py:155",
    "pairwise_rank": "fognetsimpp_tpu/ops/pallas_kernels.py:320",
    "ring_all_gather": "fognetsimpp_tpu/ops/pallas_kernels.py:234",
    # no TPU kernel: the index order of XLA's float32 scatter-add there
    "cell_sum_ordered": "fognetsimpp_tpu/net/topology.py:191",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bench_world(dt: float) -> dict:
    """The world ``bench.py::_build_bench_world`` builds on an accelerator."""
    interval, horizon = 0.0025, 0.1
    return dict(
        n_users=10_000, n_fogs=32,
        fog_mips=(1000.0, 2000.0, 3000.0, 4000.0),
        send_interval=interval, horizon=horizon, dt=dt,
        max_sends_per_user=int(horizon / interval) + 4,
        max_sends_per_tick=max(1, -(-int(round(dt * 1e6)) // int(round(interval * 1e6)))),
        queue_capacity=128, start_time_max=min(0.05, horizon / 4),
        derive_acks=True,
        arrival_window=min(4096, max(1024, int(1.1 * 10_000 * min(dt, 1e-3) / interval))),
    )


WIDE_FOG = dict(
    n_users=2048, n_fogs=1040, fog_mips=(1000.0, 2000.0, 3000.0, 4000.0),
    send_interval=0.0025, horizon=0.02, dt=1e-3, queue_capacity=128,
    arrival_window=1024, derive_acks=True,
)

#: ``bench.py::tp_measurement``'s world at its defaults: 2^20 users x 64
#: fogs, send interval 50 ms, dt 5 ms, 0.25 s, one send a tick.
TP_WORLD = dict(
    n_users=1_048_576, n_fogs=64, fog_mips=(1000.0, 2000.0, 3000.0, 4000.0),
    send_interval=0.05, horizon=0.25, dt=5e-3,
    max_sends_per_user=int(0.25 / 0.05) + 4, max_sends_per_tick=1,
    queue_capacity=128, start_time_max=min(0.05, 0.25 / 4), derive_acks=True,
)
TP_SHARDS = 4
#: The bench's per-shard exchange window (bench.py:579-580): 34,142.
TP_K_EX = max(256, int(1.3 * (TP_WORLD["n_users"] // TP_SHARDS) * 5e-3 / 0.05) + 64)
#: Ticks of the tp world held card against CPU (the CPU run's length).
TP_CHECK_TICKS = 5
#: Masked rows of a shard's arrival-plan window at the tp world's tick 0,
#: all bound for one fog (this script's ``tp_profile`` phase on an H100);
#: the kernel phase holds the kernel against its plain version on such a
#: window.
TP_TICK0_MASKED = 86_103
#: Masked rows of the bench world's one non-empty window at dt 5 ms, all
#: in one fog (the port's CPU run of that world).
BENCH_MASKED = 2_281

#: ``benchmarks.py::config2`` at its own size: 96 users x 4 fogs,
#: ROUND_ROBIN, send interval 10 ms, dt 1 ms, cut from 1.0 s to 0.25 s
#: (250 ticks) for the script's time (``benchmarks.py 2`` runs it whole).
RR_GRID = dict(
    n_users=96, n_fogs=4, send_interval=0.01, horizon=0.25, dt=1e-3,
    max_sends_per_user=104, arrival_window=1024,
)
#: The compacted broker's policies on the bench world (``policies``): row
#: -> (``Policy`` name, spec overrides).  DYNAMIC runs with
#: ``learn_in_dynamic`` and its traced id set to EXP3.
POLICIES = {
    "min_busy": ("MIN_BUSY", {"mips0_divisor": False}),
    "random": ("RANDOM", {}),
    "ucb": ("UCB", {}),
    "ducb": ("DUCB", {}),
    "exp3": ("EXP3", {}),
    "dynamic": ("DYNAMIC", {"learn_in_dynamic": True}),
}
#: Horizon of the learned policies' runs: at the bench world's 0.1 s no
#: status-6 ack has landed under UCB or DUCB (tasks take 0.05-0.9 s on
#: fogs of 1,000-4,000 MIPS), so their credit path would not run.
LEARN_HORIZON = 0.3
#: Ticks stepped before a world's short profile, and the ticks profiled.
PROFILE_FROM, PROFILE_TICKS = 8, 4

#: The replica axis on small worlds, card against CPU (``replicas_small``):
#: world -> (builder name, policy, arguments).  The smoke world is config 3's cut
#: to 32 users x 6 fogs; the wireless one config 4's cut to 40 users.
REPLICAS_SMALL = {
    "smoke": ("smoke", "MIN_LATENCY", dict(
        n_users=32, n_fogs=6, send_interval=0.01, horizon=0.04, dt=1e-3,
        max_sends_per_user=8, arrival_window=64, start_time_max=0.02)),
    "wireless5": ("wireless5", "ENERGY_AWARE", dict(
        numb_users=40, horizon=0.1, dt=5e-3, extra_aps=4, mac_model="bianchi")),
}
SMALL_R, REPLICA_SEED = 4, 5
#: Ticks of a replica phase's warm-up run (its shapes are the run's).
REPLICA_WARM_TICKS = 10
#: ``benchmarks.py``'s ``CONFIG4_R``, and config 5's chunk of load levels
#: (the script runs one chunk of the 256).
CONFIG4_R, CONFIG5_CHUNK = 128, 32

#: tests/test_parity_wireless.py's fast-cycling battery world (12 mJ
#: batteries, 18 mW net drain while publishing) at dt 10 ms, MIN_BUSY.
CHURN = dict(
    numb_users=8, horizon=4.0, dt=0.01, send_interval=0.1, w_contention=0.0,
    mac_model="linear", energy_capacity_j=0.012, tx_energy_j=2e-3,
    rx_energy_j=1e-4, idle_power_w=2e-3, harvest_power_w=4e-3,
    harvest_period_s=50.0, harvest_duty=0.5,
)


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    from fognetsimpp_tpu_torch import benchmarks as bm
    from fognetsimpp_tpu_torch.core import engine
    from fognetsimpp_tpu_torch.core.engine import run_batched
    from fognetsimpp_tpu_torch.net.topology import associate
    from fognetsimpp_tpu_torch.ops import arrival_kernels as ak
    from fognetsimpp_tpu_torch.ops import cell_kernels as ck
    from fognetsimpp_tpu_torch.ops import cuda_build
    from fognetsimpp_tpu_torch.ops import queues as tq
    from fognetsimpp_tpu_torch.ops import ring_kernels as rk
    from fognetsimpp_tpu_torch.parallel.replicas import replicate_state, strict_vmap
    from fognetsimpp_tpu_torch.parallel.sweep import policy_batches
    from fognetsimpp_tpu_torch.parallel.taskshard import run_tp_sharded
    from fognetsimpp_tpu_torch.runtime.signals import summarize
    from fognetsimpp_tpu_torch.scenarios import cell_sum_inputs, smoke, wireless
    from fognetsimpp_tpu_torch.spec import BugCompat, Policy
    from fognetsimpp_tpu_torch.state import state_to_numpy, tree_leaves, tree_map

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit({
        "phase": "device", "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "nvidia_smi": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda,
    })

    # ---- 2. build --------------------------------------------------------
    path, secs, log = cuda_build.build()
    emit({
        "phase": "build", "seconds": round(secs, 3), "library": path,
        "ptxas": [ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "Compiling entry" in ln
                  or ln.startswith("== ")],
    })

    # ---- 3. kernels against their plain versions -------------------------
    def window(K, F, seed, kind="uniform", n_masked=None):
        """An arrival window: ``uniform`` (70 % masked, fogs uniform, times
        on a 0.1 ms grid: ties), ``one_fog`` (``n_masked`` rows at random
        positions, all bound for one fog, times in one tick's 5 ms band as
        in the main path's windows), ``empty``, ``all_ties`` (one time for
        every row) or ``signed_zero`` (times +0.0, -0.0, 0.1 ms)."""
        rng = np.random.default_rng(seed)
        mask = rng.random(K) < 0.7
        fog = rng.integers(0, F, K).astype(np.int32)
        t = np.round(rng.random(K) * 0.01, 4).astype(np.float32)
        if kind == "one_fog":
            mask = np.zeros(K, bool)
            mask[rng.permutation(K)[:n_masked]] = True
            fog[:] = F // 2
            t = (0.05 + rng.random(K) * 0.005).astype(np.float32)
        elif kind == "empty":
            mask[:] = False
        elif kind == "all_ties":
            t[:] = 0.0025
        elif kind == "signed_zero":
            t = rng.choice(np.array([0.0, -0.0, 1e-4], np.float32), K)
        f_key = np.where(mask, fog, F).astype(np.int32)
        t_key = np.where(mask, t, np.inf).astype(np.float32)
        return [torch.from_numpy(a).to(dev) for a in (mask, f_key, t_key)]

    def per_call_ms(fn, reps):
        """Mean ms per call over ``reps`` back-to-back calls between two
        CUDA events, after a warm-up call; the median of 5 such runs."""
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            torch.cuda.synchronize()
            runs.append(a.elapsed_time(b) / reps)
        return statistics.median(runs)

    def stream_ms(fn, reps, runs=5):
        """Device ms a call of ``fn``, its launches back to back: the calls
        are queued behind a sleep kernel that holds the stream while the
        host launches them, so the CUDA events around them time the card's
        work and not the host's (median of ``runs``).  For the replica paths'
        kernel rows, where the profiler's trace of a call came back with
        some of its launches missing on the card."""
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(runs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / reps)
        return statistics.median(times)

    def max_abs_err(got, want):
        err = 0.0
        for g, w in zip(got, want):
            same = g == w
            d = torch.where(same, 0.0, (g.double() - w.double()).abs())
            err = max(err, float(d.max()) if d.numel() else 0.0)
        return err

    def device_us(fn, reps, names=("",)):
        """Device µs per call by kernel name, from ``torch.profiler``: the
        sum of the device events of ``reps`` calls (warm-up call first),
        over ``reps``, and the events per call by name.  Gaps between the
        launches are not counted.  A trace that holds no event named with
        one of ``names`` is taken again, up to six times, a second apart:
        the profiler on the card now and then returns no device events at
        all, three traces running."""
        fn()
        torch.cuda.synchronize()
        for attempt in range(6):
            if attempt:
                time.sleep(1.0)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            by_name, n_by_name = {}, {}
            for ev in prof.events():
                if str(ev.device_type).endswith("CUDA"):
                    us = float(ev.time_range.elapsed_us())
                    by_name[ev.name] = by_name.get(ev.name, 0.0) + us / reps
                    n_by_name[ev.name] = n_by_name.get(ev.name, 0) + 1 / reps
            if any(n in k for k in by_name for n in names):
                break
        return by_name, n_by_name

    def bound(mask, f_key, F, fused):
        """The least time the card could take for the function on these
        inputs: the bytes it must move (the mask read once; the fog and
        time keys only in the 32-byte sectors that hold a masked row, as
        no other key is needed; each output written once), against the
        compares a comparison sort of each fog's masked rows needs
        (c * ceil(log2 c) for c rows), plus a count and a lex-min step per
        masked row for the per-fog outputs.  Returns the counts beside the
        bound."""
        K = mask.shape[0]
        c = torch.unique(f_key[mask], return_counts=True)[1].tolist()
        sort_cmp = sum(n * (n - 1).bit_length() for n in c)
        n_masked = int(mask.sum())
        # sectors of 8 four-byte keys (the tensors start sector-aligned)
        n_sectors = int(torch.unique(torch.nonzero(mask).flatten() // 8).numel())
        key_bytes = 2 * min(4 * K, 32 * n_sectors)
        n_bytes = K * 1 + key_bytes + K * 4 + (F * 12 if fused else 0)
        n_ops = sort_cmp + (2 * n_masked if fused else 0)
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / CUDA_CORE_OPS_PER_S * 1e3
        return {
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "fogs_touched": len(c), "sort_compares": sort_cmp, "ops": n_ops,
            "bytes": n_bytes, "key_sectors": n_sectors,
        }

    def same_bits(got, want):
        """Equal dtypes and bytes: -0.0 and +0.0 differ here."""
        return all(
            g.dtype == w.dtype and torch.equal(
                g.view(torch.int32) if g.is_floating_point() else g,
                w.view(torch.int32) if w.is_floating_point() else w,
            )
            for g, w in zip(got, want)
        )

    def check_arrival_kernel(name, inp, F, reps, by_events=False):
        """The kernel against its plain version on ``inp``: exact equality
        (or SystemExit), device and wall times of both and of the torch
        sort composition, launches a call, and the bound.  ``reps`` =
        (kernel device, plain device, kernel wall, plain wall) calls.
        ``by_events`` takes the device times from :func:`stream_ms` and the
        profiler's trace only for the launches a call."""
        fused = name == "fused_arrival_plan"
        if fused:
            run_k = lambda: ak.fused_arrival_plan(*inp, F)  # noqa: E731
            run_p = lambda: ak.fused_arrival_plan_plain(*inp, F)  # noqa: E731
        else:
            run_k = lambda: (ak.pairwise_rank(*inp),)  # noqa: E731
            run_p = lambda: (ak.pairwise_rank_plain(*inp),)  # noqa: E731
        # the port's torch sort composition of the rank (the CPU path above
        # K = 4096), timed beside the kernel; the port never runs it on the
        # card
        run_lib = lambda: tq._sort_rank(*inp)  # noqa: E731
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # the wrapper may not sync
        try:
            got = run_k()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        want = run_p()
        equal = same_bits(got, want)
        err = max_abs_err(got, want)
        K = inp[0].shape[0]
        if not equal:
            raise SystemExit(f"{name} at K={K}, F={F} differs from its plain version")
        # device time of the kernel's own launches, and of the plain
        # version's kernels, per call
        # each launch's mean time, summed over the call's launches: the
        # profiler now and then misses one call's events in a trace
        us_k, n_k = device_us(run_k, reps[0], OUR_KERNELS)
        dev_k = {k: v / n_k[k] for k, v in us_k.items()
                 if any(s in k for s in OUR_KERNELS)}
        launches = sum(v for k, v in n_k.items() if any(s in k for s in OUR_KERNELS))
        if not dev_k and not by_events:
            raise SystemExit(f"{name}: the profiler saw no device time of its kernels")
        if launches > MAX_ARRIVAL_LAUNCHES + 1e-9:
            raise SystemExit(f"{name}: {launches} launches a call")
        b = bound(*inp[:2], F, fused)
        if by_events:
            # the plain version of an end-to-end window takes seconds a call:
            # one timed run of it, and its wall time is that run's
            plain_ms = stream_ms(run_p, reps[1], runs=1)
            times = {"ms": stream_ms(run_k, reps[0]),
                     "plain_ms": plain_ms, "plain_wrapper_ms": plain_ms,
                     "library_ms": stream_ms(run_lib, reps[1]),
                     "timed_by": "CUDA events behind a sleep kernel"}
        else:
            times = {"ms": sum(dev_k.values()) / 1e3,
                     "plain_ms": sum(device_us(run_p, reps[1])[0].values()) / 1e3,
                     "plain_wrapper_ms": per_call_ms(run_p, reps[3]),
                     "library_ms": sum(device_us(run_lib, reps[1])[0].values()) / 1e3,
                     "timed_by": "torch.profiler"}
        return {
            "name": name, "K": K, "F": F, "masked_rows": int(inp[0].sum()),
            "equal": equal, "max_abs_err": err, **times,
            "launches_a_call": launches,
            "device_us_by_launch": {
                s: sum(v for k, v in dev_k.items() if s in k)
                for s in OUR_KERNELS if any(s in k for k in dev_k)
            },
            "library_rank_equal": bool(torch.equal(run_lib(), got[0])),
            # wall time per call of the Python wrapper, launches included
            "wrapper_ms": per_call_ms(run_k, reps[2]),
            **b,
        }

    def emit_kernel(r, kind):
        emit({
            "phase": "kernel", "name": r["name"], "window": kind, "K": r["K"],
            "F": r["F"], "masked_rows": r["masked_rows"],
            "fogs_touched": r["fogs_touched"], "equal": r["equal"],
            "max_abs_err": r["max_abs_err"], "device_us": r["ms"] * 1e3,
            "launches_a_call": r["launches_a_call"],
            "device_us_by_launch": r["device_us_by_launch"],
            "plain_device_us": r["plain_ms"] * 1e3,
            "sort_composition_device_us": r["library_ms"] * 1e3,
            "sort_composition_rank_equal": r["library_rank_equal"],
            "wrapper_us": r["wrapper_ms"] * 1e3,
            "plain_wrapper_us": r["plain_wrapper_ms"] * 1e3,
            "bound_us": r["bound_ms"] * 1e3, "bound_by": r["bound_by"],
            "timed_by": r["timed_by"],
            "bound_sort_compares": r["sort_compares"], "bound_ops": r["ops"],
            "bound_bytes": r["bytes"], "bound_key_sectors": r["key_sectors"],
        })

    def real_window(r):
        """A row's numbers on a window the main path planned."""
        return {k: r[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "masked_rows", "fogs_touched", "max_abs_err", "wrapper_ms",
            "launches_a_call",
        )}

    def kernel_row(r, path, kind):
        return {
            "name": r["name"], "route": "cuda", "source": SOURCES[r["name"]],
            "replaces": REPLACES[r["name"]], "launches": 0,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library": SORT_COMPOSITION,
            "shape": {"K": r["K"], "F": r["F"], "masked_rows": r["masked_rows"],
                      "fogs_touched": r["fogs_touched"]},
            "shape_of": path, "window": kind,
            "bound_sort_compares": r["sort_compares"],
            "bound_ops": r["ops"], "bound_bytes": r["bytes"],
            "wrapper_ms": r["wrapper_ms"], "launches_a_call": r["launches_a_call"],
            "timed_by": r["timed_by"],
        }

    def empty_row(r):
        """A row's numbers on the empty window of its path."""
        return {k: r[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err", "wrapper_ms",
        )} | {"bound_bytes": r["bytes"]}

    SORT_COMPOSITION = (
        "composition, not one call: ops/queues._sort_rank (three stable "
        "torch.sort, a cummax, a scatter), the rank only"
    )

    # rows of the kernels line: fused_arrival_plan at the bench window
    # (K = 4096, the bench and tp_window paths) and at the tp world's
    # gathered exchange window (K = 4 x 34,142, F = 64), each from the
    # windows those paths run (every masked row in one fog; empty), and
    # pairwise_rank at the wide-fog window
    TP_K = TP_SHARDS * TP_K_EX
    kernel_rows = {}
    cases = [
        # (name, K, F, window, masked rows of a one-fog window, row)
        ("fused_arrival_plan", 4096, 32, "one_fog", BENCH_MASKED, "bench"),
        ("fused_arrival_plan", 4096, 32, "empty", 0, "bench"),
        ("fused_arrival_plan", 4096, 32, "uniform", None, None),
        ("fused_arrival_plan", 1000, 7, "uniform", None, None),  # ragged edge
        ("fused_arrival_plan", 4096, 32, "all_ties", None, None),
        ("fused_arrival_plan", 4096, 32, "signed_zero", None, None),
        # one bucket at and one past a sorted run
        ("fused_arrival_plan", ARRIVAL_RUN + 777, 8, "one_fog", ARRIVAL_RUN, None),
        ("fused_arrival_plan", ARRIVAL_RUN + 777, 8, "one_fog", ARRIVAL_RUN + 1, None),
        ("fused_arrival_plan", TP_K, TP_WORLD["n_fogs"], "one_fog", TP_TICK0_MASKED, "tp"),
        ("fused_arrival_plan", TP_K, TP_WORLD["n_fogs"], "empty", 0, "tp"),
        ("fused_arrival_plan", TP_K, TP_WORLD["n_fogs"], "uniform", None, None),
        ("pairwise_rank", WIDE_FOG["arrival_window"], WIDE_FOG["n_fogs"], "uniform",
         None, "wide_fog"),
        ("pairwise_rank", WIDE_FOG["arrival_window"], WIDE_FOG["n_fogs"], "one_fog",
         700, None),
        ("pairwise_rank", 4096, 32, "uniform", None, None),
        ("pairwise_rank", 4096, 32, "signed_zero", None, None),
    ]
    for name, K, F, kind, n_masked, path in cases:
        inp = window(K, F, seed=K + F, kind=kind, n_masked=n_masked)
        reps = (20, 10, 50, 10) if K <= 4096 else (10, 2, 10, 1)
        r = check_arrival_kernel(name, inp, F, reps)
        emit_kernel(r, kind)
        if path is None:
            continue
        if (name, path) not in kernel_rows:
            kernel_rows[(name, path)] = kernel_row(r, path, kind)
        else:  # the empty window of a path, beside its one-fog window
            kernel_rows[(name, path)]["empty_window"] = empty_row(r)
    del inp

    # ---- 3b. the ring all-gather against its plain version ----------------
    def ring_blocks(n, K, C, seed):
        rng = np.random.default_rng(seed)
        return [
            torch.from_numpy(
                rng.integers(-2 ** 31, 2 ** 31, (K, C), dtype=np.int64).astype(np.int32)
            ).to(dev)
            for _ in range(n)
        ]

    ring_cases = [  # (n, K, C, main shape); C = 5 and odd K leave 16-B lines
        (2, 1000, 4, False), (8, 777, 5, False), (2, 3, 5, False),
        (8, 4096, 4, False), (TP_SHARDS, TP_K_EX, 5, False),
        (TP_SHARDS, TP_K_EX, 4, True),
    ]
    for n, K, C, main_shape in ring_cases:
        blocks = ring_blocks(n, K, C, seed=n * 1_000_003 + K * 7 + C)
        got = rk.ring_all_gather(blocks)
        torch.cuda.synchronize()
        want = rk.ring_all_gather_plain(blocks)
        equal = len(got) == n and all(torch.equal(g, w) for g, w in zip(got, want))
        err = max_abs_err(got, want)
        dsts = [torch.empty((n * K, C), dtype=torch.int32, device=dev) for _ in range(n)]

        def run_lib(blocks=blocks, dsts=dsts):
            for d in dsts:
                torch.cat(blocks, out=d)

        run_k = lambda blocks=blocks: rk.ring_all_gather(blocks)  # noqa: E731
        run_p = lambda blocks=blocks: rk.ring_all_gather_plain(blocks)  # noqa: E731
        events_k = device_us(run_k, 20, (RING_KERNEL,))[0]
        dev_k = {k: v for k, v in events_k.items() if RING_KERNEL in k}
        if not dev_k:
            raise SystemExit("ring_all_gather: the profiler saw no device time of its kernel")
        ms = sum(dev_k.values()) / 1e3
        plain_ms = sum(device_us(run_p, 20)[0].values()) / 1e3
        lib_ms = sum(device_us(run_lib, 20)[0].values()) / 1e3
        wrapper_ms = per_call_ms(run_k, 50)
        plain_wrapper_ms = per_call_ms(run_p, 20)
        lib_wrapper_ms = per_call_ms(run_lib, 20)
        # each input block read once, each of the n outputs written once
        n_bytes = (n * n + n) * K * C * 4
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        emit({
            "phase": "kernel", "name": "ring_all_gather", "n": n, "K": K, "C": C,
            "equal": equal, "max_abs_err": err, "device_us": ms * 1e3,
            "device_us_by_event": events_k, "plain_device_us": plain_ms * 1e3,
            "library_device_us": lib_ms * 1e3, "wrapper_us": wrapper_ms * 1e3,
            "plain_wrapper_us": plain_wrapper_ms * 1e3,
            "library_wrapper_us": lib_wrapper_ms * 1e3,
            "bound_us": bound_ms * 1e3, "bound_by": "bytes", "bound_bytes": n_bytes,
        })
        if not equal:
            raise SystemExit(
                f"ring_all_gather at n={n}, K={K}, C={C} differs from its plain version"
            )
        if main_shape:
            kernel_rows[("ring_all_gather", "tp")] = {
                "name": "ring_all_gather", "route": "cuda",
                "source": SOURCES["ring_all_gather"],
                "replaces": REPLACES["ring_all_gather"], "launches": 0,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms,
                "shape": {"n": n, "K": K, "C": C}, "shape_of": "tp",
                "bound_bytes": n_bytes,
                "wrapper_ms": wrapper_ms,
            }
    del blocks, got, want, dsts

    # ---- helpers for the world phases ------------------------------------
    def device_events(prof):
        """(device µs, number of device events, µs by name) of a profile."""
        dev_us, n_events, by_name = 0.0, 0, {}
        for ev in prof.events():
            if str(ev.device_type).endswith("CUDA"):
                us = float(ev.time_range.elapsed_us())
                dev_us += us
                n_events += 1
                by_name[ev.name] = by_name.get(ev.name, 0.0) + us
        return dev_us, n_events, by_name

    def reset_launches():
        ak.reset_launches()
        rk.reset_launches()
        ck.reset_launches()

    def all_launches():
        return {**ak.LAUNCHES, **rk.LAUNCHES, **ck.LAUNCHES}

    def assert_same(card_state, cpu_state, what):
        paths = [p for p, _ in tree_leaves(cpu_state)]
        a_all, b_all = state_to_numpy(card_state), state_to_numpy(cpu_state)
        for p, a, b in zip(paths, a_all, b_all):
            if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
                raise SystemExit(f"{what}: leaf {p} differs between card and CPU")
        return len(paths)

    def timed_run(kw):
        spec, st, net, b = smoke.build(device=dev, **kw)
        engine.run(spec, st, net, b)  # warm-up: same work, same shapes
        torch.cuda.synchronize()
        spec, st, net, b = smoke.build(device=dev, **kw)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        final, _ = engine.run(spec, st, net, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_launches()
        return spec, final, wall, launches

    def cpu_run(kw):
        spec, st, net, b = smoke.build(device="cpu", **kw)
        return engine.run(spec, st, net, b)[0]

    def static_cache(spec, st, net):
        return associate(net, st.nodes.pos, st.nodes.alive, spec.broker_index)

    def tick_profile(spec, st, net, b, cache, tick=None):
        """Where a world's tick time goes: PROFILE_FROM ticks stepped into
        the steady state, PROFILE_TICKS timed without the profiler, the
        next PROFILE_TICKS profiled (an empty trace is taken again, up to
        six times).  ``tick`` (state -> state) replaces the world's own
        step, for a replica batch.  Returns the row (wall ms a tick both
        ways, device events, device ms and busy share a tick, the heaviest
        kernels) and the device µs by kernel name."""
        if tick is None:
            step = engine.make_step(spec)
            tick = lambda s: step(s, net, b, cache)  # noqa: E731
        for _ in range(PROFILE_FROM):
            st = tick(st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILE_TICKS):
            st = tick(st)
        torch.cuda.synchronize()
        wall_plain = time.perf_counter() - t0
        for attempt in range(6):
            if attempt:
                time.sleep(1.0)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(PROFILE_TICKS):
                    st = tick(st)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            dev_us, n_events, by_name = device_events(prof)
            if n_events:
                break
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        n = PROFILE_TICKS
        return {
            "profiled_ticks": n, "profiled_from_tick": PROFILE_FROM + n,
            "wall_ms_per_tick": wall / n * 1e3,
            "wall_ms_per_tick_unprofiled": wall_plain / n * 1e3,
            "device_events_per_tick": n_events / n,
            "device_ms_per_tick": dev_us / n / 1e3 if n_events else None,
            # device time over the wall time of the same ticks run without
            # the profiler, which slows the host's launches
            "device_busy_share": (dev_us / 1e6) / wall_plain if n_events else None,
            "top_device_us_per_tick": [[k, v / n] for k, v in top],
        }, {k: v / n for k, v in by_name.items()}

    # ---- 4. smoke world --------------------------------------------------
    kw = dict(horizon=0.5)
    spec, card, wall, launches = timed_run(kw)
    n_leaves = assert_same(card, cpu_run(kw), "smoke")
    summ = summarize(card)
    emit({
        "phase": "smoke", "ticks": spec.n_ticks, "leaves_equal": n_leaves,
        "wall_s": round(wall, 4), "launches": launches,
        "summary": {k: (None if isinstance(v, float) and v != v else v)
                    for k, v in summ.items()},
    })
    if launches["fused_arrival_plan"] <= 0:
        raise SystemExit("smoke: the main path never launched fused_arrival_plan")

    # ---- 5. bench world at full width ------------------------------------
    fused_main = 0
    for dt in (5e-3, 1e-3):
        kw = bench_world(dt)
        spec, card, wall, launches = timed_run(kw)
        n_leaves = assert_same(card, cpu_run(kw), f"bench dt={dt}")
        summ = summarize(card)
        n_sched = summ["n_scheduled"]
        n_fused = launches["fused_arrival_plan"]
        emit({
            "phase": "bench", "dt": dt, "n_users": spec.n_users,
            "n_fogs": spec.n_fogs, "window": spec.window,
            "task_rows": spec.task_capacity, "ticks": spec.n_ticks,
            "leaves_equal": n_leaves, "n_scheduled": n_sched,
            "n_published": summ["n_published"], "n_dropped": summ["n_dropped"],
            "n_completed": summ["n_completed"],
            "n_deferred_max": summ["n_deferred_max"],
            "wall_s": wall,
            "task_offload_decisions_per_sec": n_sched / wall,
            "ms_per_tick": wall / spec.n_ticks * 1e3,
            "launches": launches,
        })
        if not 0 < n_fused <= spec.n_ticks:
            raise SystemExit(
                f"bench dt={dt}: fused_arrival_plan launched {n_fused} times "
                f"in {spec.n_ticks} ticks"
            )
        fused_main += n_fused

    # ---- 6. wide-fog world -----------------------------------------------
    spec, card, wall, launches = timed_run(WIDE_FOG)
    n_leaves = assert_same(card, cpu_run(WIDE_FOG), "wide_fog")
    summ = summarize(card)
    emit({
        "phase": "wide_fog", "n_users": spec.n_users, "n_fogs": spec.n_fogs,
        "window": spec.window, "ticks": spec.n_ticks, "leaves_equal": n_leaves,
        "n_scheduled": summ["n_scheduled"], "wall_s": wall,
        "launches": launches,
    })
    if launches["pairwise_rank"] <= 0:
        raise SystemExit("wide_fog: the path never launched pairwise_rank")
    wide_launches = launches["pairwise_rank"]

    # ---- 7. where a bench tick's time goes -------------------------------
    kw = bench_world(5e-3)
    spec, st, net, b = smoke.build(device=dev, **kw)
    # keep each tick's window, to count its masked rows afterwards and to
    # time the kernel on the first that holds rows
    windows, fused_plan = [], ak.fused_arrival_plan

    def kept_plan(*args):
        windows.append(args)
        return fused_plan(*args)

    ak.fused_arrival_plan = kept_plan
    try:
        prof_row, by_name = tick_profile(spec, st, net, b, static_cache(spec, st, net))
    finally:
        ak.fused_arrival_plan = fused_plan
    emit({
        "phase": "profile", "world": "bench dt=5ms",
        # masked rows of the K-window, a tick each: the steady-state
        # ticks, then the unprofiled and the profiled ticks
        "window_masked_rows": [int(w[0].sum()) for w in windows],
        **prof_row,
        "arrival_kernels_device_us_per_tick": sum(
            v for k, v in by_name.items() if any(s in k for s in OUR_KERNELS)),
    })
    args = next(w for w in windows if int(w[0].sum()))
    r = check_arrival_kernel("fused_arrival_plan", args[:3], args[3], (20, 10, 50, 10))
    emit_kernel(r, "bench world, tick 0")
    kernel_rows[("fused_arrival_plan", "bench")]["real_window"] = real_window(r)
    del windows, args

    # ---- 8. the task-sharded tick at full width ---------------------------
    def tp_run(device, n_ticks):
        spec, st, net, b = smoke.build(device=device, **TP_WORLD)
        spec, final = run_tp_sharded(
            spec, st, net, b, n_shards=TP_SHARDS, n_ticks=n_ticks,
            exchange_window=TP_K_EX,
        )
        return spec, final, net

    # card against CPU over the first ticks; the card run is the warm-up
    t0 = time.perf_counter()
    _, card, _ = tp_run(dev, TP_CHECK_TICKS)
    torch.cuda.synchronize()
    check_card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, cpu, _ = tp_run("cpu", TP_CHECK_TICKS)
    check_cpu_s = time.perf_counter() - t0
    n_leaves = assert_same(card, cpu, "tp")
    del card, cpu
    # the whole horizon, timed
    spec, st, net, b = smoke.build(device=dev, **TP_WORLD)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    spec, final = run_tp_sharded(
        spec, st, net, b, n_shards=TP_SHARDS, exchange_window=TP_K_EX
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    del st
    summ = summarize(final)
    n_sched = summ["n_scheduled"]
    emit({
        "phase": "tp", "n_users": spec.n_users, "n_fogs": spec.n_fogs,
        "n_shards": TP_SHARDS, "k_exchange": TP_K_EX,
        "exchange_window_rows": TP_SHARDS * TP_K_EX,
        "task_rows": spec.task_capacity, "ticks": spec.n_ticks,
        "check_ticks": TP_CHECK_TICKS, "leaves_equal": n_leaves,
        "check_card_s": check_card_s, "check_cpu_s": check_cpu_s,
        "n_scheduled": n_sched, "n_published": summ["n_published"],
        "n_dropped": summ["n_dropped"], "n_completed": summ["n_completed"],
        "n_deferred_max": summ["n_deferred_max"], "wall_s": wall,
        "task_offload_decisions_per_sec": n_sched / wall,
        "ms_per_tick": wall / spec.n_ticks * 1e3,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
    })
    if launches["ring_all_gather"] != spec.n_ticks:
        raise SystemExit(
            f"tp: ring_all_gather launched {launches['ring_all_gather']} "
            f"times in {spec.n_ticks} ticks"
        )
    if launches["fused_arrival_plan"] <= 0:
        raise SystemExit("tp: the path never launched fused_arrival_plan")
    tp_launches = launches

    # two ticks from the start (full exchange windows) and two past the
    # horizon (saturated fogs), each without and with the profiler; each
    # call includes the runner's set-up and the join of the shards
    def profile_tp(state, from_tick, n_prof=2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_tp_sharded(spec, state, net, n_shards=TP_SHARDS, n_ticks=n_prof,
                       exchange_window=TP_K_EX)
        torch.cuda.synchronize()
        wall_plain = time.perf_counter() - t0
        windows, fused_plan = [], ak.fused_arrival_plan

        def kept_plan(*args):
            windows.append(args)
            return fused_plan(*args)

        ak.fused_arrival_plan = kept_plan
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run_tp_sharded(spec, state, net, n_shards=TP_SHARDS,
                               n_ticks=n_prof, exchange_window=TP_K_EX)
                torch.cuda.synchronize()
                wall_prof = time.perf_counter() - t0
        finally:
            ak.fused_arrival_plan = fused_plan
        dev_us, n_events, by_name = device_events(prof)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        masked = [int(w[0].sum()) for w in windows]
        # distinct fogs among each non-empty window's masked rows
        fogs_touched = [int(torch.unique(w[1][w[0]]).numel()) for w in windows
                        if int(w[0].sum())]
        # the kernel against its plain version on every window of these
        # ticks that holds rows (the main path's own inputs)
        for args in windows:
            if int(args[0].sum()):
                got = fused_plan(*args)
                want = ak.fused_arrival_plan_plain(*args)
                if not same_bits(got, want):
                    raise SystemExit(
                        f"tp_profile: fused_arrival_plan differs from its plain "
                        f"version on a window of tick {from_tick}-{from_tick + n_prof - 1}"
                    )
        full = [w for w in windows if int(w[0].sum())]
        if full:  # time the kernel on the first of them
            r = check_arrival_kernel(
                "fused_arrival_plan", full[0][:3], full[0][3], (10, 2, 10, 1)
            )
            emit_kernel(r, f"tp world, tick {from_tick}")
            kernel_rows[("fused_arrival_plan", "tp")]["real_window"] = real_window(r)
        emit({
            "phase": "tp_profile", "ticks": n_prof, "from_tick": from_tick,
            "wall_ms_per_tick": wall_prof / n_prof * 1e3,
            "wall_ms_per_tick_unprofiled": wall_plain / n_prof * 1e3,
            "device_events_per_tick": n_events / n_prof,
            "device_ms_per_tick": dev_us / n_prof / 1e3,
            "device_busy_share": (dev_us / 1e6) / wall_plain,
            "ring_kernel_device_us_per_tick": sum(
                v for k, v in by_name.items() if RING_KERNEL in k) / n_prof,
            "arrival_kernels_device_us_per_tick": sum(
                v for k, v in by_name.items() if any(s in k for s in OUR_KERNELS)
            ) / n_prof,
            # each shard's call a tick: the window's rows and masked rows
            "arrival_plan_window_rows": windows[0][0].shape[0],
            "arrival_plan_masked_rows": masked,
            "arrival_plan_fogs_touched": fogs_touched,
            # windows with rows, each equal to the plain version on them
            "arrival_plan_checked_windows": sum(1 for m in masked if m),
            "top_device_us_per_tick": [[k, v / n_prof] for k, v in top],
        })

    profile_tp(final, spec.n_ticks)
    del final
    profile_tp(smoke.build(device=dev, **TP_WORLD)[1], 0)

    # ---- 9. the windowed exchange: bench world under four shards ---------
    kw = bench_world(5e-3)
    spec, st, net, b = smoke.build(device=dev, **kw)
    ref, _ = engine.run(spec, st, net, b)
    spec, st, net, b = smoke.build(device=dev, **kw)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    _, got = run_tp_sharded(spec, st, net, b, n_shards=TP_SHARDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    n_leaves = assert_same(got, ref, "tp_window (TP against engine.run)")
    emit({
        "phase": "tp_window", "n_users": spec.n_users, "n_fogs": spec.n_fogs,
        "n_shards": TP_SHARDS, "window": spec.window, "ticks": spec.n_ticks,
        "leaves_equal": n_leaves, "n_scheduled": int(got.metrics.n_scheduled),
        "wall_s": wall,
        "task_offload_decisions_per_sec": int(got.metrics.n_scheduled) / wall,
        "ms_per_tick": wall / spec.n_ticks * 1e3,
        "launches": launches,
    })
    if launches["fused_arrival_plan"] <= 0:
        raise SystemExit("tp_window: the path never launched fused_arrival_plan")
    window_launches = launches

    # ---- 10. the wireless world: config 4 at one replica, full width -----
    # benchmarks.py::config4 at one replica: the 10k-node mobile-handover
    # world with energy, ENERGY_AWARE, the Bianchi MAC over 64 APs
    w_kw = cell_sum_inputs.wireless_kw()

    def handovers(net, spec, pos0, alive0, pos1, alive1):
        """Users associated at both states, with different APs."""
        a0 = associate(net, pos0, alive0, spec.broker_index).assoc[: spec.n_users]
        a1 = associate(net, pos1, alive1, spec.broker_index).assoc[: spec.n_users]
        return int(((a0 != a1) & (a0 >= 0) & (a1 >= 0)).sum())

    # a stepped run that keeps every arrival window and tick 0's input of
    # the per-cell sum; also the warm-up of the timed run below
    spec, st, net, b = wireless.wireless5(device=dev, **w_kw)
    step = engine.make_step(spec)
    U = spec.n_users
    windows, fused_plan = [], ak.fused_arrival_plan
    cell_inputs, cell_sum = [], ck.cell_sum_ordered

    def kept_plan(*args):
        windows.append(args)
        return fused_plan(*args)

    def kept_sum(*args):
        cell_inputs.append(args)
        return cell_sum(*args)

    ak.fused_arrival_plan, ck.cell_sum_ordered = kept_plan, kept_sum
    try:
        alive_n = []
        for tick in range(spec.n_ticks):
            st = step(st, net, b)
            alive_n.append(st.nodes.alive[:U].sum())
            if tick == 0:
                pos0, alive0 = st.nodes.pos.clone(), st.nodes.alive.clone()
    finally:
        ak.fused_arrival_plan, ck.cell_sum_ordered = fused_plan, cell_sum
    torch.cuda.synchronize()
    stepped = st
    n_hand = handovers(net, spec, pos0, alive0, st.nodes.pos, st.nodes.alive)
    alive_min = int(torch.stack(alive_n).min())
    masked = [int(w[0].sum()) for w in windows]
    for args in windows:
        if int(args[0].sum()):
            if not same_bits(fused_plan(*args), ak.fused_arrival_plan_plain(*args)):
                raise SystemExit("wireless: fused_arrival_plan differs from its plain "
                                 "version on a window of the run")
    full = [w for w in windows if int(w[0].sum())]
    if not full or len(cell_inputs) != spec.n_ticks:
        raise SystemExit(f"wireless: {len(full)} non-empty windows, "
                         f"{len(cell_inputs)} per-cell sums in {spec.n_ticks} ticks")
    r = check_arrival_kernel("fused_arrival_plan", full[0][:3], full[0][3], (20, 10, 50, 10))
    emit_kernel(r, "wireless world, first non-empty window")
    kernel_rows[("fused_arrival_plan", "wireless")] = kernel_row(r, "wireless", "real")
    del windows, full
    # the timed run through engine.run
    spec, st, net, b = wireless.wireless5(device=dev, **w_kw)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    card, _ = engine.run(spec, st, net, b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    n_same = assert_same(card, stepped, "wireless (engine.run against the stepped run)")
    del stepped
    t0 = time.perf_counter()
    spec_c, st_c, net_c, b_c = wireless.wireless5(device="cpu", **w_kw)
    cpu, _ = engine.run(spec_c, st_c, net_c, b_c)
    cpu_s = time.perf_counter() - t0
    n_leaves = assert_same(card, cpu, "wireless")
    del cpu
    summ = summarize(card)
    n_sched = summ["n_scheduled"]
    emit({
        "phase": "wireless", "n_users": U, "n_nodes": spec.n_nodes,
        "n_aps": spec.n_aps, "n_fogs": spec.n_fogs, "window": spec.window,
        "task_rows": spec.task_capacity, "ticks": spec.n_ticks,
        "leaves_equal": n_leaves, "leaves_equal_stepped": n_same,
        "n_scheduled": n_sched, "n_published": summ["n_published"],
        "n_lost": int(card.metrics.n_lost), "n_dropped": summ["n_dropped"],
        "n_completed": summ["n_completed"],
        "n_deferred_max": summ["n_deferred_max"],
        "alive_min": alive_min, "alive_end": int(card.nodes.alive[:U].sum()),
        "handovers": n_hand, "window_masked_rows": masked,
        "arrival_plan_checked_windows": sum(1 for m in masked if m),
        "wall_s": wall, "cpu_run_s": cpu_s,
        "task_offload_decisions_per_sec": n_sched / wall,
        "ms_per_tick": wall / spec.n_ticks * 1e3,
        "launches": launches,
    })
    if launches["cell_sum_ordered"] != spec.n_ticks or launches["fused_arrival_plan"] <= 0:
        raise SystemExit(f"wireless: launches {launches} in {spec.n_ticks} ticks")
    wireless_launches = launches
    del card

    # the ordered per-cell sum against its plain version and index_add_
    def sm_clock_mhz():
        return float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True,
        ).stdout.split()[0])

    def check_cell_kernel(case, cell, vals, A, reps, by_events=False):
        run_k = lambda: ck.cell_sum_ordered(cell, vals, A)  # noqa: E731
        run_p = lambda: ck.cell_sum_ordered_plain(cell, vals, A)  # noqa: E731
        idx = torch.where((cell >= 0) & (cell < A), cell, A).long()
        acc = torch.zeros((A + 1,), dtype=torch.float32, device=dev)
        run_lib = lambda: acc.index_add_(0, idx, vals)  # noqa: E731
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # the wrapper may not sync
        try:
            got = run_k()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = run_p()
        equal = same_bits([got], [want])
        err = max_abs_err([got], [want])
        lib_out = torch.zeros((A + 1,), device=dev).index_add_(0, idx, vals)[:A]
        if not equal:
            raise SystemExit(f"cell_sum_ordered ({case}) differs from its plain version")
        # each kernel and index_add_ timed by its launches' mean, as the
        # profiler now and then drops a call, summed over a call's kernels
        us_k, n_k = device_us(run_k, reps[0], CELL_KERNELS)
        ours = [k for k in us_k if any(s in k for s in CELL_KERNELS)]
        dev_k = {k: us_k[k] / n_k[k] for k in ours}
        clock = sm_clock_mhz()  # read beside the window
        us_l, n_l = device_us(run_lib, reps[0], ("index",))
        dev_l = {k: v / n_l[k] for k, v in us_l.items() if "index" in k}
        if (not dev_k or not dev_l) and not by_events:
            raise SystemExit("cell_sum_ordered: the profiler saw no device time "
                             "of the kernel or of index_add_")
        if len(dev_k) > MAX_CELL_LAUNCHES:
            raise SystemExit(f"cell_sum_ordered ({case}): {len(dev_k)} kernels a call")
        largest = int(torch.bincount(idx, minlength=A + 1)[:A].max())
        n_bytes = cell.shape[0] * 8 + A * 4
        return {
            "name": "cell_sum_ordered", "case": case, "N": cell.shape[0], "A": A,
            "largest_cell": largest, "equal": equal, "max_abs_err": err,
            "index_add_bit_equal": bool(torch.equal(lib_out.view(torch.int32), want.view(torch.int32))),
            "ms": stream_ms(run_k, reps[0]) if by_events else sum(dev_k.values()) / 1e3,
            "timed_by": "CUDA events behind a sleep kernel" if by_events else "torch.profiler",
            "launches_a_call": len(dev_k),
            "device_us_by_launch": {s: sum(v for k, v in dev_k.items() if s in k)
                                    for s in CELL_KERNELS if any(s in k for k in dev_k)},
            "traced_share": {k: n_k[k] for k in ours},
            "library_ms": (stream_ms(run_lib, reps[0]) if by_events
                           else sum(dev_l.values()) / 1e3),
            # CUDA events around a call: the plain version waits once for
            # the card (its round count), so its wall time is its time
            "plain_ms": per_call_ms(run_p, reps[1]),
            "wrapper_ms": per_call_ms(run_k, reps[0]),
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bound_bytes": n_bytes,
            # the largest cell's chain of dependent adds at the SM clock
            "sm_clock_mhz": clock,
            "chain_ms": largest * CYCLES_PER_ADD / (clock * 1e6) * 1e3,
        }

    cell0, vals0, A0 = (x.cpu().numpy() if torch.is_tensor(x) else x
                        for x in cell_inputs[0])
    del cell_inputs
    cell_rows = {}
    for case, cell, vals, A in cell_sum_inputs.kernel_cases(cell0, vals0, A0):
        cell, vals = torch.from_numpy(cell).to(dev), torch.from_numpy(vals).to(dev)
        big = case in ("128 replicas", "large cells")
        r = check_cell_kernel(case, cell, vals, A, (20, 1 if big else 2))
        emit({"phase": "kernel", **{k: v for k, v in r.items() if not k.endswith("_ms")},
              "device_us": r["ms"] * 1e3, "plain_wall_us": r["plain_ms"] * 1e3,
              "index_add_device_us": r["library_ms"] * 1e3,
              "wrapper_us": r["wrapper_ms"] * 1e3, "bound_us": r["bound_ms"] * 1e3,
              "chain_us": r["chain_ms"] * 1e3})
        cell_rows[case] = r
    del cell, vals
    r, rr = cell_rows["wireless tick 0"], cell_rows["128 replicas"]
    kernel_rows[("cell_sum_ordered", "wireless")] = {
        "name": "cell_sum_ordered", "route": "cuda",
        "source": SOURCES["cell_sum_ordered"],
        "replaces": REPLACES["cell_sum_ordered"],
        "replaces_note": "no TPU kernel: the index order of XLA's "
                         "float32 scatter-add, which the card's "
                         "atomic adds do not keep",
        "launches": 0, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": "bytes", "library_ms": r["library_ms"],
        "library": "Tensor.index_add_ (atomic adds, another order)",
        "shape": {"N": r["N"], "A": r["A"], "largest_cell": r["largest_cell"]},
        "shape_of": "wireless", "bound_bytes": r["bound_bytes"],
        "wrapper_ms": r["wrapper_ms"], "chain_ms": r["chain_ms"],
        "launches_a_call": r["launches_a_call"],
        # config 4's 128 replicas flattened, the replica axis's shape
        "replicas_128": {k: rr[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_bytes",
            "chain_ms", "max_abs_err", "launches_a_call", "largest_cell",
            "N", "A")},
    }
    del cell_rows

    # where a wireless tick's time goes
    spec, st, net, b = wireless.wireless5(device=dev, **w_kw)
    prof_row, by_name = tick_profile(spec, st, net, b, None)  # moving users
    emit({
        "phase": "wireless_profile", **prof_row,
        "cell_kernel_device_us_per_tick": sum(
            v for k, v in by_name.items() if any(s in k for s in CELL_KERNELS)),
        "arrival_kernels_device_us_per_tick": sum(
            v for k, v in by_name.items() if any(s in k for s in OUR_KERNELS)),
    })
    del st

    # ---- 11. battery churn: users shut down and restart ------------------
    c_kw = dict(CHURN, policy=int(Policy.MIN_BUSY))
    spec, st, net, b = wireless.wireless5(device=dev, **c_kw)
    step = engine.make_step(spec)
    U = spec.n_users
    prev = st.nodes.alive[:U]
    downs = torch.zeros((U,), dtype=torch.int32, device=dev)
    ups = torch.zeros((U,), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(spec.n_ticks):
        st = step(st, net, b)
        a = st.nodes.alive[:U]
        downs += (prev & ~a).int()
        ups += (~prev & a).int()
        prev = a
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    spec_c, st_c, net_c, b_c = wireless.wireless5(device="cpu", **c_kw)
    cpu, _ = engine.run(spec_c, st_c, net_c, b_c)
    n_leaves = assert_same(st, cpu, "wireless_churn")
    emit({
        "phase": "wireless_churn", "n_users": U, "ticks": spec.n_ticks,
        "leaves_equal": n_leaves, "shutdowns": downs.tolist(),
        "restarts": ups.tolist(), "n_published": int(st.metrics.n_published),
        "n_scheduled": int(st.metrics.n_scheduled), "wall_s": wall,
        "ms_per_tick": wall / spec.n_ticks * 1e3, "launches": launches,
    })
    if not (int(downs.max()) > 0 and int(ups.max()) > 0):
        raise SystemExit("wireless_churn: no user shut down and restarted")
    if launches["fused_arrival_plan"] <= 0:
        raise SystemExit("wireless_churn: the path never launched fused_arrival_plan")

    # ---- 12. rr_grid: benchmarks.py::config2 at its own size -------------
    rr_kw = dict(RR_GRID, policy=int(Policy.ROUND_ROBIN))
    spec, st, net, b = smoke.build(device=dev, **rr_kw)
    step, cache = engine.make_step(spec), static_cache(spec, st, net)
    windows, fused_plan = [], ak.fused_arrival_plan

    def kept_plan(*args):
        windows.append(args)
        return fused_plan(*args)

    ak.fused_arrival_plan = kept_plan
    try:
        for _ in range(spec.n_ticks):
            st = step(st, net, b, cache)
    finally:
        ak.fused_arrival_plan = fused_plan
    torch.cuda.synchronize()
    stepped = st
    masked = [int(w[0].sum()) for w in windows]
    full = [w for w, m in zip(windows, masked) if m]
    for args in full:
        if not same_bits(fused_plan(*args), ak.fused_arrival_plan_plain(*args)):
            raise SystemExit("rr_grid: fused_arrival_plan differs from its plain "
                             "version on a window of the run")
    if not full:
        raise SystemExit("rr_grid: no arrival window held a row")
    r = check_arrival_kernel("fused_arrival_plan", full[0][:3], full[0][3], (50, 20, 100, 20))
    emit_kernel(r, "rr_grid, first non-empty window")
    kernel_rows[("fused_arrival_plan", "rr_grid")] = kernel_row(r, "rr_grid", "real")
    n_checked = len(full)
    del windows, full
    spec, st, net, b = smoke.build(device=dev, **rr_kw)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    card, _ = engine.run(spec, st, net, b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    n_same = assert_same(card, stepped, "rr_grid (engine.run against the stepped run)")
    del stepped
    t0 = time.perf_counter()
    n_leaves = assert_same(card, cpu_run(rr_kw), "rr_grid")
    cpu_s = time.perf_counter() - t0
    summ = summarize(card)
    spec_p, st_p, net_p, b_p = smoke.build(device=dev, **rr_kw)
    prof_row, _ = tick_profile(spec_p, st_p, net_p, b_p, static_cache(spec_p, st_p, net_p))
    emit({
        "phase": "rr_grid", "n_users": spec.n_users, "n_fogs": spec.n_fogs,
        "policy": "ROUND_ROBIN", "window": spec.window,
        "task_rows": spec.task_capacity, "ticks": spec.n_ticks,
        "leaves_equal": n_leaves, "leaves_equal_stepped": n_same,
        "n_scheduled": summ["n_scheduled"], "n_published": summ["n_published"],
        "n_completed": summ["n_completed"], "n_dropped": summ["n_dropped"],
        "n_deferred_max": summ["n_deferred_max"],
        "fogs_used": len(set(card.tasks.fog[card.tasks.fog >= 0].tolist())),
        "arrival_plan_checked_windows": n_checked,
        "wall_s": wall, "cpu_run_s": cpu_s,
        "task_offload_decisions_per_sec": summ["n_scheduled"] / wall,
        "ms_per_tick": wall / spec.n_ticks * 1e3,
        "launches": launches, **prof_row,
    })
    if launches["fused_arrival_plan"] != spec.n_ticks:
        raise SystemExit(f"rr_grid: launches {launches} in {spec.n_ticks} ticks")
    rr_launches = launches
    del card

    # ---- 13. the compacted broker's policies on the bench world ----------
    def policy_world(device, name):
        pol, over = POLICIES[name]
        pid = int(Policy[pol])
        kw = bench_world(5e-3)
        if "mips0_divisor" in over:
            kw["bug_compat"] = BugCompat(mips0_divisor=over["mips0_divisor"])
        learned = pol in ("UCB", "DUCB", "EXP3") or over.get("learn_in_dynamic", False)
        if learned:
            kw.update(horizon=LEARN_HORIZON,
                      max_sends_per_user=int(LEARN_HORIZON / kw["send_interval"]) + 4)
        kw.update(policy=pid, derive_acks=not learned,
                  learn_in_dynamic=over.get("learn_in_dynamic", False))
        spec, st, net, b = smoke.build(device=device, **kw)
        if pid == int(Policy.DYNAMIC):
            st = st.replace(broker=st.broker.replace(policy_id=torch.full(
                (), int(Policy.EXP3), dtype=torch.int32, device=device)))
        return spec, st, net, b

    policy_launches = {}
    for name in POLICIES:
        spec, st, net, b = policy_world(dev, name)
        engine.run(spec, st, net, b)  # warm-up: same work, same shapes
        torch.cuda.synchronize()
        spec, st, net, b = policy_world(dev, name)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        card, _ = engine.run(spec, st, net, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_launches()
        t0 = time.perf_counter()
        spec_c, st_c, net_c, b_c = policy_world("cpu", name)
        cpu, _ = engine.run(spec_c, st_c, net_c, b_c)
        cpu_s = time.perf_counter() - t0
        n_leaves = assert_same(card, cpu, f"policies {name}")
        del cpu
        summ = summarize(card)
        spec_p, st_p, net_p, b_p = policy_world(dev, name)
        prof_row, _ = tick_profile(spec_p, st_p, net_p, b_p, static_cache(spec_p, st_p, net_p))
        row = {
            "phase": "policies", "policy": name, "n_users": spec.n_users,
            "n_fogs": spec.n_fogs, "window": spec.window,
            "task_rows": spec.task_capacity, "ticks": spec.n_ticks,
            "derive_acks": spec.derive_acks, "leaves_equal": n_leaves,
            "n_scheduled": summ["n_scheduled"], "n_published": summ["n_published"],
            "n_completed": summ["n_completed"], "n_dropped": summ["n_dropped"],
            "n_deferred_max": summ["n_deferred_max"],
            "fogs_used": len(set(card.tasks.fog[card.tasks.fog >= 0].tolist())),
            "wall_s": wall, "cpu_run_s": cpu_s,
            "task_offload_decisions_per_sec": summ["n_scheduled"] / wall,
            "ms_per_tick": wall / spec.n_ticks * 1e3,
            "launches": launches, **prof_row,
        }
        if spec.learn_active:
            row["learn_lat_cnt"] = float(card.learn.lat_cnt)
            row["learn_pick_count"] = card.learn.pick_count.tolist()
            row["learn_pick_p_below_one"] = int((card.learn.pick_p < 1.0).sum())
        emit(row)
        if spec.learn_active and not row["learn_lat_cnt"] > 0:
            raise SystemExit(f"policies {name}: no reward was credited")
        if not 0 < launches["fused_arrival_plan"] <= spec.n_ticks:
            raise SystemExit(f"policies {name}: launches {launches}")
        policy_launches[name] = launches["fused_arrival_plan"]
        del card

    # ---- 14-17. the replica axis ------------------------------------------
    def single_replica(batch, r):
        return tree_map(lambda x: x[r].clone(), batch)

    def replica_launches(launches):
        """Arrival-plan wrapper calls (either kernel) and per-cell sums."""
        return (launches["fused_arrival_plan"] + launches["pairwise_rank"],
                launches["cell_sum_ordered"])

    # 14. replicas_small: the batching rules on the card against the CPU's
    # plain versions under the same rules, every leaf
    small_rows = []
    for world, (builder, pol, kw) in REPLICAS_SMALL.items():
        build = smoke.build if builder == "smoke" else getattr(wireless, builder)
        kw = dict(kw, policy=int(Policy[pol]))
        finals = {}
        for device in (dev, "cpu"):
            spec, st, net, b = build(device=device, **kw)
            batch = replicate_state(spec, st, SMALL_R, seed=REPLICA_SEED)
            reset_launches()
            with strict_vmap():
                finals[str(device)] = run_batched(spec, batch, net, b)[0]
            if device == dev:
                launches = all_launches()
        n_leaves = assert_same(finals[str(dev)], finals["cpu"], f"replicas_small {world}")
        arrival, cells = replica_launches(launches)
        small_rows.append({"world": world, "replicas": SMALL_R, "ticks": spec.n_ticks,
                           "leaves_equal": n_leaves, "launches": launches})
        if arrival != spec.n_ticks or cells != (spec.n_ticks if spec.n_aps else 0):
            raise SystemExit(f"replicas_small {world}: launches {launches} in "
                             f"{spec.n_ticks} ticks")
    emit({"phase": "replicas_small", "worlds": small_rows})

    def replica_phase(phase, spec, batch, net, b, extra=None):
        """One replica batch at full width: a warm-up run, a timed run
        (through ``run_batched``, every kernel input kept by a tap that
        also refuses a CPU tensor), replicas 0, 1 and R - 1 against
        single-world card runs of their states (every leaf, and the same
        wrapper calls a tick), and a short profile of the batched tick.
        Returns the row and each kernel's first non-empty real input."""
        R = batch.t.shape[0]
        with strict_vmap():  # warm-up: every shape of the run, its first ticks
            run_batched(spec, batch, net, b, n_ticks=REPLICA_WARM_TICKS)
        torch.cuda.synchronize()
        kept = {"fused_arrival_plan": [], "pairwise_rank": [], "cell_sum_ordered": []}

        def tap(name, *args):
            if not args[0].is_cuda:
                raise SystemExit(f"{phase}: {name} took the CPU path")
            kept[name].append(args)

        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.TAPS.append(tap)
        try:
            with strict_vmap():
                t0 = time.perf_counter()
                final, _ = run_batched(spec, batch, net, b)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            cuda_build.TAPS.remove(tap)
        launches = all_launches()
        peak = torch.cuda.max_memory_allocated()
        n_sched = int(final.metrics.n_scheduled.sum())
        n_pub = int(final.metrics.n_published.sum())
        checked = {}
        for r in sorted({0, 1, R - 1}):
            reset_launches()
            one, _ = engine.run(spec, single_replica(batch, r), net, b)
            torch.cuda.synchronize()
            if replica_launches(all_launches()) != replica_launches(launches):
                raise SystemExit(f"{phase}: replica {r} alone made {all_launches()} "
                                 f"wrapper calls, the batch {launches}")
            checked[r] = assert_same(tree_map(lambda x: x[r], final), one,
                                     f"{phase}: replica {r} against its single run")
        del final, one
        arrival, cells = replica_launches(launches)
        if arrival != spec.n_ticks or cells not in (0, spec.n_ticks):
            raise SystemExit(f"{phase}: launches {launches} in {spec.n_ticks} ticks")
        with strict_vmap():
            tick, _ = engine.batched_tick(spec, net, b, batch)
            prof_row, by_name = tick_profile(spec, batch, net, b, None, tick=tick)
        first = {}
        for name, calls in kept.items():
            for args in calls:
                rows = args[0] if name != "cell_sum_ordered" else (
                    (args[0] >= 0) & (args[0] < args[2]))
                if int(rows.sum()):
                    first[name] = args
                    break
        row = {
            "phase": phase, "replicas": R, "n_users": spec.n_users,
            "n_fogs": spec.n_fogs, "window": spec.window,
            "task_rows_per_replica": spec.task_capacity, "ticks": spec.n_ticks,
            "leaves_equal_single": checked, "n_scheduled": n_sched,
            "n_published": n_pub,
            "wall_s": wall, "ms_per_tick": wall / spec.n_ticks * 1e3,
            "task_offload_decisions_per_sec": n_sched / wall,
            "peak_device_bytes": peak, "launches": launches,
            "launches_per_tick": {k: v / spec.n_ticks for k, v in launches.items()},
            "flattened_fogs": R * spec.n_fogs, **(extra or {}), **prof_row,
            "arrival_kernels_device_us_per_tick": sum(
                v for k, v in by_name.items() if any(s in k for s in OUR_KERNELS)),
            "cell_kernel_device_us_per_tick": sum(
                v for k, v in by_name.items() if any(s in k for s in CELL_KERNELS)),
        }
        return row, first, launches

    def flattened_kernel_rows(path, first, launches, flat_fogs):
        """Each kernel of a replica path against its plain version on the
        first non-empty end-to-end input of the timed run (``flat_fogs``
        fogs end to end), a row of the kernels line each."""
        for name, args in first.items():
            if name == "cell_sum_ordered":
                r = check_cell_kernel(f"{path}, first real input", *args, (20, 1),
                                      by_events=True)
                emit({"phase": "kernel", **{k: v for k, v in r.items()
                                            if not k.endswith("_ms")},
                      "device_us": r["ms"] * 1e3, "plain_wall_us": r["plain_ms"] * 1e3,
                      "index_add_device_us": r["library_ms"] * 1e3,
                      "wrapper_us": r["wrapper_ms"] * 1e3,
                      "bound_us": r["bound_ms"] * 1e3, "chain_us": r["chain_ms"] * 1e3})
                kernel_rows[(name, path)] = {
                    "name": name, "route": "cuda", "source": SOURCES[name],
                    "replaces": REPLACES[name],
                    "launches": launches[name], "max_abs_err": r["max_abs_err"],
                    "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": "bytes",
                    "library_ms": r["library_ms"],
                    "library": "Tensor.index_add_ (atomic adds, another order)",
                    "shape": {"N": r["N"], "A": r["A"], "largest_cell": r["largest_cell"]},
                    "shape_of": path, "bound_bytes": r["bound_bytes"],
                    "wrapper_ms": r["wrapper_ms"], "launches_a_call": r["launches_a_call"],
                    "timed_by": r["timed_by"],
                }
                continue
            r = check_arrival_kernel(name, args[:3], flat_fogs, (10, 2, 10, 1),
                                     by_events=True)
            emit_kernel(r, f"{path}, first non-empty end-to-end window")
            kernel_rows[(name, path)] = kernel_row(r, path, "real, replicas end to end")
        for name, _ in first.items():
            kernel_rows[(name, path)]["launches"] = launches[name]
            kernel_rows[(name, path)]["launches_by_path"] = {path: launches[name]}

    # 15. config3: benchmarks.py::config3 at full width, 64 replicas
    spec, st, net, b = bm.config3_world(dev)
    batch = replicate_state(spec, st, 64, seed=0)
    row, first, launches = replica_phase("config3", spec, batch, net, b)
    emit(row)
    flattened_kernel_rows("config3", first, launches, row["flattened_fogs"])
    del batch, first

    # 16. config4: benchmarks.py::config4 at its 128 replicas, 100 ticks
    spec, st, net, b = bm.config4_world(device=dev)
    batch = replicate_state(spec, st, CONFIG4_R, seed=0)
    row, first, launches = replica_phase("config4", spec, batch, net, b)
    emit(row)
    flattened_kernel_rows("config4", first, launches, row["flattened_fogs"])
    del batch, first

    # 17. config5: one chunk of 32 load levels of benchmarks.py::config5,
    # each policy's batch, then the four as one Policy.DYNAMIC batch (5b)
    loads = bm.config5_loads()[:CONFIG5_CHUNK]
    c5_kw = bm.config5_build_kw(device=dev)
    pols = [int(p) for p in bm.CONFIG5_POLICIES]
    for dynamic, path in ((False, "config5"), (True, "config5b")):
        total = {"fused_arrival_plan": 0, "pairwise_rank": 0, "cell_sum_ordered": 0}
        kernel_first = {}
        for batch_pols, spec, batch, net, b in policy_batches(
            smoke.build, pols, loads, dynamic=dynamic, **c5_kw
        ):
            row, first, launches = replica_phase(
                path, spec, batch, net, b,
                {"policies": [Policy(p).name for p in batch_pols],
                 "load_levels": len(loads), "load_levels_of_config": 256})
            emit(row)
            for k in total:
                total[k] += launches[k]
            for k, v in first.items():
                kernel_first.setdefault(k, v)
            del batch
        flattened_kernel_rows(path, kernel_first, total, row["flattened_fogs"])
        del kernel_first

    # each row's launches: the main paths' calls at that row's shape
    by_path = {
        ("fused_arrival_plan", "bench"): {
            "bench": fused_main,
            "tp_window": window_launches["fused_arrival_plan"],
            **{f"policies {k}": v for k, v in policy_launches.items()},
        },
        ("fused_arrival_plan", "rr_grid"): {
            "rr_grid": rr_launches["fused_arrival_plan"],
        },
        ("fused_arrival_plan", "tp"): {"tp": tp_launches["fused_arrival_plan"]},
        ("pairwise_rank", "wide_fog"): {"wide_fog": wide_launches},
        ("ring_all_gather", "tp"): {"tp": tp_launches["ring_all_gather"]},
        ("fused_arrival_plan", "wireless"): {
            "wireless": wireless_launches["fused_arrival_plan"],
        },
        ("cell_sum_ordered", "wireless"): {
            "wireless": wireless_launches["cell_sum_ordered"],
        },
    }
    for key, paths in by_path.items():
        kernel_rows[key]["launches"] = sum(paths.values())
        kernel_rows[key]["launches_by_path"] = paths

    emit({"kernels": list(kernel_rows.values()),
          "seconds": round(time.perf_counter() - t_start, 1)})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
