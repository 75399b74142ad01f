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
4. smoke: ``smoke.build(horizon=0.1)`` on the card against the same world
   on the CPU, every leaf equal, and the run's summary;
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
8. tp: ``bench.py::tp_measurement``'s world (2^20 users x 64 fogs, cut
   to 30 of its 50 ticks of 5 ms, 9,437,184 task rows) under ``run_tp_sharded`` at four
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
   the Bianchi MAC keyed by offered load, ENERGY_AWARE, cut to 50 of 100 ticks of
   5 ms, T = 90,000 task rows): a stepped card run that keeps every
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
   battery world at dt 10 ms under MIN_BUSY (8 users, cut to 160 of 400
   ticks: the first restart comes at tick 137), stepped
   on the card watching ``nodes.alive`` (at least one user shut down and
   one restarted), card against CPU every leaf;

12. rr_grid: ``benchmarks.py::config2`` (96 users x 4 fogs, ROUND_ROBIN
   on the compacted broker, K = 1,024), cut to 60 of its 1,000 ticks of
   1 ms: a stepped card run that keeps every arrival window, with
   ``fused_arrival_plan`` held against its plain version on every
   non-empty one (and timed on the first), then ``engine.run`` timed
   (decisions per second, ms per tick, launches), card against CPU every
   leaf, and a short profile (device events a tick);
13. policies: the bench world of phase 5 (dt 5 ms) under MIN_BUSY
   without the ``mips0_divisor`` quirk, RANDOM, UCB, DUCB, EXP3 and
   DYNAMIC (``learn_in_dynamic``, its id set to EXP3), ``derive_acks``
   off for the learned ones as ``bench.py`` sets it, the learned ones at
   ``LEARN_HORIZON``: each timed after a warm-up run of its first
   ``REPLICA_WARM_TICKS`` ticks, card against CPU
   every leaf, its short profile, and for the learned ones the credited
   count ``learn.lat_cnt``, which must be above 0;
14. replicas_small: the replica axis (``run_batched``: one ``vmap`` of
   the tick a tick, the kernels' batching rules laying the replicas'
   windows end to end) on 4 replicas of config 3's world cut to 32 users
   x 6 fogs and of config 4's cut to 40 users, card against CPU every
   leaf, one wrapper call of each kernel a tick;
15. config3: ``benchmarks.py::config3`` at full width, 64 replicas of
   1,000 users x 24 fogs (1,536 fogs end to end: ``pairwise_rank`` and
   the per-fog reductions a replica), cut to 40 of its 250 ticks of 1 ms;
16. config4: ``benchmarks.py::config4`` at its 128 replicas (512 fogs
   end to end: ``fused_arrival_plan``; 8,192 cells: ``cell_sum_ordered``
   on 1,288,832 entries every tick), cut to 20 of its 100 ticks of 5 ms;
17. config5: one chunk of 32 of ``benchmarks.py::config5``'s 256 load
   levels at full width (10,000 users x 32 fogs, K = 4,096, cut to 10 of
   its 50 ticks of 5 ms): a batch of 32 replicas for each of its four policies (1,024
   fogs end to end: ``fused_arrival_plan``), then the four as one
   ``Policy.DYNAMIC`` batch of 128 (5b: 4,096 fogs, ``pairwise_rank``).
   Phases 15-17 each run a batch once to warm up (its first 5 ticks)
   and once timed (ms a
   tick, decisions per second over all replicas, peak device memory,
   each wrapper's calls a tick, which must be the single world's one),
   hold replicas 0, 1 and R - 1 against single-world card runs of their
   states (every leaf), profile a few batched ticks (device events and
   busy share), and hold each kernel against its plain version on the
   first non-empty end-to-end input of the timed run, timed beside its
   bound; functorch's per-replica fallback is off throughout, and a
   kernel input on the CPU fails the phase;
18. chunked: the bench world (dt 5 ms, 20 ticks) through
   ``engine.run_chunked`` in chunks of 7, promoted (the knobs a device
   operand), timed with and without a callback that keeps each boundary's
   state: the callback sees ticks 7, 14 and 20 and its kept states stay
   intact, every leaf equals the card's ``engine.run`` and the CPU's
   ``run_chunked``;
19. reconfigure: config 4's single world (40 ticks in chunks of 10), its
   idle power and shutdown threshold retuned at tick 20: equal to the
   manual composition (two promoted ``engine.run`` calls) and to the CPU,
   every leaf; the alive users at each boundary;
20. dyn4: ``benchmarks.py``'s dyn4, ``sweep_dyn``'s batch over config 4's
   world (idle power {2, 4, 6, 8} mW x shutdown {10, 20} %, 16 replicas a
   cell, 128 in all), each replica's knobs a row of the device operand,
   run as phases 15-17 run theirs; the first and last replica of cells 0
   and 7 against promoted single-world card runs on their cell's knobs;
21. learned_grid: the bench world under UCB (``derive_acks`` off,
   ``LEARN_HORIZON``), reward scale {0.25, 0.3} x discount {0.99, 0.995}, 16
   replicas a cell (2,048 fogs end to end: ``pairwise_rank``, held against
   its plain version on the first real input), as phase 20; the 0.3 cells'
   first and last replicas against promoted single runs;
22. whatif: the bench world's twin (uplink loss 1 %, as ``bench.py``
   builds it) run 20 ticks, then ``sweep_dyn_from`` forks the carry onto 8
   loss values from 0.01 to 0.08, 20 ticks ahead, timed as one ask
   (``whatif_latency_s``); rows 0 and 7 against direct promoted runs from
   the same carry, and ``fused_arrival_plan`` against its plain version on
   the first real end-to-end window (empty: the fork's fogs are saturated
   and fast-drop every arrival);
23. tp_chunked: the tp_window world with loss 1 % and a stop time of 80
   ms under ``run_tp_chunked`` at four shards in chunks of 5, loss and stop
   time retuned at tick 10: equal to the manual composition and to the
   single-device ``run_chunked`` with the same retune; then
   ``unstamp_tp_carry`` and a 4-cell stop-time fork, each row equal to a
   cold promoted run from the carry;
24. v1_bench, v2_bench, front_droptail: the bench world of phase 5 (dt 5
   ms, ``derive_acks`` off, as these worlds need) under the v1 apps (POOL
   fogs, LOCAL_FIRST on a 50,000-MIPS broker pool, periodic adverts), the
   v2 hybrid broker (``app_gen=2``, ``v2_local_broker``), and the full
   arrival front with DropTail link queues: each timed after a warm-up
   run of its first ticks, card against CPU every leaf, a short profile; ``local_pool_scan``
   against its plain version bit for bit on the first window of the v1
   and the v2 run that holds a row, on 8 replicas of the v2 window in
   one launch (the batching rule) and on 128, on dense windows (every
   valid row taken, v1 and v2) and on a v2 window whose timer fires in
   its middle (``scenarios/pool_scan_inputs``): its device time, an
   empty launch timed the same way (the floor), one launch a tick and its
   bound (bytes, operations, and the chain over the takes and the fire);
   ``fused_arrival_plan`` against its plain version on the first
   non-empty pool-arrival window of the v2 run;
25. wired_v1 (``scenarios/wired_v1``, 0.15 s of 1 ms) and example
   (``scenarios/example``, 1.06 s of 1 ms: past the 1.0414 s link-up and
   into the drain), card against CPU every leaf, and ``local_pool_scan``
   against its plain version on each run's first window that holds a
   row.
26. chaos: the bench world (dt 5 ms, 20 ticks) with
   ``bench.py::chaos_measurement``'s knobs (REOFFLOAD, 8 retries, the RTT
   wave and its bursts, fog 0 scripted down from 30 to 60 ms) and random
   churn (MTBF 50 ms, MTTR 20 ms), not static, under MIN_BUSY (the dense
   broker), EXP3 (the compacted broker and the learner's crash penalty)
   and MIN_BUSY in LOSE mode: each timed after a warm-up run, card
   against CPU every leaf, the fault counters (crashes, recoveries and
   the mode's bounces or losses above 0), a short profile, and
   ``fused_arrival_plan`` against its plain version on the run's first
   window that holds a row;
27. chaos_replicas: 16 replicas of the MIN_BUSY chaos world through
   ``run_replicated`` (512 fogs end to end), each on its own chaos key,
   as phases 15-17 run theirs, replicas 0 and 15 against single-world
   card runs of their states;
28. hier and hier_domain_down: ``bench.py::hier_measurement``'s layout at
   the bench world's width, 4 brokers (domain 0: the 8 slow fogs and
   every user; domains 1-3: 24 fast fogs), THRESHOLD 0.5, 2 hops, 5 ms
   between brokers, under RANDOM (the compacted broker's per-domain slot
   tables), then its twin with domain 0's fogs down over 10-90 % of the
   horizon under MIN_BUSY (the dense broker's winner a domain, chaos
   REOFFLOAD): each as phase 26, migrations above 0, hop exhaustions
   printed;
29. tp_aps: ``benchmarks.py::config4``'s world at one replica and full
   width made TP-eligible (linear MAC, no energy model, static; 10,000
   users, 64 APs, cut to 75 of its 100 ticks of 5 ms) under ``run_tp_sharded`` at four shards
   against ``engine.run`` on the card, every leaf (the APs'
   ``assoc_sum`` too), the ring and arrival kernels' launches a tick,
   and each held against its plain version on the run's first real
   exchange and window.
30. telemetry: the bench world (dt 5 ms, 20 ticks, ``derive_acks`` off)
   on fast fogs (80,000 MIPS, so status-6 acks land in its 0.1 s) with
   plane 1, the latency histogram and 64 journeys in rings of 64, then
   the MIN_BUSY chaos world of phase 26 on the same fogs and the hier
   world of phase 28 with plane 1 and the histogram: each as phase 26
   (card against CPU every leaf, the arrival kernel on the bench run's
   first real window), a histogram that counted acks, the host readers'
   roll-ups printed, ms and device events a tick with telemetry on and
   off (each world's off twin, and phase 7's world, which may not make
   more device events than phase 7 did), one ``cell_sum_ordered`` a
   tick, held against its plain version on the first latency sum with
   due rows;
31. telemetry_replicas: 16 replicas of phase 30's bench world with plane
   1 and the histogram, as phases 15-17 (its arrival kernel at
   chaos_replicas' shapes, held there), replicas 0 and 15 against their
   single runs, a histogram that counted acks, the latency sum's
   ``cell_sum_ordered`` held against its plain version on the batch's
   first input with due rows, beside the same batch with telemetry off;
32. tp_telemetry: phase 30's bench world under four shards, without an
   arrival window (the ring) and with the bench's (the top-K merge):
   card against CPU every leaf, a histogram that counted acks, the ring
   and arrival launches a tick, the exchange roll-up, each kernel against
   its plain version on the run's first real exchange and window, the
   latency sum's on a shard's first input with due rows, ms and device
   events a tick on and off.
33. cli: ``python -m fognetsimpp_tpu_torch`` as a subprocess on the card
   at full width, config 4's world at one replica (``-s wireless5 -p
   energy_aware`` with ``--set`` keys for 10,000 users, 64 APs, the
   Bianchi MAC, 5 ms ticks, queue 64, 50 ms sends and the config's
   arrival window, on the telemetry phases' 80,000-MIPS fogs;
   ``CLI_TICKS`` ticks) with ``--ticks --telemetry --hist --out``: tasks
   completed and a histogram that counted acks, its summary line, wall
   time and the series' bytes, its
   ``.sca.json`` and ``.vec.npz`` against an in-process ``--platform
   cpu`` run of the same argv, every value equal; the same argv once
   more through ``main()`` in this process with the wrapper counts reset
   before it (``fused_arrival_plan`` and ``cell_sum_ordered`` must have
   launched); then two small calls through ``main()`` on the card,
   counted, and on the CPU, their files held equal: ``--tp 4`` with no
   window (``ring_all_gather``) and ``-c examples/demo_v2.ini`` (the v2
   pool fogs: ``local_pool_scan``).
   Every phase from 18 on resets the wrapper counts before its path and
   fails if a kernel of the path was launched no time;

then the ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` prints them, and ``{"ok": true, "device": {...}}`` last.
Without a CUDA device it prints no result and exits 2.
"""
from __future__ import annotations

import dataclasses
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

#: Name fragment of the local-pool scan's one launch in a device trace.
POOL_KERNEL = "local_pool_scan_kernel"
#: Dependent float32 operations on the pool's chain an event (a take or
#: the timer's fire): v1 compares and subtracts; v2 also compares with the
#: fire time and adds the refund.
POOL_CHAIN_OPS = {False: 2, True: 4}
#: Bytes and operations a valid row of the scan needs: its MIPS (and
#: time, v2) read, and the chain's operations plus the take's select.
POOL_ROW_OPS = {False: 3, True: 6}

SOURCES = {
    "local_pool_scan": "fognetsimpp_tpu_torch/csrc/pool_scan.cu",
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
    # no TPU kernel: the lax.scan of the broker's local pool (v1 body;
    # the v2 body at :1723)
    "local_pool_scan": "fognetsimpp_tpu/core/engine.py:1689",
}


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also holds the script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - _T0, 1)}
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
#: fogs, send interval 50 ms, dt 5 ms, one send a tick; its 0.25 s cut to
#: 0.15 s (30 ticks) for the script's time.
TP_WORLD = dict(
    n_users=1_048_576, n_fogs=64, fog_mips=(1000.0, 2000.0, 3000.0, 4000.0),
    send_interval=0.05, horizon=0.15, dt=5e-3,
    max_sends_per_user=int(0.25 / 0.05) + 4, max_sends_per_tick=1,
    queue_capacity=128, start_time_max=min(0.05, 0.25 / 4), derive_acks=True,
)
TP_SHARDS = 4
#: The bench's per-shard exchange window (bench.py:579-580): 34,142.
TP_K_EX = max(256, int(1.3 * (TP_WORLD["n_users"] // TP_SHARDS) * 5e-3 / 0.05) + 64)
#: Ticks of the tp world held card against CPU (the CPU run's length).
TP_CHECK_TICKS = 3
#: Masked rows of a shard's arrival-plan window at the tp world's tick 0,
#: all bound for one fog (this script's ``tp_profile`` phase on an H100);
#: the kernel phase holds the kernel against its plain version on such a
#: window.
TP_TICK0_MASKED = 86_103
#: Masked rows of the bench world's one non-empty window at dt 5 ms, all
#: in one fog (the port's CPU run of that world).
BENCH_MASKED = 2_281

#: ``benchmarks.py::config2`` at its own size: 96 users x 4 fogs,
#: ROUND_ROBIN, send interval 10 ms, dt 1 ms, cut from 1.0 s to 0.06 s
#: (60 ticks) for the script's time (``benchmarks.py 2`` runs it whole).
RR_GRID = dict(
    n_users=96, n_fogs=4, send_interval=0.01, horizon=0.06, dt=1e-3,
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
#: Horizon of the smoke world's run (cut from 0.5 s for the script's time).
SMOKE_HORIZON = 0.1
#: Horizon of the learned policies' runs: at the bench world's 0.1 s no
#: status-6 ack has landed under UCB or DUCB (tasks take 0.05-0.9 s on
#: fogs of 1,000-4,000 MIPS), so their credit path would not run; by
#: 0.15 s each has credited some (the phase fails otherwise).  Cut from
#: 0.3 s for the script's time.
LEARN_HORIZON = 0.15
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
REPLICA_WARM_TICKS = 5
#: ``benchmarks.py``'s ``CONFIG4_R``, and config 5's chunk of load levels
#: (the script runs one chunk of the 256).
CONFIG4_R, CONFIG5_CHUNK = 128, 32
#: Horizons that cut configs 3, 5 and 4 (with dyn4) from their own 0.25,
#: 0.25 and 0.5 s for the script's time (``benchmarks.py`` runs them
#: whole): 40 ticks of 1 ms, 10 and 20 of 5 ms.
CONFIG3_HORIZON, CONFIG5_HORIZON, CONFIG4_HORIZON = 0.04, 0.05, 0.1

#: tests/test_parity_wireless.py's fast-cycling battery world (12 mJ
#: batteries, 18 mW net drain while publishing) at dt 10 ms, MIN_BUSY,
#: cut to 1.6 s (the port's CPU run: first shutdown at tick 10, first
#: restart at tick 137).
CHURN = dict(
    numb_users=8, horizon=1.6, dt=0.01, send_interval=0.1, w_contention=0.0,
    mac_model="linear", energy_capacity_j=0.012, tx_energy_j=2e-3,
    rx_energy_j=1e-4, idle_power_w=2e-3, harvest_power_w=4e-3,
    harvest_period_s=50.0, harvest_duty=0.5,
)


#: ``reconfigure``: config 4's single world cut to 40 of its 100 ticks,
#: in chunks of 10 ticks, its energy knobs retuned at tick 20.
RECONF_HORIZON, RECONF_CHUNK, RECONF_AT = 0.2, 10, 20
RECONF_KNOBS = {"idle_power_w": 4e-3, "shutdown_frac": 0.2}
#: ``learned_grid``: reward scale x discount on the bench world under UCB,
#: 16 replicas a cell (64 x 32 = 2,048 fogs end to end).
LEARNED_KNOBS = {"learn_reward_scale": [0.25, 0.3], "learn_discount": [0.99, 0.995]}
LEARNED_NRC = 16
#: ``whatif``: loss values 0.01-0.08 forked from the twin world's carry.
WHATIF_CELLS = 8
#: ``tp_chunked``: the retune at tick 10 of the tp_window world's 20.
TP_RETUNE = {"uplink_loss_prob": 0.03, "send_stop_time": 0.06}
#: The bench world's front phase: its spec overrides (the v1/v2 phases'
#: are ``scenarios.pool_scan_inputs.V1V2``).
FRONT_DROPTAIL = dict(two_stage_arrivals=False, wired_queue_enabled=True,
                      derive_acks=False)
#: Replicas of the v2 window that the scan's batching rule is held on, and
#: the larger batch the scan is also timed on.
POOL_REPLICAS, POOL_REPLICAS_WIDE = 8, 128
#: Rows of the scan's synthetic windows (``pool_scan_inputs.rows``): the
#: bench world's window.
POOL_SYNTH_K = 4096
#: Horizons of the scenario worlds held card against CPU.
WIRED_V1_HORIZON, EXAMPLE_HORIZON = 0.15, 1.06
#: The wireless world (config 4 at one replica) cut to 50 of its 100 ticks.
WIRELESS_HORIZON = 0.25

#: ``chaos``: ``bench.py::chaos_measurement``'s knobs on the bench world
#: (dt 5 ms, 20 ticks): REOFFLOAD with 8 retries, the RTT wave and bursts,
#: fog 0 scripted down from 30 to 60 ms, and random churn fast enough to
#: crash and recover fogs within the 0.1 s horizon.  Chaos moves fog
#: liveness, so the world is not static, and the ack columns are written
#: in the tick (``derive_acks`` off).
CHAOS_BENCH = dict(
    chaos=True, chaos_mode=1, chaos_max_retries=8, chaos_rtt_amp=0.5,
    chaos_rtt_period_s=0.5, chaos_rtt_burst_prob=0.02, chaos_rtt_burst_mult=4.0,
    chaos_script=((0, 0.03, 0.06),), chaos_mtbf_s=0.05, chaos_mttr_s=0.02,
    assume_static=False, derive_acks=False,
)
#: The chaos rows: MIN_BUSY (dense broker), EXP3 (compacted broker and the
#: learner's crash penalty) and MIN_BUSY in LOSE mode.
CHAOS_ROWS = {
    "min_busy": {}, "exp3": {"policy": "EXP3"}, "lose_min_busy": {"chaos_mode": 0},
}
#: ``chaos_replicas``: replicas of the MIN_BUSY chaos world (512 fogs end
#: to end: ``fused_arrival_plan``).
CHAOS_R = 16
#: ``hier``: ``bench.py::hier_measurement``'s layout at the bench world's
#: width, 4 brokers: domain 0 holds the 8 slow fogs (3,000 MIPS) and every
#: user, domains 1-3 the 24 fast ones (80,000 MIPS), by bench.py's split.
HIER_BROKERS, HIER_SLOW = 4, 32 // 4
HIER_FOG_OWNER = [0] * HIER_SLOW + [
    1 + (i * (HIER_BROKERS - 1)) // (32 - HIER_SLOW) for i in range(32 - HIER_SLOW)
]
HIER_BENCH = dict(
    fog_mips=tuple([3000.0] * HIER_SLOW + [80000.0] * (32 - HIER_SLOW)),
    n_brokers=HIER_BROKERS, hier_policy=1, hier_threshold=0.5, hier_max_hops=2,
    hier_rtt_s=5e-3,
)
#: The federated world runs RANDOM on the compacted broker (per-domain
#: slot tables): MIN_BUSY's stale view sends a 20-tick run's publishes to
#: one fog of domain 0's eight, whose load (1/8) then never passes the
#: threshold.  The domain-down twin runs MIN_BUSY on the dense broker
#: (one winner a domain): domain 0's fogs down over 10-90 % of the
#: horizon, REOFFLOAD, not static.
HIER_UP = dict(policy="RANDOM")
HIER_DOWN = dict(
    chaos=True, chaos_mode=1, chaos_max_retries=8, assume_static=False,
    derive_acks=False, chaos_script=tuple((f, 0.01, 0.09) for f in range(HIER_SLOW)),
)
#: ``tp_aps``: ``benchmarks.py::config4``'s world at one replica and full
#: width, made TP-eligible (linear MAC, no energy model, static), cut to 75
#: of its 100 ticks, without config 4's arrival window: the TP tick's no-window
#: exchange is the ring all-gather (a windowed spec merges top-K windows
#: instead).  The linear MAC charges 1.5 ms a station of the cell (about
#: 156 here), so connecting takes 0.2-0.5 s and the first task reaches a
#: fog at tick 63 (the port's CPU run): 50 ticks would plan no arrival.
TP_APS = dict(
    numb_users=10_000, horizon=0.375, dt=5e-3, policy="ENERGY_AWARE",
    send_interval=0.05, queue_capacity=64, extra_aps=59, mac_model="linear",
    energy_enabled=False, assume_static=True,
)


#: The telemetry phases (30-32): plane 1 and the latency histogram on,
#: journeys of 64 sampled tasks in rings of 64 on the bench world.  The
#: histogram streams at ack time in the tick, so the ack columns are
#: written there (``derive_acks`` off).
TELEMETRY = dict(telemetry=True, telemetry_hist=True, derive_acks=False)
TEL_JOURNEYS = dict(telemetry_journeys=64, telemetry_journey_ring=64)
#: The telemetry bench worlds' fogs: the hier world's fast ones (80,000
#: MIPS).  At the bench world's 1,000-4,000 MIPS MIN_BUSY's first task
#: takes 200-900 ms, so no status-6 ack lands in 0.1 s and the histogram
#: would stream nothing; at 80,000 MIPS acks land from the first ticks
#: (62 in 20 ticks on 400 users, the port's CPU run).
TEL_FOGS = dict(fog_mips=(80000.0,))
#: ``telemetry_replicas``: 16 replicas of the telemetry bench world.
TEL_R = 16
#: The bench tick's device events before the telemetry planes were ported
#: (an H100 80GB HBM3 at 700 W): a telemetry-off tick must launch what it
#: launched before.
PRE_TELEMETRY_BENCH_EVENTS = 1688.0
#: Device events a tick by which two traces of one world's tick may differ.
TRACE_NOISE_EVENTS = 2.0

#: ``cli``: config 4's world at one replica through the CLI
#: (``benchmarks.py::config4_world``'s keys; the arrival window is added
#: from that world's spec), ``CLI_TICKS`` ticks of 5 ms, on the telemetry
#: phases' fast fogs (``TEL_FOGS``): at config 4's 1,000-4,000 MIPS no
#: task completes within 0.3 s (the port's CPU run at 300 users), so the
#: histogram and the completion columns would hold zeros; at 80,000 MIPS
#: acks land from the tenth tick.
CLI_TICKS = 20
CLI_CONFIG4 = [
    "-s", "wireless5", "-p", "energy_aware",
    "--set", "scenario.numb_users=10000", "--set", "scenario.extra_aps=59",
    "--set", "scenario.mac_model=bianchi", "--set", "scenario.dt=5ms",
    "--set", "scenario.queue_capacity=64", "--set", "scenario.send_interval=50ms",
    "--set", f"fog.*.mips={TEL_FOGS['fog_mips'][0]:g}",
    "--set", f"scenario.horizon={CLI_TICKS * 5e-3:g}",
    "--ticks", "--telemetry", "--hist",
]
#: The two small CLI calls: the TP tick with no window (the ring), 10
#: ticks on fogs fast enough that tasks complete, and the v2 demo config
#: (pool fogs: the local-pool scan, a launch a tick), cut to 0.05 s (0.5 s
#: took 79 s of the script: 58 ms a tick on the card, three runs), before
#: its users' first publish: it holds the scan's launches and the card's
#: files to the CPU's; the ``example`` phase runs the same world past its
#: link-up.
CLI_TP = ["-s", "smoke", "--tp", "4", "--set", "scenario.n_users=1024",
          "--set", "scenario.n_fogs=32", "--set", f"fog.*.mips={TEL_FOGS['fog_mips'][0]:g}",
          "--set", "scenario.send_interval=10ms", "--set", "scenario.horizon=0.01"]
CLI_DEMO_V2 = ["-c", "examples/demo_v2.ini", "--set", "scenario.horizon=0.05"]


def _cli_files_equal(a: dict, b: dict, what: str) -> dict:
    """Two runs' ``.sca.json`` and ``.vec.npz`` (paths from their summary
    lines): every value equal but the run stamp and the argv attribute
    (output directories and ``--platform``).  Returns the series'
    bytes."""
    import numpy as np

    def sca(path):
        with open(path) as f:
            d = json.load(f)
        d.pop("recorded_at")
        d["attrs"].pop("argv")
        return d

    if sca(a["sca"]) != sca(b["sca"]):
        raise SystemExit(f"cli {what}: the .sca.json files differ")
    with np.load(a["vec"]) as va, np.load(b["vec"]) as vb:
        if sorted(va.files) != sorted(vb.files):
            raise SystemExit(f"cli {what}: the .vec.npz files hold other vectors")
        for k in va.files:
            x, y = va[k], vb[k]
            if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
                raise SystemExit(f"cli {what}: vector {k} differs")
        return {"series_bytes": int(sum(va[k].nbytes for k in va.files if k.startswith("tick."))),
                "vectors": len(va.files)}


def cli_phase(reset_launches, all_launches, need_launches, smi) -> dict:
    """Phase 33 (see the module docstring): the config 4 call as a
    subprocess on the card, each call through ``main()`` in this process
    on the card with the counts reset and on the CPU; returns each call's
    launches."""
    import contextlib
    import io
    import os

    import torch

    from fognetsimpp_tpu_torch import benchmarks as bm
    from fognetsimpp_tpu_torch.__main__ import main as cli_main

    root = os.path.dirname(os.path.abspath(__file__))
    out_root = os.path.join(root, "_cli_out")  # git-ignored
    window = bm.config4_world(horizon=CLI_TICKS * 5e-3, device="cpu")[0].window
    calls = {
        "config4": CLI_CONFIG4 + ["--set", f"scenario.arrival_window={window}"],
        "tp": CLI_TP,
        "demo_v2": CLI_DEMO_V2,
    }
    need = {"config4": ("fused_arrival_plan", "cell_sum_ordered"),
            "tp": ("fused_arrival_plan", "ring_all_gather"),
            "demo_v2": ("fused_arrival_plan", "local_pool_scan")}
    #: the calls whose tasks must complete on the card
    completes = ("config4", "tp")
    launches = {}
    for name, argv in calls.items():
        what = f"cli {name}"
        # a config file named from the checkout's root
        argv = [os.path.join(root, a) if a.endswith(".ini") else a for a in argv]
        out = {k: os.path.join(out_root, name, k) for k in ("card", "main", "cpu")}
        card = wall = None
        if name == "config4":  # the python -m entry point itself
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "fognetsimpp_tpu_torch", *argv, "--out", out["card"]],
                cwd=root, capture_output=True, text=True, timeout=600,
            )
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise SystemExit(f"{what}: exit {proc.returncode}: {proc.stderr[-2000:]}")
            card = json.loads(proc.stdout.strip().splitlines()[-1])

        def in_process(args):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(args)
            if rc != 0:
                raise SystemExit(f"{what}: main() returned {rc}")
            return json.loads(buf.getvalue().strip().splitlines()[-1])

        reset_launches()
        t1 = time.perf_counter()
        counted = in_process(argv + ["--out", out["main"]])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t1
        launches[name] = all_launches()
        need_launches(what, launches[name], need[name])
        t1 = time.perf_counter()
        cpu = in_process(argv + ["--platform", "cpu", "--out", out["cpu"]])
        cpu_s = time.perf_counter() - t1
        if card is not None:
            _cli_files_equal(card, counted, f"{name} (subprocess against main())")
        card = counted if card is None else card
        files = _cli_files_equal(card, cpu, f"{name} (card against CPU)")
        for k in ("n_published", "n_completed"):
            if card[k] != cpu[k]:
                raise SystemExit(f"{what}: {k} {card[k]} on the card, {cpu[k]} on the CPU")
        if name in completes and card["n_completed"] <= 0:
            raise SystemExit(f"{what}: no task completed ({card})")
        hist_count = None
        if "--hist" in argv:
            with open(card["sca"]) as f:
                hist_count = json.load(f)["hist"]["count"]
            if hist_count <= 0:
                raise SystemExit(f"{what}: the latency histogram counted no ack")
        emit({
            "phase": "cli", "call": name, "argv": argv,
            "summary": {k: v for k, v in card.items()
                        if k not in ("sca", "vec", "sca_txt", "vec_txt", "anf")},
            "subprocess_wall_s": wall, "run_wall_s": card["wall_s"],
            "main_wall_s": main_s, "cpu_run_s": cpu_s, "hist_count": hist_count, **files,
            "launches": launches[name], "nvidia_smi": smi,
        })
    return launches


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
    from fognetsimpp_tpu_torch.ops import pool_kernels as pk
    from fognetsimpp_tpu_torch.ops import queues as tq
    from fognetsimpp_tpu_torch.ops import ring_kernels as rk
    from fognetsimpp_tpu_torch.parallel.replicas import replicate_state, strict_vmap
    from fognetsimpp_tpu_torch.parallel.sweep import policy_batches
    from fognetsimpp_tpu_torch.dynspec import apply_knobs, dyn_of, dyn_to_device, shape_key
    from fognetsimpp_tpu_torch.parallel.sweep import dyn_batch as sweep_dyn_batch
    from fognetsimpp_tpu_torch.parallel.sweep import sweep_dyn_from
    from fognetsimpp_tpu_torch.parallel.taskshard import (
        run_tp_chunked, run_tp_sharded, unstamp_tp_carry,
    )
    from fognetsimpp_tpu_torch.runtime.signals import summarize
    from fognetsimpp_tpu_torch.scenarios import (
        cell_sum_inputs, example, pool_scan_inputs, smoke, wired_v1, wireless,
    )
    from fognetsimpp_tpu_torch.spec import BugCompat, Policy
    from fognetsimpp_tpu_torch.state import state_to_numpy, tree_leaves, tree_map
    # device ms by CUDA events behind a sleep kernel: the replica paths'
    # kernel rows (the profiler's trace of a call dropped launches there)
    # and the scan's
    from fognetsimpp_tpu_torch.tools.ab import stream_ms

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
            # the engine's record_function("phase_<name>") spans are
            # annotations, not device work
            if str(ev.device_type).endswith("CUDA") and not ev.name.startswith("phase_"):
                us = float(ev.time_range.elapsed_us())
                dev_us += us
                n_events += 1
                by_name[ev.name] = by_name.get(ev.name, 0.0) + us
        return dev_us, n_events, by_name

    def reset_launches():
        ak.reset_launches()
        rk.reset_launches()
        ck.reset_launches()
        pk.reset_launches()

    def all_launches():
        return {**ak.LAUNCHES, **rk.LAUNCHES, **ck.LAUNCHES, **pk.LAUNCHES}

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
    kw = dict(horizon=SMOKE_HORIZON)
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
    bench_events = prof_row["device_events_per_tick"]
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
    w_kw = dict(cell_sum_inputs.wireless_kw(), horizon=WIRELESS_HORIZON)

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

    def check_cell_kernel(case, cell, vals, A, reps, by_events=False, n_bytes=None):
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
        if n_bytes is None:
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
        engine.run(spec, st, net, b, n_ticks=REPLICA_WARM_TICKS)  # warm-up
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

    def replica_phase(phase, spec, batch, net, b, extra=None, dyn_rows=None,
                      singles=None, runner=run_batched):
        """One replica batch at full width: a warm-up run, a timed run
        (through ``runner``, ``run_batched`` or an entry point with its
        arguments and return, every kernel input kept by a tap that
        also refuses a CPU tensor), replicas 0, 1 and R - 1 against
        single-world card runs of their states (every leaf, and the same
        wrapper calls a tick), and a short profile of the batched tick.
        With ``dyn_rows`` (a knob grid, ``spec`` its shape key) each
        replica runs its row of knobs, and the replicas checked are
        ``singles``' keys, each against a single promoted run on its
        cell's knobs (the value).  Returns the row and each kernel's first
        non-empty real input."""
        R = batch.t.shape[0]
        with strict_vmap():  # warm-up: every shape of the run, its first ticks
            runner(spec, batch, net, b, n_ticks=REPLICA_WARM_TICKS,
                   dyn_rows=dyn_rows)
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
                final, _ = runner(spec, batch, net, b, dyn_rows=dyn_rows)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            cuda_build.TAPS.remove(tap)
        launches = all_launches()
        peak = torch.cuda.max_memory_allocated()
        n_sched = int(final.metrics.n_scheduled.sum())
        n_pub = int(final.metrics.n_published.sum())
        hist = ({"lat_hist_count": int(final.telem.lat_hist.sum())}
                if spec.telemetry and spec.telemetry_hist else {})
        checked = {}
        singles = singles or {r: None for r in (0, 1, R - 1)}
        for r in sorted(singles):
            reset_launches()
            one, _ = engine.run(spec, single_replica(batch, r), net, b, dyn=singles[r])
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
            tick, _ = engine.batched_tick(spec, net, b, batch, dyn_rows)
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
            "n_published": n_pub, **hist,
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
    spec = dataclasses.replace(spec, horizon=CONFIG3_HORIZON).validate()
    batch = replicate_state(spec, st, 64, seed=0)
    row, first, launches = replica_phase("config3", spec, batch, net, b)
    emit(row)
    flattened_kernel_rows("config3", first, launches, row["flattened_fogs"])
    del batch, first

    # 16. config4: benchmarks.py::config4 at its 128 replicas, 50 ticks
    spec, st, net, b = bm.config4_world(horizon=CONFIG4_HORIZON, device=dev)
    batch = replicate_state(spec, st, CONFIG4_R, seed=0)
    row, first, launches = replica_phase("config4", spec, batch, net, b)
    emit(row)
    flattened_kernel_rows("config4", first, launches, row["flattened_fogs"])
    del batch, first

    # 17. config5: one chunk of 32 load levels of benchmarks.py::config5,
    # each policy's batch, then the four as one Policy.DYNAMIC batch (5b)
    loads = bm.config5_loads()[:CONFIG5_CHUNK]
    c5_kw = dict(bm.config5_build_kw(device=dev), horizon=CONFIG5_HORIZON)
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

    # ---- 18-23. the promoted knobs: chunks, retunes, grids, the what-if --
    def keep_states(kept):
        """A run_chunked callback that keeps each boundary's state and a
        host copy of its leaves."""
        return lambda s, done: kept.append((done, s, state_to_numpy(s)))

    def kept_intact(kept, what):
        for done, s, snap in kept:
            now = state_to_numpy(s)
            if int(s.tick) != done or any(a.tobytes() != c.tobytes()
                                          for a, c in zip(now, snap)):
                raise SystemExit(f"{what}: the state kept at tick {done} changed")

    def dyn_on(spec, device, **knobs):
        """``spec``'s knobs, retuned by ``knobs``, as an operand on ``device``."""
        return dyn_to_device(dyn_of(apply_knobs(spec, knobs) if knobs else spec), device)

    def need_launches(what, launches, names):
        """The path went through each kernel in ``names``."""
        for name in names:
            if launches[name] <= 0:
                raise SystemExit(f"{what}: the path never launched {name} ({launches})")

    # 18. chunked: run_chunked on the bench world, a callback between chunks
    kw = bench_world(5e-3)
    spec, st, net, b = smoke.build(device=dev, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, _ = engine.run(spec, st, net, b)
    torch.cuda.synchronize()
    wall_run = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.run_chunked(spec, st, net, b, chunk_ticks=7)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    kept = []
    reset_launches()
    t0 = time.perf_counter()
    card = engine.run_chunked(spec, st, net, b, chunk_ticks=7, callback=keep_states(kept))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    need_launches("chunked", launches, ("fused_arrival_plan",))
    seen = [d for d, _, _ in kept]
    if seen != [7, 14, 20]:
        raise SystemExit(f"chunked: the callback saw {seen}")
    kept_intact(kept, "chunked")
    n_run = assert_same(card, ref, "chunked against engine.run on the card")
    spec_c, st_c, net_c, b_c = smoke.build(device="cpu", **kw)
    n_cpu = assert_same(card, engine.run_chunked(spec_c, st_c, net_c, b_c, chunk_ticks=7),
                        "chunked card against CPU")
    emit({"phase": "chunked", "ticks": spec.n_ticks, "chunk_ticks": 7,
          "callback_ticks": seen, "leaves_equal_run": n_run, "leaves_equal_cpu": n_cpu,
          "wall_s": wall, "ms_per_tick": wall / spec.n_ticks * 1e3,
          "no_callback_ms_per_tick": wall_plain / spec.n_ticks * 1e3,
          "run_wall_s": wall_run, "run_ms_per_tick": wall_run / spec.n_ticks * 1e3,
          "n_scheduled": int(card.metrics.n_scheduled), "launches": launches})
    chunked_launches = launches
    del kept, card, ref

    # 19. reconfigure: config 4's single world, the energy knobs retuned at
    # tick 20 of 40 in chunks of 10
    at = RECONF_AT

    def reconf(done):
        return RECONF_KNOBS if done == at else None

    def alive_users(s, U):
        return int(s.nodes.alive[:U].sum())

    spec, st, net, b = bm.config4_world(horizon=RECONF_HORIZON, device=dev)
    U = spec.n_users
    alive_at = {}
    reset_launches()
    t0 = time.perf_counter()
    card = engine.run_chunked(
        spec, st, net, b, chunk_ticks=RECONF_CHUNK, reconfigure=reconf,
        callback=lambda s, done: alive_at.__setitem__(done, alive_users(s, U)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    need_launches("reconfigure", launches, ("fused_arrival_plan", "cell_sum_ordered"))
    key = shape_key(spec)
    mid, _ = engine.run(key, st, net, b, n_ticks=at, dyn=dyn_on(spec, dev))
    manual, _ = engine.run(key, mid, net, b, n_ticks=spec.n_ticks - at,
                           dyn=dyn_on(spec, dev, **RECONF_KNOBS))
    n_manual = assert_same(card, manual, "reconfigure against the manual composition")
    del mid, manual
    spec_c, st_c, net_c, b_c = bm.config4_world(horizon=RECONF_HORIZON, device="cpu")
    n_cpu = assert_same(card, engine.run_chunked(
        spec_c, st_c, net_c, b_c, chunk_ticks=RECONF_CHUNK, reconfigure=reconf),
        "reconfigure card against CPU")
    emit({"phase": "reconfigure", "n_users": U, "ticks": spec.n_ticks,
          "chunk_ticks": RECONF_CHUNK, "retuned_at": at, "knobs": RECONF_KNOBS,
          "leaves_equal_manual": n_manual, "leaves_equal_cpu": n_cpu,
          "alive_users_by_tick": alive_at,
          "least_alive_before": min(v for k, v in alive_at.items() if k <= at),
          "least_alive_after": min([v for k, v in alive_at.items() if k > at]
                                   + [alive_users(card, U)]),
          "wall_s": wall, "ms_per_tick": wall / spec.n_ticks * 1e3,
          "launches": launches})
    reconf_launches = launches
    del card

    # 20. dyn4: sweep_dyn's batch over config 4's energy knobs, 128 replicas
    grid, key, batch, net, b, rows = bm.dyn4_batch(horizon=CONFIG4_HORIZON, device=dev)
    nrc = bm.DYN4_REPLICAS_PER_CELL
    spec0 = bm.config4_world(horizon=CONFIG4_HORIZON, device="cpu")[0]
    singles = {
        r: dyn_on(spec0, dev, **grid[r // nrc])
        for c in (0, len(grid) - 1) for r in (c * nrc, (c + 1) * nrc - 1)
    }
    row, first, launches = replica_phase(
        "dyn4", key, batch, net, b, {"cells": grid, "replicas_per_cell": nrc},
        dyn_rows=rows, singles=singles)
    emit(row)
    need_launches("dyn4", launches, ("fused_arrival_plan", "cell_sum_ordered"))
    dyn4_launches = launches
    del batch, rows, first

    # 21. learned_grid: the bench world under UCB, a reward scale x discount
    # grid, 16 replicas a cell (2,048 fogs end to end: pairwise_rank)
    grid, key, batch, net, b, rows = sweep_dyn_batch(
        smoke.build, LEARNED_KNOBS, LEARNED_NRC, 0,
        **dict(bench_world(5e-3), policy=int(Policy.UCB), derive_acks=False,
               horizon=LEARN_HORIZON, device=dev))
    spec0 = smoke.build(device="cpu", **dict(
        bench_world(5e-3), policy=int(Policy.UCB), derive_acks=False,
        horizon=LEARN_HORIZON))[0]
    singles = {
        r: dyn_on(spec0, dev, **grid[r // LEARNED_NRC])
        for c, cell in enumerate(grid) if cell["learn_reward_scale"] == 0.3
        for r in (c * LEARNED_NRC, (c + 1) * LEARNED_NRC - 1)
    }
    row, first, launches = replica_phase(
        "learned_grid", key, batch, net, b,
        {"cells": grid, "replicas_per_cell": LEARNED_NRC}, dyn_rows=rows, singles=singles)
    emit(row)
    need_launches("learned_grid", launches, ("pairwise_rank",))
    flattened_kernel_rows("learned_grid", {k: v for k, v in first.items()
                                           if k == "pairwise_rank"},
                          launches, row["flattened_fogs"])
    learned_launches = launches
    del batch, rows, first

    # 22. whatif: the bench world's twin (uplink loss 1 %), 20 ticks, then
    # a fork onto 8 loss values 20 ticks ahead (bench.py's what-if)
    kw = dict(bench_world(5e-3), uplink_loss_prob=0.01)
    spec, st, net, b = smoke.build(device=dev, **kw)
    carry, _ = engine.run(spec, st, net, b)
    losses = [round(0.01 * (i + 1), 2) for i in range(WHATIF_CELLS)]
    sweep_dyn_from(spec, carry, net, b, {"uplink_loss_prob": losses[:2]}, 2)  # warm-up
    torch.cuda.synchronize()
    calls = []

    def tap(name, *args):
        if not args[0].is_cuda:
            raise SystemExit(f"whatif: {name} took the CPU path")
        calls.append((name, args))

    reset_launches()
    cuda_build.TAPS.append(tap)
    try:
        t0 = time.perf_counter()
        cells, fork = sweep_dyn_from(spec, carry, net, b, {"uplink_loss_prob": losses},
                                     spec.n_ticks)
        n_sched = int(fork.metrics.n_scheduled.sum())
        ask_s = time.perf_counter() - t0
    finally:
        cuda_build.TAPS.remove(tap)
    launches = all_launches()
    need_launches("whatif", launches, ("fused_arrival_plan",))
    key = shape_key(spec)
    checked = {}
    for i in (0, len(cells) - 1):
        one, _ = engine.run(key, carry, net, b, n_ticks=spec.n_ticks,
                            dyn=dyn_on(spec, dev, **cells[i]))
        checked[i] = assert_same(tree_map(lambda x, i=i: x[i], fork), one,
                                 f"whatif row {i} against its direct run")
    emit({"phase": "whatif", "fork_tick": spec.n_ticks, "cells": cells,
          "ticks_ahead": spec.n_ticks, "leaves_equal_direct": checked,
          "whatif_latency_s": ask_s, "n_scheduled": n_sched, "launches": launches})
    # each kernel's first non-empty input; past the carry's tick 20 the
    # saturated fogs fast-drop every arrival, so the windows are empty and
    # the first of them stands in
    first = {}
    for name, args in calls:
        if name not in first and int(args[0].sum()):
            first[name] = args
    for name, args in calls:
        first.setdefault(name, args)
    flattened_kernel_rows("whatif", first, launches, len(cells) * spec.n_fogs)
    del carry, fork, first, calls

    # 23. tp_chunked: the tp_window world under four shards in chunks of 5,
    # its loss and stop time retuned at tick 10; then the carry forked
    kw = dict(bench_world(5e-3), uplink_loss_prob=0.01, send_stop_time=0.08)

    def tp_reconf(done):
        return TP_RETUNE if done == 10 else None

    spec, st, net, b = smoke.build(device=dev, **kw)
    reset_launches()
    t0 = time.perf_counter()
    sp_f, card = run_tp_chunked(spec, st, net, b, n_shards=TP_SHARDS, chunk_ticks=5,
                                reconfigure=tp_reconf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    need_launches("tp_chunked", launches, ("fused_arrival_plan",))
    sp_a, mid = run_tp_sharded(spec, st, net, b, n_shards=TP_SHARDS, n_ticks=10)
    _, manual = run_tp_sharded(apply_knobs(sp_a, TP_RETUNE), mid, net, b,
                               n_shards=TP_SHARDS, n_ticks=spec.n_ticks - 10)
    n_manual = assert_same(card, manual, "tp_chunked against the manual composition")
    single = engine.run_chunked(spec, st, net, b, chunk_ticks=5, reconfigure=tp_reconf)
    n_single = assert_same(card, single, "tp_chunked against run_chunked on one device")
    del mid, manual, single
    sp_w, carry = unstamp_tp_carry(sp_f, card)
    fork_knobs = {"send_stop_time": [0.06, 0.11, 0.13, 0.15]}
    cells, fork = sweep_dyn_from(sp_w, carry, net, b, fork_knobs, 10)
    key = shape_key(sp_w)
    for i, cell in enumerate(cells):
        cold, _ = engine.run(key, carry, net, b, n_ticks=10, dyn=dyn_on(sp_w, dev, **cell))
        assert_same(tree_map(lambda x, i=i: x[i], fork), cold, f"tp what-if row {i}")
    emit({"phase": "tp_chunked", "n_shards": TP_SHARDS, "ticks": spec.n_ticks,
          "chunk_ticks": 5, "retune": TP_RETUNE, "spec_after": {
              k: getattr(sp_f, k) for k in TP_RETUNE},
          "leaves_equal_manual": n_manual, "leaves_equal_single_device": n_single,
          "fork_cells": cells, "fork_rows_equal_cold_runs": len(cells),
          "wall_s": wall, "ms_per_tick": wall / spec.n_ticks * 1e3,
          "launches": launches})
    tp_chunked_launches = launches
    del card, carry, fork

    # ---- 24. the v1/v2 apps and the full front with DropTail, full width --
    v1v2_bench = {**pool_scan_inputs.V1V2, "front_droptail": FRONT_DROPTAIL}

    def v1v2_build(name):
        return lambda device: smoke.build(
            device=device, **dict(bench_world(5e-3), **v1v2_bench[name]))

    def world_run(phase, build, need):
        """A warm-up run of the first ticks, then the timed run (every
        kernel input kept by a tap that refuses a CPU tensor), the same
        world on the CPU, every leaf equal.  Returns the spec, the card's
        final state, the kept calls, the launches, the wall, the CPU run's
        seconds and the leaves compared."""
        spec, st, net, b = build(dev)
        engine.run(spec, st, net, b, n_ticks=REPLICA_WARM_TICKS)  # warm-up
        torch.cuda.synchronize()
        spec, st, net, b = build(dev)
        calls = []

        def tap(name, *args):
            if not args[0].is_cuda:
                raise SystemExit(f"{phase}: {name} took the CPU path")
            calls.append((name, args))

        torch.cuda.synchronize()
        reset_launches()
        cuda_build.TAPS.append(tap)
        try:
            t0 = time.perf_counter()
            card, _ = engine.run(spec, st, net, b)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            cuda_build.TAPS.remove(tap)
        launches = all_launches()
        need_launches(phase, launches, need)
        t0 = time.perf_counter()
        spec_c, st_c, net_c, b_c = build("cpu")
        cpu, _ = engine.run(spec_c, st_c, net_c, b_c)
        cpu_s = time.perf_counter() - t0
        n_leaves = assert_same(card, cpu, phase)
        return spec, card, calls, launches, wall, cpu_s, n_leaves

    def pool_bound(rows, got, v2):
        """The least time for the scan on these rows: each valid row's
        MIPS (and time) read once, the valid flags read and the takes
        written once; the operations the valid rows need; and the chain of
        the pool's dependent operations over the events that change it
        (each world's takes and fire, the longest world) at the SM clock.
        The bound is the largest of the three.  The chain is the
        operations' own limit (their dependence, not their rate), so
        ``bound_by`` names it "operations"; ``ops_ms`` and ``chain_ms``
        tell the two apart."""
        valid = rows[1]
        R, K = valid.shape
        n_valid = int(valid.sum())
        n_bytes = 2 * R * K + n_valid * (8 if v2 else 4) + R * 17
        n_ops = n_valid * POOL_ROW_OPS[v2]
        events = int((got[0].sum(dim=1) + got[2]).max()) if R else 0
        clock = sm_clock_mhz()
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / CUDA_CORE_OPS_PER_S * 1e3
        t_chain = events * POOL_CHAIN_OPS[v2] * CYCLES_PER_ADD / (clock * 1e6) * 1e3
        return {
            "bound_ms": max(t_bytes, t_ops, t_chain),
            "bound_by": "bytes" if t_bytes >= max(t_ops, t_chain) else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops, "valid_rows": n_valid,
            "bytes_ms": t_bytes, "ops_ms": t_ops, "chain_ms": t_chain,
            "chain_events": events, "sm_clock_mhz": clock,
        }

    def check_pool_scan(what, rows, v2, reps=(50, 5), plain_once=False):
        """``local_pool_scan`` against its plain version on ``rows`` (R
        worlds as rows, the layout the taps see), bit for bit: device and
        wall times of both, an empty launch timed the same way (the
        floor), launches a call, the bound.  ``plain_once`` times the
        plain version by one call (it takes seconds on a wide batch)."""
        run_k = lambda: pk.local_pool_scan_rows(*rows, v2)  # noqa: E731
        run_p = lambda: pk.local_pool_scan_plain(*rows, v2)  # noqa: E731
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # the wrapper may not sync
        try:
            got = run_k()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        want = run_p()
        if not same_bits(got, want):
            raise SystemExit(f"local_pool_scan ({what}) differs from its plain version")
        before = pk.LAUNCHES["local_pool_scan"]
        run_k()
        launches = pk.LAUNCHES["local_pool_scan"] - before
        r = {
            "name": "local_pool_scan", "case": what, "R": rows[0].shape[0],
            "K": rows[0].shape[1], "v2": v2, "equal": True,
            "max_abs_err": max_abs_err(got, want),
            # CUDA events: the profiler's trace of these calls came back
            # empty six times running on the card
            "ms": stream_ms(run_k, reps[0]),
            "launch_floor_ms": stream_ms(lambda: torch.cuda._sleep(0), reps[0]),
            "timed_by": "CUDA events behind a sleep kernel",
            "launches_a_call": launches,
            # the plain version reads its rows to the host once a call
            "plain_ms": (stream_ms(run_p, 1, runs=1) if plain_once
                         else per_call_ms(run_p, reps[1])),
            "wrapper_ms": per_call_ms(run_k, reps[0]),
            "takes": int(got[0].sum()), "fired": int(got[2].sum()),
            **pool_bound(rows, got, v2),
        }
        emit({"phase": "kernel", **{k: v for k, v in r.items() if not k.endswith("_ms")},
              "device_us": r["ms"] * 1e3, "plain_wall_us": r["plain_ms"] * 1e3,
              "wrapper_us": r["wrapper_ms"] * 1e3, "bound_us": r["bound_ms"] * 1e3,
              "bytes_us": r["bytes_ms"] * 1e3, "ops_us": r["ops_ms"] * 1e3,
              "chain_us": r["chain_ms"] * 1e3,
              "launch_floor_us": r["launch_floor_ms"] * 1e3})
        return r

    def pool_case(r):
        """A scan row's numbers on one more window."""
        return {k: r[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "ops_ms", "chain_ms",
            "chain_events", "launch_floor_ms", "max_abs_err", "launches_a_call",
            "R", "K", "valid_rows", "takes", "fired")}

    def first_call(calls, name):
        """The first kept call of ``name`` whose window holds a row."""
        for n, args in calls:
            if n == name and bool(args[1 if name == "local_pool_scan" else 0].any()):
                return args
        raise SystemExit(f"no call of {name} held a row")

    def pool_row(r, path, launches):
        return {
            "name": "local_pool_scan", "route": "cuda",
            "source": SOURCES["local_pool_scan"],
            "replaces": REPLACES["local_pool_scan"],
            "replaces_note": "no TPU kernel: the jax.lax.scan of LOCAL_FIRST's "
                             "sequential pool debit (v2 body at engine.py:1723)",
            "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "library": "none: no PyTorch call computes a sequential pool debit",
            "shape": {"R": r["R"], "K": r["K"], "valid_rows": r["valid_rows"],
                      "takes": r["takes"], "fired": r["fired"]},
            "shape_of": path, "bound_bytes": r["bound_bytes"],
            "bound_ops": r["bound_ops"], "bytes_ms": r["bytes_ms"], "ops_ms": r["ops_ms"],
            "chain_ms": r["chain_ms"], "chain_events": r["chain_events"],
            "launch_floor_ms": r["launch_floor_ms"],
            "wrapper_ms": r["wrapper_ms"], "launches_a_call": r["launches_a_call"],
            "timed_by": r["timed_by"],
        }

    v1v2_launches = {}
    for phase in v1v2_bench:
        build = v1v2_build(phase)
        need = ("fused_arrival_plan",) + (("local_pool_scan",) if phase != "front_droptail" else ())
        spec, card, calls, launches, wall, cpu_s, n_leaves = world_run(phase, build, need)
        if phase != "front_droptail" and launches["local_pool_scan"] != spec.n_ticks:
            raise SystemExit(f"{phase}: local_pool_scan launched "
                             f"{launches['local_pool_scan']} times in {spec.n_ticks} ticks")
        summ = summarize(card)
        spec_p, st_p, net_p, b_p = build(dev)
        prof_row, by_name = tick_profile(spec_p, st_p, net_p, b_p,
                                         static_cache(spec_p, st_p, net_p))
        emit({
            "phase": phase, "n_users": spec.n_users, "n_fogs": spec.n_fogs,
            "window": spec.window, "task_rows": spec.task_capacity,
            "ticks": spec.n_ticks, "leaves_equal": n_leaves,
            "n_scheduled": summ["n_scheduled"], "n_local": int(card.metrics.n_local),
            "n_rejected": int(card.metrics.n_rejected),
            "n_published": summ["n_published"], "n_completed": summ["n_completed"],
            "n_dropped": summ["n_dropped"], "n_lost": int(card.metrics.n_lost),
            "n_link_drops": int(card.metrics.n_link_drops),
            "n_deferred_max": summ["n_deferred_max"],
            "wall_s": wall, "cpu_run_s": cpu_s,
            # decisions: the broker's placements, local runs included
            "task_offload_decisions_per_sec":
                (summ["n_scheduled"] + int(card.metrics.n_local)) / wall,
            "ms_per_tick": wall / spec.n_ticks * 1e3, "launches": launches,
            **prof_row,
            "pool_kernel_device_us_per_tick": sum(
                v for k, v in by_name.items() if POOL_KERNEL in k),
            "arrival_kernels_device_us_per_tick": sum(
                v for k, v in by_name.items() if any(s in k for s in OUR_KERNELS)),
        })
        v1v2_launches[phase] = launches
        if phase == "front_droptail":
            continue
        v2 = phase == "v2_bench"
        args = first_call(calls, "local_pool_scan")
        r = check_pool_scan(f"{phase}, first real window", args[:6], v2)
        kernel_rows[("local_pool_scan", phase)] = pool_row(r, phase, 0)
        if v2:
            # the batching rule: 8 replicas of the window, their pools apart
            mips, valid, t, pool0, fire_t0, refund0 = (x[0] for x in args[:6])
            scale = torch.arange(1, POOL_REPLICAS + 1, device=dev, dtype=torch.float32)
            before = pk.LAUNCHES["local_pool_scan"]
            got = torch.func.vmap(
                lambda p: pk.local_pool_scan(mips, valid, t, p, fire_t0, refund0, True)
            )(pool0 * scale / POOL_REPLICAS)
            if pk.LAUNCHES["local_pool_scan"] - before != 1:
                raise SystemExit("local_pool_scan: 8 replicas took more than one launch")
            rows = pool_scan_inputs.replicas(args[:6], POOL_REPLICAS)
            if not same_bits(got, pk.local_pool_scan_plain(*rows, True)):
                raise SystemExit("local_pool_scan: the batching rule differs from "
                                 "its plain version on 8 replicas")
            rr = check_pool_scan(f"{phase}, {POOL_REPLICAS} replicas", rows, True)
            kernel_rows[("local_pool_scan", phase)]["replicas_8"] = pool_case(rr)
            rows = pool_scan_inputs.replicas(args[:6], POOL_REPLICAS_WIDE)
            rr = check_pool_scan(f"{phase}, {POOL_REPLICAS_WIDE} replicas", rows, True,
                                 plain_once=True)
            kernel_rows[("local_pool_scan", phase)]["replicas_128"] = pool_case(rr)
            # the kernel's other paths: dense windows (every group walked
            # row by row) and a timer that fires in the middle of the window
            for kind, path_v2, key in (("dense", False, ("v1_bench", "dense")),
                                       ("dense", True, ("v2_bench", "dense")),
                                       ("timer_fire", True, ("v2_bench", "timer_fire"))):
                rows = [torch.from_numpy(np.asarray(a)).to(dev) for a in
                        pool_scan_inputs.rows(kind, 1, POOL_SYNTH_K, seed=len(kind))]
                rr = check_pool_scan(f"{kind}, K = {POOL_SYNTH_K}", rows, path_v2)
                kernel_rows[("local_pool_scan", key[0])][key[1]] = pool_case(rr)
            # the arrival kernel on the first non-empty pool-arrival window
            fa = first_call(calls, "fused_arrival_plan")
            r = check_arrival_kernel("fused_arrival_plan", fa[:3], fa[3], (20, 10, 50, 10))
            emit_kernel(r, "v2_bench, first non-empty pool-arrival window")
            kernel_rows[("fused_arrival_plan", "v2_bench")] = kernel_row(
                r, "v2_bench", "real")
        del card, calls

    # ---- 25. the scenario worlds: wired v1 and the v2 demo --------------
    for phase, build, need in (
        ("wired_v1", lambda d: wired_v1.build(device=d, horizon=WIRED_V1_HORIZON),
         ("local_pool_scan", "fused_arrival_plan")),
        ("example", lambda d: example.build(device=d, horizon=EXAMPLE_HORIZON),
         ("local_pool_scan", "fused_arrival_plan", "cell_sum_ordered")),
    ):
        spec, st, net, b = build(dev)
        calls = []

        def keep(name, *args):  # every scan window, read after the run
            if name == "local_pool_scan":
                calls.append((name, args))

        torch.cuda.synchronize()
        reset_launches()
        cuda_build.TAPS.append(keep)
        try:
            t0 = time.perf_counter()
            card, _ = engine.run(spec, st, net, b)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            cuda_build.TAPS.remove(keep)
        launches = all_launches()
        need_launches(phase, launches, need)
        t0 = time.perf_counter()
        spec_c, st_c, net_c, b_c = build("cpu")
        n_leaves = assert_same(card, engine.run(spec_c, st_c, net_c, b_c)[0], phase)
        cpu_s = time.perf_counter() - t0
        args = first_call(calls, "local_pool_scan")
        r = check_pool_scan(f"{phase}, first real window", args[:6], bool(args[6]))
        kernel_rows[("local_pool_scan", "v2_bench" if args[6] else "v1_bench")][
            f"{phase}_window"] = pool_case(r)
        del calls
        m = card.metrics
        emit({"phase": phase, "ticks": spec.n_ticks, "leaves_equal": n_leaves,
              "n_published": int(m.n_published), "n_local": int(m.n_local),
              "n_scheduled": int(m.n_scheduled), "n_completed": int(m.n_completed),
              "n_rejected": int(m.n_rejected), "n_lost": int(m.n_lost),
              "wall_s": wall, "ms_per_tick": wall / spec.n_ticks * 1e3,
              "cpu_run_s": cpu_s, "launches": launches})
        v1v2_launches[phase] = launches
        del card

    # ---- 26. chaos: the bench world under faults --------------------------
    def chaos_build(row):
        kw = dict(bench_world(5e-3), **CHAOS_BENCH)
        over = dict(CHAOS_ROWS[row])
        if "policy" in over:
            over["policy"] = int(Policy[over["policy"]])
        return lambda device: smoke.build(device=device, **dict(kw, **over))

    def world_kernel(phase, calls, row_key):
        """``fused_arrival_plan`` against its plain version on the first
        window of the run that holds a row; its numbers go on ``row_key``'s
        row of the kernels line under ``phase``."""
        fa = first_call(calls, "fused_arrival_plan")
        r = check_arrival_kernel("fused_arrival_plan", fa[:3], fa[3], (20, 10, 50, 10))
        emit_kernel(r, f"{phase}, first non-empty window")
        kernel_rows[row_key][f"{phase}_window"] = real_window(r)

    fault_launches, fault_profiles = {}, {}
    for row in CHAOS_ROWS:
        phase = f"chaos {row}"
        build = chaos_build(row)
        spec, card, calls, launches, wall, cpu_s, n_leaves = world_run(
            phase, build, ("fused_arrival_plan",))
        ch, m = card.chaos, card.metrics
        counts = {k: int(getattr(ch, k)) for k in (
            "n_crashes", "n_recovers", "n_reoffloaded", "n_lost_crash",
            "n_retry_exhausted")}
        made = "n_reoffloaded" if spec.chaos_mode == 1 else "n_lost_crash"
        if min(counts["n_crashes"], counts["n_recovers"], counts[made]) <= 0:
            raise SystemExit(f"{phase}: the faults did not fire ({counts})")
        if spec.learn_active and float(card.learn.reward_cnt.sum()) <= 0:
            raise SystemExit(f"{phase}: no crashed pick was resolved")
        world_kernel(phase, calls, ("fused_arrival_plan", "bench"))
        spec_p, st_p, net_p, b_p = build(dev)
        prof_row, by_name = tick_profile(spec_p, st_p, net_p, b_p, None)
        emit({
            "phase": "chaos", "row": row, "policy": Policy(spec.policy).name,
            "mode": "reoffload" if spec.chaos_mode == 1 else "lose",
            "n_users": spec.n_users, "n_fogs": spec.n_fogs, "window": spec.window,
            "ticks": spec.n_ticks, "leaves_equal": n_leaves, **counts,
            "n_scheduled": int(m.n_scheduled), "n_published": int(m.n_published),
            "n_completed": int(m.n_completed), "wall_s": wall, "cpu_run_s": cpu_s,
            "task_offload_decisions_per_sec": int(m.n_scheduled) / wall,
            "ms_per_tick": wall / spec.n_ticks * 1e3, "launches": launches,
            **prof_row,
            "arrival_kernels_device_us_per_tick": sum(
                v for k, v in by_name.items() if any(s in k for s in OUR_KERNELS)),
        })
        fault_launches[phase] = launches["fused_arrival_plan"]
        fault_profiles[phase] = prof_row
        del card, calls

    # ---- 27. chaos_replicas: a chaos batch, each replica its own schedule -
    from fognetsimpp_tpu_torch.parallel.replicas import run_replicated

    def replicated(spec, batch, net, b, n_ticks=None, dyn_rows=None):
        return run_replicated(spec, batch, net, b, n_ticks=n_ticks, dyn_rows=dyn_rows), None

    spec, st, net, b = chaos_build("min_busy")(dev)
    batch = replicate_state(spec, st, CHAOS_R, seed=0)
    if len({tuple(k.tolist()) for k in batch.chaos.key}) != CHAOS_R:
        raise SystemExit("chaos_replicas: two replicas share a chaos key")
    row, first, launches = replica_phase(
        "chaos_replicas", spec, batch, net, b, singles={0: None, CHAOS_R - 1: None},
        runner=replicated)
    emit(row)
    flattened_kernel_rows("chaos_replicas", first, launches, row["flattened_fogs"])
    del batch, first

    # ---- 28. hier: the federated bench world, and its domain-down twin ---
    from fognetsimpp_tpu_torch.hier import stamp_ownership

    def hier_build(extra):
        kw = dict(bench_world(5e-3), **HIER_BENCH, **extra)
        if "policy" in kw:
            kw["policy"] = int(Policy[kw["policy"]])

        def build(device):
            spec, st, net, b = smoke.build(device=device, **kw)
            st = stamp_ownership(spec, st, user_broker=[0] * spec.n_users,
                                 fog_broker=HIER_FOG_OWNER)
            return spec, st, net, b

        return build

    for phase, extra in (("hier", HIER_UP), ("hier_domain_down", HIER_DOWN)):
        build = hier_build(extra)
        spec, card, calls, launches, wall, cpu_s, n_leaves = world_run(
            phase, build, ("fused_arrival_plan",))
        h, m = card.hier, card.metrics
        if int(h.n_migrated) <= 0:
            raise SystemExit(f"{phase}: no task migrated")
        world_kernel(phase, calls, ("fused_arrival_plan", "bench"))
        spec_p, st_p, net_p, b_p = build(dev)
        prof_row, by_name = tick_profile(
            spec_p, st_p, net_p, b_p,
            static_cache(spec_p, st_p, net_p) if spec.assume_static else None)
        emit({
            "phase": phase, "policy": Policy(spec.policy).name,
            "n_users": spec.n_users, "n_fogs": spec.n_fogs,
            "n_brokers": spec.n_brokers, "ticks": spec.n_ticks,
            "leaves_equal": n_leaves, "n_migrated": int(h.n_migrated),
            "n_hop_exhausted": int(h.n_hop_exhausted),
            "mig_out": h.mig_out.tolist(), "mig_in": h.mig_in.tolist(),
            "n_crashes": int(card.chaos.n_crashes),
            "n_reoffloaded": int(card.chaos.n_reoffloaded),
            "n_scheduled": int(m.n_scheduled), "n_completed": int(m.n_completed),
            "wall_s": wall, "cpu_run_s": cpu_s,
            "task_offload_decisions_per_sec": int(m.n_scheduled) / wall,
            "ms_per_tick": wall / spec.n_ticks * 1e3, "launches": launches,
            **prof_row,
            "arrival_kernels_device_us_per_tick": sum(
                v for k, v in by_name.items() if any(s in k for s in OUR_KERNELS)),
        })
        fault_launches[phase] = launches["fused_arrival_plan"]
        fault_profiles[phase] = prof_row
        del card, calls

    # ---- 29. tp_aps: access points under the task-sharded tick -----------
    from fognetsimpp_tpu_torch.parallel import shards as tshards

    aps_kw = dict(TP_APS, policy=int(Policy[TP_APS["policy"]]))
    spec, st, net, b = wireless.wireless5(device=dev, **aps_kw)
    ref, _ = engine.run(spec, st, net, b)
    run_tp_sharded(spec, st, net, b, n_shards=TP_SHARDS, n_ticks=REPLICA_WARM_TICKS)
    torch.cuda.synchronize()
    plans, blocks, ring = [], [], tshards.ring_all_gather

    def keep_plan(name, *args):
        if name == "fused_arrival_plan":
            if not args[0].is_cuda:
                raise SystemExit(f"tp_aps: {name} took the CPU path")
            plans.append((name, args))

    def keep_ring(bl):
        if not blocks:
            blocks.append([x.clone() for x in bl])
        return ring(bl)

    reset_launches()
    cuda_build.TAPS.append(keep_plan)
    tshards.ring_all_gather = keep_ring
    try:
        t0 = time.perf_counter()
        _, got = run_tp_sharded(spec, st, net, b, n_shards=TP_SHARDS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tshards.ring_all_gather = ring
        cuda_build.TAPS.remove(keep_plan)
    launches = all_launches()
    need_launches("tp_aps", launches, ("ring_all_gather", "fused_arrival_plan"))
    n_leaves = assert_same(got, ref, "tp_aps (TP against engine.run)")
    a0, a1 = spec.ap_slice
    n_assoc = int(got.nodes.assoc_sum[a0:a1].sum())
    if n_assoc <= 0:
        raise SystemExit("tp_aps: no association was counted on the APs")
    want = rk.ring_all_gather_plain(blocks[0])
    got_ring = rk.ring_all_gather(blocks[0])
    if not all(torch.equal(g, w) for g, w in zip(got_ring, want)):
        raise SystemExit("tp_aps: ring_all_gather differs from its plain version")
    n, (K, C) = len(blocks[0]), blocks[0][0].shape
    ring_bytes = (n * n + n) * K * C * 4
    # CUDA events behind a sleep kernel: the profiler's trace of a lone
    # small launch can hold no event of it
    kernel_rows[("ring_all_gather", "tp")]["tp_aps_window"] = {
        "n": n, "K": K, "C": C, "timed_by": "CUDA events behind a sleep kernel",
        "ms": stream_ms(lambda: rk.ring_all_gather(blocks[0]), 50),
        "plain_ms": stream_ms(lambda: rk.ring_all_gather_plain(blocks[0]), 50),
        "bound_ms": ring_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "max_abs_err": max_abs_err(got_ring, want),
    }
    fa = first_call(plans, "fused_arrival_plan")
    r = check_arrival_kernel("fused_arrival_plan", fa[:3], fa[3], (20, 10, 50, 10))
    emit_kernel(r, "tp_aps, first non-empty window")
    kernel_rows[("fused_arrival_plan", "tp_aps")] = kernel_row(r, "tp_aps", "real")
    emit({
        "phase": "tp_aps", "n_users": spec.n_users, "n_aps": spec.n_aps,
        "n_fogs": spec.n_fogs, "n_shards": TP_SHARDS, "ticks": spec.n_ticks,
        "leaves_equal": n_leaves, "assoc_sum_aps": n_assoc,
        "n_scheduled": int(got.metrics.n_scheduled), "wall_s": wall,
        "task_offload_decisions_per_sec": int(got.metrics.n_scheduled) / wall,
        "ms_per_tick": wall / spec.n_ticks * 1e3, "launches": launches,
        "launches_per_tick": {k: v / spec.n_ticks for k, v in launches.items()},
        "ring_window": {"n": n, "K": K, "C": C},
    })
    tp_aps_launches = launches
    del ref, got, blocks, plans

    # ---- 30. telemetry: every plane on the bench, chaos and hier worlds --
    from fognetsimpp_tpu_torch.hier import hier_summary
    from fognetsimpp_tpu_torch.telemetry.health import hist_summary
    from fognetsimpp_tpu_torch.telemetry.journeys import journey_summary
    from fognetsimpp_tpu_torch.telemetry.metrics import (
        exchange_summary, telemetry_summary,
    )

    def finite(x):
        return None if isinstance(x, float) and x != x else x

    def tel_summaries(spec, st):
        """The host readers' roll-ups of a telemetry-on final state, cut to
        what a line can hold."""
        t, h = telemetry_summary(spec, st), hist_summary(spec, st)
        out = {
            "telemetry_summary": {
                "ticks": t["ticks"], "defer_sum": t["defer_sum"],
                "busy_frac_mean": float(t["busy_frac"].mean()),
                "q_len_max": int(t["q_len_max"].max()),
                "phase_work": t["phase_work"],
                "reservoir_rows": len(t["reservoir"]["t"]),
            },
            "hist_summary": None if h is None else {
                "count": h["count"], "sum_ms": h["sum_ms"],
                "quantiles_ms": {k: finite(v) for k, v in h["quantiles_ms"].items()},
            },
        }
        j = journey_summary(spec, st)
        if j is not None:
            out["journey_summary"] = {k: j[k] for k in (
                "sampled", "ring", "events_total", "dropped_total", "terminal",
                "in_flight", "unspawned")}
        hs = hier_summary(spec, st)
        if hs is not None:
            out["hier_summary"] = {
                k: v for k, v in hs.items() if k not in ("load_rows", "load_rows_t")}
        return out

    def tel_bench(device, **extra):
        return smoke.build(device=device, **dict(bench_world(5e-3), **TEL_FOGS, **extra))

    def lat_due(args, prefixed):
        """Due rows of a latency sum's input: its entries in a cell, less
        the running sums a single-device tick puts first (one a cell)."""
        cell, _, A = args
        return int(((cell >= 0) & (cell < A)).sum()) - (A if prefixed else 0)

    def lat_sum_check(case, args, n_due, reps):
        """``cell_sum_ordered`` against its plain version on a latency
        sum's input; the bound reads every cell, the values in a cell,
        and writes the sums."""
        cell, vals, A = args
        n_bytes = cell.shape[0] * 4 + int(((cell >= 0) & (cell < A)).sum()) * 4 + A * 4
        r = check_cell_kernel(case, cell, vals, A, reps, by_events=True, n_bytes=n_bytes)
        emit({"phase": "kernel", **{k: v for k, v in r.items() if not k.endswith("_ms")},
              "due_rows": n_due, "device_us": r["ms"] * 1e3,
              "plain_wall_us": r["plain_ms"] * 1e3,
              "index_add_device_us": r["library_ms"] * 1e3,
              "wrapper_us": r["wrapper_ms"] * 1e3, "bound_us": r["bound_ms"] * 1e3,
              "chain_us": r["chain_ms"] * 1e3})
        return r, n_bytes

    def lat_sum_input(r, n_due):
        """A latency-sum input's sub-entry of the kernels line's row."""
        return {"N": r["N"], "A": r["A"], "due_rows": n_due,
                "largest_cell": r["largest_cell"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                "bound_ms": r["bound_ms"], "max_abs_err": r["max_abs_err"],
                "timed_by": r["timed_by"]}

    def counted_acks(phase, n):
        if n <= 0:
            raise SystemExit(f"{phase}: the latency histogram counted no ack")
        return n

    def cost(spec, build):
        """ms a tick and device events a tick of ``build``'s world."""
        spec_p, st_p, net_p, b_p = build(dev)
        cache = static_cache(spec_p, st_p, net_p) if spec.assume_static else None
        prof, _ = tick_profile(spec_p, st_p, net_p, b_p, cache)
        return {k: prof[k] for k in (
            "wall_ms_per_tick_unprofiled", "wall_ms_per_tick", "device_events_per_tick",
            "device_ms_per_tick", "device_busy_share")}

    tel_launches = {}
    lat_sum_calls = []
    tel_worlds = {
        "bench": lambda d: tel_bench(d, **TELEMETRY, **TEL_JOURNEYS),
        "chaos": lambda d: smoke.build(device=d, **{
            **bench_world(5e-3), **CHAOS_BENCH, **TEL_FOGS, **TELEMETRY}),
        "hier": hier_build(dict(HIER_UP, **TELEMETRY)),
    }
    for world, build in tel_worlds.items():
        phase = f"telemetry {world}"
        spec, card, calls, launches, wall, cpu_s, n_leaves = world_run(
            phase, build, ("fused_arrival_plan", "cell_sum_ordered"))
        if launches["cell_sum_ordered"] != spec.n_ticks:
            raise SystemExit(f"{phase}: cell_sum_ordered launched "
                             f"{launches['cell_sum_ordered']} times in {spec.n_ticks} ticks")
        summ = tel_summaries(spec, card)
        n_acks = counted_acks(phase, int(card.telem.lat_hist.sum()))
        # the latency sums with due rows
        lat_sum_calls += [a for n, a in calls if n == "cell_sum_ordered"
                          and lat_due(a, True) > 0]
        if world == "bench":
            fa = first_call(calls, "fused_arrival_plan")
            r = check_arrival_kernel("fused_arrival_plan", fa[:3], fa[3], (20, 10, 50, 10),
                                     by_events=True)
            emit_kernel(r, f"{phase}, first non-empty window")
            kernel_rows[("fused_arrival_plan", "bench")][f"{phase}_window"] = real_window(r)
            on = cost(spec, build)
            off = cost(spec, lambda d: tel_bench(d, derive_acks=False))
            # phase 7's world, telemetry off: the tick launches what it did.
            # Two traces of one world's tick differ by up to one event a
            # tick (1,688.0, 1,688.25, 1,689.0 seen); a telemetry phase
            # traced on the off tick would add hundreds
            off_bench = cost(spec, lambda d: smoke.build(device=d, **bench_world(5e-3)))
            if off_bench["device_events_per_tick"] > bench_events + TRACE_NOISE_EVENTS:
                raise SystemExit(
                    f"{phase}: the telemetry-off bench tick made "
                    f"{off_bench['device_events_per_tick']} device events, phase 7 "
                    f"{bench_events}")
            costs = {"on": on, "off_same_world": off, "off_phase7_world": {
                **off_bench, "phase7_events": bench_events,
                "equals_phase7": off_bench["device_events_per_tick"] == bench_events,
                "equals_pre_telemetry": (off_bench["device_events_per_tick"]
                                         == PRE_TELEMETRY_BENCH_EVENTS)}}
        elif world == "chaos":
            costs = {"on": cost(spec, build), "off_same_world": cost(
                spec, lambda d: smoke.build(device=d, **{
                    **bench_world(5e-3), **CHAOS_BENCH, **TEL_FOGS}))}
        else:
            costs = {"on": cost(spec, build), "off_phase": fault_profiles["hier"]}
        emit({
            "phase": "telemetry", "world": world, "policy": Policy(spec.policy).name,
            "n_users": spec.n_users, "n_fogs": spec.n_fogs, "ticks": spec.n_ticks,
            "task_rows": spec.task_capacity, "leaves_equal": n_leaves,
            "wall_s": wall, "ms_per_tick": wall / spec.n_ticks * 1e3, "cpu_run_s": cpu_s,
            "lat_hist_count": n_acks, "launches": launches, "cost": costs, **summ,
        })
        tel_launches[phase] = launches
        del card, calls

    # lat_sum's ordered sum on the first tick with due rows
    if not lat_sum_calls:
        raise SystemExit("telemetry: no latency streamed into a histogram")
    n_due = lat_due(lat_sum_calls[0], True)
    r, n_bytes = lat_sum_check("lat_sum, first tick with due rows", lat_sum_calls[0],
                               n_due, (50, 2))
    kernel_rows[("cell_sum_ordered", "lat_sum")] = {
        "name": "cell_sum_ordered", "route": "cuda", "source": SOURCES["cell_sum_ordered"],
        "replaces": REPLACES["cell_sum_ordered"],
        "replaces_note": "no TPU kernel: the index order of XLA's float32 "
                         "scatter-add of the latency histogram's per-fog sums",
        "launches": 0, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": "bytes",
        "library_ms": r["library_ms"],
        "library": "Tensor.index_add_ (atomic adds, another order)",
        "shape": {"N": r["N"], "A": r["A"], "due_rows": n_due,
                  "largest_cell": r["largest_cell"]},
        "shape_of": "telemetry, first due rows", "bound_bytes": n_bytes,
        "wrapper_ms": r["wrapper_ms"], "chain_ms": r["chain_ms"],
        "launches_a_call": r["launches_a_call"], "timed_by": r["timed_by"],
    }
    del lat_sum_calls

    # ---- 31. telemetry_replicas: 16 bench worlds with plane 1 and the
    # histogram, one launch of each kernel a tick for the batch
    spec, st, net, b = tel_bench(dev, **TELEMETRY)
    batch = replicate_state(spec, st, TEL_R, seed=0)
    batch_sums = []

    def batch_sum(name, *args):
        # the batch's first latency sums (the replicas end to end), read
        # after the phase: a read here would sync the timed run
        if (name == "cell_sum_ordered" and args[2] == TEL_R * spec.n_fogs
                and len(batch_sums) < REPLICA_WARM_TICKS + spec.n_ticks):
            batch_sums.append(args)

    cuda_build.TAPS.append(batch_sum)
    try:
        row, first, launches = replica_phase(
            "telemetry_replicas", spec, batch, net, b,
            singles={0: None, TEL_R - 1: None}, runner=replicated)
    finally:
        cuda_build.TAPS.remove(batch_sum)
    counted_acks("telemetry_replicas", row["lat_hist_count"])
    batch_sums = [a for a in batch_sums if lat_due(a, True) > 0]
    if not batch_sums:
        raise SystemExit("telemetry_replicas: no latency sum of the batch had due rows")
    n_due = lat_due(batch_sums[0], True)
    r, _ = lat_sum_check("lat_sum, the batch's first input with due rows",
                         batch_sums[0], n_due, (20, 1))
    kernel_rows[("cell_sum_ordered", "lat_sum")]["telemetry_replicas_input"] = \
        lat_sum_input(r, n_due)
    del batch_sums
    spec_o, st_o, net_o, b_o = tel_bench(dev, derive_acks=False)
    batch_o = replicate_state(spec_o, st_o, TEL_R, seed=0)
    with strict_vmap():
        tick_o, _ = engine.batched_tick(spec_o, net_o, b_o, batch_o)
        off_row, _ = tick_profile(spec_o, batch_o, net_o, b_o, None, tick=tick_o)
    row["cost_off_same_batch"] = {k: off_row[k] for k in (
        "wall_ms_per_tick_unprofiled", "wall_ms_per_tick", "device_events_per_tick",
        "device_ms_per_tick", "device_busy_share")}
    emit(row)
    tel_launches["telemetry_replicas"] = launches
    del batch, batch_o, first

    # ---- 32. tp_telemetry: the bench world under four shards with every
    # plane on, the ring exchange (no window) and the windowed merge
    def tp_events(spec, st, net, b, n):
        """Device events a tick of an ``n``-tick sharded run."""
        run_tp_sharded(spec, st, net, b, n_shards=TP_SHARDS, n_ticks=n)
        torch.cuda.synchronize()
        for attempt in range(6):
            if attempt:
                time.sleep(1.0)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run_tp_sharded(spec, st, net, b, n_shards=TP_SHARDS, n_ticks=n)
                torch.cuda.synchronize()
            dev_us, n_events, _ = device_events(prof)
            if n_events:
                break
        return n_events / n, dev_us / n / 1e3

    for variant, window in (("ring", {"arrival_window": None}), ("window", {})):
        phase = f"tp_telemetry {variant}"
        kw = dict(bench_world(5e-3), **window, **TEL_FOGS, **TELEMETRY, **TEL_JOURNEYS)
        spec, st, net, b = smoke.build(device=dev, **kw)
        run_tp_sharded(spec, st, net, b, n_shards=TP_SHARDS, n_ticks=REPLICA_WARM_TICKS)
        torch.cuda.synchronize()
        plans, blocks, ring = [], [], tshards.ring_all_gather

        def tel_plan(name, *args, phase=phase, plans=plans):
            if not args[0].is_cuda:
                raise SystemExit(f"{phase}: {name} took the CPU path")
            if name in ("fused_arrival_plan", "cell_sum_ordered"):
                plans.append((name, args))

        def tel_ring(bl, blocks=blocks, ring=ring):
            if not blocks:
                blocks.append([x.clone() for x in bl])
            return ring(bl)

        reset_launches()
        cuda_build.TAPS.append(tel_plan)
        tshards.ring_all_gather = tel_ring
        try:
            t0 = time.perf_counter()
            spec2, got = run_tp_sharded(spec, st, net, b, n_shards=TP_SHARDS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            tshards.ring_all_gather = ring
            cuda_build.TAPS.remove(tel_plan)
        launches = all_launches()
        need_launches(phase, launches, ("fused_arrival_plan", "cell_sum_ordered") + (
            ("ring_all_gather",) if variant == "ring" else ()))
        t0 = time.perf_counter()
        spec_c, st_c, net_c, b_c = smoke.build(device="cpu", **kw)
        _, cpu = run_tp_sharded(spec_c, st_c, net_c, b_c, n_shards=TP_SHARDS)
        cpu_s = time.perf_counter() - t0
        n_leaves = assert_same(got, cpu, f"{phase} (card against CPU)")
        n_acks = counted_acks(phase, int(got.telem.lat_hist.sum()))
        ex = exchange_summary(spec2, got)
        fa = first_call(plans, "fused_arrival_plan")
        # CUDA events: the profiler's trace of these calls came back empty
        r = check_arrival_kernel("fused_arrival_plan", fa[:3], fa[3], (10, 2, 10, 1),
                                 by_events=True)
        emit_kernel(r, f"{phase}, first non-empty window")
        kernel_rows[("fused_arrival_plan", "tp")][f"tp_telemetry_{variant}_window"] = \
            real_window(r)
        ls = next((a for n, a in plans if n == "cell_sum_ordered" and lat_due(a, False) > 0),
                  None)
        if ls is None:
            raise SystemExit(f"{phase}: no shard's latency sum had due rows")
        if variant == "ring":  # a shard's shape, the same in both variants
            n_due = lat_due(ls, False)
            r, _ = lat_sum_check(f"lat_sum, {phase}, a shard's first input with due rows",
                                 ls, n_due, (20, 1))
            kernel_rows[("cell_sum_ordered", "lat_sum")]["tp_telemetry_shard_input"] = \
                lat_sum_input(r, n_due)
        if variant == "ring":
            want = rk.ring_all_gather_plain(blocks[0])
            got_ring = rk.ring_all_gather(blocks[0])
            if not all(torch.equal(g, w) for g, w in zip(got_ring, want)):
                raise SystemExit(f"{phase}: ring_all_gather differs from its plain version")
            n, (K, C) = len(blocks[0]), blocks[0][0].shape
            ring_bytes = (n * n + n) * K * C * 4
            kernel_rows[("ring_all_gather", "tp")]["tp_telemetry_window"] = {
                "n": n, "K": K, "C": C, "timed_by": "CUDA events behind a sleep kernel",
                "ms": stream_ms(lambda: rk.ring_all_gather(blocks[0]), 50),
                "plain_ms": stream_ms(lambda: rk.ring_all_gather_plain(blocks[0]), 50),
                "bound_ms": ring_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "max_abs_err": max_abs_err(got_ring, want),
            }
        ev_on, dms_on = tp_events(spec, st, net, b, 4)
        kw_off = dict(bench_world(5e-3), **window, **TEL_FOGS, derive_acks=False)
        spec_o, st_o, net_o, b_o = smoke.build(device=dev, **kw_off)
        ev_off, dms_off = tp_events(spec_o, st_o, net_o, b_o, 4)  # warms up too
        t0 = time.perf_counter()
        run_tp_sharded(spec_o, st_o, net_o, b_o, n_shards=TP_SHARDS)
        torch.cuda.synchronize()
        wall_off = time.perf_counter() - t0
        emit({
            "phase": "tp_telemetry", "variant": variant, "n_users": spec.n_users,
            "n_fogs": spec.n_fogs, "n_shards": TP_SHARDS, "window": spec.window,
            "ticks": spec.n_ticks, "leaves_equal": n_leaves, "wall_s": wall,
            "ms_per_tick": wall / spec.n_ticks * 1e3, "cpu_run_s": cpu_s,
            "lat_hist_count": n_acks, "launches": launches,
            "launches_per_tick": {k: v / spec.n_ticks for k, v in launches.items()},
            "cost": {"on": {"ms_per_tick": wall / spec.n_ticks * 1e3,
                            "device_events_per_tick": ev_on, "device_ms_per_tick": dms_on},
                     "off_same_world": {"ms_per_tick": wall_off / spec.n_ticks * 1e3,
                                        "device_events_per_tick": ev_off,
                                        "device_ms_per_tick": dms_off}},
            "exchange_summary": {k: (v.tolist() if hasattr(v, "tolist") else v)
                                 for k, v in ex.items() if k not in ("occ_rows", "occ_rows_t")},
            **tel_summaries(spec2, got),
        })
        tel_launches[phase] = launches
        del got, cpu, blocks, plans

    # 33. cli: the python -m entry point on the card, and main() counted
    cli_launches = cli_phase(reset_launches, all_launches, need_launches, smi)

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
    # the promoted paths at the shapes of earlier rows: the bench world's
    # window (chunked, tp_chunked), config 4's single world (reconfigure)
    # and its 128 replicas end to end (dyn4)
    by_path[("fused_arrival_plan", "bench")].update(
        chunked=chunked_launches["fused_arrival_plan"],
        tp_chunked=tp_chunked_launches["fused_arrival_plan"])
    for name in ("fused_arrival_plan", "cell_sum_ordered"):
        by_path[(name, "wireless")]["reconfigure"] = reconf_launches[name]
        by_path[(name, "config4")] = dict(
            kernel_rows[(name, "config4")]["launches_by_path"], dyn4=dyn4_launches[name])
    # the v1/v2 paths: the scan's v1 and v2 rows, the v2 bench's windows
    by_path[("local_pool_scan", "v1_bench")] = {
        k: v1v2_launches[k]["local_pool_scan"] for k in ("v1_bench", "wired_v1")}
    by_path[("local_pool_scan", "v2_bench")] = {
        k: v1v2_launches[k]["local_pool_scan"] for k in ("v2_bench", "example")}
    by_path[("fused_arrival_plan", "v2_bench")] = {
        k: v1v2_launches[k]["fused_arrival_plan"]
        for k in ("v1_bench", "v2_bench", "front_droptail", "wired_v1", "example")}
    # the fault planes at the bench world's shape, and tp_aps
    by_path[("fused_arrival_plan", "bench")].update(fault_launches)
    by_path[("fused_arrival_plan", "tp_aps")] = {
        "tp_aps": tp_aps_launches["fused_arrival_plan"]}
    by_path[("ring_all_gather", "tp")]["tp_aps"] = tp_aps_launches["ring_all_gather"]
    # the telemetry paths (30-32)
    # (the 16 replicas' end-to-end windows are chaos_replicas' shape)
    rep_key = ("fused_arrival_plan", "chaos_replicas")
    by_path[rep_key] = dict(kernel_rows[rep_key]["launches_by_path"], telemetry_replicas=tel_launches[
        "telemetry_replicas"]["fused_arrival_plan"])
    for phase, launches in tel_launches.items():
        if phase == "telemetry_replicas":
            continue
        key = "tp" if phase.startswith("tp_") else "bench"
        by_path[("fused_arrival_plan", key)][phase] = launches["fused_arrival_plan"]
        if launches["ring_all_gather"]:
            by_path[("ring_all_gather", "tp")][phase] = launches["ring_all_gather"]
    by_path[("cell_sum_ordered", "lat_sum")] = {
        k: v["cell_sum_ordered"] for k, v in tel_launches.items()}
    # the CLI's calls (33): config 4's single world at the wireless rows'
    # shape, the TP smoke world's ring, the v2 demo's scan
    for name in ("fused_arrival_plan", "cell_sum_ordered"):
        by_path[(name, "wireless")]["cli"] = cli_launches["config4"][name]
    by_path[("ring_all_gather", "tp")]["cli_tp"] = cli_launches["tp"]["ring_all_gather"]
    by_path[("local_pool_scan", "v2_bench")]["cli_demo_v2"] = \
        cli_launches["demo_v2"]["local_pool_scan"]
    by_path[("fused_arrival_plan", "v2_bench")]["cli_demo_v2"] = \
        cli_launches["demo_v2"]["fused_arrival_plan"]
    by_path[("fused_arrival_plan", "tp")]["cli_tp"] = cli_launches["tp"]["fused_arrival_plan"]
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
