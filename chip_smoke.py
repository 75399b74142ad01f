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
   to 20 of its 50 ticks of 5 ms, 9,437,184 task rows) under ``run_tp_sharded`` at four
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
   into the drain; the card takes the CPU's state at tick 1,035, restored
   as a checkpoint is, and runs the last 25 ticks), card against CPU
   every leaf, and ``local_pool_scan`` against its plain version on each
   run's first window that holds a row.
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
34. serve: the telemetry bench world of phase 30 (10,000 users x 32 fogs,
   K = 4,096, 20 ticks of 5 ms, plane 1, the histogram, 64 journeys) with
   the ingest gate, served by ``twin.ingest.serve_ingest_run`` in chunks
   of 5 behind ``HealthServer`` on ``127.0.0.1:0``: 256 arrivals fed in
   process and 64 through ``POST /ingest``, ``GET /metrics`` and ``GET
   /healthz`` after every chunk, one ``POST /whatif`` (4 send stop times,
   5 ticks ahead) from a client thread while the loop runs on, an SLO
   that every ack breaches (the flight recorder dumps), and the
   ``--trace-out`` export; card against a CPU run of the same session
   (forking at the card's fork point): every leaf, the last exposition,
   /healthz, the trace, the arrival log, the recorder's ring, each bundle
   less its wall fields and the what-if report; ms a chunk, the
   exposition's render ms, the ask's wall s; ``fused_arrival_plan`` and
   ``cell_sum_ordered`` launched in the serve run and
   ``fused_arrival_plan`` in the fork (its calls counted on the server's
   thread);
35. serve_tp: ``telemetry.live.serve_tp_run`` at four shards on the
   CLI's ``--tp 4`` smoke world (1,024 users x 32 fogs of 80,000 MIPS, 10
   ticks in chunks of 5, the ring): card against CPU every leaf, the last
   exposition and the ring's per-shard hashes; ``ring_all_gather``
   launched;
36. tenants: ``twin.front.FrontDoor`` with two smoke tenants (seeds 0 and
   1, plane 1 and the histogram) on ``127.0.0.1:0``, 2 rounds of 25 ticks:
   card against CPU tenant by tenant (every leaf, its page, its ring) and
   the aggregate page.
37. fleet: ``benchmarks.py::config3``'s 64 replicas (1,000 users x 24
   fogs) cut to 20 ticks through ``parallel.fleet.run_fleet`` on a
   one-slot and a four-slot mesh (one batch either way, 1,536 fogs end to
   end: ``pairwise_rank``), the two equal on every leaf and to the CPU's
   fleet, and one slot's 16 replicas alone (384 fogs:
   ``fused_arrival_plan``) equal to those rows of the whole batch, each
   timed after a warm-up; ``run_fleet_series`` in chunks of 7 on the four
   slots (final state and series against the CPU's); ``fleet_decisions``
   on 2 keys (against the CPU's pair); ``fused_arrival_plan`` against its
   plain version on the slot's rows' first non-empty window; then
   ``python -m fognetsimpp_tpu_torch
   --replicas 8 --mesh 4 --ticks`` as a subprocess, through ``main()``
   counted, and on the CPU, its files equal;
38. node_sharded: ``parallel.taskshard.run_node_sharded`` over 4 slots
   on the bench world without an arrival window (the task-sharded tick:
   ``ring_all_gather``) and on config 4's one-replica world (the engine:
   ``cell_sum_ordered``), 20 ticks each, card against CPU every leaf;
   ``sharded_min_busy`` at K = 4,096 tasks over 1,024 fogs on 4 slots
   against ``ops/sched.schedule_batch`` and the CPU, timed, and the ring
   against its plain version and ``torch.cat`` on its gathered blocks;
39. multihost: a one-rank NCCL process group on the card
   (``parallel.multihost.initialize``), ``run_sharded`` and
   ``fleet_decisions`` over ``global_mesh`` (2 slots, 4 replicas of a
   256-user smoke world) against the CPU, the group destroyed after.
40. checkify: the runtime sanitizer and the carry contracts on the bench
   world of phase 5 (dt 5 ms, its 20 ticks): ``run_checkified(errors=
   "div")`` equal on every leaf to the card's plain ``engine.run``, with
   one host synchronisation in the whole run (torch's sync debug mode
   counts them, checked on one ``.item()`` first), and ms a tick beside
   the plain tick's; ``errors="nan"`` raises ``CheckifyError``;
   ``check_step_contract`` and ``check_fleet_contract`` (4 replicas) on
   the card's state, shapes only, together in under ``CONTRACT_MAX_S``
   seconds, and a planted int8 + int32 promotion raising
   ``ContractError``; then ``python -m fognetsimpp_tpu_torch --checkify``
   as two subprocesses on the tests' smoke world (seed 7, cut to 0.1 s):
   exit 0 under ``div`` and 1 under ``nan``;
41. card_tests: ``python -m pytest --noconftest -p no:cacheprovider -q
   tests/test_torch_cuda.py``: its tests collected once and dealt to
   ``CARD_TEST_PROCS`` subprocesses of the same command (every test
   once), ``CARD_TESTS_TIMEOUT`` seconds at most; the junit counts and
   seconds; a failure, an error, a skip, a test not run, a nonzero exit
   or the timeout fails the run.
   Every phase from 18 on resets the wrapper counts before its path and
   fails if a kernel of the path was launched no time;

then the ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` prints them, and ``{"ok": true, "device": {...}}`` last.
Without a CUDA device it prints no result and exits 2.

The CPU run of every world that is fixed before the run (``cpu_jobs``)
is queued at the start on ``CPU_WORKERS`` spawned worker processes, which
run them while the card runs the phases; a phase waits for its world's
leaves (``cpu_run_s`` is the worker's seconds).  The CPU runs that depend
on the card's run (the serve session's fork point) and the small ones stay
in the script's process.  ``torch.profiler`` traces the card's activity
only: no phase reads a CPU operator's event.
"""
from __future__ import annotations

import dataclasses
import functools
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
#: 0.1 s (20 ticks) for the script's time.
TP_WORLD = dict(
    n_users=1_048_576, n_fogs=64, fog_mips=(1000.0, 2000.0, 3000.0, 4000.0),
    send_interval=0.05, horizon=0.1, dt=5e-3,
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
#: A plain version whose compared call took longer (ms) is timed by that
#: call alone: its launches' issue is a small share of it.
SLOW_PLAIN_MS = 250.0
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
#: Horizons of the scenario worlds held card against CPU, and the tick at
#: which the card takes the CPU's state: the example's user publishes into
#: a pending queue until its link comes up at tick 1,041, and the CLI
#: phase runs that world's first 50 ticks on the card.
WIRED_V1_HORIZON, EXAMPLE_HORIZON = 0.15, 1.06
SCENARIO_FROM_TICK = {"wired_v1": 0, "example": 1035}
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


#: ``serve`` (34): the telemetry bench world (``TEL_FOGS``, plane 1, the
#: histogram, 64 journeys) with the ingest gate and a send stop time past
#: the horizon (a promoted knob the what-if can retune), 20 ticks of 5 ms
#: served in chunks of 5 by ``serve_ingest_run``.
SERVE_WORLD = dict(**TEL_FOGS, **TELEMETRY, **TEL_JOURNEYS, ingest=True, send_stop_time=1.0)
SERVE_CHUNK = 5
#: Arrivals fed in process before the first chunk, and through
#: ``POST /ingest`` after it; 64 drain at each interior boundary.
SERVE_FEED = 256
SERVE_POSTS = 64
#: The what-if asked over HTTP after chunk 2: 4 stop times, 5 ticks ahead.
SERVE_ASK = {"knobs": {"send_stop_time": [0.03, 0.045, 0.06, 1.0]}, "ticks": 5}
#: An SLO every acked task breaches: the flight recorder dumps a bundle.
SERVE_SLO_MS = 1e-3
#: ``--trace-out``'s cap on traced tasks for the serve run.
SERVE_TRACE_TASKS = 20_000
#: ``serve_tp`` (35): the CLI's ``--tp 4`` smoke world, 10 ticks in chunks
#: of 5, the ring (no window).
SERVE_TP_WORLD = dict(n_users=1024, n_fogs=32, fog_mips=TEL_FOGS["fog_mips"],
                      send_interval=0.01, horizon=0.01, telemetry=True,
                      telemetry_hist=True, derive_acks=False)
SERVE_TP_CHUNK = 5
#: ``tenants`` (36): two smoke tenants (seeds 0 and 1; 256 users x 8 fogs
#: of 80,000 MIPS, plane 1 and the histogram, the ingest gate) behind one
#: front door, 2 rounds of 25 ticks of 1 ms.
TENANT_WORLD = dict(n_users=256, n_fogs=8, fog_mips=TEL_FOGS["fog_mips"],
                    send_interval=0.01, horizon=0.05, telemetry=True,
                    telemetry_hist=True, derive_acks=False, ingest=True)
TENANT_CHUNK = 25
TENANT_ROUNDS = 2


def _http(url, body=None, timeout=300):
    """``(status, body text)`` of one request to the phases' own server on
    ``127.0.0.1``."""
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST" if body is not None else "GET")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


def _masked_ingest(obj):
    """A JSON value with every ingest stats dict's ``latency_s`` (a wall
    clock reading) dropped, and the manifests' ``recorded_at`` and trace
    path."""
    if isinstance(obj, dict):
        return {k: _masked_ingest(v) for k, v in obj.items()
                if k not in ("latency_s", "recorded_at", "trace", "wall_s")}
    if isinstance(obj, list):
        return [_masked_ingest(v) for v in obj]
    return obj


def _mask_latency_line(text):
    import re

    return re.sub(r"^(fns_twin_ingest_latency_seconds) .*$", r"\1 -", text, flags=re.M)


def serve_session(device, outdir, ask_at=None):
    """The ``serve`` phase's session on ``device``: the bench world served
    by ``serve_ingest_run`` behind ``HealthServer`` on ``127.0.0.1:0``,
    ``SERVE_FEED`` arrivals fed in process and ``SERVE_POSTS`` through
    ``POST /ingest`` after chunk 1, ``GET /metrics`` and ``GET /healthz``
    after every chunk, one ``POST /whatif``: from a client thread started
    after chunk 2 while the loop goes on (``ask_at`` None), or, to repeat
    a session, synchronously once the door holds the carry of tick
    ``ask_at``.  Returns the final state and what the checks read."""
    import os
    import threading

    import numpy as np

    from fognetsimpp_tpu_torch.scenarios import smoke
    from fognetsimpp_tpu_torch.telemetry.health import hist_summary
    from fognetsimpp_tpu_torch.telemetry.live import HealthServer
    from fognetsimpp_tpu_torch.telemetry.openmetrics import render_openmetrics
    from fognetsimpp_tpu_torch.telemetry.timeline import export_trace
    from fognetsimpp_tpu_torch.twin.ingest import IngestQueue, serve_ingest_run

    spec, st, net, b = smoke.build(device=device, **dict(bench_world(5e-3), **SERVE_WORLD))
    rng = np.random.default_rng(0)
    n = SERVE_FEED + SERVE_POSTS
    users = rng.integers(0, spec.n_users, n).tolist()
    mips = (np.round(rng.uniform(100.0, 1000.0, n) * 2) / 2).tolist()
    rows = list(zip(users, mips))
    q = IngestQueue(capacity=1024)
    q.feed_rows(rows[:SERVE_FEED])
    server = HealthServer(port=0)
    url = f"http://127.0.0.1:{server.port}"
    ask = json.dumps(SERVE_ASK).encode()
    out = {"chunk_s": [], "ask": None, "threads": []}
    last = [time.perf_counter()]

    def post_ask():
        t0 = time.perf_counter()
        code, text = _http(url + "/whatif", ask)
        out["ask"] = (code, json.loads(text), time.perf_counter() - t0)

    def on_chunk(health):
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize()
        now = time.perf_counter()
        out["chunk_s"].append(now - last[0])
        k = health["chunks"]
        if k == 1:
            body = json.dumps({"rows": [list(r) for r in rows[SERVE_FEED:]]}).encode()
            code, text = _http(url + "/ingest", body)
            if code != 200 or json.loads(text)["accepted"] != SERVE_POSTS:
                raise SystemExit(f"serve: POST /ingest answered {code} {text}")
        out["metrics"] = _http(url + "/metrics")[1]
        out["health"] = json.loads(_http(url + "/healthz")[1])
        if ask_at is None and k == 2:
            th = threading.Thread(target=post_ask, name="whatif-client")
            th.start()
            out["threads"].append(th)
        elif ask_at is not None and k == ask_at // SERVE_CHUNK + 1:
            post_ask()
        last[0] = time.perf_counter()

    try:
        t0 = time.perf_counter()
        final, status = serve_ingest_run(
            spec, st, net, b, queue=q, server=server, chunk_ticks=SERVE_CHUNK,
            slo_ms=SERVE_SLO_MS, dump_dir=os.path.join(outdir, "pm"), on_chunk=on_chunk,
            whatif_ticks=SERVE_ASK["ticks"])
        run_s = time.perf_counter() - t0
        for th in out["threads"]:
            th.join(600)
            if th.is_alive():
                raise SystemExit("serve: the what-if client did not finish")
    finally:
        server.close()
    if out["ask"] is None or out["ask"][0] != 200:
        raise SystemExit(f"serve: the what-if ask failed: {out['ask']}")
    t0 = time.perf_counter()
    trace = export_trace(spec, final, os.path.join(outdir, "trace.json"),
                         max_tasks=SERVE_TRACE_TASKS)
    trace_s = time.perf_counter() - t0
    hist = hist_summary(spec, final)
    t0 = time.perf_counter()
    render_openmetrics(spec, final, hist=hist, ingest=q.stats())
    render_ms = (time.perf_counter() - t0) * 1e3
    return spec, final, {**out, "status": status, "run_s": run_s, "trace": trace,
                         "trace_s": trace_s, "render_ms": render_ms, "ingest": q.stats(),
                         "log": status["arrival_log"]}


def _profile_events(fn, n_ticks):
    """Device events and device ms a tick of ``fn()`` (an ``n_ticks``-tick
    run, warm) from ``torch.profiler``; a trace with no device event is
    taken again, up to six times, a second apart."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(6):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if str(e.device_type).endswith("CUDA")
               and not e.name.startswith("phase_")]
        if evs:
            break
    dev_us = sum(float(e.time_range.elapsed_us()) for e in evs)
    return len(evs) / n_ticks, dev_us / n_ticks / 1e3


def serve_cost(dev):
    """The serve world cut to 10 ticks (2 chunks of 5), plain
    ``run_chunked`` against ``serve_run`` (no server, no what-if): wall ms
    a chunk after a warm-up, device events and device ms a tick from the
    profiler."""
    import torch

    from fognetsimpp_tpu_torch.core.engine import run_chunked
    from fognetsimpp_tpu_torch.scenarios import smoke
    from fognetsimpp_tpu_torch.telemetry.live import serve_run

    world = smoke.build(device=dev, **dict(bench_world(5e-3), **SERVE_WORLD,
                                          horizon=2 * SERVE_CHUNK * 5e-3))
    spec = world[0]
    calls = {
        "off": lambda: run_chunked(*world, chunk_ticks=SERVE_CHUNK),
        "on": lambda: serve_run(*world, chunk_ticks=SERVE_CHUNK, port=None),
    }
    out = {}
    for name, fn in calls.items():
        fn()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ev, dms = _profile_events(fn, spec.n_ticks)
        out[name] = {"ms_a_chunk": wall / (spec.n_ticks / SERVE_CHUNK) * 1e3,
                     "ms_a_tick": wall / spec.n_ticks * 1e3,
                     "device_events_per_tick": ev, "device_ms_per_tick": dms}
    return out


def serve_phase(dev, outroot, reset_launches, all_launches, need_launches, assert_same, smi):
    """Phase 34 (see the module docstring): the serve session on the card
    with the counts reset, then the same session on the CPU forking at the
    card's fork point; returns the serve run's and the fork's launches."""
    import collections
    import os
    import threading

    import torch

    from fognetsimpp_tpu_torch.ops import cuda_build

    fork = collections.Counter()

    def fork_tap(name, *args):
        # the what-if's kernel calls run on the server's handler thread
        if args[0].is_cuda and threading.current_thread() is not threading.main_thread():
            fork[name] += 1

    reset_launches()
    cuda_build.TAPS.append(fork_tap)
    try:
        spec, card, got = serve_session(dev, os.path.join(outroot, "card"))
    finally:
        cuda_build.TAPS.remove(fork_tap)
    total = all_launches()
    launches = {k: v - fork.get(k, 0) for k, v in total.items()}
    fork_launches = {k: fork.get(k, 0) for k in total}
    need_launches("serve", launches, ("fused_arrival_plan", "cell_sum_ordered"))
    need_launches("serve (the what-if fork)", fork_launches, ("fused_arrival_plan",))
    code, report, ask_s = got["ask"]
    done = report["fork_ticks_done"]
    t0 = time.perf_counter()
    _, cpu, want = serve_session(torch.device("cpu"), os.path.join(outroot, "cpu"), ask_at=done)
    cpu_s = time.perf_counter() - t0
    n_leaves = assert_same(card, cpu, "serve (card against CPU)")
    checks = {
        "exposition": _mask_latency_line(got["metrics"]) == _mask_latency_line(want["metrics"]),
        "healthz": _masked_ingest(got["health"]) == _masked_ingest(want["health"]),
        "trace": json.load(open(got["trace"])) == json.load(open(want["trace"])),
        "whatif_report": report == want["ask"][1],
        "arrival_log": got["log"] == want["log"],
        "ring": _masked_ingest(got["status"]["recorder"].ring)
        == _masked_ingest(want["status"]["recorder"].ring),
        "dumps": [os.path.basename(p) for p in got["status"]["dumps"]]
        == [os.path.basename(p) for p in want["status"]["dumps"]],
    }
    for a, b in zip(got["status"]["dumps"], want["status"]["dumps"]):
        ma, mb = json.load(open(a)), json.load(open(b))
        checks["bundle " + os.path.basename(a)] = _masked_ingest(ma) == _masked_ingest(mb)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise SystemExit(f"serve: card and CPU differ in {bad}")
    if not got["status"]["dumps"]:
        raise SystemExit("serve: the breaching SLO dumped no bundle")
    ing = got["ingest"]
    if ing["injected"] <= 0 or ing["accepted"] != SERVE_FEED + SERVE_POSTS:
        raise SystemExit(f"serve: the queue's stats are off: {ing}")
    if int(card.telem.lat_hist.sum()) <= 0:
        raise SystemExit("serve: the latency histogram counted no ack")
    emit({
        "phase": "serve", "n_users": spec.n_users, "n_fogs": spec.n_fogs,
        "ticks": spec.n_ticks, "chunk_ticks": SERVE_CHUNK, "leaves_equal": n_leaves,
        "checks": sorted(checks), "run_s": got["run_s"],
        "ms_a_chunk": [s * 1e3 for s in got["chunk_s"]],
        "render_ms": got["render_ms"], "trace_s": got["trace_s"],
        "whatif": {"wall_s": ask_s, "fork_ticks_done": done, "n_cells": report["n_cells"],
                   "delta_n_published": [c["delta"]["n_published"] for c in report["cells"]]},
        "ingest": ing, "dumps": [os.path.basename(p) for p in got["status"]["dumps"]],
        "anomalies": got["status"]["anomalies"], "slo_breaches": got["status"]["slo_breaches"],
        "lat_hist_count": int(card.telem.lat_hist.sum()), "cpu_session_s": cpu_s,
        "cost": serve_cost(dev),
        "launches": launches, "fork_launches": fork_launches, "nvidia_smi": smi,
    })
    return launches, fork_launches


def serve_tp_session(device, n_shards):
    """``serve_tp_run`` of ``SERVE_TP_WORLD`` on ``device`` behind a server
    on ``127.0.0.1:0``: the final state, the ring and the last
    ``/metrics``."""
    from fognetsimpp_tpu_torch.scenarios import smoke
    from fognetsimpp_tpu_torch.telemetry.live import serve_tp_run

    spec, st, net, b = smoke.build(device=device, **SERVE_TP_WORLD)
    seen = {}

    def on_chunk(health):
        seen["health"] = health

    t0 = time.perf_counter()
    spec2, final, status = serve_tp_run(spec, st, net, b, n_shards=n_shards,
                                        chunk_ticks=SERVE_TP_CHUNK, port=0, on_chunk=on_chunk)
    run_s = time.perf_counter() - t0
    try:
        metrics = _http(f"http://127.0.0.1:{status['port']}/metrics")[1]
    finally:
        status["server"].close()
    return spec2, final, status, metrics, run_s


def serve_tp_phase(dev, n_shards, reset_launches, all_launches, need_launches, assert_same,
                   smi):
    """Phase 35: ``serve_tp_run`` at ``n_shards`` shards on the card, counted,
    against the CPU."""
    import torch

    reset_launches()
    spec, card, status, metrics, run_s = serve_tp_session(dev, n_shards)
    launches = all_launches()
    need_launches("serve_tp", launches, ("fused_arrival_plan", "ring_all_gather"))
    t0 = time.perf_counter()
    _, cpu, cstatus, cmetrics, _ = serve_tp_session(torch.device("cpu"), n_shards)
    cpu_s = time.perf_counter() - t0
    n_leaves = assert_same(card, cpu, "serve_tp (card against CPU)")
    if metrics != cmetrics:
        raise SystemExit("serve_tp: the last exposition differs between card and CPU")
    if status["recorder"].ring != cstatus["recorder"].ring:
        raise SystemExit("serve_tp: the flight recorder's hashes differ between card and CPU")
    if "fns_tp_exchange_candidates{shard=" not in metrics:
        raise SystemExit("serve_tp: the exposition has no per-shard exchange family")
    emit({
        "phase": "serve_tp", "n_users": spec.n_users, "n_fogs": spec.n_fogs,
        "n_shards": n_shards, "ticks": spec.n_ticks, "chunk_ticks": SERVE_TP_CHUNK,
        "leaves_equal": n_leaves, "run_s": run_s, "ms_a_tick": run_s / spec.n_ticks * 1e3,
        "chunks": status["chunks"], "n_completed": int(card.metrics.n_completed),
        "shard_hashes": len(status["recorder"].ring[-1]["shard_hashes"]),
        "cpu_session_s": cpu_s, "launches": launches, "nvidia_smi": smi,
    })
    return launches


def tenant_door(device):
    """Two smoke tenants behind a front door on ``127.0.0.1:0``, served
    ``TENANT_ROUNDS`` rounds: the door and the aggregate ``/metrics``."""
    from fognetsimpp_tpu_torch.scenarios import smoke
    from fognetsimpp_tpu_torch.twin.front import FrontDoor

    door = FrontDoor(capacity=2, chunk_ticks=TENANT_CHUNK, port=0)
    try:
        for i in range(2):
            door.admit(f"t{i}", *smoke.build(device=device, seed=i, **TENANT_WORLD))
        t0 = time.perf_counter()
        ticks = door.serve(TENANT_ROUNDS)
        wall = time.perf_counter() - t0
        url = f"http://127.0.0.1:{door.server.port}"
        pages = {p: _http(url + p)[1] for p in ("/metrics", "/t/t0/metrics", "/t/t1/healthz")}
    finally:
        door.close()
    return door, ticks, wall, pages


def tenants_phase(dev, reset_launches, all_launches, need_launches, assert_same, smi):
    """Phase 36: the front door on the card, counted, against the CPU,
    tenant by tenant."""
    import torch

    reset_launches()
    door, ticks, wall, pages = tenant_door(dev)
    launches = all_launches()
    need_launches("tenants", launches, ("fused_arrival_plan", "cell_sum_ordered"))
    cdoor, cticks, _, cpages = tenant_door(torch.device("cpu"))
    if ticks != cticks or door.tenant_rows() != cdoor.tenant_rows():
        raise SystemExit("tenants: the tenants' rows differ between card and CPU")
    if _mask_latency_line(str(pages)) != _mask_latency_line(str(cpages)):
        raise SystemExit("tenants: the served pages differ between card and CPU")
    leaves = {}
    for label in ("t0", "t1"):
        t, c = door._tenants[label], cdoor._tenants[label]
        leaves[label] = assert_same(t.state, c.state, f"tenants {label} (card against CPU)")
        if t.metrics_text != c.metrics_text or t.recorder.ring != c.recorder.ring:
            raise SystemExit(f"tenants {label}: its page or ring differs between card and CPU")
    emit({
        "phase": "tenants", "tenants": door.tenants, "rounds": TENANT_ROUNDS,
        "chunk_ticks": TENANT_CHUNK, "ticks": ticks, "wall_s": wall,
        "ms_a_tenant_chunk": wall / (TENANT_ROUNDS * 2) * 1e3,
        "rows": door.tenant_rows(), "leaves_equal": leaves, "launches": launches,
        "nvidia_smi": smi,
    })
    return launches


# ---- 37-39: the slot mesh, the node-sharded entry, the process group ----
#: ``fleet`` (37): ``benchmarks.py::config3``'s 64 replicas (1,000 users x
#: 24 fogs, K = 256) cut to 20 of its 250 ticks, over a one-slot and a
#: four-slot mesh (1,536 fogs end to end: ``pairwise_rank``) and one slot's
#: 16 replicas alone (384 fogs: ``fused_arrival_plan``); ``run_fleet_series``
#: in chunks of 7 on the four slots; ``fleet_decisions`` on 2 keys.
FLEET_R, FLEET_SLOTS, FLEET_HORIZON, FLEET_CHUNK, FLEET_KEY_SEED = 64, 4, 0.02, 7, 7
#: The fleet's CLI call: 8 replicas of the ``--tp 4`` smoke world of
#: ``cli`` over 4 slots, with their series.
CLI_FLEET = ["-s", "smoke", "--set", "scenario.n_users=1024", "--set", "scenario.n_fogs=32",
             "--set", f"fog.*.mips={TEL_FOGS['fog_mips'][0]:g}",
             "--set", "scenario.send_interval=10ms", "--set", "scenario.horizon=0.01",
             "--replicas", "8", "--mesh", "4", "--ticks"]
#: ``node_sharded`` (38): ``run_node_sharded`` over 4 slots of the bench
#: world without an arrival window (the task-sharded tick's ring) and of
#: config 4's one-replica world (mobile: the engine; 10,000 users and
#: 90,000 task rows divide by 4), each 20 ticks of 5 ms; ``sharded_min_busy``
#: at K = 4,096 tasks over 1,024 fogs on 4 slots.
NODE_SLOTS, NODE_WIRELESS_HORIZON = 4, 0.1
MIN_BUSY_K, MIN_BUSY_F = 4096, 1024
#: ``multihost`` (39): a one-rank NCCL group, 2 slots, 4 replicas of a
#: 256-user smoke world on 80,000-MIPS fogs, 20 ticks.
MULTIHOST_WORLD = dict(n_users=256, n_fogs=8, fog_mips=TEL_FOGS["fog_mips"], horizon=0.02)


def _fleet_world(device):
    """Config 3's world cut to ``FLEET_HORIZON``."""
    from fognetsimpp_tpu_torch import benchmarks as bm

    spec, st, net, b = bm.config3_world(device)
    return dataclasses.replace(spec, horizon=FLEET_HORIZON).validate(), st, net, b


def _equal_leaves(a: list, b: list, what: str) -> int:
    """Two lists of numpy leaves equal in dtype, shape and bits."""
    if len(a) != len(b) or any(x.dtype != y.dtype or x.shape != y.shape
                               or x.tobytes() != y.tobytes() for x, y in zip(a, b)):
        raise SystemExit(f"{what}: the leaves differ")
    return len(a)


def fleet_phase(dev, refs, h) -> dict:
    """Phase 37 (see the module docstring); ``h`` holds the launch-count
    helpers, ``assert_same``, ``smi`` and, when the phase runs inside the
    script, ``first_window_row`` (a kernel row from a kept window).
    Returns each run's launches."""
    import os

    import torch

    from fognetsimpp_tpu_torch.ops import cuda_build
    from fognetsimpp_tpu_torch.parallel import fleet, make_mesh, replicate_state
    from fognetsimpp_tpu_torch.parallel.replicas import strict_vmap
    from fognetsimpp_tpu_torch.random import PRNGKey, split
    from fognetsimpp_tpu_torch.state import state_to_numpy, tree_map

    spec, st, net, b = _fleet_world(dev)
    batch = replicate_state(spec, st, FLEET_R, seed=0)
    slot_r = FLEET_R // FLEET_SLOTS
    meshes = {"one_slot": make_mesh(1, device=dev),
              "four_slots": make_mesh(FLEET_SLOTS, device=dev)}
    runs = {"one_slot": (meshes["one_slot"], batch, "pairwise_rank"),
            "four_slots": (meshes["four_slots"], batch, "pairwise_rank"),
            "slot_rows": (meshes["one_slot"], tree_map(lambda x: x[:slot_r], batch),
                          "fused_arrival_plan")}
    finals, walls, launches, first = {}, {}, {}, {}
    for label, (mesh, rows, kernel) in runs.items():
        kept = []

        def tap(name, *args, kept=kept):
            if args[0].device.type != mesh.device.type:
                raise SystemExit(f"fleet: {name} ran off the mesh's device")
            if not kept and name in ("fused_arrival_plan", "pairwise_rank") and bool(args[0].any()):
                kept.append((name, [a.clone() for a in args[:3]]))

        with strict_vmap():
            fleet.run_fleet(spec, rows, net, b, mesh, n_ticks=REPLICA_WARM_TICKS)
            torch.cuda.synchronize()
            h.reset_launches()
            cuda_build.TAPS.append(tap)
            try:
                t0 = time.perf_counter()
                finals[label] = fleet.run_fleet(spec, rows, net, b, mesh)
                torch.cuda.synchronize()
                walls[label] = time.perf_counter() - t0
            finally:
                cuda_build.TAPS.remove(tap)
        launches[label] = h.all_launches()
        h.need_launches(f"fleet {label}", launches[label], [kernel])
        other = "pairwise_rank" if kernel == "fused_arrival_plan" else "fused_arrival_plan"
        if launches[label][kernel] != spec.n_ticks or launches[label][other]:
            raise SystemExit(f"fleet {label}: launches {launches[label]} in {spec.n_ticks} ticks")
        first[label] = kept[0] if kept else None
    # one slot's rows alone (fused) against the same rows of the whole
    # batch (pairwise); the four-slot fleet against the one-slot fleet
    _equal_leaves(state_to_numpy(finals.pop("slot_rows")),
                  state_to_numpy(tree_map(lambda x: x[:slot_r], finals["one_slot"])),
                  "fleet: a slot's rows alone against the whole batch's")
    one = state_to_numpy(finals.pop("one_slot"))
    n_leaves = _equal_leaves(state_to_numpy(finals.pop("four_slots")), one,
                             "fleet: four slots against one slot")
    cpu_final, cpu_series, cpu_s = refs.take("fleet series")
    _equal_leaves(one, cpu_final, "fleet: one slot (card) against the CPU")
    spec_rec = dataclasses.replace(spec, record_tick_series=True)
    h.reset_launches()
    t0 = time.perf_counter()
    with strict_vmap():
        rec, series = fleet.run_fleet_series(spec_rec, batch, net, b, meshes["four_slots"],
                                             chunk_ticks=FLEET_CHUNK)
    torch.cuda.synchronize()
    series_wall = time.perf_counter() - t0
    launches["series"] = h.all_launches()
    h.need_launches("fleet series", launches["series"], ["pairwise_rank"])
    _equal_leaves(state_to_numpy(rec), cpu_final, "fleet series: final (card against CPU)")
    if sorted(series) != sorted(cpu_series) or any(
            series[k].tobytes() != cpu_series[k].tobytes() for k in series):
        raise SystemExit("fleet series: the series differ between card and CPU")
    del rec
    keys = split(PRNGKey(FLEET_KEY_SEED, dev), 2)
    h.reset_launches()
    t0 = time.perf_counter()
    with strict_vmap():
        d, dm = fleet.fleet_decisions(spec, batch, net, b, keys, meshes["four_slots"])
    d, dm = int(d), int(dm)  # the one fetch
    decisions_s = time.perf_counter() - t0
    launches["decisions"] = h.all_launches()
    h.need_launches("fleet decisions", launches["decisions"], ["pairwise_rank"])
    cpu_pair, _, cpu_dec_s = refs.take("fleet decisions")
    if [d, dm] != cpu_pair or d <= 0:
        raise SystemExit(f"fleet decisions: ({d}, {dm}) on the card, {cpu_pair} on the CPU")
    # a slot's rows' first non-empty window, a shape no other phase has
    # (the whole batch's is config3's)
    if getattr(h, "first_window_row", None) is not None and first["slot_rows"] is not None:
        name, args = first["slot_rows"]
        h.first_window_row(name, args, "fleet_slot_rows", slot_r * spec.n_fogs)
    # the python -m entry point with --mesh, as a subprocess; then the same
    # argv through main() counted and on the CPU
    root = os.path.dirname(os.path.abspath(__file__))
    out = {k: os.path.join(root, "_cli_out", "fleet", k) for k in ("card", "main", "cpu")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "fognetsimpp_tpu_torch", *CLI_FLEET,
                           "--out", out["card"]], cwd=root, capture_output=True, text=True,
                          timeout=600)
    cli_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"fleet cli: exit {proc.returncode}: {proc.stderr[-2000:]}")
    card = json.loads(proc.stdout.strip().splitlines()[-1])
    h.reset_launches()
    counted = _main_json(CLI_FLEET + ["--out", out["main"]], "fleet cli")
    torch.cuda.synchronize()
    launches["cli"] = h.all_launches()
    h.need_launches("fleet cli", launches["cli"], ["fused_arrival_plan"])
    cpu = _main_json(CLI_FLEET + ["--platform", "cpu", "--out", out["cpu"]], "fleet cli")
    _cli_files_equal(card, counted, "fleet (subprocess against main())")
    files = _cli_files_equal(card, cpu, "fleet (card against CPU)")
    if card["n_devices"] != 4 or card["n_completed_sum"] <= 0 or any(
            card[k] != cpu[k] for k in ("n_published_sum", "n_completed_sum",
                                        "n_completed_minmax")):
        raise SystemExit(f"fleet cli: {card} on the card, {cpu} on the CPU")
    n = spec.n_ticks
    emit({
        "phase": "fleet", "replicas": FLEET_R, "n_users": spec.n_users, "n_fogs": spec.n_fogs,
        "window": spec.window, "ticks": n, "slots": {k: m.size for k, m in meshes.items()},
        "slot_rows_replicas": slot_r, "ms_per_tick": {k: w / n * 1e3 for k, w in walls.items()},
        "four_over_one": walls["four_slots"] / walls["one_slot"],
        "leaves_equal": n_leaves, "cpu_run_s": cpu_s,
        "series": {"chunk_ticks": FLEET_CHUNK, "wall_s": series_wall,
                   "ms_per_tick": series_wall / n * 1e3, "keys": sorted(series),
                   "bytes": int(sum(v.nbytes for v in series.values()))},
        "decisions": {"keys": 2, "total": d, "deferred_max": dm, "s_a_call": decisions_s,
                      "decisions_per_sec": d / decisions_s, "cpu_run_s": cpu_dec_s},
        "cli": {"argv": CLI_FLEET, "subprocess_wall_s": cli_wall, "run_wall_s": card["wall_s"],
                "summary": {k: v for k, v in card.items() if k not in ("sca", "vec", "om")},
                **files},
        "launches": launches, "nvidia_smi": h.smi,
    })
    return launches


def _main_json(argv, what):
    """The port's ``main(argv)`` in this process: its summary line."""
    import contextlib
    import io

    from fognetsimpp_tpu_torch.__main__ import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    if rc != 0:
        raise SystemExit(f"{what}: main() returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _min_busy_inputs(device):
    """``sharded_min_busy``'s inputs at ``MIN_BUSY_K`` x ``MIN_BUSY_F``
    from seed 0: 70 % of tasks decided, one fog in 16 unregistered."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    K, F = MIN_BUSY_K, MIN_BUSY_F
    arrays = (rng.random(K) < 0.7, (200 + rng.random(K) * 700).astype(np.float32),
              (rng.random(F) * 2).astype(np.float32),
              (100 + rng.random(F) * 3900).astype(np.float32), rng.random(F) >= 1 / 16)
    return [torch.from_numpy(a).to(device) for a in arrays]


def node_sharded_phase(dev, refs, h) -> dict:
    """Phase 38 (see the module docstring); returns each run's launches,
    and ``h.ring_row`` (when set) receives ``sharded_min_busy``'s
    gathered blocks for a kernel row."""
    import torch

    from fognetsimpp_tpu_torch.core.engine import tp_ok
    from fognetsimpp_tpu_torch.ops import sched
    from fognetsimpp_tpu_torch.parallel import make_mesh, run_node_sharded, sharded_min_busy
    from fognetsimpp_tpu_torch.parallel import shards as tshards
    from fognetsimpp_tpu_torch.random import PRNGKey
    from fognetsimpp_tpu_torch.spec import Policy

    launches, walls, leaves, cpu_s, ticks = {}, {}, {}, {}, {}
    for label, build, need in (
        ("bench_ring", built_by(_smoke_world, _node_bench_kw()), ("ring_all_gather",
                                                                  "fused_arrival_plan")),
        ("config4", built_by(_node_wireless_world), ("cell_sum_ordered", "fused_arrival_plan")),
    ):
        spec, st, net, b = build(dev)
        if tp_ok(spec) != (label == "bench_ring"):
            raise SystemExit(f"node_sharded {label}: tp_ok is {tp_ok(spec)}")
        mesh = make_mesh(NODE_SLOTS, axis_name="node", device=dev)
        h.reset_launches()
        t0 = time.perf_counter()
        got = run_node_sharded(spec, st, net, b, mesh)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        ticks[label] = spec.n_ticks
        launches[label] = h.all_launches()
        h.need_launches(f"node_sharded {label}", launches[label], need)
        cpu, _, cpu_s[label] = refs.take(f"node {label}")
        leaves[label] = h.assert_same(got, cpu, f"node_sharded {label} (card against CPU)")
        if int(got.metrics.n_scheduled) <= 0:
            raise SystemExit(f"node_sharded {label}: nothing scheduled")
        del got
    inp = _min_busy_inputs(dev)
    mesh = make_mesh(NODE_SLOTS, axis_name="fog", device=dev)
    blocks = []
    ring = tshards.ring_all_gather

    def keep(bl):
        if not blocks:
            blocks.append([x.clone() for x in bl])
        return ring(bl)

    h.reset_launches()
    tshards.ring_all_gather = keep
    try:
        got = sharded_min_busy(mesh, *inp, axis_name="fog")
        torch.cuda.synchronize()
    finally:
        tshards.ring_all_gather = ring
    launches["sharded_min_busy"] = h.all_launches()
    h.need_launches("sharded_min_busy", launches["sharded_min_busy"], ["ring_all_gather"])
    F = MIN_BUSY_F
    plain, _ = sched.schedule_batch(
        int(Policy.MIN_BUSY), *inp, torch.ones(F, dtype=torch.bool, device=dev),
        torch.ones(F, device=dev), torch.zeros(F, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev), PRNGKey(0, dev), mips0_divisor=False)
    cpu = sharded_min_busy(make_mesh(NODE_SLOTS, axis_name="fog", device="cpu"),
                           *[x.cpu() for x in inp], axis_name="fog")
    if not torch.equal(got, plain) or not torch.equal(got.cpu(), cpu):
        raise SystemExit("sharded_min_busy differs from schedule_batch or from the CPU")
    from fognetsimpp_tpu_torch.tools.ab import stream_ms

    call_ms = stream_ms(lambda: sharded_min_busy(mesh, *inp, axis_name="fog"), 20)
    plain_ms = stream_ms(lambda: sched.schedule_batch(
        int(Policy.MIN_BUSY), *inp, torch.ones(F, dtype=torch.bool, device=dev),
        torch.ones(F, device=dev), torch.zeros(F, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev), PRNGKey(0, dev), mips0_divisor=False), 20)
    if getattr(h, "ring_row", None) is not None:
        h.ring_row(blocks[0], "sharded_min_busy")
    emit({
        "phase": "node_sharded", "slots": NODE_SLOTS, "wall_s": walls,
        "ms_per_tick": {k: w / ticks[k] * 1e3 for k, w in walls.items()},
        "leaves_equal": leaves, "cpu_run_s": cpu_s,
        "sharded_min_busy": {"K": MIN_BUSY_K, "F": MIN_BUSY_F, "slots": NODE_SLOTS,
                             "decided": int((got >= 0).sum()),
                             "ms_a_call": call_ms, "schedule_batch_ms": plain_ms,
                             "timed_by": "CUDA events behind a sleep kernel"},
        "launches": launches, "nvidia_smi": h.smi,
    })
    return launches


def _node_bench_kw():
    """The bench world (dt 5 ms) without an arrival window."""
    return dict(bench_world(5e-3), arrival_window=None)


def _node_wireless_world(device):
    """Config 4's one-replica world cut to ``NODE_WIRELESS_HORIZON``."""
    from fognetsimpp_tpu_torch import benchmarks as bm

    return bm.config4_world(horizon=NODE_WIRELESS_HORIZON, device=device)


def multihost_phase(dev, h) -> dict:
    """Phase 39 (see the module docstring): a one-rank NCCL group on the
    card; ``run_sharded`` and ``fleet_decisions`` over ``global_mesh``
    against the CPU; the group destroyed at the end."""
    import socket

    import torch
    import torch.distributed as dist

    from fognetsimpp_tpu_torch.parallel import (
        fleet_decisions, global_mesh, initialize, make_mesh, replicate_state, run_sharded,
    )
    from fognetsimpp_tpu_torch.random import PRNGKey, split
    from fognetsimpp_tpu_torch.scenarios import smoke
    from fognetsimpp_tpu_torch.state import state_to_numpy

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    if initialize(f"127.0.0.1:{port}", 1, 0) != 1:
        raise SystemExit("multihost: the group does not hold one rank")
    try:
        init_s = time.perf_counter() - t0
        backend = dist.get_backend()
        mesh = global_mesh(local_slots=2)
        if backend != "nccl" or mesh.device.type != "cuda" or mesh.group_size != 1:
            raise SystemExit(f"multihost: backend {backend}, mesh {mesh}")
        spec, st, net, b = smoke.build(device=mesh.device, **MULTIHOST_WORLD)
        batch = replicate_state(spec, st, 4, seed=0)
        h.reset_launches()
        rows = run_sharded(spec, batch, net, b, mesh)
        d, dm = fleet_decisions(spec, batch, net, b, split(PRNGKey(5, mesh.device), 2), mesh)
        d, dm = int(d), int(dm)
        torch.cuda.synchronize()
        launches = h.all_launches()
        h.need_launches("multihost", launches, ["fused_arrival_plan"])
    finally:
        dist.destroy_process_group()
    cspec, cst, cnet, cb = smoke.build(device="cpu", **MULTIHOST_WORLD)
    cbatch = replicate_state(cspec, cst, 4, seed=0)
    cmesh = make_mesh(2, device="cpu")
    n_leaves = _equal_leaves(state_to_numpy(rows.state),
                             state_to_numpy(run_sharded(cspec, cbatch, cnet, cb, cmesh)),
                             "multihost: rows (card against CPU)")
    cd, cdm = fleet_decisions(cspec, cbatch, cnet, cb, split(PRNGKey(5), 2), cmesh)
    if (rows.start, rows.stop) != (0, 4) or [d, dm] != [int(cd), int(cdm)] or d <= 0:
        raise SystemExit(f"multihost: rows {rows.start}:{rows.stop}, ({d}, {dm}) on the "
                         f"card, ({int(cd)}, {int(cdm)}) on the CPU")
    emit({
        "phase": "multihost", "backend": backend, "ranks": 1, "slots": mesh.size,
        "init_s": init_s, "rows": [rows.start, rows.stop], "leaves_equal": n_leaves,
        "decisions": d, "deferred_max": dm, "launches": launches, "nvidia_smi": h.smi,
    })
    return launches


# ---- 40-41: the sanitizer and the contracts, then the card-only tests ---
#: The sanitized CLI calls' world: ``tests/test_engine_smoke.py``'s, its
#: 0.3 s cut to 0.1 s.
CHECKIFY_CLI = ["-s", "smoke", "--set", "spec.horizon=0.1", "--seed", "7"]
#: Replicas of the bench world in the fleet contract's batch.
CONTRACT_REPLICAS = 4
#: Most seconds the step and fleet contracts may take together.
CONTRACT_MAX_S = 5.0
#: The card test file's command, its time limit (seconds) and the pytest
#: processes its tests are dealt to.
CARD_TESTS = ["-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q",
              "tests/test_torch_cuda.py"]
CARD_TESTS_TIMEOUT, CARD_TEST_PROCS = 420, 8


#: The warning torch's sync debug mode gives a synchronising CUDA call.
SYNC_WARNING = "called a synchronizing CUDA operation"


def _sync_count(fn):
    """``(fn(), host synchronisations it made)``: torch's sync debug mode
    warns once a synchronising CUDA call, and each warning is counted."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum(SYNC_WARNING in str(w.message) for w in caught)


def checkify_phase(dev, h) -> dict:
    """Phase 40 (see the module docstring); returns the sanitized run's
    launches."""
    import os

    import torch

    from fognetsimpp_tpu_torch.core import contracts, engine
    from fognetsimpp_tpu_torch.core.sanitizer import CheckifyError
    from fognetsimpp_tpu_torch.parallel import replicate_state
    from fognetsimpp_tpu_torch.scenarios import smoke
    from fognetsimpp_tpu_torch.state import state_to_numpy

    t_phase = time.perf_counter()
    _, n_cal = _sync_count(lambda: torch.ones((), device=dev).item())
    if n_cal != 1:
        raise SystemExit(f"checkify: one .item() counted {n_cal} synchronisations")
    kw = bench_world(5e-3)
    spec, st, net, b = smoke.build(device=dev, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain, _ = engine.run(spec, st, net, b)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0

    spec, st, net, b = smoke.build(device=dev, **kw)
    torch.cuda.synchronize()
    h.reset_launches()
    t0 = time.perf_counter()
    (final, _), n_sync = _sync_count(
        lambda: engine.run_checkified(spec, st, net, b, errors="div"))
    torch.cuda.synchronize()
    div_s = time.perf_counter() - t0
    launches = h.all_launches()
    h.need_launches("checkify", launches, ["fused_arrival_plan"])
    if n_sync != 1:
        raise SystemExit(f"checkify: the sanitized run synchronised {n_sync} times, not once")
    n_leaves = _equal_leaves(state_to_numpy(final), state_to_numpy(plain),
                             "checkify div (sanitized against plain, on the card)")

    spec, st, net, b = smoke.build(device=dev, **kw)
    t0 = time.perf_counter()
    try:
        engine.run_checkified(spec, st, net, b, errors="nan")
    except CheckifyError as e:
        nan_trip = str(e)
    else:
        raise SystemExit("checkify: the nan set did not trip on the bench world")
    nan_s = time.perf_counter() - t0

    # the contracts on the card's state: shapes only
    t0 = time.perf_counter()
    contracts.check_step_contract(spec, st, net, b)
    step_s = time.perf_counter() - t0
    batch = replicate_state(spec, st, CONTRACT_REPLICAS, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    contracts.check_fleet_contract(spec, batch, net, b)
    fleet_s = time.perf_counter() - t0
    if step_s + fleet_s > CONTRACT_MAX_S:
        raise SystemExit(f"checkify: the contracts took {step_s + fleet_s:.2f} s")
    step = engine.make_step(spec)

    def promoted(s, n, bb):
        out = step(s, n, bb)
        stage = out.tasks.stage
        return out.replace(tasks=out.tasks.replace(
            stage=stage + torch.ones_like(stage, dtype=torch.int32)))

    try:
        contracts.check_step_contract(spec, st, net, b, step=promoted)
    except contracts.ContractError as e:
        if "stage" not in str(e):
            raise SystemExit(f"checkify: the planted promotion's error names no stage: {e}")
    else:
        raise SystemExit("checkify: a planted int8 + int32 promotion passed the contract")
    del batch

    # the CLI, both calls at once
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = {
        sets: subprocess.Popen(
            [sys.executable, "-m", "fognetsimpp_tpu_torch", *CHECKIFY_CLI, "--checkify", sets],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for sets in ("div", "nan")
    }
    cli = {}
    try:
        for sets, p in procs.items():
            out, err = p.communicate(timeout=600)
            cli[sets] = {"rc": p.returncode, "stdout": out.strip().splitlines()[-1:],
                         "stderr": err.strip().splitlines()[-1:]}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    cli_s = time.perf_counter() - t0
    if cli["div"]["rc"] != 0 or cli["nan"]["rc"] != 1 or not \
            cli["nan"]["stderr"][0].startswith("error: checkify: nan: "):
        raise SystemExit(f"checkify: the CLI calls gave {cli}")
    n = spec.n_ticks
    emit({
        "phase": "checkify", "n_users": spec.n_users, "n_fogs": spec.n_fogs,
        "window": spec.window, "ticks": n, "leaves_equal": n_leaves,
        "host_syncs": n_sync, "plain_s": plain_s, "div_s": div_s, "nan_s": nan_s,
        "plain_ms_per_tick": plain_s / n * 1e3, "div_ms_per_tick": div_s / n * 1e3,
        "div_over_plain": div_s / plain_s, "nan_trip": nan_trip,
        "step_contract_s": step_s, "fleet_contract_s": fleet_s,
        "fleet_contract_replicas": CONTRACT_REPLICAS, "cli": cli, "cli_s": cli_s,
        "seconds": time.perf_counter() - t_phase, "launches": launches,
        "nvidia_smi": h.smi,
    })
    return launches


def card_tests_phase(h) -> dict:
    """Phase 41 (see the module docstring): the card test file's tests,
    collected once and run in ``CARD_TEST_PROCS`` pytest processes
    (every test once; each process runs torch on one CPU thread, the
    file's own fixture); returns the summed counts."""
    import os
    import xml.etree.ElementTree as ET

    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "_cli_out", "card_tests")  # git-ignored
    os.makedirs(out, exist_ok=True)
    torch.cuda.empty_cache()  # the test processes' memory
    t0 = time.perf_counter()
    coll = subprocess.run([sys.executable, *CARD_TESTS, "--collect-only"], cwd=root,
                          capture_output=True, text=True, timeout=300)
    ids = [ln.strip() for ln in coll.stdout.splitlines() if "::" in ln]
    if coll.returncode != 0 or not ids:
        raise SystemExit(f"card_tests: collection failed ({coll.returncode}):\n"
                         f"{coll.stdout[-3000:]}\n{coll.stderr[-2000:]}")
    procs = []
    for k in range(CARD_TEST_PROCS):
        shard = ids[k::CARD_TEST_PROCS]
        xml = os.path.join(out, f"shard{k}.xml")
        if os.path.exists(xml):
            os.remove(xml)
        log = open(os.path.join(out, f"shard{k}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, *CARD_TESTS[:-1], f"--junitxml={xml}", *shard], cwd=root,
            stdout=log, stderr=subprocess.STDOUT, text=True), xml, log))
    deadline = t0 + CARD_TESTS_TIMEOUT
    try:
        for p, _, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        raise SystemExit(f"card_tests: past its {CARD_TESTS_TIMEOUT} s") from None
    finally:
        for p, _, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    secs = time.perf_counter() - t0
    counts = {"tests": 0, "failures": 0, "errors": 0, "skipped": 0}
    for _, xml, _ in procs:
        if os.path.exists(xml):
            suite = ET.parse(xml).getroot()
            suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
            for k in counts:
                counts[k] += int(suite.get(k, 0))
    row = {
        "phase": "card_tests", "command": " ".join(["python", *CARD_TESTS]),
        "collected": len(ids), "processes": CARD_TEST_PROCS,
        "passed": counts["tests"] - counts["failures"] - counts["errors"] - counts["skipped"],
        "failed": counts["failures"], "errors": counts["errors"],
        "skipped": counts["skipped"], "rcs": [p.returncode for p, _, _ in procs],
        "seconds": secs, "nvidia_smi": h.smi,
    }
    emit(row)
    if any(row["rcs"]) or row["failed"] or row["errors"] or row["skipped"] \
            or row["passed"] != len(ids):
        tails = "".join(open(log.name).read()[-3000:] for _, _, log in procs)
        raise SystemExit(f"card_tests: {row}\n{tails}")
    return row


# ---- the CPU references, run in worker processes ------------------------
#: Worker processes that run each world's CPU reference while the card
#: runs the phases before it (spawned, so the card stays the parent's),
#: torch's threads in each, and the niceness they run at.
CPU_WORKERS, CPU_WORKER_THREADS, CPU_WORKER_NICE = 3, 2, 10


def built_by(fn, *args):
    """A world builder a worker can unpickle: ``built_by(fn, *args)(device)``
    is ``fn(*args, device)``, which returns ``(spec, state, net, bounds)``."""
    return functools.partial(fn, *args)


def _smoke_world(kw, device):
    from fognetsimpp_tpu_torch.scenarios import smoke

    return smoke.build(device=device, **kw)


def _hier_world(kw, device):
    """The smoke world of ``kw`` with domain 0 owning every user and the
    fogs owned as ``HIER_FOG_OWNER`` says."""
    from fognetsimpp_tpu_torch.hier import stamp_ownership

    spec, st, net, b = _smoke_world(kw, device)
    st = stamp_ownership(spec, st, user_broker=[0] * spec.n_users, fog_broker=HIER_FOG_OWNER)
    return spec, st, net, b


def _wireless_world(kw, device):
    from fognetsimpp_tpu_torch.scenarios import wireless

    return wireless.wireless5(device=device, **kw)


def _scenario_world(name, kw, device):
    import importlib

    return importlib.import_module(f"fognetsimpp_tpu_torch.scenarios.{name}").build(
        device=device, **kw)


def _policy_world(name, device):
    """The bench world under ``POLICIES[name]``."""
    import torch

    from fognetsimpp_tpu_torch.spec import BugCompat, Policy

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
    spec, st, net, b = _smoke_world(kw, device)
    if pid == int(Policy.DYNAMIC):
        st = st.replace(broker=st.broker.replace(policy_id=torch.full(
            (), int(Policy.EXP3), dtype=torch.int32, device=device)))
    return spec, st, net, b


def _chaos_kw(row):
    from fognetsimpp_tpu_torch.spec import Policy

    over = dict(CHAOS_ROWS[row])
    if "policy" in over:
        over["policy"] = int(Policy[over["policy"]])
    return {**bench_world(5e-3), **CHAOS_BENCH, **over}


def _hier_kw(extra):
    from fognetsimpp_tpu_torch.spec import Policy

    kw = dict(bench_world(5e-3), **HIER_BENCH, **extra)
    if "policy" in kw:
        kw["policy"] = int(Policy[kw["policy"]])
    return kw


def cpu_jobs():
    """Every CPU reference whose world is fixed before the run, in the
    phases' order: key -> (kind, builder, run keywords); see
    :func:`_cpu_reference` for the kinds."""
    from fognetsimpp_tpu_torch.scenarios import cell_sum_inputs, pool_scan_inputs
    from fognetsimpp_tpu_torch.spec import Policy

    jobs = {"smoke": ("run", built_by(_smoke_world, dict(horizon=SMOKE_HORIZON)), {})}
    for dt in (5e-3, 1e-3):
        jobs[f"bench dt={dt}"] = ("run", built_by(_smoke_world, bench_world(dt)), {})
    jobs["wide_fog"] = ("run", built_by(_smoke_world, WIDE_FOG), {})
    jobs["tp"] = ("tp", built_by(_smoke_world, TP_WORLD), dict(
        n_shards=TP_SHARDS, n_ticks=TP_CHECK_TICKS, exchange_window=TP_K_EX))
    jobs["wireless"] = ("run", built_by(_wireless_world, dict(
        cell_sum_inputs.wireless_kw(), horizon=WIRELESS_HORIZON)), {})
    jobs["wireless_churn"] = ("run", built_by(_wireless_world, dict(
        CHURN, policy=int(Policy.MIN_BUSY))), {})
    jobs["rr_grid"] = ("run", built_by(_smoke_world, dict(RR_GRID, policy=int(Policy.ROUND_ROBIN))), {})
    for name in POLICIES:
        jobs[f"policies {name}"] = ("run", built_by(_policy_world, name), {})
    for name, over in {**pool_scan_inputs.V1V2, "front_droptail": FRONT_DROPTAIL}.items():
        jobs[name] = ("run", built_by(_smoke_world, dict(bench_world(5e-3), **over)), {})
    jobs["wired_v1"] = ("run", built_by(_scenario_world, "wired_v1", dict(
        horizon=WIRED_V1_HORIZON)), {})
    jobs["example"] = ("split", built_by(_scenario_world, "example", dict(
        horizon=EXAMPLE_HORIZON)), dict(from_tick=SCENARIO_FROM_TICK["example"]))
    for row in CHAOS_ROWS:
        jobs[f"chaos {row}"] = ("run", built_by(_smoke_world, _chaos_kw(row)), {})
    for phase, extra in (("hier", HIER_UP), ("hier_domain_down", HIER_DOWN)):
        jobs[phase] = ("run", built_by(_hier_world, _hier_kw(extra)), {})
    tel_bench = dict(bench_world(5e-3), **TEL_FOGS)
    jobs["telemetry bench"] = ("run", built_by(_smoke_world, dict(
        tel_bench, **TELEMETRY, **TEL_JOURNEYS)), {})
    jobs["telemetry chaos"] = ("run", built_by(_smoke_world, {
        **bench_world(5e-3), **CHAOS_BENCH, **TEL_FOGS, **TELEMETRY}), {})
    jobs["telemetry hier"] = ("run", built_by(_hier_world, _hier_kw(dict(HIER_UP, **TELEMETRY))), {})
    for variant, window in (("ring", {"arrival_window": None}), ("window", {})):
        jobs[f"tp_telemetry {variant}"] = ("tp", built_by(_smoke_world, dict(
            tel_bench, **window, **TELEMETRY, **TEL_JOURNEYS)), dict(n_shards=TP_SHARDS))
    jobs["fleet series"] = ("fleet_series", _fleet_world, {})
    jobs["fleet decisions"] = ("fleet_decisions", _fleet_world, {})
    jobs["node bench_ring"] = ("node", built_by(_smoke_world, _node_bench_kw()), {})
    jobs["node config4"] = ("node", _node_wireless_world, {})
    return jobs


def _cpu_worker_init():
    """A worker yields the host's cores to the script's process, whose
    host-bound card runs are timed."""
    import os

    import torch

    os.nice(CPU_WORKER_NICE)
    torch.set_num_threads(CPU_WORKER_THREADS)


def _cpu_reference(kind, build, kw):
    """A world's run on the CPU, in a worker: ``engine.run`` ("run"),
    ``run_tp_sharded`` ("tp"), ``engine.run`` to tick ``from_tick`` and
    on to the horizon ("split"), ``run_node_sharded`` over ``NODE_SLOTS``
    ("node"), or the fleet of ``FLEET_R`` replicas on one slot with its
    series ("fleet_series") or its ``fleet_decisions`` ("fleet_decisions").
    Returns the final state's numpy leaves (the decisions' pair), the
    split's middle state's or the series (else None) and the seconds
    taken."""
    from fognetsimpp_tpu_torch.core import engine
    from fognetsimpp_tpu_torch.parallel import (
        fleet_decisions, make_mesh, replicate_state, run_fleet_series, run_node_sharded,
    )
    from fognetsimpp_tpu_torch.random import PRNGKey, split
    from fognetsimpp_tpu_torch.state import state_to_numpy

    t0 = time.perf_counter()
    spec, st, net, b = build("cpu")
    mid = None
    if kind == "fleet_decisions":
        d, dm = fleet_decisions(spec, replicate_state(spec, st, FLEET_R, seed=0), net, b,
                                split(PRNGKey(FLEET_KEY_SEED), 2), make_mesh(1, device="cpu"))
        return [int(d), int(dm)], None, time.perf_counter() - t0
    if kind == "fleet_series":
        batch = replicate_state(spec, st, FLEET_R, seed=0)
        final, mid = run_fleet_series(dataclasses.replace(spec, record_tick_series=True), batch,
                                      net, b, make_mesh(1, device="cpu"), chunk_ticks=FLEET_CHUNK)
    elif kind == "node":
        final = run_node_sharded(spec, st, net, b,
                                 make_mesh(NODE_SLOTS, axis_name="node", device="cpu"))
    elif kind == "tp":
        from fognetsimpp_tpu_torch.parallel.taskshard import run_tp_sharded

        final = run_tp_sharded(spec, st, net, b, **kw)[1]
    elif kind == "split":
        st, _ = engine.run(spec, st, net, b, n_ticks=kw["from_tick"])
        mid = state_to_numpy(st)
        final = engine.run(spec, st, net, b, n_ticks=spec.n_ticks - kw["from_tick"])[0]
    else:
        final = engine.run(spec, st, net, b, **kw)[0]
    return state_to_numpy(final), mid, time.perf_counter() - t0


class CpuReferences:
    """The CPU references of :func:`cpu_jobs` (those of ``keys``, default
    all), queued at once on
    ``CPU_WORKERS`` spawned worker processes: ``take(key)`` waits for one
    (leaves, middle leaves, seconds) and ``builder(key)`` is its world's
    builder, for the card's run of the same world."""

    def __init__(self, keys=None):
        import concurrent.futures
        import multiprocessing

        self.jobs = {k: v for k, v in cpu_jobs().items() if keys is None or k in keys}
        self._pool = concurrent.futures.ProcessPoolExecutor(
            CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_cpu_worker_init)
        self._futures = {k: self._pool.submit(_cpu_reference, *job)
                         for k, job in self.jobs.items()}

    def builder(self, key):
        return self.jobs[key][1]

    def take(self, key):
        return self._futures.pop(key).result()

    def close(self):
        """Stops the workers, a job still running or queued included."""
        import multiprocessing

        self._pool.shutdown(wait=False, cancel_futures=True)
        for p in multiprocessing.active_children():
            p.terminate()
            p.join(30)


def phases(refs) -> int:
    """Every phase in order (see the module docstring); ``refs`` holds the
    worlds' CPU references."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

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
        cell_sum_inputs, pool_scan_inputs, smoke, wireless,
    )
    from fognetsimpp_tpu_torch.spec import Policy
    from fognetsimpp_tpu_torch.state import (
        state_from_numpy, state_to_numpy, tree_leaves, tree_map,
    )
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

    def device_us(fn, reps, names=("",), tries=6):
        """Device µs per call by kernel name, from ``torch.profiler``: the
        sum of the device events of ``reps`` calls (warm-up call first),
        over ``reps``, and the events per call by name.  Gaps between the
        launches are not counted.  A trace that holds no event named with
        one of ``names`` is taken again, up to ``tries`` traces in all, a
        second apart: the profiler on the card now and then returns no
        device events at all, three traces running.  A caller that times
        by CUDA events reads the trace only for the launches a call, and
        takes two."""
        fn()
        torch.cuda.synchronize()
        for attempt in range(tries):
            if attempt:
                time.sleep(1.0)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
        t0 = time.perf_counter()
        want = run_p()
        torch.cuda.synchronize()
        first_plain_ms = (time.perf_counter() - t0) * 1e3
        equal = same_bits(got, want)
        err = max_abs_err(got, want)
        K = inp[0].shape[0]
        if not equal:
            raise SystemExit(f"{name} at K={K}, F={F} differs from its plain version")
        # device time of the kernel's own launches, and of the plain
        # version's kernels, per call
        # each launch's mean time, summed over the call's launches: the
        # profiler now and then misses one call's events in a trace
        us_k, n_k = device_us(run_k, reps[0], OUR_KERNELS, tries=2 if by_events else 6)
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
            # one timed run of it, and its wall time is that run's; past
            # SLOW_PLAIN_MS the compared call above is that run
            plain_ms = (first_plain_ms if first_plain_ms > SLOW_PLAIN_MS
                        else stream_ms(run_p, reps[1], runs=1))
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
        """Every leaf equal; ``cpu_state`` a state or a worker's leaves."""
        paths = [p for p, _ in tree_leaves(card_state)]
        a_all = state_to_numpy(card_state)
        b_all = cpu_state if isinstance(cpu_state, list) else state_to_numpy(cpu_state)
        if len(a_all) != len(b_all):
            raise SystemExit(f"{what}: {len(a_all)} leaves on the card, {len(b_all)} on the CPU")
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
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    n_leaves = assert_same(card, refs.take("smoke")[0], "smoke")
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
        n_leaves = assert_same(card, refs.take(f"bench dt={dt}")[0], f"bench dt={dt}")
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
    n_leaves = assert_same(card, refs.take("wide_fog")[0], "wide_fog")
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
    cpu, _, check_cpu_s = refs.take("tp")
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
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    cpu, _, cpu_s = refs.take("wireless")
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = run_p()
        torch.cuda.synchronize()
        first_plain_ms = (time.perf_counter() - t0) * 1e3
        equal = same_bits([got], [want])
        err = max_abs_err([got], [want])
        lib_out = torch.zeros((A + 1,), device=dev).index_add_(0, idx, vals)[:A]
        if not equal:
            raise SystemExit(f"cell_sum_ordered ({case}) differs from its plain version")
        # each kernel and index_add_ timed by its launches' mean, as the
        # profiler now and then drops a call, summed over a call's kernels
        us_k, n_k = device_us(run_k, reps[0], CELL_KERNELS, tries=2 if by_events else 6)
        ours = [k for k in us_k if any(s in k for s in CELL_KERNELS)]
        dev_k = {k: us_k[k] / n_k[k] for k in ours}
        clock = sm_clock_mhz()  # read beside the window
        dev_l = {}
        if not by_events:  # else index_add_ is timed by CUDA events below
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
            # the card (its round count), so its wall time is its time; past
            # SLOW_PLAIN_MS the compared call above is its one timed run
            "plain_ms": (first_plain_ms if first_plain_ms > SLOW_PLAIN_MS
                         else per_call_ms(run_p, reps[1])),
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
    n_leaves = assert_same(st, refs.take("wireless_churn")[0], "wireless_churn")
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
    n_leaves = assert_same(card, refs.take("rr_grid")[0], "rr_grid")
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
    policy_launches = {}
    for name in POLICIES:
        spec, st, net, b = _policy_world(name, dev)
        engine.run(spec, st, net, b, n_ticks=REPLICA_WARM_TICKS)  # warm-up
        torch.cuda.synchronize()
        spec, st, net, b = _policy_world(name, dev)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        card, _ = engine.run(spec, st, net, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = all_launches()
        cpu, _, cpu_s = refs.take(f"policies {name}")
        n_leaves = assert_same(card, cpu, f"policies {name}")
        del cpu
        summ = summarize(card)
        spec_p, st_p, net_p, b_p = _policy_world(name, dev)
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

    def world_run(phase, need):
        """A warm-up run of the first ticks, then the timed run (every
        kernel input kept by a tap that refuses a CPU tensor) of the world
        of ``phase``'s CPU reference, every leaf equal to that.  Returns
        the spec, the card's final state, the kept calls, the launches, the
        wall, the CPU run's seconds (in its worker) and the leaves
        compared."""
        build = refs.builder(phase)
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
        cpu, _, cpu_s = refs.take(phase)
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
        build = refs.builder(phase)
        need = ("fused_arrival_plan",) + (("local_pool_scan",) if phase != "front_droptail" else ())
        spec, card, calls, launches, wall, cpu_s, n_leaves = world_run(phase, need)
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
    for phase, need in (
        ("wired_v1", ("local_pool_scan", "fused_arrival_plan")),
        ("example", ("local_pool_scan", "fused_arrival_plan", "cell_sum_ordered")),
    ):
        spec, st, net, b = refs.builder(phase)(dev)
        cpu, mid, cpu_s = refs.take(phase)
        # the card takes the CPU's state at the phase's start tick (the
        # example's idle wait for its link-up runs on the CPU only)
        from_tick = SCENARIO_FROM_TICK[phase]
        if from_tick:
            st = state_from_numpy(mid, dev)  # a checkpoint's restore
        calls = []

        def keep(name, *args):  # every scan window, read after the run
            if name == "local_pool_scan":
                calls.append((name, args))

        torch.cuda.synchronize()
        reset_launches()
        cuda_build.TAPS.append(keep)
        try:
            t0 = time.perf_counter()
            card, _ = engine.run(spec, st, net, b, n_ticks=spec.n_ticks - from_tick)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            cuda_build.TAPS.remove(keep)
        launches = all_launches()
        need_launches(phase, launches, need)
        n_leaves = assert_same(card, cpu, phase)
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
              "card_from_tick": from_tick, "wall_s": wall,
              "ms_per_tick": wall / (spec.n_ticks - from_tick) * 1e3,
              "cpu_run_s": cpu_s, "launches": launches})
        v1v2_launches[phase] = launches
        del card

    # ---- 26. chaos: the bench world under faults --------------------------
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
        build = refs.builder(phase)
        spec, card, calls, launches, wall, cpu_s, n_leaves = world_run(
            phase, ("fused_arrival_plan",))
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

    spec, st, net, b = refs.builder("chaos min_busy")(dev)
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
    for phase in ("hier", "hier_domain_down"):
        build = refs.builder(phase)
        spec, card, calls, launches, wall, cpu_s, n_leaves = world_run(
            phase, ("fused_arrival_plan",))
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
    for tel_world in ("bench", "chaos", "hier"):
        phase = f"telemetry {tel_world}"
        build = refs.builder(phase)
        spec, card, calls, launches, wall, cpu_s, n_leaves = world_run(
            phase, ("fused_arrival_plan", "cell_sum_ordered"))
        if launches["cell_sum_ordered"] != spec.n_ticks:
            raise SystemExit(f"{phase}: cell_sum_ordered launched "
                             f"{launches['cell_sum_ordered']} times in {spec.n_ticks} ticks")
        summ = tel_summaries(spec, card)
        n_acks = counted_acks(phase, int(card.telem.lat_hist.sum()))
        # the latency sums with due rows
        lat_sum_calls += [a for n, a in calls if n == "cell_sum_ordered"
                          and lat_due(a, True) > 0]
        if tel_world == "bench":
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
        elif tel_world == "chaos":
            costs = {"on": cost(spec, build), "off_same_world": cost(
                spec, lambda d: smoke.build(device=d, **{
                    **bench_world(5e-3), **CHAOS_BENCH, **TEL_FOGS}))}
        else:
            costs = {"on": cost(spec, build), "off_phase": fault_profiles["hier"]}
        emit({
            "phase": "telemetry", "world": tel_world, "policy": Policy(spec.policy).name,
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
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
        cpu, _, cpu_s = refs.take(phase)
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

    # 34-36. the live health plane and the twin: serve, serve_tp, tenants
    import os

    serve_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_cli_out", "serve")
    serve_launches, fork_launches = serve_phase(
        dev, serve_root, reset_launches, all_launches, need_launches, assert_same, smi)
    serve_tp_launches = serve_tp_phase(dev, TP_SHARDS, reset_launches, all_launches,
                                       need_launches, assert_same, smi)
    tenant_launches = tenants_phase(dev, reset_launches, all_launches, need_launches,
                                    assert_same, smi)

    # 37-39. the slot mesh: the fleet, the node-sharded entry, the group
    def first_window_row(name, args, path, flat_fogs):
        """An arrival kernel against its plain version on a path's first
        non-empty end-to-end window, a row of the kernels line."""
        r = check_arrival_kernel(name, args, flat_fogs, (10, 2, 10, 1), by_events=True)
        emit_kernel(r, f"{path}, first non-empty end-to-end window")
        kernel_rows[(name, path)] = kernel_row(r, path, "real, a slot's replicas end to end")

    def ring_row(blocks, path):
        """The ring all-gather against its plain version and ``torch.cat``
        on a path's gathered blocks, timed by CUDA events, a row of the
        kernels line."""
        want = rk.ring_all_gather_plain(blocks)
        got = rk.ring_all_gather(blocks)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"{path}: ring_all_gather differs from its plain version")
        n, (K, C) = len(blocks), blocks[0].shape
        outs = [torch.empty((n * K, C), dtype=torch.int32, device=dev) for _ in range(n)]
        n_bytes = (n * n + n) * K * C * 4
        kernel_rows[("ring_all_gather", path)] = {
            "name": "ring_all_gather", "route": "cuda", "source": SOURCES["ring_all_gather"],
            "replaces": REPLACES["ring_all_gather"], "launches": 0,
            "max_abs_err": max_abs_err(got, want),
            "ms": stream_ms(lambda: rk.ring_all_gather(blocks), 50),
            "plain_ms": stream_ms(lambda: rk.ring_all_gather_plain(blocks), 50),
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": stream_ms(lambda: [torch.cat(blocks, out=o) for o in outs], 50),
            "library": "torch.cat(blocks, out=) a shard",
            "shape": {"n": n, "K": K, "C": C}, "shape_of": path, "bound_bytes": n_bytes,
            "timed_by": "CUDA events behind a sleep kernel",
        }

    import types

    h = types.SimpleNamespace(
        reset_launches=reset_launches, all_launches=all_launches,
        need_launches=need_launches, assert_same=assert_same, smi=smi,
        first_window_row=first_window_row, ring_row=ring_row)
    fleet_launches = fleet_phase(dev, refs, h)
    node_launches = node_sharded_phase(dev, refs, h)
    multihost_launches = multihost_phase(dev, h)

    # 40-41. the sanitizer and the contracts, then the card-only tests
    # (after every timed phase: pytest's CPU work sits under none)
    checkify_launches = checkify_phase(dev, h)
    card_tests_phase(h)

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
    # the serving phases (34-36): the bench world's window served (and its
    # what-if fork, four replicas end to end), the smoke world's ring
    # under serve_tp, the tenants' smoke worlds
    by_path[("fused_arrival_plan", "bench")].update(
        serve=serve_launches["fused_arrival_plan"],
        serve_whatif_fork=fork_launches["fused_arrival_plan"],
        tenants=tenant_launches["fused_arrival_plan"])
    by_path[("cell_sum_ordered", "lat_sum")].update(
        serve=serve_launches["cell_sum_ordered"],
        serve_whatif_fork=fork_launches["cell_sum_ordered"],
        serve_tp=serve_tp_launches["cell_sum_ordered"],
        tenants=tenant_launches["cell_sum_ordered"])
    by_path[("fused_arrival_plan", "tp")]["serve_tp"] = serve_tp_launches["fused_arrival_plan"]
    by_path[("ring_all_gather", "tp")]["serve_tp"] = serve_tp_launches["ring_all_gather"]
    # the slot mesh (37-39): config 3's whole batch on one and on four
    # slots, a slot's rows alone (and the CLI's 8-replica fleet on 4
    # slots), the node-sharded
    # bench ring and config 4's single world, sharded_min_busy's gather,
    # the one-rank group's smoke batch
    key = ("pairwise_rank", "config3")
    by_path[key] = dict(kernel_rows[key]["launches_by_path"], **{
        f"fleet_{k}": fleet_launches[k]["pairwise_rank"]
        for k in ("one_slot", "four_slots", "series", "decisions")})
    if ("fused_arrival_plan", "fleet_slot_rows") in kernel_rows:
        by_path[("fused_arrival_plan", "fleet_slot_rows")] = {
            f"fleet_{k}": fleet_launches[k]["fused_arrival_plan"]
            for k in ("slot_rows", "cli")}
    by_path[("fused_arrival_plan", "tp")]["node_sharded"] = \
        node_launches["bench_ring"]["fused_arrival_plan"]
    by_path[("ring_all_gather", "tp")]["node_sharded"] = \
        node_launches["bench_ring"]["ring_all_gather"]
    for name in ("fused_arrival_plan", "cell_sum_ordered"):
        by_path[(name, "wireless")]["node_sharded"] = node_launches["config4"][name]
    by_path[("ring_all_gather", "sharded_min_busy")] = {
        "sharded_min_busy": node_launches["sharded_min_busy"]["ring_all_gather"]}
    by_path[("fused_arrival_plan", "bench")]["multihost"] = \
        multihost_launches["fused_arrival_plan"]
    # the sanitized bench run (40)
    by_path[("fused_arrival_plan", "bench")]["checkify"] = \
        checkify_launches["fused_arrival_plan"]
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    refs = CpuReferences()
    try:
        return phases(refs)
    finally:
        refs.close()


if __name__ == "__main__":
    sys.exit(main())
