"""The repo's benchmark configurations (``benchmarks.py``) on the port, on the card.

The same worlds from the same arguments as the root ``benchmarks.py``,
one JSON line a config:

  2. 100-node grid, ROUND_ROBIN, one replica
  3. 1k-node world, MIN_LATENCY, 64 replicas
  4. 10k-node mobile-handover world (APs, moving users, energy churn),
     ENERGY_AWARE, 128 replicas (``CONFIG4_R``, ``CONFIG4_HORIZON``,
     ``CONFIG4_CHUNK`` as there)
  5. policy × load sweep, 10k users × 4 policies × 256 load levels in
     chunks of 32; ``5b`` the same grid with ``Policy.DYNAMIC``, one batch
     a chunk

Configs 2-4: one warm-up run, then three runs rekeyed 1, 2, 3 (config
4: ``1000 + c``), timed on the host clock with one trailing sync; each
run's own seconds are printed beside the total (``runs_s``; the last
holds the sync), so the spread shows.  Config 5: the first chunk's
first batch as the warm-up, then the whole sweep timed once, the
worlds' builds included as JAX's compiles are, each chunk's seconds in
``runs_s``.  A decision is a scheduled task (``metrics.n_scheduled``).

Run on a CUDA card: ``python -m fognetsimpp_tpu_torch.benchmarks [2 3 4 5 5b]``
(default 2 3 4 5).  It writes no ``BENCHMARK.json``.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from .core.engine import run, run_batched
from .parallel.replicas import replicate_state, strict_vmap
from .parallel.sweep import policy_batches
from .random import PRNGKey, split
from .scenarios import smoke, wireless
from .spec import Policy

#: Config 5's policies (``benchmarks.py::config5``).
CONFIG5_POLICIES = (Policy.MIN_BUSY, Policy.ROUND_ROBIN, Policy.MIN_LATENCY,
                    Policy.ENERGY_AWARE)


def config2_world(device=None):
    """``benchmarks.py::config2``: 96 users × 4 fogs, ROUND_ROBIN, 1 s of 1 ms ticks."""
    return smoke.build(
        n_users=96, n_fogs=4, policy=int(Policy.ROUND_ROBIN),
        send_interval=0.01, horizon=1.0, dt=1e-3,
        max_sends_per_user=104, arrival_window=1024, device=device,
    )


def config3_world(device=None):
    """``benchmarks.py::config3``'s world: 1,000 users × 24 fogs,
    MIN_LATENCY, K = 256, 0.25 s of 1 ms ticks, starts within 50 ms."""
    return smoke.build(
        n_users=1000, n_fogs=24, policy=int(Policy.MIN_LATENCY),
        send_interval=0.01, horizon=0.25, dt=1e-3,
        max_sends_per_user=29, arrival_window=256,
        start_time_max=0.05, device=device,
    )


def config4_world(horizon: float = 0.5, device=None):
    """``benchmarks.py::config4``'s world: ``wireless5`` at 10,000 users,
    64 APs, the Bianchi MAC, ENERGY_AWARE, 5 ms ticks, the spec's own
    arrival window."""
    kw = dict(
        numb_users=10_000, horizon=horizon, dt=5e-3,
        policy=int(Policy.ENERGY_AWARE), send_interval=0.05,
        queue_capacity=64, extra_aps=59, mac_model="bianchi",
    )
    spec0 = wireless.wireless5(device="cpu", **kw)[0]
    return wireless.wireless5(
        arrival_window=spec0.auto_arrival_window, device=device, **kw
    )


def config5_loads(n_loads: int = 256):
    """Config 5's publish intervals, lightest last (``np.geomspace``)."""
    return list(np.geomspace(0.01, 0.16, n_loads))


def config5_build_kw(n_users: int = 10_000, n_loads: int = 256, device=None) -> dict:
    """``benchmarks.py::config5``'s builder arguments: 32 fogs, K = 4,096,
    0.25 s of 5 ms ticks, the send budget of the heaviest load."""
    loads = config5_loads(n_loads)
    horizon = 0.25
    return dict(
        n_users=n_users, n_fogs=32, horizon=horizon, dt=5e-3,
        send_interval=min(loads), max_sends_per_user=int(horizon / min(loads)) + 4,
        arrival_window=4096, queue_capacity=64, start_time_max=0.05,
        device=device,
    )


def _decisions(metrics) -> int:
    """Scheduled tasks of a run's (batched) metrics; reading them syncs."""
    return int(metrics.n_scheduled.sum().item())


def _timed(go, warm, args):
    """``go(warm)`` once, then ``go`` on each of ``args`` with one trailing
    sync: ``(wall seconds, outputs, each run's seconds)``; the last run's
    seconds hold the sync, which reading the outputs' counts makes."""
    _decisions(go(warm)[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks, outs = [], []
    for a in args:
        outs.append(go(a))
        marks.append(time.perf_counter())
    _decisions(outs[-1][0])
    marks[-1] = time.perf_counter()
    runs = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    return marks[-1] - t0, outs, runs


def _emit(name, wall, decisions, ticks, runs, extra=None) -> None:
    out = {
        "config": name,
        "wall_s": round(wall, 3),
        "decisions": int(decisions),
        "decisions_per_sec": round(decisions / wall, 1),
        "ticks_per_sec": round(ticks / wall, 1),
        "runs_s": [round(r, 3) for r in runs],
        "device": torch.cuda.get_device_name(0),
    }
    out.update(extra or {})
    print(json.dumps(out), flush=True)


def config2() -> None:
    spec, state, net, bounds = config2_world()
    dev = state.t.device
    wall, outs, runs = _timed(
        lambda s: (run(spec, s, net, bounds)[0].metrics,), state,
        [state.replace(key=PRNGKey(i, dev)) for i in (1, 2, 3)],
    )
    dec = sum(_decisions(m) for m, in outs)
    _emit("2:100-node-grid-rr", wall, dec, spec.n_ticks * 3, runs)


def config3() -> None:
    R = 64
    spec, state, net, bounds = config3_world()
    batch = replicate_state(spec, state, R, seed=0)
    dev = state.t.device
    wall, outs, runs = _timed(
        lambda b: (run_batched(spec, b, net, bounds)[0].metrics,), batch,
        [batch.replace(key=split(PRNGKey(i, dev), R)) for i in (1, 2, 3)],
    )
    dec = sum(_decisions(m) for m, in outs)
    _emit("3:1k-node-minlat-64rep", wall, dec, spec.n_ticks * R * 3, runs,
          {"replicas": R})


def config4() -> None:
    """The chunks of ``CONFIG4_R`` replicas, three times, each rekeyed
    ``1000 + c`` as ``benchmarks.py`` keys its chunks."""
    R = int(os.environ.get("CONFIG4_R", 128))
    horizon = float(os.environ.get("CONFIG4_HORIZON", 0.5))
    chunk = min(R, int(os.environ.get("CONFIG4_CHUNK", 250)))
    n_chunks = -(-R // chunk)
    R = chunk * n_chunks
    spec, state, net, bounds = config4_world(horizon)
    batch = replicate_state(spec, state, chunk, seed=0)
    dev = state.t.device

    def go(b):
        fs = run_batched(spec, b, net, bounds)[0]
        return fs.metrics, fs.nodes.alive.sum(dim=1, dtype=torch.int32)

    wall, outs, runs = _timed(go, batch, [
        batch.replace(key=split(PRNGKey(1000 + c, dev), chunk))
        for c in range(3 * n_chunks)
    ])
    _emit(f"4:10k-mobile-energy-{R}rep", wall, sum(_decisions(m) for m, _ in outs),
          spec.n_ticks * R * 3, runs,
          {"replicas": R, "chunk": chunk, "n_chunks": n_chunks,
           "arrival_window": spec.window,
           "n_deferred_max": max(int(m.n_deferred_max.max()) for m, _ in outs),
           "alive_min": min(int(a.min()) for _, a in outs),
           "peak_gib": round(torch.cuda.max_memory_allocated() / 2 ** 30, 3)})


def config5(dynamic: bool = False, n_users: int = 10_000, n_loads: int = 256,
            chunk: int = 32) -> None:
    loads = config5_loads(n_loads)
    kw = config5_build_kw(n_users, n_loads)
    pols = [int(p) for p in CONFIG5_POLICIES]

    def batches(c0):
        return policy_batches(smoke.build, pols, loads[c0: c0 + chunk],
                              dynamic=dynamic, **kw)

    # warm-up: the first batch of the first chunk
    _, spec, batch, net, bounds = next(iter(batches(0)))
    _decisions(run_batched(spec, batch, net, bounds)[0].metrics)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decisions, runs, mark = 0, [], t0
    for c0 in range(0, len(loads), chunk):
        for _, spec, batch, net, bounds in batches(c0):
            decisions += _decisions(run_batched(spec, batch, net, bounds)[0].metrics)
        now = time.perf_counter()
        runs.append(now - mark)
        mark = now
    wall = mark - t0  # the worlds' builds included, as JAX's compiles are
    n_ticks = spec.n_ticks * len(pols) * len(loads)
    name = "5b:policy-sweep-dynamic" if dynamic else "5:policy-x-load-sweep"
    _emit(name, wall, decisions, n_ticks, runs,
          {"grid": f"{n_users} users x {len(pols)} policies x {len(loads)} "
                   "loads x 1 replicas",
           "chunk": chunk,
           "peak_gib": round(torch.cuda.max_memory_allocated() / 2 ** 30, 3)})


CONFIGS = {"2": config2, "3": config3, "4": config4, "5": config5,
           "5b": lambda: config5(dynamic=True)}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("benchmarks: no CUDA device; the benchmark runs on the card",
              file=sys.stderr)
        return 1
    with strict_vmap():
        for name in argv or ["2", "3", "4", "5"]:
            CONFIGS[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
