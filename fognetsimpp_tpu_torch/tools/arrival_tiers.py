"""Time the arrival kernels' direct-count tier against the radix sort.

    python3 -m fognetsimpp_tpu_torch.tools.arrival_tiers

The sort kernel of ``csrc/arrival_plan.cu`` ranks a bucket of 33 to
``kDirect`` keys by a direct count in shared memory and is done; a larger
bucket goes through the block radix sort and the rank kernel.  This script
builds ``arrival_plan.cu`` once for each bound in :data:`DIRECT_BOUNDS`
(``-DFNS_ARRIVAL_DIRECT=n``; 32 sends every such bucket to the radix
sort), runs the ``fns_fused_arrival_plan`` entry point of each on the same
card windows (the wrapper's arguments and scratch), holds each bit for bit
against the plain version, and prints one JSON line a window: the device
time of a call of each build (``torch.profiler``: each launch's mean over
``REPS`` calls, summed over the launches), taken in the order of the
bounds and then back.  Then the card's name and power limit as
``nvidia-smi`` prints them.  Without a CUDA device it prints nothing and
exits 2.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..ops import arrival_kernels as ak
from ..ops import cuda_build

#: Calls a profiled run of one build on one window.
REPS = 50
#: The builds' bounds on the direct count: off (kTiny), the source's
#: default (one key a thread of the sort block), two keys a thread.
DIRECT_BOUNDS = (32, 256, 512)
#: The five launches of a call, by kernel name.
LAUNCH_NAMES = (
    "arrival_init_kernel", "arrival_pass_kernel", "arrival_scatter_kernel",
    "arrival_sort_kernel", "arrival_rank_kernel",
)
_VP, _CI = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_VP, _VP, _VP, _CI, _CI, _CI, _VP, _VP, _VP, _VP, _VP, _VP, _VP]

#: (name, K, F, masked rows all in one fog, or None for 70 % masked with
#: fogs drawn uniformly: 32 buckets of about 90).  409 and 47 rows: the
#: bench world's two non-empty windows at dt 1 ms, each in one fog.
WINDOWS = [
    ("uniform", 4096, 32, None),
    ("one_fog_47", 4096, 32, 47),
    ("one_fog_160", 4096, 32, 160),
    ("one_fog_256", 4096, 32, 256),
    ("one_fog_409", 4096, 32, 409),
    ("one_fog_512", 4096, 32, 512),
]


def _build(direct: int) -> str:
    """Start building ``arrival_plan.cu`` alone with ``kDirect = direct``;
    returns the library's path once it is linked."""
    src = os.path.join(cuda_build.CSRC, "arrival_plan.cu")
    out = cuda_build.library_path().replace(
        "libfns_kernels_", f"libfns_arrival_direct{direct}_"
    )
    if not os.path.exists(out):
        os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
        obj = f"{out}.{os.getpid()}.o"
        cmd = cuda_build._compile_command(src, obj) + [f"-DFNS_ARRIVAL_DIRECT={direct}"]
        for step in (cmd, [cuda_build._nvcc(), "-shared", "-o", out, obj]):
            done = subprocess.run(step, capture_output=True, text=True, check=False)
            if done.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
        os.remove(obj)
    return out


def _entry(path: str):
    fn = ctypes.CDLL(path).fns_fused_arrival_plan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _plan_with(fn, mask, f_key, t_key, F):
    """``fused_arrival_plan`` through the entry point ``fn``."""
    K, dev = mask.shape[0], mask.device
    b = ak._bucket_bits(K, F)
    rank = torch.empty((K,), dtype=torch.int32, device=dev)
    counts = torch.empty((F,), dtype=torch.int32, device=dev)
    t_min = torch.empty((F,), dtype=torch.float32, device=dev)
    first = torch.empty((F,), dtype=torch.int32, device=dev)
    words, keys = ak._scratch(K, b, F, dev)
    err = fn(
        mask.data_ptr(), f_key.data_ptr(), t_key.data_ptr(), K, F, b,
        rank.data_ptr(), counts.data_ptr(), t_min.data_ptr(), first.data_ptr(),
        words.data_ptr(), keys.data_ptr(), cuda_build.stream_of(dev),
    )
    cuda_build.raise_on(err, "fused_arrival_plan")
    return rank, counts, t_min, first


def _window(K, F, n_masked, seed, dev):
    rng = np.random.default_rng(seed)
    if n_masked is None:
        mask = rng.random(K) < 0.7
        fog = rng.integers(0, F, K).astype(np.int32)
        t = np.round(rng.random(K) * 0.01, 4).astype(np.float32)
    else:  # one tick's 5 ms band, as in the main path's windows
        mask = np.zeros(K, bool)
        mask[rng.permutation(K)[:n_masked]] = True
        fog = np.full(K, F // 2, np.int32)
        t = (0.05 + rng.random(K) * 0.005).astype(np.float32)
    f_key = np.where(mask, fog, F).astype(np.int32)
    t_key = np.where(mask, t, np.inf).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (mask, f_key, t_key)]


def _device_us(call):
    """(device µs a call, µs by launch): each launch's mean time, summed."""
    call()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then returns no device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                call()
            torch.cuda.synchronize()
        us, n = {}, {}
        for ev in prof.events():
            if not str(ev.device_type).endswith("CUDA"):
                continue
            for name in LAUNCH_NAMES:
                if name in ev.name:
                    us[name] = us.get(name, 0.0) + float(ev.time_range.elapsed_us())
                    n[name] = n.get(name, 0) + 1
        if us:
            by_launch = {k: us[k] / n[k] for k in us}
            return sum(by_launch.values()), by_launch
    raise SystemExit("the profiler saw no arrival kernel")


def _same_bits(got, want):
    return all(
        torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want)
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("arrival_tiers: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    with ThreadPoolExecutor(len(DIRECT_BOUNDS)) as pool:  # one nvcc a build
        paths = list(pool.map(_build, DIRECT_BOUNDS))
    entries = {d: _entry(p) for d, p in zip(DIRECT_BOUNDS, paths)}
    order = DIRECT_BOUNDS + DIRECT_BOUNDS[::-1]
    for name, K, F, n_masked in WINDOWS:
        inp = _window(K, F, n_masked, seed=K + F + (n_masked or 0), dev=dev)
        want = ak.fused_arrival_plan_plain(*inp, F)
        for d, fn in entries.items():
            got = _plan_with(fn, *inp, F)
            torch.cuda.synchronize()
            if not _same_bits(got, want):
                raise SystemExit(f"the kDirect = {d} build differs on {name}")
        times = {d: [] for d in DIRECT_BOUNDS}
        sort_us = {d: [] for d in DIRECT_BOUNDS}
        for d in order:
            us, by_launch = _device_us(lambda fn=entries[d]: _plan_with(fn, *inp, F))
            times[d].append(us)
            sort_us[d].append(by_launch.get("arrival_sort_kernel", 0.0))
        print(json.dumps({
            "window": name, "K": K, "F": F, "masked_rows": int(inp[0].sum()),
            "largest_bucket": int(torch.unique(
                inp[1][inp[0]], return_counts=True)[1].max()),
            "equal": True,
            "device_us_by_direct_bound": {str(d): v for d, v in times.items()},
            "sort_kernel_us_by_direct_bound": {str(d): v for d, v in sort_us.items()},
        }), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
