"""Device time of ``local_pool_scan`` under two or more trees, in turns.

    python3 -m fognetsimpp_tpu_torch.tools.pool_scan_ab ROOT_A ROOT_B [ROOT ...]

Each ROOT is a checkout that holds ``fognetsimpp_tpu_torch`` (for example
a ``git archive`` of the parent under ``_ab/parent`` and this tree,
``.``).  This process builds the cases once, with this tree's code on the
card (``scenarios.pool_scan_inputs``): the first real windows of the bench
world's v1 and v2 variants, kept by a tap as ``chip_smoke.py`` keeps
them; dense windows (a pool of 1e9: every valid row taken, v1 and v2);
a v2 window whose timer fires at its middle row; a window with no valid
row (the walk without a candidate: the launch, the copies and the tests
of every stage); 8 and 128 replicas of the v2 window in one launch; and
the plain version's result on each.  Each run is a process of its own
(``tools/ab.py``): it builds that tree's ``pool_scan.cu`` alone and calls
its C entry point ``fns_local_pool_scan``, checks each result bit for bit
against the plain version's, and times each case and an empty launch
(the floor) with ``ab.stream_ms``.  The trees take turns, forward then
back in each of two rounds.  It prints one JSON line a run, then the
medians by tree and case, each tree over the first, the card's name and
power limit (``nvidia-smi``) and its SM clock.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

from . import ab

#: Back-to-back calls a timed run, and timed runs a case (their median).
REPS, RUNS = 100, 5
#: Rows of the synthetic windows: the bench world's window.
K_SYNTH = 4096


#: What a run executes, with the tree's root first on ``sys.path``.
_CHILD = r"""
import ctypes, importlib.util, json, os, subprocess, sys
import numpy as np
import torch
from fognetsimpp_tpu_torch.ops import cuda_build
data = np.load(sys.argv[1])
names = json.loads(sys.argv[2])
reps, runs = json.loads(sys.argv[3])
spec = importlib.util.spec_from_file_location("fns_ab", sys.argv[4])
ab = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ab)
src = os.path.join(cuda_build.CSRC, "pool_scan.cu")
out = cuda_build.library_path().replace("libfns_kernels_", "libfns_pool_scan_")
if not os.path.exists(out):
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    obj = f"{out}.{os.getpid()}.o"
    for step in (cuda_build._compile_command(src, obj),
                 [cuda_build._nvcc(), "-shared", "-o", out, obj]):
        done = subprocess.run(step, capture_output=True, text=True, check=False)
        if done.returncode != 0:
            raise SystemExit(f"nvcc failed:\n{done.stdout}{done.stderr}")
    os.remove(obj)
fn = ctypes.CDLL(out).fns_local_pool_scan
fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
fn.restype = ctypes.c_int
dev = torch.device("cuda")
stream = torch.cuda.current_stream(dev).cuda_stream

def timed(call):
    return ab.stream_ms(call, reps, runs) * 1e3

res = {"launch_floor_us": timed(lambda: torch.cuda._sleep(0))}
for k, name in enumerate(names):
    rows = [torch.from_numpy(data[f"{k}_{i}"]).to(dev) for i in range(6)]
    v2 = int(data[f"{k}_v2"])
    R, K = rows[0].shape
    take = torch.empty((R, K), dtype=torch.bool, device=dev)
    pool = torch.empty((R,), dtype=torch.float32, device=dev)
    fired = torch.empty((R,), dtype=torch.bool, device=dev)
    def call():
        err = fn(*[x.data_ptr() for x in rows], K, R, v2, take.data_ptr(),
                 pool.data_ptr(), fired.data_ptr(), stream)
        if err:
            raise SystemExit(f"{name}: launch failed, cudaError {err}")
    call()
    torch.cuda.synchronize()
    equal = all(
        g.cpu().numpy().tobytes() == data[f"{k}_want{i}"].tobytes()
        for i, g in enumerate((take, pool, fired)))
    res[name] = {"equal": equal, "device_us": timed(call)}
print(json.dumps(res))
"""


def run_tree(root: str, data: str, names: list) -> dict:
    return ab.run_child(root, _CHILD, [data, json.dumps(names), json.dumps([REPS, RUNS]),
                                       ab.PATH], root)


def cases(dev) -> list:
    """``(name, rows, v2)``: the windows every tree is timed on."""
    import torch

    from ..scenarios import pool_scan_inputs as inputs

    def synth(kind):
        return [torch.from_numpy(np.asarray(a)).to(dev)
                for a in inputs.rows(kind, 1, K_SYNTH, seed=len(kind))]

    v1 = inputs.bench_window("v1_bench", dev)
    v2 = inputs.bench_window("v2_bench", dev)
    return [
        ("v1 first real window", v1, False),
        ("v2 first real window", v2, True),
        ("dense v1", synth("dense"), False),
        ("dense v2", synth("dense"), True),
        ("timer fires mid-window v2", synth("timer_fire"), True),
        ("all rows invalid v1", synth("all_invalid"), False),
        ("8 replicas v2", inputs.replicas(v2, 8), True),
        ("128 replicas v2", inputs.replicas(v2, 128), True),
    ]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="two or more trees")
    roots = ap.parse_args().roots
    if len(roots) < 2 or len(set(roots)) != len(roots):
        ap.error("give two or more distinct trees")
    import torch

    from ..ops import pool_kernels as pk

    if not torch.cuda.is_available():
        print("pool_scan_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    todo = cases(dev)
    names = [c[0] for c in todo]
    by_tree = {root: {nm: [] for nm in names + ["launch_floor_us"]} for root in roots}
    shapes = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "cases.npz")
        arrays = {}
        for k, (name, rows, v2) in enumerate(todo):
            want = pk.local_pool_scan_plain(*rows, v2)
            arrays.update({f"{k}_{i}": x.cpu().numpy() for i, x in enumerate(rows)})
            arrays.update({f"{k}_want{i}": w.cpu().numpy() for i, w in enumerate(want)})
            arrays[f"{k}_v2"] = np.int64(v2)
            shapes[name] = {
                "R": int(rows[0].shape[0]), "K": int(rows[0].shape[1]),
                "valid_rows": int(rows[1].sum()), "takes": int(want[0].sum()),
                "fires": int(want[2].sum()),
                "most_events_a_world": int((want[0].sum(dim=1) + want[2]).max()),
                # groups of 32 rows (a warp's ballot) that hold a take
                "groups_with_takes": int(torch.nn.functional.pad(
                    want[0], (0, -want[0].shape[1] % 32)).view(
                        want[0].shape[0], -1, 32).any(dim=2).sum()),
            }
        np.savez(data, **arrays)
        print(json.dumps({"cases": shapes, "nvidia_smi": ab.smi("name,power.limit")}),
              flush=True)
        for root, rnd, r in ab.in_turns(roots, lambda root: run_tree(root, data, names)):
            for nm in names:
                if not r[nm]["equal"]:
                    raise SystemExit(f"{root}: {nm} differs from the plain version")
                by_tree[root][nm].append(r[nm]["device_us"])
            by_tree[root]["launch_floor_us"].append(r["launch_floor_us"])
            print(json.dumps({"tree": root, "round": rnd,
                              "clocks_sm": ab.smi("clocks.sm"), **r}), flush=True)
    print(json.dumps({
        **ab.summary(by_tree, "device_us"),
        "nvidia_smi": ab.smi("name,power.limit"), "clocks_sm": ab.smi("clocks.sm"),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
