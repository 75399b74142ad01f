"""Device time of ``cell_sum_ordered`` under two arms, in turns.

    python3 -m fognetsimpp_tpu_torch.tools.cell_sum_ab ARM_A ARM_B [--sweep]

An arm is ``ROOT`` or ``ROOT@TIER``.  ROOT is a checkout that holds
``fognetsimpp_tpu_torch`` (for example a ``git archive`` of the parent
under ``_ab/parent`` and this tree, ``.``); TIER, ``one_block`` or
``segments``, makes that tree's wrapper take that tier on every input
(trees with ``cell_kernels.ONE_BLOCK_MAX_TILES`` only).  This process
builds the inputs once, with this tree's code: by default the cases of
``chip_smoke.py``'s kernel phase (``scenarios.cell_sum_inputs.kernel_cases``,
built from the wireless world's tick-0 input, stepped once on the card),
with ``--sweep`` the shapes around the tiers' crossover
(``cell_sum_inputs.sweep_cases``); and the plain version's result on each.
Each run is a process of its own with ROOT first on the import path, so it
builds and launches that tree's kernel; the arms take turns, A B B A in
each of two rounds (``tools/ab.py``), so that a drift of the card during
the call falls on both.  A run checks each result bit for bit against the plain version's
and times each case: the device time of a call (each kernel's mean over
the launches ``torch.profiler`` traced, summed over the call's kernels)
and the time of a call between two CUDA events around back-to-back calls.
It prints one JSON line a run, then the medians by arm and case, B's
over A's, the card's name and power limit (``nvidia-smi``) and its SM clock.  Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

from . import ab

#: Calls timed a run, by case: a kernel that reads all entries a cell
#: takes milliseconds at 128 replicas.
REPS = {"128 replicas": 5}
DEFAULT_REPS = 20
#: ``ONE_BLOCK_MAX_TILES`` that forces each tier.
FORCE = {"one_block": 2 ** 62, "segments": -1}


#: What a run executes, with the tree's root first on ``sys.path``.
_CHILD = r"""
import json, re, sys
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from fognetsimpp_tpu_torch.ops import cell_kernels as ck
data = np.load(sys.argv[1])
names, reps = json.loads(sys.argv[2]), json.loads(sys.argv[3])
if sys.argv[4] != "null":
    assert hasattr(ck, "ONE_BLOCK_MAX_TILES"), "this tree has one tier"
    ck.ONE_BLOCK_MAX_TILES = json.loads(sys.argv[4])
dev = torch.device("cuda")
res = {}
for k, name in enumerate(names):
    cell = torch.from_numpy(data[f"cell{k}"]).to(dev)
    vals = torch.from_numpy(data[f"vals{k}"]).to(dev)
    A = int(data[f"A{k}"])
    run = lambda: ck.cell_sum_ordered(cell, vals, A)
    got = run()
    torch.cuda.synchronize()
    equal = got.cpu().numpy().tobytes() == data[f"want{k}"].tobytes()
    n = reps[name]
    run()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then returns no device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                run()
            torch.cuda.synchronize()
        us, cnt = {}, {}
        for ev in prof.events():
            if str(ev.device_type).endswith("CUDA") and "cell_sum" in ev.name:
                us[ev.name] = us.get(ev.name, 0.0) + float(ev.time_range.elapsed_us())
                cnt[ev.name] = cnt.get(ev.name, 0) + 1
        if us:
            break
    else:
        raise SystemExit(f"{name}: the profiler saw no device time of the kernel")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        run()
    b.record()
    torch.cuda.synchronize()
    res[name] = {
        "equal": equal,
        "device_us": sum(us[e] / cnt[e] for e in us),
        "device_us_by_kernel": {re.search(r"cell_sum_\w+", e).group(0): us[e] / cnt[e]
                                for e in us},
        "launches_traced_a_call": sum(cnt.values()) / n,
        "event_us": a.elapsed_time(b) / n * 1e3,
    }
print(json.dumps(res))
"""


def run_arm(arm: str, data: str, names: list, reps: dict) -> dict:
    root, _, tier = arm.partition("@")
    return ab.run_child(root, _CHILD, [data, json.dumps(names), json.dumps(reps),
                                       json.dumps(FORCE[tier] if tier else None)], arm)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arms", nargs=2, help="the two arms, A then B: ROOT or ROOT@TIER")
    ap.add_argument("--sweep", action="store_true",
                    help="time the shapes around the tiers' crossover")
    args = ap.parse_args()
    a, b = args.arms
    for arm in args.arms:
        if arm.partition("@")[2] not in ("", *FORCE):
            ap.error(f"{arm}: TIER is one of {sorted(FORCE)}")
    import torch

    from ..ops import cell_kernels as ck
    from ..scenarios import cell_sum_inputs as inputs

    if not torch.cuda.is_available():
        print("cell_sum_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cases = (inputs.sweep_cases() if args.sweep
             else inputs.kernel_cases(*inputs.tick0_input(dev)))
    names = [c[0] for c in cases]
    reps = {nm: REPS.get(nm, DEFAULT_REPS) for nm in names}
    by_arm = {a: {nm: [] for nm in names}, b: {nm: [] for nm in names}}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "cases.npz")
        arrays = {}
        for k, (_, cell, vals, A) in enumerate(cases):
            want = ck.cell_sum_ordered_plain(
                torch.from_numpy(cell).to(dev), torch.from_numpy(vals).to(dev), A)
            arrays.update({f"cell{k}": cell, f"vals{k}": vals,
                           f"A{k}": np.int64(A), f"want{k}": want.cpu().numpy()})
        np.savez(data, **arrays)
        print(json.dumps({"cases": {nm: {"N": int(c.shape[0]), "A": int(A)}
                                    for nm, c, _, A in cases},
                          "nvidia_smi": ab.smi("name,power.limit")}), flush=True)
        for arm, rnd, r in ab.in_turns((a, b), lambda arm: run_arm(arm, data, names, reps)):
            for nm in names:
                if not r[nm]["equal"]:
                    raise SystemExit(f"{arm}: {nm} differs from the plain version")
                by_arm[arm][nm].append(r[nm]["device_us"])
            print(json.dumps({"arm": arm, "round": rnd,
                              "clocks_sm": ab.smi("clocks.sm"), **r}), flush=True)
    print(json.dumps({
        **ab.summary(by_arm, "device_us"), "nvidia_smi": ab.smi("name,power.limit"),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
