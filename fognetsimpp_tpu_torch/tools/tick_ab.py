"""Wall time per tick of the bench world under two trees of the port, in
turns.

    python3 -m fognetsimpp_tpu_torch.tools.tick_ab ROOT_A ROOT_B

Each ROOT is a checkout that holds ``fognetsimpp_tpu_torch`` (for example
this tree and a ``git archive`` of its parent).  Each run is a process of
its own with ROOT first on the import path, so it runs that tree's engine
and builds that tree's kernels.  The trees take turns, A B B A in each
of two rounds (``tools/ab.py``), so that a drift of the host during the
call falls on both.  A run builds the world on the card, runs it once as
a warm-up, then times ``engine.run`` three times; it prints one JSON line
with the tree, each rep's ms per tick and the device events of one
profiled tick after the timed reps, then the medians and spreads.  The world is ``chip_smoke.py``'s bench world at
dt 5 ms (10,000 users x 32 fogs, K = 4096, derive_acks, 20 ticks).
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys

from ..scenarios.pool_scan_inputs import BENCH5
from . import ab

REPS = 3

#: What a run executes, with the tree's root first on ``sys.path``.
_CHILD = r"""
import json, sys, time
import torch
from torch.profiler import ProfilerActivity, profile
from fognetsimpp_tpu_torch.core import engine
from fognetsimpp_tpu_torch.scenarios import smoke
kw = json.loads(sys.argv[1])
reps = int(sys.argv[2])
dev = torch.device("cuda")
spec, st, net, b = smoke.build(device=dev, **kw)
engine.run(spec, st, net, b)
torch.cuda.synchronize()
ms = []
for _ in range(reps):
    spec, st, net, b = smoke.build(device=dev, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, _ = engine.run(spec, st, net, b)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) / spec.n_ticks * 1e3)
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    engine.run(spec, final, net, b, n_ticks=1)
    torch.cuda.synchronize()
events = sum(1 for ev in prof.events() if str(ev.device_type).endswith("CUDA"))
print(json.dumps({"ms_per_tick": ms, "device_events_one_tick": events,
                  "n_scheduled": int(final.metrics.n_scheduled)}))
"""


def run_tree(root: str) -> dict:
    return ab.run_child(root, _CHILD, [json.dumps(BENCH5), str(REPS)], root)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs=2, help="the two trees, A then B")
    roots = ap.parse_args().roots
    by_tree = {root: {"ms_per_tick": []} for root in roots}
    for root, rnd, r in ab.in_turns(roots, run_tree):
        by_tree[root]["ms_per_tick"] += r["ms_per_tick"]
        print(json.dumps({"tree": root, "round": rnd, **r}), flush=True)
    print(json.dumps(ab.summary(by_tree, "ms")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
