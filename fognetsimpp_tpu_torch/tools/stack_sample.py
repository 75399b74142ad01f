"""Where a Python script's wall time goes: its ``main()`` run under a
sampler of the main thread's stack, then the heaviest lines.

    python3 -m fognetsimpp_tpu_torch.tools.stack_sample chip_smoke.py \\
        --out samples.json

The script is imported under its file's stem (so that worker processes
it spawns can import it too) and its ``main()`` is called; the tool exits
with its return code.  Every ``--period`` seconds a thread reads the main
thread's stack and keeps the chain of the script's own frames (function
and line, outermost first) and the innermost frame's file and function.
A sample needs the GIL, so time in C code that holds it is charged to the
line that called that code.  The report scales the samples by the run's
wall time over their count (the sampler's own work stretches the
period): the innermost script lines and the innermost functions with the
most seconds.  ``--report FILE`` prints the report of a kept file.
"""
from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import sys
import threading
import time


def sample(script: str, period: float = 0.02):
    """Runs ``script``'s ``main()`` under the sampler; returns its return
    code and ``{"wall": s, "samples": [[chain, leaf, count], ...]}``."""
    path = os.path.abspath(script)
    sys.path.insert(0, os.path.dirname(path))
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)

    main_id = threading.get_ident()
    counts = collections.Counter()
    stop = threading.Event()

    def run():
        while not stop.wait(period):
            f = sys._current_frames().get(main_id)
            chain, leaf = [], None
            while f is not None:
                code = f.f_code
                if leaf is None:
                    leaf = f"{os.path.basename(code.co_filename)}:{code.co_name}"
                if os.path.abspath(code.co_filename) == path:
                    chain.append(f"{code.co_name}:{f.f_lineno}")
                f = f.f_back
            counts[(tuple(reversed(chain)), leaf)] += 1

    th = threading.Thread(target=run, name="stack-sampler", daemon=True)
    t0 = time.perf_counter()
    th.start()
    try:
        rc = mod.main()
    finally:
        stop.set()
        th.join(5)
    out = {"script": script, "period": period, "wall": time.perf_counter() - t0,
           "samples": [[list(c), leaf, n] for (c, leaf), n in counts.items()]}
    return rc, out


def report(data: dict, top: int = 25) -> str:
    """The innermost script lines and innermost functions with the most
    seconds, one per line."""
    total = sum(n for _, _, n in data["samples"]) or 1
    scale = data["wall"] / total
    by_line, by_leaf = collections.Counter(), collections.Counter()
    for chain, leaf, n in data["samples"]:
        by_line[chain[-1] if chain else "(outside the script)"] += n
        by_leaf[leaf] += n
    rows = [f"wall {data['wall']:.1f} s, {total} samples"]
    for title, counter in (("script lines", by_line), ("functions", by_leaf)):
        rows.append(f"-- {title}")
        rows += [f"{n * scale:9.1f} s  {k}" for k, n in counter.most_common(top)]
    return "\n".join(rows)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("script", nargs="?")
    p.add_argument("--out", help="write the samples here as JSON")
    p.add_argument("--period", type=float, default=0.02)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--report", help="print the report of a kept samples file")
    a = p.parse_args(argv)
    if a.report:
        with open(a.report) as f:
            print(report(json.load(f), a.top))
        return 0
    if not a.script:
        p.error("name a script, or --report FILE")
    rc, data = sample(a.script, a.period)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(data, f)
    print(report(data, a.top), file=sys.stderr)
    return rc or 0


if __name__ == "__main__":
    sys.exit(main())
