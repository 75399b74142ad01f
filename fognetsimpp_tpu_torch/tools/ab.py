"""What the A/B tools share: arms run in turns, each in a process of its
own, the card's name, limit and clock, the medians, and a timer of the
card's work.

An arm's run is ``python -c CHILD ARGS...`` with the arm's tree first on
the import path (:func:`run_child`), so it builds and launches that
tree's code; its last line of output is one JSON object.  The arms take
turns forward then back (A B B A for two) in each of ``rounds`` rounds
(:func:`in_turns`), so that a drift of the card or the host during the
call falls on all.  :func:`stream_ms` times a call's device work by CUDA
events around back-to-back calls queued behind a sleep kernel.  This
module imports only the standard library at its top, so a child can load
it by its path (:data:`PATH`) whatever the arm's tree holds.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
from typing import Callable, Dict, Iterator, List, Sequence, Tuple

#: This file, for a child to load by :func:`importlib.util.spec_from_file_location`.
PATH = os.path.abspath(__file__)
#: Rounds of turns.
ROUNDS = 2
#: Cycles of the sleep kernel that holds the stream while the host queues
#: the calls :func:`stream_ms` times (about 25 ms at the H100's boost clock).
SLEEP_CYCLES = 50_000_000


def smi(query: str) -> str:
    """``nvidia-smi --query-gpu=QUERY`` for the first card."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def run_child(root: str, child: str, args: Sequence[str], what: str) -> dict:
    """Run ``child`` in ``root`` with that tree first on the import path;
    the JSON object on its last line.  Exits naming ``what`` if it fails."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    out = subprocess.run(
        [sys.executable, "-c", child, *args],
        cwd=os.path.abspath(root), env=env, capture_output=True, text=True,
    )
    if out.returncode != 0:
        raise SystemExit(f"run of {what} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def in_turns(arms: Sequence[str], run: Callable[[str], dict],
             rounds: int = ROUNDS) -> Iterator[Tuple[str, int, dict]]:
    """``(arm, round, run(arm))``: each round runs the arms forward, then
    back."""
    for rnd in range(rounds):
        for arm in list(arms) + list(arms)[::-1]:
            yield arm, rnd, run(arm)


def summary(by_arm: Dict[str, Dict[str, List[float]]], unit: str) -> dict:
    """Medians and spreads of each arm's values by case, and each later
    arm's medians over the first arm's."""
    arms = list(by_arm)
    med = {a: {c: statistics.median(v) for c, v in d.items()} for a, d in by_arm.items()}
    return {
        f"median_{unit}": med,
        f"spread_{unit}": {a: {c: [min(v), max(v)] for c, v in d.items()}
                           for a, d in by_arm.items()},
        "over_first_arm": {a: {c: med[a][c] / med[arms[0]][c] for c in med[a]}
                           for a in arms[1:]},
    }


def stream_ms(fn: Callable[[], object], reps: int, runs: int = 5,
              sleep_cycles: int = SLEEP_CYCLES) -> float:
    """Device ms a call of ``fn``, its launches back to back: the calls are
    queued behind a sleep kernel that holds the stream while the host
    launches them, so the CUDA events around them time the card's work
    and not the host's (the median of ``runs``, after a warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)
