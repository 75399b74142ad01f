"""Result analysis: the ``.anf``/Scave analog over recorded runs
(``fognetsimpp_tpu/runtime/analysis.py``, copied for the port).

The reference analyses its ``.sca``/``.vec`` outputs with OMNeT++'s Scave
tool driven by ``.anf`` descriptors (``simulations/General.anf:1-9``).
Here :func:`analyze` computes the same statistic set (count, mean, min,
max, percentiles) over every signal vector of one or more recorded runs,
and :func:`render_report` formats the cross-run comparison table —
available from the CLI as ``python -m fognetsimpp_tpu_torch --analyze DIR``.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List

import numpy as np

from .recorder import load_scalars, load_vectors


def _stats(v: np.ndarray) -> Dict[str, float]:
    if v.size == 0:
        return {"n": 0}
    return {
        "n": int(v.size),
        "mean": float(v.mean()),
        "min": float(v.min()),
        "p50": float(np.percentile(v, 50)),
        "p95": float(np.percentile(v, 95)),
        "max": float(v.max()),
    }


def analyze(results_dir: str) -> Dict[str, Dict]:
    """Per-run signal statistics for every recorded run in a directory.

    Returns ``{run_id: {"scalars": {...}, "modules": {"user": [...],
    "fog": [...]}, "signals": {name: stats}}}`` (``modules`` is empty for
    runs recorded before per-module scalars existed).
    """
    out: Dict[str, Dict] = {}
    for sca_path in sorted(glob.glob(os.path.join(results_dir, "*.sca.json"))):
        run_id = os.path.basename(sca_path)[: -len(".sca.json")]
        sca = load_scalars(sca_path)
        entry: Dict = {
            "scalars": sca.get("scalars", {}),
            "modules": sca.get("modules", {}),
            "signals": {},
        }
        vec_path = os.path.join(results_dir, f"{run_id}.vec.npz")
        if os.path.exists(vec_path):
            for name, v in load_vectors(vec_path).items():
                # per-tick series (possibly (ticks, F)-shaped) flatten into
                # the same scalar-stat treatment as the signal vectors
                entry["signals"][name] = _stats(
                    np.asarray(v, np.float64).ravel()
                )
        out[run_id] = entry
    if not out:
        raise FileNotFoundError(f"no *.sca.json runs under {results_dir!r}")
    return out


def render_report(results: Dict[str, Dict]) -> str:
    """Human-readable cross-run table (the .anf chart-sheet analog)."""
    lines: List[str] = []
    for run_id, entry in results.items():
        sc = entry["scalars"]
        lines.append(f"== run {run_id}")
        lines.append(
            "   published={n_published} scheduled={n_scheduled} "
            "completed={n_completed} no_resource={n_no_resource} "
            "dropped={n_dropped} rejected={n_rejected}".format(
                **{k: sc.get(k, 0) for k in (
                    "n_published", "n_scheduled", "n_completed",
                    "n_no_resource", "n_dropped", "n_rejected",
                )}
            )
        )
        hdr = (f"   {'signal':<16}{'n':>7}{'mean':>10}{'min':>10}{'p50':>10}"
               f"{'p95':>10}{'max':>10}")
        lines.append(hdr)
        for name, s in sorted(entry["signals"].items()):
            if s["n"] == 0:
                lines.append(f"   {name:<16}{0:>7}")
                continue
            lines.append(
                f"   {name:<16}{s['n']:>7}{s['mean']:>10.2f}{s['min']:>10.2f}"
                f"{s['p50']:>10.2f}{s['p95']:>10.2f}{s['max']:>10.2f}"
            )
        fogs = entry.get("modules", {}).get("fog", [])
        if fogs:
            lines.append(
                f"   {'fog':<6}{'assigned':>9}{'completed':>10}"
                f"{'busy':>9}{'q_len':>7}{'drops':>7}"
            )
            for f, row in enumerate(fogs):
                lines.append(
                    f"   {f:<6}{row['assigned']:>9}{row['completed']:>10}"
                    f"{row['busy_time']:>9.2f}{row['q_len']:>7}"
                    f"{row['q_drops']:>7}"
                )
    return "\n".join(lines)
