"""Movement/communication trails: the Tkenv-animation analog as SVG
(``fognetsimpp_tpu/runtime/trails.py``, copied for the port).

The reference ships interactive observability through OMNeT++'s GUI:
mobility trails and communication lines
(``simulations/example/wirelessNet.ini:79-88`` turns on
``moveTrail``/``communicationTrail`` visualizers), display-string counters
(``rcvd: %d pks / sent: %d pks`` bubbles, ``mqttApp2.cc:103-107``), and
range circles around radios.  The batched framework renders the same
picture headlessly: one self-contained SVG per run showing

  * per-user movement trails (polyline over the recorded tick positions,
    ``spec.record_trails``);
  * APs as squares with their range circles, fog nodes as triangles, the
    base broker as a diamond;
  * a communication line from every wireless user's final position to its
    associated AP;
  * the display-string counters (sent/rcvd per node) from the cumulative
    per-node tx/rx counters.

No third-party rendering dependency: the SVG is assembled textually.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..net.topology import NetParams, associate
from ..spec import WorldSpec
from ..state import WorldState
from .recorder import to_host

_COLORS = ["#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e",
           "#17becf", "#8c564b", "#e377c2"]


def render_trails_svg(
    spec: WorldSpec,
    final: WorldState,
    series: Dict,
    out_path: str,
    net: Optional[NetParams] = None,
    size: int = 640,
) -> str:
    """Write the trail picture for a finished run; returns the path.

    ``series`` must come from a run with ``spec.record_trails`` (it needs
    the per-tick ``pos`` array).
    """
    if "pos" not in series:
        raise ValueError(
            "series has no 'pos' — run with spec.record_trails=True "
            "(and record_tick_series=True)"
        )
    final = to_host(final)
    pos = np.asarray(series["pos"])  # (ticks, N, 2)
    U, F = spec.n_users, spec.n_fogs
    last = pos[-1]
    lo = pos.reshape(-1, 2).min(axis=0) - 20.0
    hi = pos.reshape(-1, 2).max(axis=0) + 20.0
    span = np.maximum(hi - lo, 1e-6)
    scale = (size - 40) / span.max()

    def xy(p):
        q = (p - lo) * scale + 20.0
        return float(q[0]), float(size - q[1])  # y up

    out = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" '
        f'height="{size}" style="background:#fff;font:10px sans-serif">'
    ]
    tx = np.asarray(final.nodes.tx_count)
    rx = np.asarray(final.nodes.rx_count)

    # AP range circles + squares
    a0, a1 = spec.ap_slice
    ap_range = (
        np.asarray(net.ap_range) if net is not None and spec.n_aps else None
    )
    for i, a in enumerate(range(a0, a1)):
        x, y = xy(last[a])
        if ap_range is not None:
            r = float(ap_range[i]) * scale
            out.append(
                f'<circle cx="{x:.1f}" cy="{y:.1f}" r="{r:.1f}" '
                'fill="#1f77b410" stroke="#1f77b440"/>'
            )
        out.append(
            f'<rect x="{x - 5:.1f}" y="{y - 5:.1f}" width="10" height="10" '
            'fill="#444"/>'
            f'<text x="{x + 7:.1f}" y="{y:.1f}">ap{i}</text>'
        )

    # communication lines: wireless users to their associated AP
    if net is not None and spec.n_aps:
        # op by op, as JAX associates outside a jitted program
        net = to_host(net)
        cache = associate(
            net, final.nodes.pos, final.nodes.alive, broker=spec.broker_index,
            fused=False,
        )
        assoc = np.asarray(cache.assoc)
        ap_nodes = np.asarray(net.ap_nodes)
        for u in range(U):
            if assoc[u] >= 0:
                x1, y1 = xy(last[u])
                x2, y2 = xy(last[ap_nodes[assoc[u]]])
                out.append(
                    f'<line x1="{x1:.1f}" y1="{y1:.1f}" x2="{x2:.1f}" '
                    f'y2="{y2:.1f}" stroke="#2ca02c80" stroke-dasharray="4 3"/>'
                )

    # movement trails + user markers with display-string counters
    for u in range(U):
        c = _COLORS[u % len(_COLORS)]
        pts = " ".join(
            "{:.1f},{:.1f}".format(*xy(p)) for p in pos[:, u, :]
        )
        out.append(
            f'<polyline points="{pts}" fill="none" stroke="{c}" '
            'stroke-opacity="0.5"/>'
        )
        x, y = xy(last[u])
        out.append(
            f'<circle cx="{x:.1f}" cy="{y:.1f}" r="4" fill="{c}"/>'
            f'<text x="{x + 6:.1f}" y="{y + 4:.1f}">u{u} '
            f"sent:{int(tx[u])} rcvd:{int(rx[u])}</text>"
        )

    # fog nodes (triangles) + broker (diamond), with counters
    for f in range(F):
        n = spec.n_users + f
        x, y = xy(last[n])
        out.append(
            f'<path d="M {x:.1f} {y - 6:.1f} L {x - 6:.1f} {y + 5:.1f} '
            f'L {x + 6:.1f} {y + 5:.1f} Z" fill="#9467bd"/>'
            f'<text x="{x + 7:.1f}" y="{y + 4:.1f}">fog{f} '
            f"sent:{int(tx[n])} rcvd:{int(rx[n])}</text>"
        )
    b = spec.broker_index
    x, y = xy(last[b])
    out.append(
        f'<path d="M {x:.1f} {y - 7:.1f} L {x - 7:.1f} {y:.1f} '
        f'L {x:.1f} {y + 7:.1f} L {x + 7:.1f} {y:.1f} Z" fill="#d62728"/>'
        f'<text x="{x + 8:.1f}" y="{y + 4:.1f}">broker '
        f"sent:{int(tx[b])} rcvd:{int(rx[b])}</text>"
    )
    out.append("</svg>")
    svg = "\n".join(out)
    with open(out_path, "w") as fh:
        fh.write(svg)
    return out_path
