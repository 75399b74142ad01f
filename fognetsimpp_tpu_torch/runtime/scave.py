"""OMNeT++/Scave-compatible text result files (`.sca` / `.vec`), both
directions (``fognetsimpp_tpu/runtime/scave.py``, copied for the port):
an exporter rendering a finished run in the reference's grammar, and a
reader (:func:`read_sca` / :func:`read_vec`) of the reference's own
result files (``simulations/example/results/General-0.sca`` and the
testing run under ``simulations/results/``).

The reference's L5 output is the OMNeT++ 4.x "version 2" text format:
header ``version 2`` + ``run`` + ``attr`` lines, then ``scalar <module>
<name> <value>`` rows and ``statistic`` blocks with ``field`` lines; the
``.vec`` twin declares ``vector <id> <module> <name> ETV`` and streams
``<id>\\t<event>\\t<time>\\t<value>`` rows, read by ``.anf`` descriptors
(``simulations/General.anf:1-9``).  The exporter writes that grammar so
the reference's analysis tooling (Scave, ``opp_scavetool``) reads the
port's results unmodified; the ``.sca.json`` / ``.vec.npz`` pair stays
the primary machine-readable output (:mod:`.recorder`).

Module naming follows the reference networks: ``<net>.user[<u>].udpApp[0]``
(the demo's single user is plain ``<net>.user.udpApp[0]``),
``<net>.ComputeBroker<f+1>.udpApp[0]``, ``<net>.BaseBroker.udpApp[0]``.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional, TextIO, Tuple

import numpy as np

from ..spec import WorldSpec
from ..state import WorldState
from .recorder import per_module_scalars, to_host

# per-user statistic blocks / vectors above this population are aggregated
# into one synthetic `<net>.users` module (the committed reference worlds
# have <= 13 users; a 10k-user bench world would emit 40k text blocks)
_PER_USER_LIMIT = 64

# scenario builder -> reference NED network name (SURVEY.md §2 topologies)
NETWORK_NAMES = {
    "smoke": "Network",
    "wired_v1": "Network",
    "wireless": "WirelessNetwork",
    "wireless2": "WirelessNetwork2",
    "wireless3": "WirelessNetwork3",
    "wireless4": "WirelessNetwork4",
    "wireless5": "WirelessNetwork5",
    "paper": "WirelessNetwork6",
    "example": "WirelessNet",
}


def _q(name: str) -> str:
    """Quote a scalar/statistic name the way OMNeT++ does (spaces)."""
    return f'"{name}"' if (" " in name or "\t" in name) else name


def _write_header(f: TextIO, run_id: str, attrs: Dict[str, str]) -> None:
    f.write("version 2\n")
    f.write(f"run {run_id}\n")
    for k, v in attrs.items():
        sv = str(v)
        if sv == "" or " " in sv:
            sv = f'"{sv}"'
        f.write(f"attr {k} {sv}\n")
    f.write("\n")


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    x = float(v)
    if np.isnan(x):
        return "nan"
    if np.isinf(x):
        return "inf" if x > 0 else "-inf"
    return repr(x)


def _scalar(f: TextIO, module: str, name: str, value) -> None:
    f.write(f"scalar {module} \t{_q(name)} \t{_fmt(value)}\n")


def _statistic(f: TextIO, module: str, name: str, v: np.ndarray) -> None:
    """A `statistic` block with the reference's seven `field` rows
    (General-0.sca:52-59)."""
    f.write(f"statistic {module} \t{_q(name)}\n")
    n = int(v.size)
    f.write(f"field count {n}\n")
    f.write(f"field mean {_fmt(v.mean() if n else float('nan'))}\n")
    std = v.std(ddof=1) if n > 1 else float("nan")
    f.write(f"field stddev {_fmt(std)}\n")
    f.write(f"field sum {_fmt(v.sum() if n else 0.0)}\n")
    f.write(f"field sqrsum {_fmt(float(np.square(v, dtype=np.float64).sum()) if n else 0.0)}\n")
    f.write(f"field min {_fmt(v.min() if n else float('nan'))}\n")
    f.write(f"field max {_fmt(v.max() if n else float('nan'))}\n")


def _signal_samples(
    spec: WorldSpec, final: WorldState
) -> Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Per-signal (user, emit_time_s, value_ms) triples from the task table.

    The emission times are the exact ack-arrival event times the reference
    would have recorded each sample at (``mqttApp2.cc:256-291``); the
    values mirror :func:`~.signals.extract_signals`.
    """
    t = final.tasks
    user = np.asarray(t.user)
    t_create = np.asarray(t.t_create, np.float64)

    def tri(t_end_arr, owner=None):
        t_end = np.asarray(t_end_arr, np.float64)
        m = np.isfinite(t_end) & np.isfinite(t_create)
        o = user if owner is None else owner
        return o[m], t_end[m], (t_end[m] - t_create[m]) * 1e3

    out = {
        "latency": tri(t.t_ack5),
        "taskTime": tri(t.t_ack6),
        "delay": tri(t.t_at_broker),
    }
    # latencyH1: both the broker's own "forwarded" and the relayed fog
    # "queued" status-4 acks produce samples (mqttApp2.cc:269-277)
    u4a, tt4a, v4a = tri(t.t_ack4_fwd)
    u4b, tt4b, v4b = tri(t.t_ack4_queued)
    out["latencyH1"] = (
        np.concatenate([u4a, u4b]),
        np.concatenate([tt4a, tt4b]),
        np.concatenate([v4a, v4b]),
    )
    # queueTime belongs to the fog module that served the task
    qt = np.asarray(t.queue_time_ms, np.float64)
    mq = np.isfinite(qt)
    fog = np.asarray(t.fog)
    ts = np.asarray(t.t_service_start, np.float64)
    out["queueTime"] = (
        fog[mq],
        np.where(np.isfinite(ts[mq]), ts[mq], 0.0),
        qt[mq],
    )
    return out


def _user_module(net: str, u: int, n_users: int) -> str:
    if n_users == 1:
        return f"{net}.user.udpApp[0]"  # the demo's single circling user
    return f"{net}.user[{u}].udpApp[0]"


def export_scave(
    outdir: str,
    spec: WorldSpec,
    final: WorldState,
    series: Optional[Dict] = None,
    run_id: str = "General-0",
    attrs: Optional[Dict] = None,
    network: str = "Network",
) -> Dict[str, str]:
    """Write `<run_id>.sca` + `<run_id>.vec` in OMNeT++ text format.

    Returns ``{"sca": path, "vec": path, "anf": path}``; the ``.anf``
    descriptor points Scave at both files, like
    ``simulations/General.anf``.
    """
    os.makedirs(outdir, exist_ok=True)
    sca_path = os.path.join(outdir, f"{run_id}.sca")
    vec_path = os.path.join(outdir, f"{run_id}.vec")
    anf_path = os.path.join(outdir, "General.anf")

    stamp = time.strftime("%Y%m%d-%H:%M:%S")
    header = {
        "configname": "General",
        "datetime": stamp,
        "experiment": "General",
        "inifile": (attrs or {}).get("scenario", "scenario"),
        "iterationvars": "",
        "iterationvars2": "$repetition=0",
        "measurement": "",
        "network": network,
        "processid": os.getpid(),
        "repetition": 0,
        "replication": "#0",
        "resultdir": "results",
        "runnumber": 0,
        "seedset": 0,
    }
    if attrs:
        header.update({k: v for k, v in attrs.items()})

    final = to_host(final)
    mods = per_module_scalars(spec, final)
    U, F = spec.n_users, spec.n_fogs
    per_user = U <= _PER_USER_LIMIT
    sig = _signal_samples(spec, final)

    # ------------------------------------------------------------- .sca
    with open(sca_path, "w") as f:
        _write_header(f, run_id, header)
        for u, row in enumerate(mods["user"]):
            mod = _user_module(network, u, U)
            # the reference's exact row names where a direct analog exists
            _scalar(f, mod, "packets sent", row["tx_msgs"])
            _scalar(f, mod, "packets received", row["rx_msgs"])
            _scalar(f, mod, "sentPk:count", row["sent"])
            _scalar(f, mod, "completedTasks:count", row["completed"])
            _scalar(f, mod, "acked6:count", row["acked6"])
            _scalar(f, mod, "delivered:count", row["delivered"])
            _scalar(f, mod, "residualEnergy", row["energy_j"])
            _scalar(f, mod, "alive", row["alive"])
        for fi, row in enumerate(mods["fog"]):
            mod = f"{network}.ComputeBroker{fi + 1}.udpApp[0]"
            _scalar(f, mod, "packets sent", row["tx_msgs"])
            _scalar(f, mod, "packets received", row["rx_msgs"])
            _scalar(f, mod, "assignedTasks:count", row["assigned"])
            _scalar(f, mod, "completedTasks:count", row["completed"])
            _scalar(f, mod, "busyTime", row["busy_time"])
            _scalar(f, mod, "queueLength", row["q_len"])
            _scalar(f, mod, "queueDrops:count", row["q_drops"])
        bmod = f"{network}.BaseBroker.udpApp[0]"
        _scalar(f, bmod, "packets sent", mods["broker"]["tx_msgs"])
        # everything the broker app processed — the `echoedPk:count` analog
        _scalar(f, bmod, "echoedPk:count", mods["broker"]["rx_msgs"])
        for a, row in enumerate(mods["ap"]):
            _scalar(f, f"{network}.ap{a + 1}", "assocStations:mean",
                    row["assoc_mean"])

        # per-signal statistic blocks (the @statistic record=stats half,
        # mqttApp2.ned:50-55); values in ms like the signal layer
        for name, owner_mod in (
            ("latency", "user"),
            ("latencyH1", "user"),
            ("taskTime", "user"),
        ):
            owner, _, val = sig[name]
            if per_user:
                for u in range(U):
                    _statistic(
                        f, _user_module(network, u, U), f"{name}:stats",
                        val[owner == u],
                    )
            else:
                _statistic(f, f"{network}.users", f"{name}:stats", val)
        for fi in range(F):
            owner, _, val = sig["queueTime"]
            _statistic(
                f, f"{network}.ComputeBroker{fi + 1}.udpApp[0]",
                "queueTime:stats", val[owner == fi],
            )
        _statistic(f, bmod, "delay:stats", sig["delay"][2])

    # ------------------------------------------------------------- .vec
    with open(vec_path, "w") as f:
        _write_header(f, run_id, header)
        decls = []  # (vec_id, module, name, times, values)
        vid = 0
        for name in ("latency", "latencyH1", "taskTime"):
            owner, tt, val = sig[name]
            if per_user:
                for u in range(U):
                    m = owner == u
                    decls.append(
                        (vid, _user_module(network, u, U), f"{name}:vector",
                         tt[m], val[m])
                    )
                    vid += 1
            else:
                decls.append(
                    (vid, f"{network}.users", f"{name}:vector", tt, val)
                )
                vid += 1
        for fi in range(F):
            owner, tt, val = sig["queueTime"]
            m = owner == fi
            decls.append(
                (vid, f"{network}.ComputeBroker{fi + 1}.udpApp[0]",
                 "queueTime:vector", tt[m], val[m])
            )
            vid += 1
        owner, tt, val = sig["delay"]
        decls.append((vid, bmod, "delay:vector", tt, val))
        vid += 1
        if series is not None:
            ts = np.asarray(series.get("t", []), np.float64).ravel()
            for k, v in series.items():
                arr = np.asarray(v, np.float64)
                if k == "t" or arr.ndim != 1 or arr.shape[0] != ts.shape[0]:
                    continue  # per-fog matrices live in the .npz
                decls.append((vid, f"{network}.tick", f"{k}:vector", ts, arr))
                vid += 1

        for i, mod, name, _, _ in decls:
            f.write(f"vector {i}  {mod}  {name}  ETV\n")
        f.write("\n")
        # one global event counter over all samples in time order, so the
        # E column is monotone the way the kernel's would be
        all_t = np.concatenate([d[3] for d in decls]) if decls else np.zeros(0)
        all_vid = np.concatenate(
            [np.full(d[3].shape[0], d[0], np.int64) for d in decls]
        ) if decls else np.zeros(0, np.int64)
        all_v = np.concatenate([d[4] for d in decls]) if decls else np.zeros(0)
        order = np.argsort(all_t, kind="stable")
        for ev, j in enumerate(order):
            f.write(
                f"{int(all_vid[j])}\t{ev}\t{float(all_t[j])!r}\t"
                f"{float(all_v[j])!r}\n"
            )

    with open(anf_path, "w") as f:
        f.write('<?xml version="1.0" encoding="UTF-8"?>\n')
        f.write(
            '<scave:Analysis xmi:version="2.0" '
            'xmlns:xmi="http://www.omg.org/XMI" '
            'xmlns:scave="http://www.omnetpp.org/omnetpp/scave">\n'
        )
        f.write("  <inputs>\n")
        f.write(f'    <inputs name="{os.path.abspath(sca_path)}"/>\n')
        f.write(f'    <inputs name="{os.path.abspath(vec_path)}"/>\n')
        f.write("  </inputs>\n  <datasets/>\n  <chartSheets/>\n")
        f.write("</scave:Analysis>\n")

    return {"sca": sca_path, "vec": vec_path, "anf": anf_path}


# ----------------------------------------------------------------------
# readers (the opp_scavetool/Scave-side half of the format contract)
# ----------------------------------------------------------------------

def _split_name(rest: str):
    """Split `<name-or-quoted> <value...>` returning (name, remainder)."""
    rest = rest.strip()
    if rest.startswith('"'):
        end = rest.index('"', 1)
        return rest[1:end], rest[end + 1 :].strip()
    parts = rest.split(None, 1)
    return parts[0], (parts[1] if len(parts) > 1 else "")


def read_sca(path: str) -> Dict:
    """Parse an OMNeT++ version-2 text `.sca` file.

    Handles the grammar of the reference's committed artifacts
    (``simulations/example/results/General-0.sca``): `run`/`attr`
    header, `scalar <module> <name> <value>` rows (names may be quoted:
    ``"simulated time"``), `statistic` blocks with `field` rows, nested
    `attr` rows and histogram `bin` rows.

    Returns ``{"run": str, "attrs": {..}, "scalars": {(module, name):
    float}, "statistics": {(module, name): {"fields": {..}, "bins":
    [(edge, count), ...]}}}``.
    """
    out = {"run": "", "attrs": {}, "scalars": {}, "statistics": {}}
    cur = None  # open statistic block
    with open(path) as f:
        first = f.readline().strip()
        if first != "version 2":
            raise ValueError(f"unsupported result-file version: {first!r}")
        for ln in f:
            ln = ln.rstrip("\n")
            if not ln.strip():
                cur = None
                continue
            kind, _, rest = ln.partition(" ")
            if kind == "run":
                out["run"] = rest.strip()
            elif kind == "attr":
                name, val = _split_name(rest)
                if cur is not None:
                    cur.setdefault("attrs", {})[name] = val.strip('"')
                else:
                    out["attrs"][name] = val.strip('"')
            elif kind == "scalar":
                module, rest2 = _split_name(rest)
                name, val = _split_name(rest2)
                out["scalars"][(module, name)] = float(val)
                cur = None
            elif kind == "statistic":
                module, rest2 = _split_name(rest)
                name, _ = _split_name(rest2 + " _")
                cur = {"fields": {}, "bins": []}
                out["statistics"][(module, name)] = cur
            elif kind == "field" and cur is not None:
                name, val = _split_name(rest)
                cur["fields"][name] = float(val)
            elif kind == "bin" and cur is not None:
                edge_s, count_s = rest.split()
                edge = float("-inf") if edge_s == "-INF" else float(edge_s)
                cur["bins"].append((edge, float(count_s)))
    return out


def read_vec(path: str, vector_ids: Optional[set] = None) -> Dict:
    """Parse an OMNeT++ version-2 text `.vec` file.

    Returns ``{"run": str, "attrs": {..}, "vectors": {id: {"module":
    str, "name": str, "columns": str}}, "data": {id: (events, times,
    values)}}`` — data as numpy arrays.  ``vector_ids`` restricts data
    collection (declarations are always read); the reference's committed
    `.vec` is 63k lines, so callers anchoring one vector skip the rest.
    """
    decls: Dict[int, Dict] = {}
    data: Dict[int, list] = {}
    out = {"run": "", "attrs": {}, "vectors": decls}
    with open(path) as f:
        first = f.readline().strip()
        if first != "version 2":
            raise ValueError(f"unsupported result-file version: {first!r}")
        for ln in f:
            c = ln[0] if ln else "\n"
            if c.isdigit():
                vid_s, _, rest = ln.partition("\t")
                vid = int(vid_s)
                if vector_ids is not None and vid not in vector_ids:
                    continue
                decl = decls.get(vid)
                if decl is not None and decl["columns"] != "ETV":
                    raise ValueError(
                        f"vector {vid} declares columns "
                        f"{decl['columns']!r}; only ETV is supported"
                    )
                cols = rest.split()
                # ETV: event, time, value
                data.setdefault(vid, []).append(
                    (int(cols[0]), float(cols[1]), float(cols[2]))
                )
            elif ln.startswith("vector "):
                rest = ln[len("vector ") :]
                vid_s, rest = rest.split(None, 1)
                module, rest = _split_name(rest)
                name, cols = _split_name(rest)
                decls[int(vid_s)] = {
                    "module": module,
                    "name": name,
                    "columns": cols.strip() or "ETV",
                }
            elif ln.startswith("run "):
                out["run"] = ln[4:].strip()
            elif ln.startswith("attr "):
                name, val = _split_name(ln[5:])
                out["attrs"][name] = val.strip('"')
    out["data"] = {
        vid: (
            np.asarray([r[0] for r in rows], np.int64),
            np.asarray([r[1] for r in rows], np.float64),
            np.asarray([r[2] for r in rows], np.float64),
        )
        for vid, rows in data.items()
    }
    return out
