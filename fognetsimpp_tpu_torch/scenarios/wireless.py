"""The wireless scenario ladder (``fognetsimpp_tpu/scenarios/wireless.py``).

Each builder rebuilds one rung of the reference's integration suite
(``simulations/testing/*.ini`` and ``*.ned``) as a batched world, the same
world the JAX builder makes from the same seed, on the device the caller
names: the NED topology becomes an infrastructure delay graph (routers
and APs joined by 100 Mbps / 0.1 us ``channel C`` links), 802.11 access
the per-cell Bianchi MAC of :func:`..net.topology.associate`, and the
ini's mobility, MIPS and energy blocks per-node state.

* :func:`wireless`: 1 linear user, 2 APs, 2 fogs;
* :func:`wireless2`: 10 + 1 users, 4 APs, 3 fogs, two on CircleMobility;
* :func:`wireless3`: the parametric AP chain;
* :func:`wireless4`: the 10-AP row that linear users traverse (handover);
* :func:`wireless5`: the full-feature world, heterogeneous fogs, energy
  storage and harvesting with shutdown/restart churn (``extra_aps`` adds
  a grid of APs for large populations);
* :func:`paper`: the publication topology, 4 fogs, 7 APs, 18 users.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.engine import prime_initial_advertisements
from ..device import resolve_device
from ..net.mobility import MobilityBounds
from ..net.topology import build_core_delay, make_net_params
from ..random import PRNGKey, uniform
from ..spec import Mobility, WorldSpec
from ..state import init_state

# `channel C extends DatarateChannel { datarate = 100Mbps; delay = 0.1us; }`
C_RATE = 100e6
C_DELAY = 1e-7


class InfraGraph:
    """Named infrastructure points + C-channel links -> core delay matrix."""

    def __init__(self) -> None:
        self.names: Dict[str, int] = {}
        self.links: List[Tuple[int, int, float, float]] = []

    def node(self, name: str) -> int:
        return self.names.setdefault(name, len(self.names))

    def link(self, a: str, b: str, rate: float = C_RATE,
             delay: float = C_DELAY) -> None:
        self.links.append((self.node(a), self.node(b), rate, delay))

    def core(self, packet_bytes: int) -> np.ndarray:
        return build_core_delay(len(self.names), self.links, packet_bytes)


def access_cost(packet_bytes: int) -> float:
    """One C-channel hop: propagation + serialization."""
    return C_DELAY + packet_bytes * 8.0 / C_RATE


def _deg(a: float) -> float:
    return a * math.pi / 180.0


def assemble(
    spec: WorldSpec,
    graph: InfraGraph,
    *,
    seed: int = 0,
    fog_mips: Sequence[float],
    fog_attach: Sequence[str],
    broker_attach: str,
    fog_pos: Optional[Sequence[Tuple[float, float]]] = None,
    broker_pos: Tuple[float, float] = (0.0, 0.0),
    ap_names: Sequence[str] = (),
    ap_pos: Sequence[Tuple[float, float]] = (),
    ap_range: float = 250.0,
    user_pos: Sequence[Tuple[float, float]] = (),
    linear: Optional[Dict[int, Tuple[float, float]]] = None,  # u -> (speed, angle_rad)
    circle: Optional[Dict[int, Tuple[float, float, float, float, float]]] = None,
    # u -> (cx, cy, r, speed, start_angle_rad)
    wired_users: Optional[Dict[int, str]] = None,  # u -> infra attach name
    area: Tuple[float, float] = (600.0, 400.0),
    w_base: float = 2e-3,
    w_prop: float = 3.336e-9,
    w_contention: float = 1.5e-3,
    mac_model: str = "bianchi",
    energy_users: bool = False,
    initial_energy_frac: Optional[Tuple[float, float]] = None,
    device=None,
):
    """Shared scenario assembler: ``(spec, state, net, bounds)``.

    Node layout [users | fogs | broker | aps].  Wired hosts (fogs, broker,
    APs, wired users) attach to their router with one C-hop access cost;
    wireless users associate every tick.
    """
    dev = resolve_device(device)
    U, F, A = spec.n_users, spec.n_fogs, spec.n_aps
    assert A == len(ap_names) == len(ap_pos)
    assert F == len(fog_mips) == len(fog_attach)
    # the activity-keyed MAC is declared on the spec, so that
    # assume_static with it fails at construction
    keyed = A > 0 and mac_model == "bianchi"
    if keyed != spec.mac_keyed:
        spec = dataclasses.replace(spec, mac_keyed=keyed).validate()
    N = spec.n_nodes
    cost = access_cost(spec.task_bytes)

    node_attach = np.full((N,), -1, np.int32)
    node_acc = np.zeros((N,), np.float32)
    is_wireless = np.zeros((N,), bool)
    is_wireless[:U] = True
    for u, name in (wired_users or {}).items():
        is_wireless[u] = False
        node_attach[u] = graph.node(name)
        node_acc[u] = cost
    for f in range(F):
        node_attach[U + f] = graph.node(fog_attach[f])
        node_acc[U + f] = cost
    node_attach[spec.broker_index] = graph.node(broker_attach)
    node_acc[spec.broker_index] = cost
    ap_infra = [graph.node(nm) for nm in ap_names]
    for i in range(A):
        node_attach[spec.ap_slice[0] + i] = ap_infra[i]

    net = make_net_params(
        n_nodes=N,
        core_delay=graph.core(spec.task_bytes),
        node_attach=node_attach,
        is_wireless=is_wireless,
        ap_nodes=list(range(spec.ap_slice[0], spec.ap_slice[0] + A)),
        ap_attach=ap_infra,
        ap_range=ap_range,
        w_base=w_base,
        w_prop=w_prop,
        w_contention=w_contention,
        node_acc=node_acc,
        mac_model=mac_model,
        device=dev,
    )

    state = init_state(spec, PRNGKey(seed, dev), dev)
    mips = torch.tensor(np.asarray(fog_mips, np.float32), device=dev)
    state = state.replace(fogs=state.fogs.replace(mips=mips, pool_avail=mips.clone()))

    pos = np.zeros((N, 2), np.float32)
    pos[:U] = np.asarray(user_pos, np.float32) if len(user_pos) else 0.0
    if fog_pos is not None:
        pos[U: U + F] = np.asarray(fog_pos, np.float32)
    pos[spec.broker_index] = broker_pos
    if A:
        pos[spec.ap_slice[0]: spec.ap_slice[0] + A] = np.asarray(ap_pos, np.float32)

    mob = np.zeros((N,), np.int8)
    vel = np.zeros((N, 2), np.float32)
    ccen = np.zeros((N, 2), np.float32)
    crad = np.zeros((N,), np.float32)
    comg = np.zeros((N,), np.float32)
    cpha = np.zeros((N,), np.float32)
    for u, (speed, ang) in (linear or {}).items():
        mob[u] = int(Mobility.LINEAR)
        vel[u] = (speed * math.cos(ang), speed * math.sin(ang))
    for u, (cx, cy, r, speed, start) in (circle or {}).items():
        mob[u] = int(Mobility.CIRCLE)
        ccen[u] = (cx, cy)
        crad[u] = r
        comg[u] = speed / r
        cpha[u] = start
        pos[u] = (cx + r * math.cos(start), cy + r * math.sin(start))

    def t(a):
        return torch.as_tensor(a, device=dev)

    nodes = state.nodes.replace(
        pos=t(pos), mobility=t(mob), vel=t(vel), circle_center=t(ccen),
        circle_radius=t(crad), circle_omega=t(comg), circle_phase=t(cpha),
    )
    if energy_users:
        has = np.zeros((N,), bool)
        has[:U] = True
        nodes = nodes.replace(has_energy=t(has))
        if initial_energy_frac is not None:
            lo, hi = initial_energy_frac
            frac = uniform(PRNGKey(seed + 1, dev), (N,), lo, hi)
            nodes = nodes.replace(
                energy=torch.where(nodes.has_energy, frac * nodes.energy_capacity, nodes.energy)
            )
    state = state.replace(nodes=nodes)
    state = prime_initial_advertisements(spec, state, net)
    bounds = MobilityBounds(
        lo=torch.zeros((2,), dtype=torch.float32, device=dev),
        hi=t(np.asarray(area, np.float32)),
    )
    return spec, state, net, bounds


# ----------------------------------------------------------------------
# the ladder
# ----------------------------------------------------------------------

def _sized(overrides: dict, horizon: float, default_interval: float) -> dict:
    """``send_interval`` through ``overrides`` (default the rung's), and
    ``max_sends_per_user`` sized from the effective interval."""
    overrides.setdefault("send_interval", default_interval)
    overrides.setdefault(
        "max_sends_per_user",
        int(horizon / overrides["send_interval"]) + 4,
    )
    return overrides


def _split(overrides: dict):
    """The caller's ``device`` apart from the spec's overrides."""
    return overrides.pop("device", None), overrides


def wireless(horizon: float = 10.0, dt: float = 1e-3, seed: int = 0,
             **overrides):
    """``testing/wireless.ini``: 1 linear user (20 mps in a 600 x 400
    area), 2 APs, 2 fogs of 1000 MIPS behind router1, a publish every
    50 ms."""
    device, overrides = _split(overrides)
    spec = WorldSpec(
        n_users=1, n_fogs=2, n_aps=2, horizon=horizon, dt=dt,
        **_sized(overrides, horizon, 0.05),
    ).validate()
    g = InfraGraph()
    for a, b in [("ap2", "ap1"), ("router", "ap1"), ("router", "ap2"),
                 ("router", "bb"), ("router1", "bb"), ("router1", "cb1"),
                 ("router1", "cb2")]:
        g.link(a, b)
    return assemble(
        spec, g, seed=seed,
        fog_mips=(1000.0, 1000.0), fog_attach=("router1", "router1"),
        broker_attach="router",
        ap_names=("ap1", "ap2"), ap_pos=((123.0, 175.0), (467.0, 175.0)),
        ap_range=250.0,
        user_pos=((397.0, 78.0),),
        linear={0: (20.0, 0.0)},
        area=(600.0, 400.0), device=device,
    )


def wireless2(horizon: float = 10.0, dt: float = 1e-3, seed: int = 0,
              **overrides):
    """``testing/wireless2.ini``: 10 + 1 users, 4 APs, 3 fogs; users 10
    and 2 on CircleMobility around (300, 300), r = 250 m at 40 mps, the
    rest linear at 20 mps; a publish every 1 s."""
    device, overrides = _split(overrides)
    U = 11
    spec = WorldSpec(
        n_users=U, n_fogs=3, n_aps=4, horizon=horizon, dt=dt,
        **_sized(overrides, horizon, 1.0),
    ).validate()
    g = InfraGraph()
    for a, b in [("ap1", "ap2"), ("router3", "ap1"), ("router2", "ap2"),
                 ("router2", "ap3"), ("router3", "ap4"), ("ap3", "ap4"),
                 ("router3", "router"), ("router2", "router"),
                 ("router", "bb"), ("router1", "bb")] + [
            ("router1", f"cb{i}") for i in range(3)]:
        g.link(a, b)
    rng = np.random.default_rng(seed)
    user_pos = rng.uniform((50, 50), (550, 350), (U, 2))
    linear = {u: (20.0, 0.0) for u in range(U)}
    circle = {}
    for u, start in ((10, _deg(360)), (2, _deg(180))):
        del linear[u]
        circle[u] = (300.0, 300.0, 250.0, 40.0, start)
    return assemble(
        spec, g, seed=seed,
        fog_mips=(1000.0,) * 3, fog_attach=("router1",) * 3,
        broker_attach="router",
        ap_names=("ap1", "ap2", "ap3", "ap4"),
        ap_pos=((77.0, 151.0), (475.0, 151.0), (475.0, 408.0), (77.0, 398.0)),
        ap_range=300.0,
        user_pos=user_pos, linear=linear, circle=circle,
        area=(600.0, 400.0), device=device,
    )


def wireless3(numb: int = 4, numb_users: int = 2, horizon: float = 10.0,
              dt: float = 1e-3, seed: int = 0, **overrides):
    """``testing/wireless3.ini``: ``numb`` APs chained ap[i] <-> ap[i+1],
    each backhauled through routerL3[i] (the NED for-loop); user 1
    circles when present; 3 fogs of 1000 MIPS."""
    assert numb >= 2, "the AP chain needs >= 2 APs (the NED loop is 0..numb-2)"
    device, overrides = _split(overrides)
    spec = WorldSpec(
        n_users=numb_users, n_fogs=3, n_aps=numb, horizon=horizon, dt=dt,
        **_sized(overrides, horizon, 1.0),
    ).validate()
    g = InfraGraph()
    for a, b in [("router1", "bb")] + [("router1", f"cb{i}") for i in range(3)]:
        g.link(a, b)
    for i in range(numb - 1):  # the NED for i=0..(numb-2) loop
        g.link(f"ap{i}", f"ap{i + 1}")
        g.link(f"routerL3{i}", f"ap{i}")
        g.link(f"routerL3{i}", "bb")
    ap_pos = [(100.0 + 250.0 * i, 123.0) for i in range(numb)]
    rng = np.random.default_rng(seed)
    user_pos = rng.uniform((50, 50), (100 + 250 * (numb - 1), 350),
                           (numb_users, 2))
    linear = {u: (20.0, 0.0) for u in range(numb_users)}
    circle = {}
    if numb_users > 1:
        del linear[1]
        circle[1] = (300.0, 300.0, 250.0, 40.0, _deg(360))
    return assemble(
        spec, g, seed=seed,
        fog_mips=(1000.0,) * 3, fog_attach=("router1",) * 3,
        broker_attach="router1",
        ap_names=[f"ap{i}" for i in range(numb)], ap_pos=ap_pos,
        ap_range=300.0,
        user_pos=user_pos, linear=linear, circle=circle,
        area=(100.0 + 250.0 * numb, 400.0), device=device,
    )


def wireless4(numb_users: int = 2, horizon: float = 30.0, dt: float = 1e-3,
              seed: int = 0, **overrides):
    """``testing/wireless4.ini``: 10 APs in a row at y = 259, each
    backhauled through its own router; users move along +x at 20 mps
    and hand over from cell to cell; a publish every 2 s."""
    device, overrides = _split(overrides)
    ap_x = [60.0, 177.0, 298.0, 422.0, 529.0, 634.0, 742.0, 834.0, 954.0,
            1074.0]
    spec = WorldSpec(
        n_users=numb_users, n_fogs=3, n_aps=10, horizon=horizon, dt=dt,
        **_sized(overrides, horizon, 2.0),
    ).validate()
    g = InfraGraph()
    g.link("router1", "bb")
    for i in range(3):
        g.link("router1", f"cb{i}")
    for i in range(10):
        g.link(f"r{i}", f"ap{i}")
        g.link(f"r{i}", "bb")
    rng = np.random.default_rng(seed)
    ys = rng.uniform(150.0, 260.0, numb_users)
    user_pos = np.stack([np.full(numb_users, 70.0), ys], axis=-1)
    return assemble(
        spec, g, seed=seed,
        fog_mips=(1000.0,) * 3, fog_attach=("router1",) * 3,
        broker_attach="router1",
        ap_names=[f"ap{i}" for i in range(10)],
        ap_pos=[(x, 259.0) for x in ap_x],
        ap_range=100.0,  # 2.5 mW cells: only the nearest row AP is in range
        user_pos=user_pos,
        linear={u: (20.0, 0.0) for u in range(numb_users)},
        area=(1150.0, 400.0), device=device,
    )


def wireless5(numb_users: int = 10, horizon: float = 60.0, dt: float = 0.01,
              seed: int = 0, ap_range: float = 400.0,
              w_contention: float = 1.5e-3, mac_model: str = "bianchi",
              extra_aps: int = 0, **overrides):
    """``testing/wireless5.ini``: fogs of 1000-4000 MIPS, 5 APs with ap4
    as the hub, users 0..5 on CircleMobility and the rest linear, a
    publish every 1.5 s, and the energy framework: 0.05 J storage charged
    uniform(10 %, 100 %) at start, a 4 mW alternating harvester, shutdown
    at 10 % and restart at 50 %.  ``extra_aps`` adds a square grid of APs
    over the 1 km^2 area, alternately backhauled through router2 and
    router11 (config 4's 10,000 users in 64 cells)."""
    device, overrides = _split(overrides)
    overrides.setdefault("energy_enabled", True)
    overrides.setdefault("energy_capacity_j", 0.05)
    overrides.setdefault("harvest_power_w", 4e-3)
    # generation/sleep ~ exponential(25 s) -> square wave, 50 s, 50 % duty
    overrides.setdefault("harvest_period_s", 50.0)
    overrides.setdefault("harvest_duty", 0.5)
    overrides.setdefault("shutdown_frac", 0.10)
    overrides.setdefault("start_frac", 0.50)
    spec = WorldSpec(
        n_users=numb_users, n_fogs=4, n_aps=5 + extra_aps,
        horizon=horizon, dt=dt,
        **_sized(overrides, horizon, 1.5),
    ).validate()
    g = InfraGraph()
    for a, b in ([("router1", "bb")] +
                 [("router1", f"cb{i}") for i in range(4)] +
                 [("router2", "bb"), ("router11", "bb"),
                  ("router2", "ap"), ("router11", "ap2"),
                  ("router11", "ap1"), ("router2", "ap3"),
                  ("ap4", "bb"), ("ap4", "ap"), ("ap4", "ap1"),
                  ("ap4", "ap2"), ("ap4", "ap3")]):
        g.link(a, b)
    ap_names = ["ap", "ap1", "ap2", "ap3", "ap4"]
    ap_pos = [(133.0, 172.0), (997.0, 566.0), (997.0, 172.0),
              (139.0, 566.0), (582.0, 330.0)]
    if extra_aps:
        side = int(np.ceil(np.sqrt(extra_aps)))
        step = 1000.0 / side
        for i in range(extra_aps):
            nm = f"apx{i}"
            g.link(nm, "router2" if i % 2 == 0 else "router11")
            ap_names.append(nm)
            ap_pos.append(
                (step * (i % side + 0.5), step * (i // side + 0.5))
            )
    rng = np.random.default_rng(seed)
    user_pos = rng.uniform((50, 50), (950, 950), (numb_users, 2))
    linear = {u: (20.0, 0.0) for u in range(numb_users)}
    circle = {}
    for u in range(min(6, numb_users)):
        del linear[u]
        circle[u] = (300.0, 300.0, 250.0, 40.0, _deg(30.0 * (u + 1)))
    return assemble(
        spec, g, seed=seed,
        fog_mips=(1000.0, 2000.0, 3000.0, 4000.0),
        fog_attach=("router1",) * 4, broker_attach="router1",
        ap_names=tuple(ap_names),
        ap_pos=tuple(ap_pos),
        # 400 m ~ 3.5 mW transmit power (wireless5.ini:52)
        ap_range=ap_range,
        w_contention=w_contention,
        mac_model=mac_model,
        user_pos=user_pos, linear=linear, circle=circle,
        area=(1000.0, 1000.0),
        energy_users=True, initial_energy_frac=(0.10, 1.0), device=device,
    )


def paper(horizon: float = 10.0, dt: float = 1e-3, seed: int = 0,
          **overrides):
    """``testing/paper.ned``: 4 fogs on separate routers, 7 APs, 17
    wireless users and 1 wired static sensor; v3 defaults (a publish
    every 1 s)."""
    device, overrides = _split(overrides)
    user_pos = [
        (710.0, 268.0), (320.0, 59.0), (725.0, 74.0), (109.0, 128.0),
        (471.0, 180.0), (109.0, 251.0), (497.0, 95.0), (816.0, 497.0),
        (725.0, 419.0), (421.0, 419.0), (131.0, 437.0), (922.0, 290.0),
        (870.0, 74.0), (274.0, 144.0), (344.0, 503.0), (679.0, 164.0),
        (589.0, 31.0), (301.0, 451.0),  # last = staticSensor (wired)
    ]
    U = len(user_pos)
    spec = WorldSpec(
        n_users=U, n_fogs=4, n_aps=7, horizon=horizon, dt=dt,
        **_sized(overrides, horizon, 1.0),
    ).validate()
    g = InfraGraph()
    for a, b in [("router1", "bb"), ("router2", "fn1a"), ("router1", "fn2a"),
                 ("router3", "fn3a"), ("router11", "fn4a"),
                 ("router2", "bb"), ("router11", "bb"), ("router3", "bb"),
                 ("router2", "ap"), ("router3", "ap4"), ("router11", "ap2"),
                 ("router11", "ap1"), ("router2", "ap3"), ("router2", "ap5"),
                 ("router11", "ap6")]:
        g.link(a, b)
    # the four "mobile*" hosts move; everyone else is stationary
    linear = {7: (20.0, 0.0), 13: (20.0, 0.0), 14: (20.0, 0.0),
              15: (20.0, 0.0)}
    return assemble(
        spec, g, seed=seed,
        fog_mips=(1000.0,) * 4,
        fog_attach=("router2", "router1", "router3", "router11"),
        broker_attach="router1",
        ap_names=("ap", "ap1", "ap2", "ap3", "ap4", "ap5", "ap6"),
        ap_pos=((363.0, 163.0), (783.0, 172.0), (909.0, 172.0),
                (197.0, 163.0), (566.0, 163.0), (197.0, 528.0),
                (909.0, 528.0)),
        ap_range=300.0,
        user_pos=user_pos, linear=linear,
        wired_users={U - 1: "router2"},  # staticSensor: StandardHost
        area=(1000.0, 600.0), device=device,
    )
