"""``example/wirelessNet.ini`` -> WirelessNet: the shipped v2 demo
(``fognetsimpp_tpu/scenarios/example.py``).

One 802.11 user circling (300, 300) at r = 250 m and 40 m/s, publishing a
task every 50 ms; five 1,000-MIPS POOL fogs behind routerD; three APs,
each backhauled through its own router to the broker.  The apps are
generation 2, and the base broker is the v2 hybrid: a task runs on the
broker's own 1,000-MIPS pool when it fits, else offloads by the MAX_MIPS
scan, and the pool is released by one shared self-message
(``v2_local_broker``).  The publish link comes up at 1.0414 s: the first
14 creations wait in a bounded pending queue and drain in a 7-frame burst
and then a trickle, the six after them overflow, and every later publish
arrives at a steady 0.4015 s transit.  The calibration constants are the
reference's fit to its committed demo run (the JAX builder's), copied
here.  The same world the JAX builder makes from the same seed, on the
device the caller names.
"""
from __future__ import annotations

from ..spec import FogModel, Policy, WorldSpec
from .wireless import InfraGraph, _deg, assemble

CALIB_START = 0.06  # first publish creation time in the committed run
CALIB_LINK_UP = 1.0414  # link-up instant
CALIB_BURST_N = 7  # packets in the fast drain burst
CALIB_DRAIN = 0.0056833  # burst gap
CALIB_DRAIN2 = 0.0480143  # backlog trickle gap
CALIB_BUFFER = 14  # pending-queue capacity
CALIB_W_BASE = 0.4013  # steady transit less the wired core hops
CALIB_AP_RANGE = 600.0
CALIB_BROKER_MIPS = 1000.0  # wirelessNet.ini:58


def build(horizon: float = 3.35, dt: float = 1e-3, seed: int = 0,
          send_interval: float = 0.05, w_base: float = CALIB_W_BASE,
          device=None, **overrides):
    """Returns (spec, state, net, bounds) for the WirelessNet demo world,
    on ``device`` (CUDA unless the caller names another device)."""
    overrides.setdefault("app_gen", 2)
    overrides.setdefault("fog_model", int(FogModel.POOL))
    overrides.setdefault("policy", int(Policy.LOCAL_FIRST))
    overrides.setdefault("broker_mips", CALIB_BROKER_MIPS)
    overrides.setdefault("v2_local_broker", True)
    overrides.setdefault("adv_on_completion", False)
    overrides.setdefault("adv_periodic", True)
    overrides.setdefault("required_time", 0.01)
    overrides.setdefault("connect_gating", False)
    overrides.setdefault("start_time_min", CALIB_START)
    overrides.setdefault("start_time_max", CALIB_START + 1e-6)
    overrides.setdefault("link_up_s", CALIB_LINK_UP)
    overrides.setdefault("link_drain_s", CALIB_DRAIN)
    overrides.setdefault("link_burst_n", CALIB_BURST_N)
    overrides.setdefault("link_drain2_s", CALIB_DRAIN2)
    overrides.setdefault("link_buffer_frames", CALIB_BUFFER)
    overrides.setdefault("task_bytes", 1024)  # messageLength = 1024B
    spec = WorldSpec(
        n_users=1, n_fogs=5, n_aps=3,
        send_interval=send_interval, horizon=horizon, dt=dt,
        max_sends_per_user=int(horizon / send_interval) + 4,
        **overrides,
    ).validate()
    g = InfraGraph()
    for a, b in ([("ap5", "ap"), ("ap3", "ap"),
                  ("ap", "router1"), ("ap3", "router3"), ("ap5", "router5"),
                  ("router1", "bb"), ("router3", "bb"), ("router5", "bb"),
                  ("routerD", "bb")] +
                 [("routerD", f"cb{i}") for i in range(5)]):
        g.link(a, b)
    return assemble(
        spec, g, seed=seed,
        fog_mips=(1000.0,) * 5, fog_attach=("routerD",) * 5,
        broker_attach="routerD",
        ap_names=("ap", "ap3", "ap5"),
        ap_pos=((109.0, 508.0), (374.0, 185.0), (654.0, 508.0)),
        ap_range=CALIB_AP_RANGE,
        user_pos=((550.0, 300.0),),
        circle={0: (300.0, 300.0, 250.0, 40.0, _deg(360.0))},
        area=(784.0, 1014.0),
        w_base=w_base,
        w_contention=0.0,  # single station: steady transit is constant
        device=device,
    )
