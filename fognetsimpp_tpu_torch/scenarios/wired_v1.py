"""``testing/omnetpp.ini`` -> Network: the wired v1 pub/sub smoke world
(``fognetsimpp_tpu/scenarios/wired_v1.py``).

The reference's first ladder rung: two users, two fog nodes and the base
broker off one router over identical 100 Mbps links (``network.ned``),
running the generation-1 apps: ``standardUser`` publishes fixed-size tasks
(``MIPSRequired = 100``, ``mqttApp.cc:330``) on topic 0, ``standardUser1``
publishes nothing and subscribes to topics 0 and 1; the v1 broker runs a
task on its own 1,000-MIPS pool when the pool covers it and otherwise
offloads by the compare-to-first MAX_MIPS scan (``Policy.LOCAL_FIRST``);
the v1 fogs are MIPS pools.  The broker's pool is never refunded
(``BugCompat(local_pool_leak=True)``, ``BrokerBaseApp.cc:208``), so both
branches run.  The same world the JAX builder makes from the same seed,
on the device the caller names.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.engine import prime_initial_advertisements
from ..device import resolve_device
from ..net.mobility import default_bounds
from ..net.topology import wired_star
from ..random import PRNGKey
from ..spec import BugCompat, FogModel, Policy, WorldSpec
from ..state import init_state


def build(
    horizon: float = 5.0,
    dt: float = 1e-3,
    send_interval: float = 0.05,
    broker_mips: float = 1000.0,
    fog_mips: float = 1000.0,
    seed: int = 0,
    max_sends_per_user: Optional[int] = None,
    device=None,
    **overrides,
):
    """Returns (spec, state, net, bounds) for the wired v1 world, on
    ``device`` (CUDA unless the caller names another device)."""
    dev = resolve_device(device)
    overrides.setdefault("app_gen", 1)
    overrides.setdefault("policy", int(Policy.LOCAL_FIRST))
    overrides.setdefault("fog_model", int(FogModel.POOL))
    overrides.setdefault("fixed_mips_required", 100)  # mqttApp.cc:330
    overrides.setdefault("adv_periodic", True)  # v1 re-advertises on a timer
    overrides.setdefault("adv_on_completion", False)
    overrides.setdefault("n_topics", 2)
    overrides.setdefault("bug_compat", BugCompat(local_pool_leak=True))
    if max_sends_per_user is None:
        max_sends_per_user = int(horizon / send_interval) + 4
    spec = WorldSpec(
        n_users=2,
        n_fogs=2,
        send_interval=send_interval,
        horizon=horizon,
        dt=dt,
        broker_mips=broker_mips,
        max_sends_per_user=max_sends_per_user,
        **overrides,
    ).validate()

    state = init_state(spec, PRNGKey(seed, dev), dev)
    mips = torch.full((2,), fog_mips, dtype=torch.float32, device=dev)
    state = state.replace(fogs=state.fogs.replace(mips=mips, pool_avail=mips.clone()))
    # the pub/sub split (omnetpp.ini:18-21)
    users = state.users.replace(
        publisher=torch.tensor([True, False], device=dev),
        pub_topic=torch.zeros((2,), dtype=torch.int32, device=dev),
        sub_mask=torch.tensor([[False, False], [True, True]], device=dev),
    )
    state = state.replace(users=users)
    net = wired_star(spec.n_nodes, link_delay=1e-7, rate=100e6,
                     packet_bytes=spec.task_bytes, device=dev)
    state = prime_initial_advertisements(spec, state, net)
    return spec, state, net, default_bounds(1000.0, dev)
