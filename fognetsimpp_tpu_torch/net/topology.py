"""Network model: the delay model, 802.11 association and the Bianchi MAC.

Counterpart of ``fognetsimpp_tpu/net/topology.py``, leaf for leaf:
:class:`NetParams` and :class:`LinkCache`, the delay model
``delay(a, b) = acc_a + core[attach_a, attach_b] + acc_b``
(:func:`_delay_between`, :func:`_delay_to`, :func:`pair_delay`),
:func:`associate` (nearest alive AP in range, each cell's station count,
the access delay and the 802.11 retry-exhaustion loss), and the numpy
builders run once a scenario (:func:`bianchi_fixed_point`,
:func:`bianchi_tables`, :func:`build_core_delay`, :func:`make_net_params`,
:func:`wired_star`), copied from the JAX package.

Two habits keep :func:`associate` bit-exact with XLA on the CPU: the
``a * b + c`` that XLA contracts into one fused multiply-add use
:func:`~..f32math.fma` (``fused=False`` rounds each step instead, as the
reference's un-jitted calls do), and the float32 sum of each cell's offered load
adds in index order (:func:`~..ops.cell_kernels.cell_sum_ordered`, a
CUDA kernel on the card), as XLA's scatter-add does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..f32math import const, fma
from ..ops import cell_kernels
from ..ops.scatter import add_drop
from ..state import Struct, register_pytree

_I32, _F32 = torch.int32, torch.float32


@register_pytree
@dataclasses.dataclass
class NetParams(Struct):
    """Static-per-scenario network data (same leaves as the JAX twin)."""

    core_delay: torch.Tensor  # (I, I) f32 base delay between attach points
    node_attach: torch.Tensor  # (N,) i32 wired attach point per node
    node_acc: torch.Tensor  # (N,) f32 access-link delay to the attach point
    is_wireless: torch.Tensor  # (N,) bool
    ap_nodes: torch.Tensor  # (A,) i32
    ap_attach: torch.Tensor  # (A,) i32
    ap_range: torch.Tensor  # (A,) f32
    w_base: torch.Tensor  # () f32
    w_prop: torch.Tensor  # () f32
    w_contention: torch.Tensor  # () f32
    mac_delay_tab: torch.Tensor  # (n_max+1,) f32, empty = linear model
    mac_loss_tab: torch.Tensor  # (n_max+1,) f32


@register_pytree
@dataclasses.dataclass
class LinkCache(Struct):
    """Derived connectivity of one tick (constant on a static world)."""

    assoc: torch.Tensor  # (N,) i32 associated AP slot (-1 = none)
    n_assoc: torch.Tensor  # (A,) i32 stations per AP
    attach_now: torch.Tensor  # (N,) i32
    acc_delay: torch.Tensor  # (N,) f32
    reachable: torch.Tensor  # (N,) bool
    d2b: torch.Tensor  # (N,) f32 delay(node, broker), +inf if unreachable
    mac_loss_p: torch.Tensor  # (N,) f32 802.11 retry-exhaustion loss


def _delay_between(
    net: NetParams, attach_a, acc_a, attach_b, acc_b
) -> torch.Tensor:
    """``acc_a + core[attach_a, attach_b] + acc_b``; +inf if unattached."""
    I = net.core_delay.shape[0]
    core = net.core_delay[attach_a.clamp(0, I - 1).long(), attach_b.clamp(0, I - 1).long()]
    d = acc_a + core + acc_b
    return torch.where(
        (attach_a >= 0) & (attach_b >= 0), d, torch.full_like(d, float("inf"))
    )


def _delay_to(
    net: NetParams, attach_now: torch.Tensor, acc_delay: torch.Tensor, dst: int
) -> torch.Tensor:
    """Per-node delay to one fixed destination node (the base broker)."""
    return _delay_between(
        net, attach_now, acc_delay,
        attach_now[dst].expand_as(attach_now),
        acc_delay[dst].expand_as(acc_delay),
    )


def _interp(tab: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of ``tab`` at ``x`` (clamped to its range):
    ``tab[i0] * (1 - fr) + tab[i0 + 1] * fr``, the second product and the
    sum fused, as XLA compiles it."""
    n = tab.shape[0]
    i0 = torch.clamp(torch.floor(x).to(_I32), 0, n - 2)
    fr = torch.clamp(x - i0.to(_F32), 0.0, 1.0)
    i0 = i0.long()
    return fma(tab[i0 + 1], fr, tab[i0] * (1.0 - fr))


def _mul_add(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded twice: the product, then the sum."""
    return a * b + c


def associate(
    net: NetParams, pos: torch.Tensor, alive: torch.Tensor, broker: int,
    offered_rate: Optional[torch.Tensor] = None, fused: bool = True,
) -> LinkCache:
    """Association and access delays for the current positions.

    Each wireless node associates with the nearest alive AP within range.
    With Bianchi tables and ``offered_rate`` (frames/s a node), each
    cell's MAC is keyed by its effective contender count, the fixed point
    ``n = clip(lambda * D(n), 1, occupancy)`` of Little's law taken in 8
    iterations; without ``offered_rate``, by the cell's occupancy; with
    empty tables the access delay is linear in the occupancy and nothing
    is lost.

    ``fused``: the arithmetic of the reference's compiled programs (the
    tick, and the static cache of its jitted runners), where XLA
    contracts ``a * b + c``; ``False`` that of an op-by-op call (the
    static cache JAX ``run`` and the task-sharded runner build before
    their loop), every product rounded apart.
    """
    mad = fma if fused else _mul_add
    N = pos.shape[0]
    A = net.ap_nodes.shape[0]
    dev = pos.device
    if A == 0:
        attach_now = net.node_attach
        return LinkCache(
            assoc=torch.full((N,), -1, dtype=_I32, device=dev),
            n_assoc=torch.zeros((0,), dtype=_I32, device=dev),
            attach_now=attach_now,
            acc_delay=net.node_acc,
            reachable=attach_now >= 0,
            d2b=_delay_to(net, attach_now, net.node_acc, broker),
            mac_loss_p=torch.zeros((N,), dtype=_F32, device=dev),
        )
    ap_idx = net.ap_nodes.long()
    ap_pos = pos[ap_idx]  # (A, 2)
    ap_ok = alive[ap_idx]
    diff = pos[:, None, :] - ap_pos[None, :, :]  # (N, A, 2)
    dx, dy = diff[..., 0], diff[..., 1]
    d2 = mad(dy, dy, dx * dx)
    d2 = torch.where(ap_ok[None, :], d2, float("inf"))
    nearest = torch.argmin(d2, dim=1).to(_I32)  # first minimum
    # a correctly rounded square root, as XLA's (torch's float32 sqrt on
    # the CPU is not), taken in float64 and rounded once
    ndist = torch.sqrt(torch.gather(d2, 1, nearest.long()[:, None])[:, 0].double()).float()
    in_range = ndist <= net.ap_range[nearest.long()]
    assoc = torch.where(net.is_wireless & in_range & alive, nearest, -1).to(_I32)

    on_air = net.is_wireless & (assoc >= 0)
    cell = torch.where(assoc >= 0, assoc, A)
    n_assoc = add_drop(
        torch.zeros((A,), dtype=_I32, device=dev), cell, torch.ones_like(cell)
    )
    assoc_c = torch.clamp(assoc, 0, A - 1).long()
    attach_now = torch.where(
        net.is_wireless,
        torch.where(assoc >= 0, net.ap_attach[assoc_c], -1),
        net.node_attach,
    ).to(_I32)
    w_c = net.w_contention
    base = mad(net.w_prop, ndist, net.w_base.expand_as(ndist))
    if net.mac_delay_tab.shape[0] > 0:
        tab, loss_tab = net.mac_delay_tab, net.mac_loss_tab
        tab_n = tab.shape[0]
        occ_f = torch.clamp_min(n_assoc.to(_F32), 1.0)  # (A,)
        if offered_rate is not None:
            lam = cell_kernels.cell_sum_ordered(
                torch.where(on_air, assoc, A),
                torch.where(on_air, offered_rate, 0.0), A,
            )
            n_eff = torch.ones((A,), dtype=_F32, device=dev)
            for _ in range(8):
                n_eff = torch.minimum(
                    torch.clamp_min(lam * _interp(tab, n_eff), 1.0), occ_f
                )
            n_here_f = n_eff[assoc_c]  # continuous contender count
            mac_d = w_c * _interp(tab, n_here_f) / tab[1]
            mac_loss = _interp(loss_tab, n_here_f)
        else:
            n_c = torch.clamp(n_assoc[assoc_c], 0, tab_n - 1).long()
            mac_d = w_c * tab[n_c] / tab[1]
            mac_loss = loss_tab[n_c]
        acc = base + mac_d
    else:
        n_here = n_assoc[assoc_c].to(_F32)
        acc = mad(w_c.expand_as(n_here), n_here, base)
        mac_loss = torch.zeros((N,), dtype=_F32, device=dev)
    acc = torch.where(on_air, acc, net.node_acc)
    return LinkCache(
        assoc=assoc,
        n_assoc=n_assoc,
        attach_now=attach_now,
        acc_delay=acc,
        reachable=attach_now >= 0,
        d2b=_delay_to(net, attach_now, acc, broker),
        mac_loss_p=torch.where(on_air, mac_loss, 0.0),
    )


def pair_delay(
    net: NetParams, cache: LinkCache, src: torch.Tensor, dst: torch.Tensor
) -> torch.Tensor:
    """Vectorised message delay between node index tensors ``src``/``dst``."""
    return _delay_between(
        net,
        cache.attach_now[src], cache.acc_delay[src],
        cache.attach_now[dst], cache.acc_delay[dst],
    )


# ----------------------------------------------------------------------
# host-side builders (numpy; run once a scenario), copied from the JAX
# package
# ----------------------------------------------------------------------

def bianchi_fixed_point(
    n: int, cw_min: int = 31, n_stages: int = 5
) -> Tuple[float, float]:
    """Bianchi's two-equation DCF fixed point for n stations: (tau, p),
    the per-slot transmission probability and the conditional collision
    probability (Bianchi 2000, eqs. 7 and 9), with W = cw_min + 1 and
    ``n_stages`` backoff doublings, by a damped iteration."""
    W = cw_min + 1
    tau = 2.0 / (W + 1)
    for _ in range(200):
        p = 1.0 - (1.0 - tau) ** (n - 1)
        denom = (1 - 2 * p) * (W + 1) + p * W * (1 - (2 * p) ** n_stages)
        tau_new = 2 * (1 - 2 * p) / denom if abs(denom) > 1e-12 else 1e-6
        tau_new = min(max(tau_new, 1e-7), 1.0)
        prev = tau
        tau = 0.5 * tau + 0.5 * tau_new  # damped: stable for large n
        if abs(tau - prev) < 1e-12:
            break
    return tau, 1.0 - (1.0 - tau) ** (n - 1)


def bianchi_tables(
    n_max: int,
    cw_min: int = 31,  # wireless5.ini:67 cwMinData
    n_stages: int = 5,  # CWmax 1023 = 31 doubled 5 times (802.11g DCF)
    retry_limit: int = 7,  # wireless5.ini:66
    slot_s: float = 9e-6,  # 802.11g ERP slot
    sifs_s: float = 10e-6,
    difs_s: float = 28e-6,
    rate_bps: float = 54e6,  # wireless5.ini:64 mac.bitrate
    basic_bps: float = 6e6,  # :65 basicBitrate (ACKs)
    payload_bytes: int = 128,
    mac_header_bytes: int = 34,
    phy_preamble_s: float = 20e-6,
    ack_bytes: int = 14,
) -> Tuple[np.ndarray, np.ndarray]:
    """Bianchi DCF saturation tables for 0..n_max contending stations:
    the expected per-packet MAC access delay D(n) (backoff slots over the
    retry ladder times the expected slot length, plus a success) and the
    retry-exhaustion loss L(n) = p^(retryLimit+1), both float32."""
    W = cw_min + 1
    t_s = (
        phy_preamble_s
        + (mac_header_bytes + payload_bytes) * 8.0 / rate_bps
        + sifs_s
        + phy_preamble_s
        + ack_bytes * 8.0 / basic_bps
        + difs_s
    )
    t_c = (
        phy_preamble_s
        + (mac_header_bytes + payload_bytes) * 8.0 / rate_bps
        + difs_s
    )
    delays = np.zeros((n_max + 1,), np.float64)
    losses = np.zeros((n_max + 1,), np.float64)
    for n in range(1, n_max + 1):
        tau, p = bianchi_fixed_point(n, cw_min=cw_min, n_stages=n_stages)
        p_tr = 1.0 - (1.0 - tau) ** n
        p_s = n * tau * (1.0 - tau) ** (n - 1) / max(p_tr, 1e-12)
        e_slot = (
            (1 - p_tr) * slot_s + p_tr * p_s * t_s + p_tr * (1 - p_s) * t_c
        )
        # expected backoff slots summed over the retry ladder (stage j's
        # window doubles up to CWmax), weighted by reaching stage j
        ex, reach = 0.0, 1.0
        for j in range(retry_limit + 1):
            w_j = min(W * 2 ** min(j, n_stages), 1024)
            ex += reach * (w_j - 1) / 2.0
            reach *= p
        delays[n] = ex * e_slot + t_s
        losses[n] = p ** (retry_limit + 1)
    delays[0] = delays[1] if n_max >= 1 else 0.0
    return delays.astype(np.float32), losses.astype(np.float32)


def build_core_delay(
    n_infra: int,
    links: Sequence[Tuple[int, int, float, float]],
    packet_bytes: int = 128,
) -> np.ndarray:
    """All-pairs base delay over infrastructure attach points: links
    ``(i, j, datarate_bps, prop_delay_s)`` cost ``prop + serialisation``
    a hop, shortest paths by Floyd-Warshall."""
    d = np.full((n_infra, n_infra), np.inf, np.float64)
    np.fill_diagonal(d, 0.0)
    for i, j, rate, prop in links:
        cost = prop + (packet_bytes * 8.0) / rate
        d[i, j] = min(d[i, j], cost)
        d[j, i] = min(d[j, i], cost)
    for k in range(n_infra):
        d = np.minimum(d, d[:, k: k + 1] + d[k: k + 1, :])
    return d.astype(np.float32)


def make_net_params(
    n_nodes: int,
    core_delay: np.ndarray,
    node_attach: np.ndarray,
    is_wireless: np.ndarray,
    ap_nodes: Sequence[int] = (),
    ap_attach: Sequence[int] = (),
    ap_range=400.0,
    w_base: float = 2e-3,
    w_prop: float = 3.336e-9,
    w_contention: float = 1.5e-3,
    node_acc: Optional[np.ndarray] = None,
    mac_model: str = "bianchi",
    device=None,
) -> NetParams:
    """A :class:`NetParams` on ``device`` from host arrays.
    ``mac_model="bianchi"`` attaches the DCF saturation tables (when the
    world has APs); ``"linear"`` keeps the constant-per-station model."""
    dev = resolve_device(device)
    A = len(ap_nodes)
    ap_range_arr = (
        np.full((A,), ap_range, np.float32)
        if np.isscalar(ap_range)
        else np.asarray(ap_range, np.float32)
    )
    if node_acc is None:
        node_acc = np.zeros((n_nodes,), np.float32)
    if A > 0 and mac_model == "bianchi":
        mac_delay, mac_loss = bianchi_tables(n_nodes)
    elif mac_model in ("bianchi", "linear"):
        mac_delay = np.zeros((0,), np.float32)
        mac_loss = np.zeros((0,), np.float32)
    else:
        raise ValueError(f"unknown mac_model {mac_model!r}")

    def t(a, dt):
        return torch.as_tensor(np.array(a, dt), device=dev)

    return NetParams(
        core_delay=t(core_delay, np.float32),
        node_attach=t(node_attach, np.int32),
        node_acc=t(node_acc, np.float32),
        is_wireless=t(is_wireless, bool),
        ap_nodes=t(np.asarray(ap_nodes, np.int32), np.int32),
        ap_attach=t(np.asarray(ap_attach, np.int32), np.int32),
        ap_range=t(ap_range_arr, np.float32),
        w_base=t(w_base, np.float32),
        w_prop=t(w_prop, np.float32),
        w_contention=t(w_contention, np.float32),
        mac_delay_tab=t(mac_delay, np.float32),
        mac_loss_tab=t(mac_loss, np.float32),
    )


def wired_star(
    n_nodes: int, link_delay: float = 1e-4, rate: float = 100e6,
    packet_bytes: int = 128, device=None,
) -> NetParams:
    """All nodes wired to one switch: one infra point plus per-node
    access costs, ``delay(a, b) = acc_a + acc_b`` (the smoke shape)."""
    cost = link_delay + (packet_bytes * 8.0) / rate
    return make_net_params(
        n_nodes=n_nodes,
        core_delay=np.zeros((1, 1), np.float32),
        node_attach=np.zeros((n_nodes,), np.int32),
        is_wireless=np.zeros((n_nodes,), bool),
        node_acc=np.full((n_nodes,), cost, np.float32),
        device=device,
    )
