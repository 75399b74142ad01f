"""The port on a CUDA card: the kernels against their plain versions and a
card run against a CPU run.  Every test needs a card and skips elsewhere.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed: ``python -m pytest --noconftest -q
tests/test_torch_cuda.py`` (``--noconftest`` skips the JAX set-up of
``tests/conftest.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from fognetsimpp_tpu_torch.core import engine
from fognetsimpp_tpu_torch.ops import arrival_kernels as ak
from fognetsimpp_tpu_torch.ops import cell_kernels as ck
from fognetsimpp_tpu_torch.ops import pool_kernels as pk
from fognetsimpp_tpu_torch.ops import ring_kernels as rk
from fognetsimpp_tpu_torch.parallel.taskshard import run_tp_sharded
from fognetsimpp_tpu_torch.scenarios import smoke, wireless
from fognetsimpp_tpu_torch.spec import Policy
from fognetsimpp_tpu_torch.state import state_to_numpy
from fognetsimpp_tpu_torch.scenarios.cell_sum_inputs import large_cells, replicas
from fognetsimpp_tpu_torch.scenarios.pool_scan_inputs import KINDS as SCAN_KINDS
from fognetsimpp_tpu_torch.scenarios.pool_scan_inputs import rows as scan_rows


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    # TF32 on: no leaf may depend on it (the engine runs no f32 matmul)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _window(K, F, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(K) < 0.7
    fog = rng.integers(0, F, K).astype(np.int32)
    t = np.round(rng.random(K) * 0.01, 4).astype(np.float32)
    f_key = np.where(mask, fog, F).astype(np.int32)
    t_key = np.where(mask, t, np.inf).astype(np.float32)
    return [torch.from_numpy(a) for a in (mask, f_key, t_key)]


@pytest.mark.parametrize(
    "K, F", [(4096, 32), (1000, 7), (1, 1), (2048, 1024), (5000, 3), (9000, 64)]
)
def test_kernels_equal_plain(cuda, K, F):
    cpu = _window(K, F, seed=K * 7 + F)
    dev = [a.to(cuda) for a in cpu]
    got = ak.fused_arrival_plan(*dev, F)
    rank = ak.pairwise_rank(*dev)
    torch.cuda.synchronize()
    want = ak.fused_arrival_plan_plain(*cpu, F)
    for name, w, g in zip(("rank", "counts", "t_min", "first"), want, got):
        assert g.dtype == w.dtype, name
        assert torch.equal(g.cpu(), w), name
    assert torch.equal(rank.cpu(), ak.pairwise_rank_plain(*cpu))


def _kind_window(kind, K, F, seed):
    """Windows that take the kernels' other paths: ``one_fog`` (every
    masked row in one fog, as at the tp world's tick 0), ``empty``,
    ``all_ties`` (one time for every row), ``signed_zero`` (+0.0 and -0.0
    among the times) and ``any_key`` (masked rows keyed by any int32,
    negative and past F included)."""
    mask, f_key, t_key = _window(K, F, seed)
    rng = np.random.default_rng(seed + 1)
    if kind == "one_fog":
        mask = torch.ones(K, dtype=torch.bool)
        f_key = torch.full((K,), F - 1, dtype=torch.int32)
        t_key = torch.from_numpy(np.round(rng.random(K) * 0.01, 4).astype(np.float32))
    elif kind == "empty":
        mask = torch.zeros(K, dtype=torch.bool)
        f_key = torch.full((K,), F, dtype=torch.int32)
        t_key = torch.full((K,), float("inf"))
    elif kind == "all_ties":
        t_key = torch.where(mask, torch.tensor(0.0025), torch.tensor(float("inf")))
    elif kind == "signed_zero":
        t = rng.choice(np.array([0.0, -0.0, 1e-4], np.float32), K)
        t_key = torch.where(mask, torch.from_numpy(t), torch.tensor(float("inf")))
    elif kind == "any_key":
        keys = rng.choice(
            np.array([0, 1, F - 1, F, 2048, 4096 + 1, -1, -2 ** 31, 2 ** 31 - 1]), K
        ).astype(np.int32)
        f_key = torch.where(mask, torch.from_numpy(keys), torch.tensor(F, dtype=torch.int32))
    return [mask, f_key.to(torch.int32), t_key.to(torch.float32)]


def _assert_kernels_equal_plain(cpu, F, device, pairwise=True):
    ak.reset_launches()
    dev = [a.to(device) for a in cpu]
    got = ak.fused_arrival_plan(*dev, F) if F <= ak.FUSED_MAX_FOGS else None
    rank = ak.pairwise_rank(*dev) if pairwise else None
    torch.cuda.synchronize()
    if got is not None:
        want = ak.fused_arrival_plan_plain(*cpu, F)
        for name, w, g in zip(("rank", "counts", "t_min", "first"), want, got):
            assert g.dtype == w.dtype, name
            # bit for bit: t_min's -0.0 and +0.0 differ here
            assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32)), name
        assert ak.LAUNCHES["fused_arrival_plan"] == 1
    if rank is not None:
        assert torch.equal(rank.cpu(), ak.pairwise_rank_plain(*cpu))
        assert ak.LAUNCHES["pairwise_rank"] == 1


@pytest.mark.parametrize("K", [1, 4096, 8193, 40000])
def test_kernels_equal_plain_on_one_fog_windows(cuda, K):
    _assert_kernels_equal_plain(_kind_window("one_fog", K, 64, seed=K), 64, cuda)


@pytest.mark.parametrize(
    "kind, K, F",
    [
        ("empty", 4096, 32), ("empty", 136568, 64), ("empty", 1, 1),
        ("all_ties", 4096, 32), ("all_ties", 9000, 2),
        ("signed_zero", 4096, 32), ("signed_zero", 6000, 1),
        ("any_key", 4096, 32), ("any_key", 1000, 1040),
    ],
)
def test_kernels_equal_plain_on_other_windows(cuda, kind, K, F):
    _assert_kernels_equal_plain(_kind_window(kind, K, F, seed=K + F), F, cuda)


@pytest.mark.parametrize("c", [256, 257, 512, 513, 4096, 4097, 8192, 12289])
def test_kernels_equal_plain_at_run_edges(cuda, c):
    """One fog holding exactly c masked rows of a wider window: the edge of
    the kernels' direct count (256 keys) and of a sorted run (4,096)."""
    K, F = c + 777, 5
    mask, f_key, t_key = _window(K, F, seed=c)
    mask[:] = False
    mask[torch.randperm(K, generator=torch.Generator().manual_seed(c))[:c]] = True
    f_key = torch.where(mask, torch.tensor(3, dtype=torch.int32), torch.tensor(F, dtype=torch.int32))
    t_key = torch.where(mask, t_key.clamp(max=0.01), torch.tensor(float("inf")))
    _assert_kernels_equal_plain([mask, f_key, t_key], F, cuda)


def test_kernels_break_a_signed_zero_tie_by_position(cuda):
    t = torch.tensor([0.0, -0.0, 0.0, -0.0, 1.0])
    cpu = [torch.ones(5, dtype=torch.bool), torch.zeros(5, dtype=torch.int32), t]
    _assert_kernels_equal_plain(cpu, 1, cuda)
    rank, _, t_min, first = ak.fused_arrival_plan(*[a.to(cuda) for a in cpu], 1)
    assert rank.tolist() == [0, 1, 2, 3, 4] and first.tolist() == [0]
    assert t_min.view(torch.int32).tolist() == [-(2 ** 31)]  # -0.0, as XLA's min


@pytest.mark.parametrize("flip", [False, True])
def test_kernel_t_min_keeps_the_sign_of_zero(cuda, flip):
    """Fogs whose zeros are all +0.0, mixed, all -0.0, or absent, spread
    over many blocks of rows: t_min bit for bit as the plain version."""
    K, F = 20_000, 6
    rng = np.random.default_rng(11)
    fog = rng.integers(0, 4, K).astype(np.int32)
    t = rng.choice(np.array([1e-4, 2e-4], np.float32), K)
    zeros = {0: [0.0], 1: [0.0, -0.0], 2: [-0.0]}  # fog 3 has none
    for f, vals in zeros.items():
        rows = rng.choice(np.flatnonzero(fog == f), 50, replace=False)
        t[rows] = rng.choice(np.array(vals, np.float32), 50)
    if flip:
        fog, t = fog[::-1].copy(), t[::-1].copy()
    mask = np.ones(K, bool)
    cpu = [torch.from_numpy(a) for a in (mask, fog, t)]
    _assert_kernels_equal_plain(cpu, F, cuda)
    t_min = ak.fused_arrival_plan(*[a.to(cuda) for a in cpu], F)[2].cpu()
    assert torch.signbit(t_min[:3]).tolist() == [False, True, True]


@pytest.mark.parametrize(
    "K, F", [(4096, 1024), (1024, 1040), (3001, 1040), (2048, 3000)]
)
def test_kernels_equal_plain_at_wide_fog_axes(cuda, K, F):
    """F = 1,024 is the fused kernel's edge; past it ``pairwise_rank``
    carries the plan (1,040 fogs: the wide-fog world).  Past 2,048 fogs
    two fogs share a bucket of ``pairwise_rank``."""
    _assert_kernels_equal_plain(_window(K, F, seed=K * 3 + F), F, cuda)


def test_wrappers_do_not_synchronise(cuda):
    """Grids follow K and F: no wrapper call waits for the card."""
    dev = [a.to(cuda) for a in _window(9000, 64, seed=5)]
    ak.fused_arrival_plan(*dev, 64)  # builds the library first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ak.fused_arrival_plan(*dev, 64)
        ak.pairwise_rank(*dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_wrappers_refuse_bad_inputs(cuda):
    mask, f_key, t_key = [a.to(cuda) for a in _window(64, 4, 0)]
    with pytest.raises(TypeError):
        ak.pairwise_rank(mask, f_key.long(), t_key)
    with pytest.raises(ValueError):
        ak.fused_arrival_plan(mask, f_key, t_key, 2000)
    with pytest.raises(ValueError):
        ak.pairwise_rank(mask, f_key[::2], t_key[::2])


@pytest.mark.parametrize("kw", [
    dict(horizon=0.5),
    dict(n_users=256, n_fogs=8, send_interval=0.0025, horizon=0.05, dt=5e-3,
         max_sends_per_tick=2, queue_capacity=16, derive_acks=True,
         arrival_window=256),
])
def test_card_run_equals_cpu_run(cuda, kw):
    ak.reset_launches()
    spec, st, net, b = smoke.build(device=cuda, **kw)
    card, _ = engine.run(spec, st, net, b)
    launches = ak.LAUNCHES["fused_arrival_plan"]
    spec, st, net, b = smoke.build(device="cpu", **kw)
    cpu, _ = engine.run(spec, st, net, b)
    for a, c in zip(state_to_numpy(card), state_to_numpy(cpu)):
        assert a.dtype == c.dtype and a.tobytes() == c.tobytes()
    assert 0 < launches <= spec.n_ticks


@pytest.mark.parametrize(
    "n, K, C", [(2, 1000, 4), (4, 34142, 4), (8, 777, 5), (3, 1, 5), (1, 64, 4)]
)
def test_ring_kernel_equals_plain(cuda, n, K, C):
    rng = np.random.default_rng(n * 1000 + K + C)
    cpu = [
        torch.from_numpy(
            rng.integers(-2 ** 31, 2 ** 31, (K, C), dtype=np.int64).astype(np.int32)
        )
        for _ in range(n)
    ]
    rk.reset_launches()
    got = rk.ring_all_gather([b.to(cuda) for b in cpu])
    torch.cuda.synchronize()
    assert rk.LAUNCHES["ring_all_gather"] == 1
    want = rk.ring_all_gather_plain(cpu)
    assert len(got) == n
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.is_cuda
        assert torch.equal(g.cpu(), w)


def test_ring_wrapper_refuses_bad_blocks(cuda):
    a = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        rk.ring_all_gather([a, a.float()])
    with pytest.raises(ValueError):
        rk.ring_all_gather([a, a[:4]])
    with pytest.raises(ValueError):
        rk.ring_all_gather([a, a.cpu()])
    with pytest.raises(ValueError):
        rk.ring_all_gather([a] * (rk.MAX_SHARDS + 1))


TP_SMALL = dict(
    n_users=512, n_fogs=8, fog_mips=(1000.0, 2000.0, 3000.0, 4000.0),
    send_interval=0.05, horizon=0.1, dt=5e-3, max_sends_per_user=6,
    queue_capacity=128, start_time_max=0.025, derive_acks=True,
)


@pytest.mark.parametrize("kw, window", [
    (TP_SMALL, 3),  # the bounded no-window exchange: the ring kernel
    (dict(TP_SMALL, arrival_window=16), None),  # the windowed top-K merge
])
def test_tp_card_run_equals_cpu_run(cuda, kw, window):
    ak.reset_launches()
    rk.reset_launches()
    spec, st, net, b = smoke.build(device=cuda, **kw)
    _, card = run_tp_sharded(spec, st, net, b, n_shards=4, exchange_window=window)
    torch.cuda.synchronize()
    rings = rk.LAUNCHES["ring_all_gather"]
    plans = ak.LAUNCHES["fused_arrival_plan"]
    spec, st, net, b = smoke.build(device="cpu", **kw)
    _, cpu = run_tp_sharded(spec, st, net, b, n_shards=4, exchange_window=window)
    for a, c in zip(state_to_numpy(card), state_to_numpy(cpu)):
        assert a.dtype == c.dtype and a.tobytes() == c.tobytes()
    assert rings == (spec.n_ticks if window is not None else 0)
    assert plans == 4 * spec.n_ticks


def _cell_case(kind, seed=0):
    """Inputs of the ordered per-cell sum: config 4's shape (10,069
    nodes, 64 cells, inexact rates, the drop cell 64 among them), every
    entry in one cell, cells at and past ``n_cells`` (dropped), values
    whose sum depends on the order of the adds, and no entries; 16
    replicas of config 4 flattened, cells past a warp's sort and past a
    sorted run, many cells with and without entries."""
    rng = np.random.default_rng(seed)
    if kind == "replicas":
        cell, vals, A = _cell_case("config4", seed)
        cell, vals, A = replicas(cell.numpy(), vals.numpy(), A, 16)
    elif kind == "large_cells":
        cell, vals, A = large_cells(seed)
    elif kind == "many_cells":
        n, A = 3000, 5000
        cell = rng.integers(-3, A + 5, n)
        vals = rng.random(n) * 7
    elif kind == "many_cells_empty":
        n, A = 0, 300
        cell, vals = np.zeros(0), np.zeros(0)
    elif kind == "config4":
        n, A = 10_069, 64
        cell = rng.integers(0, A + 1, n)
        vals = rng.choice(np.array([1 / 1.5, 1 / 0.05, 0.1, 1 / 3]), n)
    elif kind == "one_cell":
        n, A = 10_000, 64
        cell = np.full(n, 17)
        vals = rng.random(n) * 30
    elif kind == "dropped":
        n, A = 3000, 10
        cell = rng.integers(-3, A + 5, n)
        vals = rng.random(n) * 7
    elif kind == "order":
        n, A = 9000, 3
        cell = rng.integers(0, A, n)
        vals = rng.choice(np.array([1e8, 1.0, -1e8, 3.3, 0.1, -0.0]), n)
    elif kind == "empty":
        n, A = 0, 5
        cell, vals = np.zeros(0), np.zeros(0)
    else:
        raise KeyError(kind)
    return torch.from_numpy(cell.astype(np.int32)), torch.from_numpy(vals.astype(np.float32)), A


#: ``cell_kernels.ONE_BLOCK_MAX_TILES`` by tier: the wrapper's own choice,
#: or one tier forced on every input.
_CELL_TIERS = {"auto": ck.ONE_BLOCK_MAX_TILES, "one_block": 2 ** 62, "segments": -1}


@pytest.mark.parametrize("tier", sorted(_CELL_TIERS))
@pytest.mark.parametrize("kind", [
    "config4", "one_cell", "dropped", "order", "empty",
    "replicas", "large_cells", "many_cells", "many_cells_empty",
])
def test_cell_sum_kernel_equals_plain(cuda, monkeypatch, kind, tier):
    monkeypatch.setattr(ck, "ONE_BLOCK_MAX_TILES", _CELL_TIERS[tier])
    cell, vals, A = _cell_case(kind)
    ck.reset_launches()
    got = ck.cell_sum_ordered(cell.to(cuda), vals.to(cuda), A)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["cell_sum_ordered"] == 1
    want = ck.cell_sum_ordered_plain(cell, vals, A)
    assert got.dtype == torch.float32 and got.is_cuda
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("tier", sorted(_CELL_TIERS))
def test_cell_sum_kernel_adds_a_large_cell_in_index_order(cuda, monkeypatch, tier):
    """100,003 entries in one cell, past every sorted run: the sum against
    numpy's sequential float32 accumulate from +0.0 in index order (the
    plain version's rounds would take minutes here)."""
    monkeypatch.setattr(ck, "ONE_BLOCK_MAX_TILES", _CELL_TIERS[tier])
    rng = np.random.default_rng(5)
    n, A = 100_003, 64
    vals = (rng.random(n) * 30).astype(np.float32)
    want = np.zeros(A, np.float32)
    want[17] = np.add.accumulate(np.concatenate([[0.0], vals]).astype(np.float32),
                                 dtype=np.float32)[-1]
    cell = torch.full((n,), 17, dtype=torch.int32, device=cuda)
    got = ck.cell_sum_ordered(cell, torch.from_numpy(vals).to(cuda), A)
    assert got.cpu().numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("tier", sorted(_CELL_TIERS))
@pytest.mark.parametrize("kind", ["config4", "replicas", "large_cells"])
def test_cell_sum_wrapper_does_not_synchronise(cuda, monkeypatch, kind, tier):
    """Every tier: the tier and the grids follow N and A only."""
    monkeypatch.setattr(ck, "ONE_BLOCK_MAX_TILES", _CELL_TIERS[tier])
    cell, vals, A = _cell_case(kind)
    cell, vals = cell.to(cuda), vals.to(cuda)
    ck.cell_sum_ordered(cell, vals, A)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ck.cell_sum_ordered(cell, vals, A)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_cell_sum_wrapper_refuses_bad_inputs(cuda):
    cell = torch.zeros(8, dtype=torch.int32, device=cuda)
    vals = torch.zeros(8, device=cuda)
    with pytest.raises(TypeError):
        ck.cell_sum_ordered(cell.long(), vals, 4)
    with pytest.raises(ValueError):
        ck.cell_sum_ordered(cell[::2], vals[::2], 4)
    with pytest.raises(ValueError):
        ck.cell_sum_ordered(cell, vals.cpu(), 4)


@pytest.mark.parametrize("builder, kw", [
    ("wireless2", dict(horizon=1.0, dt=5e-3)),
    ("wireless5", dict(numb_users=300, horizon=1.0, dt=0.01, extra_aps=8,
                       policy=int(Policy.ENERGY_AWARE), uplink_loss_prob=0.1)),
])
def test_wireless_card_run_equals_cpu_run(cuda, builder, kw):
    ak.reset_launches()
    ck.reset_launches()
    spec, st, net, b = getattr(wireless, builder)(device=cuda, **kw)
    card, _ = engine.run(spec, st, net, b)
    torch.cuda.synchronize()
    sums, plans = ck.LAUNCHES["cell_sum_ordered"], ak.LAUNCHES["fused_arrival_plan"]
    spec, st, net, b = getattr(wireless, builder)(device="cpu", **kw)
    cpu, _ = engine.run(spec, st, net, b)
    for a, c in zip(state_to_numpy(card), state_to_numpy(cpu)):
        assert a.dtype == c.dtype and a.tobytes() == c.tobytes()
    assert sums == spec.n_ticks  # one Bianchi keying a tick
    assert 0 < plans <= spec.n_ticks


#: A wired world on the compacted broker, small enough for the CPU run.
_COMPACT = dict(
    n_users=64, n_fogs=4, fog_mips=(40000.0, 80000.0, 20000.0, 60000.0),
    send_interval=0.01, horizon=0.1, start_time_max=0.02, queue_capacity=16,
    derive_acks=False,
)
_COMPACT_POLICIES = {
    "round_robin": dict(policy=int(Policy.ROUND_ROBIN)),
    "random": dict(policy=int(Policy.RANDOM)),
    "ucb": dict(policy=int(Policy.UCB)),
    "ducb": dict(policy=int(Policy.DUCB)),
    "exp3": dict(policy=int(Policy.EXP3)),
    "dynamic": dict(policy=int(Policy.DYNAMIC), learn_in_dynamic=True),
    # the dense broker's world, for the no-sync check of its tick
    "min_busy_dense": dict(policy=int(Policy.MIN_BUSY), derive_acks=True),
}


def _compact_world(device, name):
    spec, st, net, b = smoke.build(device=device, **{**_COMPACT, **_COMPACT_POLICIES[name]})
    if name == "dynamic":  # the traced id names EXP3
        st = st.replace(broker=st.broker.replace(
            policy_id=torch.full((), int(Policy.EXP3), dtype=torch.int32, device=device)))
    return spec, st, net, b


@pytest.mark.parametrize("name", sorted(_COMPACT_POLICIES))
def test_compacted_card_run_equals_cpu_run(cuda, name):
    ak.reset_launches()
    spec, st, net, b = _compact_world(cuda, name)
    card, _ = engine.run(spec, st, net, b)
    torch.cuda.synchronize()
    launches = ak.LAUNCHES["fused_arrival_plan"]
    spec, st, net, b = _compact_world("cpu", name)
    cpu, _ = engine.run(spec, st, net, b)
    for a, c in zip(state_to_numpy(card), state_to_numpy(cpu)):
        assert a.dtype == c.dtype and a.tobytes() == c.tobytes()
    assert 0 < launches <= spec.n_ticks
    if spec.learn_active:
        assert float(cpu.learn.lat_cnt) > 0


@pytest.mark.parametrize(
    "name", ["ucb", "exp3", "round_robin", "dynamic", "min_busy_dense"]
)
def test_compacted_broker_tick_does_not_synchronise(cuda, name):
    """A whole tick of a compacted-broker world (the broker's decisions,
    the learners' bookkeeping and credit, the arrival kernel) waits for
    the card nowhere: no host copy, no read of a device value.  The dense
    broker's tick, beside it, neither."""
    from fognetsimpp_tpu_torch.net.topology import associate

    spec, st, net, b = _compact_world(cuda, name)
    step = engine.make_step(spec)
    cache = associate(net, st.nodes.pos, st.nodes.alive, spec.broker_index)
    for _ in range(30):  # past the first decisions and credits
        st = step(st, net, b, cache)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = step(st, net, b, cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(st.metrics.n_scheduled) > 0


# ----------------------------------------------------------------------
# the replica axis on the card
# ----------------------------------------------------------------------

#: Small replica worlds, card against CPU: config 3's world cut to 32
#: users x 6 fogs, config 4's cut to 40 users, and UCB's credit phase.
_REPLICA_WORLDS = {
    "min_latency": ("smoke", dict(
        n_users=32, n_fogs=6, policy=int(Policy.MIN_LATENCY), send_interval=0.01,
        horizon=0.04, dt=1e-3, max_sends_per_user=8, arrival_window=64,
        start_time_max=0.02)),
    "wireless5": ("wireless5", dict(
        numb_users=40, horizon=0.1, dt=5e-3, extra_aps=4, mac_model="bianchi",
        policy=int(Policy.ENERGY_AWARE))),
    "ucb": ("smoke", dict(_COMPACT, policy=int(Policy.UCB))),
}


def _replica_world(device, name, R=4):
    from fognetsimpp_tpu_torch.parallel.replicas import replicate_state

    builder, kw = _REPLICA_WORLDS[name]
    build = smoke.build if builder == "smoke" else getattr(wireless, builder)
    spec, st, net, b = build(device=device, **kw)
    return spec, replicate_state(spec, st, R, seed=5), net, b


@pytest.mark.parametrize("name", sorted(_REPLICA_WORLDS))
def test_replica_batch_card_equals_cpu(cuda, name):
    """``run_batched`` on the card against the same batch on the CPU,
    every leaf, with one wrapper call of each kernel a tick for all
    replicas and no per-replica fallback."""
    from fognetsimpp_tpu_torch.parallel.replicas import strict_vmap

    ak.reset_launches()
    ck.reset_launches()
    with strict_vmap():
        spec, batch, net, b = _replica_world(cuda, name)
        card, _ = engine.run_batched(spec, batch, net, b)
        torch.cuda.synchronize()
        plans = ak.LAUNCHES["fused_arrival_plan"] + ak.LAUNCHES["pairwise_rank"]
        sums = ck.LAUNCHES["cell_sum_ordered"]
        spec, batch, net, b = _replica_world("cpu", name)
        cpu, _ = engine.run_batched(spec, batch, net, b)
    for a, c in zip(state_to_numpy(card), state_to_numpy(cpu)):
        assert a.dtype == c.dtype and a.tobytes() == c.tobytes()
    assert plans == spec.n_ticks
    assert sums == (spec.n_ticks if spec.n_aps else 0)


@pytest.mark.parametrize("R, K, F", [(4, 2048, 32), (128, 1556, 4), (64, 256, 24)])
def test_kernel_rules_on_card_equal_plain(cuda, R, K, F):
    """The batching rules on the card: R windows end to end in one call
    (the fused kernel up to 1,024 fogs, past it the rank kernel and the
    reductions a replica), each replica equal to its plain window."""
    from fognetsimpp_tpu_torch.parallel.replicas import strict_vmap

    rng = np.random.default_rng(R * K + F)
    mask = rng.random((R, K)) < 0.6
    mask[1] = False  # an empty replica
    fog = rng.integers(0, F, (R, K)).astype(np.int32)
    t = np.round(rng.random((R, K)) * 0.01, 4).astype(np.float32)
    cpu = [torch.from_numpy(a) for a in (
        mask, np.where(mask, fog, F).astype(np.int32),
        np.where(mask, t, np.inf).astype(np.float32))]
    ak.reset_launches()
    with strict_vmap():
        got = torch.func.vmap(lambda m, f, k: ak.fused_arrival_plan(m, f, k, F))(
            *[a.to(cuda) for a in cpu])
    torch.cuda.synchronize()
    assert ak.LAUNCHES["fused_arrival_plan"] + ak.LAUNCHES["pairwise_rank"] == 1
    for r in range(R):
        want = ak.fused_arrival_plan_plain(cpu[0][r], cpu[1][r], cpu[2][r], F)
        for g, w in zip(got, want):
            assert g[r].dtype == w.dtype and g[r].cpu().numpy().tobytes() == w.numpy().tobytes()


def test_cell_sum_rule_on_card(cuda):
    """config 4's per-cell sum laid end to end over 128 replicas in one
    call (the segments tier), each replica equal to its plain sum."""
    from fognetsimpp_tpu_torch.parallel.replicas import strict_vmap

    cell, vals, A = _cell_case("config4")
    R = 128
    rng = np.random.default_rng(1)
    perms = [rng.permutation(cell.shape[0]) for _ in range(R)]
    c = torch.stack([cell[p] for p in perms])
    v = torch.stack([vals[p] for p in perms])
    ck.reset_launches()
    with strict_vmap():
        got = torch.func.vmap(lambda a, x: ck.cell_sum_ordered(a, x, A))(
            c.to(cuda), v.to(cuda))
    torch.cuda.synchronize()
    assert ck.LAUNCHES["cell_sum_ordered"] == 1
    for r in (0, 1, R - 1):
        want = ck.cell_sum_ordered_plain(c[r], v[r], A)
        assert got[r].cpu().numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.parametrize("name", ["min_latency", "ucb"])
def test_batched_tick_does_not_synchronise(cuda, name):
    """A tick of a wired replica batch waits for the card nowhere either.
    (A wireless tick copies ``sinf``'s tables from the host, replicas or
    not: ``ROADMAP.md`` item 19.)"""
    from fognetsimpp_tpu_torch.parallel.replicas import strict_vmap

    spec, batch, net, b = _replica_world(cuda, name)
    with strict_vmap():
        tick, _ = engine.batched_tick(spec, net, b, batch)
        for _ in range(8):
            batch = tick(batch)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            batch = tick(batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert int(batch.metrics.n_published.sum()) > 0


@pytest.mark.parametrize("name", ["min_latency", "ucb"])
def test_fleet_slot_tick_does_not_synchronise(cuda, name):
    """The fleet's mesh waits for the card nowhere: a process's rows cut
    from the batch, its rows of the promoted knobs, the folded keys of a
    ``fleet_decisions`` fleet and a tick of those rows; and the two-slot
    fleet equals the one-slot fleet, every leaf."""
    from fognetsimpp_tpu_torch.parallel import fleet, mesh
    from fognetsimpp_tpu_torch.parallel.replicas import strict_vmap
    from fognetsimpp_tpu_torch.random import PRNGKey

    spec, batch, net, b = _replica_world(cuda, name)
    R = batch.t.shape[0]
    two = mesh.make_mesh(2, device=cuda)
    with strict_vmap():
        rows, net, b = mesh.shard_world(batch, net, b, two)
        run_spec, knobs = fleet._run_rows(spec, two, R, rows, True)
        tick, _ = engine.batched_tick(run_spec, net, b, rows.state, knobs)
        state = rows.state
        for _ in range(8):
            state = tick(state)
        key = PRNGKey(5, cuda)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            rows, _, _ = mesh.shard_world(batch, net, b, two)
            _, knobs = fleet._run_rows(spec, two, R, rows, True)
            keys = fleet.fold_replica_keys(key, R)
            state = tick(rows.state.replace(key=keys[rows.start:rows.stop]))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        one = fleet.run_fleet(spec, batch, net, b, mesh.make_mesh(1, device=cuda), n_ticks=10)
        split = fleet.run_fleet(spec, batch, net, b, two, n_ticks=10)
    assert int(state.metrics.n_published.sum()) > 0
    for x, y in zip(state_to_numpy(one), state_to_numpy(split)):
        assert x.tobytes() == y.tobytes()


# ----------------------------------------------------------------------
# the promoted knobs on the card
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ucb", "min_busy_dense"])
def test_promoted_tick_and_operand_do_not_synchronise(cuda, name):
    """``dyn_to_device`` (one pinned copy), a promoted tick (every knob
    read from the operand) and a batched tick on knob rows wait for the
    card nowhere; the promoted card run equals the promoted CPU run."""
    from fognetsimpp_tpu_torch import dynspec
    from fognetsimpp_tpu_torch.net.topology import associate
    from fognetsimpp_tpu_torch.parallel.replicas import replicate_state, strict_vmap

    spec, st, net, b = _compact_world(cuda, name)
    spec = dataclasses.replace(spec, learn_reward_scale=0.3, send_stop_time=0.2,
                               uplink_loss_prob=0.05)
    key, host = dynspec.split_spec(spec)
    step = engine.make_step(key)
    cache = associate(net, st.nodes.pos, st.nodes.alive, spec.broker_index)
    dyn = dynspec.dyn_to_device(host, cuda)
    for _ in range(30):
        st = step(st, net, b, cache, dyn)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dyn = dynspec.dyn_to_device(dynspec.dyn_of(dynspec.apply_knobs(
            spec, {"learn_reward_scale": 0.25})), cuda)
        rows = dynspec.dyn_rows([host, host], cuda)
        st = step(st, net, b, cache, dyn)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(st.metrics.n_scheduled) > 0
    batch = replicate_state(key, st, 2)
    with strict_vmap():
        tick, _ = engine.batched_tick(key, net, b, batch, rows)
        batch = tick(batch)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            batch = tick(batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    card = engine.run_chunked(spec, *_compact_world(cuda, name)[1:], chunk_ticks=25)
    cpu_spec, cpu_st, cpu_net, cpu_b = _compact_world("cpu", name)
    cpu = engine.run_chunked(spec, cpu_st, cpu_net, cpu_b, chunk_ticks=25)
    for a, c in zip(state_to_numpy(card), state_to_numpy(cpu)):
        assert a.dtype == c.dtype and a.tobytes() == c.tobytes()


# ----------------------------------------------------------------------
# the local-pool scan and the v1/v2 worlds
# ----------------------------------------------------------------------

def _scan_rows(R, K, seed, kind="uniform"):
    """R sorted windows as rows (``scenarios.pool_scan_inputs.rows``)."""
    return [torch.from_numpy(np.asarray(a)) for a in scan_rows(kind, R, K, seed)]


#: (kind, R, K): the uniform windows at the lengths around a warp's 32
#: rows, past one stage (512) and far past it, and 128 worlds; every kind
#: at 128 worlds; the dense window past many stages.
_SCAN_CASES = (
    [("uniform", R, K) for R, K in ((1, 4096), (8, 4096), (3, 1), (5, 5000), (1, 1),
                                    (1, 31), (1, 33), (1, 70000), (128, 4096))]
    + [(kind, 128, 4096) for kind in SCAN_KINDS[1:]]
    + [("dense", 1, 70000), ("timer_fire", 1, 70000)]
)


@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("kind, R, K", _SCAN_CASES)
def test_pool_scan_kernel_equals_plain(cuda, kind, R, K, v2):
    cpu = _scan_rows(R, K, seed=R * 31 + K + v2 + 7 * SCAN_KINDS.index(kind), kind=kind)
    got = pk.local_pool_scan_rows(*[a.to(cuda) for a in cpu], v2)
    torch.cuda.synchronize()
    want = pk.local_pool_scan_plain(*cpu, v2)
    for g, w in zip(got, want):
        # bit for bit: -0.0 and +0.0 differ here
        g = g.cpu()
        assert g.dtype == w.dtype and g.numpy().tobytes() == w.numpy().tobytes()


def test_pool_scan_rule_makes_one_launch(cuda):
    rows = [a.to(cuda) for a in _scan_rows(8, 4096, seed=7)]
    pk.reset_launches()
    got = torch.func.vmap(lambda *a: pk.local_pool_scan(*a, True))(*rows)
    assert pk.LAUNCHES["local_pool_scan"] == 1
    want = pk.local_pool_scan_plain(*[a.cpu() for a in rows], True)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_pool_scan_wrapper_does_not_synchronise_and_refuses_bad_inputs(cuda):
    rows = [a.to(cuda) for a in _scan_rows(1, 4096, seed=3)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pk.local_pool_scan_rows(*rows, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    with pytest.raises(TypeError):
        pk.local_pool_scan_rows(rows[0].double(), *rows[1:], True)
    with pytest.raises(ValueError):
        pk.local_pool_scan_rows(rows[0][:, ::2], *rows[1:], True)


V1V2_WORLDS = {
    "v1_pool": dict(n_users=64, n_fogs=4, fog_model=1, app_gen=1, policy=5,
                    broker_mips=3000.0, adv_periodic=True, adv_on_completion=False,
                    horizon=0.1, send_interval=0.005, start_time_max=0.01),
    "v2_hybrid": dict(n_users=64, n_fogs=4, fog_model=1, app_gen=2, policy=5,
                      broker_mips=3000.0, v2_local_broker=True, adv_periodic=True,
                      adv_on_completion=False, horizon=0.1, send_interval=0.004,
                      start_time_max=0.01),
    "front_droptail": dict(n_users=256, n_fogs=4, two_stage_arrivals=False,
                           wired_queue_enabled=True, send_interval=1e-3,
                           horizon=0.05, queue_capacity=16),
}


@pytest.mark.parametrize("name", sorted(V1V2_WORLDS))
def test_v1v2_card_run_equals_cpu_run(cuda, name):
    kw = V1V2_WORLDS[name]
    runs = []
    for device in (cuda, "cpu"):
        spec, st, net, b = smoke.build(device=device, **kw)
        pk.reset_launches()
        runs.append(state_to_numpy(engine.run(spec, st, net, b)[0]))
        if device == cuda and name != "front_droptail":
            assert pk.LAUNCHES["local_pool_scan"] == spec.n_ticks
    for a, c in zip(*runs):
        assert a.dtype == c.dtype and a.tobytes() == c.tobytes()


# ----------------------------------------------------------------------
# chaos and the federated hierarchy on the card
# ----------------------------------------------------------------------

_CHAOS = dict(
    n_users=64, n_fogs=4, fog_mips=(40000.0, 80000.0), send_interval=0.01,
    horizon=0.06, start_time_max=0.02, assume_static=False, chaos=True,
    chaos_mode=1, chaos_mtbf_s=0.02, chaos_mttr_s=0.01, chaos_max_retries=3,
    chaos_script=((1, 0.01, 0.03),), chaos_rtt_amp=0.5, chaos_rtt_burst_prob=0.2,
    derive_acks=False,
)
_IMBALANCED = dict(
    n_users=64, n_fogs=4, fog_mips=(900.0, 60000.0, 60000.0, 60000.0),
    send_interval=0.01, horizon=0.06, n_brokers=2, hier_policy=1,
    hier_threshold=0.5, hier_max_hops=2, hier_rtt_s=0.005, derive_acks=False,
)
_FAULT_WORLDS = {
    "chaos_min_busy": dict(_CHAOS),
    "chaos_exp3": dict(_CHAOS, policy=int(Policy.EXP3)),
    "chaos_lose": dict(_CHAOS, chaos_mode=0),
    "hier_min_busy": dict(_IMBALANCED),
    "hier_exp3": dict(_IMBALANCED, policy=int(Policy.EXP3)),
}


def _fault_world(device, name):
    from fognetsimpp_tpu_torch.hier import stamp_ownership

    spec, st, net, b = smoke.build(device=device, **_FAULT_WORLDS[name])
    if spec.hier_active:
        st = stamp_ownership(spec, st, user_broker=[0] * spec.n_users,
                             fog_broker=[0, 1, 1, 1])
    return spec, st, net, b


@pytest.mark.parametrize("name", sorted(_FAULT_WORLDS))
def test_chaos_and_hier_card_runs_equal_cpu_runs(cuda, name):
    runs = []
    for device in (cuda, "cpu"):
        spec, st, net, b = _fault_world(device, name)
        runs.append(engine.run(spec, st, net, b)[0])
    for a, c in zip(*(state_to_numpy(r) for r in runs)):
        assert a.dtype == c.dtype and a.tobytes() == c.tobytes()
    final = runs[1]
    if spec.chaos:
        assert int(final.chaos.n_crashes) > 0
    else:
        assert int(final.hier.n_migrated) > 0


@pytest.mark.parametrize("name", sorted(_FAULT_WORLDS))
def test_chaos_and_hier_ticks_do_not_synchronise(cuda, name):
    """A chaos tick (the lifecycle draws, the sweep's per-task gathers
    of the per-fog edges, the RTT factor) and a federated tick (the
    per-domain winners, the migrate phase) wait for the card nowhere."""
    spec, st, net, b = _fault_world(cuda, name)
    step = engine.make_step(spec)
    for _ in range(30):  # past the first crashes and migrations
        st = step(st, net, b)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = step(st, net, b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(st.metrics.n_scheduled) > 0


def test_fold_in_over_tensors_on_the_card_equals_cpu(cuda):
    from fognetsimpp_tpu_torch import random as trandom

    data = torch.tensor([0, 1, 7, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], dtype=torch.int64)
    for seed in (0, 5, -7):
        key = trandom.PRNGKey(seed)
        want = trandom.fold_in(key, data)
        got = trandom.fold_in(key.to(cuda), data.to(cuda))
        assert torch.equal(got.cpu(), want)
        keys = trandom.fold_in(key.to(cuda), torch.arange(6, device=cuda))
        draws = trandom.uniform(trandom.fold_in(keys, data.to(cuda)), (2,), 1e-7, 1.0)
        want = trandom.uniform(trandom.fold_in(trandom.fold_in(key, torch.arange(6)), data),
                               (2,), 1e-7, 1.0)
        assert draws.cpu().numpy().tobytes() == want.numpy().tobytes()


def _float_inputs():
    """Inputs of each float32 primitive: sinf/cosf's CIRCLE range, the
    values beside multiples of pi/2, the integer reduction past 120 and
    special values; exp's and log's ranges; fma's triples with a sum just
    above a float32 midpoint."""
    rng = np.random.default_rng(13)
    f = np.finfo(np.float32)
    special = np.array([0.0, -0.0, f.tiny, -f.tiny, 1e-45, 1e-40, 2.0 ** -12, 0.7853982,
                        1.0, -1.0, 88.8, -87.8, 119.99999, 120.0, np.inf, -np.inf, np.nan],
                       np.float32)
    half_pi = (np.arange(-80, 81) * (np.pi / 2)).astype(np.float32)
    big = rng.uniform(120.0, 2.0e5, 4000) * rng.choice([-1.0, 1.0], 4000)
    huge = 10.0 ** rng.uniform(5.0, 38.0, 2000)
    trig = np.concatenate([
        rng.uniform(-120.0, 120.0, 200_000), half_pi, np.nextafter(half_pi, np.float32(9e9)),
        big, huge, special]).astype(np.float32)
    expx = np.concatenate([rng.uniform(-104.0, 89.0, 200_000), special]).astype(np.float32)
    logx = np.concatenate([np.exp(rng.uniform(-103.0, 88.0, 200_000)),
                           rng.uniform(-0.5, 0.5, 50_000), special]).astype(np.float32)
    h = np.float32(1 + 2 ** -12)
    a, b, c = (rng.standard_normal(100_000).astype(np.float32) for _ in range(3))
    fma3 = (np.append(a, h), np.append(b, h), np.append(c * 1e-3, np.float32(2 ** -60)))
    return trig, expx, logx, fma3


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bits, any NaN equal to any NaN (payloads may differ)."""
    a, b = a.cpu().numpy(), b.cpu().numpy()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    nan = np.isnan(a)
    return bool(np.array_equal(nan, np.isnan(b))
                and (a[~nan].view(np.int32) == b[~nan].view(np.int32)).all())


def test_float_primitives_on_the_card_equal_both_cpu_routes(cuda):
    """The card's tensor ops for ``sinf``/``cosf``, ``fma``, ``expf``,
    ``logf`` and ``log1pf`` give the bits of both CPU routes (the host
    route, and the tensor route that the card's tensors take), which the
    CPU tests hold to XLA's."""
    from fognetsimpp_tpu_torch import f32math as fm
    from fognetsimpp_tpu_torch.device import host_routes

    trig, expx, logx, fma3 = _float_inputs()
    unary = [(fm.sinf, trig), (fm.cosf, trig), (fm.expf, expx), (fm.logf, np.abs(logx)),
             (fm.log1pf, logx)]
    for fn, x in unary:
        got = fn(torch.from_numpy(x).to(cuda))
        for host in (True, False):
            with host_routes(host):
                assert _same_bits(got, fn(torch.from_numpy(x))), (fn.__name__, host)
    got = fm.fma(*(torch.from_numpy(v).to(cuda) for v in fma3))
    assert got[-1].item() == np.float32(1 + 2 ** -11 + 2 ** -23)
    for host in (True, False):
        with host_routes(host):
            assert _same_bits(got, fm.fma(*(torch.from_numpy(v) for v in fma3))), host


def test_cipher_on_the_card_equals_both_cpu_routes(cuda):
    """Keys, folds and draws of every size (the host route's Python ints,
    its numpy arrays, and the tensor route) equal on the card."""
    from fognetsimpp_tpu_torch import random as trandom
    from fognetsimpp_tpu_torch.device import host_routes

    def draws(dev):
        key = trandom.PRNGKey(42, device=dev)
        out = [trandom.split(key, n) for n in (2, 3, 9, 17)]
        k = trandom.fold_in(trandom.split(key, 3)[2], 0x0B57)
        out += [trandom.fold_in(k, d) for d in (0, 2 ** 31, 2 ** 32 - 1)]
        for shape in ((), (1,), (7,), (3, 4), (1001, 2), (20000,)):
            out.append(trandom.uniform(k, shape, 1e-7, 1.0))
            out.append(trandom.randint(k, shape, 200, 901))
        out.append(trandom.permutation(k, 5000))
        return out

    card = draws(cuda)
    for host in (True, False):
        with host_routes(host):
            for i, (g, w) in enumerate(zip(card, draws("cpu"))):
                assert g.dtype == w.dtype and g.shape == w.shape, (host, i)
                assert g.cpu().numpy().tobytes() == w.numpy().tobytes(), (host, i)


# ----------------------------------------------------------------------
# the telemetry planes on the card
# ----------------------------------------------------------------------

#: A wired world with every plane on: telemetry, the latency histogram
#: and journeys (64 users, fast fogs, so acks stream from the first ticks).
_TEL = dict(
    n_users=64, n_fogs=4, fog_mips=(40000.0, 80000.0), send_interval=0.01,
    horizon=0.1, telemetry=True, telemetry_hist=True, telemetry_journeys=16,
    telemetry_journey_ring=16,
)


def test_telemetry_card_run_equals_cpu_run(cuda):
    """Every leaf, the telemetry leaves included; the latency sums take
    ``cell_sum_ordered`` once a tick."""
    ck.reset_launches()
    spec, st, net, b = smoke.build(device=cuda, **_TEL)
    card, _ = engine.run(spec, st, net, b)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["cell_sum_ordered"] == spec.n_ticks
    spec, st, net, b = smoke.build(device="cpu", **_TEL)
    cpu, _ = engine.run(spec, st, net, b)
    for a, c in zip(state_to_numpy(card), state_to_numpy(cpu)):
        assert a.dtype == c.dtype and a.tobytes() == c.tobytes()
    assert int(cpu.telem.lat_hist.sum()) > 0 and int(cpu.telem.j_cursor.sum()) > 0


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_telemetry_tick_does_not_synchronise(cuda, batched):
    """A telemetry-on tick (the phase brackets, the histogram, the journey
    tap, the reservoir write) waits for the card nowhere, alone or as a
    replica batch."""
    from fognetsimpp_tpu_torch.net.topology import associate
    from fognetsimpp_tpu_torch.parallel.replicas import replicate_state, strict_vmap

    spec, st, net, b = smoke.build(device=cuda, **_TEL)
    if batched:
        with strict_vmap():
            tick, _ = engine.batched_tick(spec, net, b, replicate_state(spec, st, 4))
            batch = replicate_state(spec, st, 4)
            for _ in range(20):
                batch = tick(batch)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                batch = tick(batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        assert int(batch.telem.ticks.sum()) == 4 * 21
        return
    step = engine.make_step(spec)
    cache = associate(net, st.nodes.pos, st.nodes.alive, spec.broker_index)
    for _ in range(20):
        st = step(st, net, b, cache)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = step(st, net, b, cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(st.telem.lat_hist.sum()) > 0


def test_tp_telemetry_run_equals_cpu_and_does_not_synchronise(cuda):
    """The TP tick with every plane on (four shards, the ring exchange):
    card against CPU every leaf, and a second sharded run waits for the
    card nowhere."""
    kw = dict(_TEL, horizon=0.03)
    rk.reset_launches()
    spec, st, net, b = smoke.build(device=cuda, **kw)
    _, card = run_tp_sharded(spec, st, net, b, n_shards=4)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["ring_all_gather"] == spec.n_ticks
    spec_c, st_c, net_c, b_c = smoke.build(device="cpu", **kw)
    _, cpu = run_tp_sharded(spec_c, st_c, net_c, b_c, n_shards=4)
    for a, c in zip(state_to_numpy(card), state_to_numpy(cpu)):
        assert a.dtype == c.dtype and a.tobytes() == c.tobytes()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run_tp_sharded(spec, st, net, b, n_shards=4, n_ticks=3)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _lat_sum_case(kind, F=32, T=440_000, seed=0):
    """``accumulate_latency``'s ordered sum at the bench world's shapes:
    the F running sums first, then the task rows, not due at -1."""
    rng = np.random.default_rng(seed)
    fog = rng.integers(0, F, T).astype(np.int32)
    due = {"sparse": rng.random(T) < 0.005, "one_fog_5000": np.zeros(T, bool),
           "all_due": np.ones(T, bool)}[kind]
    if kind == "one_fog_5000":
        rows = rng.choice(T, 5000, replace=False)
        due[rows], fog[rows] = True, 7
    lat = (rng.random(T) * 0.05).astype(np.float32)
    cell = np.concatenate([np.arange(F, dtype=np.int32), np.where(due, fog, -1).astype(np.int32)])
    vals = np.concatenate([(rng.random(F) * 10).astype(np.float32), lat])
    return torch.from_numpy(cell), torch.from_numpy(vals), F


@pytest.mark.parametrize("kind", ["sparse", "one_fog_5000", "all_due"])
def test_cell_sum_equals_plain_at_lat_sum_shapes(cuda, kind):
    cell, vals, F = _lat_sum_case(kind)
    got = ck.cell_sum_ordered(cell.to(cuda), vals.to(cuda), F)
    want = ck.cell_sum_ordered_plain(cell, vals, F)
    assert got.cpu().numpy().tobytes() == want.numpy().tobytes()
    # four replicas end to end: one call
    from fognetsimpp_tpu_torch.parallel.replicas import strict_vmap

    c = torch.stack([cell] * 4)
    v = torch.stack([vals.roll(r) for r in range(4)])
    ck.reset_launches()
    with strict_vmap():
        got = torch.func.vmap(lambda a, x: ck.cell_sum_ordered(a, x, F))(c.to(cuda), v.to(cuda))
    torch.cuda.synchronize()
    assert ck.LAUNCHES["cell_sum_ordered"] == 1
    for r in (0, 3):
        want = ck.cell_sum_ordered_plain(c[r], v[r], F)
        assert got[r].cpu().numpy().tobytes() == want.numpy().tobytes()


# ----------------------------------------------------------------------
# the per-tick series on the card
# ----------------------------------------------------------------------

_SERIES_WORLDS = {
    "smoke": (smoke.build, dict(horizon=0.05, record_tick_series=True)),
    "wireless5": (wireless.wireless5, dict(numb_users=40, horizon=0.3,
                                           record_tick_series=True, record_trails=True)),
}


@pytest.mark.parametrize("name", sorted(_SERIES_WORLDS))
def test_series_card_run_equals_cpu_run(cuda, name):
    build, kw = _SERIES_WORLDS[name]
    spec, st, net, b = build(device=cuda, **kw)
    card, card_series = engine.run(spec, st, net, b)
    torch.cuda.synchronize()
    spec, st, net, b = build(device="cpu", **kw)
    cpu, cpu_series = engine.run(spec, st, net, b)
    for a, c in zip(state_to_numpy(card), state_to_numpy(cpu)):
        assert a.dtype == c.dtype and a.tobytes() == c.tobytes()
    assert sorted(card_series) == sorted(cpu_series)
    for k, v in cpu_series.items():
        assert card_series[k].device.type == "cpu", k
        assert card_series[k].numpy().tobytes() == v.numpy().tobytes(), k


@pytest.mark.parametrize("name", sorted(_SERIES_WORLDS))
def test_series_tick_does_not_synchronise(cuda, name):
    """A series tick (the tick with its aux, the row's reductions, the
    row written into the device buffer) waits for the card nowhere."""
    build, kw = _SERIES_WORLDS[name]
    spec, st, net, b = build(device=cuda, **kw)
    step = engine.make_step(spec, with_aux=True)
    cache = engine._static_cache(spec, net, st, False) if spec.assume_static else None
    st, aux = step(st, net, b, cache)
    buf = engine.SeriesBuffer(engine.series_row(spec, st, aux["n_assoc"]), 4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(4):
            st, aux = step(st, net, b, cache)
            buf.write(i, engine.series_row(spec, st, aux["n_assoc"]))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert buf.host()["t"].shape == (4,)


# ----------------------------------------------------------------------
# the runtime sanitizer and the carry contracts on the card
# ----------------------------------------------------------------------

#: ``bench.py::_build_bench_world`` at dt 5 ms (``chip_smoke.bench_world``),
#: its 20 ticks cut to 8.
_BENCH = dict(
    n_users=10_000, n_fogs=32, fog_mips=(1000.0, 2000.0, 3000.0, 4000.0),
    send_interval=0.0025, horizon=0.04, dt=5e-3, max_sends_per_user=44,
    max_sends_per_tick=2, queue_capacity=128, start_time_max=0.025,
    derive_acks=True, arrival_window=4096,
)


def test_sanitized_bench_run_synchronises_once_and_equals_plain(cuda):
    """``run_checkified(errors="div")`` on the bench world waits for the
    card once, when it reads its flags at the end (torch's sync debug
    mode warns once a synchronising call), and its final state equals
    the plain card run's, every leaf."""
    import warnings

    spec, st, net, b = smoke.build(device=cuda, **_BENCH)
    plain, _ = engine.run(spec, st, net, b)
    spec, st, net, b = smoke.build(device=cuda, **_BENCH)
    torch.cuda.synchronize()
    ak.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            final, _ = engine.run_checkified(spec, st, net, b, errors="div")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == 1
    assert ak.LAUNCHES["fused_arrival_plan"] > 0
    for x, y in zip(state_to_numpy(final), state_to_numpy(plain)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_planted_integer_division_by_zero_on_the_card_raises(cuda):
    """An integer division by a zero on the card: no wait per operator,
    the quotient computed on the repaired divisor, and ``throw`` names the
    set and the first operator that tripped."""
    from fognetsimpp_tpu_torch.core.sanitizer import CheckifyError, Sanitizer

    a = torch.arange(1, 9, dtype=torch.int32, device=cuda)
    d = torch.tensor([1, 2, 0, 4, 1, 2, 3, 4], dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with Sanitizer({"div"}, cuda) as s:
            q = torch.div(a, d, rounding_mode="floor")
            r = torch.remainder(a, d)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    with pytest.raises(CheckifyError, match="div") as e:
        s.throw()
    assert e.value.op == "aten::div"
    assert q.tolist() == [1, 1, 3, 1, 5, 3, 2, 2] and r.tolist() == [0, 0, 0, 0, 0, 0, 1, 0]


def test_planted_out_of_range_index_on_the_card_raises_and_the_card_goes_on(cuda):
    """An access point's node index past the node table: the sanitized
    card run raises naming ``oob`` without a device-side assert (the index
    is repaired before the operator runs), and the card runs on."""
    from fognetsimpp_tpu_torch.core.sanitizer import CheckifyError

    spec, st, net, b = wireless.wireless5(device=cuda, numb_users=12, horizon=0.4)
    ap = net.ap_nodes.clone()
    ap[0] = spec.n_nodes + 3
    with pytest.raises(CheckifyError, match="oob"):
        engine.run_checkified(spec, st, net.replace(ap_nodes=ap), b, n_ticks=3, errors="oob")
    final, _ = engine.run(spec, st, net, b, n_ticks=3)
    assert int(final.tick) == 3


def test_contracts_hold_on_card_states(cuda):
    """The step, phase and fleet contracts on card tensors (fake copies:
    nothing runs), and a planted promotion caught."""
    from fognetsimpp_tpu_torch.core import contracts
    from fognetsimpp_tpu_torch.parallel.replicas import replicate_state

    spec, st, net, b = smoke.build(device=cuda, **_BENCH)
    contracts.check_step_contract(spec, st, net, b)
    assert contracts.check_phase_contracts(spec, st, net)
    contracts.check_fleet_contract(spec, replicate_state(spec, st, 2, seed=0), net, b)
    step = engine.make_step(spec)

    def promoted(s, n, bb):
        out = step(s, n, bb)
        return out.replace(tasks=out.tasks.replace(stage=out.tasks.stage.to(torch.int32)))

    with pytest.raises(contracts.ContractError, match="stage"):
        contracts.check_step_contract(spec, st, net, b, step=promoted)
