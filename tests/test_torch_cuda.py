"""The port on a CUDA card: the kernels against their plain versions and a
card run against a CPU run.  Every test needs a card and skips elsewhere.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed: ``python -m pytest --noconftest -q
tests/test_torch_cuda.py`` (``--noconftest`` skips the JAX set-up of
``tests/conftest.py``).
"""
import numpy as np
import pytest
import torch

from fognetsimpp_tpu_torch.core import engine
from fognetsimpp_tpu_torch.ops import arrival_kernels as ak
from fognetsimpp_tpu_torch.ops import ring_kernels as rk
from fognetsimpp_tpu_torch.parallel.taskshard import run_tp_sharded
from fognetsimpp_tpu_torch.scenarios import smoke
from fognetsimpp_tpu_torch.state import state_to_numpy

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
