"""The arrival planner's kernels and ops against the JAX package.

* the plain ``fused_arrival_plan`` / ``pairwise_rank`` (the CPU path and
  the card kernels' yardstick) against the Pallas kernels in interpret
  mode, as ``tests/test_pallas.py`` runs them;
* the same on the windows the main path meets: all masked rows bound
  for one fog, no masked row, and times of +0.0 and -0.0 (a tie);
* the port's ``plan_arrivals`` against the JAX one on the K <= 4096,
  K > 4096 (stable sort), wide-fog and ``fused=True`` branches;
* the compaction and the drop-mode scatters against their JAX forms.

The CUDA kernels are held against the plain versions in
``tests/test_torch_cuda.py``, which needs a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.ops import queues as jqueues
from fognetsimpp_tpu.ops.pallas_kernels import fused_arrival_plan as pallas_fused
from fognetsimpp_tpu.ops.pallas_kernels import pairwise_rank as pallas_rank
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.ops import arrival_kernels as ak
from fognetsimpp_tpu_torch.ops import queues as tqueues
from fognetsimpp_tpu_torch.ops.scatter import add_drop, set_drop


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _window(K, F, seed, p_mask=0.7, t_max=0.01):
    """Numpy-made window: mask, fog ids, coarse times (plenty of ties)."""
    rng = np.random.default_rng(seed)
    mask = rng.random(K) < p_mask
    fog = rng.integers(0, F, K).astype(np.int32)
    t = np.round(rng.random(K) * t_max, 4).astype(np.float32)
    return mask, fog, t


def _main_path_window(kind, K, F, seed):
    """The windows the engine's arrival tail meets: ``one_fog`` (the dense
    broker sends a tick's tasks to one winner), ``empty`` (later ticks),
    and ``signed_zero`` (times drawn from +0.0, -0.0 and a few values)."""
    rng = np.random.default_rng(seed)
    mask, fog, t = _window(K, F, seed)
    if kind == "one_fog":
        fog = np.full(K, F // 2, np.int32)
    elif kind == "empty":
        mask = np.zeros(K, bool)
    elif kind == "signed_zero":
        t = rng.choice(np.array([0.0, -0.0, 1e-4, 2e-4], np.float32), K)
    return mask, fog, t


#: One fog, times [+0, -0, +0, -0, 1]: the earliest is row 0, the ranks
#: follow position among the zeros.
SIGNED_ZERO_FOG = np.array([0.0, -0.0, 0.0, -0.0, 1.0], np.float32)


def _keys(mask, fog, t, F):
    f_key = np.where(mask, fog, F).astype(np.int32)
    t_key = np.where(mask, t, np.inf).astype(np.float32)
    return f_key, t_key


def _assert_same_bits(want, got, name):
    """Equal dtype, shape and bytes: -0.0 and +0.0 differ here."""
    want, got = np.asarray(want), got.numpy()
    assert want.dtype == got.dtype and want.shape == got.shape, name
    assert want.tobytes() == got.tobytes(), (name, want.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("K", [512, 1024])
def test_plain_fused_plan_equals_pallas_interpret(K):
    F = 7
    mask, fog, t = _window(K, F, seed=K)
    f_key, t_key = _keys(mask, fog, t, F)
    want = pallas_fused(
        jnp.asarray(mask), jnp.asarray(f_key), jnp.asarray(t_key), F,
        interpret=True,
    )
    got = ak.fused_arrival_plan(
        torch.from_numpy(mask), torch.from_numpy(f_key),
        torch.from_numpy(t_key), F,
    )
    for name, w, g in zip(("rank", "counts", "t_min", "first"), want, got):
        w = np.asarray(w)
        g = g.numpy()
        assert w.dtype == g.dtype, name
        np.testing.assert_array_equal(w, g, err_msg=name)


@pytest.mark.parametrize("K", [512, 1024])
def test_plain_pairwise_rank_equals_pallas_interpret(K):
    F = 5
    mask, fog, t = _window(K, F, seed=K + 1, p_mask=0.6)
    f_key, t_key = _keys(mask, fog, t, F)
    want = pallas_rank(
        jnp.asarray(mask), jnp.asarray(f_key), jnp.asarray(t_key),
        interpret=True,
    )
    got = ak.pairwise_rank(
        torch.from_numpy(mask), torch.from_numpy(f_key), torch.from_numpy(t_key)
    )
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("K", [512, 1024])
@pytest.mark.parametrize("kind", ["one_fog", "empty", "signed_zero"])
def test_plain_kernels_equal_pallas_interpret_on_main_path_windows(kind, K):
    F = 7
    mask, fog, t = _main_path_window(kind, K, F, seed=K + len(kind))
    f_key, t_key = _keys(mask, fog, t, F)
    args_j = (jnp.asarray(mask), jnp.asarray(f_key), jnp.asarray(t_key))
    args_t = (torch.from_numpy(mask), torch.from_numpy(f_key), torch.from_numpy(t_key))
    want = pallas_fused(*args_j, F, interpret=True)
    got = ak.fused_arrival_plan(*args_t, F)
    for name, w, g in zip(("rank", "counts", "t_min", "first"), want, got):
        _assert_same_bits(w, g, name)
    _assert_same_bits(
        pallas_rank(*args_j, interpret=True), ak.pairwise_rank(*args_t), "rank"
    )


def test_plain_kernels_break_a_signed_zero_tie_by_position():
    """One fog, times [+0, -0, +0, -0, 1]: -0.0 and +0.0 tie, so the first
    arrival is row 0 and the zeros rank by position, as in Pallas; the
    earliest time is -0.0, as XLA's min gives it."""
    K, F = len(SIGNED_ZERO_FOG), 1
    mask = np.ones(K, bool)
    f_key, t_key = _keys(mask, np.zeros(K, np.int32), SIGNED_ZERO_FOG, F)
    args_t = (torch.from_numpy(mask), torch.from_numpy(f_key), torch.from_numpy(t_key))
    rank, counts, t_min, first = ak.fused_arrival_plan(*args_t, F)
    assert rank.tolist() == [0, 1, 2, 3, 4]
    assert counts.tolist() == [5] and first.tolist() == [0]
    assert t_min.view(torch.int32).tolist() == [-(2 ** 31)]  # -0.0
    assert torch.equal(ak.pairwise_rank(*args_t), rank)
    want = pallas_fused(
        jnp.asarray(mask), jnp.asarray(f_key), jnp.asarray(t_key), F,
        interpret=True,
    )
    for name, w, g in zip(("rank", "counts", "t_min", "first"), want,
                          (rank, counts, t_min, first)):
        _assert_same_bits(w, g, name)


@pytest.mark.parametrize("order", ["as_listed", "reversed"])
def test_plain_t_min_keeps_the_sign_of_zero_as_pallas(order):
    """Fogs whose zeros are all +0.0, mixed, all -0.0, or absent: t_min's
    bits equal the Pallas kernel's in either order of the rows."""
    times = {
        0: [0.0, 0.0, 1e-4], 1: [0.0, -0.0, 0.0], 2: [-0.0, 1e-4, -0.0],
        3: [2e-4, 1e-4, 3e-4], 4: [1e-4, -0.0, 0.0, 5e-5],
    }
    fog = np.array([f for f, ts in times.items() for _ in ts], np.int32)
    t = np.array([x for ts in times.values() for x in ts], np.float32)
    if order == "reversed":
        fog, t = fog[::-1].copy(), t[::-1].copy()
    K, F = len(t), len(times) + 1  # the last fog takes no row
    mask = np.ones(K, bool)
    f_key, t_key = _keys(mask, fog, t, F)
    want = pallas_fused(
        jnp.asarray(mask), jnp.asarray(f_key), jnp.asarray(t_key), F,
        interpret=True,
    )
    got = ak.fused_arrival_plan(
        torch.from_numpy(mask), torch.from_numpy(f_key), torch.from_numpy(t_key), F
    )
    for name, w, g in zip(("rank", "counts", "t_min", "first"), want, got):
        _assert_same_bits(w, g, name)
    assert np.signbit(got[2].numpy()[:3]).tolist() == [False, True, True]


def test_plain_rank_in_row_blocks_equals_sort_rank():
    """Past one block of rows (a ragged last block), the plain rank equals
    the stable-sort rank, which ``test_plan_arrivals_matches_jax`` holds
    against JAX at this size."""
    K, F = 5000, 7
    mask, fog, t = _window(K, F, seed=11)
    f_key, t_key = _keys(mask, fog, t, F)
    m, f, tk = (torch.from_numpy(a) for a in (mask, f_key, t_key))
    assert K % ak._PLAIN_ROWS and K > 2 * ak._PLAIN_ROWS
    got = ak.pairwise_rank_plain(m, f, tk)
    want = tqueues._sort_rank(m, f, torch.from_numpy(t))
    assert torch.equal(got, want)


def test_plain_fused_plan_empty_fog_contract():
    """An empty fog: t_min = +inf, first = K (the Pallas contract)."""
    K, F = 64, 9
    mask, fog, t = _window(K, 4, seed=3)  # fogs 4..8 receive nothing
    f_key, t_key = _keys(mask, fog, t, F)
    _, counts, t_min, first = ak.fused_arrival_plan(
        torch.from_numpy(mask), torch.from_numpy(f_key), torch.from_numpy(t_key), F
    )
    assert (counts[4:] == 0).all()
    assert torch.isinf(t_min[4:]).all()
    assert (first[4:] == K).all()


@pytest.mark.parametrize(
    "K, F, fused",
    [
        (1000, 7, False),  # ragged window, fused-kernel branch
        (4096, 32, False),  # the bench window
        (5000, 7, False),  # K > 4096: the stable-sort branch
        (600, 1100, False),  # F > 1024: rank kernel + torch reductions
        (1000, 7, True),  # the fused tick's contract (counts=None)
        (5000, 7, True),
    ],
)
def test_plan_arrivals_matches_jax(K, F, fused):
    mask, fog, t = _window(K, F, seed=K + F)
    rng = np.random.default_rng(F)
    idle = rng.random(F) < 0.6
    want = jqueues.plan_arrivals(
        jnp.asarray(mask), jnp.asarray(fog), jnp.asarray(t), F,
        jnp.asarray(idle), fused=fused,
    )
    got = tqueues.plan_arrivals(
        torch.from_numpy(mask), torch.from_numpy(fog), torch.from_numpy(t), F,
        torch.from_numpy(idle), fused=fused,
    )
    np.testing.assert_array_equal(np.asarray(want.assign_task), got.assign_task.numpy())
    np.testing.assert_array_equal(np.asarray(want.rank), got.rank.numpy())
    assert got.rank.dtype == torch.int32
    if fused:
        assert want.counts is None and got.counts is None
    else:
        np.testing.assert_array_equal(np.asarray(want.counts), got.counts.numpy())


@pytest.mark.parametrize(
    "kind, K",
    [
        ("signed_zero", 1000),  # the K <= 4096 branch
        ("signed_zero", 5000),  # the stable-sort branch
        ("one_fog", 5000),
    ],
)
def test_plan_arrivals_matches_jax_on_main_path_windows(kind, K):
    F = 7
    mask, fog, t = _main_path_window(kind, K, F, seed=K + 3)
    idle = np.arange(F) % 2 == 0
    if kind == "one_fog":
        idle[F // 2] = True  # the one fog takes its first arrival
    want = jqueues.plan_arrivals(
        jnp.asarray(mask), jnp.asarray(fog), jnp.asarray(t), F, jnp.asarray(idle)
    )
    got = tqueues.plan_arrivals(
        torch.from_numpy(mask), torch.from_numpy(fog), torch.from_numpy(t), F,
        torch.from_numpy(idle),
    )
    for name in ("assign_task", "rank", "counts"):
        np.testing.assert_array_equal(
            np.asarray(getattr(want, name)), getattr(got, name).numpy(), err_msg=name
        )


@pytest.mark.parametrize("T, K, rot", [(300, 64, None), (300, 64, 77), (20000, 4096, 12345), (1000, 8, 999)])
def test_compact_matches_jax(T, K, rot):
    rng = np.random.default_rng(T + K)
    mask = rng.random(T) < 0.4
    want = jengine._compact(
        jnp.asarray(mask), K, T, None if rot is None else jnp.int32(rot)
    )
    got = tengine._compact(
        torch.from_numpy(mask), K, T,
        None if rot is None else torch.tensor(rot, dtype=torch.int32),
    )
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_drop_mode_scatters_match_jax():
    rng = np.random.default_rng(0)
    n = 50
    col = rng.random(n).astype(np.float32)
    idx = rng.permutation(n + 10)[:30].astype(np.int32)  # some past the end
    vals = rng.random(30).astype(np.float32)
    want = jnp.asarray(col).at[idx].set(vals, mode="drop")
    got = set_drop(torch.from_numpy(col), torch.from_numpy(idx), torch.from_numpy(vals))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    cnt = np.zeros(n, np.int32)
    idx2 = rng.integers(0, n + 5, 200).astype(np.int32)  # duplicates too
    add = rng.integers(0, 3, 200).astype(np.int32)
    want = jnp.asarray(cnt).at[idx2].add(add, mode="drop")
    got = add_drop(torch.from_numpy(cnt), torch.from_numpy(idx2), torch.from_numpy(add))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
