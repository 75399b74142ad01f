"""The compacted broker's modules against the JAX package, bit for bit.

* ``schedule_batch`` for every ported policy on numpy-made inputs:
  random views, score ties, zero-MIPS views (every estimate +inf, so the
  first registered fog anchors), no registered fog, all fogs dead, each
  with and without ``order_t`` and ``rand_u``;
* DYNAMIC over the argmin ids 0-4, the bandit ids 8-10 and invalid ids;
* ``ucb_scores``, ``ducb_scores``, ``exp3_probs`` and ``exp3_sample``,
  including ``u = 0`` and a float32 cumsum that tops out below 1;
* ``credit_batch`` at K = 1,024 and 4,096, and ``task_uniform``.

The JAX functions run under ``jax.jit`` with the engine's static
arguments, so XLA's CPU rewrites (reduction order, contractions, the
reciprocal of a constant divisor) are the ones the engine meets.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fognetsimpp_tpu.learn import bandits as jb
from fognetsimpp_tpu.learn import rewards as jr
from fognetsimpp_tpu.ops import sched as jsched
from fognetsimpp_tpu.spec import Policy
from fognetsimpp_tpu_torch import random as trandom
from fognetsimpp_tpu_torch.learn import bandits as tb
from fognetsimpp_tpu_torch.learn import rewards as tr
from fognetsimpp_tpu_torch.ops import sched as tsched
from fognetsimpp_tpu_torch.state import LearnState as TLearnState


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


POLICIES = {
    "min_busy": Policy.MIN_BUSY, "round_robin": Policy.ROUND_ROBIN,
    "min_latency": Policy.MIN_LATENCY, "energy_aware": Policy.ENERGY_AWARE,
    "random": Policy.RANDOM, "ucb": Policy.UCB, "ducb": Policy.DUCB,
    "exp3": Policy.EXP3,
}
CASES = ["random", "ties", "zero_mips", "no_registered", "all_dead"]


def _bits(x) -> bytes:
    return np.asarray(x).tobytes()


def _inputs(case: str, seed: int, T: int = 96, F: int = 6):
    """numpy inputs of ``schedule_batch`` and a bandit arm view."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    d = dict(
        mask=rng.random(T) < 0.7,
        mips_req=rng.integers(100, 1001, T).astype(f32),
        view_busy=(rng.random(F) * 0.5).astype(f32),
        view_mips=rng.choice(np.array([1000, 2000, 3000, 4000], f32), F),
        registered=rng.random(F) < 0.85,
        fog_alive=rng.random(F) < 0.9,
        fog_energy_frac=rng.random(F).astype(f32),
        rtt=(rng.random(F) * 1e-3).astype(f32),
        rr=np.int32(rng.integers(0, F)),
        order_t=np.round(rng.random(T) * 0.005, 4).astype(f32),
        rand_u=rng.random(T).astype(f32),
    )
    d["registered"][rng.integers(0, F)] = True
    d["fog_alive"][rng.integers(0, F)] = True
    if case == "ties":
        d["view_busy"] = np.round(d["view_busy"] * 4).astype(f32) / 4
        d["view_mips"][:] = 2000.0
        d["mips_req"][:] = 500.0
        d["rtt"][:] = 1e-4
        d["fog_energy_frac"] = np.round(d["fog_energy_frac"] * 2).astype(f32) / 2
        d["order_t"][:] = 0.0025
    elif case == "zero_mips":
        d["view_mips"][:] = 0.0
        d["registered"][0] = False  # the anchor is not slot 0
    elif case == "no_registered":
        d["registered"][:] = False
    elif case == "all_dead":
        d["fog_alive"][:] = False
    d["rand_u"][:4] = [0.0, np.nextafter(f32(1), f32(0)), 0.5, 1e-8]
    picks = rng.integers(0, 40, F).astype(f32)
    picks[rng.integers(0, F)] = 0.0  # an untried arm
    cnt = np.floor(picks * rng.random(F)).astype(f32)
    arms = dict(
        pick_count=picks,
        reward_cnt=cnt,
        reward_sum=(cnt * rng.random(F)).astype(f32),
        disc_cnt=(cnt * rng.random(F) * rng.choice([1.0, 1e-4], F)).astype(f32),
        disc_sum=(cnt * rng.random(F) * 0.3).astype(f32),
        logw=(rng.standard_normal(F) * 3).astype(f32),
        explore=f32(0.5),
    )
    return d, arms


def _jax_call(policy, d, arms, mips0, use_order, use_u, policy_id=None,
              with_learn=True):
    learn = jb.BanditArms(**{k: jnp.asarray(v) for k, v in arms.items()})

    @jax.jit
    def go(d, learn, pid):
        return jsched.schedule_batch(
            int(policy), d["mask"], d["mips_req"], d["view_busy"],
            d["view_mips"], d["registered"], d["fog_alive"],
            d["fog_energy_frac"], d["rtt"], d["rr"], jax.random.PRNGKey(7),
            mips0, True, policy_id=pid,
            order_t=d["order_t"] if use_order else None,
            rand_u=d["rand_u"] if use_u else None,
            learn=learn if with_learn else None,
        )

    pid = None if policy_id is None else jnp.int32(policy_id)
    return go({k: jnp.asarray(v) for k, v in d.items()}, learn, pid)


def _port_call(policy, d, arms, mips0, use_order, use_u, policy_id=None,
               with_learn=True):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    learn = tb.BanditArms(
        **{k: torch.from_numpy(np.asarray(v)) for k, v in arms.items()}
    )
    return tsched.schedule_batch(
        int(policy), t["mask"], t["mips_req"], t["view_busy"], t["view_mips"],
        t["registered"], t["fog_alive"], t["fog_energy_frac"], t["rtt"],
        t["rr"], trandom.PRNGKey(7), mips0,
        policy_id=None if policy_id is None else torch.tensor(policy_id, dtype=torch.int32),
        order_t=t["order_t"] if use_order else None,
        rand_u=t["rand_u"] if use_u else None,
        learn=learn if with_learn else None,
    )


def _assert_same(want, got, what):
    (wc, wr), (gc, gr) = want, got
    assert gc.dtype == torch.int32 and gr.dtype == torch.int32, what
    assert _bits(wc) == gc.numpy().tobytes(), (
        what, np.asarray(wc)[:20], gc.numpy()[:20])
    assert _bits(wr) == gr.numpy().tobytes(), (what, wr, gr)


@pytest.mark.parametrize("feed", ["order_u", "bare"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_schedule_batch_matches_jax(name, case, feed):
    policy = POLICIES[name]
    use = feed == "order_u"
    d, arms = _inputs(case, seed=zlib.crc32(f"{name}/{case}/{feed}".encode()))
    for mips0 in ((True, False) if policy in (0, 2, 3) else (False,)):
        want = _jax_call(policy, d, arms, mips0, use, use)
        got = _port_call(policy, d, arms, mips0, use, use)
        _assert_same(want, got, (name, case, feed, mips0))
    if policy == Policy.RANDOM:
        assert (np.asarray(want[0]) >= 0).any() or case in ("no_registered", "all_dead")


@pytest.mark.parametrize("with_learn", [True, False], ids=["learn", "no_learn"])
@pytest.mark.parametrize("policy_id", [0, 1, 2, 3, 4, 8, 9, 10, -1, 5, 6, 7, 11])
def test_dynamic_matches_lax_switch(policy_id, with_learn):
    d, arms = _inputs("random", seed=100 + policy_id)
    for mips0 in (True, False):
        want = _jax_call(Policy.DYNAMIC, d, arms, mips0, True, True,
                         policy_id=policy_id, with_learn=with_learn)
        got = _port_call(Policy.DYNAMIC, d, arms, mips0, True, True,
                         policy_id=policy_id, with_learn=with_learn)
        _assert_same(want, got, (policy_id, with_learn, mips0))
    valid = policy_id in range(5) or (with_learn and 8 <= policy_id <= 10)
    if not valid:
        assert (np.asarray(want[0]) == -1).all()


def test_dynamic_round_robin_advances_its_cursor():
    d, arms = _inputs("random", seed=5)
    want = _jax_call(Policy.DYNAMIC, d, arms, True, True, True, policy_id=1)
    got = _port_call(Policy.DYNAMIC, d, arms, True, True, True, policy_id=1)
    _assert_same(want, got, "rr under DYNAMIC")
    assert int(got[1]) != int(d["rr"]) or int(d["mask"].sum()) % 6 == 0


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fn", ["ucb", "ducb"])
def test_ucb_scores_match_jax(fn, case):
    d, arms = _inputs(case, seed=11 + len(case))
    avail = d["registered"] & d["fog_alive"]
    j = jax.jit(getattr(jb, f"{fn}_scores"))(
        jb.BanditArms(**{k: jnp.asarray(v) for k, v in arms.items()}), avail
    )
    t = getattr(tb, f"{fn}_scores")(
        tb.BanditArms(**{k: torch.from_numpy(np.asarray(v)) for k, v in arms.items()}),
        torch.from_numpy(avail),
    )
    assert _bits(j) == t.numpy().tobytes()


@pytest.mark.parametrize("gamma", [0.0, 0.07, 0.5, 1.0, 1.5])
@pytest.mark.parametrize("F", [1, 3, 6, 32, 33])
def test_exp3_probs_match_jax(F, gamma):
    rng = np.random.default_rng(F * 10 + int(gamma * 100))
    logw = (rng.standard_normal(F) * 20).astype(np.float32)
    for avail in (rng.random(F) < 0.7, np.ones(F, bool), np.zeros(F, bool)):
        j = jax.jit(jb.exp3_probs)(logw, avail, jnp.float32(gamma))
        t = tb.exp3_probs(torch.from_numpy(logw), torch.from_numpy(avail),
                          torch.tensor(gamma, dtype=torch.float32))
        assert _bits(j) == t.numpy().tobytes(), (avail, np.asarray(j), t.numpy())


@pytest.mark.parametrize("F", [1, 4, 17, 32, 100])
def test_exp3_sample_matches_jax(F):
    rng = np.random.default_rng(F)
    u = rng.random(300).astype(np.float32)
    u[:3] = [0.0, 1e-9, np.nextafter(np.float32(1), np.float32(0))]
    p_rand = rng.random(F).astype(np.float32)
    p_rand[rng.random(F) < 0.3] = 0.0
    # a float32 cumsum that tops out below 1, and an all-zero p
    p_short = np.full(F, np.float32(1.0) / np.float32(F * 1.0000001), np.float32)
    for p in (p_rand, p_rand / p_rand.sum(), p_short, np.zeros(F, np.float32)):
        p = p.astype(np.float32)
        j = jax.jit(jb.exp3_sample)(p, u)
        t = tb.exp3_sample(torch.from_numpy(p), torch.from_numpy(u))
        assert _bits(j) == t.numpy().tobytes()
        arms = t.numpy()
        if p.any():
            assert (p[arms] > 0).all()  # never a zero-probability arm
        else:
            assert (arms == -1).all()


def _learn_states(F, Tl, rng):
    f32 = np.float32
    cnt = rng.integers(0, 50, F).astype(f32)
    cols = dict(
        pick_count=cnt + rng.integers(0, 5, F).astype(f32),
        reward_cnt=cnt,
        reward_sum=(cnt * rng.random(F)).astype(f32),
        disc_cnt=(cnt * rng.random(F)).astype(f32),
        disc_sum=(cnt * rng.random(F) * 0.5).astype(f32),
        logw=(rng.standard_normal(F) * 2).astype(f32),
        explore=f32(0.37),
        lat_sum=f32(rng.random() * 100),
        lat_cnt=f32(rng.integers(0, 1000)),
        pick_p=np.clip(rng.random(Tl), 0.01, 1).astype(f32),
        credited=(rng.random(Tl) < 0.3).astype(np.int8),
    )
    j = jb.LearnState(**{k: jnp.asarray(v) for k, v in cols.items()})
    t = TLearnState(**{k: torch.from_numpy(np.asarray(v)) for k, v in cols.items()})
    return j, t


@pytest.mark.parametrize("scale", [0.25, 0.3])
@pytest.mark.parametrize("K, F", [(1024, 4), (4096, 32), (1556, 3)])
def test_credit_batch_matches_jax(K, F, scale):
    rng = np.random.default_rng(K + F)
    lj, lt = _learn_states(F, 8, rng)
    valid = rng.random(K) < 0.8
    fog = rng.integers(0, F, K)
    memb = (fog[None, :] == np.arange(F)[:, None]) & valid[None, :]
    # latencies past ~21.9 s * scale / 0.25 take exp's flush to zero
    lat = np.where(valid, rng.uniform(0, 60, K), 0).astype(np.float32)
    pick_p = rng.uniform(1e-7, 1, K).astype(np.float32)
    disc = np.float32(0.995)
    sc = np.float32(scale)

    @jax.jit
    def go(lj, valid, memb, lat, pick_p):
        return jr.credit_batch(lj, valid, memb, lat, pick_p, F, disc, sc)

    want = go(lj, valid, memb, lat, pick_p)
    got = tr.credit_batch(
        lt, torch.from_numpy(valid), torch.from_numpy(memb),
        torch.from_numpy(lat), torch.from_numpy(pick_p), F, disc, sc,
    )
    for name in ("reward_cnt", "reward_sum", "disc_cnt", "disc_sum", "logw",
                 "lat_sum", "lat_cnt"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert w.dtype == g.dtype and w.tobytes() == g.tobytes(), (name, w, g)


def test_reward_from_latency_flushes_like_xla():
    lat = np.linspace(0, 60, 200_001).astype(np.float32)
    for scale in (0.25, 0.3, 1.0):
        w = jax.jit(lambda x: jr.reward_from_latency(x, np.float32(scale)))(lat)
        g = tr.reward_from_latency(torch.from_numpy(lat), np.float32(scale))
        assert _bits(w) == g.numpy().tobytes()
        if scale < 1.0:  # the flushed tail is exercised
            assert (np.asarray(w) == 0).any()


def test_penalize_counts_matches_jax():
    rng = np.random.default_rng(3)
    lj, lt = _learn_states(5, 4, rng)
    cnt = rng.integers(0, 4, 5).astype(np.float32)
    w = jax.jit(jr.penalize_counts)(lj, cnt)
    g = tr.penalize_counts(lt, torch.from_numpy(cnt))
    for name in ("reward_cnt", "disc_cnt", "reward_sum", "logw"):
        assert _bits(getattr(w, name)) == getattr(g, name).numpy().tobytes()


def test_credit_window_past_2_24_rows_raises():
    with pytest.raises(ValueError, match="2\\^24"):
        tr._credit_counts_exact(2 ** 24)


def test_task_uniform_matches_jax():
    rng = np.random.default_rng(9)
    ids = np.concatenate([
        np.arange(64), rng.integers(0, 2**31 - 1, 4000), [2**31 - 1],
    ]).astype(np.int32)
    for seed in (0, 1, 12345):
        w = jax.jit(jsched.task_uniform)(jax.random.PRNGKey(seed), ids)
        g = tsched.task_uniform(trandom.PRNGKey(seed), torch.from_numpy(ids))
        assert g.dtype == torch.float32
        assert _bits(w) == g.numpy().tobytes()


FEDERATED = ["min_busy", "min_latency", "energy_aware", "random", "ucb",
             "ducb", "exp3", "max_mips"]


def _owners(F: int, B: int, T: int, rng):
    """A random ownership of F fogs by B brokers (each owns one at least)
    and each of T tasks' broker."""
    fog_owner = np.concatenate([np.arange(B), rng.integers(0, B, F - B)])
    rng.shuffle(fog_owner)
    return fog_owner.astype(np.int32), rng.integers(0, B, T).astype(np.int32)


@pytest.mark.parametrize("F, B", [(6, 2), (40, 3)])
@pytest.mark.parametrize("name", FEDERATED)
def test_federated_arguments_raise(name, F, B):
    """The federated domains (``fog_owner``, ``task_broker``,
    ``n_brokers``): every federatable policy's per-domain decision
    against JAX, bit for bit, on random, tied and no-fog windows; and
    ROUND_ROBIN and DYNAMIC refuse to federate with JAX's words."""
    policy = int(Policy.MAX_MIPS) if name == "max_mips" else POLICIES[name]
    for case in ("random", "ties", "zero_mips", "all_dead"):
        d, arms = _inputs(case, seed=zlib.crc32(f"fed/{name}/{case}/{F}".encode()), F=F)
        rng = np.random.default_rng(F + B)
        fog_owner, task_broker = _owners(F, B, d["mask"].shape[0], rng)
        if case == "random":
            # one domain with no registered fog at all
            d["registered"][fog_owner == B - 1] = False
        learn = jb.BanditArms(**{k: jnp.asarray(v) for k, v in arms.items()})
        for mips0 in ((True, False) if policy in (0, 2, 3) else (False,)):
            want = jax.jit(
                lambda d, learn, fo, tbk: jsched.schedule_batch(
                    policy, d["mask"], d["mips_req"], d["view_busy"],
                    d["view_mips"], d["registered"], d["fog_alive"],
                    d["fog_energy_frac"], d["rtt"], d["rr"],
                    jax.random.PRNGKey(7), mips0, True, order_t=d["order_t"],
                    rand_u=d["rand_u"], learn=learn, fog_owner=fo,
                    task_broker=tbk, n_brokers=B,
                )
            )({k: jnp.asarray(v) for k, v in d.items()}, learn, fog_owner, task_broker)
            t = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
            got = tsched.schedule_batch(
                policy, t["mask"], t["mips_req"], t["view_busy"], t["view_mips"],
                t["registered"], t["fog_alive"], t["fog_energy_frac"], t["rtt"],
                t["rr"], trandom.PRNGKey(7), mips0, order_t=t["order_t"],
                rand_u=t["rand_u"],
                learn=tb.BanditArms(
                    **{k: torch.from_numpy(np.asarray(v)) for k, v in arms.items()}
                ),
                fog_owner=torch.from_numpy(fog_owner),
                task_broker=torch.from_numpy(task_broker), n_brokers=B,
            )
            _assert_same(want, got, (name, case, mips0))
            picked = got[0].numpy()
            ok = picked >= 0
            # every pick lies in the task's own domain
            assert (fog_owner[picked[ok]] == task_broker[ok]).all()
    d, arms = _inputs("random", seed=1, F=F)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    fog_owner, task_broker = _owners(F, B, 96, np.random.default_rng(0))
    for pol, words in ((Policy.ROUND_ROBIN, "ROUND_ROBIN does not federate"),
                       (Policy.DYNAMIC, "Policy.DYNAMIC does not federate")):
        with pytest.raises(ValueError, match=words):
            tsched.schedule_batch(
                int(pol), t["mask"], t["mips_req"], t["view_busy"],
                t["view_mips"], t["registered"], t["fog_alive"],
                t["fog_energy_frac"], t["rtt"], t["rr"], trandom.PRNGKey(0), False,
                policy_id=torch.tensor(0, dtype=torch.int32),
                fog_owner=torch.from_numpy(fog_owner),
                task_broker=torch.from_numpy(task_broker), n_brokers=B,
            )


def test_learned_policy_without_arms_raises():
    d, arms = _inputs("random", seed=1)
    with pytest.raises(ValueError, match="bandit arm view"):
        _port_call(Policy.UCB, d, arms, False, True, True, with_learn=False)
