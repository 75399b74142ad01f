"""The learned policies' worlds: the port's ``run`` against JAX ``run``.

UCB, DUCB, EXP3 and DYNAMIC with ``learn_in_dynamic`` at a static and at
a bandit id, every leaf bit for bit against the undonated JAX
``engine.run``, with horizons long enough that rewards are credited
(``learn.lat_cnt > 0``) and EXP3's recorded pick probabilities leave 1.
The worlds and the comparison are ``tests/test_torch_policies.py``'s.
"""
import pytest

from fognetsimpp_tpu_torch.core import engine as tengine
from tests.test_torch_policies import (  # noqa: F401 (fixtures)
    LEARNED_WORLDS,
    _build_port,
    assert_run_matches_jax,
    one_torch_thread,
    port_runs,
)


@pytest.mark.parametrize("name", LEARNED_WORLDS)
def test_learned_run_matches_jax_every_leaf(name, port_runs):
    assert_run_matches_jax(name, port_runs)


def test_compacted_worlds_take_the_compacted_broker(monkeypatch):
    """The dense broker's gate sends these worlds down the compacted one,
    and the learned worlds through the credit phase every tick."""
    calls = {"dense": 0, "compacted": 0, "credit": 0}
    for fn, key in (("_phase_broker_dense", "dense"), ("_phase_broker", "compacted"),
                    ("_phase_learn_credit", "credit")):
        orig = getattr(tengine, fn)

        def counted(*a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(tengine, fn, counted)
    spec, st, net, b = _build_port("ucb")
    tengine.run(spec, st, net, b, n_ticks=5)
    assert calls == {"dense": 0, "compacted": 5, "credit": 5}
