"""learn/ — the online bandit schedulers (``fognetsimpp_tpu/learn``).

:mod:`.bandits` scores the arms (UCB, discounted UCB, EXP3),
:mod:`.rewards` credits delayed rewards at ack time, and :mod:`.eval` is
the host regret harness.  :class:`LearnState` lives in
:mod:`fognetsimpp_tpu_torch.state` with the rest of the world.  ``.eval``
imports the engine, so it is not imported here::

    from fognetsimpp_tpu_torch.learn import eval as learn_eval
"""
from ..state import LearnState, init_learn_state  # noqa: F401
from .bandits import (  # noqa: F401
    BanditArms,
    arms_view,
    ducb_scores,
    exp3_probs,
    exp3_sample,
    ucb_scores,
)
from .rewards import credit_batch, penalize_counts, reward_from_latency  # noqa: F401
