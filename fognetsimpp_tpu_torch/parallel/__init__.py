"""parallel layer of the PyTorch port: the replica axis and its sweeps on
one card, and the task-sharded runner."""
from .replicas import replica_counters, replicate_state, run_replicated  # noqa: F401
from .sweep import fork_state, sweep_dyn, sweep_dyn_from, sweep_explore, sweep_policies  # noqa: F401
from .taskshard import run_tp_chunked, run_tp_sharded, unstamp_tp_carry  # noqa: F401
