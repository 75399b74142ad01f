"""parallel layer of the PyTorch port: the replica axis, the slot mesh and
the fleet, the sweeps, the task-sharded runner and the fog-axis MIN_BUSY
decision, on one card; replicas across processes over
``torch.distributed`` (:mod:`.multihost`)."""
from .replicas import replica_counters, replicate_state, run_replicated  # noqa: F401
from .mesh import make_mesh, replica_sharding, run_sharded, shard_replicas  # noqa: F401
from .fleet import (  # noqa: F401
    fleet_decisions,
    fold_replica_keys,
    run_fleet,
    run_fleet_series,
)
from .multihost import global_mesh, initialize  # noqa: F401
from .sweep import fork_state, sweep_dyn, sweep_dyn_from, sweep_explore, sweep_policies  # noqa: F401
from .taskshard import (  # noqa: F401
    pad_users_to_multiple,
    ring_all_gather,
    run_node_sharded,
    run_tp_chunked,
    run_tp_sharded,
    shard_state_by_node,
    unstamp_tp_carry,
)
from .tp import sharded_min_busy  # noqa: F401
