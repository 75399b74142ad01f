"""Worker process of ``tests/test_torch_multihost.py`` (no tests here).

    python tests/torch_multihost_worker.py <rank> <port> <out.npz>

Joins a 2-process gloo group on 127.0.0.1 with ``multihost.initialize``,
lays 2 slots a process over it (``global_mesh``: a 4-slot mesh), advances
its own rows of a 4-replica smoke batch (``run_sharded``) and the
pipelined ``fleet_decisions`` (one ``all_reduce`` across the processes),
writes its rows' leaves and range to ``out.npz`` and prints one line.
Imports nothing of JAX.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from fognetsimpp_tpu_torch.parallel import (  # noqa: E402
    fleet_decisions, global_mesh, initialize, replicate_state, run_sharded,
)
from fognetsimpp_tpu_torch.random import PRNGKey, split  # noqa: E402
from fognetsimpp_tpu_torch.scenarios import smoke  # noqa: E402
from fognetsimpp_tpu_torch.state import state_to_numpy  # noqa: E402

#: The world, its replicas and keys; the test builds JAX's from the same.
WORLD = dict(n_users=2, n_fogs=2, send_interval=0.01, horizon=0.02)
R, SEED, KEY_SEED = 4, 0, 5

if __name__ == "__main__":
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    assert initialize(f"127.0.0.1:{port}", 2, rank, device="cpu") == 2
    try:
        mesh = global_mesh(local_slots=2, device="cpu")
        assert mesh.size == 4 and mesh.local_slots() == [2 * rank, 2 * rank + 1]
        spec, state, net, bounds = smoke.build(device="cpu", **WORLD)
        batch = replicate_state(spec, state, R, seed=SEED)
        rows = run_sharded(spec, batch, net, bounds, mesh)
        d, dm = fleet_decisions(spec, batch, net, bounds, split(PRNGKey(KEY_SEED), 2), mesh)
        np.savez(out, start=rows.start, stop=rows.stop,
                 **{f"leaf{i}": a for i, a in enumerate(state_to_numpy(rows.state))})
        print(f"MULTIHOST-OK rank={rank} rows={rows.start}:{rows.stop} "
              f"d={int(d)} dm={int(dm)}", flush=True)
    finally:
        dist.destroy_process_group()
