"""Replicas across two processes (``tests/test_multihost.py``'s gate for
the port): two spawned workers (``tests/torch_multihost_worker.py``) join
one gloo process group on 127.0.0.1 with 2 slots each; each advances only
its own rows of a 4-replica smoke batch, which must equal JAX
``run_replicated``'s rows (written to a temporary ``.npz`` first), and
``fleet_decisions``' total across the processes must equal JAX's.
"""
import os
import re
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from fognetsimpp_tpu.parallel import fleet as jfleet
from fognetsimpp_tpu.parallel import mesh as jmesh
from fognetsimpp_tpu.parallel import replicas as jreplicas
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from tests.torch_multihost_worker import KEY_SEED, R, SEED, WORLD

_WORKER = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")
#: Seconds a worker may take, start-up and imports included.
TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_group_matches_jax(tmp_path):
    js, jst, jn, jb = jsmoke.build(**WORLD)
    jbatch = jreplicas.replicate_state(js, jst, R, seed=SEED)
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jreplicas.run_replicated(js, jbatch, jn, jb))]
    np.savez(tmp_path / "jax.npz", *ref)
    jd, jdm = jfleet.fleet_decisions(js, jbatch, jn, jb, jax.random.split(
        jax.random.PRNGKey(KEY_SEED), 2), jmesh.make_mesh(4))

    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    outs = [tmp_path / f"rank{r}.npz" for r in (0, 1)]
    procs = [subprocess.Popen([sys.executable, _WORKER, str(r), port, str(outs[r])],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    want = np.load(tmp_path / "jax.npz")
    want = [want[f"arr_{i}"] for i in range(len(ref))]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {r} failed:\n{log}"
        m = re.search(r"MULTIHOST-OK rank=(\d) rows=(\d+):(\d+) d=(-?\d+) dm=(-?\d+)", log)
        assert m and int(m.group(1)) == r, log
        a, b = 2 * r, 2 * r + 2
        assert (int(m.group(2)), int(m.group(3))) == (a, b)
        assert (int(m.group(4)), int(m.group(5))) == (int(jd), int(jdm)) and int(jd) > 0
        got = np.load(outs[r])
        assert (int(got["start"]), int(got["stop"])) == (a, b)
        for i, w in enumerate(want):
            g = got[f"leaf{i}"]
            assert g.dtype == w.dtype and g.tobytes() == w[a:b].tobytes(), (r, i)
