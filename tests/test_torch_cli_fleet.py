"""The port's ``--replicas R --ticks`` against JAX's on the same argv
(``--platform cpu``): the replica batch on one device, which JAX's
``run_fleet`` equals on a one-device mesh (JAX's CLI spreads it over this
process's 8 CPU devices, so only ``n_devices`` differs); the summary and
the ``.fleet.sca.json`` / ``.fleet.vec.npz`` files.
"""
import json

import numpy as np
import pytest
import torch

from tests.torch_cli_support import run_both, summary_lines
from tests.torch_exporter_support import without_compile_families


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


SMALL = ["-s", "smoke", "--set", "scenario.n_users=6", "--set", "scenario.horizon=0.1"]


def test_replicas_match_jax_fleet(tmp_path, capsys):
    argv = SMALL + ["--replicas", "8", "--ticks", "--set", "scenario.start_time_max=0.02"]
    (jrc, jout, _, jdir), (trc, tout, _, tdir) = run_both(argv, capsys, tmp_path)
    assert jrc == trc == 0
    want, got = summary_lines(jout)[-1], summary_lines(tout)[-1]
    assert want.pop("n_devices") == 8 and got.pop("n_devices") == 1
    assert list(got) == list(want)
    keep = {k for k in got if k not in ("wall_s", "sca", "vec", "om")}
    assert {k: got[k] for k in keep} == {k: want[k] for k in keep}
    assert got["n_published_sum"] > 0
    a = json.loads(open(want["sca"]).read().replace(str(jdir), "OUT"))
    b = json.loads(open(got["sca"]).read().replace(str(tdir), "OUT"))
    for d in (a, b):
        d.pop("recorded_at")
        d["attrs"].pop("n_devices")
    assert b == a
    assert open(got["om"]).read() == without_compile_families(open(want["om"]).read())
    va, vb = np.load(want["vec"]), np.load(got["vec"])
    assert sorted(vb.files) == sorted(va.files) and "tick.q_len" in vb.files
    for f in va.files:
        assert vb[f].dtype == va[f].dtype and vb[f].tobytes() == va[f].tobytes(), f
