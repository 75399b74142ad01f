"""The port's CLI run modes against JAX's on the same argv
(``--platform cpu``; ``tests/torch_cli_support.py``): ``--sweep``
(one JSON line a cell), ``--tp 2``, ``--progress`` (one line a chunk)
and the v2 demo config, whose pool fogs take the local-pool scan.
``--replicas`` is ``tests/test_torch_cli_fleet.py``.
"""
import pytest
import torch

from tests.torch_cli_support import (
    assert_same_files,
    assert_same_summary,
    run_both,
    summary_lines,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


SMALL = ["-s", "smoke", "--set", "scenario.n_users=6", "--set", "scenario.horizon=0.1"]


def test_sweep_matches_jax(capsys):
    argv = ["-s", "smoke", "--set", "scenario.n_users=4", "--set", "scenario.horizon=0.05",
            "--sweep", "policies=random loads=0.05,0.02"]
    (jrc, jout, _, _), (trc, tout, _, _) = run_both(argv, capsys)
    assert jrc == trc == 0
    assert_same_summary(jout, tout)
    assert len(summary_lines(tout)) == 3  # a line a load, the wall line


def test_progress_lines_match_jax(capsys):
    (jrc, jout, _, _), (trc, tout, _, _) = run_both(SMALL + ["--progress", "40"], capsys)
    assert jrc == trc == 0
    assert_same_summary(jout, tout)
    assert [ln["tick"] for ln in summary_lines(tout)[:-1]] == [40, 80, 100]


@pytest.mark.parametrize("argv", [
    pytest.param(SMALL + ["--tp", "2"], id="tp2"),
    pytest.param(["-c", "examples/demo_v2.ini", "--set", "scenario.horizon=0.1"],
                 id="demo_v2"),
])
def test_run_modes_match_jax(argv, tmp_path, capsys):
    (jrc, jout, _, jdir), (trc, tout, _, tdir) = run_both(argv, capsys, tmp_path)
    assert jrc == trc == 0
    jsum, tsum = assert_same_summary(jout, tout)
    assert len(assert_same_files(jsum, tsum, jdir, tdir)) == 5
    assert tsum["n_published"] > 0
