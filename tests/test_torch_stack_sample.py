"""``tools/stack_sample.py``: a script's ``main()`` run under the stack
sampler, its return code kept and its busy line at the top of the report."""
from __future__ import annotations

import json
import textwrap

import pytest
import torch

from fognetsimpp_tpu_torch.tools import stack_sample


@pytest.fixture(autouse=True)
def one_torch_thread():
    """No torch work here: one thread beside the other test workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


SCRIPT = textwrap.dedent("""
    import time


    def busy(seconds):
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            n += 1
        return n


    def main():
        busy(0.4)
        return 3
""")


def test_sample_charges_the_busy_line_and_keeps_the_return_code(tmp_path, capsys):
    script = tmp_path / "toy_busy.py"
    script.write_text(SCRIPT)
    out = tmp_path / "out" / "samples.json"
    rc = stack_sample.main([str(script), "--out", str(out), "--period", "0.005"])
    assert rc == 3
    data = json.loads(out.read_text())
    assert data["wall"] >= 0.4
    lines = stack_sample.report(data).splitlines()
    script_rows = lines[lines.index("-- script lines") + 1:lines.index("-- functions")]
    assert script_rows[0].split()[-1].startswith("busy:")
    assert float(script_rows[0].split()[0]) > 0.2
    assert "toy_busy.py:busy" in capsys.readouterr().err
    assert stack_sample.main(["--report", str(out)]) == 0
    assert "-- functions" in capsys.readouterr().out
