"""Every port test file runs torch's CPU ops on one thread.

Six test workers share the machine, and the JAX runtime beside torch in
each of them: torch's default OpenMP pool only spins there (a link-queue
world took 971-974 s a test six at a time on 8 threads, 17-21 s on one).
So each ``tests/test_torch_*.py`` defines its own autouse fixture that
calls ``torch.set_num_threads(1)``.  The check reads the files' syntax
trees; it imports none of them.
"""
import ast
import pathlib

import pytest
import torch

TESTS = pathlib.Path(__file__).resolve().parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _is_autouse_fixture(deco: ast.expr) -> bool:
    return (
        isinstance(deco, ast.Call)
        and ast.unparse(deco.func) == "pytest.fixture"
        and any(
            k.arg == "autouse" and isinstance(k.value, ast.Constant) and k.value.value is True
            for k in deco.keywords
        )
    )


def _sets_one_thread(fn: ast.FunctionDef) -> bool:
    return any(
        isinstance(n, ast.Call)
        and ast.unparse(n.func) == "torch.set_num_threads"
        and len(n.args) == 1
        and isinstance(n.args[0], ast.Constant)
        and n.args[0].value == 1
        for n in ast.walk(fn)
    )


def caps_torch_threads(path: pathlib.Path) -> bool:
    tree = ast.parse(path.read_text(), filename=str(path))
    return any(
        isinstance(node, ast.FunctionDef)
        and any(_is_autouse_fixture(d) for d in node.decorator_list)
        and _sets_one_thread(node)
        for node in tree.body
    )


def test_every_port_test_file_caps_torch_at_one_thread():
    files = sorted(TESTS.glob("test_torch_*.py"))
    assert len(files) >= 30
    assert [f.name for f in files if not caps_torch_threads(f)] == []


def test_the_check_tells_a_capped_file_from_one_without(tmp_path):
    fixture = (TESTS / "test_torch_hygiene.py").read_text()
    capped = tmp_path / "capped.py"
    capped.write_text(fixture)
    assert caps_torch_threads(capped)
    for wrong in (
        fixture.replace("autouse=True", "autouse=False"),
        fixture.replace("set_num_threads(1)", "set_num_threads(2)"),
        "import torch\ntorch.set_num_threads(1)\n",
    ):
        capped.write_text(wrong)
        assert not caps_torch_threads(capped)
