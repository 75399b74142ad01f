"""The port package's public names are the JAX package's.

Every name ``fognetsimpp_tpu/__init__.py`` exports (its ``from ... import``
lists, read from its syntax tree) is an attribute of
``fognetsimpp_tpu_torch``, from the port's own modules, and so are the
``chaos``, ``hier``, ``telemetry``, ``runtime``, ``config``, ``twin`` and
``parallel`` subpackages' names, and the public names of the ``messages`` module, the
CLI module, the telemetry exporters and the twin's modules.
Importing the package builds no kernel.
"""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import fognetsimpp_tpu_torch as port

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _exported(init: pathlib.Path):
    """Names bound by the ``from . import`` lists and top-level
    assignments of a package's ``__init__.py``."""
    names = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names


@pytest.mark.parametrize("pkg", [
    "", "chaos", "hier", "telemetry", "runtime", "config", "twin", "parallel",
])
def test_every_jax_public_name_is_in_the_port(pkg):
    names = _exported(REPO / "fognetsimpp_tpu" / pkg / "__init__.py")
    assert names
    mod = port
    if pkg:
        mod = __import__(f"fognetsimpp_tpu_torch.{pkg}", fromlist=["_"])
    missing = sorted(n for n in names if not hasattr(mod, n))
    assert missing == []
    for n in names:
        owner = getattr(getattr(mod, n), "__module__", None)
        if owner is not None and not owner.startswith(("enum", "typing", "builtins")):
            assert owner.startswith("fognetsimpp_tpu_torch"), (n, owner)


def _defined(path: pathlib.Path):
    """Public names a module defines at its top level (functions,
    classes, assignments)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("mod", [
    "messages", "__main__", "telemetry/openmetrics", "telemetry/timeline",
    "telemetry/live", "twin/gates", "twin/ingest", "twin/whatif", "twin/front",
])
def test_every_jax_module_name_is_in_the_port(mod):
    names = _defined(REPO / "fognetsimpp_tpu" / f"{mod}.py")
    assert names
    port_mod = __import__(f"fognetsimpp_tpu_torch.{mod.replace('/', '.')}", fromlist=["_"])
    assert sorted(n for n in names if not hasattr(port_mod, n)) == []


def test_the_public_names_run_a_world():
    spec = port.WorldSpec(n_users=2, n_fogs=2, send_interval=0.05, horizon=0.02)
    spec = spec.validate()
    state = port.init_state(spec, device="cpu")
    assert isinstance(state, port.WorldState)
    key, dyn = port.split_spec(spec)
    assert port.shape_key(spec) == key and isinstance(dyn, port.DynSpec)
    assert port.policy_from_name("min_busy") == port.Policy.MIN_BUSY
    assert port.hier_policy_from_name("threshold") == port.HierPolicy.THRESHOLD
    assert port.__version__ == "0.1.0"


def test_importing_the_package_builds_no_kernel():
    code = (
        "import sys, fognetsimpp_tpu_torch\n"
        "from fognetsimpp_tpu_torch.ops import cuda_build\n"
        "assert cuda_build._lib is None\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'fognetsimpp_tpu.'))"
        " for m in sys.modules)\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
