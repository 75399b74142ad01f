"""The port's CUDA sources, built into one shared library at first use.

Every source in :data:`SOURCES` (``csrc/``) is compiled for sm_90a by its
own ``nvcc`` process, all started together, and the objects are linked
into one shared library with a plain C interface, bound with ``ctypes``.
The library lives in ``_build/`` under a name keyed on the hash of all
the sources, so an edited source is rebuilt and an unchanged tree is not.
The first kernel call builds it; :func:`build` also returns ``ptxas``'s
report (registers, shared memory, spills) for whoever wants to print it.
The wrappers' shared helpers live here too: launch counts, the stream,
error checks, the input taps and the batching rules' operand layout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
#: The kernel sources, in link order.
SOURCES = ("arrival_plan.cu", "ring_gather.cu", "cell_sum.cu", "pool_scan.cu")

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_fns: Dict[str, object] = {}

#: Callables ``tap(name, *inputs)`` that every kernel wrapper hands its
#: inputs to before it runs, at the level where a kernel sees them (a
#: replica batch laid end to end); a harness appends one to keep real
#: windows and removes it after.
TAPS: List[Callable] = []


def count_launch(launches: Dict[str, int], name: str) -> None:
    """Add one to ``launches[name]``; shard threads launch concurrently."""
    with _count_lock:
        launches[name] += 1


def tap(name: str, *inputs) -> None:
    """Hand a kernel call's inputs to every callable in :data:`TAPS`."""
    for fn in TAPS:
        fn(name, *inputs)


def batch_first(x: torch.Tensor, dim: Optional[int], n: int) -> torch.Tensor:
    """A batching rule's operand with its replica axis first and
    contiguous, broadcast to ``n`` rows where it has none (``dim`` None)."""
    if dim is None:
        return x.expand((n,) + tuple(x.shape)).contiguous()
    return x.movedim(dim, 0).contiguous()


def stream_of(dev) -> int:
    """The calling thread's current CUDA stream on ``dev``, as a handle."""
    return torch.cuda.current_stream(dev).cuda_stream


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand:
        return cand
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_paths() -> List[str]:
    return [os.path.join(CSRC, s) for s in SOURCES]


def library_path() -> str:
    """Where the built library lives, keyed on every source's bytes."""
    h = hashlib.sha256()
    for path in _source_paths():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfns_kernels_{h.hexdigest()[:16]}.so")


def _compile_command(src: str, obj: str) -> list:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c", "-o", obj, src,
    ]


def _build_locked() -> Tuple[str, float, str]:
    out = library_path()
    if os.path.exists(out):
        return out, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _source_paths():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            _compile_command(src, obj), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ))
    logs, failed = [], []
    for src, proc in zip(_source_paths(), procs):
        text, _ = proc.communicate()
        logs.append(f"== {os.path.basename(src)}\n{text}")
        if proc.returncode != 0:
            failed.append(os.path.basename(src))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = f"{out}.{tag}.tmp"
    link = subprocess.run(
        [_nvcc(), "-shared", "-o", tmp, *objs],
        capture_output=True, text=True, check=False,
    )
    for obj in objs:
        os.remove(obj)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, "\n".join(logs)


def build() -> Tuple[str, float, str]:
    """Compile and link the kernels unless the library is built.

    Returns ``(path, seconds, compiler output)``; raises with ``nvcc``'s
    output if a build fails.
    """
    with _lock:
        return _build_locked()


def function(name: str, argtypes: list, restype=ctypes.c_int):
    """The library's C function ``name`` with its ``ctypes`` argument
    types, returning ``restype`` (a ``cudaError_t`` as int unless given);
    builds on first use."""
    global _lib
    with _lock:
        fn = _fns.get(name)
        if fn is None:
            if _lib is None:
                path, _, _ = _build_locked()
                _lib = ctypes.CDLL(path)
            fn = getattr(_lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
            _fns[name] = fn
        return fn
