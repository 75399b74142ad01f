"""Checkpoint/resume: snapshot the whole world, restore it, keep running
(``fognetsimpp_tpu/runtime/checkpoint.py``, in the same file format).

A checkpoint is one npz: ``leaf_<i>`` for the state's leaves in JAX's
``jax.tree.leaves`` order (PRNG keys as uint32, as JAX holds them) and
``spec_json``, the spec as :func:`.recorder.spec_to_dict` writes it.  The
state's structure is a pure function of the spec, so :func:`load`
rebuilds the skeleton from the spec and pours the leaves back in; a file
written by either package loads in the other, and a resumed run
continues bit-identically (the PRNG key is part of the state).
"""
from __future__ import annotations

import json
from typing import Tuple

import numpy as np

import torch.utils._pytree as pytree

from ..core.contracts import assert_same_struct
from ..spec import WorldSpec
from ..state import WorldState, init_state, state_from_numpy, state_to_numpy, tree_leaves
from .recorder import dict_to_spec, spec_to_dict


def save(path: str, spec: WorldSpec, state: WorldState) -> None:
    """Write ``<path>`` (npz): spec JSON + the state's leaves."""
    arrays = {f"leaf_{i}": a for i, a in enumerate(state_to_numpy(state))}
    arrays["spec_json"] = np.frombuffer(
        json.dumps(spec_to_dict(spec)).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def load(path: str, device=None) -> Tuple[WorldSpec, WorldState]:
    """Rebuild ``(spec, state)`` from a :func:`save` file (or JAX's), the
    state on ``device`` (the card unless the caller names one)."""
    with np.load(path) as z:
        spec_d = json.loads(bytes(z["spec_json"]).decode())
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]
    spec = dict_to_spec(spec_d)
    skeleton = init_state(spec, device="cpu")
    names = [name for name, _ in tree_leaves(skeleton)]
    if len(leaves) != len(names):
        raise ValueError(
            f"checkpoint {path!r} has {len(leaves)} state leaves, spec "
            f"expects {len(names)} — saved by an incompatible "
            "WorldState layout"
        )
    # each leaf's shape and dtype against the spec's skeleton (the carry
    # contract, core/contracts.py); keys are uint32 on file, int64 words
    # in the port
    on_file = [
        a.astype(np.int64) if a.dtype == np.uint32 and (n == "key" or n.endswith(".key"))
        else a
        for n, a in zip(names, leaves)
    ]
    assert_same_struct(
        skeleton, pytree.tree_unflatten(on_file, pytree.tree_structure(skeleton)),
        what=f"checkpoint {path!r}",
    )
    return spec, state_from_numpy(leaves, device)
