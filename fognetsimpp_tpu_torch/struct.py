"""The dataclass-of-tensors idiom every state tree of the port uses."""
from __future__ import annotations

import dataclasses

import torch.utils._pytree as pytree


class Struct:
    """Mixin: functional field replacement, as flax's ``.replace``."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def register_pytree(cls):
    """Class decorator: ``cls``, a dataclass of tensors and dataclasses,
    becomes a torch pytree node whose children are its fields in order."""
    pytree.register_dataclass(cls)
    return cls
