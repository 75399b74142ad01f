"""The dataclass-of-tensors idiom every state tree of the port uses."""
from __future__ import annotations

import torch.utils._pytree as pytree


class Struct:
    """Mixin: functional field replacement, as flax's ``.replace``."""

    def replace(self, **changes):
        # ``dataclasses.replace`` without its trip through ``__init__``:
        # the port's state dataclasses have neither ``__post_init__`` nor
        # init-less fields, and the tick replaces some fifty a step
        fields = self.__dict__
        for name in changes:
            if name not in fields:
                raise TypeError(f"{type(self).__name__} has no field {name!r}")
        new = object.__new__(type(self))
        new.__dict__.update(fields)
        new.__dict__.update(changes)
        return new


def register_pytree(cls):
    """Class decorator: ``cls``, a dataclass of tensors and dataclasses,
    becomes a torch pytree node whose children are its fields in order."""
    pytree.register_dataclass(cls)
    return cls
