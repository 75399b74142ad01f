"""Device choice for the port's entry points."""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With no device asked for and no CUDA device present this raises: the
    port never falls back to the CPU on its own.  Tests and reference
    runs pass ``device="cpu"`` explicitly.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "fognetsimpp_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


#: Whether plain CPU tensors may take the host routes (:func:`plain_host`).
_HOST_ROUTES = [True]


@contextlib.contextmanager
def host_routes(on: bool) -> Iterator[None]:
    """Within the block, plain CPU tensors take the host routes (``on``)
    or the tensor ops that a card's tensors take (not ``on``).  The tests
    hold both routes to the same reference on the same inputs."""
    old = _HOST_ROUTES[0]
    _HOST_ROUTES[0] = bool(on)
    try:
        yield
    finally:
        _HOST_ROUTES[0] = old


def plain_host(*tensors: torch.Tensor) -> bool:
    """True when every tensor is an ordinary CPU tensor, not a
    ``torch.func`` batched or functional wrapper, and the host routes are
    on (:func:`host_routes`).  The CPU path may then skip the
    custom-operator dispatch (whose batching rules only a ``vmap`` needs)
    or compute on the tensor's words as numpy arrays or Python ints, the
    same operations at a fraction of torch's dispatch cost."""
    if not _HOST_ROUTES[0]:
        return False
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    for t in tensors:
        if not t.is_cpu or wrapped(t):
            return False
    return True
