"""CPU cost of a threefry2x32 call on plain CPU tensors, by route and size.

    python3 -m fognetsimpp_tpu_torch.tools.host_cipher

Plain CPU tensors run the cipher's rounds (``random._threefry_words``) on
Python ints, one word at a time, up to ``random._HOST_SCALAR_MAX`` words,
and on numpy ``uint32`` arrays past it; a card's tensors run them as
tensor ops.  This script times one call of each route (the best of five
repeats of 200 calls, torch on one thread) for 1 to 128 words and prints
one JSON line a size, in microseconds: the route whose cost is lower at a
size is the one the threshold should give it.  Runs on the CPU.
"""
from __future__ import annotations

import json
import timeit

import numpy as np
import torch

from .. import random as trandom
from ..device import host_routes

SIZES = (1, 2, 4, 8, 12, 16, 32, 64, 128)


def _us(fn) -> float:
    return min(timeit.repeat(fn, number=200, repeat=5)) / 200 * 1e6


def main() -> int:
    torch.set_num_threads(1)
    for n in SIZES:
        k1, k2 = torch.tensor(5), torch.tensor(7)
        x1, x2 = torch.zeros(n, dtype=torch.int64), torch.arange(n)
        cols = [t.expand(n).tolist() for t in (k1, k2, x1, x2)]
        words = [np.asarray(c, np.uint32) for c in cols]

        def tensor_ops():
            with host_routes(False):
                trandom.threefry2x32(k1, k2, x1, x2)

        print(json.dumps({
            "words": n,
            "python_ints_us": _us(lambda: [trandom._threefry_words(*w) for w in zip(*cols)]),
            "numpy_uint32_us": _us(lambda: trandom._threefry_words(*words, mask=None)),
            "tensor_ops_us": _us(tensor_ops),
            "threshold": trandom._HOST_SCALAR_MAX,
        }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
