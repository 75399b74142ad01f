"""The runtime sanitizer behind ``engine.run_checkified``: a debug run that
stops at the first integer division by zero, NaN or out-of-range index
(``jax.experimental.checkify`` in the JAX package).

:class:`Sanitizer` is a ``TorchDispatchMode``: it sees every aten
operator of the run and every ``fns::`` custom operator (a kernel is
checked as one operator, as checkify checks a ``pallas_call`` as one
primitive: its inside is not instrumented).  Its sets keep JAX's names
(``engine.CHECKIFY_SETS``):

- ``div``: an integer ``div`` (with a rounding mode), ``floor_divide``,
  ``remainder`` or ``fmod`` whose divisor holds a zero;
- ``nan``: a floating output that holds a NaN, of an operator of
  checkify's NaN family (``nan_primitives`` in ``jax/_src/checkify.py``:
  the arithmetic, the transcendental functions, sums, products,
  cumulative ops, matrix products, padding).  What checkify exempts is
  exempt here: selects (``where``), comparisons, ``maximum`` /
  ``minimum`` / ``clamp``, ``neg``, ``abs``, rounding, casts, copies,
  gathers, and scatters unless ``oob`` is on too (checkify checks a
  scatter's output for NaNs only beside its index check);
- ``oob``: an index operator (``index``, ``index_put_``,
  ``index_select``, ``gather``, ``scatter*``, ``index_add_``,
  ``index_copy_``, ``index_fill_``, ``take``) whose index falls outside
  the dimension: ``[-n, n)`` for ``index``, ``index_put_`` and
  ``take``, which wrap a negative index, ``[0, n)`` for the rest.

The run keeps one 0-d flag on its device: the index of the first (set,
operator) that tripped, -1 while none has; each check folds its verdict
into it (a check of a host scalar, such as a divisor given as a Python
number, as a CPU scalar).  Nothing waits for the card per operator;
:meth:`Sanitizer.throw` reads the flag once, after the run, and raises
:class:`CheckifyError` naming the set and the operator that tripped
first.  So that a run with a bad operand gets
to that point, the operator runs on a repaired operand (a zero divisor
made one, an out-of-range index made zero), which changes nothing where
no check trips.

On the CPU the run takes the tensor route (``device.host_routes(False)``):
the numpy host routes compute outside the dispatcher, where no mode sees
them.

One departure from the JAX package, by design: JAX's ``oob`` trips on the
stock engine, whose drop-mode scatters index one past the table
(``NO_TASK`` rows, ``fognetsimpp_tpu/core/engine.py:4422-4431``).  The
port routes those writes into a spare slot past the end and cuts it off
(:mod:`..ops.scatter`), so its ``oob`` is clean on the same world and
trips only on a real out-of-range index.

A slow path for debug runs: nothing on the main path calls it.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_DIV_OPS = frozenset({"div", "floor_divide", "remainder", "fmod"})

# checkify's nan_primitives, as aten operators: add, sub, mul, div, rem,
# pow / integer_pow, the exponentials, logarithms, roots and
# trigonometric functions, erf / erfc / erf_inv, lgamma, digamma,
# logistic, cumsum / cumprod / cummax / cummin / cumlogsumexp,
# reduce_sum / reduce_prod, dot_general, conv and pad
_NAN_OPS = frozenset({
    "add", "sub", "rsub", "mul", "div", "remainder", "fmod", "pow", "float_power",
    "square", "reciprocal", "exp", "exp2", "expm1", "log", "log2", "log10", "log1p",
    "sqrt", "rsqrt", "sin", "cos", "tan", "sinh", "cosh", "tanh", "asin", "acos",
    "atan", "atan2", "asinh", "acosh", "atanh", "erf", "erfc", "erfinv", "lgamma",
    "digamma", "sigmoid", "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp",
    "sum", "mean", "prod", "mm", "bmm", "addmm", "addmv", "baddbmm", "matmul",
    "mv", "dot", "vdot", "convolution", "constant_pad_nd", "addcmul", "addcdiv",
    "lerp",
})

# index operators taking (operand, dim, index, ...)
_DIM_INDEX_OPS = frozenset({"index_select", "gather", "scatter", "scatter_add",
                            "scatter_reduce", "index_add", "index_copy", "index_fill"})
_LIST_INDEX_OPS = frozenset({"index", "_unsafe_index", "index_put", "_unsafe_index_put",
                             "_index_put_impl"})
_SCATTER_OPS = frozenset({"scatter", "scatter_add", "scatter_reduce", "index_put",
                          "_unsafe_index_put", "_index_put_impl", "index_add"})


class CheckifyError(RuntimeError):
    """A check of :func:`..core.engine.run_checkified` tripped: ``set``
    names the check set, ``op`` the operator that tripped first."""

    def __init__(self, set_name: str, op: str):
        self.set = set_name
        self.op = op
        what = {
            "div": "integer division by zero",
            "nan": "nan generated",
            "oob": "out-of-bounds index",
        }[set_name]
        super().__init__(f"{set_name}: {what} by operator {op}")


def _base(func) -> str:
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") else name


def _op_name(func) -> str:
    return f"{func.namespace}::{func.overloadpacket.__name__}"


class Sanitizer(TorchDispatchMode):
    """Checks every operator of the block against ``sets`` (names from
    ``engine.CHECKIFY_SETS``), its flag on ``device`` (the run's);
    :meth:`throw` after the block raises on the first trip."""

    def __init__(self, sets: Iterable[str], device="cpu"):
        super().__init__()
        self.sets = frozenset(sets)
        self._trips: List[Tuple[str, str]] = []
        self._ids: Dict[Tuple[str, str], int] = {}
        self._flag = torch.full((), -1, dtype=torch.int32, device=device)
        # operator -> (base name, check div, check oob, check nan)
        self._checks: Dict[object, Tuple[str, bool, bool, bool]] = {}

    def _checks_of(self, func) -> Tuple[str, bool, bool, bool]:
        base = _base(func)
        return (
            base,
            "div" in self.sets and base in _DIV_OPS,
            "oob" in self.sets and (base in _DIM_INDEX_OPS or base in _LIST_INDEX_OPS
                                    or base == "take"),
            "nan" in self.sets and (
                base in _NAN_OPS or ("oob" in self.sets and base in _SCATTER_OPS)),
        )

    # ------------------------------------------------------------------
    def _trip(self, set_name: str, func, bad: torch.Tensor) -> None:
        """Record ``(set, operator)`` as the first trip where the 0-d bool
        ``bad`` holds, with no host synchronisation."""
        key = (set_name, _op_name(func))
        i = self._ids.get(key)
        if i is None:
            i = self._ids[key] = len(self._trips)
            self._trips.append(key)
        self._flag = torch.where((self._flag < 0) & bad, i, self._flag)

    def _div(self, func, args: list, kwargs: dict) -> None:
        if _base(func) == "div" and kwargs.get("rounding_mode") is None:
            return  # true division: a float result
        num, den = args[0], args[1]
        if torch.result_type(num, den).is_floating_point:
            return
        if isinstance(den, torch.Tensor):
            zero = den == 0
            self._trip("div", func, zero.any())
            args[1] = torch.where(zero, torch.ones_like(den), den)
        elif den == 0:
            dev = num.device
            self._trip("div", func, torch.ones((), dtype=torch.bool, device=dev))
            args[1] = 1

    def _checked_index(self, func, idx: torch.Tensor, n: int, wraps: bool) -> torch.Tensor:
        bad = (idx < (-n if wraps else 0)) | (idx >= n)
        self._trip("oob", func, bad.any())
        return torch.where(bad, torch.zeros_like(idx), idx) if n > 0 else idx

    def _oob(self, func, base: str, args: list) -> None:
        if base in _DIM_INDEX_OPS:
            x, dim, idx = args[0], args[1], args[2]
            n = x.shape[dim % x.dim()] if x.dim() else 1
            args[2] = self._checked_index(func, idx, n, wraps=False)
        elif base == "take":
            args[1] = self._checked_index(func, args[1], args[0].numel(), wraps=True)
        elif base in _LIST_INDEX_OPS:
            x, idxs = args[0], list(args[1])
            d = 0
            for j, idx in enumerate(idxs):
                if idx is None:
                    d += 1
                elif idx.dtype in (torch.bool, torch.uint8):
                    d += idx.dim()  # a mask spans as many dims as it has
                else:
                    idxs[j] = self._checked_index(func, idx, x.shape[d], wraps=True)
                    d += 1
            args[1] = idxs

    def _nan(self, func, out) -> None:
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for o in outs:
            if isinstance(o, torch.Tensor) and o.is_floating_point():
                self._trip("nan", func, torch.isnan(o).any())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        checks = self._checks.get(func)
        if checks is None:
            checks = self._checks[func] = self._checks_of(func)
        base, div, oob, nan = checks
        if div or oob:
            args = list(args)
            if div:
                self._div(func, args, kwargs)
            if oob:
                self._oob(func, base, args)
        out = func(*args, **kwargs)
        if nan:
            self._nan(func, out)
        return out

    # ------------------------------------------------------------------
    def throw(self) -> None:
        """Read the flag (the run's one wait for its device) and raise
        :class:`CheckifyError` for the first trip, if any."""
        i = int(self._flag.item())
        if i >= 0:
            raise CheckifyError(*self._trips[i])
