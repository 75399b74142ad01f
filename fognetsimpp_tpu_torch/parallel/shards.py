"""The shards of one world, run side by side in one process.

Counterpart of what ``shard_map`` over a one-axis mesh gives the JAX
package (``fognetsimpp_tpu/parallel/tp.py``, ``parallel/mesh.py``): one
shard body per device, ``lax.axis_index`` for the body's shard, and the
collectives between bodies.  Here a :class:`ShardGroup` runs one Python
thread per shard, all on one device, and owns the collectives the
task-sharded tick uses: :meth:`~ShardGroup.psum`,
:meth:`~ShardGroup.ring_all_gather` and :meth:`~ShardGroup.ring_topk_merge`.

Every collective is a blocking call that each shard makes at the same
point of its body: the shard deposits its tensor, the group waits on a
barrier, shard 0 computes the result (a sum in shard order 0..n-1, or one
launch of the all-gather kernel), a second barrier wait follows, and each
shard takes its own copy.  On a card every worker runs on the caller's
CUDA stream, so all the shards' launches are ordered on that one stream
and a collective reads the other shards' deposits in order.

The shards take turns on the host: a shard holds the group's turn lock
while it runs and gives it up only while it waits at a collective.  The
threads then never contend for the interpreter lock op by op, which
costs a thread switch per tensor op (about 5x the time of a small op
with eight shards); the device work is ordered on one stream either way.

A shard that raises breaks the barrier, the others stop at their next
collective, and :meth:`ShardGroup.run` re-raises the first error in the
caller; the barrier's timeout ends a run that a fault would otherwise
hang.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence, TypeVar

import torch

from ..ops.queues import topk_merge_sorted
from ..ops.ring_kernels import ring_all_gather

R = TypeVar("R")

#: Seconds a shard may wait at a collective before the run is abandoned.
DEFAULT_TIMEOUT_S = 300.0


class ShardGroup:
    """``n`` shards of one world on ``device``, one thread each."""

    def __init__(self, n: int, device, timeout: float = DEFAULT_TIMEOUT_S):
        if n < 1:
            raise ValueError(f"a shard group needs n >= 1 shards, got {n}")
        self.n = int(n)
        self.device = torch.device(device)
        self.timeout = float(timeout)
        self._barrier = threading.Barrier(self.n, timeout=self.timeout)
        self._turn = threading.Lock()
        self._in: List[Optional[object]] = [None] * self.n
        self._out: List[Optional[object]] = [None] * self.n

    # ------------------------------------------------------------------
    # running the bodies
    # ------------------------------------------------------------------

    def run(self, body: Callable[[int], R]) -> List[R]:
        """``body(shard)`` on one thread per shard; the results in shard
        order.  Re-raises the first shard's error that did not come from
        the broken barrier itself."""
        results: List[Optional[R]] = [None] * self.n
        errors: List[Optional[BaseException]] = [None] * self.n
        card = self.device.type == "cuda"
        stream = torch.cuda.current_stream(self.device) if card else None

        def work(shard: int) -> None:
            self._turn.acquire()
            try:
                if card:
                    with torch.cuda.device(self.device), torch.cuda.stream(stream):
                        results[shard] = body(shard)
                else:
                    results[shard] = body(shard)
            except BaseException as e:  # noqa: BLE001 - handed to the caller
                errors[shard] = e
                self._barrier.abort()
            finally:
                self._turn.release()

        threads = [
            threading.Thread(target=work, args=(s,), name=f"shard-{s}")
            for s in range(self.n)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._in = [None] * self.n
        self._out = [None] * self.n
        if any(e is not None for e in errors):
            self._barrier = threading.Barrier(self.n, timeout=self.timeout)
            causes = [
                e for e in errors
                if e is not None and not isinstance(e, threading.BrokenBarrierError)
            ]
            raise (causes or [e for e in errors if e is not None])[0]
        return results  # type: ignore[return-value]

    # ------------------------------------------------------------------
    # collectives
    # ------------------------------------------------------------------

    def _wait(self) -> None:
        """Wait at the barrier, giving up the host turn meanwhile."""
        self._turn.release()
        try:
            self._barrier.wait()
        finally:
            self._turn.acquire()

    def _exchange(self, shard: int, x, combine: Callable[[list], list]):
        """Deposit ``x``; shard 0 turns the deposits into one output per
        shard; each shard takes its own."""
        self._in[shard] = x
        self._wait()
        if shard == 0:
            self._out = combine(list(self._in))
        self._wait()
        return self._out[shard]

    def psum(self, shard: int, x: torch.Tensor) -> torch.Tensor:
        """The sum over shards, taken in shard order 0..n-1 (``psum``)."""

        def total(xs: Sequence[torch.Tensor]) -> list:
            acc = xs[0]
            for y in xs[1:]:
                acc = acc + y
            return [acc.clone() for _ in xs]

        return self._exchange(shard, x, total)

    def ring_all_gather(self, shard: int, block: torch.Tensor) -> torch.Tensor:
        """Every shard's ``(K, C)`` block, as ``(n*K, C)`` in shard order:
        one launch of the ring kernel for all shards
        (:func:`..ops.ring_kernels.ring_all_gather`)."""
        return self._exchange(shard, block, ring_all_gather)

    def ring_topk_merge(self, shard: int, win: torch.Tensor) -> torch.Tensor:
        """The best ``K`` rows of all shards' ``(K, W)`` windows, each
        sorted ascending on its last column (``taskshard.ring_topk_merge``).

        The windows fold in the JAX ring's hop order: the accumulator
        starts as this shard's own window and hop ``h`` merges the window
        of shard ``shard - h``, the block the ring hands on.
        """
        wins = self._exchange(shard, win, lambda ws: [ws] * len(ws))
        acc = win
        for h in range(1, self.n):
            acc = topk_merge_sorted(acc, wins[(shard - h) % self.n])
        return acc
