"""Distributed FIFO queue backed by an asyncio actor.

Reference analogue: `python/ray/util/queue.py` (``Queue`` — an actor
wrapping asyncio.Queue; blocking callers park INSIDE the actor, so a
blocked get/put costs one outstanding actor call, not a poll loop).
"""

from __future__ import annotations

from typing import Any, List, Optional

__all__ = ["Queue", "Empty", "Full"]


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    """Coroutine methods run on the actor's asyncio loop — single-threaded,
    so the queue state is race-free even with many parked callers."""

    def __init__(self, maxsize: int):
        import asyncio

        self._q: "asyncio.Queue" = asyncio.Queue(maxsize=maxsize)

    async def qsize(self) -> int:
        return self._q.qsize()

    async def empty(self) -> bool:
        return self._q.empty()

    async def full(self) -> bool:
        return self._q.full()

    async def put(self, item, timeout: Optional[float]) -> bool:
        """timeout None = wait forever; 0 = non-blocking."""
        import asyncio

        if timeout == 0:
            try:
                self._q.put_nowait(item)
                return True
            except asyncio.QueueFull:
                return False
        try:
            await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def put_batch(self, items: List[Any]) -> bool:
        """All-or-nothing: no partial enqueue on overflow."""
        import asyncio

        if self._q.maxsize > 0 and \
                self._q.qsize() + len(items) > self._q.maxsize:
            return False
        for item in items:
            try:
                self._q.put_nowait(item)
            except asyncio.QueueFull:  # pragma: no cover — capacity checked
                return False
        return True

    async def get(self, timeout: Optional[float]):
        import asyncio

        if timeout == 0:
            try:
                return True, self._q.get_nowait()
            except asyncio.QueueEmpty:
                return False, None
        try:
            return True, await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    async def get_batch(self, n: int):
        import asyncio

        out = []
        while len(out) < n:
            try:
                out.append(self._q.get_nowait())
            except asyncio.QueueEmpty:
                break
        return out


class Queue:
    """``Queue(maxsize=0)`` — unbounded by default; handles are
    serializable, so producers/consumers can live in any task or actor."""

    def __init__(self, maxsize: int = 0,
                 *, actor_options: Optional[dict] = None):
        import ray_tpu_torch

        self.maxsize = maxsize
        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0)
        # Each PARKED blocking caller holds one concurrency slot until it
        # resolves; the default matches the reference's async-actor default
        # (1000) so realistic producer/consumer counts cannot wedge the
        # actor's dispatch queue.  Parked coroutines are cheap (one asyncio
        # task each).
        opts.setdefault("max_concurrency", 1000)
        self._actor = ray_tpu_torch.remote(_QueueActor).options(**opts).remote(
            maxsize)

    # ------------------------------------------------------------- inspect

    def qsize(self) -> int:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor.qsize.remote())

    def empty(self) -> bool:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor.empty.remote())

    def full(self) -> bool:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor.full.remote())

    # ------------------------------------------------------------- put/get

    def put(self, item, block: bool = True,
            timeout: Optional[float] = None):
        import ray_tpu_torch

        t = 0 if not block else timeout
        ok = ray_tpu_torch.get(self._actor.put.remote(item, t))
        if not ok:
            raise Full

    def put_nowait(self, item):
        self.put(item, block=False)

    def get(self, block: bool = True, timeout: Optional[float] = None):
        import ray_tpu_torch

        t = 0 if not block else timeout
        ok, item = ray_tpu_torch.get(self._actor.get.remote(t))
        if not ok:
            raise Empty
        return item

    def get_nowait(self):
        return self.get(block=False)

    def put_nowait_batch(self, items: List[Any]):
        import ray_tpu_torch

        if not ray_tpu_torch.get(self._actor.put_batch.remote(list(items))):
            raise Full(f"{len(items)} items do not fit")

    def get_nowait_batch(self, n: int) -> List[Any]:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor.get_batch.remote(n))

    def shutdown(self):
        import ray_tpu_torch

        try:
            ray_tpu_torch.kill(self._actor)
        except Exception:  # noqa: BLE001
            pass
