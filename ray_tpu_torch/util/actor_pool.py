"""ActorPool — round-robin work distribution over a fixed set of actors.

Reference analogue: `python/ray/util/actor_pool.py` (``ActorPool.map``,
``map_unordered``, ``submit``/``get_next``).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List

__all__ = ["ActorPool"]


class ActorPool:
    def __init__(self, actors: List[Any]):
        if not actors:
            raise ValueError("ActorPool needs at least one actor")
        self._idle = list(actors)
        self._future_to_actor = {}
        self._pending_order: List[Any] = []  # refs in submission order

    def has_free(self) -> bool:
        return bool(self._idle)

    def submit(self, fn: Callable[[Any, Any], Any], value: Any):
        """``fn(actor, value) -> ObjectRef`` — e.g.
        ``pool.submit(lambda a, v: a.double.remote(v), 1)``."""
        if not self._idle:
            raise RuntimeError("no idle actor; call get_next() first")
        actor = self._idle.pop(0)
        ref = fn(actor, value)
        self._future_to_actor[ref] = actor
        self._pending_order.append(ref)
        return ref

    def has_next(self) -> bool:
        return bool(self._pending_order)

    def _recycle(self, ref):
        actor = self._future_to_actor.pop(ref)
        self._idle.append(actor)

    def get_next(self, timeout: float = None):
        """Next result in SUBMISSION order.  On timeout the pending ref is
        kept (retry get_next later); the actor stays busy."""
        import ray_tpu_torch

        if not self._pending_order:
            raise StopIteration
        ref = self._pending_order[0]
        try:
            result = ray_tpu_torch.get(ref, timeout=timeout)
        except TimeoutError:
            raise  # still running: keep the ref pending, actor stays busy
        except Exception:
            # the task FAILED: it is finished, so free the actor
            self._pending_order.pop(0)
            self._recycle(ref)
            raise
        self._pending_order.pop(0)
        self._recycle(ref)
        return result

    def get_next_unordered(self, timeout: float = None):
        """Next COMPLETED result, whichever actor finishes first."""
        import ray_tpu_torch

        if not self._pending_order:
            raise StopIteration
        ready, _ = ray_tpu_torch.wait(list(self._pending_order), num_returns=1,
                                timeout=timeout)
        if not ready:
            raise TimeoutError("no task completed within timeout")
        ref = ready[0]
        self._pending_order.remove(ref)
        try:
            return ray_tpu_torch.get(ref)
        finally:
            self._recycle(ref)

    def map(self, fn: Callable[[Any, Any], Any], values: Iterable[Any]):
        """Ordered results; saturates the pool, yields lazily."""
        values = list(values)
        i = 0
        while i < len(values) and self.has_free():
            self.submit(fn, values[i])
            i += 1
        while self.has_next():
            yield self.get_next()
            if i < len(values):
                self.submit(fn, values[i])
                i += 1

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]):
        values = list(values)
        i = 0
        while i < len(values) and self.has_free():
            self.submit(fn, values[i])
            i += 1
        while self.has_next():
            yield self.get_next_unordered()
            if i < len(values):
                self.submit(fn, values[i])
                i += 1
