"""multiprocessing.Pool drop-in over actors.

Reference analogue: `python/ray/util/multiprocessing/pool.py` (``Pool`` —
the stdlib Pool API running each worker as an actor, so pools span the
cluster).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, List, Optional

__all__ = ["Pool"]


class _PoolWorker:
    def run(self, fn_blob: bytes, args: tuple, kwargs: dict):
        from ray_tpu_torch._vendor import cloudpickle

        fn = cloudpickle.loads(fn_blob)
        return fn(*args, **(kwargs or {}))

    def run_batch(self, fn_blob: bytes, items: List[tuple]):
        from ray_tpu_torch._vendor import cloudpickle

        fn = cloudpickle.loads(fn_blob)
        return [fn(*it) for it in items]


class AsyncResult:
    def __init__(self, refs: List[Any], single: bool):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        import ray_tpu_torch

        out = ray_tpu_torch.get(self._refs, timeout=timeout)
        return out[0] if self._single else out

    def wait(self, timeout: Optional[float] = None):
        import ray_tpu_torch

        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                     timeout=timeout)

    def ready(self) -> bool:
        import ray_tpu_torch

        done, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                               timeout=0)
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result is not ready")
        try:
            self.get(timeout=5)
            return True
        except Exception:  # noqa: BLE001
            return False


class Pool:
    """``Pool(processes=4)`` — apply/map/starmap/imap + async variants."""

    def __init__(self, processes: int = 4,
                 ray_remote_args: Optional[dict] = None):
        from ray_tpu_torch._vendor import cloudpickle

        import ray_tpu_torch

        self._cp = cloudpickle
        opts = dict(ray_remote_args or {})
        opts.setdefault("num_cpus", 1)
        worker_cls = ray_tpu_torch.remote(**opts)(_PoolWorker)
        self._workers = [worker_cls.remote() for _ in range(processes)]
        self._rr = itertools.cycle(range(processes))
        self._closed = False
        self._inflight: List[Any] = []

    def _next_worker(self):
        if self._closed:
            raise ValueError("Pool is closed")
        return self._workers[next(self._rr)]

    # --------------------------------------------------------------- apply

    def apply(self, fn: Callable, args: tuple = (), kwds: dict = None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn: Callable, args: tuple = (),
                    kwds: dict = None) -> AsyncResult:
        blob = self._cp.dumps(fn)
        ref = self._next_worker().run.remote(blob, tuple(args), kwds or {})
        self._inflight.append(ref)
        return AsyncResult([ref], single=True)

    # ----------------------------------------------------------------- map

    def _map_refs(self, fn: Callable, iterable: Iterable,
                  chunksize: Optional[int], star: bool) -> List[Any]:
        items = [tuple(x) if star else (x,) for x in iterable]
        if not items:
            return []
        blob = self._cp.dumps(fn)
        if chunksize is None:
            chunksize = max(1, len(items) // (len(self._workers) * 4))
        refs = []
        for i in range(0, len(items), chunksize):
            refs.append(self._next_worker().run_batch.remote(
                blob, items[i:i + chunksize]))
        self._inflight.extend(refs)
        return refs

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn, iterable, chunksize=None) -> "AsyncResult":
        refs = self._map_refs(fn, iterable, chunksize, star=False)
        return _FlattenResult(refs)

    def starmap(self, fn: Callable, iterable: Iterable,
                chunksize: Optional[int] = None) -> List[Any]:
        import ray_tpu_torch

        refs = self._map_refs(fn, iterable, chunksize, star=True)
        return [x for chunk in ray_tpu_torch.get(refs) for x in chunk]

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: int = 1):
        import ray_tpu_torch

        refs = self._map_refs(fn, iterable, chunksize, star=False)
        for ref in refs:
            yield from ray_tpu_torch.get(ref)

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: int = 1):
        import ray_tpu_torch

        refs = self._map_refs(fn, iterable, chunksize, star=False)
        pending = list(refs)
        while pending:
            done, pending = ray_tpu_torch.wait(pending, num_returns=1)
            yield from ray_tpu_torch.get(done[0])

    # ------------------------------------------------------------ lifecycle

    def close(self):
        self._closed = True

    def terminate(self):
        import ray_tpu_torch

        self._closed = True
        for w in self._workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001
                pass

    def join(self):
        """Blocks until every submitted task finished (stdlib contract)."""
        import ray_tpu_torch

        if not self._closed:
            raise ValueError("join() before close()")
        if self._inflight:
            ray_tpu_torch.wait(self._inflight, num_returns=len(self._inflight))
            self._inflight = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()


class _FlattenResult(AsyncResult):
    def __init__(self, refs):
        super().__init__(refs, single=False)

    def get(self, timeout: Optional[float] = None):
        import ray_tpu_torch

        chunks = ray_tpu_torch.get(self._refs, timeout=timeout)
        return [x for chunk in chunks for x in chunk]
