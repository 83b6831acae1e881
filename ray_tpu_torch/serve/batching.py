"""``@serve.batch`` — transparent request batching inside a replica.

Port of ``ray_tpu/serve/batching.py`` (reference analogue:
`python/ray/serve/batching.py:337`: ``@serve.batch`` wraps a method taking
``List[request]``; concurrent callers are grouped up to ``max_batch_size``
or ``batch_wait_timeout_s``).  Callers (the threads a replica serves
requests on) enqueue (request, future) pairs; one flusher thread per
wrapped function forms batches and distributes results.  The JAX module's
batch-size telemetry is not ported yet: it waits for the replica's
telemetry hooks (ROADMAP).
"""

from __future__ import annotations

import functools
import queue
import threading
import time
from typing import Any, Callable, List, Optional

__all__ = ["batch", "batch_sizes_of"]


class _Batcher:
    def __init__(self, fn: Callable[[Any, List[Any]], List[Any]],
                 max_batch_size: int, batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout = batch_wait_timeout_s
        self.queue: "queue.Queue" = queue.Queue()
        self.batch_sizes: List[int] = []  # observability / tests
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def _ensure_thread(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, name="serve-batcher", daemon=True)
                self._thread.start()

    def _loop(self):
        while True:
            item = self.queue.get()  # block for the first element
            batch = [item]
            deadline = time.monotonic() + self.timeout
            while len(batch) < self.max_batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.queue.get(timeout=remaining))
                except queue.Empty:
                    break
            self.batch_sizes.append(len(batch))
            owner = batch[0][0]
            requests = [req for _, req, _ in batch]
            try:
                results = self.fn(owner, requests) if owner is not None \
                    else self.fn(requests)
                if len(results) != len(requests):
                    raise ValueError(
                        f"batched function returned {len(results)} results "
                        f"for {len(requests)} requests")
                for (_, _, fut), res in zip(batch, results):
                    fut["result"] = res
                    fut["event"].set()
            except Exception as e:  # noqa: BLE001 - handed to every caller
                for _, _, fut in batch:
                    fut["error"] = e
                    fut["event"].set()

    def submit(self, owner, request, timeout: float = 60.0):
        self._ensure_thread()
        fut = {"event": threading.Event(), "result": None, "error": None}
        self.queue.put((owner, request, fut))
        if not fut["event"].wait(timeout):
            raise TimeoutError("batched call timed out")
        if fut["error"] is not None:
            raise fut["error"]
        return fut["result"]


def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorate a method/function taking a LIST of requests; single-request
    calls are grouped transparently::

        class Model:
            @batch(max_batch_size=16, batch_wait_timeout_s=0.005)
            def __call__(self, inputs):      # inputs: List[request]
                return model_forward(inputs)  # List[response]
    """

    def wrap(fn):
        @functools.wraps(fn)
        def method_wrapper(self_or_req, *rest):
            b = _live_batcher(method_wrapper, fn, max_batch_size,
                              batch_wait_timeout_s)
            if rest:  # bound method: (self, request)
                return b.submit(self_or_req, rest[0])
            return b.submit(None, self_or_req)

        method_wrapper._is_serve_batch = True
        method_wrapper._batch_config = {
            "max_batch_size": max_batch_size,
            "batch_wait_timeout_s": batch_wait_timeout_s,
        }
        return method_wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap


# The batcher holds threads/queues — never picklable, so it lives in a
# process-local registry rather than the (pickled) closure.  Keyed by the
# wrapper's id: fresh per process after unpickling, shared across all
# instances of the deployment class in one replica.
_registry: dict = {}
_registry_lock = threading.Lock()


def _live_batcher(wrapper, fn, max_batch_size, batch_wait_timeout_s):
    key = id(wrapper)
    b = _registry.get(key)
    if b is None:
        with _registry_lock:
            b = _registry.setdefault(
                key, _Batcher(fn, max_batch_size, batch_wait_timeout_s))
    return b


def batch_sizes_of(wrapper) -> List[int]:
    """Observed batch sizes of a @batch-wrapped function IN THIS PROCESS
    (call from inside the replica, e.g. via a stats method)."""
    b = _registry.get(id(wrapper))
    return list(b.batch_sizes) if b else []
