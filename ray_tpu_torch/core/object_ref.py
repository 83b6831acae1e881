"""ObjectRef — the distributed future handle.

Reference analogue: ``ray.ObjectRef`` (Cython, `python/ray/includes/object_ref.pxi`).
Holds only the ObjectID; resolution goes through the per-process worker
(`ray_tpu_torch.core.worker`).  Refs are picklable and can be passed as task args
(dependency) or stored inside other objects (borrowing — round 1 keeps the
owner as the driver, so serializing a ref is just shipping its ID).
"""

from __future__ import annotations

import threading

from ray_tpu_torch.core.ids import ObjectID

# Serialization-time ref collection (the borrow-pinning protocol's first
# half): while a collector is installed on this thread, every ObjectRef
# pickled records its id.  The serializer returns those ids alongside the
# bytes, and whatever entity comes to OWN the bytes (an object entry, a
# task spec) pins the inner objects until it is itself released — so a ref
# travelling inside a serialized value can never be freed out from under
# the eventual deserializer (reference: borrowed-ref tracking,
# `src/ray/core_worker/reference_count.h:233`).
_collect = threading.local()


class collect_serialized_refs:
    """Context manager installing a per-thread inner-ref collector."""

    def __init__(self):
        self.ids = []

    def __enter__(self):
        self._prev = getattr(_collect, "sink", None)
        _collect.sink = self.ids
        return self

    def __exit__(self, *exc):
        _collect.sink = self._prev
        return False


class ObjectRef:
    """Reference-counted handle: every live ObjectRef in a process counts
    one local reference; when a process's count for an object drops to
    zero it notifies the raylet, which frees the object once NO process
    holds it and no queued task depends on it (reference: distributed ref
    counting, `src/ray/core_worker/reference_count.h:61` — minus the full
    borrowing protocol: refs stashed inside long-lived actor state on
    OTHER nodes must be kept alive by the creator or `ray_tpu_torch.put`)."""

    __slots__ = ("_id", "__weakref__")

    def __init__(self, object_id: ObjectID):
        self._id = object_id
        from ray_tpu_torch.core import worker as _w

        _w.note_ref_created(object_id)

    def __del__(self):
        try:
            from ray_tpu_torch.core import worker as _w

            _w.note_ref_dropped(self._id)
        except Exception:  # noqa: BLE001 interpreter teardown
            pass

    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def task_id(self):
        return self._id.task_id()

    def future(self):
        """Return a concurrent.futures.Future resolving to the value."""
        import concurrent.futures

        from ray_tpu_torch.core import worker as _w

        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _resolve():
            try:
                fut.set_result(_w.global_worker().get([self])[0])
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        import threading

        threading.Thread(target=_resolve, name="objref-resolve",
                         daemon=True).start()
        return fut

    def __await__(self):
        import asyncio

        return asyncio.wrap_future(self.future()).__await__()

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __reduce__(self):
        sink = getattr(_collect, "sink", None)
        if sink is not None:
            sink.append(self._id)
        return (ObjectRef, (self._id,))


class ObjectRefGenerator:
    """Iterator over a streaming task's yields (reference:
    ``ObjectRefGenerator``, `python/ray/_raylet.pyx:209`): each ``next()``
    blocks until the producer has yielded item *i* (it can be consumed
    while the task is still running), then returns the item's ObjectRef.
    """

    def __init__(self, task_id):
        self._task_id = task_id
        self._index = 0
        self._done = False

    @property
    def task_id(self):
        return self._task_id

    def completed(self) -> "ObjectRef":
        """Ref that resolves (to the item count) when the stream finishes."""
        from ray_tpu_torch.core.ids import ObjectID

        return ObjectRef(ObjectID.for_task_return(self._task_id, 0))

    def __iter__(self):
        return self

    def __next__(self) -> "ObjectRef":
        if self._done:
            raise StopIteration
        from ray_tpu_torch.core import worker as _w
        from ray_tpu_torch.core.ids import ObjectID

        res = _w.global_worker().stream_next(self._task_id, self._index)
        kind = res["kind"]
        if kind == "end":
            self._done = True
            raise StopIteration
        if kind == "error":
            self._done = True
            raise res["error"]
        ref = ObjectRef(
            ObjectID.for_task_return(self._task_id, self._index + 1))
        self._index += 1
        return ref

    def __repr__(self):
        return f"ObjectRefGenerator({self._task_id.hex()}@{self._index})"
