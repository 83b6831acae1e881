"""Per-process worker state — the ``CoreWorker`` equivalent.

Reference analogue: `src/ray/core_worker/core_worker.h:284` +
`python/ray/_private/worker.py`.  One ``Worker`` per process:

  * DRIVER mode — owns the ``Raylet`` (in-process event thread), talks to it
    with direct closures; owns the session (store file, worker pool).
  * WORKER mode — subprocess connected to the raylet socket; executes tasks.
  * LOCAL mode — ``init(local_mode=True)``: tasks execute inline in the
    driver (reference: ``ray.init(local_mode=True)``), for debugging.

Result plane: values ≤ ``config.inline_object_max_bytes`` travel inline over
the control socket (reference inlines ≤100KB returns, `core_worker.h:988`);
larger values go through the shm object store with zero-copy reads.
"""

from __future__ import annotations

import hashlib
import os
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._vendor import cloudpickle

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import config
from ray_tpu_torch.util.locks import make_lock, make_rlock
from ray_tpu_torch.core.exceptions import GetTimeoutError, TaskError
from ray_tpu_torch.core.ids import FunctionID, ObjectID, WorkerID, put_counter
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.object_store import (
    InProcObjectStore,
    ShmObjectStore,
    create_store_file,
)
from ray_tpu_torch.core.raylet import Raylet
from ray_tpu_torch.core.task_spec import TaskSpec

DRIVER = "driver"
WORKER = "worker"
LOCAL = "local"

_global_worker: Optional["Worker"] = None
_init_lock = make_lock("worker.init")

# ---------------------------------------------------------------------------
# Process-local reference counting (reference: ReferenceCounter,
# `src/ray/core_worker/reference_count.h:61`).  ObjectRef __init__/__del__
# call these; when this process's count for an object reaches zero the
# worker tells its raylet, which frees the object once nobody holds it.

_ref_counts: Dict["ObjectID", int] = {}  # guard: _ref_lock
# RLock: a GC pass triggered by an allocation INSIDE these functions can
# finalize an ObjectRef on the same thread, re-entering note_ref_dropped.
_ref_lock = make_rlock("worker.refcount")
_pending_events: List[tuple] = []  # guard: _ref_lock
# Batch threshold: freeing is latency-tolerant (a 0.5s raylet timer drains
# stragglers), so a bigger batch just means fewer raylet hops — at 8 a 10k
# fan-out cost ~2.5k event-loop posts; 64 cuts that 8x.
_REF_EVENT_BATCH = 64


def note_ref_created(oid):
    flush = None
    with _ref_lock:
        n = _ref_counts.get(oid, 0)
        _ref_counts[oid] = n + 1
        if n == 0:
            _pending_events.append(("h", oid))
            if len(_pending_events) >= _REF_EVENT_BATCH:
                flush = list(_pending_events)
                _pending_events.clear()
    if flush is not None:
        _flush_events(flush)


def note_ref_dropped(oid):
    flush = None
    with _ref_lock:
        n = _ref_counts.get(oid, 0) - 1
        if n > 0:
            _ref_counts[oid] = n
            return
        _ref_counts.pop(oid, None)
        _pending_events.append(("r", oid))
        if len(_pending_events) >= _REF_EVENT_BATCH:
            flush = list(_pending_events)
            _pending_events.clear()
    if flush is not None:
        _flush_events(flush)


def note_refs_created(oids):
    """Bulk pin: one lock round for a whole arg list (the direct burst
    path pins every inner ref of a submit under a single acquisition
    instead of one per oid)."""
    flush = None
    with _ref_lock:
        for oid in oids:
            n = _ref_counts.get(oid, 0)
            _ref_counts[oid] = n + 1
            if n == 0:
                _pending_events.append(("h", oid))
        if len(_pending_events) >= _REF_EVENT_BATCH:
            flush = list(_pending_events)
            _pending_events.clear()
    if flush is not None:
        _flush_events(flush)


def note_refs_dropped(oids):
    """Bulk release — the counterpart of :func:`note_refs_created`."""
    flush = None
    with _ref_lock:
        for oid in oids:
            n = _ref_counts.get(oid, 0) - 1
            if n > 0:
                _ref_counts[oid] = n
                continue
            _ref_counts.pop(oid, None)
            _pending_events.append(("r", oid))
        if len(_pending_events) >= _REF_EVENT_BATCH:
            flush = list(_pending_events)
            _pending_events.clear()
    if flush is not None:
        _flush_events(flush)


def flush_pending_releases():
    with _ref_lock:
        flush = list(_pending_events)
        _pending_events.clear()
    if flush:
        _flush_events(flush)


def _flush_events(events):
    w = _global_worker
    if w is None:
        return
    try:
        w.send_ref_events(events)
    except Exception:  # noqa: BLE001 shutdown races
        pass


def global_worker() -> "Worker":
    if _global_worker is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return _global_worker


def is_initialized() -> bool:
    return _global_worker is not None


class Worker:
    def __init__(self, mode: str):
        self.mode = mode
        self.worker_id = WorkerID.from_random()
        self.store = None
        self.raylet: Optional[Raylet] = None
        self.session_dir: Optional[str] = None
        self._pushed_functions: set = set()
        # id(fn) -> (fn, fid, blob); bounded LRU — a driver minting fresh
        # closures in a loop must not pin them (and their captured data)
        # forever.
        from collections import OrderedDict as _OD

        self._fn_memo: "Dict[int, tuple]" = _OD()
        self._fn_cache: Dict[bytes, Any] = {}
        self.actor_instance = None  # worker mode: the hosted actor
        self.current_actor_id = None
        self.namespace = ""
        # Direct worker→worker transport (core/direct.py): caller-side
        # channel manager, wired by DriverWorker / worker_main / client —
        # None when direct calls are disabled (or in local mode).
        self._direct = None

    # ------------------------------------------------------------ serialization

    def _serialize_value(self, value) -> serialization.SerializedObject:
        return serialization.serialize(value)

    def _prepare_args(self, args: Sequence, kwargs: Dict):
        """Top-level ObjectRef args become dependencies; plain values are
        serialized inline, or promoted to the store when large (reference:
        LocalDependencyResolver inlines small args,
        `transport/dependency_resolver.cc`).  Returns (args, kwargs,
        inner_refs) — inner_refs are ObjectIDs of refs serialized INSIDE
        inline values; the spec pins them until the task completes."""
        inner: list = []
        out_args = []
        for a in args:
            out_args.append(self._prepare_arg(a, inner))
        out_kwargs = [(k, self._prepare_arg(v, inner))
                      for k, v in kwargs.items()]
        return out_args, out_kwargs, inner

    def _prepare_arg(self, value, inner: list):
        if isinstance(value, ObjectRef):
            return ("ref", value.id())
        ser, refs = serialization.serialize_with_refs(value)
        blob = ser.to_bytes()
        if len(blob) > config.inline_object_max_bytes:
            ref = self.put(value)  # put() re-collects and pins via contains
            return ("ref", ref.id())
        inner.extend(refs)
        return ("v", blob)

    def register_function(self, callable_obj) -> Tuple[FunctionID, Optional[bytes]]:
        """Returns (function_id, inline_blob_or_None); large callables are
        pushed to the GCS function table once (reference function_manager).

        Per-object memo: re-pickling the same function on EVERY .remote()
        was ~13% of async submission cost (profiled); identity-keyed, with
        a mutation fingerprint holding STRONG REFS to the attribute dict's
        values, __defaults__ and __code__ and comparing by identity — so
        rebinding a function attribute or its defaults re-pickles instead
        of silently shipping the old state (and the kept refs make the
        `is` checks immune to id reuse).  In-place mutation of a captured
        object's internals remains export-once, matching the reference's
        function manager semantics."""
        memo = self._fn_memo.get(id(callable_obj))
        if memo is not None and memo[0] is callable_obj:
            # memo-hit fast path: fingerprint against the LIVE attribute
            # dict without snapshotting it — the copy below only happens
            # on miss/re-pickle (the hit path runs once per .remote()
            # and the per-call dict copy was ~5% of burst submit cost)
            sd, sdef, scode = memo[3]
            cur = getattr(callable_obj, "__dict__", None) or {}
            if (getattr(callable_obj, "__defaults__", None) is sdef
                    and getattr(callable_obj, "__code__", None) is scode
                    and cur.keys() == sd.keys()
                    and all(sd[k] is cur[k] for k in sd)):
                self._fn_memo.move_to_end(id(callable_obj))
                return memo[1], memo[2]
        fp = (dict(getattr(callable_obj, "__dict__", None) or {}),
              getattr(callable_obj, "__defaults__", None),
              getattr(callable_obj, "__code__", None))
        blob = cloudpickle.dumps(callable_obj)
        fid = FunctionID(hashlib.sha1(blob).digest()[:16])
        if len(blob) <= config.inline_object_max_bytes:
            out = (fid, blob)
        else:
            if fid not in self._pushed_functions:
                self._push_function(fid, blob)
                self._pushed_functions.add(fid)
            out = (fid, None)
        # keep a strong ref to the callable so id() stays unambiguous
        self._fn_memo[id(callable_obj)] = (callable_obj, out[0], out[1], fp)
        while len(self._fn_memo) > 256:
            self._fn_memo.popitem(last=False)
        return out

    def _push_function(self, fid: FunctionID, blob: bytes):
        if self.mode == DRIVER:
            self.raylet.gcs.put_function(fid.binary(), blob)
        else:
            self._request("put_function", id=fid.binary(), blob=blob)

    # ------------------------------------------------------------ core ops

    def submit_spec(self, spec: TaskSpec) -> List[ObjectRef]:
        self._stamp_lineage(spec)
        refs = [ObjectRef(oid) for oid in spec.return_ids()]
        d = self._direct
        if d is not None and d.try_submit(spec):
            return refs  # rode the direct channel (or its fallback)
        self._submit_relayed(spec)
        return refs

    def _stamp_lineage(self, spec: TaskSpec):
        """Deadline propagation + cancel fan-out edges: a spec submitted
        FROM a running task inherits the tightest enclosing deadline and
        records its parent task id, so deadline expiry / recursive cancel
        reach nested work wherever it was spawned.  Actor CREATION never
        inherits a deadline — the actor outlives the request that made it
        (the raylet's admission path exempts creations for the same
        reason; inheriting here would have the worker kill a creation the
        raylet deliberately admitted)."""
        from ray_tpu_torch.core.task_spec import ACTOR_CREATION_TASK
        from ray_tpu_torch.runtime_context import _current_deadline, _current_task_id

        parent = _current_task_id.get()
        if parent is not None and spec.parent_task_id is None:
            spec.parent_task_id = parent
        if not config.deadlines or spec.kind == ACTOR_CREATION_TASK:
            return
        ambient = _current_deadline.get()
        if ambient is not None and (spec.deadline is None
                                    or ambient < spec.deadline):
            spec.deadline = ambient

    def _submit_relayed(self, spec: TaskSpec):
        """The raylet-mediated submit path — also the direct transport's
        fallback/reconcile target (must not re-enter try_submit)."""
        if self.mode == DRIVER:
            self.raylet.call_async(self.raylet.submit_task, spec)
        else:
            self._send({"t": "submit", "spec": spec})

    def send_ref_events(self, events: List[tuple]):
        """Ordered hold/release transitions for this process's ObjectRefs."""
        if self.mode == DRIVER:
            self.raylet.call_async(self.raylet.apply_ref_events, events)
        elif self.mode == LOCAL:
            for kind, oid in events:
                if kind == "r":
                    self._objects.pop(oid, None)
        else:
            try:
                self._send({"t": "ref_events", "events": events})
            except Exception:  # noqa: BLE001 socket teardown
                pass

    def put(self, value, _replicate: bool = False) -> ObjectRef:
        """``_replicate=True``: eagerly push a secondary copy to another
        node regardless of the RAY_TPU_REPLICATION_MIN_BYTES threshold
        (flagged puts route through the store even when small — an inline
        value lives only in its raylet's memory and cannot be served to a
        replica holder)."""
        flush_pending_releases()  # free before allocating under pressure
        oid = put_counter.next_object_id()
        ser, inner = serialization.serialize_with_refs(value)
        size = ser.total_bytes()
        inline = (size <= config.inline_object_max_bytes
                  and not (_replicate and self.store is not None))
        if inline or self.store is None:
            blob = ser.to_bytes()
            if self.mode == DRIVER:
                self.raylet.call_async(self.raylet._object_inline, oid, blob,
                                       inner)
            else:
                self._request("put_inline", id=oid.hex(), blob=blob,
                              contains=inner)
        else:
            self.store.put_serialized(oid, ser)
            if self.mode == DRIVER:
                def _mark(o=oid, n=size, inner=inner, rep=_replicate):
                    self.raylet._obj(o).size = n
                    self.raylet._object_in_store(o, contains=inner)
                    self.raylet._maybe_replicate(o, force=rep)
                self.raylet.call_async(_mark)
            else:
                self._request("register_stored", id=oid.hex(), size=size,
                              contains=inner, replicate=_replicate)
        return ObjectRef(oid)

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float] = None):
        from ray_tpu_torch.util import tracing as _tracing

        ids = [r.id() for r in refs]
        if _tracing.tracing_enabled():
            # caller-wakeup hop: the get() that consumes a traced submit's
            # result closes the request loop (ctx recorded at submit time,
            # consumed on first lookup)
            ctx = _tracing.lookup_get_ctx(ids)
            if ctx is not None:
                # a raised error marks the span ERROR in span.__exit__
                with _tracing.span("task.get", parent=ctx, n=len(ids)):
                    return self._get_inner(ids, timeout)
        return self._get_inner(ids, timeout)

    def _get_inner(self, ids, timeout: Optional[float] = None):
        fast: Dict[ObjectID, tuple] = {}
        d = self._direct
        deadline = None
        if d is not None:
            # Direct-call results resolve here first: in-flight calls are
            # waited on locally (the callee pushes straight back — no
            # raylet round trip), cached inline results decode in place,
            # and store-sized results fall through to the shm fast path.
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            for oid in ids:
                if oid in fast:
                    continue
                r = d.resolve(oid, deadline)
                if r is None:
                    continue
                if r[0] == "inline":
                    fast[oid] = (serialization.loads(r[1]),)
                elif r[0] == "error":
                    raise r[1]
                # ("store",): read via the store/raylet paths below
            if timeout is not None:
                timeout = max(0.0, deadline - time.monotonic())
        if self.mode in (DRIVER, WORKER) and self.store is not None:
            # Fast path: an object already SEALED in the local store needs
            # no raylet round trip (sealed implies the producing task
            # completed, and the caller's ref pins it against free) — read
            # it straight off the shm arena.  For the driver this skips two
            # thread hops + a wake syscall per get; for workers a full
            # socket round trip.  Misses (inline results, pending or
            # errored tasks, evicted/spilled objects) take the slow path,
            # which also owns reconstruction.
            miss: List[ObjectID] = []
            for oid in ids:
                if oid in fast:
                    continue
                if self.store.contains(oid):
                    try:
                        fast[oid] = (self.read_store_object(
                            oid,
                            timeout=60.0 if timeout is None else timeout),)
                        continue
                    except Exception:  # noqa: BLE001 evicted/raced: slow path
                        pass
                miss.append(oid)
            if not miss:
                if d is not None:
                    d.note_observed(ids)
                return [fast[oid][0] for oid in ids]
            return self._get_via_raylet(ids, miss, fast, timeout)
        return self._get_via_raylet(ids, [o for o in ids if o not in fast],
                                    fast, timeout)

    def _get_via_raylet(self, ids, fetch_ids, fast, timeout):
        """Resolve ``fetch_ids`` through the raylet, then assemble results
        for ``ids`` in order (``fast`` holds store-read values keyed by
        ObjectID, each wrapped in a 1-tuple)."""
        if self.mode == DRIVER:
            from ray_tpu_torch.core.raylet import SimpleFuture

            fut = SimpleFuture()
            cancel_fut = self.raylet.call(self.raylet.async_get, fetch_ids,
                                          fut.set)
            try:
                results = fut.result(timeout)
            except TimeoutError:
                # Deregister the waiters we left behind in the raylet.
                def _cancel():
                    try:
                        cancel = cancel_fut.result(0)
                    except Exception:  # noqa: BLE001
                        return
                    if cancel is not None:
                        cancel()
                self.raylet.call_async(_cancel)
                raise GetTimeoutError(
                    f"get() timed out after {timeout}s"
                ) from None
        else:
            try:
                results = self._request(
                    "get", ids=[i.hex() for i in fetch_ids],
                    _wait_timeout=timeout
                )
            except TimeoutError:
                raise GetTimeoutError(
                    f"get() timed out after {timeout}s"
                ) from None
        if self._direct is not None:
            # every fetched id is now resolved — the delivery watermark
            # the direct transport's order-safe engagement waits on
            # (errored results don't count: a raylet-side failure proves
            # nothing about delivery of the calls before it)
            self._direct.note_observed(
                ids, errored={h for h, r in results.items()
                              if r[0] == "error"})
        out = []
        for oid in ids:
            hit = fast.get(oid)
            if hit is not None:
                out.append(hit[0])
                continue
            kind, *rest = results[oid.hex()]
            if kind == "error":
                raise rest[0]
            if kind == "inline":
                out.append(serialization.loads(rest[0]))
            else:  # store
                out.append(self.read_store_object(
                    oid, timeout=60.0 if timeout is None else timeout))
        return out

    def read_store_object(self, oid, attempts: int = 3,
                          timeout: Optional[float] = 60.0):
        """Store read with transparent lineage recovery: an LRU-evicted
        object is reconstructed by re-running its creating task
        (reference: `object_recovery_manager.h:41`).  ``timeout`` bounds
        each reseal wait (the re-executed task could hang)."""
        from ray_tpu_torch.core.exceptions import GetTimeoutError, ObjectLostError

        for attempt in range(attempts):
            try:
                return self.store.get(oid)
            except ObjectLostError:
                if attempt == attempts - 1 or not self.reconstruct(oid):
                    raise
                # block until resealed (or inline/error this time around)
                try:
                    result = self._blocking_get_status([oid],
                                                       timeout)[oid.hex()]
                except TimeoutError:
                    raise GetTimeoutError(
                        f"reconstruction of {oid.hex()} timed out after "
                        f"{timeout}s") from None
                if result[0] == "inline":
                    return serialization.loads(result[1])
                if result[0] == "error":
                    raise result[1]

    def _blocking_get_status(self, oids, timeout: Optional[float] = None):
        if self.mode == DRIVER:
            from ray_tpu_torch.core.raylet import SimpleFuture

            fut = SimpleFuture()
            self.raylet.call(self.raylet.async_get, oids, fut.set)
            return fut.result(timeout)
        return self._request("get", ids=[o.hex() for o in oids],
                             _wait_timeout=timeout)

    def reconstruct(self, oid) -> bool:
        if self.mode == DRIVER:
            return bool(self.raylet.call(
                self.raylet.reconstruct_object, oid).result())
        if self.mode == LOCAL:
            return False
        return bool(self._request("reconstruct", id=oid.hex()))

    def wait(self, refs: Sequence[ObjectRef], num_returns=1,
             timeout: Optional[float] = None):
        ids = [r.id() for r in refs]
        if self.mode == DRIVER:
            from ray_tpu_torch.core.raylet import SimpleFuture

            fut = SimpleFuture()
            self.raylet.call_async(
                self.raylet.async_wait, ids, num_returns, timeout, fut.set
            )
            rep = fut.result()
        else:
            rep = self._request(
                "wait", ids=[i.hex() for i in ids],
                num_returns=num_returns, timeout=timeout,
            )
        ready_set = set(rep["ready"])
        ready = [r for r in refs if r.hex() in ready_set]
        not_ready = [r for r in refs if r.hex() not in ready_set]
        if self._direct is not None and ready:
            # errored refs count as ready but must NOT clear the direct
            # engagement watermark (see async_wait's reply_value)
            self._direct.note_observed(
                [r.id() for r in ready],
                errored=set(rep.get("errored") or ()))
        return ready, not_ready

    def free(self, refs: Sequence[ObjectRef]):
        hexes = [r.hex() for r in refs]
        if self.mode == DRIVER:
            def _free():
                for h in hexes:
                    self.raylet.drop_object(ObjectID.from_hex(h))
            self.raylet.call_async(_free)
        else:
            self._request("free", ids=hexes)
        if self.store is not None:
            for r in refs:
                try:
                    self.store.delete(r.id())
                except Exception:  # noqa: BLE001
                    pass

    # KV (GCS KV — backs runtime envs, Train/Tune metadata, Serve).  The
    # driver holds the GCS handle directly (embedded GcsCore or GcsClient);
    # workers go through their raylet which proxies to the GCS.
    def kv_put(self, key: bytes, value: bytes, namespace: str = ""):
        if self.mode == DRIVER:
            self.raylet.gcs.kv_put(namespace, key, value)
        else:
            self._request("kv_put", ns=namespace, key=key, val=value)

    def kv_get(self, key: bytes, namespace: str = "") -> Optional[bytes]:
        if self.mode == DRIVER:
            return self.raylet.gcs.kv_get(namespace, key)
        return self._request("kv_get", ns=namespace, key=key)

    def kv_del(self, key: bytes, namespace: str = ""):
        if self.mode == DRIVER:
            return self.raylet.gcs.kv_del(namespace, key)
        return self._request("kv_del", ns=namespace, key=key)

    def kv_keys(self, prefix: bytes, namespace: str = "") -> List[bytes]:
        if self.mode == DRIVER:
            return self.raylet.gcs.kv_keys(namespace, prefix)
        return self._request("kv_keys", ns=namespace, prefix=prefix)

    def stream_next(self, task_id, index: int,
                    timeout: Optional[float] = None) -> dict:
        """Block until item ``index`` of a streaming task exists (or the
        stream ended/errored).  Returns {"kind": "item"|"end"|"error",...}."""
        if self.mode == DRIVER:
            from ray_tpu_torch.core.raylet import SimpleFuture

            fut = SimpleFuture()
            cancel_fut = self.raylet.call(
                self.raylet.async_stream_next, task_id, index, fut.set)
            try:
                return fut.result(timeout)
            except TimeoutError:
                def _cancel():
                    try:
                        cancel = cancel_fut.result(0)
                    except Exception:  # noqa: BLE001
                        return
                    if cancel is not None:
                        cancel()
                self.raylet.call_async(_cancel)
                raise
        return self._request("stream_next", task_id=task_id, index=index,
                             _wait_timeout=timeout)

    def cancel(self, ref, force: bool = False, recursive: bool = True) -> bool:
        if self.mode == LOCAL:
            return False
        hit = False
        if self._direct is not None:
            # the call may be in flight on a direct channel the raylet
            # never saw dispatch: the cancel frame must reach the dialed
            # callee's in-flight registry, not just the raylet queues
            hit = self._direct.cancel(ref.id())
        if self.mode == DRIVER:
            return bool(self.raylet.call(
                self.raylet.cancel_task, ref.id(), force,
                recursive).result()) or hit
        return bool(self._request("cancel_task", id=ref.hex(), force=force,
                                  recursive=recursive)) or hit

    def gcs_nodes(self) -> List[dict]:
        if self.mode == DRIVER:
            return self.raylet.gcs.nodes()
        if self.mode == LOCAL:
            return []
        return self._request("nodes")

    # ------------------------------------------------------------ worker mode

    def _send(self, msg):
        raise NotImplementedError

    def _request(self, op, **fields):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Driver bring-up / teardown


def _gc_stale_stores(shm_dir: str):
    """Remove store files whose owning driver (pid in the name) is gone —
    crash-safety for the file-backed shm arena."""
    try:
        for name in os.listdir(shm_dir):
            if not name.startswith("rtt_store_"):
                continue
            parts = name.split("_")
            try:
                pid = int(parts[2])
            except (IndexError, ValueError):
                continue
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                try:
                    os.unlink(os.path.join(shm_dir, name))
                except OSError:
                    pass
                import shutil

                shutil.rmtree(os.path.join(shm_dir, name + ".spill"),
                              ignore_errors=True)
            except PermissionError:
                pass
    except OSError:
        pass


class DriverWorker(Worker):
    def __init__(self, num_cpus=None, num_tpus=None, resources=None,
                 object_store_memory=None, namespace: str = ""):
        super().__init__(DRIVER)
        self.namespace = namespace or ""
        ts = time.strftime("%Y%m%d-%H%M%S")
        self.session_dir = os.path.join(
            config.temp_dir, f"session_{ts}_{os.getpid()}_{uuid.uuid4().hex[:6]}"
        )
        os.makedirs(self.session_dir, exist_ok=True)

        total = {"CPU": float(num_cpus if num_cpus is not None else os.cpu_count())}
        if num_tpus is None:
            num_tpus = config.num_chips
            if num_tpus == 0 and "torch" in __import__("sys").modules:
                try:
                    import torch

                    num_tpus = torch.cuda.device_count()
                except Exception:  # noqa: BLE001
                    num_tpus = 0
        if num_tpus:
            total["TPU"] = float(num_tpus)
        total.update(resources or {})

        store_mb = (object_store_memory or config.object_store_memory_mb * (1 << 20)) // (1 << 20)
        store_path = None
        if not config.object_store_fallback_inproc:
            shm_dir = "/dev/shm" if os.path.isdir("/dev/shm") else self.session_dir
            _gc_stale_stores(shm_dir)
            store_path = os.path.join(
                shm_dir, f"rtt_store_{os.getpid()}_{uuid.uuid4().hex[:6]}"
            )
            create_store_file(store_path, int(store_mb) << 20)
            self.store = ShmObjectStore(store_path)
        else:
            self.store = InProcObjectStore()

        self.store_path = store_path
        self.raylet = Raylet(
            self.session_dir, total, store_path,
            worker_env={"RAY_TPU_SESSION_DIR": self.session_dir},
        )
        if config.prestart_workers:
            n = min(int(total["CPU"]), 4)
            for _ in range(n):
                self.raylet.call_async(self.raylet._spawn_worker, "cpu")

        # Periodic ref-event flush: the batching threshold (8) can leave a
        # tail of release events unsent forever on an idle driver, pinning
        # their objects; a 0.5s raylet timer drains them.
        def _ref_flush_tick():
            flush_pending_releases()
            self.raylet.add_timer(0.5, _ref_flush_tick)

        self.raylet.call_async(
            lambda: self.raylet.add_timer(0.5, _ref_flush_tick))
        # Direct worker→worker transport (caller side): actor calls and
        # lease-reused tasks dial the callee worker directly after the
        # raylet brokers the address; raylet path kept for first-call,
        # recovery, and fenced peers.
        if config.direct_calls:
            from ray_tpu_torch.core.direct import DirectCallClient

            raylet = self.raylet
            self._direct = DirectCallClient(
                self,
                broker=lambda aid: raylet.call(
                    raylet.direct_call_info, aid).result(2.0),
                resubmit=self._submit_relayed,
                lease=lambda spec: raylet.call(
                    raylet.acquire_direct_lease, spec).result(2.0),
                lease_release=lambda lid: raylet.call_async(
                    raylet.release_direct_lease, lid),
            )
            # actor-death / node-SUSPECT fences reach this in-process
            # caller by direct callback (workers get control frames)
            raylet.direct_fence_cb = self._direct.on_fence
        # Clean up the shm store even if the user forgets shutdown() or the
        # driver exits on an exception.
        import atexit

        atexit.register(self._atexit_cleanup)

    def _atexit_cleanup(self):
        try:
            self.shutdown()
        except Exception:  # noqa: BLE001
            pass

    def shutdown(self):
        if self._direct is not None:
            self._direct.close()  # releases leases before the pool dies
            self._direct = None
        self.raylet.shutdown()
        try:
            self.store.close()
        except Exception:  # noqa: BLE001
            pass
        if self.store_path and os.path.exists(self.store_path):
            try:
                os.unlink(self.store_path)
            except OSError:
                pass
        if self.store_path:
            import shutil

            shutil.rmtree(self.store_path + ".spill", ignore_errors=True)


# ---------------------------------------------------------------------------
# Local mode: inline execution (ray.init(local_mode=True) equivalent)


class LocalWorker(Worker):
    def __init__(self):
        super().__init__(LOCAL)
        self._objects: Dict[ObjectID, Tuple[str, Any]] = {}
        self._actors: Dict[Any, Any] = {}
        self._local_streams: Dict[Any, int] = {}
        self.store = InProcObjectStore()

    def stream_next(self, task_id, index, timeout=None):
        total = self._local_streams.get(task_id)
        if total is None:
            return {"kind": "error",
                    "error": ValueError(f"unknown stream {task_id.hex()}")}
        return {"kind": "item"} if index < total else {"kind": "end"}

    def submit_spec(self, spec: TaskSpec) -> List[ObjectRef]:
        from ray_tpu_torch.core.task_spec import (
            ACTOR_CREATION_TASK,
            ACTOR_TASK,
            STREAMING_RETURNS,
        )

        fn = (cloudpickle.loads(spec.function_blob)
              if spec.function_blob is not None else None)
        args, kwargs = self._resolve_args(spec)
        refs = [ObjectRef(oid) for oid in spec.return_ids()]
        try:
            if spec.kind == ACTOR_CREATION_TASK:
                inst = fn(*args, **kwargs)
                self._actors[spec.actor_id] = inst
                result = None
            elif spec.kind == ACTOR_TASK:
                inst = self._actors[spec.actor_id]
                result = getattr(inst, spec.method_name)(*args, **kwargs)
            else:
                result = fn(*args, **kwargs)
            if spec.num_returns == STREAMING_RETURNS:
                items = list(result)  # local mode: drain eagerly
                for i, v in enumerate(items):
                    self._objects[spec.stream_item_id(i)] = ("v", v)
                self._local_streams[spec.task_id] = len(items)
                self._objects[refs[0].id()] = ("v", len(items))
            elif spec.num_returns == 1:
                self._objects[refs[0].id()] = ("v", result)
            else:
                for r, v in zip(refs, result):
                    self._objects[r.id()] = ("v", v)
        except Exception as e:  # noqa: BLE001
            import traceback

            err = TaskError(spec.name, traceback.format_exc(), e)
            for r in refs:
                self._objects[r.id()] = ("e", err)
        return refs

    def _resolve_args(self, spec):
        def resolve(entry):
            kind, payload = entry
            if kind == "ref":
                tag, v = self._objects[payload]
                if tag == "e":
                    raise v
                return v
            return serialization.loads(payload)

        args = [resolve(a) for a in spec.args]
        kwargs = {k: resolve(v) for k, v in spec.kwargs}
        return args, kwargs

    def put(self, value, _replicate: bool = False) -> ObjectRef:
        oid = put_counter.next_object_id()
        self._objects[oid] = ("v", value)
        return ObjectRef(oid)

    def get(self, refs, timeout=None):
        out = []
        for r in refs:
            tag, v = self._objects[r.id()]
            if tag == "e":
                raise v
            out.append(v)
        return out

    def wait(self, refs, num_returns=1, timeout=None):
        return list(refs[:num_returns]), list(refs[num_returns:])

    def free(self, refs):
        for r in refs:
            self._objects.pop(r.id(), None)

    def kv_put(self, key, value, namespace=""):
        self._objects[("kv", namespace, key)] = ("v", value)

    def kv_get(self, key, namespace=""):
        entry = self._objects.get(("kv", namespace, key))
        return entry[1] if entry else None

    def kv_del(self, key, namespace=""):
        return self._objects.pop(("kv", namespace, key), None) is not None

    def kv_keys(self, prefix, namespace=""):
        return [k[2] for k in self._objects
                if isinstance(k, tuple) and k[0] == "kv" and k[1] == namespace
                and k[2].startswith(prefix)]

    def shutdown(self):
        self._objects.clear()
        self._actors.clear()


# ---------------------------------------------------------------------------


def init_worker(worker: Worker):
    global _global_worker
    with _init_lock:
        _global_worker = worker


def clear_worker():
    global _global_worker
    with _init_lock:
        _global_worker = None
