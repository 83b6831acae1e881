"""Worker subprocess entrypoint — the ``default_worker.py`` equivalent.

Reference analogue: `python/ray/_private/workers/default_worker.py` +
``CoreWorker.run_task_loop`` (`python/ray/_raylet.pyx:2702`).

Threading model: a reader thread drains the raylet socket (demuxing task
dispatches from request replies) so that a task blocked in ``get()`` can
still receive its reply; the main thread is the single task executor.
"""

from __future__ import annotations

import argparse
import asyncio
import inspect
import os
import queue
import socket
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

from ray_tpu_torch._vendor import cloudpickle

from ray_tpu_torch.core import protocol, serialization
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.exceptions import (
    BackPressureError,
    DeadlineExceededError,
    TaskCancelledError,
    TaskError,
)
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_store import ShmObjectStore
from ray_tpu_torch.core.task_spec import (
    ACTOR_CREATION_TASK,
    ACTOR_TASK,
    STREAMING_RETURNS,
    TaskSpec,
)
from ray_tpu_torch.core.worker import WORKER, Worker, init_worker
from ray_tpu_torch.util.locks import make_lock

#: control-flow errors that must reach the caller TYPED (not wrapped in
#: TaskError) and are never retried — backpressure rejections, deadline
#: expiry, cancellation
CONTROL_ERRORS = (BackPressureError, DeadlineExceededError,
                  TaskCancelledError)

#: Hot-path module refs, resolved once on first execution.  The execute
#: path used to run half a dozen ``from x import y`` statements PER CALL
#: (~15µs of sys.modules lookups); those imports are deferred only to
#: break import cycles at module-load time, so a lazy singleton pays the
#: deferral exactly once.
_HOT = None


def _hot():
    global _HOT
    if _HOT is None:
        from ray_tpu_torch.core import runtime_env
        from ray_tpu_torch.core.worker import global_worker
        from ray_tpu_torch.runtime_context import (
            _current_deadline,
            _current_task_id,
        )
        from ray_tpu_torch.util import chaos, profiling, tracing

        _HOT = (_current_deadline, _current_task_id, chaos, profiling,
                tracing, runtime_env, global_worker)
    return _HOT


def _async_raise(thread_ident: int, exc_type) -> bool:
    """Raise ``exc_type`` asynchronously in another thread (delivered at
    its next bytecode boundary) — the CPython seam behind mid-exec
    cancellation/deadlines, same mechanism the reference uses for
    non-force task cancellation (KeyboardInterrupt into the executor)."""
    import ctypes

    res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(thread_ident), ctypes.py_object(exc_type))
    if res > 1:  # pragma: no cover — defensive: undo a multi-target hit
        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(thread_ident), None)
        return False
    return res == 1


class _CancelRegistry:
    """Per-process cancellation + deadline enforcement for executing
    tasks.  One watchdog thread (lazy) arms every deadline; cancel frames
    (raylet ``cancel`` / direct ``dcancel``) interrupt the registered
    executor thread or mark a not-yet-started task for the pre-exec
    check.  Sync executions register their thread ident; asyncio actor
    calls register with ident None (cooperative pre-exec check only — an
    async exception into the shared loop thread would kill the loop)."""

    def __init__(self):
        self._lock = make_lock("worker.cancel_registry")
        self._cancelled: dict = {}  # task_id -> exc type  # guard: _lock
        self._running: dict = {}  # task_id -> thread ident or None  # guard: _lock
        self._interrupted: set = set()  # tids already async-raised  # guard: _lock
        self._deadlines: list = []  # heap[(deadline, task_id)]  # guard: _lock
        self._wake = threading.Condition(self._lock)
        self._watchdog_started = False  # guard: _lock

    # ---- cancel frames (reader / direct-conn threads) ----

    def cancel(self, task_id, exc_type=TaskCancelledError):
        """Mark cancelled; interrupt now if the task is mid-exec.  The
        async raise happens UNDER the lock (deregister serializes behind
        it, so the exception can never land on a thread that already
        moved on to the next task) and at most ONCE per task id — the
        same cancel arriving on two paths (dcancel + raylet frame, or
        cancel racing the deadline watchdog) must not deliver a second
        exception into the except-handler that is reporting the first
        (the aborted done frame would hang the caller forever)."""
        with self._lock:
            self._cancelled[task_id] = exc_type
            while len(self._cancelled) > 4096:  # bounded: stale ids age out
                self._cancelled.pop(next(iter(self._cancelled)))
            entry = self._running.get(task_id)
            if entry is not None and task_id not in self._interrupted:
                self._interrupted.add(task_id)
                self._interrupt(entry, exc_type)

    @staticmethod
    def _interrupt(entry, exc_type):
        """Deliver the interrupt for a registry entry: thread ident ->
        async exception at the next bytecode; asyncio record ->
        task.cancel() scheduled on the loop (raises CancelledError at
        the coroutine's next await — an async exception into the shared
        loop thread would kill every interleaved call)."""
        if isinstance(entry, tuple):
            loop, atask = entry[1], entry[2]
            loop.call_soon_threadsafe(atask.cancel)
        else:
            _async_raise(entry, exc_type)

    def check(self, task_id):
        """Pre-exec seam: raise if this task was cancelled before it ran."""
        if not self._cancelled:  # unguarded-ok: GIL-atomic emptiness peek; a cancel landing this instant is the same race as it landing one call later
            return
        with self._lock:
            exc = self._cancelled.get(task_id)
        if exc is not None:
            raise exc()

    def cancelled_as(self, task_id):
        """The typed error this task was cancelled with (None if it
        wasn't) — lets the asyncio path convert a CancelledError back
        into the control error the caller dispatches on."""
        with self._lock:
            return self._cancelled.get(task_id)

    # ---- execution registration ----

    def register(self, task_id, ident, deadline):
        with self._lock:
            exc = self._cancelled.get(task_id)
            if exc is not None:
                # cancel frame landed between the pre-exec check and
                # registration: raise HERE (we are on the executor
                # thread) instead of executing uninterruptible
                raise exc()
            self._running[task_id] = ident
            if deadline is not None and ident is not None \
                    and config.deadlines:
                self._arm_deadline(task_id, deadline)

    def register_async(self, task_id, loop, atask, deadline):
        """Asyncio actor call: interruptible via task.cancel() on the
        loop (CancelledError at the next await).  Raises like register()
        when a cancel already landed."""
        with self._lock:
            exc = self._cancelled.get(task_id)
            if exc is not None:
                raise exc()
            self._running[task_id] = ("async", loop, atask)
            if deadline is not None and config.deadlines:
                self._arm_deadline(task_id, deadline)

    def _arm_deadline(self, task_id, deadline):  # requires: _lock
        import heapq

        heapq.heappush(self._deadlines, (deadline, task_id))
        if not self._watchdog_started:
            self._watchdog_started = True
            threading.Thread(target=self._watchdog_loop,
                             name="deadline-watchdog",
                             daemon=True).start()
        self._wake.notify()

    def deregister(self, task_id):
        with self._lock:
            self._running.pop(task_id, None)
            self._cancelled.pop(task_id, None)
            self._interrupted.discard(task_id)

    def _watchdog_loop(self):
        import heapq

        while True:
            with self._lock:
                now = time.time()
                while self._deadlines and self._deadlines[0][0] <= now:
                    _, task_id = heapq.heappop(self._deadlines)
                    entry = self._running.get(task_id)
                    if entry is not None \
                            and task_id not in self._interrupted:
                        self._cancelled[task_id] = DeadlineExceededError
                        self._interrupted.add(task_id)
                        self._interrupt(entry, DeadlineExceededError)
                timeout = (self._deadlines[0][0] - now
                           if self._deadlines else None)
                self._wake.wait(timeout)


class RemoteWorker(Worker):
    """Worker-process side of the control socket."""

    def __init__(self, sock: socket.socket):
        super().__init__(WORKER)
        self.sock = sock
        self.send_lock = make_lock("remote_worker.send")
        self.task_queue: "queue.Queue" = queue.Queue()
        # Actor concurrency (reference: threaded concurrency groups + asyncio
        # actors, `src/ray/core_worker/transport/concurrency_group_manager.cc`)
        self.actor_executor: Optional[ThreadPoolExecutor] = None
        self.group_executors: Optional[Dict[str, ThreadPoolExecutor]] = None
        self.actor_loop: Optional[asyncio.AbstractEventLoop] = None
        # Checkpointable actors: snapshot __ray_save__() every
        # checkpoint_interval completed calls (sync actors only — set by
        # the creation task).  All three fields touched only on the main
        # executor thread.
        self.checkpoint_interval = 0
        self.checkpoint_calls = 0  # completed calls since last snapshot
        self.checkpoint_seq = 0
        # Direct transport: callee-side listener (started in main once the
        # store is attached) and the restart generation the hosting raylet
        # stamped into the creation spec — direct hellos must match it.
        self.direct_server = None
        self.actor_generation = 0
        # lease token the raylet granted on this worker (direct_lease
        # control message); lease hellos must present exactly this id
        self.active_lease_id = None
        # Serializes task execution between the main loop and a direct
        # conn thread executing inline (plain sync actors / leased pool
        # workers) — single-threaded execution semantics hold either way.
        self.exec_lock = make_lock("worker.exec")
        # Cancellation + deadline enforcement for tasks executing here
        # (cancel frames from the raylet, dcancel from direct callers,
        # and the deadline watchdog all funnel through it).
        self.cancel_registry = _CancelRegistry()
        self._rid = 0  # guard: _rid_lock
        self._rid_lock = make_lock("remote_worker.rid")
        self._pending: Dict[int, dict] = {}
        # Done-message coalescing for batched dispatch: while more tasks
        # wait in the local queue, done frames buffer and flush in ONE
        # sendall when the queue drains (or before any blocking request) —
        # each sendall to the busy raylet costs a scheduler wakeup.  A
        # background flusher bounds the staleness to ~2ms so a fast task's
        # result is never held hostage by a slow batch member running
        # behind it.
        self._done_buf: list = []  # guard: _done_lock
        self._done_lock = make_lock("remote_worker.done")
        self._done_pending = threading.Event()
        self._reader = threading.Thread(target=self._read_loop,
                                        name="worker-reader", daemon=True)
        self._reader.start()
        self._flusher = threading.Thread(target=self._flush_loop,
                                         name="worker-done-flush",
                                         daemon=True)
        self._flusher.start()

    def _flush_loop(self):
        while True:
            self._done_pending.wait()
            time.sleep(0.002)  # let a fast burst coalesce
            self._done_pending.clear()
            self.flush_dones()

    def _read_loop(self):
        # Buffered frame reader: a coalesced dispatch train from the raylet
        # costs ~one recv syscall total instead of two (header + payload)
        # per message.
        reader = protocol.FrameReader(self.sock)
        while True:
            try:
                msg = reader.recv_msg()
            except (OSError, protocol.ProtocolError):
                msg = None
            if msg is None:
                os._exit(0)  # raylet gone — die quietly
            t = msg.get("t")
            if t == "task":
                self.task_queue.put(msg)
            elif t == "exit_checkpoint":
                # graceful restart-allowed kill: drain queued calls, take
                # a final snapshot, then exit — handled on the EXECUTOR
                # thread (a snapshot mid-call would tear state)
                self.task_queue.put(msg)
            elif t == "reply":
                entry = self._pending.pop(msg["rid"], None)
                if entry is not None:
                    entry["msg"] = msg
                    entry["event"].set()
            elif t == "stack":
                # live introspection (`ray_tpu_torch stack`): answered HERE on
                # the reader thread, so a worker stuck in user code — or
                # deadlocked on the executor — still reports every
                # thread's stack (the py-spy-dump analogue, in-process)
                from ray_tpu_torch.util import profiling

                try:
                    self._send({"t": "stack_reply",
                                "token": msg.get("token"),
                                "pid": os.getpid(),
                                "threads": profiling.dump_threads(
                                    proc="worker")})
                except OSError:
                    pass
            elif t == "cancel":
                # cancel/deadline fan-out from the raylet: a queued task
                # is marked for the pre-exec check, a RUNNING one gets
                # the exception raised in its executor thread (handled
                # HERE on the reader thread — the executor is the thread
                # being interrupted)
                self.cancel_registry.cancel(
                    msg["task_id"],
                    DeadlineExceededError if msg.get("deadline")
                    else TaskCancelledError)
            elif t == "direct_lease":
                # lease grant/release notice: the DirectServer validates
                # lease hellos against this token (None = not leased)
                self.active_lease_id = msg.get("lease_id")
            elif t == "direct_fence":
                # the raylet fenced an actor/node we hold direct channels
                # to: tear down and reconcile in-flight calls via the
                # raylet path (handled on this reader thread — the
                # executor may be blocked inside one of those calls)
                if self._direct is not None:
                    self._direct.on_fence(msg)
            elif t == "shutdown":
                os._exit(0)

    def _send(self, msg):
        protocol.send_msg(self.sock, msg, self.send_lock)

    def send_done(self, msg):
        """Send a task-completion message, coalescing with neighbors while
        batched work is still queued locally (flushed at queue drain,
        before any blocking request, or by the ~2ms background flusher)."""
        # Hold announcements for refs this task deserialized must reach the
        # raylet BEFORE the done (which releases the spec's borrow pins) —
        # the socket preserves order, so flushing them first suffices.
        from ray_tpu_torch.core.worker import flush_pending_releases

        flush_pending_releases()
        with self._done_lock:
            self._done_buf.append(msg)
            if not self.task_queue.empty():
                self._done_pending.set()
                return
            buf, self._done_buf = self._done_buf, []
        protocol.send_msgs(self.sock, buf, self.send_lock)

    def flush_dones(self):
        with self._done_lock:
            buf, self._done_buf = self._done_buf, []
        if buf:
            protocol.send_msgs(self.sock, buf, self.send_lock)

    def queue_done(self, msg):
        """Buffer a completion strictly for the background flusher (~2ms):
        used for direct_done notices — the CALLER already has the result,
        so the raylet's bookkeeping copy is latency-tolerant and must not
        cost this thread a per-call sendall."""
        from ray_tpu_torch.core.worker import flush_pending_releases

        flush_pending_releases()  # hold events precede the done (in order)
        with self._done_lock:
            self._done_buf.append(msg)
            self._done_pending.set()

    def queue_direct_notes(self, notes):
        """Buffer a whole drained train of direct_running/direct_done
        notes as ONE direct_notes frame (burst mode): one ref-event
        flush and one done-buffer lock round per train instead of two
        per call — the raylet unpacks and applies them in order."""
        from ray_tpu_torch.core.worker import flush_pending_releases

        flush_pending_releases()  # hold events precede the dones (in order)
        with self._done_lock:
            self._done_buf.append({"t": "direct_notes", "notes": notes})
            self._done_pending.set()

    def requeue_pending_tasks(self):
        """Hand unstarted batched tasks back to the raylet — called before
        blocking (nested get/wait): the current task may wait on work that
        would otherwise sit behind it in this worker's own queue.  Pool
        workers only — actor calls are pinned to their worker (and an actor
        worker's queue order must not be disturbed)."""
        if self.actor_instance is not None:
            return
        give_back = []
        keep = []
        try:
            while True:
                m = self.task_queue.get_nowait()
                if m.get("direct_conn") is not None or "spec" not in m:
                    # direct calls belong to their caller's channel, not
                    # the raylet — keep them queued here
                    keep.append(m)
                else:
                    give_back.append(m["spec"])
        except queue.Empty:
            pass
        for m in keep:
            self.task_queue.put(m)
        if give_back:
            self._send({"t": "requeue", "specs": give_back})

    def _request(self, op, _wait_timeout=None, **fields):
        """Round-trip to the raylet.  ``_wait_timeout`` bounds the local wait
        (used by get/wait with a user timeout): on expiry the request is
        cancelled raylet-side and TimeoutError raised here."""
        self.flush_dones()  # the raylet must see completions before we wait
        with self._rid_lock:
            self._rid += 1
            rid = self._rid
        entry = {"event": threading.Event(), "msg": None}
        self._pending[rid] = entry
        self._send({"t": "request", "rid": rid, "op": op, **fields})
        remaining = _wait_timeout
        if (op in ("get", "wait", "stream_next")
                and (remaining is None or remaining > 0.05)
                and not self.task_queue.empty()):
            # Grace period before handing batched tasks back: a get the
            # raylet satisfies immediately must not trigger a
            # requeue/redispatch churn cycle, and short-timeout POLLS
            # (wait(timeout=0) loops) never give the queue back at all —
            # only an actually-blocking request does.
            grace = 0.01 if remaining is None else min(0.01, remaining)
            if entry["event"].wait(grace):
                remaining = 0
            else:
                if remaining is not None:
                    remaining -= grace
                self.requeue_pending_tasks()
        if not entry["event"].wait(remaining):
            self._pending.pop(rid, None)
            self._send({"t": "request", "rid": rid + (1 << 62), "op":
                        "cancel_request", "target_rid": rid})
            raise TimeoutError(f"request {op} timed out")
        msg = entry["msg"]
        if not msg["ok"]:
            raise msg["error"]
        return msg["value"]


def _deliver_result(worker: RemoteWorker, msg: dict, done: dict):
    """Route a task's completion: relayed tasks send the ordinary done to
    the raylet; direct calls push the result STRAIGHT to the caller's
    channel (the latency path), remember it for retry dedup, and notify
    the raylet with a direct_done so object state / ref counting / task
    events / lineage stay exactly as on the relayed path."""
    dconn = msg.get("direct_conn")
    if dconn is None:
        worker.send_done(done)
        return
    spec: TaskSpec = msg["spec"]
    worker.direct_server.remember(spec.task_id, done)
    res = dict(done)
    res["t"] = "dresult"
    burst = config.direct_burst
    rx = msg.get("_rx_t")
    if burst and rx is not None:
        # decode→result turnover, stamped for the caller's lease
        # pipelining EWMA (burst mode only — the pre-burst dresult
        # stays byte-identical under the kill switch)
        res["dur"] = time.time() - rx
    dconn.send_result(res)
    note = dict(done)
    note["t"] = "direct_done"
    note["spec"] = spec
    if burst and rx is not None:
        # same stamp on the bookkeeping side: the raylet's FINISHED
        # event keeps exec latency when the RUNNING note is elided
        note["dur"] = res["dur"]
    if burst and msg.get("_inline"):
        # inline exec on the conn thread: the note coalesces into the
        # train's batched direct_notes flush (see _DirectConn.flush_notes)
        dconn.note_buf.append(note)
    else:
        worker.queue_done(note)


def _resolve_callable(worker: RemoteWorker, spec: TaskSpec, fn_blob):
    key = spec.function_id.binary() if spec.function_id else None
    if key is not None and key in worker._fn_cache:
        return worker._fn_cache[key]
    blob = fn_blob or spec.function_blob
    if blob is None and spec.function_id is not None:
        blob = worker._request("get_function", id=spec.function_id.binary())
    if blob is None:
        raise RuntimeError(f"no function payload for task {spec.name}")
    fn = cloudpickle.loads(blob)
    if key is not None:
        worker._fn_cache[key] = fn
    return fn


def _resolve_args(worker: RemoteWorker, spec: TaskSpec, arg_values):
    def resolve(entry):
        kind, payload = entry
        if kind == "v":
            return serialization.loads(payload)
        oid: ObjectID = payload
        blob = arg_values.get(oid.hex())
        if blob is not None:
            return serialization.loads(blob)
        if worker.store is None:
            raise RuntimeError("no object store attached")
        # evicted arg -> lineage reconstruction via the raylet
        return worker.read_store_object(oid)

    args = [resolve(a) for a in spec.args]
    kwargs = {k: resolve(v) for k, v in spec.kwargs}
    return args, kwargs


def _package_results(worker: RemoteWorker, spec: TaskSpec, result):
    inline: Dict[str, bytes] = {}
    stored = []
    if spec.num_returns in (1, STREAMING_RETURNS):
        values = [result]  # streaming: result is the completion marker
    else:
        values = list(result)
        if len(values) != spec.num_returns:
            raise ValueError(
                f"task {spec.name} declared num_returns={spec.num_returns} "
                f"but returned {len(values)} values"
            )
    sizes: Dict[str, int] = {}
    contains: Dict[str, list] = {}
    for oid, val in zip(spec.return_ids(), values):
        ser, inner = serialization.serialize_with_refs(val)
        if inner:
            # refs inside the result: the raylet pins them for the result
            # object's lifetime (borrow pinning)
            contains[oid.hex()] = inner
        n = ser.total_bytes()
        if n <= config.inline_object_max_bytes or worker.store is None:
            inline[oid.hex()] = ser.to_bytes()
        else:
            worker.store.put_serialized(oid, ser)
            stored.append(oid.hex())
            sizes[oid.hex()] = n
    return inline, stored, sizes, contains


def _save_checkpoint(worker: RemoteWorker):
    """Serialize the actor's ``__ray_save__()`` state into a fresh object
    and hand it to the raylet (inline blob, or shm store + size), which
    records it on the actor and replicates it.  Runs on the executor
    thread only — never concurrently with a method call."""
    inst = worker.actor_instance
    if inst is None:
        return
    from ray_tpu_torch.core.ids import put_counter

    oid = put_counter.next_object_id()
    try:
        state = inst.__ray_save__()
        ser = serialization.serialize(state)
        n = ser.total_bytes()
        msg = {"t": "checkpoint", "actor_id": worker.current_actor_id,
               "seq": worker.checkpoint_seq + 1, "id": oid.hex()}
        if n <= config.inline_object_max_bytes or worker.store is None:
            msg["inline"] = ser.to_bytes()
        else:
            # inside the guard: a full store with spilling disabled
            # raises ObjectStoreFullError — skip the snapshot, don't
            # kill the actor
            worker.store.put_serialized(oid, ser)
            msg["size"] = n
    except Exception:  # noqa: BLE001 — a failed snapshot must not kill calls
        traceback.print_exc()
        return
    worker.checkpoint_seq += 1
    # completed results must reach the raylet BEFORE the snapshot that
    # includes their effects (socket order preserves the invariant)
    worker.flush_dones()
    worker._send(msg)


def _maybe_checkpoint(worker: RemoteWorker):
    """Count a completed actor call toward the checkpoint cadence."""
    if not worker.checkpoint_interval:
        return
    worker.checkpoint_calls += 1
    if worker.checkpoint_calls < worker.checkpoint_interval:
        return
    worker.checkpoint_calls = 0
    _save_checkpoint(worker)


def _run_streaming(worker: RemoteWorker, spec: TaskSpec, gen):
    """Drive a generator task: each yield ships to the raylet immediately
    (reference: streaming generator returns, `_raylet.pyx:224`) so consumers
    can read item i while item i+1 is still being produced.  The slot-0
    completion marker resolves to the item count."""
    idx = 0
    for item in gen:
        oid = spec.stream_item_id(idx)
        ser, inner = serialization.serialize_with_refs(item)
        n = ser.total_bytes()
        if n <= config.inline_object_max_bytes or worker.store is None:
            worker._send({"t": "stream_item", "id": oid.hex(), "index": idx,
                          "inline": ser.to_bytes(), "contains": inner})
        else:
            worker.store.put_serialized(oid, ser)
            worker._send({"t": "stream_item", "id": oid.hex(), "index": idx,
                          "inline": None, "size": n, "contains": inner})
        idx += 1
    return idx


def _apply_runtime_env(spec: TaskSpec):
    _, _, _, _, _, _rtenv, global_worker = _hot()
    _rtenv.ensure_runtime_env(global_worker(), spec.runtime_env)


def _enrich_control_error(e, spec: TaskSpec):
    """Async-raised interrupts come from PyThreadState_SetAsyncExc with
    the exception CLASS (instances are unreliable there), so a mid-exec
    DeadlineExceededError carries no message/hop — rebuild it with the
    task name and the worker.mid_exec hop before it rides to the
    caller."""
    if isinstance(e, DeadlineExceededError) and not e.hop:
        return DeadlineExceededError(
            f"task {spec.name} missed its deadline mid-execution",
            hop="worker.mid_exec")
    return e


def _preflight(worker: RemoteWorker, spec: TaskSpec):
    """Deadline + cancellation gate, run before any expensive phase
    (entry, between arg-pull and exec): work whose deadline already
    passed — or that a cancel frame reached first — raises the typed
    control error instead of executing (no wasted exec)."""
    worker.cancel_registry.check(spec.task_id)
    if (config.deadlines and spec.deadline is not None
            and time.time() > spec.deadline):
        raise DeadlineExceededError(
            f"task {spec.name} deadline expired before execution",
            hop="worker.pre_exec")


def _setup_actor_concurrency(worker: RemoteWorker, spec: TaskSpec):
    """After actor instantiation: start the thread pool / asyncio loop that
    back max_concurrency>1 and coroutine methods."""
    inst = worker.actor_instance
    # Walk the class MRO rather than getattr on the instance: getattr would
    # EXECUTE properties as a side effect of actor creation.
    has_async = any(
        inspect.iscoroutinefunction(v)
        for klass in type(inst).__mro__
        for v in vars(klass).values()
    )
    if has_async and worker.actor_loop is None:
        loop = asyncio.new_event_loop()
        threading.Thread(target=loop.run_forever, daemon=True,
                         name="actor-asyncio").start()
        worker.actor_loop = loop
    if spec.concurrency_groups and worker.group_executors is None:
        if has_async:
            raise NotImplementedError(
                "concurrency_groups are thread-pool based and do not "
                "combine with asyncio actor methods — use one or the "
                "other (reference async fiber groups are not implemented)")
        # One thread pool per named group (reference: threaded concurrency
        # groups, `concurrency_group_manager.cc`): each group's limit is
        # enforced by its pool size; the raylet additionally admits per
        # group.
        worker.group_executors = {
            name: ThreadPoolExecutor(
                max_workers=n, thread_name_prefix=f"actor-{name}")
            for name, n in spec.concurrency_groups.items()
        }
    elif spec.max_concurrency > 1 and worker.actor_executor is None:
        worker.actor_executor = ThreadPoolExecutor(
            max_workers=spec.max_concurrency, thread_name_prefix="actor-exec"
        )


class _run_span:
    """Shared task.run tracing wrapper for the sync and asyncio execution
    paths (child span of the submit-side span; reference:
    `_inject_tracing_into_function`, `tracing_helper.py:322`).  Call
    ``done(ok)`` with the inner result so user exceptions converted into
    error replies still mark the span ERROR.

    Only requests carrying a submit-side context get an execution span
    (with no ctx a span here would mint a fresh root per execution —
    noise, not a request trace), and SAMPLED-OUT requests skip the span
    object entirely: a failure is reported post-hoc as one synthesized
    ERROR span under the propagated ids, so errored requests stay
    visible while the other 99% pay ~nothing."""

    def __init__(self, spec: TaskSpec):
        tracing = _hot()[4]
        self._sp = None
        self._err_ctx = None
        ctx = spec.trace_ctx
        if ctx is None or not tracing.tracing_enabled():
            return
        if ctx.get("sampled", True):
            self._sp = tracing.span(
                f"task.run {spec.name}", parent=ctx,
                task_id=spec.task_id.hex(), kind=spec.kind)
        else:
            self._err_ctx = ctx
            self._name = spec.name
            self._task_id = spec.task_id.hex()

    def __enter__(self):
        if self._sp is not None:
            self._sp.__enter__()
        elif self._err_ctx is not None:
            self._t0 = time.time()
        return self

    def done(self, ok: bool):
        if ok:
            return
        if self._sp is not None:
            self._sp.set_error("task raised (see error object)")
        elif self._err_ctx is not None:
            from ray_tpu_torch.util import tracing

            tracing.emit_span(
                f"task.run {self._name}", self._err_ctx["trace_id"],
                self._err_ctx.get("span_id"), self._t0, time.time(),
                status="ERROR", error="task raised (see error object)",
                task_id=self._task_id)

    def __exit__(self, *exc):
        if self._sp is not None:
            return self._sp.__exit__(*exc)
        return False


async def _execute_async(worker: RemoteWorker, msg: dict):
    with _run_span(msg["spec"]) as rs:
        rs.done(await _execute_async_inner(worker, msg))


async def _execute_async_inner(worker: RemoteWorker, msg: dict) -> bool:
    spec: TaskSpec = msg["spec"]
    from ray_tpu_torch.runtime_context import (
        _current_deadline,
        _current_task_id,
    )
    from ray_tpu_torch.util import profiling, tracing

    _ctx_token = _current_task_id.set(spec.task_id)
    _dl_token = _current_deadline.set(
        spec.deadline if config.deadlines else None)
    # Profiler attribution (best-effort on the shared asyncio thread:
    # interleaved calls each stamp the loop thread while they hold it;
    # chain=False so an out-of-LIFO-order exit clears instead of
    # restoring a finished task's tags).
    _ptags = profiling.set_task_tags(
        task_id=spec.task_id.hex(),
        trace_id=(spec.trace_ctx or {}).get("trace_id"),
        actor_id=spec.actor_id.hex() if spec.actor_id else None,
        name=spec.name, chain=False)
    try:
        with tracing.maybe_span("worker.get_args"):
            args, kwargs = _resolve_args(worker, spec,
                                         msg.get("arg_values", {}))
        # Async calls: pre-exec check, then register the asyncio task so
        # mid-exec cancel/deadline can task.cancel() it on the loop
        # (CancelledError at the next await — an async exception into
        # the shared loop thread would kill every interleaved call).
        _preflight(worker, spec)
        from ray_tpu_torch.util import chaos as _chaos

        _chaos.exec_delay(spec.name)
        _preflight(worker, spec)
        worker.cancel_registry.register_async(
            spec.task_id, asyncio.get_running_loop(),
            asyncio.current_task(),
            spec.deadline if config.deadlines else None)
        try:
            with tracing.maybe_span("worker.exec"):
                result = await getattr(
                    worker.actor_instance, spec.method_name)(*args, **kwargs)
        except asyncio.CancelledError:
            # our cancel()/watchdog cancelled the task: convert back to
            # the typed control error the caller dispatches on (the
            # outer handler delivers it as the done frame)
            exc = worker.cancel_registry.cancelled_as(spec.task_id)
            raise (exc or TaskCancelledError)() from None
        finally:
            worker.cancel_registry.deregister(spec.task_id)
        with tracing.maybe_span("worker.result_push"):
            inline, stored, sizes, contains = _package_results(worker, spec,
                                                               result)
            _deliver_result(worker, msg,
                            {"t": "done", "task_id": spec.task_id,
                             "ok": True, "inline": inline, "stored": stored,
                             "sizes": sizes, "contains": contains})
        return True
    except CONTROL_ERRORS as e:
        # typed control-flow errors reach the caller AS-IS (a TaskError
        # wrapper would hide the type the router/get() dispatch on)
        _deliver_result(worker, msg, {
            "t": "done", "task_id": spec.task_id, "ok": False,
            "error": _enrich_control_error(e, spec), "retryable": False,
        })
        return False
    except Exception:  # noqa: BLE001
        tb = traceback.format_exc()
        err = TaskError(spec.name, tb, None)
        _deliver_result(worker, msg, {
            "t": "done", "task_id": spec.task_id, "ok": False,
            "error": err, "retryable": spec.retry_exceptions,
        })
        return False
    finally:
        profiling.reset_task_tags(_ptags)
        _current_deadline.reset(_dl_token)
        _current_task_id.reset(_ctx_token)


def execute_task(worker: RemoteWorker, msg: dict):
    dconn = msg.get("direct_conn")
    if dconn is not None:
        # the raylet never saw this call dispatch: a batched RUNNING note
        # keeps the timeline / state API seeing in-flight direct work
        # (rides the ~2ms done-flusher, not the latency path)
        note = {"t": "direct_running", "spec": msg["spec"]}
        if dconn.coalesce and config.direct_burst:
            # mid-train inline exec: batch the note with its direct_done
            # into the train's one direct_notes frame.  Head-of-train and
            # queue-path calls keep the per-call note so a LONG direct
            # call is still visible (and raylet-cancellable) mid-exec.
            dconn.note_buf.append(note)
        else:
            worker.queue_done(note)
    with _run_span(msg["spec"]) as rs:
        ok = _execute_task_inner(worker, msg)
        rs.done(ok)
        if msg["spec"].kind == ACTOR_TASK:
            # cadence counts COMPLETED calls (ok or errored — either may
            # have mutated state); __ray_terminate__ never returns here
            _maybe_checkpoint(worker)
        return ok


def _execute_task_inner(worker: RemoteWorker, msg: dict):
    spec: TaskSpec = msg["spec"]
    _current_deadline, _current_task_id, _chaos, profiling, tracing, _, _ \
        = _hot()
    _ctx_token = _current_task_id.set(spec.task_id)
    _dl_token = _current_deadline.set(
        spec.deadline if config.deadlines else None)
    # Profiler attribution: samples taken on this thread while the task
    # runs fold under its task/trace/actor ids (flamegraph slicing).
    _ptags = profiling.set_task_tags(
        task_id=spec.task_id.hex(),
        trace_id=(spec.trace_ctx or {}).get("trace_id"),
        actor_id=spec.actor_id.hex() if spec.actor_id else None,
        name=spec.name)
    extra: dict = {}
    _registered = False
    try:
        if msg.get("__bad_group__") is not None:
            raise ValueError(
                f"undeclared concurrency group "
                f"{msg['__bad_group__']!r} for {spec.name}")
        _apply_runtime_env(spec)
        _preflight(worker, spec)
        with tracing.maybe_span("worker.get_args"):
            args, kwargs = _resolve_args(worker, spec,
                                         msg.get("arg_values", {}))
        # between arg-pull and exec: the deadline/cancel gate, then the
        # chaos slow-executor seam, then gate again — an injected delay
        # must be visible to the deadline check like real slowness
        _preflight(worker, spec)
        _chaos.exec_delay(spec.name)
        _preflight(worker, spec)
        worker.cancel_registry.register(
            spec.task_id, threading.get_ident(),
            spec.deadline if config.deadlines else None)
        _registered = True
        with tracing.maybe_span("worker.exec"):
            if spec.kind == ACTOR_CREATION_TASK:
                cls = _resolve_callable(worker, spec, msg.get("fn_blob"))
                worker.actor_instance = cls(*args, **kwargs)
                worker.current_actor_id = spec.actor_id
                # direct-transport fencing: hellos must present this exact
                # restart generation (stamped by the owning raylet)
                worker.actor_generation = getattr(
                    spec, "_direct_generation", 0)
                _setup_actor_concurrency(worker, spec)
                worker.checkpoint_interval = spec.checkpoint_interval or 0
                if worker.checkpoint_interval \
                        and worker.actor_loop is not None:
                    # the options-time validation can't see coroutine
                    # methods; fail creation loudly rather than
                    # snapshot-while-awaiting
                    raise ValueError(
                        "checkpoint_interval is not supported on asyncio "
                        "actors (state may mutate at await points during "
                        "__ray_save__)")
                if spec.restore_oid is not None:
                    # warm restart: re-hydrate from the latest checkpoint
                    # the owning raylet attached to this (re)creation —
                    # spanned as a recovery event under the restarting
                    # request's trace
                    with tracing.maybe_span(
                            "recovery.restore",
                            checkpoint=spec.restore_oid.hex()):
                        blob = msg.get("arg_values", {}).get(
                            spec.restore_oid.hex())
                        state = (serialization.loads(blob)
                                 if blob is not None
                                 else worker.read_store_object(
                                     spec.restore_oid))
                        worker.actor_instance.__ray_restore__(state)
                    extra["restored"] = True
                # the raylet pipelines calls only to sync actors — report
                # the execution model it can't otherwise see
                extra["async_actor"] = worker.actor_loop is not None
                result = None
            elif spec.kind == ACTOR_TASK:
                if spec.method_name == "__ray_terminate__":
                    worker.flush_dones()
                    worker._send({"t": "done", "task_id": spec.task_id,
                                  "ok": True,
                                  "inline": {spec.return_ids()[0].hex():
                                             serialization.dumps(None)},
                                  "stored": []})
                    os._exit(0)
                inst = worker.actor_instance
                if inst is None:
                    raise RuntimeError("actor instance missing")
                method = getattr(inst, spec.method_name)
                result = method(*args, **kwargs)
                if inspect.iscoroutine(result):
                    # Coroutine reached the sync path (e.g. called from an
                    # executor thread): run it on the actor loop to
                    # completion.
                    result = asyncio.run_coroutine_threadsafe(
                        result, worker.actor_loop
                    ).result() if worker.actor_loop else asyncio.run(result)
            else:
                fn = _resolve_callable(worker, spec, msg.get("fn_blob"))
                result = fn(*args, **kwargs)
            if spec.num_returns == STREAMING_RETURNS:
                result = _run_streaming(worker, spec, result)
        # out of the interruptible window BEFORE packaging results: a
        # deadline/cancel exception landing mid-push could double-report
        worker.cancel_registry.deregister(spec.task_id)
        _registered = False
        with tracing.maybe_span("worker.result_push"):
            inline, stored, sizes, contains = _package_results(worker, spec,
                                                               result)
            _deliver_result(worker, msg,
                            {"t": "done", "task_id": spec.task_id,
                             "ok": True, "inline": inline, "stored": stored,
                             "sizes": sizes, "contains": contains, **extra})
        return True
    except CONTROL_ERRORS as e:
        # deadline expiry / cancellation / backpressure reach the caller
        # TYPED (a TaskError wrapper would hide what get() dispatches on)
        # and never retry
        _deliver_result(worker, msg, {
            "t": "done", "task_id": spec.task_id, "ok": False,
            "error": _enrich_control_error(e, spec), "retryable": False,
        })
        return False
    except Exception as e:  # noqa: BLE001
        tb = traceback.format_exc()
        err = TaskError(spec.name, tb, None)
        _deliver_result(worker, msg, {
            "t": "done", "task_id": spec.task_id, "ok": False,
            "error": err, "retryable": spec.retry_exceptions,
        })
        return False
    finally:
        if _registered:
            try:
                worker.cancel_registry.deregister(spec.task_id)
            except CONTROL_ERRORS:
                # a cancel frame raced the error path's own deregister:
                # the async exception fired while we were already
                # unwinding (done frame sent) — absorb it here so it
                # cannot escape into the executor / direct-conn loop
                pass
        profiling.reset_task_tags(_ptags)
        _current_deadline.reset(_dl_token)
        _current_task_id.reset(_ctx_token)


class _PrefixStream:
    """Line-prefixing stdout/stderr wrapper — the lightweight analogue of
    the reference's log monitor pipeline (worker log files tailed by
    `log_monitor.py:102` and re-printed on the driver with a
    ``(pid=..)`` prefix).  Workers inherit the driver's stdio here, so
    prefixing at the source gives the same attribution."""

    def __init__(self, stream, prefix: str):
        self._stream = stream
        self._prefix = prefix
        self._at_line_start = True

    def write(self, data: str):
        if not data:
            return 0
        out = []
        for chunk in data.splitlines(keepends=True):
            if self._at_line_start:
                out.append(self._prefix)
            out.append(chunk)
            self._at_line_start = chunk.endswith("\n")
        self._stream.write("".join(out))
        return len(data)

    def flush(self):
        self._stream.flush()

    def __getattr__(self, name):
        return getattr(self._stream, name)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--socket", required=True)
    parser.add_argument("--store", default=None)
    args = parser.parse_args()

    # Crash forensics: SIGSEGV/SIGBUS/SIGABRT dump every thread's stack to
    # stderr — which cluster mode redirects to this worker's log file, so
    # the dump lands in the excerpt the raylet attaches to the failure.
    import faulthandler

    faulthandler.enable()

    if config.log_to_driver:
        prefix = f"(worker pid={os.getpid()}) "
        sys.stdout = _PrefixStream(sys.stdout, prefix)
        sys.stderr = _PrefixStream(sys.stderr, prefix)

    from ray_tpu_torch.util import profiling, tracing

    tracing.set_process_label("worker")
    tracing.maybe_enable_from_env()
    profiling.ensure_profiler("worker")

    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(args.socket)
    worker = RemoteWorker(sock)
    if args.store:
        worker.store = ShmObjectStore(args.store)
    init_worker(worker)
    if config.direct_calls:
        # Direct transport, both roles: serve direct calls addressed to
        # this worker (listener address rides the register message), and
        # dial peers for this worker's own nested actor calls / leases.
        from ray_tpu_torch.core.direct import DirectCallClient, DirectServer

        try:
            worker.direct_server = DirectServer(
                worker, os.path.dirname(os.path.abspath(args.socket)))
        except OSError:
            worker.direct_server = None  # unservable dir: relayed only
        worker._direct = DirectCallClient(
            worker,
            broker=lambda aid: worker._request("direct_lookup",
                                               actor_id=aid),
            resubmit=worker._submit_relayed,
            lease=lambda spec: worker._request("direct_lease", spec=spec),
            lease_release=lambda lid: worker._request(
                "direct_lease_release", lease_id=lid),
        )
    worker._send({
        "t": "register",
        "pid": os.getpid(),
        "worker_id": worker.worker_id,
        "profile": config.worker_profile or "cpu",
        "direct_addr": (worker.direct_server.addr
                        if worker.direct_server is not None else None),
    })
    if tracing.tracing_enabled():
        # span export: batches ride the control socket to the raylet,
        # which forwards to the GCS trace table on its flush cadence
        tracing.set_flush_target(
            lambda spans, dropped: worker._send(
                {"t": "spans", "spans": spans, "dropped": dropped}))
    # folded profile export rides the same route (raylet -> GCS profile
    # table); registered unconditionally — RAY_TPU_PROFILE is a live
    # switch, so a worker started with profiling off must still ship
    # samples once it's flipped on
    profiling.set_flush_target(
        lambda samples, dropped: worker._send(
            {"t": "profile_samples", "samples": samples,
             "dropped": dropped}))
    # metric time-series delta points ride the same route (raylet -> GCS
    # metrics table); registered unconditionally — the per-process flusher
    # only spins up once a metric is registered in this worker, and the
    # flush itself checks the metrics_history flag
    from ray_tpu_torch.util import metrics as _metrics_mod

    _metrics_mod.set_points_target(
        lambda points, dropped: worker._send(
            {"t": "metric_points", "points": points, "dropped": dropped}))
    while True:
        try:
            _main_tick(worker)
        except CONTROL_ERRORS:
            # a mid-exec cancel/deadline exception that lost the race with
            # task completion lands here, between tasks — absorb it; the
            # task it was aimed at already reported
            continue


def _main_tick(worker: RemoteWorker):
    msg = worker.task_queue.get()
    if msg.get("t") == "exit_checkpoint":
        # restart-allowed kill: final snapshot (queued calls ahead of
        # this message already ran and are counted in it), then exit —
        # the raylet restarts the actor from this exact state.
        if worker.checkpoint_interval:
            _save_checkpoint(worker)
        worker.flush_dones()
        os._exit(0)
    spec: TaskSpec = msg["spec"]
    if (worker.direct_server is not None
            and msg.get("direct_conn") is None):
        cached, deferred = worker.direct_server.reconcile_probe(
            spec.task_id)
        if cached is not None:
            # raylet-path reconcile of a direct call that ALREADY
            # executed here: re-send the recorded result — executing
            # again would double the call's side effects
            cached["t"] = "done"
            cached["task_id"] = spec.task_id
            worker.send_done(cached)
            return
        if deferred:
            # the ORIGINAL direct execution is still in flight (e.g.
            # a false-SUSPECT fence made the caller reconcile while
            # the callee kept running): remember() answers this
            # dispatch with the recorded result at completion —
            # executing now would double the call's side effects
            return
    if (spec.kind == ACTOR_TASK and worker.actor_instance is not None
            and spec.method_name != "__ray_terminate__"):
        # getattr_static on the INSTANCE: side-effect-free (no property
        # getters run on the dispatch thread — the hazard
        # _setup_actor_concurrency documents) AND it sees instance-dict
        # methods (self.handler = some_async_fn) that a type()-level
        # lookup would miss, silently demoting them to the blocking
        # sync path.  Static lookup returns raw descriptors, so unwrap
        # them or an async staticmethod would fail the coroutine check.
        method = inspect.getattr_static(
            worker.actor_instance, spec.method_name, None)
        if isinstance(method, (staticmethod, classmethod)):
            method = method.__func__
        if worker.actor_loop is not None and \
                inspect.iscoroutinefunction(method):
            # Async actor: schedule on the loop, keep draining the queue
            # — calls interleave at await points (up to max_concurrency
            # in flight, bounded raylet-side).
            asyncio.run_coroutine_threadsafe(
                _execute_async(worker, msg), worker.actor_loop
            )
            return
        if worker.group_executors is not None:
            group = spec.concurrency_group
            if group is None and method is not None:
                group = getattr(method, "__ray_tpu_method_options__",
                                {}).get("concurrency_group")
            pool = worker.group_executors.get(group or "_default")
            if pool is None:
                # undeclared group name: fail the CALL loudly (typos
                # must not silently serialize onto the default pool)
                msg["__bad_group__"] = group
                pool = worker.group_executors["_default"]
            pool.submit(execute_task, worker, msg)
            return
        if worker.actor_executor is not None:
            worker.actor_executor.submit(execute_task, worker, msg)
            return
    with worker.exec_lock:
        execute_task(worker, msg)


if __name__ == "__main__":
    main()
