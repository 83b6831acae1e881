"""Direct worker→worker call transport — peer-to-peer actor calls and
lease-reused tasks, with the raylet demoted to broker.

Reference analogue: the core worker's direct actor/task submitters
(`src/ray/core_worker/transport/direct_actor_transport.h`,
`direct_task_transport.h`): after the first raylet-brokered call resolves
an actor (or leases a pool worker), the caller's process dials the callee
worker's process directly and the callee pushes results straight back —
the raylet's submit→inbox→dispatch→done round trip leaves the critical
path entirely.

Roles (both live in this module so the wire format has one home):

* ``DirectServer`` — callee side, hosted by every worker subprocess: a
  listening socket (unix always; TCP too in cluster mode) whose address
  rides the worker's ``register`` message.  Accepted callers are
  validated against the PR 8 fencing state (node incarnation) and the
  actor's restart generation before any call is accepted.  Executed
  results are remembered in a bounded dedup cache so a retried call
  (new channel, or a raylet-path reconcile) re-sends the recorded result
  instead of re-executing.
* ``DirectCallClient`` — caller side, hosted by drivers and workers:
  per-actor (and per-lease) connection cache, pending-call table the
  caller's ``get()`` resolves against, and the fallback machinery — on
  channel death, fence notice, or a stale-after-freeze reject, in-flight
  calls are resubmitted through the raylet with ``_direct_retry`` set,
  where the resolved-skip + actor-generation checks give the existing
  retryable-``ActorDiedError`` semantics with zero double-execution.

Ordering: a caller switches an actor to the direct path only once it has
observed every previously relayed call to that actor complete (via get /
wait), and from then on all its eligible calls ride one FIFO socket — so
per-handle call order is preserved across the switch.  Calls that are
ineligible (ObjectRef args, streaming returns, ``__ray_terminate__``)
stay on the raylet path.

Bookkeeping: the callee notifies its raylet of every direct completion
with a ``direct_done`` frame (off the caller's critical path), so object
state, ref counting, task events, lineage (lease tasks), and replication
behave exactly as on the relayed path; the raylet just stops being a hop
in the caller's round trip.

Freeze gate: a process resumed from a long stop (SIGSTOP partition — the
PR 8 chaos scenario) must not execute direct frames that sat in its
kernel buffer across the freeze: by then the cluster may have fenced the
node and restarted the actor elsewhere.  A 100ms ticker detects the gap;
whichever thread first observes ``now - last_tick`` beyond the gate marks
every live conn stale, and stale conns reject (never execute) their
calls — the caller reconciles through the raylet, which fences on the
actor generation.
"""

from __future__ import annotations

import os
import select
import socket
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.core import protocol
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.task_spec import (
    ACTOR_TASK,
    NORMAL_TASK,
    STREAMING_RETURNS,
    TaskSpec,
)
from ray_tpu_torch.util.locks import make_lock

config.define("direct_calls", bool, True,
              "Direct worker→worker call transport: after the first "
              "raylet-brokered call, actor calls (and idle-channel "
              "lease-reused tasks) travel caller→callee directly and "
              "results push straight back; the raylet only brokers "
              "address + lease + fencing incarnation and keeps the "
              "relayed path as first-call/recovery fallback.  "
              "RAY_TPU_DIRECT_CALLS=0 is the kill switch (bench A/B, "
              "debugging).")
config.define("direct_dedup_cache", int, 1024,
              "Callee-side executed-result cache entries (per worker): a "
              "retried direct call whose original execution completed "
              "re-sends the recorded result instead of re-executing — "
              "the exactly-once half of partition recovery.")
config.define("direct_result_cache", int, 8192,
              "Caller-side resolved direct-result cache entries; evicted "
              "results fall back to the raylet get path (the callee's "
              "direct_done already registered them there).")
config.define("direct_connect_timeout_s", float, 5.0,
              "Dial + hello timeout for establishing a direct channel; "
              "on expiry the call falls back to the raylet path and the "
              "actor is retried after a short backoff.")
config.define("direct_lease_idle_s", float, 1.0,
              "A leased pool worker (direct normal-task channel) is "
              "returned to its raylet after this long with no call in "
              "flight, bounding how long an idle lease can hold pool "
              "capacity.")
config.define("direct_pipeline_depth", int, 64,
              "Max direct calls in flight per channel before submit() "
              "drains results (blocking): bounds both sides' socket "
              "buffers so a fire-and-forget burst ping-pongs smoothly "
              "instead of wedging in sendall, and bounds how many calls "
              "can need reconciling after a teardown.")
config.define("direct_burst", bool, True,
              "Coalesced direct burst mode: async actor calls and "
              "fast-turnover lease-reused tasks pipeline over the direct "
              "channel with a windowed ack (each dresult acks one slot; "
              "submit() demuxes the socket past direct_burst_window in "
              "flight) instead of draining the window and falling back "
              "to the relayed path; outbound dcalls and callee-side "
              "raylet notes coalesce into one batched frame per flush "
              "window.  RAY_TPU_DIRECT_BURST=0 is the kill switch and "
              "restores the pre-burst drain-and-relay behavior exactly.")
config.define("direct_burst_window", int, 64,
              "Burst-mode window W: max unacked direct calls in flight "
              "per channel.  Past W the submitting thread advances the "
              "window by demuxing results (no per-call round trip, no "
              "relayed hand-back), bounding both sides' socket buffers "
              "and the reconcile set after a teardown.  Default chosen "
              "from the bench_core burst-depth sweep (throughput rises "
              "with W up to the socket-buffer knee; 64 ≈ the plateau).")
config.define("direct_lease_turnover_ms", float, 2.0,
              "Lease channels pipeline a burst (instead of spreading the "
              "fan-out over the pool) only once the channel's observed "
              "per-call turnover EWMA sits below this many milliseconds: "
              "sub-ms tasks gain more from pipelined submission than "
              "from pool parallelism, while longer tasks keep the "
              "serial-reuse + relayed-spread behavior.  The callee "
              "stamps the turnover (decode→result) into each burst-mode "
              "dresult.")
config.define("direct_freeze_gate_s", float, 3.0,
              "Callee freeze detector: if the worker process observes a "
              "scheduling gap longer than this (SIGSTOP partition, VM "
              "pause), direct frames buffered across the gap are "
              "rejected instead of executed — the caller reconciles via "
              "the raylet, which fences on the actor generation.  "
              "Conservative by default: a false trip (ticker starved on "
              "an overloaded host) is safe but costs a teardown + "
              "relayed round trip, so the gate sits well above ordinary "
              "scheduler jitter while far below partition-detection + "
              "failover time.")

_DIAL_ERRORS = (OSError, protocol.ProtocolError, TimeoutError)


def _trace_ctx(spec: TaskSpec):
    """Sampled trace context of a spec, or None — the unsampled fast
    path: 99% of calls at the default 1% sampling pay two dict probes
    here and zero span traffic (the PR 9 discipline, applied to the new
    hops)."""
    ctx = spec.trace_ctx
    if ctx is None or not ctx.get("sampled", True):
        return None
    from ray_tpu_torch.util import tracing

    if not tracing.tracing_enabled():
        return None
    return ctx


# ---------------------------------------------------------------------------
# Callee side


class _DirectConn:
    """One accepted caller connection on the callee worker."""

    __slots__ = ("sock", "send_lock", "alive", "stale", "hello",
                 "coalesce", "_out", "note_buf")

    def __init__(self, sock):
        self.sock = sock
        self.send_lock = make_lock("direct.conn.send")
        self.alive = True
        self.stale = False  # frames may predate a detected freeze
        self.hello: Optional[dict] = None
        # Result coalescing: while the conn thread still has decoded
        # calls backlogged (a pipelined burst), results buffer here and
        # flush in ONE sendall when the backlog drains — bursts pay one
        # syscall per train, sync calls still reply immediately.
        # coalesce is flipped only by the conn thread itself.
        self.coalesce = False
        self._out: List[dict] = []  # conn-thread only
        # Raylet-note coalescing (burst mode): direct_running/direct_done
        # notes from this train's inline executions buffer here and ship
        # as ONE direct_notes frame at train drain — one ref-event flush
        # and one done-buffer lock per train instead of two per call.
        self.note_buf: List[dict] = []  # conn-thread only

    def flush_notes(self, worker):
        if not self.note_buf:
            return
        notes, self.note_buf = self.note_buf, []
        worker.queue_direct_notes(notes)

    def send_result(self, msg):
        if self.coalesce:
            self._out.append(msg)
            return
        try:
            protocol.send_msg(self.sock, msg, self.send_lock)
        except OSError:
            self.alive = False

    def flush_results(self):
        if not self._out:
            return
        out, self._out = self._out, []
        try:
            protocol.send_msgs(self.sock, out, self.send_lock)
        except OSError:
            self.alive = False


class DirectServer:
    """Callee-side listener hosted by a worker subprocess.

    Accepts direct channels, validates hellos against incarnation +
    actor generation, enqueues calls into the worker's ordinary task
    queue (FIFO with raylet dispatches), and remembers executed results
    for retry dedup.
    """

    def __init__(self, worker, sock_dir: str):
        self._worker = worker
        self._listeners: List[socket.socket] = []
        self.unix_path = os.path.join(sock_dir, f"direct-{os.getpid()}.sock")
        if os.path.exists(self.unix_path):
            os.unlink(self.unix_path)
        lsock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        lsock.bind(self.unix_path)
        lsock.listen(64)
        self._listeners.append(lsock)
        tcp_addr = None
        node_ip = config.node_ip
        if node_ip:
            # cluster mode: remote callers (drivers/workers on peers) dial
            # over TCP; the raylet stamps RAY_TPU_NODE_IP into our env
            try:
                tsock = socket.create_server((node_ip, 0), backlog=64)
                self._listeners.append(tsock)
                tcp_addr = (node_ip, tsock.getsockname()[1])
            except OSError:
                tcp_addr = None
        self.addr = {"unix": self.unix_path, "tcp": tcp_addr,
                     "hostname": socket.gethostname()}
        self.node_incarnation = config.node_incarnation
        # Executed-result dedup: task_id -> done record (guard: _dedup_lock)
        self._dedup: "OrderedDict[Any, dict]" = OrderedDict()
        self._dedup_lock = make_lock("direct.server.dedup")
        # Direct calls admitted but not yet completed, and raylet-path
        # reconciles parked on one of them (guard: _dedup_lock).  A
        # reconcile arriving while the ORIGINAL direct execution is still
        # running must neither re-execute (double side effects) nor drop
        # (the raylet awaits a done): it defers, and remember() answers
        # it with the recorded result at completion.
        self._inflight: set = set()
        self._deferred: set = set()
        self._conns: List[_DirectConn] = []  # guard: _conns_lock
        self._conns_lock = make_lock("direct.server.conns")
        # Freeze detector: last_tick is advanced by the ticker thread; any
        # thread observing a gap beyond the gate marks live conns stale
        # BEFORE the tick resets (see _tick_loop), so buffered frames from
        # before a SIGSTOP can never race past the check.
        self.last_tick = time.monotonic()
        for lsock in self._listeners:
            threading.Thread(target=self._accept_loop, args=(lsock,),
                             name="direct-accept", daemon=True).start()
        threading.Thread(target=self._tick_loop, name="direct-ticker",
                         daemon=True).start()

    # ---- freeze detection ----

    def _tick_loop(self):
        while True:
            time.sleep(0.1)
            gap = time.monotonic() - self.last_tick
            if gap > config.direct_freeze_gate_s:
                self._mark_stale()
            self.last_tick = time.monotonic()

    def _mark_stale(self):
        with self._conns_lock:
            for conn in self._conns:
                conn.stale = True

    def _conn_is_stale(self, conn: _DirectConn) -> bool:
        if time.monotonic() - self.last_tick > config.direct_freeze_gate_s:
            # this thread saw the gap first: fence every conn (including
            # this one) before the ticker resets the clock
            self._mark_stale()
        return conn.stale

    # ---- dedup cache ----

    def remember(self, task_id, done: dict):
        # Stored by reference, not copied: _deliver_result hands the done
        # dict here and never mutates it afterwards (its wire sends copy
        # first), and every reader (lookup / admit / reconcile_probe /
        # the deferred answer below) copies before stamping t/task_id.
        rec = done
        with self._dedup_lock:
            self._dedup[task_id] = rec
            self._inflight.discard(task_id)
            deferred = task_id in self._deferred
            self._deferred.discard(task_id)
            while len(self._dedup) > config.direct_dedup_cache:
                self._dedup.popitem(last=False)
        if deferred:
            # a raylet-path reconcile parked on this execution: answer its
            # dispatch with the recorded result (never a second run)
            ans = dict(rec)
            ans["t"] = "done"
            ans["task_id"] = task_id
            self._worker.send_done(ans)

    def lookup(self, task_id) -> Optional[dict]:
        with self._dedup_lock:
            rec = self._dedup.get(task_id)
            return dict(rec) if rec is not None else None

    def admit(self, task_id):
        """Atomic dedup-or-mark-inflight for an arriving dcall: returns
        (cached, busy) — a cached result to re-send, or busy=True when
        the same task is already queued/executing here (the caller must
        reconcile via the raylet, not run it twice).  busy shouldn't
        happen with the reconcile-only retry flow, but a second direct
        submission of an in-flight task must never execute."""
        with self._dedup_lock:
            rec = self._dedup.get(task_id)
            if rec is not None:
                return dict(rec), False
            if task_id in self._inflight:
                return None, True
            self._inflight.add(task_id)
            return None, False

    def reconcile_probe(self, task_id):
        """For a raylet-dispatched spec: (cached, deferred).  cached =>
        already executed directly, re-send the recorded done; deferred =>
        the direct execution is in flight and remember() will answer this
        dispatch at completion — the caller skips execution either way."""
        with self._dedup_lock:
            rec = self._dedup.get(task_id)
            if rec is not None:
                return dict(rec), False
            if task_id in self._inflight:
                self._deferred.add(task_id)
                return None, True
            return None, False

    # ---- accept / per-conn reader ----

    def _accept_loop(self, listener):
        while True:
            try:
                sock, _ = listener.accept()
            except OSError:
                return
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass  # unix socket
            try:
                # Send timeout only (recv stays blocking): the caller
                # demuxes results from get()/submit(), so a caller that
                # stops consuming could otherwise wedge this worker in
                # sendall once the kernel buffer fills.  On expiry the
                # conn drops; the raylet path (direct_done already sent)
                # still serves the results.
                import struct as _struct

                sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                                _struct.pack("ll", 10, 0))
            except OSError:
                pass
            conn = _DirectConn(sock)
            with self._conns_lock:
                self._conns.append(conn)
            threading.Thread(target=self._conn_loop, args=(conn,),
                             name="direct-serve", daemon=True).start()

    def _check_hello(self, msg: dict) -> Optional[str]:
        """None = accepted; else the rejection reason (the fencing seam:
        a stale caller — old incarnation, or a generation from before the
        actor's last restart — must never get calls executed here)."""
        worker = self._worker
        if msg.get("incarnation", 0) < self.node_incarnation:
            return "stale node incarnation (fenced)"
        aid = msg.get("actor_id")
        if aid is not None:
            if worker.actor_instance is None \
                    or worker.current_actor_id != aid:
                return "worker hosts no such actor"
            if msg.get("generation", 0) != worker.actor_generation:
                return "stale actor generation (restarted)"
        elif worker.actor_instance is not None:
            return "worker is an actor, not leasable"
        else:
            # Lease channel: the raylet told us which lease it granted
            # (direct_lease control message) — a dialer without that
            # exact token must not execute tasks here, or it would
            # bypass the raylet's resource accounting entirely.  The
            # grant rides the raylet→worker socket while the caller
            # dials on the lease reply, so tolerate a short in-flight
            # window before rejecting.
            lid = msg.get("lease_id")
            if lid is None:
                return "no lease presented"
            deadline = time.monotonic() + 1.0
            while getattr(worker, "active_lease_id", None) != lid:
                if time.monotonic() > deadline:
                    return "lease not granted by the raylet"
                time.sleep(0.005)
        return None

    def _handle_call(self, conn: _DirectConn, msg: dict, trailing: bool):
        """One dcall (possibly unpacked from a dburst frame): dedup-admit
        and execute inline / enqueue.  ``trailing`` = more calls are
        already decoded behind this one, so results (and burst-mode
        raylet notes) coalesce into the train's batched flush."""
        spec: TaskSpec = msg["spec"]
        if self._conn_is_stale(conn) or conn.hello is None:
            # frames possibly buffered across a freeze (or a
            # caller skipping the handshake): refuse — the
            # caller reconciles via the raylet path
            conn.send_result({"t": "dresult",
                              "task_id": spec.task_id,
                              "ok": False, "rejected": True})
            return
        cached, busy = self.admit(spec.task_id)
        if cached is not None:
            # retried call whose first execution completed:
            # re-send the recorded result, never re-execute
            cached["t"] = "dresult"
            cached["task_id"] = spec.task_id
            conn.send_result(cached)
            return
        if busy:
            # already queued/executing here (duplicate direct
            # submission): refuse — the caller reconciles via
            # the raylet, which defers on the same execution
            conn.send_result({"t": "dresult",
                              "task_id": spec.task_id,
                              "ok": False, "rejected": True})
            return
        task_msg = {"t": "task", "spec": spec,
                    "arg_values": msg.get("arg_values") or {},
                    "direct_conn": conn}
        worker = self._worker
        if (worker.actor_loop is None
                and worker.group_executors is None
                and worker.actor_executor is None):
            # Plain sync actor / leased pool worker: execute
            # RIGHT HERE on the conn thread — the queue
            # handoff to the main executor thread is a full
            # scheduler wakeup of dead time per call.  The
            # exec lock serializes against the main loop, so
            # single-threaded execution semantics hold.
            from ray_tpu_torch.core import worker_main

            # results coalesce while more calls are decoded
            # and waiting (one sendall per burst train; the
            # loop top flushes when the train drains)
            task_msg["_inline"] = True
            task_msg["_rx_t"] = time.time()
            conn.coalesce = trailing
            with worker.exec_lock:
                worker_main.execute_task(worker, task_msg)
        else:
            # asyncio / concurrency-group actors: route
            # through the main loop's dispatch logic
            worker.task_queue.put(task_msg)

    def _conn_loop(self, conn: _DirectConn):
        reader = protocol.FrameReader(conn.sock)
        try:
            while True:
                if not reader._pending:
                    # end of a decoded train: ship any coalesced results
                    # (and buffered raylet notes) before blocking for the
                    # next frame
                    conn.coalesce = False
                    conn.flush_results()
                    conn.flush_notes(self._worker)
                try:
                    msg = reader.recv_msg()
                except (OSError, protocol.ProtocolError):
                    msg = None
                if msg is None:
                    break
                t = msg.get("t")
                if t == "dhello":
                    reason = self._check_hello(msg)
                    conn.hello = msg
                    conn.send_result({"t": "dhello_ack",
                                      "ok": reason is None,
                                      "reason": reason,
                                      "pid": os.getpid()})
                    if reason is not None:
                        break
                elif t == "dcancel":
                    # cancel frame for a call submitted on THIS channel:
                    # mark it in the in-flight registry (pre-exec check)
                    # and interrupt it if it is executing right now on a
                    # pool/loop thread (actor channels).  Lease channels
                    # execute dcalls INLINE on this very conn thread, so
                    # a same-channel dcancel is only read after the call
                    # finishes — mid-exec interrupts for those arrive via
                    # the raylet's control-socket cancel frame instead
                    # (the reader thread delivers the async exception).
                    self._worker.cancel_registry.cancel(msg["task_id"])
                elif t == "dcall":
                    self._handle_call(conn, msg, bool(reader._pending))
                elif t == "dburst":
                    # one coalesced flush window from the caller: unpack
                    # in order; every call but the last has decoded work
                    # behind it by construction
                    calls = msg["calls"]
                    last = len(calls) - 1
                    for i, sub in enumerate(calls):
                        if sub.get("t") == "dcancel":
                            # a cancel queued ahead of its (still
                            # unflushed) dcall rides the same frame
                            self._worker.cancel_registry.cancel(
                                sub["task_id"])
                            continue
                        self._handle_call(conn, sub,
                                          i < last or bool(reader._pending))
        finally:
            # notes record executions that HAPPENED — they must reach the
            # raylet even when the caller hangs up mid-train
            conn.flush_notes(self._worker)
            conn.alive = False
            try:
                conn.sock.close()
            except OSError:
                pass
            with self._conns_lock:
                try:
                    self._conns.remove(conn)
                except ValueError:
                    pass

    def close(self):
        for lsock in self._listeners:
            try:
                lsock.close()
            except OSError:
                pass
        try:
            os.unlink(self.unix_path)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Caller side


class _Pending:
    """One in-flight direct call, resolved by the channel reader (result)
    or by teardown (fallback via the raylet path)."""

    __slots__ = ("event", "spec", "ctx", "t_sent", "fallback", "done")

    def __init__(self, spec: TaskSpec, ctx):
        # ``done`` is the resolution flag; ``event`` is allocated LAZILY,
        # only when a second thread actually parks on this entry — the
        # common burst case (one thread submits AND demuxes) never pays
        # the three allocations inside threading.Event().  Writers set
        # ``done`` BEFORE reading ``event``; a parking thread installs
        # ``event`` under the channel lock and re-checks ``done`` after,
        # so no wake-up can be lost (GIL-atomic attribute stores).
        self.event: Optional[threading.Event] = None
        self.done = False
        self.spec = spec
        self.ctx = ctx  # sampled trace ctx or None (unsampled fast path)
        self.t_sent = 0.0
        self.fallback = False

    def resolve(self):
        """Mark resolved and wake any parked waiter (done-then-event
        order pairs with _await's install-then-recheck)."""
        self.done = True
        ev = self.event
        if ev is not None:
            ev.set()


class _Channel:
    """A dialed caller→callee connection (one per actor or lease).

    No standing reader thread: the socket is demuxed by whichever caller
    thread is waiting in ``get()`` (``_await`` takes ``recv_lock`` and
    recv's until its own result lands, dispatching everyone else's on
    the way), so the result wakes the actual waiter straight out of the
    kernel — no reader→getter handoff, no idle thread churning the GIL.
    Fire-and-forget bursts stay deadlock-free because ``submit`` drains
    the socket opportunistically once enough calls are in flight, and a
    caller that neither gets nor submits leaves results in the kernel
    buffer — bounded by the callee's send timeout, after which the
    callee drops the conn and the raylet path (already notified via
    direct_done) serves the results."""

    def __init__(self, mgr: "DirectCallClient", key, info: dict):
        self.mgr = mgr
        self.key = key  # ActorID, or ("lease", shape) for task leases
        self.node_id = info.get("node_id")
        self.generation = info.get("generation", 0)
        self.lease_id = info.get("lease_id")
        self.lock = make_lock("direct.channel.state")
        self.send_lock = make_lock("direct.channel.send")
        self.recv_lock = make_lock("direct.channel.recv")
        # Serializes sendbuf-swap + wire write: two racing flushes must
        # hit the socket in swap order or per-handle FIFO breaks.
        self.flush_lock = make_lock("direct.channel.flush")
        self.pending: "OrderedDict[Any, _Pending]" = OrderedDict()  # guard: lock
        self.alive = True  # guard: lock
        # Observed per-call turnover (decode→result at the callee, EWMA
        # seconds) — burst mode pipelines a lease channel only below
        # direct_lease_turnover_ms (guard: lock)
        self.turnover_ewma: Optional[float] = None
        # Outbound dcall frames awaiting coalesced flush (guard: lock):
        # a burst of submits ships as ONE sendall — flushed inline at 16,
        # by the first get()'s resolve, or by the manager's micro-flusher
        # (sub-ms) for pure fire-and-forget, so a call can never sit
        # unsent indefinitely.
        self.sendbuf: List[dict] = []
        self.last_used = time.monotonic()
        self.sock = self._dial(info)
        self._reader = protocol.FrameReader(self.sock)  # guard: recv_lock

    def _dial(self, info: dict) -> socket.socket:
        addr = info["addr"]
        timeout = max(0.1, config.direct_connect_timeout_s)
        unix = addr.get("unix")
        sock = None
        if unix and addr.get("hostname") == socket.gethostname() \
                and os.path.exists(unix):
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.settimeout(timeout)
            try:
                sock.connect(unix)
            except OSError:
                sock.close()
                sock = None
        if sock is None:
            tcp = addr.get("tcp")
            if not tcp:
                raise OSError("no dialable direct address")
            sock = socket.create_connection(tuple(tcp), timeout=timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            protocol.send_msg(sock, {
                "t": "dhello",
                "caller": self.mgr.worker_id_hex,
                "actor_id": self.key if not isinstance(self.key, tuple)
                else None,
                "generation": self.generation,
                "incarnation": info.get("incarnation", 0),
                "lease_id": self.lease_id,
            })
            ack = protocol.recv_msg(sock)
        except (OSError, protocol.ProtocolError):
            sock.close()
            raise OSError("direct hello failed")
        if not isinstance(ack, dict) or not ack.get("ok"):
            sock.close()
            reason = ack.get("reason") if isinstance(ack, dict) else "EOF"
            raise OSError(f"direct hello rejected: {reason}")
        sock.settimeout(None)
        return sock

    # ---- submit / results ----

    def submit(self, spec: TaskSpec, ctx) -> bool:
        """Ship one call, or return False to hand it to the relayed path.

        Burst mode (default): past ``direct_burst_window`` unacked calls
        the submitting thread demuxes the channel socket to advance the
        ack window — each dresult acks one slot — so a deep
        fire-and-forget burst pipelines over the one FIFO socket with
        ≤W in flight and never falls back mid-burst.

        Kill switch (RAY_TPU_DIRECT_BURST=0) restores the pre-burst
        behavior exactly: the direct channel is a LATENCY transport, and
        past direct_pipeline_depth in flight the window is drained as an
        ordering barrier and the burst handed back to the raylet, which
        out-runs a single submitting thread at depth.  Re-engagement
        (all completions observed) restores the direct path for the next
        call/response phase."""
        if config.direct_burst:
            if not self._advance_window(max(1, config.direct_burst_window)):
                return False
        else:
            cap = max(1, config.direct_pipeline_depth)
            with self.lock:
                over = self.alive and len(self.pending) >= cap
            if over:
                self._drain_all()
                return False
        entry = _Pending(spec, ctx)
        entry.t_sent = time.time()
        with self.lock:
            if not self.alive:
                return False
            self.pending[spec.task_id] = entry
            depth = len(self.pending)
            self.last_used = time.monotonic()
            self.sendbuf.append({"t": "dcall", "spec": spec})
            # half-window flush matches _advance_window's half-window
            # drain: a steady-state burst alternates one dburst frame of
            # W/2 calls with one demux round of W/2 acks
            flush_now = (depth == 1
                         or len(self.sendbuf)
                         >= max(1, config.direct_burst_window // 2))
        if flush_now:
            # an empty pipeline means a latency-sensitive caller (sync
            # call loop): put the frame on the wire NOW
            self.flush()
        else:
            # fire-and-forget: the manager's micro-flusher ships it if no
            # get()/follow-up submit does first
            self.mgr._arm_flusher()
        if ctx is not None:
            from ray_tpu_torch.util import tracing

            tracing.hop("worker.direct_send", ctx, entry.t_sent,
                        time.time(), task_id=spec.task_id.hex())
        return True

    def _drain_all(self):
        """Ordering barrier: block until every in-flight direct call on
        this channel resolved, so a call relayed next cannot overtake
        one still queued at the callee."""
        while True:
            with self.lock:
                if not self.alive or not self.pending:
                    return
                oldest = next(iter(self.pending.values()))
            self._await(oldest, None)

    def _advance_window(self, cap: int) -> bool:
        """Windowed ack (burst mode): when ``cap`` calls are unacked,
        demux the socket on this very thread — each dresult is the ack —
        until the window is HALF empty, then resume submitting.  The
        half-window hysteresis is what makes coalescing work: draining
        just one slot per submit would interleave flush/demux with every
        call and put one frame per call on the wire; draining to cap/2
        lets the next cap/2 submits pile into the sendbuf and ship as a
        single dburst frame, which in turn arrives at the callee as a
        coalesced train (batched notes, batched result flush).  No
        per-call round trip, no relayed hand-back.  False = the channel
        died while advancing (the caller relays, and teardown has
        already reconciled the window)."""
        with self.lock:
            if not self.alive:
                return False
            if len(self.pending) < cap:
                return True
        target = max(cap // 2, 1)
        while True:
            with self.lock:
                if not self.alive:
                    return False
                if len(self.pending) < target:
                    return True
                oldest = next(iter(self.pending.values()))
            self._await(oldest, None)

    def poll(self):
        """Opportunistic non-blocking demux: drain any dresults already
        decoded or sitting in the kernel buffer, without waiting.  Lets
        a fan-out loop that is still relaying (lease turnover unknown)
        observe completions — and their dur stamps — so burst
        pipelining can engage mid-loop."""
        if not self.recv_lock.acquire(blocking=False):
            return  # another thread is demuxing already
        try:
            while True:
                if not self._reader._pending:  # unguarded-ok: recv_lock IS held — manual try-acquire above, invisible to the lexical pass
                    try:
                        ready, _, _ = select.select([self.sock], [], [], 0)
                    except (OSError, ValueError):
                        return  # socket closed under us: teardown owns it
                    if not ready:
                        return
                try:
                    msg = self._reader.recv_msg()  # unguarded-ok: recv_lock IS held — manual try-acquire above, invisible to the lexical pass
                except (OSError, protocol.ProtocolError):
                    msg = None
                if msg is None:
                    self.teardown("connection closed")
                    return
                if not self._dispatch(msg):
                    return
        finally:
            self.recv_lock.release()

    def flush(self):
        if not self.sendbuf:  # unguarded-ok: GIL-atomic emptiness peek; the locked re-check below decides
            # fast path: _await/_advance_window call flush once per
            # demuxed entry — a burst drain would otherwise pay two lock
            # rounds per ack just to discover there is nothing to send
            return
        # flush_lock spans swap + write: a racing pair of flushes (micro-
        # flusher vs. a get()'s _await) must reach the wire in swap order
        # or per-handle FIFO breaks
        with self.flush_lock:
            with self.lock:
                if not self.sendbuf:
                    return
                out, self.sendbuf = self.sendbuf, []
            if len(out) > 1 and config.direct_burst:
                # one dburst frame per flush window: pickling the specs
                # together memoizes shared strings (function/module
                # names, resource keys) across the burst instead of
                # paying them per call
                out = [{"t": "dburst", "calls": out}]
            try:
                protocol.send_msgs(self.sock, out, self.send_lock)
            except OSError:
                self.teardown("send failed")  # reconciles every pending call

    def idle(self) -> bool:
        with self.lock:
            return not self.pending

    # ---- demux (runs on whichever thread needs a result) ----

    def _dispatch(self, msg: dict) -> bool:
        """Handle one inbound frame; False = channel torn down."""
        if msg.get("t") != "dresult":
            return True
        if msg.get("rejected"):
            # callee refused (freeze gate / stale conn): everything in
            # flight reconciles via the raylet, which dedups/fences
            self.teardown("rejected by callee")
            return False
        with self.lock:
            entry = self.pending.pop(msg["task_id"], None)
            self.last_used = time.monotonic()
            dur = msg.get("dur")
            if dur is not None:
                # callee-stamped decode→result turnover: the evidence the
                # lease-pipelining gate (_fast_turnover) runs on
                ew = self.turnover_ewma
                self.turnover_ewma = dur if ew is None \
                    else ew * 0.8 + dur * 0.2
        if entry is None:
            return True
        spec = entry.spec
        mgr = self.mgr
        results = {}
        if msg["ok"]:
            for h, blob in (msg.get("inline") or {}).items():
                results[h] = ("inline", blob)
            for h in (msg.get("stored") or ()):
                results[h] = ("store",)
        else:
            err = msg.get("error")
            for oid in spec.return_ids():
                results[oid.hex()] = ("error", err)
        mgr._store_results(results)
        entry.resolve()
        mgr._release_inner_refs(spec)
        if entry.ctx is not None:
            from ray_tpu_torch.util import tracing

            now = time.time()
            tracing.hop("worker.direct_result", entry.ctx,
                        max(entry.t_sent, now - 1e-6), now,
                        task_id=spec.task_id.hex())
        return True

    def _await(self, entry: _Pending, deadline: Optional[float]):
        """Block until ``entry`` resolves: the first waiter becomes the
        channel's demultiplexer (recv's straight off the socket —
        results wake the real waiter out of the kernel, no reader-thread
        handoff); others park on their event and re-bid for the recv
        lock on a short period."""
        from ray_tpu_torch.core.exceptions import GetTimeoutError

        self.flush()  # anything still coalescing must be on the wire
        while not entry.done:
            if deadline is not None and time.monotonic() >= deadline:
                raise GetTimeoutError(
                    "get() timed out waiting on a direct call")
            if not self.recv_lock.acquire(blocking=False):
                # someone else demuxes; they will wake us.  Install the
                # entry's (lazy) event first, then re-check done — the
                # resolver sets done BEFORE reading event, so this order
                # cannot miss the wake-up.
                ev = entry.event
                if ev is None:
                    with self.lock:
                        ev = entry.event
                        if ev is None:
                            entry.event = ev = threading.Event()
                    if entry.done:
                        continue
                ev.wait(0.02)
                continue
            try:
                while not entry.done:
                    if not self._reader._pending:  # unguarded-ok: recv_lock IS held — manual try-acquire above, invisible to the lexical pass
                        # only hit the kernel when the reader's decoded
                        # backlog is empty — a chunked recv decodes many
                        # results at once and select() knows nothing
                        # about them
                        if deadline is not None:
                            budget = deadline - time.monotonic()
                            if budget <= 0:
                                raise GetTimeoutError(
                                    "get() timed out waiting on a direct "
                                    "call")
                        else:
                            budget = None
                        # bounded block so a teardown (fence) or deadline
                        # is noticed even if the socket close loses the
                        # race with our select()
                        try:
                            ready, _, _ = select.select(
                                [self.sock], [], [],
                                1.0 if budget is None else min(1.0, budget))
                        except (OSError, ValueError):
                            ready = None  # socket closed under us
                        with self.lock:
                            alive = self.alive
                        if not alive:
                            return  # teardown resolved every pending entry
                        if ready is None:
                            self.teardown("connection closed")
                            return
                        if not ready:
                            continue
                    try:
                        msg = self._reader.recv_msg()  # unguarded-ok: recv_lock IS held — manual try-acquire above, invisible to the lexical pass
                    except (OSError, protocol.ProtocolError):
                        msg = None
                    if msg is None:
                        self.teardown("connection closed")
                        return
                    if not self._dispatch(msg):
                        return
            finally:
                self.recv_lock.release()

    # ---- failure handling ----

    def teardown(self, reason: str):
        """Kill the channel and reconcile in-flight calls via the raylet
        path: each pending spec is resubmitted with ``_direct_retry`` —
        already-delivered results are skipped raylet-side, a restarted
        actor fences on the generation (retryable ActorDiedError), and a
        live same-generation actor re-runs at most once, deduped by the
        callee's executed-result cache."""
        with self.lock:
            if not self.alive:
                return
            self.alive = False
            drain = list(self.pending.values())
            self.pending.clear()
            self.sendbuf = []  # unsent calls reconcile like sent ones
        try:
            # shutdown (not just close) wakes any demuxer blocked in
            # select/recv on another thread
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        mgr = self.mgr
        mgr._drop_channel(self)
        if self.lease_id is not None:
            mgr._release_lease(self)
        for entry in drain:
            spec = entry.spec
            spec._direct_retry = True
            spec._direct_generation = self.generation
            entry.fallback = True
            try:
                mgr._resubmit(spec)
            except Exception:  # noqa: BLE001 — shutdown races
                pass
            # the reconcile rides the relayed path: arm the engagement
            # watermark so a re-dialed channel (same or bumped
            # generation) cannot overtake a partially-acked window —
            # the direct path re-engages only after these are observed
            # delivered (no-op for lease/normal specs)
            mgr._note_relayed(spec)
            entry.resolve()
            mgr._release_inner_refs(spec)


class DirectCallClient:
    """Caller-side direct transport: channel cache + pending table +
    raylet-path fallback, shared by drivers (in-process raylet), remote
    drivers, and worker processes (their adapters differ, the state
    machine doesn't)."""

    def __init__(self, worker, broker: Callable[[Any], Optional[dict]],
                 resubmit: Callable[[TaskSpec], None],
                 lease: Optional[Callable[[TaskSpec], Optional[dict]]] = None,
                 lease_release: Optional[Callable[[str], None]] = None):
        self._worker = worker
        self.worker_id_hex = worker.worker_id.hex()
        self._broker = broker
        self._resubmit = resubmit
        self._lease = lease
        self._lease_release = lease_release
        self._lock = make_lock("direct.client")
        self._channels: Dict[Any, _Channel] = {}  # guard: _lock
        # Per-actor engagement state (guard: _lock): switching to the
        # direct path is order-safe once every previously relayed call
        # has been DELIVERED to the worker.  Relay delivery is FIFO per
        # caller (driver → raylet inbox → actor queue → socket), so one
        # WATERMARK per actor suffices: the last relayed call's return
        # oid — observing its (non-error) result implies every earlier
        # relayed call was delivered.  O(1) state per actor; a
        # fire-and-forget burst of any size re-engages after one get.
        self._actors: Dict[Any, dict] = {}
        # watermark return-oid hex -> actor_id (one live entry per actor)
        self._last_relayed: Dict[str, Any] = {}
        self._results: "OrderedDict[str, tuple]" = OrderedDict()
        self._closed = False
        self._sweeper_started = False
        # send-coalescing micro-flusher (lazy): ships buffered dcalls a
        # few hundred µs after a fire-and-forget submit if no get() or
        # follow-up submit flushed them first
        self._flush_event = threading.Event()
        self._flusher_started = False

    # ------------------------------------------------------------- submit

    def try_submit(self, spec: TaskSpec) -> bool:
        """True = the call rides (or was reconciled through) the direct
        path and must NOT be relayed by the caller; False = relay."""
        if self._closed or not config.direct_calls:
            # still record the watermark: if the kill switch is flipped
            # back on, a surviving channel must not re-engage until these
            # relayed calls are observed delivered (per-handle FIFO)
            self._note_relayed(spec)
            return False
        if spec.kind == ACTOR_TASK:
            return self._submit_actor(spec)
        if spec.kind == NORMAL_TASK and self._lease is not None:
            return self._submit_task(spec)
        return False

    def _eligible_actor_call(self, spec: TaskSpec) -> bool:
        return (spec.num_returns != STREAMING_RETURNS
                and spec.method_name != "__ray_terminate__"
                and not spec.dependency_ids())

    def _submit_actor(self, spec: TaskSpec) -> bool:
        aid = spec.actor_id
        if aid is None or not self._eligible_actor_call(spec):
            self._note_relayed(spec)
            return False
        ch = self._channels.get(aid)  # unguarded-ok: GIL-atomic probe, re-checked under the channel lock in submit()
        if ch is None or not ch.alive:
            ch = self._maybe_engage(aid)
            if ch is None:
                self._note_relayed(spec)
                return False
        else:
            st = self._actors.get(aid)
            if st is not None and st["last"] is not None:  # unguarded-ok: GIL-atomic read; a stale watermark just relays one more call
                # earlier calls took the relayed path (deep-burst
                # hand-back) and their delivery is not yet confirmed:
                # relaying this one too preserves per-handle order
                self._note_relayed(spec)
                return False
        self._pin_inner_refs(spec)
        if ch.submit(spec, _trace_ctx(spec)):
            return True
        # teardown race or window-full hand-back: relay
        self._release_inner_refs(spec)
        self._note_relayed(spec)
        return False

    def _maybe_engage(self, aid) -> Optional[_Channel]:
        """Broker + dial a direct channel for an actor — only once every
        previously relayed call has been observed complete (per-handle
        FIFO order survives the switch) and outside any backoff window."""
        now = time.monotonic()
        with self._lock:
            st = self._actors.get(aid)
            if st is None or st["last"] is not None or st["completed"] == 0:
                return None
            if now < st["next_try"]:
                return None
            ch = self._channels.get(aid)
            if ch is not None and ch.alive:
                return ch
            st["next_try"] = now + 0.25  # armed before the blocking dial
        try:
            info = self._broker(aid)
        except Exception:  # noqa: BLE001 — raylet busy/shutdown: relay
            info = None
        if not info:
            return None
        try:
            ch = _Channel(self, aid, info)
        except _DIAL_ERRORS:
            return None
        with self._lock:
            cur = self._channels.get(aid)
            if cur is not None and cur.alive:
                dup = ch
                ch = cur
            else:
                self._channels[aid] = ch
                dup = None
        if dup is not None:
            try:
                dup.sock.close()
            except OSError:
                pass
        return ch

    # ---- lease-reused normal tasks ----

    def _eligible_task(self, spec: TaskSpec) -> bool:
        return (spec.num_returns == 1
                and not spec.dependency_ids()
                and not spec.placement
                and spec.runtime_env is None
                and not spec.retry_exceptions)

    def _submit_task(self, spec: TaskSpec) -> bool:
        if not self._eligible_task(spec):
            return False
        key = ("lease", tuple(sorted((spec.resources or {}).items())))
        ch = self._channels.get(key)  # unguarded-ok: GIL-atomic probe, re-checked under the channel lock in submit()
        if ch is None or not ch.alive:
            ch = self._maybe_lease(key, spec)
            if ch is None:
                return False
        # Serial reuse by default: a fan-out must spread over the pool,
        # not serialize onto one leased worker — the lease accelerates
        # call→result→call loops, the raylet keeps everything parallel.
        # Burst mode pipelines a call onto a busy channel only where
        # _fast_turnover finds the channel fast in the past AND now, and
        # the call's function proven fast: sub-ms tasks gain more from
        # pipelined submission than from per-task raylet dispatch, while
        # unknown or slow work keeps the spread — a short call never
        # queues behind a long one on the leased worker.
        st = self._actors.get(key)  # unguarded-ok: GIL-atomic probe; _maybe_lease made the entry before the channel, and nothing removes it
        fn = spec.function_id or spec.name
        if not ch.idle():
            if not (config.direct_burst and self._fast_turnover(ch, st, fn)):
                ch.poll()  # gather turnover evidence without blocking
                return False
        self._pin_inner_refs(spec)
        if ch.submit(spec, _trace_ctx(spec)):
            if st is not None:
                # the function's first direct call on this lease shape is
                # its probe: once it has left the channel's pending table
                # (resolved), the function has turned over here (None)
                st.setdefault("probes", {}).setdefault(fn, spec.task_id)
            return True
        self._release_inner_refs(spec)
        return False

    def _fast_turnover(self, ch: _Channel, st: Optional[dict], fn) -> bool:
        """May a call of ``fn`` be pipelined behind the calls in flight on
        the busy lease channel ``ch``?  Three probes, each against
        direct_lease_turnover_ms:

        - the past: the channel's turnover EWMA (callee-stamped) is under
          it;
        - the present: the oldest call in flight has been out for less
          than it, beyond the time the calls in flight take at that
          EWMA (the callee returns a pipelined train's results together)
          — a call that has run longer may run much longer, and whatever
          queues behind it waits as long;
        - the function: a direct call of ``fn`` on this lease shape has
          completed before (its probe left ``ch.pending``); the EWMA is
          the channel's, and a function never seen here may sleep.

        GIL-atomic reads, no lock on the burst's hot path: staleness costs
        at most one relayed or one pipelined call."""
        limit = config.direct_lease_turnover_ms / 1000.0
        ew = ch.turnover_ewma  # unguarded-ok: GIL-atomic read; staleness costs at most one relayed call
        if ew is None or ew > limit or st is None:
            return False
        try:
            oldest = next(iter(ch.pending.values()))  # unguarded-ok: GIL-atomic probe; a concurrent mutation raises and relays this call
        except (StopIteration, RuntimeError):
            return False
        depth = len(ch.pending)  # unguarded-ok: GIL-atomic read
        if time.time() - oldest.t_sent > limit + depth * ew:
            return False
        probes = st.get("probes")
        if probes is None or fn not in probes:
            return False
        probe = probes[fn]
        if probe is not None:
            if probe in ch.pending:  # unguarded-ok: GIL-atomic membership probe
                return False
            probes[fn] = None
        return True

    def _maybe_lease(self, key, spec: TaskSpec) -> Optional[_Channel]:
        now = time.monotonic()
        with self._lock:
            st = self._actors.setdefault(key, {"last": None, "completed": 1,
                                               "next_try": 0.0})
            if now < st["next_try"]:
                return None
            ch = self._channels.get(key)
            if ch is not None and ch.alive:
                return ch
            st["next_try"] = now + 0.25
        try:
            info = self._lease(spec)
        except Exception:  # noqa: BLE001
            info = None
        if not info:
            return None
        try:
            ch = _Channel(self, key, info)
        except _DIAL_ERRORS:
            # the worker never saw a usable channel: hand the lease back
            if self._lease_release is not None:
                try:
                    self._lease_release(info["lease_id"])
                except Exception:  # noqa: BLE001
                    pass
            return None
        with self._lock:
            self._channels[key] = ch
            need_sweeper = not self._sweeper_started
            self._sweeper_started = True
        if need_sweeper:
            threading.Thread(target=self._lease_sweep_loop,
                             name="direct-lease-sweep", daemon=True).start()
        return ch

    def _lease_sweep_loop(self):
        """Return idle leases to the pool so a quiet caller never holds a
        worker (and its resources) beyond direct_lease_idle_s."""
        while not self._closed:
            time.sleep(max(0.2, config.direct_lease_idle_s / 2))
            now = time.monotonic()
            with self._lock:
                idle = [ch for ch in self._channels.values()
                        if ch.lease_id is not None and ch.alive
                        and not ch.pending
                        and now - ch.last_used > config.direct_lease_idle_s]
            for ch in idle:
                with ch.lock:
                    if ch.pending or not ch.alive:
                        continue
                    ch.alive = False
                try:
                    ch.sock.close()
                except OSError:
                    pass
                self._drop_channel(ch)
                self._release_lease(ch)

    def _arm_flusher(self):
        if not self._flusher_started:
            with self._lock:
                if not self._flusher_started:
                    self._flusher_started = True
                    threading.Thread(target=self._send_flush_loop,
                                     name="direct-send-flush",
                                     daemon=True).start()
        ev = self._flush_event
        if not ev.is_set():
            # skip the condition-variable round when already armed — a
            # burst re-arms once per flusher wake-up, not once per submit
            ev.set()

    def _send_flush_loop(self):
        while not self._closed:
            self._flush_event.wait()
            self._flush_event.clear()
            time.sleep(0.0005)  # let a submit burst coalesce
            for ch in list(self._channels.values()):  # unguarded-ok: snapshot; flush() re-checks under the channel lock
                ch.flush()

    def _release_lease(self, ch: _Channel):
        if self._lease_release is None or ch.lease_id is None:
            return
        try:
            self._lease_release(ch.lease_id)
        except Exception:  # noqa: BLE001 — raylet gone / worker death raced
            pass

    # ------------------------------------------------------- bookkeeping

    def _pin_inner_refs(self, spec: TaskSpec):
        """Process-level holds for refs serialized inside inline args: the
        relayed path pins them raylet-side at submit; the direct path
        must keep them alive itself until the call completes (the hold
        events ride the ordinary ref-event stream, ordered ahead of any
        later release by this process)."""
        if not spec.inner_refs:
            return
        from ray_tpu_torch.core.worker import note_refs_created

        note_refs_created(spec.inner_refs)  # one lock round per submit

    def _release_inner_refs(self, spec: TaskSpec):
        if not spec.inner_refs or getattr(spec, "_inner_released", False):
            return
        spec._inner_released = True
        from ray_tpu_torch.core.worker import note_refs_dropped

        note_refs_dropped(spec.inner_refs)

    def _store_results(self, results: Dict[str, tuple]):
        with self._lock:
            self._results.update(results)
            while len(self._results) > config.direct_result_cache:
                self._results.popitem(last=False)

    def _drop_channel(self, ch: _Channel):
        with self._lock:
            if self._channels.get(ch.key) is ch:
                del self._channels[ch.key]

    def _note_relayed(self, spec: TaskSpec):
        if spec.kind != ACTOR_TASK or spec.actor_id is None:
            return
        with self._lock:
            st = self._actors.setdefault(
                spec.actor_id, {"last": None, "completed": 0,
                                "next_try": 0.0})
            prev = st["last"]
            if prev is not None:
                self._last_relayed.pop(prev, None)
            h = spec.return_ids()[0].hex()
            st["last"] = h
            self._last_relayed[h] = spec.actor_id

    def note_observed(self, oids, errored=None):
        """Called by get()/wait() when results are observed resolved.
        Observing the watermark (the LAST relayed call) clears the
        actor's relayed backlog: FIFO relay delivery means everything
        before it reached the worker, so switching to the direct path
        is order-safe.  An ERRORED watermark does not clear — a call
        failed at the raylet (dep error, dead actor) proves nothing
        about the delivery of its predecessors."""
        if not self._last_relayed:  # unguarded-ok: GIL-atomic emptiness probe; a miss only delays engagement one get
            return
        with self._lock:
            for oid in oids:
                h = oid.hex()
                aid = self._last_relayed.get(h)
                if aid is None:
                    continue
                if errored is not None and h in errored:
                    continue
                del self._last_relayed[h]
                st = self._actors.get(aid)
                if st is not None and st["last"] == h:
                    st["last"] = None
                    st["completed"] += 1

    # ------------------------------------------------------------- get()

    def resolve(self, oid, deadline: Optional[float]):
        """Resolve a direct-call return: a cached result tuple
        (("inline", blob) / ("error", err) / ("store",)), or None when
        the oid is unknown here or fell back to the raylet path.  Blocks
        while the call is in flight; raises GetTimeoutError past the
        deadline."""
        if not self._channels and not self._results:  # unguarded-ok: GIL-atomic emptiness probes (fast path for non-direct gets)
            return None
        h = oid.hex()
        # pop, don't peek: a delivered result is consumed exactly once
        # (a re-get falls back to the raylet path, where the callee's
        # direct_done already registered it) — otherwise a burst larger
        # than direct_result_cache evicts results the caller has not
        # read yet and every evictee pays a raylet round trip
        with self._lock:
            r = self._results.pop(h, None)
        if r is not None:
            return r
        tid = oid.task_id()
        entry = owner = None
        for ch in list(self._channels.values()):  # unguarded-ok: snapshot; a racing teardown resolves the entry anyway
            with ch.lock:
                entry = ch.pending.get(tid)
            if entry is not None:
                owner = ch
                break
        if entry is None:
            return None
        owner._await(entry, deadline)  # this thread demuxes the socket
        with self._lock:
            return self._results.pop(h, None)  # None => reconciled via raylet

    # ------------------------------------------------------------- cancel

    def cancel(self, oid) -> bool:
        """Cancel fan-out over the direct transport: if the call that
        produces ``oid`` is in flight on a dialed channel, ship a dcancel
        frame to the callee (its in-flight registry interrupts or
        pre-exec-fails the call; the ordinary dresult/raylet bookkeeping
        then carries the typed TaskCancelledError back).  Returns True
        when a channel had the call in flight."""
        tid = oid.task_id()
        for ch in list(self._channels.values()):  # unguarded-ok: snapshot; a racing teardown reconciles the call anyway
            queued = False
            with ch.lock:
                if tid not in ch.pending or not ch.alive:
                    continue
                for i, frame in enumerate(ch.sendbuf):
                    if frame.get("t") == "dcall" \
                            and frame["spec"].task_id == tid:
                        # the dcall is still coalescing in the burst
                        # buffer: queue the cancel IN FRONT of it, so the
                        # callee's registry marks the task before its
                        # pre-exec check ever runs
                        ch.sendbuf.insert(i, {"t": "dcancel",
                                              "task_id": tid})
                        queued = True
                        break
            ch.flush()  # the dcall itself must not sit behind the cancel
            if queued:
                return True
            try:
                protocol.send_msg(ch.sock, {"t": "dcancel", "task_id": tid},
                                  ch.send_lock)
            except OSError:
                ch.teardown("send failed")
                return False
            return True
        return False

    # ------------------------------------------------------------- fences

    def on_fence(self, msg: dict):
        """Raylet notice: an actor died/restarted or a node went
        SUSPECT/DEAD — tear down matching channels now so blocked
        callers reconcile instead of waiting out a partition."""
        actor_ids = set(msg.get("actor_ids") or ())
        node_id = msg.get("node_id")
        with self._lock:
            victims = [ch for ch in self._channels.values()
                       if ch.key in actor_ids
                       or (node_id is not None and ch.node_id == node_id)]
        for ch in victims:
            ch.teardown("fenced by raylet")

    def forget_actor(self, actor_id):
        """Proactive teardown on ray_tpu_torch.kill(): the kill travels the
        raylet path; direct frames must not race it."""
        ch = self._channels.get(actor_id)  # unguarded-ok: GIL-atomic probe; teardown re-checks under the channel lock
        if ch is not None:
            ch.teardown("actor killed")

    def close(self):
        self._closed = True
        self._flush_event.set()  # let the micro-flusher exit
        with self._lock:
            channels = list(self._channels.values())
            self._channels.clear()
        for ch in channels:
            with ch.lock:
                ch.alive = False
                drain = list(ch.pending.values())
                ch.pending.clear()
            try:
                ch.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                ch.sock.close()
            except OSError:
                pass
            for entry in drain:
                entry.resolve()
            if ch.lease_id is not None:
                self._release_lease(ch)
