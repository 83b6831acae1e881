"""The node manager ("raylet") — scheduler, worker pool, object directory.

Reference analogues, re-designed for a single event-loop thread living inside
the driver process rather than a separate daemon:

  * ``NodeManager``/``ClusterTaskManager``/``LocalTaskManager``
    (`src/ray/raylet/node_manager.h:119`, `scheduling/cluster_task_manager.h:42`,
    `scheduling/local_task_manager.h:58`) → ``Raylet`` event thread: ready
    queue, dependency-gated dispatch, resource accounting.
  * ``WorkerPool`` (`src/ray/raylet/worker_pool.h:156`) → profile-keyed pools
    of subprocess workers, spawned on demand and prestarted.
  * ``DependencyManager`` (`src/ray/raylet/dependency_manager.h:51`) →
    ``_dep_index``: tasks wait until every argument object is ready, so a
    dispatched task never blocks on args.
  * GCS tables (`src/ray/gcs/gcs_server/`) → in-process dicts: KV store,
    function table, named actors, node info.  (Multi-node: these move behind
    the same message schema over gRPC.)
  * ``GcsActorManager`` (`gcs_actor_manager.cc`) → ``_ActorState`` lifecycle
    with restart-on-death (max_restarts) and FIFO per-actor call queues.

All mutable state is owned by the event thread; the driver thread interacts
only through ``call()`` (a closure posted to the loop) and workers through
their sockets.
"""

from __future__ import annotations


import heapq
import itertools
import os
import queue as _queue
import random
import selectors
import socket
import subprocess
import sys
import threading
import time
import traceback
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core import protocol, serialization
import ray_tpu_torch.core.direct  # noqa: F401 — registers the RAY_TPU_DIRECT_* flags
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.exceptions import (
    ActorDiedError,
    BackPressureError,
    DeadlineExceededError,
    ObjectLostError,
    OutOfMemoryError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from ray_tpu_torch.core.gcs import GcsClient, GcsCore
from ray_tpu_torch.core.ids import ActorID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.task_spec import (
    ACTOR_CREATION_TASK,
    ACTOR_TASK,
    NORMAL_TASK,
    STREAMING_RETURNS,
    TaskSpec,
)
from ray_tpu_torch.util import chaos as _chaos
from ray_tpu_torch.util import metrics as _metrics_mod
from ray_tpu_torch.util import profiling as _profiling
from ray_tpu_torch.util import tracing as _tracing
from ray_tpu_torch.util.locks import make_lock
from ray_tpu_torch.util.retry import BackoffPolicy

config.define("gcs_reconnect_timeout_s", float, 0.0,
              "GCS fault tolerance: on a lost GCS connection, retry "
              "reconnecting for this long before shutting the node down "
              "(reference: raylet<->GCS reconnect in "
              "`test_gcs_fault_tolerance.py`).  0 = shut down immediately "
              "(the default; process trees reap cleanly in tests).")
config.define("gcs_reconnect_stagger_s", float, 0.75,
              "GCS mass-reconnect de-synchronizer: every raylet sees the "
              "GCS die at the same instant, so before the FIRST reconnect "
              "dial each sleeps uniform[0, this] — the thundering herd of "
              "dials + re-registrations spreads across the window instead "
              "of landing on the restarted GCS in lockstep.  Later "
              "attempts use the jittered exponential backoff policy.")
config.define("memory_monitor_interval_s", float, 0.0,
              "OOM prevention (reference: `memory_monitor.h:52`): poll "
              "host memory every interval and kill a worker above the "
              "threshold.  0 disables (tests/opt-in).")
config.define("memory_usage_threshold", float, 0.95,
              "Usage fraction above which the worker-killing policy fires "
              "(reference: RAY_memory_usage_threshold).")
config.define("memory_usage_file", str, "",
              "Test seam: read the usage fraction from this file instead "
              "of /proc/meminfo (chaos/OOM tests).")
config.define("spillback_max_hops", int, 4,
              "Max times a task may be forwarded between nodes before it "
              "must queue where it is (guards forward ping-pong).")
config.define("object_transfer_chunk_bytes", int, 4 << 20,
              "Chunk size for raylet-to-raylet object pulls (reference: "
              "chunked gRPC push/pull, object_manager.h:117).")
config.define("ref_free_grace_s", float, 2.0,
              "Delay between an object's ref count reaching zero and the "
              "actual free (covers refs in transit inside results).")
config.define("max_lineage_entries", int, 20000,
              "Max objects whose creating TaskSpec is retained for "
              "eviction recovery (reference: lineage byte caps).")
config.define("max_object_reconstructions", int, 5,
              "Per-object lineage-reconstruction budget (reference: "
              "RAY_max_object_reconstructions / task max_retries): how "
              "many times a lost object's creating task may be re-run "
              "before get() raises ObjectLostError.  Each reconstruction "
              "also draws down the spec's retries_left, so crash retries "
              "and reconstructions share one budget.")
config.define("max_reconstruction_depth", int, 8,
              "Recursion bound for reconstructing an object's missing "
              "dependencies (a lineage chain deeper than this errors "
              "instead of re-running unboundedly).")
config.define("pull_sender_threads", int, 2,
              "Bounded sender pool for the python-fallback pull path "
              "(control-plane chunk streams).  A burst of pulls queues "
              "behind these threads instead of spawning one thread per "
              "request; saturation is counted in "
              "ray_tpu_internal_pull_sender_saturated_total.")
config.define("replication_min_bytes", int, 0,
              "Eager availability (reference: secondary object copies, "
              "SURVEY §5 failure recovery): a store object sealed at or "
              "above this size on its producing node is immediately pushed "
              "to a second node over the data plane, so losing the holder "
              "costs a pull from the replica instead of a lineage "
              "recompute (and striping across both holders doubles read "
              "bandwidth).  0 disables the auto-threshold; explicitly "
              "flagged objects (put(..., _replicate=True) / the "
              "_replicate task option) and actor checkpoints replicate "
              "regardless.")
config.define("replication_factor", int, 2,
              "Total copies (primary included) eager replication creates "
              "and re-replication maintains after a holder dies.")
config.define("replication_verify_delay_s", float, 10.0,
              "Replication pushes are fire-and-forget; this long after a "
              "push round the producer re-checks the directory and "
              "re-pushes if targets never registered their copy (dead "
              "target, store-less node, abandoned pull).  Up to 2 "
              "re-push rounds per object.")
config.define("kill_checkpoint_grace_s", float, 10.0,
              "kill(actor, no_restart=False) on a checkpointable actor "
              "asks the worker for a final checkpoint + graceful exit; "
              "if the worker has not exited after this grace (wedged "
              "call, deep queue) it is SIGKILLed like a hard kill.")
config.define("locality_aware_min_bytes", int, 1 << 20,
              "Locality-aware placement (reference: locality_aware lease "
              "policy): a task whose remote arguments hold at least this "
              "many bytes on some peer — and more than are local here — "
              "is forwarded to that peer instead of pulling the data.  "
              "0 disables.")

# ---------------------------------------------------------------------------

# Inline payload for a placement group's ready() object.
_PG_READY_BLOB = serialization.dumps(True)

# sentinel: a GCS call failed transiently (vs an authoritative None)
_GCS_ERR = object()


class SimpleFuture:
    __slots__ = ("_event", "_value", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error = None

    def set(self, value=None):
        self._value = value
        self._event.set()

    def set_error(self, err):
        self._error = err
        self._event.set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError()
        if self._error is not None:
            raise self._error
        return self._value



def _node_topology_labels() -> Dict[str, str]:
    """Scheduler-visible TPU topology labels from the environment (SURVEY
    §7 items 3-4): a TPU-VM pod-slice worker exports its slice identity
    via the TPU runtime env (or the RAY_TPU_* overrides used in tests);
    nodes sharing ``tpu_slice`` are ICI-adjacent and STRICT_PACK bundles
    prefer staying inside one slice."""
    labels: Dict[str, str] = {}
    env = os.environ
    for key, override, tpu_var in (
            ("accelerator_type", config.accelerator_type,
             "TPU_ACCELERATOR_TYPE"),
            ("tpu_slice", config.slice_id, "TPU_NAME"),
            ("tpu_topology", config.topology, "TPU_TOPOLOGY"),
            ("tpu_worker_id", config.worker_id, "TPU_WORKER_ID"),
    ):
        val = override or env.get(tpu_var)
        if val:
            labels[key] = val
    return labels


class _WorkerConn:
    def __init__(self, sock, profile):
        self.sock = sock
        self.profile = profile
        self.worker_id: Optional[WorkerID] = None
        self.pid: Optional[int] = None
        self.state = "starting"  # starting | idle | busy | actor
        self.current_task: Optional[TaskSpec] = None
        # Concurrent actors can have several calls in flight on one worker
        # (reference: concurrency groups, `concurrency_group_manager.cc`).
        self.inflight: Dict[TaskID, TaskSpec] = {}
        # rid -> cancel fn for this worker's outstanding get/wait requests;
        # invoked on explicit cancel (client-side timeout) or worker death
        # so object waiter lists don't accumulate dead callbacks.
        self.request_cancels: Dict[int, Callable] = {}
        self.actor_id: Optional[ActorID] = None
        # oid -> hold count announced by this process (auto-released on
        # process death)
        self.held: Dict[ObjectID, int] = {}
        self.send_lock = make_lock("worker_conn.send")
        self.rbuf = bytearray()  # partial-frame receive buffer
        self.sent_fns: set = set()  # function ids this worker has cached
        # Direct transport: the worker's direct-call listener address
        # (registered at startup), whether this conn ever brokered a
        # direct channel (fence notices go only to such conns), and the
        # active lease record when the worker is leased to a caller.
        self.direct_addr: Optional[dict] = None
        self.uses_direct = False
        self.lease: Optional[dict] = None
        # set by the memory monitor just before SIGKILL, so the death
        # path raises typed OutOfMemoryError instead of a generic crash
        self.oom_kill = False

    def send(self, msg):
        protocol.send_msg(self.sock, msg, self.send_lock)

    def send_many(self, msgs):
        protocol.send_msgs(self.sock, msgs, self.send_lock)


class _ObjectState:
    __slots__ = ("status", "value", "error", "size", "locations",
                 "holders", "pins", "tracked", "creating_spec",
                 "free_armed", "contains", "remote_inline",
                 "recon_attempts", "lookup_attempts",
                 "replicated", "replicas")

    def __init__(self):
        # pending | inline | store | remote | error
        # "remote": sealed in another node's store/raylet (cluster mode) —
        # satisfies dependency gating (the task can be forwarded to the
        # data) but must be pulled before LOCAL dispatch or get().
        self.status = "pending"
        self.value: Optional[bytes] = None
        self.error: Optional[Exception] = None
        self.size = 0
        self.locations: List[str] = []
        # --- reference counting (reference: reference_count.h:61) ---
        self.holders = 0        # processes holding live ObjectRefs
        self.pins = 0           # queued/submitted tasks depending on this
        self.tracked = False    # ever held => eligible for auto-free
        self.creating_spec: Optional["TaskSpec"] = None  # lineage
        self.free_armed = False
        # ObjectIDs of refs serialized INSIDE this object's bytes: each is
        # pinned while this entry lives (borrow pinning — an inner ref must
        # outlive the blob that mentions it, however long it sits unread).
        self.contains: Optional[List["ObjectID"]] = None
        # "remote" objects: the directory says the remote copy is INLINE
        # (small, lives in the holder raylet's memory, not its store) —
        # such objects pull over the control plane, not the data channel.
        self.remote_inline = False
        # Lineage-reconstruction budget spent on this object (node death /
        # eviction re-runs of creating_spec); capped by
        # config.max_object_reconstructions.
        self.recon_attempts = 0
        # Consecutive failed directory re-lookups — drives the unified
        # backoff on pull retries; reset when the object materializes.
        self.lookup_attempts = 0
        # Eager availability: True on every node that holds a MANAGED copy
        # (the producer that pushed replicas, or a replica holder) — these
        # nodes re-replicate when a holder dies.  ``replicas`` lists the
        # nodes this raylet pushed copies to (producer side only).
        self.replicated = False
        self.replicas: Optional[List[str]] = None


class _PeerConn:
    """Connection to another raylet (either dialed or accepted)."""

    __slots__ = ("sock", "node_id", "send_lock", "rbuf", "blackholed")

    def __init__(self, sock, node_id: str):
        self.sock = sock
        self.node_id = node_id
        self.send_lock = make_lock("peer_conn.send")
        self.rbuf = bytearray()  # partial-frame receive buffer
        # Chaos blackhole: a partitioned peer conn silently swallows every
        # outbound frame (the socket stays open — failure detection must
        # come from the GCS health monitor / pull watchdogs, like a real
        # network partition).
        self.blackholed = False

    def send(self, msg):
        if self.blackholed:
            return
        fault = _chaos.net_fault("peer", peer=self.node_id)
        if fault is not None:
            if fault == "blackhole":
                self.blackholed = True
            return  # drop / blackhole: the frame vanishes
        protocol.send_msg(self.sock, msg, self.send_lock)


class _ActorState:
    def __init__(self, spec: TaskSpec, name: Optional[str]):
        self.actor_id = spec.actor_id
        self.creation_spec = spec
        self.name = name
        self.state = "pending"  # pending | alive | restarting | dead
        # Cluster mode: node the actor executes on when it was spilled to a
        # peer raylet (this raylet stays the OWNER: it holds the state
        # machine and the restart budget, the exec node reports deaths).
        self.node_id: Optional[str] = None
        # Set on the EXEC side of a forwarded actor: the owner node id
        # (deaths are reported there instead of restarting locally).
        self.foreign_owner: Optional[str] = None
        self.conn: Optional[_WorkerConn] = None
        self.queue: deque = deque()  # pending method TaskSpecs (FIFO order)
        # In-flight calls — up to max_concurrency simultaneously (reference:
        # actor scheduling queues + concurrency groups).
        self.inflight: Dict[TaskID, TaskSpec] = {}
        self.max_concurrency = max(1, spec.max_concurrency)
        # Named concurrency groups: per-group admission limits so a
        # saturated group never starves another (reference: independent
        # group scheduling queues, `concurrency_group_manager.cc`).
        self.group_limits: Optional[Dict[str, int]] = \
            getattr(spec, "concurrency_groups", None)
        self.restarts_left = spec.max_restarts
        self.death_reason = ""
        # Checkpointable actors: latest snapshot object (pinned by the
        # raylet until superseded or the actor is finally dead) + its
        # monotonic sequence number (relayed checkpoints can arrive out
        # of order around a restart).
        self.checkpoint_oid: Optional[ObjectID] = None
        self.checkpoint_seq = 0
        # Sync plain actors (max_concurrency 1, no groups, non-asyncio —
        # reported by the creation-done message) execute calls one at a
        # time on the worker's main thread, so pipelining calls ahead of
        # completion keeps effective concurrency at 1 while removing a
        # socket round-trip of dead time between calls.
        self.async_actor = False
        # Direct transport: restart generation — bumped on EVERY death, so
        # a direct channel (or an in-flight direct call reconciling via
        # the raylet) brokered against an earlier incarnation of this
        # actor is fenced instead of executing on the restarted instance.
        self.generation = 0
        # Exec-side direct address of a FORWARDED actor (owner side only;
        # piggybacked on the creation xdone) — what the broker hands to
        # callers when the actor runs on a peer node.
        self.direct_info: Optional[dict] = None

    def admit_limit(self) -> int:
        if (self.max_concurrency == 1 and self.group_limits is None
                and not self.async_actor):
            return max(1, config.actor_pipeline_depth)
        return self.max_concurrency


class _PlacementGroup:
    """Local PG (or, in cluster mode, this node's FRAGMENT of one):
    bundles keyed by their GLOBAL bundle index — a fragment holds only the
    indices the GCS assigned to this node."""

    def __init__(self, pg_id, bundles, strategy: str,
                 ready_oid: Optional[ObjectID] = None,
                 fragment: bool = False):
        if isinstance(bundles, list):
            bundles = {i: b for i, b in enumerate(bundles)}
        self.pg_id = pg_id
        self.bundles: Dict[int, Dict[str, float]] = bundles
        self.available = {i: dict(b) for i, b in bundles.items()}
        self.strategy = strategy
        self.state = "pending"  # pending | created
        self.ready_oid = ready_oid
        self.fragment = fragment  # cluster PG piece; GCS owns the whole
        # bundle indices whose node resources are NOT yet acquired.
        # Whole PGs reserve atomically (all-or-nothing, no inter-PG
        # deadlock); fragments reserve per bundle (node-death repair can
        # extend a live fragment).
        self.unreserved = set(bundles.keys())

    def reserved_total(self) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for i, b in self.bundles.items():
            if i in self.unreserved:
                continue
            for k, v in b.items():
                total[k] = total.get(k, 0.0) + v
        return total

    def total(self) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for b in self.bundles.values():
            for k, v in b.items():
                total[k] = total.get(k, 0.0) + v
        return total


def _fits(avail: Dict[str, float], need: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in need.items())


def _acquire(avail: Dict[str, float], need: Dict[str, float]):
    for k, v in need.items():
        avail[k] = avail.get(k, 0.0) - v


def _release(avail: Dict[str, float], need: Dict[str, float]):
    for k, v in need.items():
        avail[k] = avail.get(k, 0.0) + v


# ---------------------------------------------------------------------------


class Raylet:
    def __init__(
        self,
        session_dir: str,
        resources: Dict[str, float],
        store_path: Optional[str],
        worker_env: Optional[Dict[str, str]] = None,
        gcs: Optional[GcsCore] = None,
        gcs_address: Optional[str] = None,
        node_ip: str = "127.0.0.1",
        listen_port: Optional[int] = None,
    ):
        """Single-node (default): embedded ``GcsCore``, unix socket only.

        Cluster mode (``listen_port`` not None, usually 0 = ephemeral): also
        listens on TCP for peer raylets and remote drivers, registers the
        node with the GCS (remote via ``gcs_address`` or a shared in-process
        core via ``gcs``), heartbeats resources, spills tasks to peers and
        pulls remote objects (reference: `src/ray/raylet/main.cc:109` node
        bring-up + `scheduling/cluster_task_manager.cc:44` spillback).
        """
        self.session_dir = session_dir
        self.socket_path = os.path.join(session_dir, "raylet.sock")
        self.store_path = store_path
        self.resources_total = dict(resources)
        self.resources_available = dict(resources)
        self.worker_env = worker_env or {}
        self.node_id = WorkerID.from_random().hex()
        self.node_ip = node_ip
        self.gcs_address = gcs_address
        self.cluster_mode = listen_port is not None
        # Registration generation assigned by the GCS (monotonic per
        # node_id).  Stamped onto heartbeats, directory updates, task-event
        # batches, actor registrations, peer hellos, and data-channel
        # handshakes — the fencing token that makes a node declared dead
        # unable to mutate cluster state until it re-registers fresh
        # (reference: raylet restarts bump the node instance id).
        self.incarnation = 0

        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._listener.bind(self.socket_path)
        self._listener.listen(128)
        self._listener.setblocking(False)

        self._tcp_listener = None
        self.tcp_port = None
        if self.cluster_mode:
            self._tcp_listener = socket.create_server(
                (node_ip, listen_port), backlog=128)
            self._tcp_listener.setblocking(False)
            self.tcp_port = self._tcp_listener.getsockname()[1]

        # Control plane: remote GCS (cluster), shared core (in-process
        # multi-raylet tests), or a private embedded core (single node).
        # A standalone raylet whose GCS dies must not linger as an orphan
        # tree of workers (reference raylets exit when the GCS is
        # unreachable); ``on_fatal`` lets the hosting process (raylet_main)
        # exit its wait loop.
        self.on_fatal: Optional[Callable[[], None]] = None
        if gcs_address is not None:
            self.gcs = GcsClient(gcs_address, push_handler=self._gcs_push,
                                 on_disconnect=self._on_gcs_lost)
        else:
            self.gcs = gcs if gcs is not None else GcsCore()

        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._inbox: deque = deque()  # guard: _inbox_lock
        self._inbox_lock = make_lock("raylet.inbox")
        # Wake elision: _wake_armed=True means the loop is GUARANTEED to
        # drain the inbox without a wake byte — either a byte is already in
        # flight, or the loop is awake and will re-check the inbox before
        # blocking in select (it disarms under the lock right before a
        # blocking select).  A submission storm while the loop is busy
        # costs ZERO syscalls instead of one send per call_async.
        self._wake_armed = False  # guard: _inbox_lock

        self._sel = selectors.DefaultSelector()
        self._sel.register(self._listener, selectors.EVENT_READ, ("accept", None))
        self._sel.register(self._wake_r, selectors.EVENT_READ, ("wake", None))
        if self._tcp_listener is not None:
            self._sel.register(self._tcp_listener, selectors.EVENT_READ,
                               ("accept", None))

        # state (event-thread owned)
        # Batched-drain context: while a frame train is being drained,
        # actor pumps and request replies are deferred/coalesced so one
        # wakeup's worth of messages costs one pump per actor and one
        # sendall per conn instead of one each per frame.
        self._drain_depth = 0
        self._pending_pumps: "dict[ActorID, _ActorState]" = {}
        self._pending_replies: "dict[int, tuple]" = {}  # id(conn) -> (conn, [msgs])
        self._workers: Dict[socket.socket, _WorkerConn] = {}
        self._idle: Dict[str, deque] = {}  # profile -> deque[_WorkerConn]
        self._spawning: Dict[str, int] = {}
        self._procs: List[subprocess.Popen] = []
        self._unregistered: List[Tuple[subprocess.Popen, str]] = []
        self._health_timer_armed = False
        self._ready_queue: deque = deque()  # TaskSpecs with deps satisfied
        self._waiting: Dict[TaskID, Tuple[TaskSpec, set]] = {}
        self._dep_index: Dict[ObjectID, set] = {}
        self._objects: Dict[ObjectID, _ObjectState] = {}
        self._object_waiters: Dict[ObjectID, List[Callable]] = {}
        self._actors: Dict[ActorID, _ActorState] = {}
        self._pgs: Dict[str, _PlacementGroup] = {}
        # Local write-through cache of the GCS function table (hot path:
        # every dispatch of a large function looks its blob up).
        self._fn_cache: Dict[bytes, bytes] = {}
        self._timers: List[Tuple[float, int, Callable]] = []
        self._timer_seq = itertools.count()
        self._task_events: deque = deque(maxlen=config.task_event_buffer_size)
        self._task_states: Dict[TaskID, dict] = {}
        # Task-event export (reference: the raylet's TaskEventBuffer flushing
        # to the GCS task-event table): a ring buffer of not-yet-flushed
        # events, batch-flushed on a timer / drain cadence via one-way GCS
        # posts.  Overflow drops the OLDEST events and counts them —
        # export backpressure must never block dispatch.
        self._task_event_buf: deque = deque()
        self._task_event_dropped = 0        # since last flush (shipped)
        self._task_event_dropped_total = 0  # lifetime (metrics)
        self._task_event_timer_armed = False
        # Hot-path flag handles: _record_event runs 3x per task; reading
        # .value off the flag object keeps runtime toggles working (tests /
        # bench flip config.task_events) without a config __getattr__ per
        # event.
        self._flag_task_events = config._flags["task_events"]
        self._flag_event_cap = config._flags["task_event_export_buffer"]
        self._flag_state_cap = config._flags["task_event_buffer_size"]
        # Trace-span export (request-flow tracing): spans from this
        # process (raylet hop spans + driver spans — they share a process
        # in single-node mode) and from workers ("spans" control frames)
        # buffer here and batch-flush to the GCS trace table on the same
        # drain/timer cadence as task events.
        _tracing.maybe_enable_from_env()
        self._trace_buf: deque = deque()
        self._trace_export_dropped = 0        # since last flush (shipped)
        self._trace_dropped_total = 0         # lifetime (metrics)
        self._trace_timer_armed = False
        if _tracing.tracing_enabled():
            # heartbeat from the start: driver-side spans (same process,
            # different thread) reach the GCS table without waiting for a
            # raylet-side emit to arm the timer
            self._arm_trace_flush()
        # Continuous-profiling export (cluster-wide profiling): folded
        # stack samples from this process's sampler thread plus worker
        # batches ("profile_samples" control frames) buffer here and
        # batch-flush to the per-node GCS profile table on a recurring
        # timer (RAY_TPU_PROFILE=0 live kill switch idles the samplers;
        # the timer then only polls an empty buffer once a second).
        _profiling.ensure_profiler(
            "raylet" if self.cluster_mode else "driver")
        self._profile_buf: deque = deque()
        self._profile_export_dropped = 0   # since last flush (shipped)
        self._profile_dropped_total = 0    # lifetime (metrics)
        # Metric time-series export: delta points from this process's
        # registry ring plus worker batches ("metric_points" control
        # frames) buffer here and batch-flush to the per-node GCS metrics
        # table on the internal-metrics cadence.
        self._metric_point_buf: deque = deque()
        self._metric_points_export_dropped = 0  # since last flush (shipped)
        self._metric_points_dropped_total = 0   # lifetime (metrics)
        # Telemetry self-audit: subsystem -> [wall seconds, approx bytes]
        # accumulated in the export flush paths, re-exported as
        # ray_tpu_internal_telemetry_flush_* series each metrics tick.
        self._m_telemetry: Dict[str, list] = {}  # unguarded-ok: event thread + flush timers; float += races at worst lose one sample's accounting
        # in-flight live stack-dump gathers: token -> {want, procs, cb, done}
        self._stack_queries: Dict[str, dict] = {}
        self._stack_token_seq = itertools.count(1)
        # worker log-file index for `ray_tpu_torch logs` + crash forensics
        # (path -> pid survives the tail entry, which pops at death)
        self._worker_log_pids: Dict[str, Optional[int]] = {}
        self._worker_log_by_pid: Dict[int, str] = {}
        self.add_timer(config.profile_flush_interval_s,
                       self._profile_flush_tick)
        # recovery-span bookkeeping: creating task_id -> (t0, parent_ctx,
        # oid_hex) captured when a reconstruction starts, emitted when it
        # concludes
        self._recon_trace: Dict[TaskID, tuple] = {}
        # traced arg pulls: oid -> (t0, parent_ctx); span emitted when the
        # pull seals/fails (one child span per data-channel pull)
        self._pull_trace: Dict[ObjectID, tuple] = {}
        # Internal runtime metrics (ray_tpu_internal_*): plain event-thread
        # counters sampled into util.metrics primitives at flush time.
        self._im: Optional[Dict[str, object]] = None
        self._m_frames = 0       # control-plane frames handled
        self._m_trains = 0       # socket drains (frame trains)
        self._m_train_bytes = 0
        self._m_tasks_done = {"FINISHED": 0, "FAILED": 0, "SHED": 0,
                              "EXPIRED": 0, "CANCELLED": 0}
        self._m_last: Dict[str, float] = {}  # counter deltas at flush
        # ---- overload protection / deadlines ----
        self._m_shed = 0              # backpressure rejections (queue bound)
        self._m_deadline_exceeded = 0  # deadline expiries enforced here
        self._m_cancelled = 0         # tasks cancelled (fan-out included)
        # cancel fan-out edges: parent task id -> child TASK IDS
        # submitted while it ran (relayed submits + direct_running
        # notes; ids only — retaining specs would pin their arg payloads
        # for the LRU's lifetime); bounded LRU on parents — a long-lived
        # driver must not grow this forever
        self._children: "OrderedDict[TaskID, List[TaskID]]" = OrderedDict()
        # tasks a cancel/deadline fan-out already reaped (tid -> deadline
        # flag): a child whose submit frame or direct_running note arrives
        # AFTER the fan-out walked the children index is caught here at
        # admission instead of running to completion.  Bounded LRU.
        self._cancelled_tids: "OrderedDict[TaskID, bool]" = OrderedDict()
        # direct calls currently executing on a local worker (RUNNING note
        # seen, done not yet): task id -> (hosting conn, spec).  Cancel/
        # deadline frames route to the hosting worker's control socket
        # even though dispatch never came through this raylet, and the
        # OOM victim picker sees leased workers' in-flight work through it
        self._direct_running: Dict[TaskID, tuple] = {}
        if config.internal_metrics_interval_s > 0:
            self._init_internal_metrics()
        self._need_schedule = False
        self._shutdown = False
        # Streaming generator tasks (reference: streaming generator returns,
        # `_raylet.pyx:224`): task_id -> {produced, total, error, waiters}.
        self._streams: Dict[TaskID, dict] = {}
        # Streams executing here for another raylet: task_id -> origin node
        # (each yielded item is relayed so the consumer-side stream state
        # advances — covers actor-routed and node-affinity streaming tasks).
        self._foreign_streams: Dict[TaskID, str] = {}
        # auto-free grace queue (see _maybe_free): FIFO of (deadline, oid)
        # swept by a single repeating timer instead of a timer per object
        self._free_queue: deque = deque()
        self._free_sweep_armed = False
        # lineage bookkeeping (bounded; see submit_task)
        self._lineage_count = 0
        self._reconstructing: set = set()
        # cluster PGs this node originated: pg_id -> ready ObjectID
        self._cluster_pg_ready: Dict[str, Optional[ObjectID]] = {}
        # Worker log tailing (reference: LogMonitor,
        # `python/ray/_private/log_monitor.py:102`): in cluster mode worker
        # stdio goes to per-worker files; a timer tails them and pushes new
        # lines to attached drivers.
        self._worker_log_seq = itertools.count()
        self._worker_log_tails: Dict[str, dict] = {}  # path -> {pos, pid}
        self._log_timer_armed = False

        # ---- cluster state (all event-thread owned) ----
        self._peers: Dict[str, _PeerConn] = {}          # node_id -> conn
        self._cluster_nodes: Dict[str, dict] = {}       # node_id -> gcs info
        # Fenced peers: node_id -> last incarnation declared dead.  Written
        # on the event thread (node_dead events); read by event-thread
        # peer-hello checks AND data-server handshake threads (dict get is
        # GIL-atomic; entries are independent).
        self._fenced: Dict[str, int] = {}
        self._m_fenced_frames = 0  # stale peer hellos / handshakes rejected
        # ---- graceful drain (node_drain push -> drain_complete) ----
        self._draining = False
        self._drained = False           # drain finished: stop heartbeating
        self._drain_deadline = 0.0
        self._drain_stats: Dict[str, int] = {}
        self._drain_pushed: set = set()  # oids already pushed during drain
        self._drain_push_at: Dict[ObjectID, float] = {}  # last push time
        self._forwarded: Dict[TaskID, Tuple[TaskSpec, str]] = {}
        self._actor_owner_cache: Dict[ActorID, str] = {}
        self._pulls: Dict[ObjectID, dict] = {}          # oid -> pull state
        self._pull_by_rid: Dict[int, ObjectID] = {}
        self._pull_rid = itertools.count(1)
        self._store = None  # guard: _store_lock — lazy attach, see _raylet_store
        self._store_lock = make_lock("raylet.store")  # data-plane threads attach too
        # ---- zero-copy data plane (data_channel.py + pull_manager.py) ----
        self._data_server = None
        self._pull_manager = None
        if self.cluster_mode and store_path and config.data_channel:
            from ray_tpu_torch.core.data_channel import DataServer
            from ray_tpu_torch.core.pull_manager import PullManager

            self._data_server = DataServer(node_ip, self._raylet_store,
                                           fence_fn=self._peer_fence_ok)
            self._pull_manager = PullManager(
                self.node_id, self._raylet_store, self._peer_data_addr,
                post=self.call_async,
                on_done=self._on_pull_done, on_fail=self._on_pull_failed,
                hello_fn=lambda: (self.node_id, self.incarnation))
        # Bounded sender pool for the python-fallback pull path (was: one
        # thread spawned per pull request).
        self._pull_send_q: Optional[_queue.SimpleQueue] = None
        self._pull_sender_count = 0
        self._m_pull_sender_saturated = 0
        self._m_locality_spills = 0
        # Lineage-reconstruction accounting (node-death + eviction recovery)
        self._m_recon_attempts = 0
        self._m_recon_successes = 0
        self._m_recon_failures = 0
        # Eager replication / actor checkpointing (cheap availability)
        self._replicating: set = set()  # oids being pulled as replicas here
        self._m_repl_pushes = 0      # replica pushes initiated
        self._m_repl_bytes = 0       # bytes covered by those pushes
        self._m_repl_repairs = 0     # re-replications after a holder died
        self._m_repl_recoveries = 0  # node-death losses served by a replica
        self._m_ckpt_saves = 0       # actor checkpoints recorded
        self._m_ckpt_bytes = 0
        self._m_ckpt_restores = 0    # restarts that restored from one
        # Unified jittered-exponential backoff for transient-failure paths
        # (GCS reconnect, pull re-lookups; data-channel dials hold their
        # own instance inside the pull manager).
        self._retry_policy = BackoffPolicy()
        # ---- direct worker→worker transport (broker-side state) ----
        # In-process driver's fence callback (DriverWorker wires it);
        # worker/driver conns that brokered direct channels get fence
        # notices as control frames instead.
        self.direct_fence_cb: Optional[Callable[[dict], None]] = None
        self._leases: Dict[str, _WorkerConn] = {}  # lease_id -> worker
        self._lease_seq = itertools.count(1)
        self._m_direct_dones = 0   # direct completions bookkept here
        self._m_direct_leases = 0  # task leases granted

        if isinstance(self.gcs, GcsCore):
            # In-process core: subscribe directly; pushes hop to the loop.
            self.gcs.subscribe(self._gcs_push, node_id=self.node_id)
        else:
            self.gcs.subscribe_remote(node_id=self.node_id)
        address = (node_ip, self.tcp_port) if self.cluster_mode else None
        self.node_labels = _node_topology_labels()
        self.data_port = (self._data_server.port
                          if self._data_server is not None else None)
        self._apply_registration(self.gcs.register_node(
            self.node_id, address, self.resources_total,
            store_path=store_path, hostname=socket.gethostname(),
            labels=self.node_labels, data_port=self.data_port,
            incarnation=self.incarnation))

        self._thread = threading.Thread(target=self._run, name="raylet", daemon=True)
        self._thread.start()
        if self.cluster_mode:
            self.call_async(
                lambda: self.add_timer(config.gcs_heartbeat_interval_s,
                                       self._heartbeat))
        if config.memory_monitor_interval_s > 0:
            self.call_async(
                lambda: self.add_timer(config.memory_monitor_interval_s,
                                       self._memory_check))
        if self._im is not None:
            self.call_async(
                lambda: self.add_timer(config.internal_metrics_interval_s,
                                       self._flush_internal_metrics))
        if self._pull_manager is not None:
            self.call_async(
                lambda: self.add_timer(1.0, self._pull_tick))

    # ------------------------------------------------------------------ API
    # Called from the driver thread; closures run on the event thread.

    def call(self, fn: Callable, *args) -> SimpleFuture:
        fut = SimpleFuture()

        def wrapper():
            try:
                fut.set(fn(*args))
            except BaseException as e:  # noqa: BLE001
                fut.set_error(e)

        with self._inbox_lock:
            self._inbox.append(wrapper)
            need_wake = not self._wake_armed
            self._wake_armed = True
        if need_wake:
            try:
                self._wake_w.send(b"\x00")
            except OSError:
                pass
        return fut

    def call_async(self, fn: Callable, *args):
        with self._inbox_lock:
            self._inbox.append(lambda: fn(*args))
            need_wake = not self._wake_armed
            self._wake_armed = True
        if need_wake:
            try:
                self._wake_w.send(b"\x00")
            except OSError:
                pass

    # --------------------------------------------------------------- event loop

    def _run(self):
        while not self._shutdown:
            # The inbox is drained every iteration (not only on wake bytes:
            # elided wakes rely on this — see _wake_armed).
            self._drain_inbox()
            # Debounced scheduling: submit/done storms request a schedule
            # pass via the flag; ONE queue scan runs per loop iteration
            # instead of one per message (a 2000-task burst is otherwise an
            # O(n^2) rescan of the deferred queue).
            if self._need_schedule:
                self._need_schedule = False
                self._safe(self._schedule_now)
            timeout = 0.0 if self._need_schedule else self._next_timer_delay()
            if timeout != 0.0:
                with self._inbox_lock:
                    if self._inbox:
                        timeout = 0.0  # drained next iteration; stay armed
                    else:
                        # about to block: from here on a caller must send a
                        # wake byte to interrupt the select
                        self._wake_armed = False
            events = self._sel.select(timeout)
            now = time.monotonic()
            while self._timers and self._timers[0][0] <= now:
                _, _, cb = heapq.heappop(self._timers)
                self._safe(cb)
            for key, _ in events:
                kind, conn = key.data
                if kind == "accept":
                    self._accept(key.fileobj)
                elif kind == "peer":
                    try:
                        self._on_peer_readable(conn)
                    except Exception:  # noqa: BLE001
                        traceback.print_exc()
                        self._safe(lambda c=conn: self._drop_peer(c))
                elif kind == "wake":
                    try:
                        self._wake_r.recv(4096)
                    except OSError:
                        pass
                    # The loop is awake: callers can skip wake bytes until
                    # it disarms again right before the next blocking
                    # select (the loop-top drain picks their work up).
                    with self._inbox_lock:
                        self._wake_armed = True
                    self._drain_inbox()
                elif kind == "worker":
                    # Never let a malformed message kill the event thread; a
                    # worker whose channel is broken is treated as dead.
                    try:
                        self._on_worker_readable(conn)
                    except Exception:  # noqa: BLE001
                        traceback.print_exc()
                        self._safe(lambda c=conn: self._on_worker_death(c))
        # cleanup
        self._safe(self.flush_task_events)  # don't lose the last window
        self._safe(self.flush_trace_spans)
        self._safe(self.flush_profile_samples)
        for conn in list(self._workers.values()):
            try:
                conn.send({"t": "shutdown"})
                conn.sock.close()
            except OSError:
                pass
        for peer in list(self._peers.values()):
            try:
                peer.sock.close()
            except OSError:
                pass
        for p in self._procs:
            try:
                p.terminate()
            except OSError:
                pass
        try:
            self._listener.close()
            os.unlink(self.socket_path)
        except OSError:
            pass
        if self._tcp_listener is not None:
            try:
                self._tcp_listener.close()
            except OSError:
                pass
        if self._pull_manager is not None:
            self._pull_manager.close()
        if self._data_server is not None:
            self._data_server.close()
        store = self._store  # unguarded-ok: shutdown; data plane closed above
        if store is not None:
            try:
                store.close()
            except Exception:  # noqa: BLE001
                pass

    def _safe(self, fn):
        try:
            fn()
        except Exception:  # noqa: BLE001
            traceback.print_exc()

    def _drain_inbox(self):
        while True:
            with self._inbox_lock:
                if not self._inbox:
                    return
                fn = self._inbox.popleft()
            self._safe(fn)

    def _next_timer_delay(self):
        if not self._timers:
            return 0.5
        return max(0.0, self._timers[0][0] - time.monotonic())

    def add_timer(self, delay: float, cb: Callable):
        heapq.heappush(
            self._timers, (time.monotonic() + delay, next(self._timer_seq), cb)
        )

    def _accept(self, listener):
        try:
            sock, _ = listener.accept()
        except OSError:
            return
        sock.setblocking(True)
        if listener is self._tcp_listener:
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
        # Starts as a worker conn; a peer_hello / driver_hello first message
        # re-tags it (peers are other raylets, drivers are remote clients).
        conn = _WorkerConn(sock, profile="cpu")
        self._workers[sock] = conn
        self._sel.register(sock, selectors.EVENT_READ, ("worker", conn))

    _drain_frames = staticmethod(protocol.drain_frames)

    # ---- batched drain context ----
    # A frame train drained from one socket wakeup is handled under this
    # context: per-frame actor pumps collapse into one pump per actor and
    # per-frame replies into one coalesced sendall per conn, AFTER the whole
    # train is processed (one schedule pass — the _need_schedule flag — was
    # already per-batch).

    def _begin_drain(self):
        self._drain_depth += 1

    def _end_drain(self):
        self._drain_depth -= 1
        if self._drain_depth:
            return
        while self._pending_pumps:
            _, actor = self._pending_pumps.popitem()
            self._safe(lambda a=actor: self._pump_actor(a))
        while self._pending_replies:
            _, (conn, msgs) = self._pending_replies.popitem()
            try:
                conn.send_many(msgs)
            except OSError:
                pass  # conn died mid-drain; its death path handles cleanup
        # Task-event export rides the drain cadence: a burst that fills the
        # batch threshold ships now instead of waiting out the flush timer.
        if len(self._task_event_buf) >= config.task_event_batch_max:
            self.flush_task_events()

    def _queue_reply(self, conn: _WorkerConn, msg: dict):
        """Reply to a worker request: coalesced per drain, direct otherwise."""
        if self._drain_depth:
            entry = self._pending_replies.get(id(conn))
            if entry is None:
                self._pending_replies[id(conn)] = (conn, [msg])
            else:
                entry[1].append(msg)
        else:
            conn.send(msg)

    def _request_pump(self, actor: "_ActorState"):
        if self._drain_depth:
            self._pending_pumps[actor.actor_id] = actor
        else:
            self._pump_actor(actor)

    def _on_worker_readable(self, conn: _WorkerConn):
        """Buffered frame reader: ONE recv drains everything the kernel has
        for this socket (workers coalesce done bursts into frame trains),
        then every complete frame is handled — instead of one recv + one
        select() iteration per message."""
        try:
            data = conn.sock.recv(1 << 20)
        except OSError:
            data = b""
        if not data:
            self._on_worker_death(conn)
            return
        self._m_trains += 1
        self._m_train_bytes += len(data)
        if self._im is not None:
            self._im["train_bytes"].observe(len(data))
        conn.rbuf += data
        self._begin_drain()
        try:
            self._drain_frames(
                conn.rbuf,
                lambda msg: self._handle_worker_msg(conn, msg),
                lambda: self._workers.get(conn.sock) is conn)
        finally:
            self._end_drain()
        if self._workers.get(conn.sock) is conn:
            return
        # The conn left _workers mid-train: either it died (socket closed,
        # buffer moot) or a peer_hello promoted it to a raylet peer — any
        # remaining buffered frames belong to the peer protocol.
        try:
            kind, peer = self._sel.get_key(conn.sock).data
        except (KeyError, ValueError):
            return
        if kind == "peer" and conn.rbuf:
            peer.rbuf += conn.rbuf
            conn.rbuf = bytearray()
            self._begin_drain()
            try:
                self._drain_frames(
                    peer.rbuf,
                    lambda msg: self._handle_peer_msg(peer, msg),
                    lambda: self._peer_alive(peer))
            finally:
                self._end_drain()

    def _peer_alive(self, peer) -> bool:
        try:
            kind, cur = self._sel.get_key(peer.sock).data
        except (KeyError, ValueError):
            return False
        return kind == "peer" and cur is peer

    # --------------------------------------------------------------- workers

    def _profile_key(self, spec: TaskSpec) -> str:
        cached = getattr(spec, "_profile", None)
        if cached is not None:
            return cached
        needs_tpu = spec.resources.get("TPU", 0) > 0
        env = (spec.runtime_env or {}).get("env_vars") or {}
        if env:
            envkey = ",".join(f"{k}={v}" for k, v in sorted(env.items()))
            key = ("tpu|" if needs_tpu else "cpu|") + envkey
        else:
            key = "tpu" if needs_tpu else "cpu"
        spec._profile = key
        return key

    def _spawn_worker(self, profile: str):
        self._spawning[profile] = self._spawning.get(profile, 0) + 1
        env = dict(os.environ)
        env.update(self.worker_env)
        # Propagate the driver's import path: workers must resolve ray_tpu_torch
        # (and the user's modules) no matter the cwd (reference ships the
        # driver's sys.path through the runtime env/worker command line).
        path_entries = [p for p in sys.path if p] + [
            p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p
        ]
        seen = set()
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in path_entries if not (p in seen or seen.add(p))
        )
        if profile == "cpu" or profile.startswith("cpu|"):
            # CPU workers must not touch the card: only workers of the chip
            # ("TPU") profile may see it, so a CPU task never opens a CUDA
            # context there.  Force (not setdefault): the environment may
            # name the card for every process.
            env["CUDA_VISIBLE_DEVICES"] = ""
        if "|" in profile:
            for kv in profile.split("|", 1)[1].split(","):
                k, v = kv.split("=", 1)
                env[k] = v
        env["RAY_TPU_WORKER_PROFILE"] = profile
        env["RAY_TPU_NODE_ID"] = self.node_id
        # Direct-transport fencing: the worker rejects direct hellos that
        # present an incarnation older than the node's at its spawn time
        # (a fenced node kills its workers, so this never goes stale).
        env["RAY_TPU_NODE_INCARNATION"] = str(self.incarnation)
        if self.cluster_mode:
            # lets the worker's direct-call listener bind TCP for callers
            # on peer nodes
            env["RAY_TPU_NODE_IP"] = self.node_ip
        cmd = [
            sys.executable,
            "-m",
            "ray_tpu_torch.core.worker_main",
            "--socket",
            self.socket_path,
        ]
        if self.store_path:
            cmd += ["--store", self.store_path]
        stdout = stderr = None
        if self.cluster_mode and self.session_dir:
            # Per-worker combined log file, tailed to drivers (reference:
            # worker log files under the session dir + LogMonitor tailing,
            # `log_monitor.py:102`). Also keeps worker prints out of the
            # raylet's (undrained) stdout pipe.
            log_dir = os.path.join(self.session_dir, "logs")
            os.makedirs(log_dir, exist_ok=True)
            log_path = os.path.join(
                log_dir, f"worker-{next(self._worker_log_seq):05d}.log")
            logf = open(log_path, "ab", buffering=0)
            stdout = stderr = logf
            self._worker_log_tails[log_path] = {"pos": 0, "pid": None}
            if not self._log_timer_armed:
                self._log_timer_armed = True
                self.add_timer(0.3, self._pump_worker_logs)
        proc = subprocess.Popen(cmd, env=env, cwd=os.getcwd(),
                                stdout=stdout, stderr=stderr)
        if stdout is not None:
            stdout.close()  # child keeps its copy
            self._worker_log_tails[log_path]["pid"] = proc.pid
            self._worker_log_tails[log_path]["proc"] = proc
            # log index outlives the tail entry (popped at worker death):
            # `ray_tpu_torch logs` attribution + crash-forensics excerpts
            self._worker_log_pids[log_path] = proc.pid
            self._worker_log_by_pid[proc.pid] = log_path
        self._procs.append(proc)
        self._unregistered.append((proc, profile))
        if not self._health_timer_armed:
            self._health_timer_armed = True
            self.add_timer(config.health_check_period_s, self._health_check)

    def _pump_worker_logs(self):
        """Tail worker log files; push new complete lines to attached
        drivers (reference: LogMonitor → GCS pubsub → driver console)."""
        drivers = [c for c in self._workers.values()
                   if getattr(c, "state", None) == "driver"]
        for path, tail in list(self._worker_log_tails.items()):
            # Order matters: check liveness BEFORE reading, so "dead" means
            # the read below saw every byte the worker ever wrote (a final
            # flush between read and poll would otherwise be dropped when
            # the tail entry is popped).
            proc = tail.get("proc")
            worker_dead = proc is not None and proc.poll() is not None
            try:
                with open(path, "rb") as f:
                    f.seek(tail["pos"])
                    data = f.read()
            except OSError:
                self._worker_log_tails.pop(path, None)
                continue
            if not data:
                if worker_dead:
                    # fully drained a dead worker's file: stop tailing it
                    self._worker_log_tails.pop(path, None)
                continue
            # Ship complete lines; keep the partial tail for the next tick
            # unless the worker already exited (then flush everything).
            cut = len(data) if worker_dead else data.rfind(b"\n") + 1
            if cut <= 0:
                continue
            tail["pos"] += cut
            lines = data[:cut].decode("utf-8", "replace").splitlines()
            if drivers and lines:
                msg = {"t": "log", "node_id": self.node_id,
                       "pid": tail["pid"], "lines": lines}
                for conn in drivers:
                    try:
                        conn.send(msg)
                    except OSError:
                        pass
            if worker_dead:
                self._worker_log_tails.pop(path, None)
        if not self._shutdown:
            self.add_timer(0.3, self._pump_worker_logs)

    # ---- log files: list/tail over the protocol (`ray_tpu_torch logs`) ----

    def _log_dir(self) -> str:
        return os.path.join(self.session_dir, "logs")

    def _logs_query(self, payload: dict):
        """Dispatch a logs node-query: ``{"action": "list"}`` or
        ``{"action": "tail", "name", "offset"?, "lines"?}``."""
        action = payload.get("action", "list")
        if action == "list":
            return self._list_logs()
        if action == "tail":
            return self._tail_log(payload.get("name"),
                                  payload.get("offset"),
                                  int(payload.get("lines", 100)))
        raise ValueError(f"unknown logs action {action!r}")

    def _list_logs(self) -> List[dict]:
        """Per-worker log files under ``session_dir/logs`` (cluster mode
        writes one per spawned worker; reference: ``ray logs`` over the
        session's log directory)."""
        out = []
        log_dir = self._log_dir()
        if not os.path.isdir(log_dir):
            return out
        for name in sorted(os.listdir(log_dir)):
            if not name.endswith(".log"):
                continue
            path = os.path.join(log_dir, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            out.append({"name": name, "size": st.st_size,
                        "mtime": st.st_mtime, "node_id": self.node_id,
                        "pid": self._worker_log_pids.get(path)})
        return out

    def _tail_log(self, name: Optional[str], offset: Optional[int] = None,
                  lines: int = 100) -> dict:
        """One read of a worker log file: the last ``lines`` lines when
        ``offset`` is None, else everything from ``offset`` (capped at
        1 MiB) — the returned ``offset`` feeds the next poll, which is
        how ``--follow`` streams without server-side state."""
        if not name or os.path.basename(name) != name:
            # basename equality rejects path traversal out of the log dir
            raise ValueError(f"bad log name {name!r}")
        path = os.path.join(self._log_dir(), name)
        size = os.path.getsize(path)  # OSError -> error reply
        with open(path, "rb") as f:
            if offset is None:
                f.seek(max(0, size - (1 << 20)))
                tail = f.read().splitlines()[-max(1, lines):]
                data = b"\n".join(tail) + (b"\n" if tail else b"")
                new_offset = size
            else:
                offset = max(0, min(int(offset), size))
                f.seek(offset)
                data = f.read(1 << 20)
                new_offset = offset + len(data)
        return {"name": name, "data": data.decode("utf-8", "replace"),
                "offset": new_offset, "size": size,
                "node_id": self.node_id}

    def _crash_log_excerpt(self, pid: Optional[int], n: int = 20) -> str:
        """The last ``n`` log lines of a (dead) worker, formatted for
        embedding in its failure message — crash forensics: the operator
        sees the traceback / faulthandler dump / OOM-killer line without
        hunting for the right file on the right node."""
        path = self._worker_log_by_pid.get(pid) if pid is not None else None
        if path is None:
            return ""
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                f.seek(max(0, size - 65536))
                tail = f.read().decode("utf-8", "replace").splitlines()[-n:]
        except OSError:
            return ""
        if not tail:
            return ""
        return (f"\n--- last {len(tail)} line(s) of worker log "
                f"({os.path.basename(path)}) ---\n" + "\n".join(tail))

    # ---- memory monitor / worker killing (reference: MemoryMonitor
    # `src/ray/common/memory_monitor.h:52` + retriable-FIFO policy
    # `worker_killing_policy_retriable_fifo.cc`) ----

    def _memory_usage_fraction(self) -> float:
        path = config.memory_usage_file
        if path:
            try:
                with open(path) as f:
                    return float(f.read().strip())
            except (OSError, ValueError):
                return 0.0
        try:
            info = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    k, v = line.split(":", 1)
                    info[k] = int(v.strip().split()[0])
            avail = info.get("MemAvailable", info.get("MemFree", 0))
            total = max(info.get("MemTotal", 1), 1)
            return 1.0 - avail / total
        except OSError:  # pragma: no cover — non-Linux
            return 0.0

    def _pick_oom_victim(self) -> Optional[_WorkerConn]:
        """Retriable-FIFO: prefer the LAST-started RETRIABLE task's worker
        (its retry costs the least lost work and is safe); else the
        last-started task's worker.  Leased workers executing DIRECT
        calls count too (their task rides _direct_running, not
        current_task) — the caller's channel EOF reconciles the kill
        through the ordinary retry path."""
        direct_task: Dict[_WorkerConn, TaskSpec] = {}
        for _conn, _spec in self._direct_running.values():
            direct_task.setdefault(_conn, _spec)

        def task_of(c: _WorkerConn) -> Optional[TaskSpec]:
            if c.state == "busy" and c.current_task is not None:
                return c.current_task
            if c.state == "leased":
                return direct_task.get(c)
            return None

        busy = [(c, t) for c in self._workers.values()
                if c.pid is not None and (t := task_of(c)) is not None]
        if not busy:
            return None
        retriable = [(c, t) for c, t in busy
                     if getattr(t, "retries_left", 0) > 0]
        pool = retriable or busy
        return max(pool, key=lambda ct:
                   getattr(ct[0], "task_start_time", 0.0))[0]

    def _memory_check(self):
        frac = self._memory_usage_fraction()
        if frac > config.memory_usage_threshold:
            victim = self._pick_oom_victim()
            if victim is not None:
                spec = victim.current_task
                sys.stderr.write(
                    f"[ray_tpu_torch] memory usage {frac:.2f} > "
                    f"{config.memory_usage_threshold:.2f}: killing worker "
                    f"pid={victim.pid} running "
                    f"{spec.name if spec else '?'} (OOM prevention)\n")
                if spec is not None:
                    self._record_event(spec, "OOM_KILLED", pid=victim.pid)
                # the death path raises typed OutOfMemoryError (with the
                # crash-forensics excerpt) instead of a generic crash
                victim.oom_kill = True
                try:
                    os.kill(victim.pid, 9)
                except (ProcessLookupError, PermissionError):
                    pass
                # the normal worker-death path fails/retries the task
        if not self._shutdown:
            self.add_timer(config.memory_monitor_interval_s,
                           self._memory_check)

    def _health_check(self):
        """Reap workers that died before registering (e.g. import failure) so
        the scheduler doesn't wait forever on a phantom spawn (reference:
        WorkerPool startup-token timeouts, `worker_pool.cc`)."""
        alive = []
        for proc, profile in self._unregistered:
            if proc.poll() is not None:
                self._spawning[profile] = max(0, self._spawning.get(profile, 0) - 1)
                sys.stderr.write(
                    f"[ray_tpu_torch] worker (profile={profile}) exited with code "
                    f"{proc.returncode} before registering — check worker "
                    "environment/imports\n"
                )
            else:
                alive.append((proc, profile))
        self._unregistered = alive
        self._schedule()
        if self._unregistered or self._spawning:
            self.add_timer(config.health_check_period_s, self._health_check)
        else:
            self._health_timer_armed = False

    def _get_idle_worker(self, profile: str) -> Optional[_WorkerConn]:
        pool = self._idle.get(profile)
        while pool:
            conn = pool.popleft()
            if conn.sock in self._workers:
                return conn
        return None

    def _return_worker(self, conn: _WorkerConn):
        conn.state = "idle"
        conn.current_task = None
        self._idle.setdefault(conn.profile, deque()).append(conn)

    def _on_worker_death(self, conn: _WorkerConn):
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        self._workers.pop(conn.sock, None)
        try:
            conn.sock.close()
        except OSError:
            pass
        for cancel in list(conn.request_cancels.values()):
            self._safe(cancel)
        conn.request_cancels.clear()
        self._release_conn_lease(conn)
        self._release_conn_holds(conn)
        # crash forensics: the dead worker's log tail rides the error so
        # ActorDiedError / WorkerCrashedError carry the actual traceback
        # or faulthandler dump (cluster mode; single-node workers share
        # the driver's stdio and have no file)
        excerpt = self._crash_log_excerpt(conn.pid)
        if self._direct_running:
            for tid in [t for t, rec in self._direct_running.items()
                        if rec[0] is conn]:
                del self._direct_running[tid]
        oom = conn.oom_kill
        if conn.actor_id is not None:
            reason = ("worker OOM-killed by the memory monitor" if oom
                      else "worker process died") + excerpt
            self._on_actor_death(conn.actor_id, reason)
        else:
            interrupted = list(conn.inflight.values()) or (
                [conn.current_task] if conn.current_task is not None else []
            )
            conn.inflight.clear()
            for spec in interrupted:
                self._release_task_resources(spec)
                if spec.retries_left > 0:
                    # OOM kills count against the SAME retry budget as
                    # crashes (reference: OOM-killed tasks retried with
                    # the task's budget, memory_monitor retry semantics)
                    spec.retries_left -= 1
                    self._record_event(spec, "RETRYING", worker_died=True,
                                       oom=oom)
                    self._enqueue_ready(spec)
                elif oom:
                    err = OutOfMemoryError(
                        f"worker (pid={conn.pid}) was OOM-killed by the "
                        f"memory monitor while running {spec.name}"
                        f"{excerpt}")
                    for oid in spec.return_ids():
                        self._object_error(oid, err)
                    self._record_event(spec, "FAILED", worker_died=True,
                                       oom=True,
                                       error=self._err_summary(err))
                else:
                    err = WorkerCrashedError(
                        f"worker (pid={conn.pid}) died while running "
                        f"{spec.name}{excerpt}"
                    )
                    for oid in spec.return_ids():
                        self._object_error(oid, err)
                    self._record_event(spec, "FAILED", worker_died=True,
                                       error=self._err_summary(err))
        self._schedule()

    # --------------------------------------------------------------- messages

    def _handle_worker_msg(self, conn: _WorkerConn, msg: dict):
        # Hot-path types first: a drained train is almost entirely done /
        # request / submit frames (the rest are connection lifecycle).
        self._m_frames += 1
        t = msg["t"]
        if t == "done":
            self._on_task_done(conn, msg)
            return
        if t == "request":
            self._handle_request(conn, msg)
            return
        if t == "submit":
            self.submit_task(msg["spec"])
            return
        if t == "direct_done":
            # completion bookkeeping for a call that travelled the direct
            # worker→worker channel (results already reached the caller)
            self._on_direct_done(conn, msg)
            return
        if t == "direct_running":
            self._on_direct_running(conn, msg)
            return
        if t == "direct_notes":
            # one coalesced train of direct_running/direct_done notes
            # (burst mode): apply in order — per-note bookkeeping matches
            # the unbatched frames, the batch just amortizes the
            # socket/dispatch cost across the callee's drained train.
            # Coalesced-pair elision: a call whose RUNNING and DONE notes
            # ride the SAME train already finished — its RUNNING note
            # would only arm the cancel seam (moot) and a timeline row
            # the FINISHED event supersedes, so skip it.  This halves
            # the event-thread work per burst call; with the kill switch
            # off notes arrive unbatched and keep full RUNNING fidelity.
            notes = msg["notes"]
            done_ids = {note["spec"].task_id for note in notes
                        if note.get("t") != "direct_running"}
            for note in notes:
                if note.get("t") == "direct_running":
                    if note["spec"].task_id not in done_ids:
                        self._on_direct_running(conn, note)
                else:
                    self._on_direct_done(conn, note)
            return
        if t == "ping":
            # Liveness probe (GCS direct probe, or a peer relaying an
            # indirect one): echo identity + incarnation so a recycled
            # port or a stale incarnation never passes for liveness.
            try:
                conn.send({"t": "pong", "node_id": self.node_id,
                           "incarnation": self.incarnation})
            except OSError:
                pass
            return
        if t == "peer_hello":
            # Another raylet dialed us: promote the conn to a peer channel
            # — unless it presents a fenced incarnation (a resurrected
            # partitioned node must re-register before its frames count).
            inc = msg.get("incarnation")
            if inc is not None and not self._peer_fence_ok(msg["node_id"],
                                                           inc):
                self._workers.pop(conn.sock, None)
                try:
                    self._sel.unregister(conn.sock)
                except (KeyError, ValueError):
                    pass
                try:
                    conn.sock.close()
                except OSError:
                    pass
                return
            peer = _PeerConn(conn.sock, msg["node_id"])
            self._workers.pop(conn.sock, None)
            self._sel.modify(conn.sock, selectors.EVENT_READ, ("peer", peer))
            self._peers.setdefault(msg["node_id"], peer)
            return
        if t == "driver_hello":
            conn.state = "driver"
            conn.send({"t": "hello_reply", "node_id": self.node_id,
                       "store_path": self.store_path,
                       "session_dir": self.session_dir,
                       "gcs_address": self.gcs_address})
            return
        if t == "register":
            conn.worker_id = msg["worker_id"]
            conn.pid = msg["pid"]
            conn.profile = msg.get("profile", "cpu")
            conn.direct_addr = msg.get("direct_addr")
            self._spawning[conn.profile] = max(
                0, self._spawning.get(conn.profile, 0) - 1
            )
            self._unregistered = [
                (p, prof) for p, prof in self._unregistered if p.pid != conn.pid
            ]
            self._return_worker(conn)
            self._schedule()
        elif t == "requeue":
            # the worker's current task blocked (nested get/wait) with
            # unstarted batch members queued behind it — take them back so
            # they can run elsewhere instead of waiting out the block.
            # Use the raylet-side spec objects (conn.inflight) — they carry
            # the batch accounting the wire copies don't.
            for wire_spec in msg["specs"]:
                spec = conn.inflight.pop(wire_spec.task_id, None)
                if spec is None:
                    continue  # already completed/raced
                self._release_task_resources(spec)
                self._record_event(spec, "REQUEUED")
                self._enqueue_ready(spec)
            self._schedule()
        elif t == "stream_item":
            self._on_stream_item(msg)
        elif t == "checkpoint":
            self._on_actor_checkpoint(conn, msg)
        elif t == "ref_events":
            self.apply_ref_events(msg["events"], conn)
        elif t == "spans":
            # worker span batch (request-flow tracing) -> GCS trace table
            self._trace_ingest(msg["spans"], msg.get("dropped", 0))
        elif t == "profile_samples":
            # worker folded-stack batch (continuous profiling) -> GCS
            # profile table on the next flush tick
            self._profile_ingest(msg["samples"], msg.get("dropped", 0))
        elif t == "metric_points":
            # worker metric delta-point batch (time-series export) -> GCS
            # metrics table on the next internal-metrics tick
            self._metric_points_ingest(msg["points"], msg.get("dropped", 0))
        elif t == "stack_reply":
            # a worker answered a live stack-dump request (ray_tpu_torch stack)
            self._on_stack_reply(conn, msg)

    def _on_task_done(self, conn: _WorkerConn, msg: dict):
        tid = msg.get("task_id")
        spec = conn.inflight.pop(tid, None) if tid is not None else None
        if spec is None:
            spec = conn.current_task
        if spec is None:
            return
        trace_t0 = time.time() if self._spec_traced(spec) else 0.0
        # Clear ALL bookkeeping for this attempt up front — a retry
        # re-enters via _enqueue_ready below and must register fresh state,
        # not have its new entries popped by this (finished) attempt.
        if conn.current_task is spec:
            conn.current_task = None
        actor = (self._actors.get(conn.actor_id)
                 if conn.actor_id is not None else None)
        if actor is not None:
            actor.inflight.pop(spec.task_id, None)
        task_failed = not msg["ok"]
        # Actors HOLD their resources while alive (released on death); every
        # other task releases at completion.
        if not (spec.kind == ACTOR_CREATION_TASK and not task_failed):
            self._release_task_resources(spec)
        retrying = (task_failed and spec.retries_left > 0
                    and msg.get("retryable", True))
        if not retrying:
            if task_failed:
                err = msg["error"]
                for oid in spec.return_ids():
                    self._object_error(oid, err)
                self._record_event(spec, self._failure_state(err),
                                   error=self._err_summary(err))
            else:
                inline: Dict[str, bytes] = msg.get("inline", {})
                stored: List[str] = msg.get("stored", [])
                sizes: Dict[str, int] = msg.get("sizes", {})
                contains: Dict[str, list] = msg.get("contains", {})
                for hex_id, blob in inline.items():
                    self._object_inline(ObjectID.from_hex(hex_id), blob,
                                        contains=contains.get(hex_id))
                for hex_id in stored:
                    oid = ObjectID.from_hex(hex_id)
                    self._obj(oid).size = sizes.get(hex_id, 0)
                    self._object_in_store(oid,
                                          contains=contains.get(hex_id))
                    # eager availability: push a secondary copy of a big
                    # (or explicitly flagged) result while it is hot
                    self._maybe_replicate(oid, force=spec.replicate,
                                          trace_ctx=spec.trace_ctx)
                self._record_event(spec, "FINISHED")
            if trace_t0:
                # result hop: done-frame processing + sealing the return
                # objects (waiter wakeups included)
                self._trace_hop(spec, "raylet.result", trace_t0,
                                status="ERROR" if task_failed else "OK")
        # worker back to pool / actor next call
        if spec.kind == ACTOR_CREATION_TASK:
            if task_failed:
                # creation failed: free the worker; a retry (if any) spawns
                # on a fresh lease, final failure kills the actor.
                conn.actor_id = None
                if actor is not None:
                    actor.conn = None
                if not retrying:
                    self._on_actor_death(spec.actor_id, "creation task failed",
                                         allow_restart=False)
                self._return_worker(conn)
            else:
                actor.state = "alive"
                actor.conn = conn
                actor.node_id = None  # executing locally, whatever was tried
                conn.state = "actor"
                # sync/async execution model, reported by the worker after
                # instantiation — gates call pipelining (admit_limit)
                actor.async_actor = bool(msg.get("async_actor"))
        elif actor is not None:
            if not conn.inflight:
                conn.state = "actor"
        else:
            # batched dispatch: the worker still has queued batch members;
            # it returns to the pool only when the last one completes.
            if not conn.inflight:
                self._return_worker(conn)
        if retrying:
            spec.retries_left -= 1
            self._record_event(spec, "RETRYING")
            # Actor-task retries must rejoin the actor's queue, not land on
            # an arbitrary idle worker with no actor instance.
            self._enqueue_ready(spec)
        if actor is not None and actor.state == "alive":
            # Deferred under a batched drain: N dones from one wakeup pump
            # the actor ONCE (one coalesced dispatch train) instead of N
            # single-message sendalls.
            self._request_pump(actor)
        self._schedule()

    # ---------------------------------------------- direct transport broker
    # (core/direct.py): the raylet's residual roles on the direct path —
    # address/lease/incarnation broker, completion bookkeeper, and the
    # fence that keeps retries exactly-once across actor restarts.

    def direct_call_info(self, actor_id: ActorID) -> Optional[dict]:
        """Broker a direct channel to an actor's worker: address + PR 8
        incarnation + restart generation.  None = stay on the relayed
        path (actor not alive here, no listener, or direct disabled)."""
        if not config.direct_calls or self._draining:
            return None
        actor = self._actors.get(actor_id)
        if actor is None or actor.state != "alive":
            return None
        if actor.node_id is not None and actor.node_id != self.node_id:
            # forwarded actor: hand out the exec-side listener the
            # creation xdone piggybacked (generation stays OURS — the
            # owner's restart counter is the fencing authority)
            if actor.direct_info is None:
                return None
            info = dict(actor.direct_info)
            info["generation"] = actor.generation
            return info
        conn = actor.conn
        if conn is None or not conn.direct_addr:
            return None
        return {"addr": conn.direct_addr, "generation": actor.generation,
                "incarnation": self.incarnation, "node_id": self.node_id,
                "pid": conn.pid}

    def acquire_direct_lease(self, spec: TaskSpec) -> Optional[dict]:
        """Lease an idle pool worker to a caller for direct normal-task
        submission (reference: worker lease reuse).  Grants only when the
        node is otherwise quiet — queued work always wins the pool — and
        holds the spec's resource shape until release/death."""
        if (not config.direct_calls or self._draining
                or self._ready_queue or self._waiting):
            return None
        need = spec.resources or {}
        if not _fits(self.resources_available, need):
            return None
        profile = self._profile_key(spec)
        conn = self._get_idle_worker(profile)
        if conn is None:
            return None
        if not conn.direct_addr:
            self._return_worker(conn)
            return None
        _acquire(self.resources_available, need)
        lease_id = f"lease-{next(self._lease_seq)}"
        conn.state = "leased"
        conn.current_task = None
        conn.lease = {"id": lease_id, "need": need}
        self._leases[lease_id] = conn
        try:
            # hand the worker the lease token: its DirectServer rejects
            # lease hellos that don't present exactly this id, so a
            # dialer can never execute tasks outside raylet accounting
            conn.send({"t": "direct_lease", "lease_id": lease_id})
        except OSError:
            # worker died under us: undo the grant, decline
            self._leases.pop(lease_id, None)
            conn.lease = None
            _release(self.resources_available, need)
            return None
        self._m_direct_leases += 1
        return {"addr": conn.direct_addr, "lease_id": lease_id,
                "generation": 0, "incarnation": self.incarnation,
                "node_id": self.node_id, "pid": conn.pid}

    def release_direct_lease(self, lease_id: str):
        conn = self._leases.pop(lease_id, None)
        if conn is None:
            return
        _release(self.resources_available, conn.lease["need"])
        conn.lease = None
        if conn.sock in self._workers:  # still alive: back to the pool
            try:
                conn.send({"t": "direct_lease", "lease_id": None})
            except OSError:
                pass  # imminent EOF reaps it
            self._return_worker(conn)
            self._schedule()

    def _release_conn_lease(self, conn: _WorkerConn):
        """Worker died while leased: give its resources back (the caller's
        channel EOF reconciles the in-flight tasks via the normal path)."""
        if conn.lease is None:
            return
        self._leases.pop(conn.lease["id"], None)
        _release(self.resources_available, conn.lease["need"])
        conn.lease = None

    def _broadcast_direct_fence(self, actor_ids=None, node_id=None):
        """Tell direct callers to tear down channels for these actors (or
        this whole node) NOW — a partitioned callee produces no socket
        EOF, so blocked callers would otherwise wait out the freeze
        instead of reconciling through the raylet."""
        msg = {"t": "direct_fence",
               "actor_ids": list(actor_ids or ()), "node_id": node_id}
        if self.direct_fence_cb is not None:
            self._safe(lambda: self.direct_fence_cb(msg))
        for conn in list(self._workers.values()):
            if not conn.uses_direct:
                continue
            try:
                conn.send(msg)
            except OSError:
                pass

    def _on_direct_running(self, conn: _WorkerConn, msg: dict):
        """In-flight visibility for direct calls (timeline/state API);
        the dispatch itself never touched this raylet.  Also the
        cancel/deadline seam for direct work: record who executes it
        (cancel frames route to that worker's control socket) and its
        fan-out edge (nested submits reap with their parent)."""
        spec = msg["spec"]
        self._record_event(spec, "RUNNING", direct=True,
                           pid=conn.pid)
        self._note_child(spec)
        self._direct_running[spec.task_id] = (conn, spec)
        if len(self._direct_running) > 8192:  # missed dones: age out
            self._direct_running.pop(next(iter(self._direct_running)))
        flag = self._cancelled_flag(spec)
        if flag is not None:
            # the note raced a cancel/deadline fan-out that already
            # walked the children index: reap it now that we know who
            # executes it
            self._note_cancelled(spec.task_id, flag)
            try:
                conn.send({"t": "cancel", "task_id": spec.task_id,
                           "deadline": flag})
            except OSError:
                self._on_worker_death(conn)

    def _on_direct_done(self, conn: Optional[_WorkerConn], msg: dict):
        spec: TaskSpec = msg["spec"]
        self._m_direct_dones += 1
        actor = (self._actors.get(spec.actor_id)
                 if spec.actor_id is not None else None)
        if actor is not None and actor.foreign_owner is not None:
            # exec side of a forwarded actor: keep the store bytes
            # registered here, relay the completion to the OWNER raylet —
            # it owns the object table entries and the task events.
            for h in msg.get("stored") or ():
                oid = ObjectID.from_hex(h)
                if self._object_status(oid) not in ("inline", "store",
                                                    "error"):
                    self._obj(oid).size = (msg.get("sizes") or {}).get(h, 0)
                    self._object_in_store(oid)
            peer = self._get_peer(actor.foreign_owner)
            if peer is not None:
                relay = {k: v for k, v in msg.items() if k != "t"}
                try:
                    peer.send({"t": "xdirect_done", "node_id": self.node_id,
                               "msg": relay})
                except OSError:
                    self._drop_peer(peer)
            return
        self._apply_direct_done(msg, store_node=None)

    def _handle_xdirect_done(self, msg: dict):
        self._apply_direct_done(msg["msg"], store_node=msg["node_id"])

    def _apply_direct_done(self, msg: dict, store_node: Optional[str]):
        """Owner-side bookkeeping for a direct completion: seal/error the
        return objects (idempotent — a raylet-path retry may already have
        resolved them), retain lineage for lease tasks, count the task
        event.  tracked=True arms the ordinary grace-free path, so a
        result whose caller already dropped every ref still gets swept."""
        spec: TaskSpec = msg["spec"]
        self._direct_running.pop(spec.task_id, None)
        keep_lineage = (spec.kind == NORMAL_TASK
                        and self._lineage_count < config.max_lineage_entries)
        if msg["ok"]:
            contains = msg.get("contains") or {}
            sizes = msg.get("sizes") or {}
            for h, blob in (msg.get("inline") or {}).items():
                oid = ObjectID.from_hex(h)
                if self._object_status(oid) in ("inline", "store", "error"):
                    continue
                st = self._obj(oid)
                st.tracked = True
                if keep_lineage and st.creating_spec is None:
                    st.creating_spec = spec
                    self._lineage_count += 1
                self._object_inline(oid, blob, contains=contains.get(h))
            for h in msg.get("stored") or ():
                oid = ObjectID.from_hex(h)
                if self._object_status(oid) in ("inline", "store", "error"):
                    continue
                st = self._obj(oid)
                st.tracked = True
                st.size = max(st.size, sizes.get(h, 0))
                if keep_lineage and st.creating_spec is None:
                    st.creating_spec = spec
                    self._lineage_count += 1
                if store_node is not None and store_node != self.node_id:
                    # bytes live in the exec node's store: register the
                    # location; a local get pulls over the data plane
                    st.status = "remote"
                    if store_node not in st.locations:
                        st.locations.append(store_node)
                    self._object_ready(oid)
                else:
                    self._object_in_store(oid, contains=contains.get(h))
                    self._maybe_replicate(oid, force=spec.replicate,
                                          trace_ctx=spec.trace_ctx)
            dur = msg.get("dur")
            if dur is not None:
                # callee-stamped exec duration: keeps timeline latency
                # visible even when the paired RUNNING note was elided
                # by the coalesced-train fast path
                self._record_event(spec, "FINISHED", direct=True,
                                   exec_s=dur)
            else:
                self._record_event(spec, "FINISHED", direct=True)
        else:
            err = msg.get("error")
            for oid in spec.return_ids():
                if self._object_status(oid) in ("inline", "store", "error"):
                    continue
                self._object_error(oid, err)
            self._record_event(spec, self._failure_state(err), direct=True,
                               error=self._err_summary(err))

    # --------------------------------------------------------------- cluster

    def _pending_demand_shapes(self, cap: int = 256):
        """Aggregate resource shapes of queued tasks that cannot run with
        current availability — the autoscaler's scale-up signal."""
        shapes: Dict[tuple, int] = {}
        for spec in itertools.islice(self._ready_queue, cap):
            need = spec.resources or {}
            if _fits(self.resources_available, need):
                continue
            key = tuple(sorted(need.items()))
            shapes[key] = shapes.get(key, 0) + 1
        return [(dict(k), n) for k, n in shapes.items()]

    def _apply_registration(self, snapshot):
        """Digest a register_node reply: adopt the incarnation the GCS
        assigned this node and refresh the peer membership view."""
        for info in snapshot or ():
            if info["node_id"] == self.node_id:
                self.incarnation = info.get("incarnation", self.incarnation)
            elif info["alive"]:
                self._cluster_nodes[info["node_id"]] = info

    def _register_with_gcs(self):
        # Proposing the incarnation we last held keeps the assigned one
        # strictly ABOVE every fence watermark peers may hold for us even
        # when the GCS lost its counters (restart without persistence).
        self._apply_registration(self.gcs.register_node(
            self.node_id, (self.node_ip, self.tcp_port),
            self.resources_total, store_path=self.store_path,
            hostname=socket.gethostname(),
            labels=self.node_labels, data_port=self.data_port,
            incarnation=self.incarnation))

    def _heartbeat(self):
        if self._drained:
            return  # drained: this node is retired, stop asserting liveness
        try:
            ok = self.gcs.heartbeat(self.node_id, self.resources_available,
                                    queue_len=len(self._ready_queue),
                                    pending_shapes=self._pending_demand_shapes(),
                                    incarnation=self.incarnation)
            if ok == "fenced":
                # This incarnation was declared dead (partition healed,
                # long stall): split-brain guard — kill the local workers
                # and come back as a fresh incarnation.
                self._on_fenced()
            elif not ok:
                # GCS lost track of us (restart): plain re-register.
                self._register_with_gcs()
        except (ConnectionError, TimeoutError, OSError):
            pass
        if not self._shutdown and not self._drained:
            self.add_timer(config.gcs_heartbeat_interval_s, self._heartbeat)

    def _on_fenced(self):
        """The GCS rejected this node's incarnation: some failure detector
        declared it dead and the cluster may already have restarted its
        actors and reconstructed its objects elsewhere.  The ONLY safe
        continuation is to kill every local worker (so no stale actor
        instance or in-flight task can double-execute side effects or
        publish stale results) and re-register under a fresh incarnation
        (reference: a fenced raylet restarts; here the process survives
        but its execution state does not)."""
        sys.stderr.write(
            f"[ray_tpu_torch] node {self.node_id[:8]}: incarnation "
            f"{self.incarnation} was fenced (declared dead) — killing "
            "local workers and re-registering\n")
        for proc in self._procs:
            try:
                proc.kill()
            except OSError:
                pass
        # Worker deaths flow back through the normal socket-EOF path
        # (task failures/retries, actor restarts per budget) — with a
        # fresh incarnation those re-assertions are accepted again.
        try:
            self._register_with_gcs()
        except (ConnectionError, TimeoutError, OSError):
            return  # next heartbeat retries the re-register
        # Re-publish surviving local store objects: the death declaration
        # pruned them from the directory, but the bytes are still valid.
        for oid, st in self._objects.items():
            if st.status == "store":
                self._gcs_post("add_object_location", oid.hex(),
                               self.node_id, st.size or 0,
                               incarnation=self.incarnation)

    def _peer_fence_ok(self, node_id: str, incarnation: int) -> bool:
        """Data-server handshake / peer-hello check (any thread): reject a
        peer presenting an incarnation that was declared dead.  Unknown
        nodes are accepted — they may simply not have registered yet from
        this node's point of view."""
        fenced = self._fenced.get(node_id)
        if fenced is not None and incarnation <= fenced:
            self._m_fenced_frames += 1  # unguarded-ok: monotonic stat counter
            return False
        return True

    def _relay_probe(self, data: dict):
        """Indirect liveness probe: the GCS asked THIS raylet to ping a
        suspect peer it cannot reach itself (covers an asymmetric
        GCS<->node partition where peers still can).  The blocking dial
        runs on a throwaway thread — never on the event loop."""
        gcs = self.gcs

        def run():
            ok = protocol.liveness_ping(
                data["address"], data["target"], data["incarnation"],
                config.gcs_probe_timeout_s)
            try:
                gcs.probe_report(data["token"], ok)
            except (ConnectionError, TimeoutError, OSError):
                pass  # GCS gone: its waiter times out on its own

        threading.Thread(target=run, name="probe-relay",
                         daemon=True).start()

    # ------------------------------------------------------ graceful drain
    # (reference: the autoscaler's DrainNode RPC before instance
    # termination.)  The GCS flipped this node's `draining` flag before
    # pushing node_drain, so no NEW placement lands here; the raylet then
    # (1) checkpoint-and-relocates checkpointable actors, (2) pushes
    # sole-copy store objects to surviving nodes via the replication path,
    # (3) waits for running tasks — all bounded by the drain deadline —
    # and reports drain_complete, which retires the node with ZERO
    # reconstructions.

    def _on_drain_request(self, timeout_s: float):
        if self._draining or self._shutdown:
            return
        self._draining = True
        self._drain_deadline = time.monotonic() + max(0.5, timeout_s)
        self._drain_stats = {"objects_migrated": 0, "actors_relocated": 0,
                             "deadline_hit": 0}
        sys.stderr.write(
            f"[ray_tpu_torch] node {self.node_id[:8]}: draining "
            f"(deadline {timeout_s:.1f}s)\n")
        # Checkpointable actors executing here: final checkpoint + graceful
        # exit; the restart re-places elsewhere (the GCS skips draining
        # nodes) and restores warm.  Non-checkpointable actors ride the
        # node-death path at completion like a crash would, minus the
        # detection latency.
        for aid, actor in list(self._actors.items()):
            if (actor.conn is not None
                    and actor.creation_spec.checkpoint_interval > 0):
                self._drain_stats["actors_relocated"] += 1
                self.kill_actor(aid, no_restart=False)
        self._drain_push_objects()
        self.add_timer(0.2, self._drain_tick)

    def _drain_sole_copies(self) -> List[ObjectID]:
        """Local store objects the directory lists no OTHER holder for —
        the set whose bytes die with this node unless migrated."""
        held = [oid for oid, st in self._objects.items()
                if st.status == "store"]
        if not held:
            return []
        locs = self._gcs_err_ok(self.gcs.get_object_locations_batch,
                                [o.hex() for o in held])
        if locs is _GCS_ERR:
            return held  # can't tell: keep pushing until the GCS answers
        sole = []
        for oid in held:
            nodes = set((locs or {}).get(oid.hex(), {}).get("nodes", ()))
            nodes.discard(self.node_id)
            if not nodes:
                sole.append(oid)
        return sole

    def _drain_push_objects(self, sole: Optional[List[ObjectID]] = None):
        now = time.monotonic()
        if sole is None:
            sole = self._drain_sole_copies()
        for oid in sole:
            st = self._objects.get(oid)
            if st is None or st.status != "store":
                continue
            last = self._drain_push_at.get(oid)
            if last is not None and now - last < 1.0:
                continue  # a push is in flight; give the pull a second
            if last is not None:
                # the previous push never registered a copy (lost frame,
                # dead target): the directory says we are still the sole
                # holder, so every recorded replica is unconfirmed — clear
                # them so the retry may pick the same target again
                st.replicas = []
            self._drain_push_at[oid] = now
            if oid not in self._drain_pushed:
                self._drain_pushed.add(oid)
                self._drain_stats["objects_migrated"] += 1
            # force one extra copy regardless of size threshold; the
            # drain tick re-pushes if the target never registered it
            st.replicated = False
            self._replicate_object(oid, st, 1)

    def _drain_tick(self):
        if self._shutdown or not self._draining or self._drained:
            return
        tasks_running = any(c.inflight for c in self._workers.values())
        actors_here = any(a.conn is not None
                          for a in self._actors.values())
        sole = self._drain_sole_copies()
        deadline_hit = time.monotonic() >= self._drain_deadline
        if (sole or tasks_running or actors_here
                or self._ready_queue) and not deadline_hit:
            if sole:
                self._drain_push_objects(sole)  # re-push stragglers
            self.add_timer(0.2, self._drain_tick)
            return
        if deadline_hit and (sole or tasks_running or actors_here):
            self._drain_stats["deadline_hit"] = 1
        self._finish_drain()

    def _finish_drain(self):
        self._drained = True
        stats = dict(self._drain_stats)
        sys.stderr.write(
            f"[ray_tpu_torch] node {self.node_id[:8]}: drain complete {stats}\n")
        self._gcs_safe(self.gcs.drain_complete, self.node_id, stats)
        # A drained node is retired: shut the raylet down (the autoscaler
        # terminates the instance; in tests the process exits cleanly).
        self._shutdown = True
        try:
            self._wake_w.send(b"\x00")
        except OSError:
            pass
        if self.on_fatal is not None:
            self._safe(self.on_fatal)

    def _gcs_push(self, event: str, data):
        """Runs on the GCS client/reader thread — hop to the event loop."""
        self.call_async(self._on_gcs_event, event, data)

    def _on_gcs_lost(self):
        """GCS connection dropped (reader thread): with reconnect enabled
        (GCS fault tolerance — the GCS restarts with persisted tables),
        retry dialing it; otherwise the node is partitioned from the
        control plane — shut down rather than orphan the worker tree."""
        if self._shutdown:
            return
        if config.gcs_reconnect_timeout_s > 0 and self.gcs_address:
            threading.Thread(target=self._gcs_reconnect_loop,
                             name="gcs-reconnect", daemon=True).start()
            return
        sys.stderr.write(
            f"[ray_tpu_torch] node {self.node_id[:8]}: GCS connection lost — "
            "shutting down\n")
        self._shutdown = True
        try:
            self._wake_w.send(b"\x00")
        except OSError:
            pass
        if self.on_fatal is not None:
            self._safe(self.on_fatal)

    def _gcs_reconnect_loop(self):
        """Reader-thread side: dial the (restarted) GCS until the timeout
        under the unified jittered-exponential backoff, then hand over to
        the event loop to re-register and re-publish this node's object
        locations."""
        deadline = time.monotonic() + config.gcs_reconnect_timeout_s
        sys.stderr.write(
            f"[ray_tpu_torch] node {self.node_id[:8]}: GCS connection lost — "
            f"reconnecting for up to {config.gcs_reconnect_timeout_s:.0f}s\n")
        # De-synchronize the herd: every raylet's reader thread saw the
        # GCS socket die at the same instant; without this full-span
        # stagger they all dial — and then re-register, re-subscribe, and
        # re-publish their whole object directories — in lockstep the
        # moment the port reopens.
        time.sleep(min(self._retry_policy.stagger(
            config.gcs_reconnect_stagger_s),
            max(0.0, deadline - time.monotonic())))
        attempt = 0
        while time.monotonic() < deadline and not self._shutdown:
            try:
                new_gcs = GcsClient(self.gcs_address,
                                    push_handler=self._gcs_push,
                                    on_disconnect=self._on_gcs_lost)
                break
            except (ConnectionError, OSError):
                time.sleep(min(self._retry_policy.delay(attempt),
                               max(0.0, deadline - time.monotonic())))
                attempt += 1
        else:
            if not self._shutdown:
                config.gcs_reconnect_timeout_s = 0.0  # no second chance
                self._on_gcs_lost()
            return
        self.call_async(self._after_gcs_reconnect, new_gcs)

    def _after_gcs_reconnect(self, new_gcs):
        """Event loop: swap the client in, re-register (node table is soft
        state), resubscribe, and re-publish this node's sealed objects to
        the rebuilt object directory.  A connection dropping again
        mid-handshake just re-enters the reconnect loop."""
        old, self.gcs = self.gcs, new_gcs
        if self._im is not None:
            new_gcs.rpc_observer = self._observe_gcs_rpc
        try:
            old.close()
        except Exception:  # noqa: BLE001
            pass
        try:
            self.gcs.subscribe_remote(node_id=self.node_id)
        except (ConnectionError, TimeoutError, OSError):
            self._on_gcs_lost()
            return
        # Ask BEFORE re-registering whether this incarnation was declared
        # dead while we were away (the fence record survives GCS restarts
        # even though membership does not): a fenced zombie must kill its
        # stale workers first — re-registering and re-asserting its actors
        # straight away could double-execute against the replacements the
        # cluster started during the outage.
        hb = self._gcs_safe(self.gcs.heartbeat, self.node_id,
                            self.resources_available,
                            incarnation=self.incarnation)
        if hb == "fenced":
            self._on_fenced()  # kills workers, re-registers fresh,
            return             # re-publishes surviving store objects
        snapshot = self._gcs_safe(
            self.gcs.register_node,
            self.node_id, (self.node_ip, self.tcp_port),
            self.resources_total, store_path=self.store_path,
            hostname=socket.gethostname(),
            labels=self.node_labels, data_port=self.data_port,
            incarnation=self.incarnation)
        if snapshot is not None:
            self._apply_registration(snapshot)
        for oid, st in self._objects.items():
            if st.status == "store":
                self._gcs_safe(self.gcs.add_object_location,
                               oid.hex(), self.node_id, size=st.size or 0,
                               incarnation=self.incarnation)
        # Reconcile actor state: the restarted GCS loaded persisted actors
        # as "restarting" (it cannot know which survived); every actor
        # LIVE on this node re-asserts itself.
        for aid, actor in self._actors.items():
            if actor.state == "alive" and actor.conn is not None:
                self._gcs_safe(self.gcs.update_actor, aid.binary(), "alive",
                               node_id=self.node_id)
        sys.stderr.write(
            f"[ray_tpu_torch] node {self.node_id[:8]}: reconnected to GCS\n")

    def _on_gcs_event(self, event: str, data):
        if event == "node_added":
            nid = data["node_id"]
            if nid != self.node_id:
                self._cluster_nodes[nid] = data
                inc = data.get("incarnation")
                if inc is not None and self._fenced.get(nid, -1) < inc:
                    # the node came back under a fresh incarnation: the
                    # fence applies to the OLD generation only
                    self._fenced.pop(nid, None)
            self._schedule()
        elif event == "node_dead":
            nid = data["node_id"]
            inc = data.get("incarnation")
            if inc is not None:
                prev = self._fenced.get(nid)
                if prev is None or inc > prev:
                    self._fenced[nid] = inc
            if nid == self.node_id:
                # Our own death declaration (drain completion, or a fence
                # we will learn about via the next rejected heartbeat) —
                # not a peer to clean up after.
                return
            self._on_node_death(nid, data.get("reason", ""))
        elif event == "node_suspect":
            nid = data["node_id"]
            suspect = bool(data.get("suspect"))
            info = self._cluster_nodes.get(nid)
            if info is not None:
                info["suspect"] = suspect
            if self._pull_manager is not None:
                # striped pulls rotate away from suspect holders (and
                # rotate back on recovery) — routing, not recovery:
                # reconstruction/replication repair fire only on DEAD
                self._pull_manager.on_node_suspect(nid, suspect)
            if suspect:
                # direct channels to the suspect node fall back to the
                # relayed path now (a false alarm costs latency, not
                # correctness — the raylet path dedups/fences)
                self._broadcast_direct_fence(node_id=nid)
            if not suspect:
                self._schedule()  # recovered: it can take work again
        elif event == "node_probe":
            self._relay_probe(data)
        elif event == "node_query":
            # targeted introspection (live stack dumps, log listings):
            # collect locally and answer with a one-way report post
            self._handle_node_query(data)
        elif event == "node_drain":
            nid = data.get("node_id")
            if nid == self.node_id:
                self._on_drain_request(float(data.get("timeout_s") or
                                             config.drain_timeout_s))
            else:
                # A peer is leaving: stop treating it as a replication /
                # locality-forwarding target while its objects migrate off.
                info = self._cluster_nodes.get(nid)
                if info is not None:
                    info["draining"] = True
        elif event == "object_at":
            oid = ObjectID.from_hex(data["oid"])
            st = self._objects.get(oid)
            if st is not None and st.status == "pending":
                st.status = "remote"
                st.locations = [data["node_id"]]
                st.size = max(st.size, data.get("size", 0))
                st.remote_inline = bool(data.get("inline", False))
                self._object_ready(oid)
            if oid in self._object_waiters or oid in self._dep_index:
                self._maybe_pull(oid)
        elif event == "pg_reserve":
            # GCS assigned this node a fragment of a cluster PG: register
            # it pending; _activate_pending_pgs (first thing every
            # schedule pass) reserves it and posts pg_fragment_ready.
            existing = self._pgs.get(data["pg_id"])
            if existing is not None and existing.fragment:
                # node-death repair can extend our fragment
                for i, b in data["bundles"].items():
                    if i not in existing.bundles:
                        existing.bundles[i] = b
                        existing.available[i] = dict(b)
                        existing.unreserved.add(i)
                        existing.state = "pending"  # reserve the new piece
            else:
                self._pgs[data["pg_id"]] = _PlacementGroup(
                    data["pg_id"], data["bundles"], "FRAGMENT",
                    fragment=True)
            self._schedule()
        elif event == "pg_ready":
            oid = self._cluster_pg_ready.pop(data["pg_id"], None)
            if oid is not None:
                self._object_inline(oid, _PG_READY_BLOB)
        elif event == "pg_remove":
            oid = self._cluster_pg_ready.pop(data["pg_id"], None)
            if oid is not None and self._object_status(oid) == "pending":
                self._object_error(oid, ValueError(
                    f"placement group {data['pg_id']} was removed before "
                    "its bundles could be reserved"))
            self.remove_pg(data["pg_id"], _from_gcs=True)

    def _on_node_death(self, node_id: str, reason: str):
        self._cluster_nodes.pop(node_id, None)
        # direct channels to workers on the dead node: tear down now (a
        # partitioned callee never produces a socket EOF)
        self._broadcast_direct_fence(node_id=node_id)
        if self._pull_manager is not None:
            # data-plane pulls sourced from the dead node rotate to other
            # holders (or fail back into _on_pull_failed for a re-lookup)
            self._pull_manager.on_node_dead(node_id)
        peer = self._peers.pop(node_id, None)
        if peer is not None:
            try:
                self._sel.unregister(peer.sock)
            except (KeyError, ValueError):
                pass
            try:
                peer.sock.close()
            except OSError:
                pass
        # In-flight pulls from the dead node: retry elsewhere.
        for oid, pull in list(self._pulls.items()):
            if pull["node"] == node_id:
                self._pull_by_rid.pop(pull["rid"], None)
                del self._pulls[oid]
                st = self._objects.get(oid)
                if st is not None and node_id in st.locations:
                    st.locations.remove(node_id)
                self._maybe_pull(oid, force_lookup=True)
        # Forwarded tasks: retry like a worker crash (actor tasks fail — the
        # actor itself restarts below and interrupted calls error).  Runs
        # BEFORE the lost-object scan so objects those retries will
        # re-produce register as in-flight and aren't double-submitted by
        # dependency reconstruction.
        for tid, (spec, nid) in list(self._forwarded.items()):
            if nid != node_id:
                continue
            del self._forwarded[tid]
            if spec.kind == ACTOR_CREATION_TASK:
                continue  # handled via the actor scan below
            if spec.kind == ACTOR_TASK:
                err = ActorDiedError(
                    spec.actor_id.hex() if spec.actor_id else "?",
                    f"node {node_id} died")
                for oid in spec.return_ids():
                    self._object_error(oid, err)
                self._record_event(spec, "FAILED", node_died=True)
            elif spec.retries_left > 0:
                spec.retries_left -= 1
                self._record_event(spec, "RETRYING", node_died=True)
                self._enqueue_ready(spec)
            else:
                err = WorkerCrashedError(
                    f"node {node_id} died while running {spec.name}")
                for oid in spec.return_ids():
                    self._object_error(oid, err)
                self._record_event(spec, "FAILED", node_died=True)
        # Remote objects whose only copy died with the node: lineage
        # reconstruction re-runs the creating task (reference:
        # ObjectRecoveryManager on node failure, object_recovery_manager.cc)
        # — ObjectLostError only when lineage is absent or the
        # reconstruction budget is exhausted.  Waiters blocked in get()
        # and dep-gated tasks stay registered: the object drops back to
        # "pending" and resolves when the re-run seals it.
        lost: List[ObjectID] = []
        for oid, st in list(self._objects.items()):
            if st.status != "remote":
                continue
            if node_id in st.locations:
                st.locations.remove(node_id)
            if not st.locations:
                lost.append(oid)
        # Eager availability: consult the directory for surviving copies
        # (replicas, or holders this raylet never heard of) BEFORE
        # falling into recompute — the GCS pruned the dead node
        # synchronously ahead of the node_dead push, so a hit here is a
        # live copy and recovery is a pull, not a re-run.  ONE batched
        # query: a dead node can take thousands of sole copies with it,
        # and per-object RPCs would serialize this thread on GCS latency.
        locs = None
        if lost:
            res = self._gcs_err_ok(self.gcs.get_object_locations_batch,
                                   [o.hex() for o in lost])
            if res is not _GCS_ERR:
                locs = res or {}
        for oid in lost:
            st = self._objects.get(oid)
            if st is None or st.status != "remote" or st.locations:
                continue  # a sibling's reconstruction already reset it
            loc = locs.get(oid.hex()) if locs is not None else None
            if loc:
                nodes = [n for n in loc["nodes"]
                         if n != self.node_id and n != node_id
                         and n in self._cluster_nodes]
                if nodes:
                    st.locations = nodes
                    st.size = max(st.size, loc.get("size", 0))
                    self._m_repl_recoveries += 1
                    if (oid in self._object_waiters
                            or oid in self._dep_index):
                        self._maybe_pull(oid)
                    continue
            if self.reconstruct_object(oid):
                continue
            self._object_error(oid, self._lost_error(
                oid, st, f"was on node {node_id} which died"))
        # Re-replication: local managed copies whose peer holder died —
        # restore the target copy count so the NEXT death is still a pull.
        repair: List[Tuple[ObjectID, "_ObjectState"]] = []
        for oid, st in list(self._objects.items()):
            if st.status != "store" or not st.replicated:
                continue
            if (node_id not in (st.replicas or ())
                    and node_id not in st.locations):
                continue
            if st.replicas and node_id in st.replicas:
                st.replicas.remove(node_id)
            if node_id in st.locations:
                st.locations.remove(node_id)
            repair.append((oid, st))
        if repair:
            res = self._gcs_err_ok(self.gcs.get_object_locations_batch,
                                   [o.hex() for o, _ in repair])
            if res is not _GCS_ERR:  # transient GCS trouble: best-effort
                for oid, st in repair:
                    loc = (res or {}).get(oid.hex()) or {}
                    if self._repair_replication(oid, st, loc,
                                                dead=node_id):
                        self._m_repl_repairs += 1
        # Actors executing on the dead node: restart per budget.
        for actor in list(self._actors.values()):
            if actor.node_id == node_id and actor.state != "dead":
                actor.node_id = None
                self._on_actor_death(actor.actor_id,
                                     f"node {node_id} died ({reason})")
        self._schedule()

    def _drop_peer(self, peer: _PeerConn):
        """Socket-level failure on a peer conn: close it; real node death is
        decided by the GCS health monitor, not by one broken socket."""
        try:
            self._sel.unregister(peer.sock)
        except (KeyError, ValueError):
            pass
        try:
            peer.sock.close()
        except OSError:
            pass
        if self._peers.get(peer.node_id) is peer:
            del self._peers[peer.node_id]

    def _get_peer(self, node_id: str) -> Optional[_PeerConn]:
        peer = self._peers.get(node_id)
        if peer is not None:
            return peer
        info = self._cluster_nodes.get(node_id)
        if info is None or not info.get("address"):
            try:
                info = self.gcs.get_node(node_id)
            except (ConnectionError, TimeoutError, OSError):
                info = None
            if info is None or not info.get("alive") or not info.get("address"):
                return None
            self._cluster_nodes[node_id] = info
        try:
            sock = socket.create_connection(tuple(info["address"]), timeout=5)
        except OSError:
            return None
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.setblocking(True)
        peer = _PeerConn(sock, node_id)
        self._peers[node_id] = peer
        self._sel.register(sock, selectors.EVENT_READ, ("peer", peer))
        peer.send({"t": "peer_hello", "node_id": self.node_id,
                   "incarnation": self.incarnation})
        return peer

    def _on_peer_readable(self, peer: _PeerConn):
        try:
            data = peer.sock.recv(1 << 20)
        except OSError:
            data = b""
        if not data:
            self._drop_peer(peer)
            return
        self._m_trains += 1
        self._m_train_bytes += len(data)
        if self._im is not None:
            self._im["train_bytes"].observe(len(data))
        peer.rbuf += data
        self._begin_drain()
        try:
            self._drain_frames(
                peer.rbuf,
                lambda msg: self._handle_peer_msg(peer, msg),
                lambda: self._peer_alive(peer))
        finally:
            self._end_drain()

    def _handle_peer_msg(self, peer: _PeerConn, msg: dict):
        self._m_frames += 1
        t = msg["t"]
        if t == "xtask":
            self._handle_xtask(peer, msg)
        elif t == "xdone":
            self._handle_xdone(msg)
        elif t == "xstream_item":
            self._handle_xstream_item(msg)
        elif t == "xactor_death":
            self._handle_xactor_death(msg)
        elif t == "xdirect_done":
            self._handle_xdirect_done(msg)
        elif t == "xkill":
            self.kill_actor(msg["actor_id"], msg.get("no_restart", True))
        elif t == "xcancel":
            # one-hop cancel relay for forwarded/foreign-executed tasks
            # (_relay=False: the origin already broadcast — no loops)
            self._cancel_tid(msg["task_id"],
                             deadline=msg.get("deadline", False),
                             recursive=msg.get("recursive", True),
                             _relay=False)
        elif t == "pull":
            self._handle_pull(peer, msg)
        elif t == "pull_meta":
            self._handle_pull_meta(msg)
        elif t == "chunk":
            self._handle_pull_chunk(msg)
        elif t == "pull_err":
            self._handle_pull_err(msg)
        elif t == "xreplicate":
            self._handle_xreplicate(msg)
        elif t == "xreplica_drop":
            self._handle_xreplica_drop(msg)
        elif t == "xcheckpoint":
            self._handle_xcheckpoint(msg)

    # ---- task forwarding (spillback / actor routing) ----

    def _forward_task(self, spec: TaskSpec, node_id: str) -> bool:
        peer = self._get_peer(node_id)
        if peer is None:
            return False
        inline_deps: Dict[str, bytes] = {}
        store_deps: Dict[str, str] = {}
        for oid in spec.dependency_ids():
            st = self._objects.get(oid)
            if st is None:
                continue
            if st.status == "inline":
                inline_deps[oid.hex()] = st.value
            elif st.status == "store":
                store_deps[oid.hex()] = (self.node_id, st.size)
            elif st.status == "remote" and st.locations:
                # ship EVERY known holder (multi-source striping seeds) +
                # size for locality/admission math + the inline flag (an
                # inline remote object must pull over the control plane —
                # the holder's STORE can't serve it)
                store_deps[oid.hex()] = (list(st.locations), st.size,
                                         st.remote_inline)
        fwd_t0 = time.time() if self._spec_traced(spec) else 0.0
        spec._acquired_pool = None
        spec._spill_count = getattr(spec, "_spill_count", 0) + 1
        self._forwarded[spec.task_id] = (spec, node_id)
        if spec.kind == ACTOR_CREATION_TASK:
            actor = self._actors.get(spec.actor_id)
            if actor is not None:
                actor.node_id = node_id  # tentative; confirmed by xdone
        self._record_event(spec, "SPILLED", to_node=node_id)
        try:
            peer.send({"t": "xtask", "spec": spec,
                       "inline_deps": inline_deps,
                       "store_deps": store_deps, "origin": self.node_id})
        except OSError:
            del self._forwarded[spec.task_id]
            if spec.kind == ACTOR_CREATION_TASK:
                actor = self._actors.get(spec.actor_id)
                if actor is not None and actor.node_id == node_id:
                    actor.node_id = None  # roll back the tentative placement
            self._drop_peer(peer)
            return False
        if fwd_t0:
            # forward hop: dep snapshotting + the xtask frame hand-off;
            # the receiving raylet opens its own inbox span on receipt
            self._trace_hop(spec, "raylet.forward", fwd_t0, to_node=node_id)
        return True

    def _handle_xtask(self, peer: _PeerConn, msg: dict):
        spec: TaskSpec = msg["spec"]
        origin: str = msg["origin"]
        for h, blob in (msg.get("inline_deps") or {}).items():
            oid = ObjectID.from_hex(h)
            if self._object_status(oid) not in ("inline", "store"):
                self._object_inline(oid, blob)
        for h, dep in (msg.get("store_deps") or {}).items():
            node, size = dep[0], dep[1]
            oid = ObjectID.from_hex(h)
            st = self._obj(oid)
            if st.status == "pending":
                st.status = "remote"
                st.locations = list(node) if isinstance(node, list) else [node]
                st.size = max(st.size, size or 0)
                if len(dep) > 2:
                    st.remote_inline = bool(dep[2])
        # Route the results back the moment every return resolves — this
        # catches every completion path (inline/store/error) with the same
        # machinery local get() uses.
        self.async_get(
            spec.return_ids(),
            lambda results, s=spec, o=origin: self._xdone_cb(o, s, results))
        if spec.num_returns == STREAMING_RETURNS:
            self._foreign_streams[spec.task_id] = origin
        self.submit_task(spec, foreign_origin=origin)

    def _xdone_cb(self, origin: str, spec: TaskSpec, results: Dict[str, tuple]):
        peer = self._get_peer(origin)
        if peer is None:
            return  # origin node is gone; results stay locally
        out = {}
        contains = {}
        for h, r in results.items():
            if r[0] == "store":
                st_out = self._objects.get(ObjectID.from_hex(h))
                out[h] = ("store", self.node_id,
                          st_out.size if st_out is not None else 0)
            else:
                out[h] = r
            st = self._objects.get(ObjectID.from_hex(h))
            if st is not None and st.contains:
                contains[h] = st.contains  # owner re-pins the inner refs
        xdone = {"t": "xdone", "task_id": spec.task_id, "results": out,
                 "contains": contains}
        if spec.kind == ACTOR_CREATION_TASK:
            # piggyback the hosted worker's direct-call listener so the
            # OWNER can broker caller→worker channels across nodes
            local = self._actors.get(spec.actor_id)
            if (local is not None and local.conn is not None
                    and local.conn.direct_addr):
                xdone["direct_info"] = {
                    "addr": local.conn.direct_addr,
                    "incarnation": self.incarnation,
                    "node_id": self.node_id,
                    "pid": local.conn.pid,
                }
        try:
            peer.send(xdone)
        except OSError:
            self._drop_peer(peer)

    def _handle_xdone(self, msg: dict):
        entry = self._forwarded.pop(msg["task_id"], None)
        spec = entry[0] if entry else None
        xdone_t0 = (time.time()
                    if spec is not None and self._spec_traced(spec) else 0.0)
        failed = False
        contains = msg.get("contains", {})
        for h, r in msg["results"].items():
            oid = ObjectID.from_hex(h)
            if r[0] == "inline":
                self._object_inline(oid, r[1], contains=contains.get(h))
            elif r[0] == "error":
                failed = True
                self._object_error(oid, r[1])
            else:  # ("store", node_id, size)
                st = self._obj(oid)
                self._set_contains(st, contains.get(h))
                if st.status in ("pending", "remote"):
                    st.status = "remote"
                    if r[1] not in st.locations:
                        st.locations.append(r[1])
                    if len(r) > 2:
                        st.size = max(st.size, r[2] or 0)
                    self._object_ready(oid)
        if spec is None:
            return
        self._record_event(spec, "FAILED" if failed else "FINISHED",
                           remote=True)
        if xdone_t0:
            # owner-side result registration for a forwarded task (the
            # executing node's raylet.result covered the seal over there)
            self._trace_hop(spec, "raylet.xdone", xdone_t0,
                            status="ERROR" if failed else "OK")
        if spec.kind == ACTOR_CREATION_TASK:
            actor = self._actors.get(spec.actor_id)
            if actor is not None:
                if failed:
                    actor.node_id = None
                    self._on_actor_death(spec.actor_id,
                                         "creation task failed",
                                         allow_restart=False)
                else:
                    actor.state = "alive"
                    actor.node_id = entry[1]
                    actor.direct_info = msg.get("direct_info")
                    if self.cluster_mode:
                        self._gcs_post("update_actor",
                                       spec.actor_id.binary(), "alive",
                                       node_id=entry[1])
                    self._pump_actor(actor)

    def _handle_xactor_death(self, msg: dict):
        actor = self._actors.get(msg["actor_id"])
        if actor is None or actor.state == "dead":
            return
        actor.node_id = None
        self._on_actor_death(msg["actor_id"], msg.get("reason", "died"))

    def _gcs_safe(self, fn, *args, **kw):
        try:
            return fn(*args, **kw)
        except (ConnectionError, TimeoutError, OSError):
            return None

    def _gcs_err_ok(self, fn, *args, **kw):
        """Like _gcs_safe but distinguishes an RPC failure (_GCS_ERR) from
        an authoritative None — callers must not treat a timeout as
        'does not exist'."""
        try:
            return fn(*args, **kw)
        except (ConnectionError, TimeoutError, OSError):
            return _GCS_ERR

    def _gcs_post(self, op: str, *args, **kw):
        """One-way GCS update (no reply wait) — keeps the event thread off
        GCS round-trips on per-object hot paths."""
        try:
            if isinstance(self.gcs, GcsClient):
                self.gcs.post(op, *args, **kw)
            else:
                getattr(self.gcs, op)(*args, **kw)
        except (ConnectionError, TimeoutError, OSError):
            pass

    # ---- chunked object pulls (reference: pull_manager.h:52) ----

    def _raylet_store(self):
        # Also called from data-plane server/receiver threads: guard the
        # lazy attach so two threads never race two attachments.
        # Double-checked locking: the unlocked probe only ever skips the
        # attach when another thread already completed it (reference
        # assignment is atomic under the GIL).
        if self._store is None and self.store_path:  # unguarded-ok: DCL probe
            from ray_tpu_torch.core.object_store import ShmObjectStore

            with self._store_lock:
                if self._store is None:
                    self._store = ShmObjectStore(self.store_path)
        return self._store  # unguarded-ok: atomic reference read

    def _peer_data_addr(self, node_id: str):
        """(host, data_port) of a peer's data-plane listener, or None when
        unknown / the peer runs without a data channel.  Called from the
        pull manager's DIALER thread (GcsClient calls are thread-safe;
        _cluster_nodes updates are GIL-atomic dict ops); a channel-less
        answer is tombstoned by the pull manager so it isn't re-queried
        per pull."""
        info = self._cluster_nodes.get(node_id)
        if info is None or not info.get("data_port"):
            info = self._gcs_safe(self.gcs.get_node, node_id)
            if info is None or not info.get("alive"):
                return None
            self._cluster_nodes[node_id] = info
        addr, port = info.get("address"), info.get("data_port")
        if not addr or not port:
            return None
        return (addr[0], port)

    # ---- bounded sender pool (python-fallback pull serving) ----

    def _pull_sender_submit(self, fn):
        """Queue a chunk-stream job onto the bounded sender pool (replaces
        the old unbounded thread-per-request spawn).  Blocking sendalls
        must stay off the event thread — two raylets pulling large objects
        from each other would deadlock on full TCP buffers."""
        if self._pull_send_q is None:
            self._pull_send_q = _queue.SimpleQueue()
        cap = max(1, config.pull_sender_threads)
        if self._pull_send_q.qsize() >= cap and self._pull_sender_count >= cap:
            self._m_pull_sender_saturated += 1
        self._pull_send_q.put(fn)
        if self._pull_sender_count < cap:
            self._pull_sender_count += 1
            threading.Thread(target=self._pull_sender_loop,
                             name=f"pull-send-{self._pull_sender_count}",
                             daemon=True).start()

    def _pull_sender_loop(self):
        q = self._pull_send_q
        while not self._shutdown:
            try:
                fn = q.get(timeout=5.0)
            except _queue.Empty:
                continue
            self._safe(fn)

    def _handle_pull(self, peer: _PeerConn, msg: dict):
        """Serve an object to a peer: inline blob in one frame, store bytes
        as a pull_meta + chunk stream.

        This is the python-fallback data path (inline objects, peers
        without a data channel, RAY_TPU_DATA_CHANNEL=0); bulk store bytes
        normally move over data_channel.py.  The chunk stream runs on the
        BOUNDED SENDER POOL: a blocking sendall on the event thread would
        stop this raylet from reading its own sockets — two raylets
        pulling large objects from each other would deadlock on full TCP
        buffers.  The store read is thread-safe (pin via get_buffer /
        release when done); _objects is only touched here on the event
        thread.
        """
        rid = msg["rid"]
        oid = ObjectID.from_hex(msg["id"])
        st = self._objects.get(oid)
        inline_value = st.value if (st is not None and st.status == "inline") \
            else None
        store = self._raylet_store()

        def stream():
            try:
                if inline_value is not None:
                    peer.send({"t": "pull_meta", "rid": rid, "kind": "inline",
                               "size": len(inline_value)})
                    peer.send({"t": "chunk", "rid": rid, "data": inline_value,
                               "eof": True})
                    return
                buf = store.get_buffer(oid) if store is not None else None
                if buf is None and store is not None \
                        and store.has_spilled(oid):
                    # stream the spilled file from disk, chunk by chunk —
                    # never materialize (possibly store-sized+) bytes
                    try:
                        f = open(store._spill_path(oid), "rb")
                    except OSError:
                        peer.send({"t": "pull_err", "rid": rid,
                                   "error": f"object {oid.hex()} freed"})
                        return
                    with f:
                        size = os.fstat(f.fileno()).st_size
                        peer.send({"t": "pull_meta", "rid": rid,
                                   "kind": "store", "size": size})
                        chunk = config.object_transfer_chunk_bytes
                        sent = 0
                        while True:
                            data = f.read(chunk)
                            sent += len(data)
                            eof = sent >= size or not data
                            peer.send({"t": "chunk", "rid": rid,
                                       "data": data, "eof": eof})
                            if eof:
                                break
                    return
                if buf is None:
                    peer.send({"t": "pull_err", "rid": rid,
                               "error": f"object {oid.hex()} not here"})
                    return
                try:
                    size = len(buf)
                    peer.send({"t": "pull_meta", "rid": rid, "kind": "store",
                               "size": size})
                    chunk = config.object_transfer_chunk_bytes
                    for off in range(0, size, chunk):
                        peer.send({"t": "chunk", "rid": rid,
                                   "data": bytes(buf[off:off + chunk]),
                                   "eof": off + chunk >= size})
                    if size == 0:
                        peer.send({"t": "chunk", "rid": rid, "data": b"",
                                   "eof": True})
                finally:
                    del buf
                    store.release(oid)
            except OSError:
                self.call_async(self._drop_peer, peer)

        self._pull_sender_submit(stream)

    def _maybe_pull(self, oid: ObjectID, force_lookup: bool = False,
                    priority: int = 1, trace_ctx: Optional[dict] = None):
        """Start fetching a non-local object.  Location from local metadata,
        else the GCS directory (registering a watch when unknown).

        ``priority``: 0 = task-argument pull (admitted ahead of
        speculative/get prefetch, which is 1) — only meaningful on the
        pull-manager path.

        ``trace_ctx``: span context of the request whose arguments need
        this object — the pull becomes a child span in its waterfall
        (one per data-channel pull, emitted when the pull concludes).

        Store objects normally move over the zero-copy data plane
        (pull_manager striping across every known holder); inline objects
        and peers without a data channel fall back to the single-source
        pickled-chunk path below."""
        if not self.cluster_mode:
            return
        st = self._obj(oid)
        if st.status not in ("pending", "remote") or oid in self._pulls:
            return
        if (trace_ctx is not None and trace_ctx.get("sampled", True)
                and _tracing.tracing_enabled()
                and oid not in self._pull_trace):
            if len(self._pull_trace) > 2048:  # never-concluding watches
                self._pull_trace.pop(next(iter(self._pull_trace)))
            self._pull_trace[oid] = (time.time(), trace_ctx)
        if (self._pull_manager is not None and not force_lookup
                and self._pull_manager.active(oid)):
            # already pulling: request() below would only dedup — but let a
            # task-arg call bump a queued prefetch's admission priority
            if priority == 0:
                self._pull_manager.request(oid, st.size, list(st.locations),
                                           priority=0)
            return
        if st.status == "pending" or force_lookup or not st.locations:
            loc = self._gcs_safe(self.gcs.get_object_locations, oid.hex(),
                                 watcher=self.node_id)
            if not loc or not loc["nodes"]:
                return  # watch registered; object_at retriggers us
            st.locations = [n for n in loc["nodes"] if n != self.node_id]
            if not st.locations:
                return
            st.size = max(st.size, loc.get("size", 0))
            st.remote_inline = bool(loc.get("inline", False))
            if st.status == "pending":
                st.status = "remote"
        if (self._pull_manager is not None and config.data_channel
                and not st.remote_inline):
            if self._pull_manager.request(oid, st.size, list(st.locations),
                                          priority=priority):
                return
            # no holder reachable on the data plane: fall through to the
            # control-plane path (peer may predate the data channel)
        # Randomize the holder so N concurrent pullers don't all hammer
        # locations[0] (the multi-source data plane stripes instead; this
        # is the single-channel fallback).
        target = random.choice(st.locations)
        peer = self._get_peer(target)
        if peer is None:
            # Unreachable holder: drop it from the directory too (else a
            # force_lookup keeps returning the same node until the GCS
            # health timeout) and retry on a timer rather than recursing.
            st.locations.remove(target)
            self._gcs_post("remove_object_location", oid.hex(), target)
            if st.locations:
                self._maybe_pull(oid)
            else:
                st.status = "pending"
                self._recover_or_retry(oid, st)
            return
        rid = next(self._pull_rid)
        self._pulls[oid] = {"rid": rid, "node": target, "kind": None,
                            "buf": None, "mv": None, "off": 0, "oid": oid}
        self._pull_by_rid[rid] = oid
        try:
            peer.send({"t": "pull", "rid": rid, "id": oid.hex()})
        except OSError:
            self._pull_by_rid.pop(rid, None)
            self._pulls.pop(oid, None)
            self._drop_peer(peer)

    def _handle_pull_meta(self, msg: dict):
        oid = self._pull_by_rid.get(msg["rid"])
        if oid is None:
            return
        pull = self._pulls[oid]
        pull["kind"] = msg["kind"]
        pull["size"] = msg["size"]
        st_meta = self._objects.get(oid)
        if st_meta is not None:
            st_meta.size = max(st_meta.size, msg["size"])
        if msg["kind"] == "store" and msg["size"] > 0:
            store = self._raylet_store()
            try:
                # spill mode: never evict sealed data to admit a pull;
                # overflow lands in the spill dir at eof instead
                pull["mv"] = store.create(
                    oid, msg["size"],
                    allow_evict=not config.object_store_spill)
            except FileExistsError:
                pass  # already local (raced another pull path)
            except Exception:  # noqa: BLE001  (store full etc.)
                pull["mv"] = None
        if pull["kind"] == "inline" or pull["mv"] is None:
            pull["buf"] = bytearray()

    def _handle_pull_chunk(self, msg: dict):
        oid = self._pull_by_rid.get(msg["rid"])
        if oid is None:
            return
        pull = self._pulls[oid]
        data = msg["data"]
        if pull.get("mv") is not None:
            mv = pull["mv"]
            mv[pull["off"]:pull["off"] + len(data)] = data
            pull["off"] += len(data)
        elif pull.get("buf") is not None:
            pull["buf"] += data
        if not msg.get("eof"):
            return
        # complete
        self._pull_by_rid.pop(msg["rid"], None)
        del self._pulls[oid]
        self._finish_pull_trace(oid, "control_plane")
        st = self._obj(oid)
        if pull["kind"] == "inline":
            self._object_inline(oid, bytes(pull["buf"]))
            return
        store = self._raylet_store()
        if pull.get("mv") is not None:
            del pull["mv"]
            store.seal(oid)
            store.release(oid)
        elif store is not None:
            try:
                mv = store.create(
                    oid, len(pull["buf"]),
                    allow_evict=not config.object_store_spill)
                mv[:] = pull["buf"]
                del mv
                store.seal(oid)
                store.release(oid)
            except FileExistsError:
                pass
            except Exception:  # noqa: BLE001
                if config.object_store_spill:
                    # no arena room: the pulled bytes overflow to disk
                    store.spill_raw(oid, pull["buf"])
                else:
                    self._object_error(oid, ObjectLostError(
                        f"no store capacity for pulled object {oid.hex()}"))
                    return
        self._object_in_store(oid)

    def _handle_pull_err(self, msg: dict):
        oid = self._pull_by_rid.pop(msg["rid"], None)
        if oid is None:
            return
        self._finish_pull_trace(oid, "control_plane", status="ERROR",
                                error=str(msg.get("error", "pull failed")))
        pull = self._pulls.pop(oid, None)
        st = self._objects.get(oid)
        if st is not None and pull is not None:
            if pull["node"] in st.locations:
                st.locations.remove(pull["node"])
            self._gcs_post("remove_object_location", oid.hex(),
                           pull["node"])
            if st.status == "remote":
                if st.locations:
                    self._maybe_pull(oid)
                else:
                    st.status = "pending"
                    self._recover_or_retry(oid, st)

    def _finish_pull_trace(self, oid: ObjectID, path: str,
                           status: str = "OK", error: Optional[str] = None):
        """Close out a traced argument pull: one ``pull.fetch`` child span
        under the requesting task, with the transfer path (data_channel /
        control fallback) and byte count from the directory metadata."""
        rec = self._pull_trace.pop(oid, None)
        if rec is None:
            return
        t0, ctx = rec
        st = self._objects.get(oid)
        _tracing.hop(f"pull.fetch {oid.hex()[:8]}", ctx, t0, time.time(),
                     status=status, error=error, proc="raylet",
                     oid=oid.hex(), path=path,
                     bytes=(st.size if st is not None else 0) or 0)
        self._arm_trace_flush()

    # ---- data-plane pull callbacks (posted by the pull manager) ----

    def _on_pull_done(self, oid: ObjectID):
        """A data-plane pull sealed the object in the local store."""
        self._finish_pull_trace(oid, "data_channel")
        st = self._obj(oid)
        if st.status in ("pending", "remote"):
            self._object_in_store(oid)

    def _on_pull_failed(self, oid: ObjectID, bad_nodes: List[str]):
        """Every data-plane source failed: scrub the dead holders from the
        directory and re-resolve with backoff (mirrors _handle_pull_err);
        the retry may pick fresh holders, fall back to the control-plane
        path when no data channel can be dialed — or, when no holder
        exists anywhere anymore, reconstruct from lineage."""
        self._finish_pull_trace(oid, "data_channel", status="ERROR",
                                error=f"all sources failed: {bad_nodes}")
        st = self._objects.get(oid)
        if st is None or st.status not in ("pending", "remote"):
            return
        for node in bad_nodes:
            if node in st.locations:
                st.locations.remove(node)
            self._gcs_post("remove_object_location", oid.hex(), node)
        if oid not in self._object_waiters and oid not in self._dep_index:
            # nobody is waiting anymore; an abandoned replication pull
            # must drop its marker too (best-effort, no retry)
            self._replicating.discard(oid)
            return
        if st.locations:
            self._maybe_pull(oid)
            return
        st.status = "pending"
        self._recover_or_retry(oid, st)

    def _recover_or_retry(self, oid: ObjectID, st: "_ObjectState"):
        """A previously sealed object has no reachable holder left.  Order
        of recovery: (1) re-resolve the directory — another live node may
        hold a copy this raylet hasn't heard of; (2) reconstruct from
        lineage; (3) no lineage (ray.put / actor result): retry the
        lookup with backoff — a holder may still re-register (e.g. after
        a GCS restart).  When lineage exists but reconstruction is
        impossible (budget exhausted, unrecoverable dependency), the
        object errors NOW so waiters raise ObjectLostError instead of
        hanging on a directory watch that can never fire."""
        loc = self._gcs_err_ok(self.gcs.get_object_locations, oid.hex(),
                               watcher=self.node_id)
        if loc is not _GCS_ERR:
            nodes = [n for n in (loc or {}).get("nodes", ())
                     if n != self.node_id and n in self._cluster_nodes]
            if nodes:
                # Retry via a backoff timer, not inline: the directory may
                # still list a dying node the health monitor hasn't pruned
                # yet, and an inline _maybe_pull would mutually recurse
                # through this path until it is.
                st.locations = nodes
                st.status = "remote"
                st.lookup_attempts += 1
                self.add_timer(
                    self._retry_policy.delay(st.lookup_attempts - 1),
                    lambda: self._maybe_pull(oid))
                return
            if st.creating_spec is not None:
                if not self.reconstruct_object(oid):
                    self._object_error(oid, self._lost_error(
                        oid, st, "has no reachable copy left"))
                return
        # GCS unreachable, or reachable but no lineage: backoff retry
        st.lookup_attempts += 1
        self.add_timer(self._retry_policy.delay(st.lookup_attempts - 1),
                       lambda: self._maybe_pull(oid, force_lookup=True))

    def _pull_tick(self):
        """Repeating watchdog: stalled-range rotation + admission retries
        for the pull manager (event thread)."""
        if self._pull_manager is not None:
            self._pull_manager.tick()
        if not self._shutdown:
            self.add_timer(1.0, self._pull_tick)

    def _remote_deps_pending(self, spec: TaskSpec) -> bool:
        """True when some dependency is not locally materialized — triggers
        the pulls; the task re-enters dispatch when they land.  ("pending"
        can appear here too when a holder node died after dep gating.)"""
        pending = False
        for oid in spec.dependency_ids():
            st = self._objects.get(oid)
            status = st.status if st is not None else "pending"
            if status not in ("inline", "store", "error"):
                self._maybe_pull(oid, priority=0,  # task arg: high priority
                                 trace_ctx=spec.trace_ctx)
                pending = True
        return pending

    # --------------------------------------------------------------- refcount

    def apply_ref_events(self, events: List[Tuple[str, ObjectID]],
                         conn: Optional[_WorkerConn] = None):
        """Ordered hold ("h") / release ("r") transitions from one process
        (reference: ReferenceCounter updates).  Free happens only after a
        grace period at zero — covers the window where a ref travels
        inside a serialized result before the receiver announces its
        hold (the full borrowing protocol's job).  ``conn``-attributed
        holds are force-released if the process dies without flushing."""
        for kind, oid in events:
            st = self._obj(oid)
            if kind == "h":
                st.holders += 1
                st.tracked = True
                if conn is not None:
                    conn.held[oid] = conn.held.get(oid, 0) + 1
            else:
                st.holders -= 1
                if conn is not None:
                    n = conn.held.get(oid, 0) - 1
                    if n <= 0:
                        conn.held.pop(oid, None)
                    else:
                        conn.held[oid] = n
                self._maybe_free(oid)

    def _release_conn_holds(self, conn: _WorkerConn):
        """A worker/driver process died: drop every hold it still had."""
        for oid, n in conn.held.items():
            st = self._objects.get(oid)
            if st is not None:
                st.holders -= n
                self._maybe_free(oid)
        conn.held.clear()

    def release_refs(self, oids: List[ObjectID]):
        self.apply_ref_events([("r", o) for o in oids])

    def drop_object(self, oid: ObjectID):
        """Explicit user free: remove the entry now, releasing any borrow
        pins its bytes held on inner refs."""
        st = self._objects.pop(oid, None)
        if st is not None:
            self._teardown_entry(oid, st)

    def _teardown_entry(self, oid: ObjectID, st: "_ObjectState"):
        """Shared final teardown for a removed object entry (explicit free
        and auto-free): lineage accounting, store bytes, borrow-pin
        release, location directory."""
        if st.creating_spec is not None:
            self._lineage_count -= 1
        if st.status == "store":
            store = self._raylet_store()
            if store is not None:
                try:
                    store.delete(oid)
                except Exception:  # noqa: BLE001
                    pass
        if st.contains:
            # this blob's inner refs lose their borrow pins; they free in
            # turn once nothing else holds them
            for inner in st.contains:
                inner_st = self._objects.get(inner)
                if inner_st is not None:
                    inner_st.pins -= 1
                    self._maybe_free(inner)
        if self.cluster_mode:
            self._gcs_post("remove_object_location", oid.hex(), self.node_id)
        if st.replicas:
            # the primary is gone for good: managed secondaries must not
            # outlive it (they hold no refs of their own)
            for node in st.replicas:
                peer = self._get_peer(node)
                if peer is None:
                    continue
                try:
                    peer.send({"t": "xreplica_drop", "id": oid.hex()})
                except OSError:
                    self._drop_peer(peer)

    def _maybe_free(self, oid: ObjectID):
        st = self._objects.get(oid)
        if (st is None or not st.tracked or st.holders > 0 or st.pins > 0
                or st.free_armed):
            return
        if st.status == "pending":
            # in-flight result: never drop the entry (and its lineage) out
            # from under the producing task — re-checked on resolution
            # (_object_ready calls _maybe_free)
            return
        if oid in self._dep_index or oid in self._object_waiters:
            return
        st.free_armed = True
        # Batched grace queue: a 10k-task fan-out frees 10k objects in a
        # burst — one timer per object is 10k heap pushes now and 10k
        # callback pops at grace expiry.  The grace period is a constant,
        # so deadlines are monotonic: a FIFO deque + ONE sweeper timer
        # gives the same semantics for O(1) per free.
        self._free_queue.append((time.monotonic() + config.ref_free_grace_s,
                                 oid))
        if not self._free_sweep_armed:
            self._free_sweep_armed = True
            self.add_timer(config.ref_free_grace_s, self._sweep_free_queue)

    def _sweep_free_queue(self):
        now = time.monotonic()
        q = self._free_queue
        while q and q[0][0] <= now:
            _, oid = q.popleft()
            self._safe(lambda o=oid: self._free_if_unreferenced(o))
        if q:
            self.add_timer(max(0.0, q[0][0] - now), self._sweep_free_queue)
        else:
            self._free_sweep_armed = False

    def _free_if_unreferenced(self, oid: ObjectID):
        st = self._objects.get(oid)
        if st is None:
            return
        st.free_armed = False
        if (st.holders > 0 or st.pins > 0 or st.status == "pending"
                or oid in self._dep_index or oid in self._object_waiters):
            return
        del self._objects[oid]
        self._teardown_entry(oid, st)

    def _pin_deps(self, spec: TaskSpec):
        """Pin dependency objects — declared top-level deps AND refs
        serialized inside inline arg values (spec.inner_refs, the borrow
        pins) — for the task's lifetime: released when every return
        resolves (the same all-paths completion signal the cluster xdone
        path uses).  The executor's own hold announcements are flushed
        ahead of its done message, so by release time any ref the task
        kept is already counted."""
        deps = list(spec.dependency_ids())
        if spec.inner_refs:
            deps += spec.inner_refs
        if not deps:
            return
        for oid in deps:
            self._obj(oid).pins += 1

        def unpin(_results, deps=deps):
            for oid in deps:
                st = self._objects.get(oid)
                if st is not None:
                    st.pins -= 1
                    self._maybe_free(oid)

        self.async_get(spec.return_ids(), unpin)

    def _lost_error(self, oid: ObjectID, st: Optional["_ObjectState"],
                    why: str) -> ObjectLostError:
        """ObjectLostError whose message says WHY recovery didn't run:
        missing lineage vs an exhausted reconstruction budget."""
        spec = st.creating_spec if st is not None else None
        if spec is None:
            detail = ("no lineage retained (ray.put / actor result, or "
                      "the lineage cap evicted it)")
        elif (st.recon_attempts >= config.max_object_reconstructions
                or spec.retries_left <= 0):
            detail = (f"reconstruction budget exhausted after "
                      f"{st.recon_attempts} reconstruction(s) "
                      f"(max_object_reconstructions="
                      f"{config.max_object_reconstructions}, "
                      f"retries_left={max(0, spec.retries_left)})")
        else:
            detail = ("a dependency could not be recovered (missing "
                      "lineage, errored, or reconstruction depth cap)")
        return ObjectLostError(f"object {oid.hex()} {why}; {detail}")

    def _task_in_flight(self, tid: TaskID) -> bool:
        """Is the task currently producing its returns (queued, dep-gated,
        forwarded, dispatched, or already reconstructing)?  Used to avoid
        double-submitting a creating task during recovery."""
        if (tid in self._reconstructing or tid in self._waiting
                or tid in self._forwarded):
            return True
        if any(s.task_id == tid for s in self._ready_queue):
            return True
        if any(tid in c.inflight for c in self._workers.values()):
            return True
        return any(tid in a.inflight
                   or any(s.task_id == tid for s in a.queue)
                   for a in self._actors.values())

    def _live_locations(self, st: "_ObjectState") -> List[str]:
        return [n for n in st.locations
                if n == self.node_id or n in self._cluster_nodes]

    def _dep_recoverable(self, dep: ObjectID, store, _depth: int) -> bool:
        """Ensure one dependency of a task being reconstructed is (or will
        become) materializable: live remote holders first, then the GCS
        directory, then recursive reconstruction — including deps whose
        only copy died with a node.  An unrecoverable dep is ERRORED here
        (not just reported False): its own waiters must raise rather than
        hang, and the node-death scan won't revisit it once its status
        left "remote"."""
        ds = self._objects.get(dep)
        status = ds.status if ds is not None else "pending"
        if status == "inline":
            return True
        if status == "error":
            return False  # re-running the parent can only re-fail
        if status == "store":
            if store is None or store.contains(dep):
                return True  # bytes are present locally
        elif status == "remote":
            if self._live_locations(ds):
                return True  # another live holder; dispatch-time pull
            # re-resolve across the cluster: the directory may know
            # holders this raylet hasn't heard of.  A transient GCS
            # failure is NOT "no holders" — leave the dep alone and let
            # the dispatch-time pull retry through the backoff paths.
            loc = self._gcs_err_ok(self.gcs.get_object_locations,
                                   dep.hex(), watcher=self.node_id)
            if loc is _GCS_ERR:
                return True
            nodes = [n for n in (loc or {}).get("nodes", ())
                     if n == self.node_id or n in self._cluster_nodes]
            if nodes:
                ds.locations = [n for n in nodes if n != self.node_id] \
                    or nodes
                return True
            ds.status = "pending"
            ds.locations = []
        elif status == "pending" and self._task_in_flight(dep.task_id()):
            return True  # producer in flight; dependency gating waits
        if self.reconstruct_object(dep, _depth + 1):
            return True
        self._object_error(dep, self._lost_error(
            dep, self._objects.get(dep), "has no reachable copy left"))
        return False

    def reconstruct_object(self, oid: ObjectID, _depth: int = 0) -> bool:
        """Lineage reconstruction (reference: ObjectRecoveryManager,
        `object_recovery_manager.h:41`): re-run the task that created an
        object whose bytes were evicted — or whose only copy died with a
        node — under the per-object reconstruction budget.  Missing
        dependencies re-resolve across the cluster (live holders first)
        or reconstruct recursively (bounded depth).  Returns False when
        lineage is absent or the budget is exhausted; the caller raises
        ObjectLostError."""
        st = self._objects.get(oid)
        spec = st.creating_spec if st is not None else None
        if (spec is None or spec.kind != NORMAL_TASK
                or _depth > config.max_reconstruction_depth):
            return False
        if spec.task_id in self._reconstructing:
            return True  # already re-running; the waiter resolves with it
        store = self._raylet_store()
        if (st.status == "store" and store is not None
                and store.contains(oid)):
            return True  # false alarm: bytes are present
        if st.status == "remote" and self._live_locations(st):
            return True  # a live holder remains: pull, don't re-run
        if self._task_in_flight(spec.task_id):
            # Creating task already re-queued/dispatched — e.g. the
            # forwarded-task retry loop re-enqueued it in this same
            # node-death pass (the return can still read "remote" with no
            # locations then).  Submitting again would run the task twice
            # concurrently and burn two budget units for one death.
            return True
        # ---- budget: reconstructions are capped per object AND draw down
        # the spec's retries_left, so crash-retries + reconstruction share
        # one budget (reference: task max_retries bounds both).
        if (st.recon_attempts >= config.max_object_reconstructions
                or spec.retries_left <= 0):
            return False
        # Dependency check BEFORE resetting the return objects: an
        # unrecoverable dep aborts reconstruction, and sibling returns
        # that are still sealed (e.g. in the local store) must keep their
        # status — resetting them first would strand them "pending".
        for dep in spec.dependency_ids():
            if not self._dep_recoverable(dep, store, _depth):
                return False
        for rid in spec.return_ids():
            s2 = self._obj(rid)
            if s2.status in ("store", "remote"):
                s2.status = "pending"
                s2.locations = []
                # the re-run may produce different bytes (nondeterministic
                # task): stale sizes must not skip the next pull's META
                s2.size = 0
                s2.remote_inline = False
        for rid in spec.return_ids():
            self._obj(rid).recon_attempts += 1
        spec.retries_left -= 1
        spec._acquired_pool = None
        spec._spill_count = 0  # fresh placement budget for the re-run
        self._m_recon_attempts += 1
        if self._im is not None:
            self._im["recon_depth"].observe(_depth)
        if _tracing.tracing_enabled():
            # recovery spans parent under the request that produced the
            # lost object (its ctx rides the retained creating spec)
            self._recon_trace[spec.task_id] = (time.time(), spec.trace_ctx,
                                               oid.hex())
        self._reconstructing.add(spec.task_id)
        self.async_get(spec.return_ids(),
                       lambda results, s=spec: self._on_recon_done(s, results))
        self._record_event(spec, "RECONSTRUCTING", depth=_depth)
        self.submit_task(spec)
        return True

    def _on_recon_done(self, spec: TaskSpec, results: Dict[str, tuple]):
        """All returns of a reconstruction attempt resolved (sealed or
        errored) — close out the attempt and count the outcome."""
        self._reconstructing.discard(spec.task_id)
        failed = any(r[0] == "error" for r in results.values())
        rec = self._recon_trace.pop(spec.task_id, None)
        if rec is not None:
            t0, ctx, oid_hex = rec
            _tracing.hop(f"recovery.reconstruct {spec.name}", ctx, t0,
                         time.time(),
                         status="ERROR" if failed else "OK",
                         proc="raylet", object_id=oid_hex,
                         task_id=spec.task_id.hex())
            self._arm_trace_flush()
        if failed:
            self._m_recon_failures += 1
        else:
            self._m_recon_successes += 1
            self._record_event(spec, "RECONSTRUCTED")

    # ------------------------------------------- eager replication
    # (cheap availability: recovery should be a copy, not a recompute —
    # reference: secondary object copies, SURVEY §3 object manager / §5
    # failure recovery.  The push rides the PR 4 data plane: the producer
    # asks the target to PULL, so striping/admission/failover all reuse
    # the pull manager.)

    def _maybe_replicate(self, oid: ObjectID, force: bool = False,
                         trace_ctx: Optional[dict] = None):
        """Push secondary copies of a locally sealed store object when it
        crosses the auto-threshold (RAY_TPU_REPLICATION_MIN_BYTES) or was
        explicitly flagged (``force``: _replicate option / checkpoint).
        ``trace_ctx``: the producing request's span context — the
        replication push shows up in its waterfall."""
        if not self.cluster_mode:
            return
        st = self._objects.get(oid)
        if st is None or st.status != "store" or st.replicated:
            return
        thresh = config.replication_min_bytes
        if not force and (thresh <= 0 or (st.size or 0) < thresh):
            return
        t0 = time.time() if _tracing.tracing_enabled() else 0.0
        sent = self._replicate_object(oid, st,
                                      max(1, config.replication_factor) - 1)
        if t0 and sent:
            _tracing.hop(f"recovery.replicate {oid.hex()[:8]}", trace_ctx,
                         t0, time.time(), proc="raylet", oid=oid.hex(),
                         targets=sent, bytes=st.size or 0)
            self._arm_trace_flush()

    def _replicate_object(self, oid: ObjectID, st: "_ObjectState",
                          count: int, exclude=(), attempt: int = 0) -> int:
        """Ask up to ``count`` live peers (none of which hold the object)
        to pull a copy from this node.  Pushes are fire-and-forget, so a
        delayed verify pass re-checks the directory and re-pushes when a
        target never registered its copy (died mid-pull, store-less,
        abandoned pull) — without it a silently failed push would leave
        the object unprotected forever while marked replicated."""
        if count <= 0:
            return 0
        have = {self.node_id} | set(st.locations) \
            | set(st.replicas or ()) | set(exclude)
        cands = [n for n, info in self._cluster_nodes.items()
                 if n not in have and info.get("alive", True)
                 # never push availability copies at a node that is itself
                 # suspected dead or being drained away
                 and not info.get("suspect") and not info.get("draining")
                 # a node registered WITHOUT a store can't hold a replica
                 # (node_added pushes lack the key: treat unknown as ok)
                 and (info.get("store_path") or "store_path" not in info)]
        if not cands:
            return 0
        random.shuffle(cands)
        sent = 0
        for target in cands:
            if sent >= count:
                break
            peer = self._get_peer(target)
            if peer is None:
                continue
            try:
                peer.send({"t": "xreplicate", "id": oid.hex(),
                           "size": st.size or 0, "src": self.node_id})
            except OSError:
                self._drop_peer(peer)
                continue
            if st.replicas is None:
                st.replicas = []
            st.replicas.append(target)
            sent += 1
            self._m_repl_pushes += 1
            self._m_repl_bytes += st.size or 0
        if sent:
            st.replicated = True
            if attempt < 2:
                self.add_timer(
                    max(0.5, config.replication_verify_delay_s),
                    lambda: self._verify_replication(oid, attempt + 1))
        return sent

    def _verify_replication(self, oid: ObjectID, attempt: int):
        """Delayed confirmation of a push round: targets that never
        registered their copy are scrubbed and replaced (bounded
        rounds).  An extra copy from a slow-but-successful pull racing
        the verify is tolerated — over-replication wastes a little
        store space, under-replication breaks the availability story."""
        st = self._objects.get(oid)
        if st is None or st.status != "store" or not st.replicated:
            return
        loc = self._gcs_err_ok(self.gcs.get_object_locations, oid.hex())
        if loc is _GCS_ERR:
            return
        registered = set((loc or {}).get("replicas", ()))
        st.replicas = sorted(registered - {self.node_id})
        self._repair_replication(oid, st, loc or {}, attempt=attempt)

    def _repair_replication(self, oid: ObjectID, st: "_ObjectState",
                            loc: dict, dead: Optional[str] = None,
                            attempt: int = 0) -> int:
        """Push enough fresh copies to restore the target count.  The
        deficit counts MANAGED copies only (directory ``replicas`` plus
        this primary): incidental consumer-side caches in ``nodes`` are
        transient, and counting them as durable copies would silently
        skip the repair right until they evict.  Current holders (caches
        included) are still excluded as push TARGETS — they already
        have the bytes."""
        nodes = set(loc.get("nodes", ()))
        managed = set(loc.get("replicas", ())) | {self.node_id}
        if dead is not None:
            managed.discard(dead)
        deficit = max(1, config.replication_factor) - len(managed)
        if deficit <= 0:
            return 0
        return self._replicate_object(oid, st, deficit, exclude=nodes,
                                      attempt=attempt)

    def _handle_xreplicate(self, msg: dict):
        """A peer sealed an object and wants a secondary copy here: pull
        it through the normal machinery (data plane when available).  The
        seal path marks the copy as a replica (``_replicating``)."""
        if not self.store_path:
            return  # store-less node: nowhere to hold a replica
        oid = ObjectID.from_hex(msg["id"])
        st = self._obj(oid)
        if st.status in ("inline", "store", "error"):
            return  # already local (or failed): nothing to do
        self._replicating.add(oid)
        src = msg.get("src")
        if src and src not in st.locations:
            st.locations.append(src)
        st.size = max(st.size, msg.get("size", 0))
        if st.status == "pending":
            st.status = "remote"
        self._maybe_pull(oid)

    def _handle_xreplica_drop(self, msg: dict):
        """The producer freed the primary: drop the managed replica —
        unless local work picked up references to it in the meantime, in
        which case it demotes to an ordinary refcounted entry."""
        oid = ObjectID.from_hex(msg["id"])
        st = self._objects.get(oid)
        if st is None:
            return
        if (st.holders > 0 or st.pins > 0 or oid in self._dep_index
                or oid in self._object_waiters):
            st.replicated = False
            return
        self.drop_object(oid)

    # --------------------------------------------- actor checkpoints

    def _on_actor_checkpoint(self, conn: _WorkerConn, msg: dict):
        """A checkpointable actor's worker snapshotted its state: seal the
        checkpoint object here, replicate it, and record it on the actor
        (relaying to the owner when the actor executes here for another
        raylet)."""
        oid = ObjectID.from_hex(msg["id"])
        inline = msg.get("inline")
        actor = (self._actors.get(conn.actor_id)
                 if conn.actor_id is not None else None)
        if actor is None or actor.conn is not conn:
            # Stale (buffered bytes from a conn whose actor already died
            # or restarted elsewhere): REJECT before sealing — a sealed
            # checkpoint nobody records would never be pinned, tracked,
            # or dropped, leaking its store bytes plus cluster replicas.
            if inline is None:
                store = self._raylet_store()
                if store is not None:
                    try:
                        store.delete(oid)  # scrub the dead worker's bytes
                    except Exception:  # noqa: BLE001
                        pass
            return
        if inline is not None:
            self._object_inline(oid, inline)
        else:
            st = self._obj(oid)
            st.size = max(st.size, msg.get("size", 0))
            self._object_in_store(oid)
            # checkpoints are the canonical "hot state worth a copy":
            # replicate regardless of the size threshold
            self._maybe_replicate(oid, force=True)
        if actor.foreign_owner is not None:
            # Exec side of a forwarded actor: the owner runs the restart
            # machine — ship the checkpoint ref (and the blob for inline
            # ones) to it; store checkpoints advertise this holder.  The
            # exec side ALSO records the snapshot locally (publish=False):
            # without the pin/track/supersede cycle every superseded
            # checkpoint object sealed here (plus its forced replicas)
            # would leak — only tracked entries ever free, and only the
            # primary's teardown drops replicas.
            self._set_actor_checkpoint(actor, oid, msg["seq"],
                                       publish=False)
            peer = self._get_peer(actor.foreign_owner)
            if peer is not None:
                try:
                    peer.send({"t": "xcheckpoint",
                               "actor_id": actor.actor_id,
                               "seq": msg["seq"], "id": msg["id"],
                               "inline": inline,
                               "size": msg.get("size", 0),
                               "node": self.node_id})
                except OSError:
                    self._drop_peer(peer)
            return
        self._set_actor_checkpoint(actor, oid, msg["seq"])

    def _handle_xcheckpoint(self, msg: dict):
        """Owner side: a forwarded actor checkpointed on its exec node.
        Staleness check FIRST (a relay from a node the actor already
        moved off): sealing or registering a checkpoint nobody records
        would leak an untracked, unpinned entry — the same hazard the
        exec-side stale path rejects before sealing."""
        actor = self._actors.get(msg["actor_id"])
        if actor is None or actor.node_id != msg.get("node"):
            return
        oid = ObjectID.from_hex(msg["id"])
        if msg.get("inline") is not None:
            self._object_inline(oid, msg["inline"])
        else:
            st = self._obj(oid)
            if msg.get("node") and msg["node"] not in st.locations:
                st.locations.append(msg["node"])
            st.size = max(st.size, msg.get("size", 0))
            if st.status == "pending":
                st.status = "remote"
            # keep a local copy too: the restart usually lands here, and
            # the exec node (the likeliest casualty) must not hold the
            # only bytes
            self._maybe_pull(oid)
        self._set_actor_checkpoint(actor, oid, msg["seq"])

    def _set_actor_checkpoint(self, actor: "_ActorState", oid: ObjectID,
                              seq: int, publish: bool = True):
        """Record the freshest checkpoint (callers already rejected stale
        sources by conn/node identity; ``seq`` is the worker's own count,
        kept for observability — the owner's counter is what orders
        snapshots across restarts).  ``publish=False`` on the exec side
        of a forwarded actor: pin/supersede locally, but the OWNER owns
        the GCS actor-table entry and the restart machine."""
        prev = actor.checkpoint_oid
        actor.checkpoint_oid = oid
        actor.checkpoint_seq += 1
        st = self._obj(oid)
        st.pins += 1        # the raylet holds the latest checkpoint
        st.tracked = True   # ...and superseded ones become freeable
        if publish:
            # owner-side only: the cluster-wide sum stays one per
            # snapshot even when exec + owner both record it
            self._m_ckpt_saves += 1
            self._m_ckpt_bytes += st.size or len(st.value or b"")
        if publish and self.cluster_mode:
            self._gcs_post("update_actor", actor.actor_id.binary(),
                           "alive", checkpoint=oid.hex(),
                           checkpoint_seq=actor.checkpoint_seq)
        if prev is not None and prev != oid:
            pst = self._objects.get(prev)
            if pst is not None:
                pst.pins -= 1
                self._maybe_free(prev)

    def _release_actor_checkpoint(self, actor: "_ActorState"):
        """Final actor death: the raylet's pin on the last checkpoint is
        released so it can free like any other unreferenced object."""
        oid = actor.checkpoint_oid
        if oid is None:
            return
        actor.checkpoint_oid = None
        st = self._objects.get(oid)
        if st is not None:
            st.pins -= 1
            self._maybe_free(oid)

    # --------------------------------------------------------------- streams

    def _init_stream(self, spec: TaskSpec):
        tid = spec.task_id
        if tid in self._streams:
            return
        self._streams[tid] = {"produced": 0, "total": None, "error": None,
                              "waiters": {}}
        # the completion marker resolves (count or error) through the same
        # object machinery every other return uses
        self.async_get(spec.return_ids(),
                       lambda results, t=tid: self._on_stream_done(t, results))

    def _on_stream_item(self, msg: dict):
        """A generator task yielded item #index (worker message)."""
        oid = ObjectID.from_hex(msg["id"])
        if msg.get("inline") is not None:
            self._object_inline(oid, msg["inline"],
                                contains=msg.get("contains"))
        else:
            self._obj(oid).size = msg.get("size", 0)
            self._object_in_store(oid, contains=msg.get("contains"))
        tid = oid.task_id()
        origin = self._foreign_streams.get(tid)
        if origin is not None:
            # executing for another raylet: relay the item so the
            # consumer-side stream advances (store items transfer lazily
            # via the normal pull path)
            peer = self._get_peer(origin)
            if peer is not None:
                relay = dict(msg)
                relay["t"] = "xstream_item"
                if msg.get("inline") is None:
                    relay["location"] = self.node_id
                try:
                    peer.send(relay)
                except OSError:
                    self._drop_peer(peer)
        self._advance_stream(tid, msg["index"])

    def _handle_xstream_item(self, msg: dict):
        """Relayed stream item from the executing node."""
        oid = ObjectID.from_hex(msg["id"])
        if msg.get("inline") is not None:
            self._object_inline(oid, msg["inline"])
        else:
            st = self._obj(oid)
            if st.status == "pending":
                st.status = "remote"
                st.size = msg.get("size", 0)
                st.locations = [msg["location"]]
                self._object_ready(oid)
        tid = oid.task_id()
        onward = self._foreign_streams.get(tid)
        if onward is not None:
            # 3-hop case (consumer -> actor owner -> exec node): keep
            # relaying toward the consumer
            peer = self._get_peer(onward)
            if peer is not None:
                try:
                    peer.send({**msg, "t": "xstream_item"})
                except OSError:
                    self._drop_peer(peer)
        self._advance_stream(tid, msg["index"])

    def _advance_stream(self, tid: TaskID, index: int):
        st = self._streams.get(tid)
        if st is None:
            return
        st["produced"] = max(st["produced"], index + 1)
        for idx in [i for i in st["waiters"] if i < st["produced"]]:
            for cb in st["waiters"].pop(idx):
                self._safe(lambda cb=cb: cb({"kind": "item"}))

    def _on_stream_done(self, tid: TaskID, results: Dict[str, tuple]):
        self._foreign_streams.pop(tid, None)
        st = self._streams.get(tid)
        if st is None:
            return
        marker = next(iter(results.values()))
        if marker[0] == "error":
            st["error"] = marker[1]
        else:
            st["total"] = st["produced"]
        for idx in list(st["waiters"]):
            for cb in st["waiters"].pop(idx):
                if idx < st["produced"]:
                    # already-produced items stay consumable even when the
                    # generator errored later
                    self._safe(lambda cb=cb: cb({"kind": "item"}))
                elif st["error"] is not None:
                    self._safe(lambda cb=cb: cb(
                        {"kind": "error", "error": st["error"]}))
                else:
                    self._safe(lambda cb=cb: cb({"kind": "end"}))
        # GC: consumers may lag; the state (a tiny dict) lingers for a
        # grace period, then goes away (reference ties this to generator
        # ref counting).
        self.add_timer(300.0, lambda: self._streams.pop(tid, None))

    def async_stream_next(self, tid: TaskID, index: int, cb: Callable):
        """cb receives {"kind": "item" | "end" | "error", ...}.  Returns a
        cancel callable or None when answered synchronously."""
        st = self._streams.get(tid)
        if st is None:
            cb({"kind": "error",
                "error": ValueError(f"unknown stream {tid.hex()}")})
            return None
        if index < st["produced"]:
            cb({"kind": "item"})
            return None
        if st["error"] is not None:
            cb({"kind": "error", "error": st["error"]})
            return None
        if st["total"] is not None:
            cb({"kind": "end"})
            return None
        st["waiters"].setdefault(index, []).append(cb)

        def cancel():
            lst = st["waiters"].get(index)
            if lst and cb in lst:
                lst.remove(cb)
                if not lst:
                    del st["waiters"][index]

        return cancel

    # --------------------------------------------------------------- objects

    def _obj(self, oid: ObjectID) -> _ObjectState:
        st = self._objects.get(oid)
        if st is None:
            st = _ObjectState()
            self._objects[oid] = st
        return st

    def _set_contains(self, st: "_ObjectState", contains):
        """Record + pin the refs serialized inside this object's bytes;
        released when the entry itself is freed."""
        if not contains:
            return
        if st.contains:
            # re-seal (retry/reconstruction): drop the old pins first
            for inner in st.contains:
                inner_st = self._objects.get(inner)
                if inner_st is not None:
                    inner_st.pins -= 1
                    self._maybe_free(inner)
        st.contains = list(contains)
        for inner in st.contains:
            self._obj(inner).pins += 1

    def _object_inline(self, oid: ObjectID, blob: bytes, contains=None):
        st = self._obj(oid)
        st.status = "inline"
        st.value = blob
        st.size = len(blob)
        self._set_contains(st, contains)
        if self.cluster_mode:
            self._gcs_post("add_object_location", oid.hex(),
                           self.node_id, len(blob), inline=True,
                           incarnation=self.incarnation)
        self._object_ready(oid)

    def _object_in_store(self, oid: ObjectID, contains=None):
        st = self._obj(oid)
        st.status = "store"
        self._set_contains(st, contains)
        replica = oid in self._replicating
        if replica:
            # This seal completed an eager-replication pull: mark the copy
            # managed (this node re-replicates on holder death) and tell
            # the directory it is a secondary.
            self._replicating.discard(oid)
            st.replicated = True
        if self.cluster_mode:
            self._gcs_post("add_object_location", oid.hex(),
                           self.node_id, st.size, replica=replica,
                           incarnation=self.incarnation)
        self._object_ready(oid)

    def _object_error(self, oid: ObjectID, err: Exception):
        st = self._obj(oid)
        st.status = "error"
        st.error = err
        self._object_ready(oid)

    def _object_ready(self, oid: ObjectID):
        st = self._objects.get(oid)
        status = st.status if st is not None else "pending"
        dep_error = st.error if (st is not None and st.status == "error") else None
        # unblock dependent tasks
        waiting = self._dep_index.pop(oid, None)
        if waiting:
            for task_id in list(waiting):
                entry = self._waiting.get(task_id)
                if entry is None:
                    continue
                spec, missing = entry
                if dep_error is not None:
                    # An errored dependency fails the dependent immediately
                    # (reference: RayTaskError propagates through deps) —
                    # never dispatch a task whose arg can only time out.
                    del self._waiting[task_id]
                    for m in missing:
                        peers = self._dep_index.get(m)
                        if peers:
                            peers.discard(task_id)
                    for rid in spec.return_ids():
                        self._object_error(rid, dep_error)
                    self._record_event(spec, "FAILED", dep_error=True)
                    continue
                missing.discard(oid)
                if not missing:
                    del self._waiting[task_id]
                    self._enqueue_ready(spec)
        # fire get/wait callbacks — only when LOCALLY resolved; a "remote"
        # transition keeps waiters registered (they resolve when the pull
        # seals the object here) but must kick the pull off.
        if status in ("inline", "store", "error"):
            st.lookup_attempts = 0  # backoff resets once materialized
            for cb in self._object_waiters.pop(oid, []):
                self._safe(lambda cb=cb: cb(oid))
        elif status == "remote" and oid in self._object_waiters:
            self._maybe_pull(oid)
        self._maybe_free(oid)  # nobody may have held it by now
        self._schedule()

    def _object_status(self, oid: ObjectID) -> str:
        st = self._objects.get(oid)
        return st.status if st else "pending"

    # --------------------------------------------------------------- submission

    def submit_task(self, spec: TaskSpec, foreign_origin: Optional[str] = None):
        """Entry point for driver and nested worker submissions.

        ``foreign_origin``: this spec was forwarded here by another raylet
        (which stays the owner of actors and handles restarts); skip the
        owner-side registrations.
        """
        if spec.trace_ctx is not None:
            # inbox-receipt timestamp: the first lifecycle transition
            # closes the raylet.inbox hop span.  A forwarded spec re-opens
            # it here (fresh node, fresh inbox interval).
            spec._tr_in = time.time()
            spec._tr_prev = None
        if getattr(spec, "_direct_retry", False) and all(
                self._object_status(o) in ("inline", "store", "error")
                for o in spec.return_ids()):
            # Reconcile of an in-flight direct call whose result DID land
            # (the direct_done raced the channel teardown): already
            # resolved — never execute twice.
            return
        self._note_child(spec)
        flag = self._cancelled_flag(spec)
        if flag is not None and spec.kind != ACTOR_CREATION_TASK:
            # This task (or the parent that spawned it) was already reaped
            # by a cancel/deadline fan-out — its submit frame raced the
            # fan-out here.  Drop it at the door, and remember IT so its
            # own late-arriving children are caught too.
            self._note_cancelled(spec.task_id, flag)
            if flag:
                self._m_deadline_exceeded += 1
                self._shed_spec(spec, DeadlineExceededError(
                    f"task {spec.name} parent deadline already expired",
                    hop="raylet.admission"), "EXPIRED", hop="admission")
            else:
                self._m_cancelled += 1
                self._shed_spec(spec, TaskCancelledError(
                    f"task {spec.name} was cancelled before it ran"),
                    "CANCELLED")
            return
        if config.deadlines and spec.deadline is not None \
                and spec.kind != ACTOR_CREATION_TASK:
            # Admission control: an already-expired request is dropped at
            # the door — no dep pinning, no lineage, no queue slot, no
            # wasted exec (reference: Serve request timeouts shed before
            # the replica sees the request).
            remaining = spec.deadline - time.time()
            if remaining <= 0:
                self._m_deadline_exceeded += 1
                err = DeadlineExceededError(
                    f"task {spec.name} deadline expired before admission",
                    hop="raylet.admission")
                for oid in spec.return_ids():
                    self._object_error(oid, err)
                self._record_event(spec, "EXPIRED", hop="admission",
                                   error=self._err_summary(err))
                return
            # Expiry timer: fires while the task is still queued anywhere
            # on this node (waiting on args, ready queue, actor queue) —
            # running tasks are interrupted by the worker-side watchdog,
            # and a completed task makes this a no-op.  Captures ids
            # only: a closure over the spec would pin its arg payloads
            # in the timer heap for the whole deadline window even after
            # the task completes.
            self.add_timer(
                remaining + 0.01,
                lambda t=spec.task_id, o=spec.return_ids(), n=spec.name:
                self._on_deadline(t, o, n))
        # Lineage for eviction recovery: NORMAL tasks only (actor results
        # aren't replayable) and bounded — beyond the cap new objects lose
        # reconstructability instead of the raylet growing without limit
        # (reference bounds lineage bytes, ray_config_def.h lineage caps).
        keep_lineage = (spec.kind == NORMAL_TASK
                        and self._lineage_count < config.max_lineage_entries)
        for oid in spec.return_ids():
            st = self._obj(oid)
            if keep_lineage and st.creating_spec is None:
                st.creating_spec = spec
                self._lineage_count += 1
        self._pin_deps(spec)
        if spec.num_returns == STREAMING_RETURNS:
            self._init_stream(spec)
        if spec.kind == ACTOR_CREATION_TASK:
            actor = _ActorState(spec, name=(spec.placement or {}).get("name"))
            self._actors[spec.actor_id] = actor
            # direct-transport fencing: the creation spec carries the
            # generation the hosted worker will validate hellos against
            actor.generation = getattr(spec, "_direct_generation", 0)
            spec._direct_generation = actor.generation
            if foreign_origin is not None:
                # exec-side state: the owner restarts, we only report deaths
                actor.restarts_left = 0
                actor.foreign_owner = foreign_origin
            else:
                namespace = (spec.placement or {}).get("namespace", "")
                if actor.name or self.cluster_mode:
                    from ray_tpu_torch._vendor import cloudpickle as _cp

                    ok = self._gcs_safe(
                        self.gcs.register_actor, spec.actor_id.binary(),
                        self.node_id, name=actor.name, namespace=namespace,
                        spec_blob=_cp.dumps(spec) if actor.name else None,
                        incarnation=self.incarnation)
                    if ok is False:
                        del self._actors[spec.actor_id]
                        err = ValueError(
                            f"actor name {actor.name!r} already taken")
                        for oid in spec.return_ids():
                            self._object_error(oid, err)
                        return
        missing = {
            oid for oid in spec.dependency_ids()
            if self._object_status(oid) not in ("inline", "store", "remote")
        }
        # error deps propagate immediately
        for oid in list(missing):
            if self._object_status(oid) == "error":
                err = self._objects[oid].error
                for rid in spec.return_ids():
                    self._object_error(rid, err)
                self._record_event(spec, "FAILED", dep_error=True,
                                   error=self._err_summary(err))
                return
        if missing:
            # QUEUED is recorded by _enqueue_ready once the args resolve
            self._record_event(spec, "PENDING_ARGS")
            self._waiting[spec.task_id] = (spec, missing)
            for oid in missing:
                self._dep_index.setdefault(oid, set()).add(spec.task_id)
            if self.cluster_mode:
                # A dep produced on another node resolves via the GCS
                # directory watch the pull registers.
                for oid in missing:
                    self._maybe_pull(oid, priority=0,  # task args
                                     trace_ctx=spec.trace_ctx)
        else:
            self._enqueue_ready(spec)
        self._schedule()

    def _enqueue_ready(self, spec: TaskSpec):
        spec._queued_t = time.monotonic()  # dispatch-latency metric start
        self._record_event(spec, "QUEUED")
        if spec.kind == ACTOR_TASK:
            actor = self._actors.get(spec.actor_id)
            if actor is None:
                if self.cluster_mode and self._route_foreign_actor_task(spec):
                    return
                err = ActorDiedError(
                    spec.actor_id.hex() if spec.actor_id else "?",
                    "unknown actor",
                )
                for oid in spec.return_ids():
                    self._object_error(oid, err)
                self._record_event(spec, "FAILED",
                                   error=self._err_summary(err))
                return
            if actor.state == "dead":
                err = ActorDiedError(
                    spec.actor_id.hex() if spec.actor_id else "?",
                    actor.death_reason,
                )
                for oid in spec.return_ids():
                    self._object_error(oid, err)
                self._record_event(spec, "FAILED",
                                   error=self._err_summary(err))
                return
            if (getattr(spec, "_direct_retry", False)
                    and spec._direct_generation != actor.generation):
                # Reconcile of an in-flight direct call from BEFORE the
                # actor's last restart: the old incarnation may have run
                # it (and died before the result escaped) — executing it
                # on the restarted instance could double side effects, so
                # it fails like any other interrupted in-flight call.
                err = ActorDiedError(
                    spec.actor_id.hex() if spec.actor_id else "?",
                    "actor restarted while a direct call was in flight "
                    "(restarting)")
                for oid in spec.return_ids():
                    self._object_error(oid, err)
                self._record_event(spec, "FAILED", direct=True,
                                   error=self._err_summary(err))
                return
            depth = config.max_queue_depth
            if (depth > 0 and len(actor.queue) >= depth
                    and self._shed_lowest_headroom(
                        actor.queue, spec, "actor queue")):
                return
            actor.queue.append(spec)
            self._pump_actor(actor)
        else:
            depth = config.max_queue_depth
            if (depth > 0 and spec.kind == NORMAL_TASK
                    and len(self._ready_queue) >= depth
                    and self._shed_lowest_headroom(
                        self._ready_queue, spec, "ready queue")):
                return
            self._ready_queue.append(spec)

    def _route_foreign_actor_task(self, spec: TaskSpec) -> bool:
        """An actor task for an actor owned by another raylet (its handle
        travelled here inside args / via get_actor): forward to the owner."""
        owner = self._actor_owner_cache.get(spec.actor_id)
        if owner is None:
            info = self._gcs_safe(self.gcs.get_actor, spec.actor_id.binary())
            if not info:
                return False
            owner = info["owner_node"]
            self._actor_owner_cache[spec.actor_id] = owner
        if owner == self.node_id:
            return False
        if getattr(spec, "_spill_count", 0) >= config.spillback_max_hops:
            return False  # routing loop guard (stale owner metadata)
        return self._forward_task(spec, owner)

    # --------------------------------------------------------------- scheduling

    def _task_resource_pools(self, spec: TaskSpec):
        """Return (avail_dict, need) — node pool or placement-group bundle."""
        placement = spec.placement or {}
        pg_hex = placement.get("pg")
        if pg_hex:
            pg = self._pgs.get(pg_hex)
            if pg is None or pg.state != "created":
                return None, None
            idx = placement.get("bundle", 0)
            if idx == -1:
                for b in pg.available.values():
                    if _fits(b, spec.resources):
                        return b, spec.resources
                return None, spec.resources
            pool = pg.available.get(idx)
            if pool is None:
                return None, None  # bundle lives on another node's fragment
            return pool, spec.resources
        return self.resources_available, spec.resources

    def _release_task_resources(self, spec: TaskSpec):
        batch = getattr(spec, "_batch", None)
        if batch is not None:
            # sequential dispatch batch: the batch holds ONE task's
            # resources, released when its last member finishes (done,
            # death, or requeue — each path comes through here exactly
            # once per member).
            spec._batch = None
            batch["open"] -= 1
            if batch["open"] == 0:
                _release(batch["pool"], batch["need"])
            return
        pool = getattr(spec, "_acquired_pool", None)
        if pool is not None:
            _release(pool, spec.resources)
            spec._acquired_pool = None

    def _dep_errored(self, spec: TaskSpec) -> bool:
        """If any dependency of a ready task has since errored, fail the task
        now instead of dispatching it to block on an arg that never comes."""
        for oid in spec.dependency_ids():
            st = self._objects.get(oid)
            if st is not None and st.status == "error":
                if spec.restore_oid is not None and oid == spec.restore_oid:
                    # an unrecoverable CHECKPOINT must not kill the actor:
                    # fall back to a cold start (the cost checkpointing
                    # exists to avoid, but strictly better than dead)
                    spec.restore_oid = None
                    continue
                for rid in spec.return_ids():
                    self._object_error(rid, st.error)
                self._record_event(spec, "FAILED", dep_error=True)
                return True
        return False

    def _activate_pending_pgs(self):
        """Reserve bundles for queued placement groups as resources free up
        (reference queues infeasible PGs instead of oversubscribing)."""
        for pg in self._pgs.values():
            if pg.state != "pending":
                continue
            if pg.fragment:
                for i in sorted(pg.unreserved):
                    if _fits(self.resources_available, pg.bundles[i]):
                        _acquire(self.resources_available, pg.bundles[i])
                        pg.unreserved.discard(i)
                if pg.unreserved:
                    continue
            else:
                total = pg.total()
                if not _fits(self.resources_available, total):
                    continue
                _acquire(self.resources_available, total)
                pg.unreserved.clear()
            pg.state = "created"
            if pg.fragment:
                self._gcs_post("pg_fragment_ready", pg.pg_id,
                               self.node_id)
            if pg.ready_oid is not None:
                self._object_inline(pg.ready_oid, _PG_READY_BLOB)

    def _schedule(self):
        """Request a scheduling pass (coalesced; see _run)."""
        self._need_schedule = True

    def _schedule_now(self):
        self._activate_pending_pgs()
        if not self._ready_queue:
            return
        # Fast bail: with zero idle workers and every near-head profile's
        # pool already at the per-profile spawn cap, a pass can neither
        # dispatch nor usefully spawn — and done-storms request one pass
        # per completion batch, so the deferred-queue rotation below would
        # run O(completions) times.  Actor tasks in the ready queue (retry
        # rejoin path) always force a full pass — they route through the
        # actor machinery, not the worker pool.
        if (not self.cluster_mode
                and not any(self._idle.values())):
            cap = max(1, int(self.resources_total.get("CPU", 1) or 1))
            poolable: Dict[str, int] = {}
            for c in self._workers.values():
                if c.actor_id is None and c.state in ("idle", "busy"):
                    poolable[c.profile] = poolable.get(c.profile, 0) + 1
            for prof, n in self._spawning.items():
                poolable[prof] = poolable.get(prof, 0) + n
            # Window = the full pass's no-progress bound: entries beyond it
            # were unreachable in a defer-storm pass anyway, so the bail
            # never hides work a full pass would have found.
            can_bail = True
            for s in itertools.islice(self._ready_queue, 128):
                if (s.kind == ACTOR_TASK
                        or poolable.get(self._profile_key(s), 0) < cap):
                    can_bail = False
                    break
            if can_bail:
                # every completion calls _schedule(), so the next pass is
                # already guaranteed once a worker frees
                return
        deferred = deque()
        spawn_demand: Dict[str, int] = {}
        pg_orphans = []  # tasks whose PG no longer exists — fail after drain
        # Bounded scan: once NO_PROGRESS_WINDOW consecutive specs deferred
        # without a single dispatch, stop — freed capacity this pass is
        # exhausted and rescanning a 10k-deep queue per completion batch is
        # O(n^2).  (The reference keeps per-resource-shape queues instead;
        # heterogeneous head-of-line blocking within the window is the
        # accepted trade.)
        no_progress = 0
        NO_PROGRESS_WINDOW = 128
        spill_queries = 0  # GCS placement lookups per pass (round trips)
        # Shapes that already failed THIS pass (no free resources or no
        # idle worker): later queued tasks with the same shape defer
        # without re-running the full placement body — the deep-queue scan
        # was the submission-throughput hot spot (profiled: 72k _fits
        # calls for 2k tasks).
        failed_shapes: set = set()
        while self._ready_queue:
            if no_progress >= NO_PROGRESS_WINDOW:
                break
            spec = self._ready_queue.popleft()
            if self._dep_errored(spec):
                continue
            if self._deadline_expired(spec):
                # pre-dispatch check: a task that expired while queued is
                # dropped before it costs a worker (typed result, no exec)
                self._m_deadline_exceeded += 1
                self._shed_spec(spec, DeadlineExceededError(
                    f"task {spec.name} deadline expired in the ready queue",
                    hop="raylet.pre_dispatch"), "EXPIRED", hop="pre_dispatch")
                self._cancel_children(spec.task_id, deadline=True)
                continue
            if (not spec.placement and spec.kind == NORMAL_TASK
                    and not self.cluster_mode):
                shape_key = tuple(sorted((spec.resources or {}).items()))
                if shape_key in failed_shapes:
                    deferred.append(spec)
                    no_progress += 1
                    continue
            else:
                shape_key = None
            if spec.kind == ACTOR_TASK:
                # An actor task can land in the ready queue via retry paths;
                # route it through the actor machinery.
                self._enqueue_ready(spec)
                continue
            placement = spec.placement or {}
            if self.cluster_mode:
                # Node affinity (reference: NodeAffinitySchedulingStrategy).
                aff = placement.get("node_id")
                if aff and aff != self.node_id:
                    if not self._forward_task(spec, aff):
                        deferred.append(spec)
                        no_progress += 1
                    continue
                # Draining: nothing new dispatches locally — forward
                # everything placeable to a surviving node (the GCS
                # placement already skips this node), so the drain
                # quiesces instead of re-filling.  Unforwardable work
                # defers and rides the drain deadline.
                if (self._draining and not placement.get("pg")
                        and spill_queries < 32):
                    spill_queries += 1
                    target = self._gcs_safe(
                        self.gcs.place_task, spec.resources or {},
                        exclude=[self.node_id])
                    if target and self._forward_task(spec, target):
                        continue
                    deferred.append(spec)
                    no_progress += 1
                    continue
                # Locality-aware placement (reference: locality_aware lease
                # policy): a task whose arguments hold more bytes on a peer
                # than here moves to the data instead of pulling the data.
                if (not placement and spec.kind == NORMAL_TASK
                        and getattr(spec, "_spill_count", 0)
                        < config.spillback_max_hops):
                    loc_target = self._locality_preferred_node(spec)
                    if loc_target is not None \
                            and self._forward_task(spec, loc_target):
                        self._m_locality_spills += 1
                        continue
            pool, need = self._task_resource_pools(spec)
            if pool is None:
                # Distinguish "not schedulable yet" (pending PG, full
                # bundles → defer) from "never schedulable" (PG removed or
                # unknown → fail now, else the task defers forever) from
                # "bundle on ANOTHER node's fragment" (cluster → forward).
                # _object_error re-enters _schedule, so only collect here.
                pg_hex = (spec.placement or {}).get("pg")
                idx = (spec.placement or {}).get("bundle", 0)
                local = self._pgs.get(pg_hex) if pg_hex else None
                if (local is not None and not local.fragment and idx != -1
                        and idx not in local.bundles):
                    # out-of-range bundle index on a whole local PG: fail
                    # loudly instead of deferring forever
                    err = ValueError(
                        f"bundle index {idx} out of range for placement "
                        f"group {pg_hex} ({len(local.bundles)} bundles)")
                    for rid in spec.return_ids():
                        self._object_error(rid, err)
                    self._record_event(spec, "FAILED", bad_bundle=True)
                    continue
                if pg_hex and self.cluster_mode and spill_queries < 8:
                    bundle_elsewhere = (
                        local is None
                        or (local.fragment
                            and (idx != -1 and idx not in local.available
                                 or idx == -1 and not any(
                                     _fits(b, spec.resources)
                                     for b in local.bundles.values()))))
                    if bundle_elsewhere:
                        spill_queries += 1
                        info = self._gcs_err_ok(self.gcs.pg_info, pg_hex)
                        if info is _GCS_ERR:
                            deferred.append(spec)  # transient GCS trouble
                            no_progress += 1
                            continue
                        if info is not None:
                            if info["state"] != "created":
                                deferred.append(spec)
                                no_progress += 1
                                continue
                            if idx != -1:
                                target = info["assignments"].get(idx)
                                if (target is None
                                        and idx >= len(info["bundles"])):
                                    err = ValueError(
                                        f"bundle index {idx} out of range "
                                        f"for placement group {pg_hex}")
                                    for rid in spec.return_ids():
                                        self._object_error(rid, err)
                                    self._record_event(spec, "FAILED",
                                                       bad_bundle=True)
                                    continue
                            else:
                                # any-bundle: pick a node whose ASSIGNED
                                # bundle can fit this task
                                target = next(
                                    (n for i2, n in sorted(
                                        info["assignments"].items())
                                     if _fits(dict(info["bundles"][i2]),
                                              spec.resources)), None)
                            if (target and target != self.node_id
                                    and self._forward_task(spec, target)):
                                continue
                            deferred.append(spec)
                            no_progress += 1
                            continue
                        # authoritative: the GCS has no such PG
                        if local is None:
                            pg_orphans.append(spec)
                            continue
                if pg_hex and pg_hex not in self._pgs \
                        and not self.cluster_mode:
                    # cluster mode orphans only via the GCS lookup above
                    pg_orphans.append(spec)
                    continue
                deferred.append(spec)
                no_progress += 1
                continue
            if not _fits(pool, need):
                # Spillback (reference: ClusterTaskManager picks another
                # node and the lease reply redirects the client,
                # cluster_task_manager.cc:418): when the task cannot run
                # here now but another node has capacity, forward it.
                if (self.cluster_mode
                        and not placement.get("pg")
                        and spill_queries < 8
                        and getattr(spec, "_spill_count", 0)
                        < config.spillback_max_hops):
                    spill_queries += 1
                    fits_total = _fits(self.resources_total, need)
                    target = self._gcs_safe(
                        self.gcs.place_task, need,
                        exclude=[self.node_id],
                        # locality hint: the GCS scores candidates by arg
                        # bytes already on them (object directory sizes)
                        arg_ids=[o.hex() for o in itertools.islice(
                            spec.dependency_ids(), 16)] or None)
                    if target is None and not fits_total:
                        # nowhere has capacity free now; if some node could
                        # EVER fit it, forward there to queue
                        feas = self._gcs_safe(self.gcs.feasible_nodes, need)
                        feas = [n for n in (feas or []) if n != self.node_id]
                        target = feas[0] if feas else None
                    if target and self._forward_task(spec, target):
                        continue
                if shape_key is not None:
                    failed_shapes.add(shape_key)
                deferred.append(spec)
                no_progress += 1
                continue
            if self._remote_deps_pending(spec):
                deferred.append(spec)  # pulls in flight; retried on seal
                no_progress += 1
                continue
            profile = self._profile_key(spec)
            conn = self._get_idle_worker(profile)
            if conn is None:
                spawn_demand[profile] = spawn_demand.get(profile, 0) + 1
                if shape_key is not None:
                    # same-shape tasks would also find no idle worker; the
                    # skip is per-pass only (any env-profile mismatch just
                    # re-evaluates next pass)
                    failed_shapes.add(shape_key)
                deferred.append(spec)
                no_progress += 1
                continue
            batch = [spec]
            # Fair share: never batch deeper than the queue spread over the
            # workers that could also take this shape — a fan-out of 8
            # tasks with 8 idle workers must not serialize onto one.
            # SPAWNABLE workers count too: batching the whole queue onto
            # the only live worker would consume the very backlog whose
            # no-idle-worker signal drives pool growth, freezing the pool
            # at its current size.
            idle_same = len(self._idle.get(profile, ()))
            pool_same = self._spawning.get(profile, 0) + sum(
                1 for c in self._workers.values()
                if c.actor_id is None and c.state in ("idle", "busy")
                and c.profile == profile)
            cpu_cap = max(1, int(self.resources_total.get("CPU", 1) or 1))
            spawnable = max(0, cpu_cap - pool_same)
            fair = -(-(len(self._ready_queue) + 1)
                     // (idle_same + spawnable + 1))
            batch_cap = min(config.dispatch_batch_max, fair)
            if (shape_key is not None and batch_cap > 1
                    and self._ready_queue):
                # Same-shape followers from the queue head ride the same
                # coalesced frame (ONE sendall — the syscall, not the
                # pickle, is the per-dispatch cost on a busy host) and
                # execute sequentially on this worker, so the whole batch
                # holds one task's resources.  Consecutive-head-only keeps
                # FIFO order; the first non-matching spec stops the batch.
                while (len(batch) < batch_cap
                       and self._ready_queue):
                    nxt = self._ready_queue[0]
                    if (nxt.kind != NORMAL_TASK or nxt.placement
                            or self._profile_key(nxt) != profile
                            or tuple(sorted((nxt.resources or {}).items()))
                            != shape_key):
                        break
                    self._ready_queue.popleft()
                    if self._dep_errored(nxt):
                        continue
                    if self._remote_deps_pending(nxt):
                        deferred.append(nxt)
                        continue
                    batch.append(nxt)
            _acquire(pool, need)
            if len(batch) == 1:
                spec._acquired_pool = pool
            else:
                rec = {"open": len(batch), "pool": pool, "need": need}
                for s in batch:
                    s._batch = rec
                    s._acquired_pool = None
            self._dispatch_many(batch, conn)
            no_progress = 0
        deferred.extend(self._ready_queue)  # early-break keeps the tail
        self._ready_queue = deferred
        for spec in pg_orphans:
            if spec.kind == ACTOR_CREATION_TASK and \
                    spec.actor_id in self._actors:
                # The actor was registered at submit time; erroring only
                # the creation refs would leave it 'pending' with method
                # calls queueing forever — mark it dead (same treatment
                # as remove_pg gives never-dispatched PG actors).
                actor = self._actors[spec.actor_id]
                actor.restarts_left = 0
                self._on_actor_death(
                    spec.actor_id,
                    f"placement group {(spec.placement or {}).get('pg')} "
                    "was removed", allow_restart=False)
                continue
            err = ValueError(
                f"placement group {(spec.placement or {}).get('pg')} "
                "was removed")
            for rid in spec.return_ids():
                self._object_error(rid, err)
            self._record_event(spec, "FAILED", pg_removed=True)
        # Spawn up to queue-depth workers per profile in one pass (reference
        # pops/starts a worker per pending lease, `worker_pool.h:156`) —
        # capped by node CPUs so a deep queue can't fork-bomb the host.
        # Note: actors hold their workers for life, so total workers may
        # legitimately exceed CPU count — the cap bounds the spawn *burst*,
        # not the pool size (resource accounting already gates dispatch).
        cap = max(1, int(self.resources_total.get("CPU", 1) or 1))
        poolable: Dict[str, int] = {}
        for c in self._workers.values():
            # real pool members only: driver conns (state "driver") and
            # not-yet-identified accepts share the dict but aren't workers
            if c.actor_id is None and c.state in ("idle", "busy"):
                poolable[c.profile] = poolable.get(c.profile, 0) + 1
        for profile, depth in spawn_demand.items():
            pending = self._spawning.get(profile, 0)  # includes unregistered
            # Cap the PROFILE'S POOL (existing poolable workers + in-flight
            # spawns), not just the per-pass burst: a deep queue must not
            # keep forking beyond CPU count while earlier workers are busy
            # (each spawn costs a Python+jax import).  Actors hold workers
            # for life and are excluded — resource accounting gates them.
            want = min(depth, cap - poolable.get(profile, 0)) - pending
            for _ in range(max(0, want)):
                self._spawn_worker(profile)

    def _locality_preferred_node(self, spec: TaskSpec) -> Optional[str]:
        """Node holding strictly more bytes of this task's arguments than
        are local here (and at least locality_aware_min_bytes) — the
        scheduler moves large-arg tasks to the data.  Sizes come from the
        object directory via xdone/object_at/pull metadata; unknown sizes
        count as zero (never force a GCS round trip per schedule pass)."""
        min_bytes = config.locality_aware_min_bytes
        if min_bytes <= 0:
            return None
        local = 0
        by_node: Dict[str, int] = {}
        for oid in spec.dependency_ids():
            st = self._objects.get(oid)
            if st is None:
                continue
            if st.status in ("inline", "store"):
                local += st.size or 0
            elif st.status == "remote" and not st.remote_inline:
                for n in st.locations:
                    by_node[n] = by_node.get(n, 0) + (st.size or 0)
        if not by_node:
            return None
        best, best_bytes = max(by_node.items(), key=lambda kv: kv[1])
        if best_bytes < min_bytes or best_bytes <= local:
            return None
        info = self._cluster_nodes.get(best)
        if info is None or info.get("suspect") or info.get("draining"):
            return None
        total = info.get("resources_total")
        # node_added pushes carry only id+address; with capacity unknown,
        # forward optimistically — an infeasible target spills the task
        # back (hop-capped) rather than suppressing locality entirely
        if total is not None and not _fits(total, spec.resources or {}):
            return None
        return best

    def _dispatch_msg(self, spec: TaskSpec, conn: _WorkerConn,
                      running: bool = True) -> dict:
        conn.state = "busy"
        conn.current_task = spec
        conn.task_start_time = time.monotonic()
        conn.inflight[spec.task_id] = spec
        if spec.kind == ACTOR_CREATION_TASK:
            conn.actor_id = spec.actor_id
            actor = self._actors[spec.actor_id]
            actor.conn = conn
        arg_values: Dict[str, bytes] = {}
        for oid in spec.dependency_ids():
            st = self._objects.get(oid)
            if st is not None and st.status == "inline":
                arg_values[oid.hex()] = st.value
        fn_blob = None
        if spec.function_id is not None:
            key = spec.function_id.binary()
            if spec.function_blob is not None and not self.cluster_mode:
                # Strip the inline blob off the wire spec: workers cache
                # the function by id after the first dispatch, so
                # re-pickling the blob for every task of a flood is pure
                # waste.  The blob moves to the GCS function table (the
                # local LRU below may evict it — a closure-minting driver
                # must not pin every blob in raylet memory) and the
                # export-once growth matches reference function-manager
                # semantics.  (Cluster mode keeps it inline — forwarded
                # specs must stay self-contained for peers.)
                if key not in self._fn_cache:
                    self._gcs_safe(self.gcs.put_function, key,
                                   spec.function_blob)
                    self._fn_cache[key] = spec.function_blob
                spec.function_blob = None
            if key not in conn.sent_fns:
                fn_blob = self._fn_cache.get(key)
                if fn_blob is None:
                    fn_blob = self._gcs_safe(self.gcs.get_function, key)
                    if fn_blob is not None:
                        self._fn_cache[key] = fn_blob
                if len(conn.sent_fns) > (1 << 16):
                    conn.sent_fns.clear()  # worker re-fetches; bounded set
                conn.sent_fns.add(key)
            if len(self._fn_cache) > 512:  # bounded write-through cache
                self._fn_cache.pop(next(iter(self._fn_cache)))
        # Batch followers queue ON the worker behind the head task: they
        # are DISPATCHED (shipped) but not yet RUNNING.
        self._record_event(spec, "RUNNING" if running else "DISPATCHED",
                           pid=conn.pid)
        return {"t": "task", "spec": spec, "arg_values": arg_values,
                "fn_blob": fn_blob}

    def _dispatch(self, spec: TaskSpec, conn: _WorkerConn):
        t0 = time.time() if self._spec_traced(spec) else 0.0
        conn.send(self._dispatch_msg(spec, conn))
        if t0:
            # dispatch hop: message construction (arg inlining, function
            # blob resolution) + the socket hand-off to the worker
            self._trace_hop(spec, "raylet.dispatch", t0, pid=conn.pid)

    def _dispatch_many(self, specs: List[TaskSpec], conn: _WorkerConn):
        """Dispatch a sequential batch in one coalesced frame; the worker
        sees ordinary per-task messages (recv_msg splits the frames) and
        runs them in order.  current_task ends as specs[0] — the one the
        worker starts executing first."""
        t0 = time.time() if any(map(self._spec_traced, specs)) else 0.0
        msgs = [self._dispatch_msg(s, conn, running=(i == 0))
                for i, s in enumerate(specs)]
        conn.current_task = specs[0]
        try:
            conn.send_many(msgs)
        except OSError:
            # dead pool worker, EOF not yet processed (same race as the
            # actor pump): inflight holds the batch, the death path
            # retries/errors it
            self._on_worker_death(conn)
            return
        if t0:
            for s in specs:
                if self._spec_traced(s):
                    self._trace_hop(s, "raylet.dispatch", t0, pid=conn.pid,
                                    batch=len(specs))

    def _pump_actor(self, actor: _ActorState):
        if actor.node_id is not None and actor.node_id != self.node_id:
            # Remote-executing actor (owner side): relay calls to the exec
            # node; it enforces max_concurrency and FIFO order (TCP keeps
            # our send order).
            if actor.state != "alive":
                return
            while actor.queue:
                spec = actor.queue.popleft()
                if self._dep_errored(spec):
                    continue
                if spec.method_name == "__ray_terminate__":
                    actor.restarts_left = 0
                self._record_event(spec, "FORWARDED", node=actor.node_id)
                if not self._forward_task(spec, actor.node_id):
                    actor.queue.appendleft(spec)
                    return
            return
        def group_of(s: TaskSpec) -> str:
            return getattr(s, "concurrency_group", None) or "_default"

        def group_has_room(s: TaskSpec) -> bool:
            if actor.group_limits is None:
                return True
            g = group_of(s)
            limit = actor.group_limits.get(g,
                                           actor.group_limits["_default"])
            used = sum(1 for f in actor.inflight.values()
                       if group_of(f) == g)
            return used < limit

        # Scan instead of strict FIFO when groups are declared: a task
        # whose group is saturated is skipped so OTHER groups keep flowing
        # (FIFO is preserved WITHIN each group — skipped specs keep their
        # relative order in the deferred queue).
        deferred_groups: deque = deque()
        out_msgs = []
        traced_dispatches: list = []  # (spec, t0, pid) — hop spans
        while (actor.state == "alive" and actor.conn is not None
               and actor.queue and len(actor.inflight) < actor.admit_limit()):
            spec = actor.queue.popleft()
            if self._dep_errored(spec):
                continue
            if self._deadline_expired(spec):
                self._m_deadline_exceeded += 1
                self._shed_spec(spec, DeadlineExceededError(
                    f"call {spec.name} deadline expired in the actor queue",
                    hop="raylet.pre_dispatch"), "EXPIRED", hop="pre_dispatch")
                self._cancel_children(spec.task_id, deadline=True)
                continue
            if not group_has_room(spec):
                deferred_groups.append(spec)
                continue
            if self.cluster_mode and self._remote_deps_pending(spec):
                # A store arg lives on another node: keep FIFO order, park
                # the call until the pull seals it here (waiters fire only
                # on local statuses; duplicates are harmless re-pumps).
                actor.queue.appendleft(spec)
                for oid in spec.dependency_ids():
                    st = self._objects.get(oid)
                    if (st is not None
                            and st.status not in ("inline", "store", "error")):
                        self._object_waiters.setdefault(oid, []).append(
                            lambda _oid, a=actor: self._pump_actor(a))
                break
            if spec.method_name == "__ray_terminate__":
                # Graceful exit: the worker process will exit after replying;
                # the EOF must not be treated as a crash worth restarting.
                actor.restarts_left = 0
            actor.inflight[spec.task_id] = spec
            conn = actor.conn
            conn.state = "busy"
            conn.current_task = spec
            conn.inflight[spec.task_id] = spec
            arg_values = {}
            for oid in spec.dependency_ids():
                st = self._objects.get(oid)
                if st is not None and st.status == "inline":
                    arg_values[oid.hex()] = st.value
            if self._spec_traced(spec):
                traced_dispatches.append((spec, time.time(), conn.pid))
            self._record_event(spec, "RUNNING", pid=conn.pid)
            out_msgs.append({"t": "task", "spec": spec,
                             "arg_values": arg_values, "fn_blob": None})
        if out_msgs and actor.conn is not None:
            # one coalesced frame for the whole pump (one sendall)
            try:
                actor.conn.send_many(out_msgs)
            except OSError:
                # The worker died and a submit raced its EOF onto the dead
                # socket (a direct-channel reconcile can arrive in that
                # window) — the specs are in inflight, so the death path
                # errors/retries them with crash forensics as usual.
                while deferred_groups:
                    actor.queue.appendleft(deferred_groups.pop())
                self._on_worker_death(actor.conn)
                return
            for spec, t0, pid in traced_dispatches:
                self._trace_hop(spec, "raylet.dispatch", t0, pid=pid)
        # put group-saturated specs back at the FRONT, preserving order
        while deferred_groups:
            actor.queue.appendleft(deferred_groups.pop())

    # --------------------------------------------------------------- actors

    def _on_actor_death(self, actor_id: ActorID, reason: str, allow_restart=True):
        actor = self._actors.get(actor_id)
        if actor is None:
            return
        # Direct transport: every death invalidates brokered channels —
        # bump the generation (fences reconciles from the old incarnation)
        # and tell local direct callers to tear down now.
        actor.generation += 1
        actor.direct_info = None
        self._broadcast_direct_fence(actor_ids=[actor_id])
        # release resources held since creation
        self._release_task_resources(actor.creation_spec)
        dead_conn = actor.conn
        if dead_conn is not None:
            dead_conn.actor_id = None
            dead_conn.current_task = None
            dead_conn.inflight.clear()
            actor.conn = None
        interrupted = list(actor.inflight.values())
        actor.inflight.clear()
        if allow_restart and actor.restarts_left != 0:
            if actor.restarts_left > 0:
                actor.restarts_left -= 1
            actor.state = "restarting"
            # interrupted calls fail (max_task_retries=0 semantics)
            err = ActorDiedError(actor_id.hex(), reason + " (restarting)")
            for spec in interrupted:
                if spec.kind == ACTOR_TASK:
                    for oid in spec.return_ids():
                        self._object_error(oid, err)
            # resubmit the creation task on a fresh worker (possibly on a
            # different node — the spill counter restarts with the attempt)
            creation = actor.creation_spec
            creation._acquired_pool = None
            creation._spill_count = 0
            actor.node_id = None
            # Checkpointable actors restart WARM: the creation re-runs
            # __init__ and then __ray_restore__(latest __ray_save__ state)
            # — calls completed after that snapshot are NOT replayed
            # (their side effects since it are lost; callers saw their
            # results and the interrupted tail got a retryable error).
            if actor.checkpoint_oid is not None:
                creation.restore_oid = actor.checkpoint_oid
                self._m_ckpt_restores += 1
            # the restarted worker validates direct hellos against the
            # NEW generation; stale channels/retries fence out
            creation._direct_generation = actor.generation
            if self.cluster_mode and actor.foreign_owner is None:
                self._gcs_post("update_actor", actor_id.binary(),
                               "restarting")
            self._ready_queue.append(creation)
            actor.state = "pending"
            self._schedule()
            return
        actor.state = "dead"
        actor.death_reason = reason
        self._release_actor_checkpoint(actor)
        err = ActorDiedError(actor_id.hex(), reason)
        for spec in interrupted:
            for oid in spec.return_ids():
                self._object_error(oid, err)
        # The creation task's return object lives in conn.inflight (not
        # actor.inflight) while the ACTOR_CREATION_TASK runs — if the worker
        # died mid-creation it would stay pending forever and any get() on
        # the actor-readiness ref would hang.  Error it unless creation
        # already resolved it.
        for oid in actor.creation_spec.return_ids():
            if self._object_status(oid) not in ("inline", "store", "error"):
                self._object_error(oid, err)
        while actor.queue:
            spec = actor.queue.popleft()
            for oid in spec.return_ids():
                self._object_error(oid, err)
        if actor.foreign_owner is not None:
            # exec side of a forwarded actor: the owner runs the restart
            # state machine — report the death there.
            peer = self._get_peer(actor.foreign_owner)
            if peer is not None:
                try:
                    peer.send({"t": "xactor_death", "actor_id": actor_id,
                               "reason": reason})
                except OSError:
                    self._drop_peer(peer)
            del self._actors[actor_id]
        elif actor.name or self.cluster_mode:
            self._gcs_post("remove_actor", actor_id.binary())

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        actor = self._actors.get(actor_id)
        if actor is None:
            if self.cluster_mode:
                # Not ours: relay the kill to the owner.
                owner = self._actor_owner_cache.get(actor_id)
                if owner is None:
                    info = self._gcs_safe(self.gcs.get_actor,
                                          actor_id.binary())
                    owner = info["owner_node"] if info else None
                if owner and owner != self.node_id:
                    peer = self._get_peer(owner)
                    if peer is not None:
                        try:
                            peer.send({"t": "xkill", "actor_id": actor_id,
                                       "no_restart": no_restart})
                        except OSError:
                            self._drop_peer(peer)
            return
        if no_restart:
            actor.restarts_left = 0
        if actor.node_id is not None and actor.node_id != self.node_id:
            # executing on a peer: kill there; death flows back as
            # xactor_death.  Relay no_restart AS GIVEN: the exec side
            # never restarts regardless (foreign actors carry
            # restarts_left=0) but a restart-allowed kill must reach it
            # so a checkpointable actor can take its final snapshot.
            peer = self._get_peer(actor.node_id)
            if peer is not None:
                try:
                    peer.send({"t": "xkill", "actor_id": actor_id,
                               "no_restart": no_restart})
                    return
                except OSError:
                    self._drop_peer(peer)
            # peer unreachable: treat as dead now
            actor.node_id = None
            self._on_actor_death(actor_id, "exec node unreachable",
                                 allow_restart=not no_restart)
            return
        conn = actor.conn
        if conn is not None and conn.pid:
            if (not no_restart
                    and actor.creation_spec.checkpoint_interval > 0):
                # Restart-allowed kill of a checkpointable actor: distinct
                # from hard kill — ask the worker to take a FINAL
                # checkpoint and exit, so the restart restores the exact
                # pre-kill state instead of whatever the last cadence
                # snapshot happened to hold.  (Previously this routed
                # through the same SIGKILL as no_restart=True.)  The
                # request drains behind queued calls, so a wedged or
                # slow actor gets the hard kill after a grace — kill()
                # must never silently become a no-op.
                try:
                    conn.send({"t": "exit_checkpoint"})
                except OSError:
                    pass  # fall through to the hard kill
                else:
                    def force(conn=conn, pid=conn.pid,
                              actor_id=actor.actor_id):
                        live = self._actors.get(actor_id)
                        if live is None or live.conn is not conn:
                            return  # exited gracefully (or restarted)
                        try:
                            os.kill(pid, 9)
                        except OSError:
                            pass

                    self.add_timer(
                        max(0.1, config.kill_checkpoint_grace_s), force)
                    return  # EOF after the final checkpoint drives restart
            try:
                os.kill(conn.pid, 9)
            except OSError:
                pass
        # death will be observed via socket EOF

    # ---------------------------------------- overload / deadlines / cancel

    def _failure_state(self, err) -> str:
        """Task-event state for a worker-reported failure: deadline and
        cancel interruptions enforced ON the worker still show up as
        EXPIRED/CANCELLED events (and count) here, not as generic FAILED."""
        if isinstance(err, DeadlineExceededError):
            self._m_deadline_exceeded += 1
            return "EXPIRED"
        if isinstance(err, TaskCancelledError):
            self._m_cancelled += 1
            return "CANCELLED"
        if isinstance(err, BackPressureError):
            self._m_shed += 1
            return "SHED"
        return "FAILED"

    def _note_child(self, spec: TaskSpec):
        """Record the parent->child cancel fan-out edge (submits made
        while a task ran, relayed or direct).  Bounded LRU on parents."""
        parent = spec.parent_task_id
        if parent is None:
            return
        kids = self._children.get(parent)
        if kids is None:
            kids = self._children[parent] = []
            while len(self._children) > 4096:
                self._children.popitem(last=False)
        if len(kids) < 1024:  # runaway fan-out: stop indexing, not serving
            kids.append(spec.task_id)

    def _deadline_expired(self, spec: TaskSpec) -> bool:
        return (config.deadlines and spec.deadline is not None
                and time.time() > spec.deadline)

    def _shed_spec(self, spec: TaskSpec, err: Exception, state: str,
                   **extra):
        """Terminal rejection of a queued/admitted task: error its
        returns, release anything it pinned, record the task event (a
        shed request still exports its errored span via _record_event)."""
        for oid in spec.return_ids():
            self._object_error(oid, err)
        self._record_event(spec, state, error=self._err_summary(err),
                           **extra)

    def _shed_lowest_headroom(self, queue_, spec: TaskSpec, where: str):
        """Bounded-queue admission (RAY_TPU_MAX_QUEUE_DEPTH): the queue is
        full — shed the task with the LEAST deadline headroom (closest to
        expiry: least likely to finish in time; no deadline = infinite
        headroom), which is the new arrival only when nothing queued is
        worse.  Returns True when the NEW spec was shed (caller must not
        enqueue it)."""
        now = time.time()

        def headroom(s: TaskSpec) -> float:
            return (s.deadline - now) if s.deadline is not None \
                else float("inf")

        victim = spec
        if config.deadlines:
            worst = min(queue_, key=headroom, default=None)
            if worst is not None and headroom(worst) < headroom(victim):
                try:
                    queue_.remove(worst)
                    victim = worst
                except ValueError:  # raced away
                    pass
        self._m_shed += 1
        self._shed_spec(victim, BackPressureError(
            f"{where} at max_queue_depth={config.max_queue_depth}; "
            f"task {victim.name} shed"), "SHED", where=where)
        return victim is spec

    def _on_deadline(self, tid: TaskID, return_oids, name: str):
        """Deadline timer fired: reap the task wherever it still is.
        Queued work is shed here with cancel fan-out to its children;
        running work gets a deadline-flavored cancel frame (the worker's
        own watchdog usually beat us to it — both are idempotent)."""
        if not config.deadlines:
            return
        if all(self._object_status(o) in ("inline", "store", "error")
               for o in return_oids):
            return  # completed (or already errored) in time
        err = DeadlineExceededError(
            f"task {name} missed its deadline", hop="raylet.queue")
        found = self._dequeue_tid(tid)
        if found is not None:
            self._m_deadline_exceeded += 1
            self._shed_spec(found, err, "EXPIRED", hop="queue")
            self._schedule()
        else:
            self._interrupt_running(tid, deadline=True)
        # fan out regardless: downstream work inherited this deadline but
        # its own timers may sit on other nodes' clocks — reap now
        self._cancel_children(tid, deadline=True)

    def _dequeue_tid(self, tid: TaskID) -> Optional[TaskSpec]:
        """Remove a not-yet-running task from whichever queue holds it
        (arg-wait, ready queue, or an actor call queue); returns its spec
        or None."""
        entry = self._waiting.pop(tid, None)
        if entry is not None:
            spec, missing = entry
            for m in missing:
                peers = self._dep_index.get(m)
                if peers:
                    peers.discard(tid)
            return spec
        for spec in self._ready_queue:
            if spec.task_id == tid:
                self._ready_queue.remove(spec)
                return spec
        for actor in self._actors.values():
            for spec in actor.queue:
                if spec.task_id == tid:
                    actor.queue.remove(spec)
                    return spec
        return None

    def _interrupt_running(self, tid: TaskID, deadline: bool) -> bool:
        """Ship a cancel frame to the worker executing ``tid`` (relayed
        dispatch or a direct call we saw a RUNNING note for): its cancel
        registry interrupts the executor thread and the ordinary done
        path reports the typed error."""
        rec = self._direct_running.get(tid)
        conn = rec[0] if rec is not None else None
        if conn is None:
            for c in self._workers.values():
                if tid in c.inflight:
                    conn = c
                    break
        if conn is None:
            return False
        try:
            conn.send({"t": "cancel", "task_id": tid, "deadline": deadline})
        except OSError:
            self._on_worker_death(conn)
            return False
        return True

    def _cancel_children(self, tid: TaskID, deadline: bool = False,
                         _depth: int = 0):
        """Recursive cancel fan-out along recorded parent->child edges."""
        if _depth > 64:
            return
        for child_tid in self._children.pop(tid, ()):
            self._cancel_tid(child_tid, deadline=deadline,
                             recursive=True, _depth=_depth + 1)

    def _note_cancelled(self, tid: TaskID, deadline: bool):
        """Remember a reaped task id so a child whose submit/running note
        is still in flight gets caught at admission (bounded LRU)."""
        self._cancelled_tids[tid] = deadline
        while len(self._cancelled_tids) > 4096:
            self._cancelled_tids.popitem(last=False)

    def _cancelled_flag(self, spec: TaskSpec) -> Optional[bool]:
        """Was this spec — or the parent it was spawned from — already
        reaped by a cancel/deadline fan-out?  Returns the deadline flag
        (False = plain cancel) or None."""
        flag = self._cancelled_tids.get(spec.task_id)
        if flag is None and spec.parent_task_id is not None:
            flag = self._cancelled_tids.get(spec.parent_task_id)
        return flag

    def _cancel_tid(self, tid: TaskID, deadline: bool = False,
                    recursive: bool = True, _depth: int = 0,
                    _relay: bool = True) -> bool:
        """Cancel one task by id wherever it is on this node; optionally
        fan out to its children and relay to peer raylets (forwarded
        tasks / foreign actor calls execute elsewhere)."""
        self._note_cancelled(tid, deadline)
        hit = False
        spec = self._dequeue_tid(tid)
        if spec is not None:
            hit = True
            if deadline:
                self._m_deadline_exceeded += 1
                self._shed_spec(spec, DeadlineExceededError(
                    f"task {spec.name} missed its deadline",
                    hop="raylet.queue"), "EXPIRED", hop="queue")
            else:
                self._m_cancelled += 1
                self._shed_spec(spec, TaskCancelledError(
                    f"task {spec.name} was cancelled before it ran"),
                    "CANCELLED")
            self._schedule()
        elif self._interrupt_running(tid, deadline=deadline):
            # counted when the worker reports the typed error (the done
            # path routes through _failure_state) — counting here too
            # would double every mid-exec cancel
            hit = True
        elif _relay and self.cluster_mode:
            # not here: the task may have been forwarded / executed on
            # a peer (foreign actor call, spillback) — one-hop relay
            for peer in list(self._peers.values()):
                try:
                    peer.send({"t": "xcancel", "task_id": tid,
                               "deadline": deadline,
                               "recursive": recursive})
                except OSError:
                    self._drop_peer(peer)
        if recursive:
            self._cancel_children(tid, deadline=deadline, _depth=_depth)
        return hit

    def cancel_task(self, oid: ObjectID, force: bool = False,
                    recursive: bool = True) -> bool:
        """Cancel the task that produces ``oid`` (reference:
        ``CoreWorker::CancelTask``): queued work is dropped with a typed
        ``TaskCancelledError``, RUNNING work is interrupted in its
        executor thread, and ``recursive=True`` fans the cancel out to
        every task it spawned (``force`` currently behaves like a normal
        cancel — the interrupt already stops execution)."""
        return self._cancel_tid(oid.task_id(), deadline=False,
                                recursive=recursive)

    # --------------------------------------------------------------- requests

    def _handle_request(self, conn: Optional[_WorkerConn], msg: dict):
        """Requests from workers (over socket).  Driver uses direct calls."""
        rid = msg["rid"]
        op = msg["op"]

        def reply(ok=True, value=None, error=None):
            # _queue_reply coalesces every reply generated by one drained
            # train into a single sendall per conn.
            self._queue_reply(conn, {"t": "reply", "rid": rid, "ok": ok,
                                     "value": value, "error": error})

        def deferred_reply(value):
            # A worker that timed out already popped its pending entry, so a
            # late reply is simply ignored on its side; a dead socket is
            # swallowed here.
            conn.request_cancels.pop(rid, None)
            try:
                self._queue_reply(conn, {"t": "reply", "rid": rid,
                                         "ok": True, "value": value})
            except OSError:
                pass

        try:
            if op == "get":
                ids = [ObjectID.from_hex(h) for h in msg["ids"]]
                cancel = self.async_get(ids, deferred_reply)
                if cancel is not None:
                    conn.request_cancels[rid] = cancel
            elif op == "wait":
                ids = [ObjectID.from_hex(h) for h in msg["ids"]]
                cancel = self.async_wait(
                    ids, msg["num_returns"], msg.get("timeout"), deferred_reply,
                )
                if cancel is not None:
                    conn.request_cancels[rid] = cancel
            elif op == "put_inline":
                self._object_inline(ObjectID.from_hex(msg["id"]), msg["blob"],
                                    contains=msg.get("contains"))
                reply()
            elif op == "register_stored":
                oid = ObjectID.from_hex(msg["id"])
                if "size" in msg:
                    self._obj(oid).size = msg["size"]
                self._object_in_store(oid, contains=msg.get("contains"))
                self._maybe_replicate(oid,
                                      force=msg.get("replicate", False))
                reply()
            elif op == "kv_put":
                self.gcs.kv_put(msg["ns"], msg["key"], msg["val"])
                reply()
            elif op == "kv_get":
                reply(value=self.gcs.kv_get(msg["ns"], msg["key"]))
            elif op == "kv_del":
                reply(value=self.gcs.kv_del(msg["ns"], msg["key"]))
            elif op == "kv_keys":
                reply(value=self.gcs.kv_keys(msg["ns"], msg["prefix"]))
            elif op == "put_function":
                self._fn_cache[msg["id"]] = msg["blob"]
                self.gcs.put_function(msg["id"], msg["blob"])
                reply()
            elif op == "get_function":
                blob = self._fn_cache.get(msg["id"])
                if blob is None:
                    blob = self.gcs.get_function(msg["id"])
                reply(value=blob)
            elif op == "named_actor":
                info = self.gcs.lookup_named_actor(
                    msg.get("namespace", ""), msg["name"])
                if info is None:
                    reply(ok=False, error=ValueError(
                        f"no actor named {msg['name']!r}"))
                elif info.get("state") == "dead":
                    reply(ok=False, error=ActorDiedError(
                        info["actor_id"].hex(),
                        info.get("death_reason", "actor is dead")))
                else:
                    from ray_tpu_torch._vendor import cloudpickle as _cp

                    spec = (_cp.loads(info["spec_blob"])
                            if info.get("spec_blob") else None)
                    if spec is None:
                        aid = ActorID(info["actor_id"])
                        local = self._actors.get(aid)
                        spec = local.creation_spec if local else None
                    reply(value={
                        "actor_id": ActorID(info["actor_id"]),
                        "creation_spec": spec,
                    })
            elif op == "actor_state":
                actor = self._actors.get(msg["actor_id"])
                if actor is not None:
                    reply(value=actor.state)
                else:
                    info = (self._gcs_safe(self.gcs.get_actor,
                                           msg["actor_id"].binary())
                            if self.cluster_mode else None)
                    reply(value=info["state"] if info else None)
            elif op == "free":
                for h in msg["ids"]:
                    self.drop_object(ObjectID.from_hex(h))
                reply()
            elif op == "stream_next":
                cancel = self.async_stream_next(
                    msg["task_id"], msg["index"], deferred_reply)
                if cancel is not None:
                    conn.request_cancels[rid] = cancel
            elif op == "reconstruct":
                reply(value=self.reconstruct_object(
                    ObjectID.from_hex(msg["id"])))
            elif op == "cancel_task":
                reply(value=self.cancel_task(
                    ObjectID.from_hex(msg["id"]),
                    force=msg.get("force", False),
                    recursive=msg.get("recursive", True)))
            elif op == "available_resources":
                reply(value=dict(self.resources_available))
            elif op == "cluster_resources":
                reply(value=dict(self.resources_total))
            elif op == "nodes":
                reply(value=self.gcs.nodes())
            elif op == "gcs_list_actors":
                reply(value=self.gcs.list_actors())
            elif op == "cancel_request":
                # The worker timed out and dropped its pending entry:
                # deregister the waiters so they don't accumulate on the
                # object for its whole lifetime.
                cancel = conn.request_cancels.pop(msg["target_rid"], None)
                if cancel is not None:
                    self._safe(cancel)
                reply()
            elif op == "pg_state":
                reply(value=self.pg_state(msg["pg_id"]))
            elif op == "create_pg":
                ok = self.create_pg(
                    msg["pg_id"], msg["bundles"], msg["strategy"],
                    ready_oid=msg.get("ready_oid"),
                )
                reply(value=ok)
            elif op == "remove_pg":
                self.remove_pg(msg["pg_id"])
                reply()
            elif op == "state_snapshot":
                reply(value=self.state_snapshot(
                    objects_limit=msg.get("objects_limit", 0)))
            elif op == "flush_task_events":
                self.flush_task_events()
                reply()
            elif op in ("list_task_events", "summarize_task_events",
                        "task_events_raw"):
                # Cluster-wide state reads proxied to the GCS task-event
                # table; flush first so this node's freshest events count.
                self.flush_task_events()
                kw = {k: msg[k] for k in ("job_id", "state", "limit")
                      if k in msg}
                reply(value=self._gcs_safe(getattr(self.gcs, op), **kw))
            elif op == "flush_trace_spans":
                self.flush_trace_spans()
                reply()
            elif op in ("get_trace", "list_trace_spans",
                        "trace_table_stats"):
                # Cluster-wide trace reads proxied to the GCS trace table;
                # flush so this node's freshest spans count.
                self.flush_trace_spans()
                kw = {k: msg[k] for k in ("trace_id", "job_id", "limit")
                      if k in msg}
                reply(value=self._gcs_safe(getattr(self.gcs, op), **kw))
            elif op == "flush_profile_samples":
                self.flush_profile_samples()
                reply()
            elif op in ("list_profile_samples", "profile_table_stats"):
                # Cluster-wide profile reads proxied to the GCS profile
                # table; flush so this node's freshest window counts.
                self.flush_profile_samples()
                kw = {k: msg[k] for k in ("node_id", "since", "limit")
                      if k in msg}
                reply(value=self._gcs_safe(getattr(self.gcs, op), **kw))
            elif op == "flush_metric_points":
                self.flush_metric_points()
                reply()
            elif op in ("query_metrics", "metrics_table_stats"):
                # Cluster-wide time-series reads proxied to the GCS
                # metrics table; flush so this node's freshest deltas
                # count (other nodes' points land on their own 1s ticks).
                self.flush_metric_points()
                kw = {k: msg[k] for k in ("name", "query_op", "tags",
                                          "node_id", "since", "until",
                                          "window_s", "q", "limit")
                      if k in msg}
                if "query_op" in kw:
                    kw["op"] = kw.pop("query_op")
                reply(value=self._gcs_safe(getattr(self.gcs, op), **kw))
            elif op == "list_alerts":
                kw = {k: msg[k] for k in ("state", "limit") if k in msg}
                reply(value=self._gcs_safe(self.gcs.list_alerts, **kw))
            elif op == "dump_stacks":
                # this node only: raylet process + all local workers
                self.collect_local_stacks(deferred_reply,
                                          pid=msg.get("pid"))
            elif op == "collect_stacks":
                # cluster-wide: the blocking GCS gather runs off-thread —
                # the event thread must stay free to answer OUR share
                self._spawn_gcs_query(
                    deferred_reply, "collect_stacks",
                    node_id=msg.get("node_id"), pid=msg.get("pid"),
                    timeout_s=msg.get("timeout_s", 3.0))
            elif op == "gcs_node_query":
                self._spawn_gcs_query(
                    deferred_reply, "node_query",
                    node_id=msg.get("node_id"), kind=msg["kind"],
                    payload=msg.get("payload"),
                    timeout_s=msg.get("timeout_s", 3.0))
            elif op == "list_logs":
                reply(value=self._list_logs())
            elif op == "tail_log":
                reply(value=self._tail_log(msg.get("name"),
                                           msg.get("offset"),
                                           msg.get("lines", 100)))
            elif op == "kill_actor":
                self.kill_actor(msg["actor_id"], msg.get("no_restart", True))
                reply()
            elif op == "direct_lookup":
                # direct-transport broker: the requester becomes a fence
                # subscriber (actor-death / node-SUSPECT teardown notices)
                conn.uses_direct = True
                reply(value=self.direct_call_info(msg["actor_id"]))
            elif op == "direct_lease":
                conn.uses_direct = True
                reply(value=self.acquire_direct_lease(msg["spec"]))
            elif op == "direct_lease_release":
                self.release_direct_lease(msg["lease_id"])
                reply()
            else:
                reply(ok=False, error=ValueError(f"unknown op {op}"))
        except Exception as e:  # noqa: BLE001
            try:
                reply(ok=False, error=e)
            except OSError:
                pass

    # get/wait used by both driver (via call) and workers (via requests).

    def _remove_waiter(self, oid: ObjectID, cb: Callable):
        lst = self._object_waiters.get(oid)
        if lst is not None:
            try:
                lst.remove(cb)
            except ValueError:
                pass
            if not lst:
                del self._object_waiters[oid]

    def async_get(self, ids: List[ObjectID], done_cb: Callable[[dict], None]):
        """done_cb receives {hex: ("inline", bytes) | ("store",) | ("error", e)}.

        Returns a cancel callable (or None if done synchronously) that
        deregisters the pending waiters — callers that time out MUST invoke
        it or the waiter list grows for the object's lifetime.
        """
        remaining = set()
        results: Dict[str, tuple] = {}

        def check(oid: ObjectID):
            st = self._objects.get(oid)
            status = st.status if st else "pending"
            if status == "inline":
                results[oid.hex()] = ("inline", st.value)
            elif status == "store":
                results[oid.hex()] = ("store",)
            elif status == "error":
                results[oid.hex()] = ("error", st.error)
            else:
                if self.cluster_mode:
                    # sealed elsewhere (or unknown): fetch it here; the
                    # waiter resolves on local seal
                    self._maybe_pull(oid)
                return False
            return True

        def on_ready(oid: ObjectID):
            if oid in remaining and check(oid):
                remaining.discard(oid)
                if not remaining:
                    done_cb(results)

        for oid in ids:
            if not check(oid):
                remaining.add(oid)
        if not remaining:
            done_cb(results)
            return None
        for oid in list(remaining):
            self._object_waiters.setdefault(oid, []).append(on_ready)

        def cancel():
            for oid in list(remaining):
                self._remove_waiter(oid, on_ready)
            remaining.clear()

        return cancel

    def async_wait(self, ids: List[ObjectID], num_returns: int,
                   timeout: Optional[float], done_cb: Callable[[List[str]], None]):
        """Returns a cancel callable (or None if done synchronously)."""
        # Dedup: the same callback registered once per duplicate id would
        # count a single object's readiness multiple times toward
        # num_returns (reference rejects duplicate refs in ray.wait).
        ids = list(dict.fromkeys(ids))
        num_returns = min(num_returns, len(ids))
        ready: List[str] = []
        fired = [False]
        pending: List[ObjectID] = []

        def is_ready(oid):
            status = self._object_status(oid)
            if status == "remote" and self.cluster_mode:
                self._maybe_pull(oid)  # fetch_local semantics
            return status in ("inline", "store", "error")

        def cleanup():
            for oid in pending:
                self._remove_waiter(oid, on_ready)
            pending.clear()

        def reply_value():
            # errored subset rides along: wait() counts an error as ready
            # (ray semantics), but the direct transport's engagement
            # watermark must not clear on one — a raylet-side failure
            # (dep error, dead actor) proves nothing about delivery of
            # the calls before it.
            return {"ready": ready,
                    "errored": [h for h in ready
                                if self._object_status(
                                    ObjectID.from_hex(h)) == "error"]}

        def fire():
            if not fired[0]:
                fired[0] = True
                cleanup()
                done_cb(reply_value())

        def on_ready(oid: ObjectID):
            if fired[0]:
                return
            ready.append(oid.hex())
            if len(ready) >= num_returns:
                fire()

        for oid in ids:
            if is_ready(oid):
                ready.append(oid.hex())
        if len(ready) >= num_returns:
            ready[:] = ready[:num_returns]
            fired[0] = True
            done_cb(reply_value())
            return None

        pending.extend(oid for oid in ids if not is_ready(oid))
        for oid in pending:
            self._object_waiters.setdefault(oid, []).append(on_ready)
        if timeout is not None:
            self.add_timer(timeout, fire)

        def cancel():
            fired[0] = True
            cleanup()

        return cancel

    # --------------------------------------------------------------- PGs

    def create_pg(self, pg_id: str, bundles: List[Dict[str, float]],
                  strategy: str, ready_oid: Optional[ObjectID] = None) -> bool:
        if self.cluster_mode:
            # GCS places bundles across nodes and pushes pg_reserve to the
            # involved raylets; ready resolves on the pg_ready push.
            # Transient GCS failures RAISE (propagating to the caller)
            # rather than masquerading as "exceeds capacity".
            ok = self.gcs.create_pg(pg_id, bundles, strategy, self.node_id)
            if not ok:
                return False
            if ready_oid is not None:
                self._obj(ready_oid)
            self._cluster_pg_ready[pg_id] = ready_oid
            return True
        pg = _PlacementGroup(pg_id, bundles, strategy, ready_oid=ready_oid)
        total = pg.total()
        if not _fits(self.resources_total, total):
            # Exceeds total node capacity: can never be satisfied (the
            # multi-node scheduler will spread bundles across nodes instead).
            return False
        if ready_oid is not None:
            self._obj(ready_oid)
        self._pgs[pg_id] = pg
        if _fits(self.resources_available, total):
            _acquire(self.resources_available, total)
            pg.unreserved.clear()
            pg.state = "created"
            if ready_oid is not None:
                self._object_inline(ready_oid, _PG_READY_BLOB)
        # else: stays pending; _activate_pending_pgs reserves it when
        # resources free up (reference queues infeasible PGs — never drives
        # availability negative).
        return True

    def pg_state(self, pg_id: str) -> Optional[str]:
        pg = self._pgs.get(pg_id)
        if pg is not None and not pg.fragment:
            return pg.state
        if self.cluster_mode:
            info = self._gcs_safe(self.gcs.pg_info, pg_id)
            if info is not None:
                return info["state"] if info["state"] == "created" \
                    else "pending"
        return pg.state if pg is not None else None

    def remove_pg(self, pg_id: str, _from_gcs: bool = False):
        if self.cluster_mode and not _from_gcs:
            # cluster PG: the GCS fans pg_remove out to every fragment
            # holder (including us); local cleanup happens on that push
            if self._gcs_safe(self.gcs.remove_cluster_pg, pg_id):
                return
        pg = self._pgs.pop(pg_id, None)
        if pg is None:
            return
        removed_err = ValueError(f"placement group {pg_id} was removed")
        # Tasks targeting this PG could never schedule again — fail them
        # now instead of deferring forever.  Both the ready queue and the
        # dep-blocked table must be purged: a waiting task would re-enter
        # the ready queue after this purge and then defer on every
        # _schedule pass.
        # Collect victims first: _object_error re-enters _schedule, which
        # mutates the ready queue — never error while iterating it.
        victims = [s for s in self._ready_queue
                   if (s.placement or {}).get("pg") == pg_id]
        self._ready_queue = deque(
            s for s in self._ready_queue
            if (s.placement or {}).get("pg") != pg_id)
        for task_id, (spec, missing) in list(self._waiting.items()):
            if (spec.placement or {}).get("pg") != pg_id:
                continue
            del self._waiting[task_id]
            for m in missing:
                peers = self._dep_index.get(m)
                if peers:
                    peers.discard(task_id)
            victims.append(spec)
        for spec in victims:
            for oid in spec.return_ids():
                self._object_error(oid, removed_err)
            self._record_event(spec, "FAILED", pg_removed=True)
        if pg.state == "created":
            # Reference kills PG-leased workers on removal
            # (`gcs_placement_group_scheduler.cc` destroys bundle leases):
            # reclaim actors and running tasks inside the bundles before
            # returning capacity so the node pool isn't oversubscribed by
            # processes still running in the removed group.
            for actor in list(self._actors.values()):
                if ((actor.creation_spec.placement or {}).get("pg") != pg_id
                        or actor.state == "dead"):
                    continue
                if actor.conn is None:
                    # Not yet dispatched (pending/restarting): there is no
                    # process to kill and no EOF will ever arrive — mark it
                    # dead directly or it hangs in state "pending" forever.
                    actor.restarts_left = 0
                    self._on_actor_death(actor.actor_id, "placement group "
                                         "removed", allow_restart=False)
                else:
                    self.kill_actor(actor.actor_id)
            for conn in list(self._workers.values()):
                if conn.actor_id is not None:
                    continue
                for spec in conn.inflight.values():
                    if (spec.placement or {}).get("pg") == pg_id:
                        spec.retries_left = 0
                        if conn.pid:
                            try:
                                os.kill(conn.pid, 9)
                            except OSError:
                                pass
                        break
            _release(self.resources_available, pg.reserved_total())
        else:
            # pending: a FRAGMENT may hold per-bundle partial reservations
            _release(self.resources_available, pg.reserved_total())
            if pg.ready_oid is not None:
                # never becomes ready: fail its ready() object so waiters
                # unblock instead of hanging forever
                self._object_error(pg.ready_oid, ValueError(
                    f"placement group {pg_id} was removed before its "
                    "bundles could be reserved"))
        self._schedule()

    # --------------------------------------------------------------- state

    @staticmethod
    def _err_summary(err) -> str:
        try:
            first = str(err).strip().splitlines()
            return f"{type(err).__name__}: {first[0] if first else ''}"[:200]
        except Exception:  # noqa: BLE001
            return type(err).__name__

    # ---- request-flow tracing (hop spans + span export pipeline) ----

    # Lifecycle interval -> hop span emitted when the NEXT transition
    # closes it.  RUNNING is deliberately absent: the executing worker's
    # task.run span (with get_args/exec/result_push children) owns that
    # interval — a raylet-side copy would double-attribute it.
    _TRACE_PHASE = {
        "PENDING_ARGS": "raylet.pending_args",
        "QUEUED": "raylet.queue",
        "FORWARDED": "raylet.await_remote",
        "SPILLED": "raylet.await_remote",
        "RECONSTRUCTING": "raylet.reconstructing",
    }

    @staticmethod
    def _spec_traced(spec: TaskSpec) -> bool:
        """Does this spec belong to a SAMPLED trace?  (The ctx rides the
        spec across processes; unsampled requests carry the bit so error
        paths can still export with real ids.)"""
        ctx = spec.trace_ctx
        return ctx is not None and ctx.get("sampled", True) \
            and _tracing.tracing_enabled()

    def _trace_hop(self, spec: TaskSpec, name: str, t0: float,
                   t1: Optional[float] = None, status: str = "OK",
                   error: Optional[str] = None, **attrs):
        """Emit one measured hop span under the request's submit span."""
        ctx = spec.trace_ctx
        _tracing.emit_span(
            f"{name} {spec.name}", ctx["trace_id"], ctx.get("span_id"),
            t0, time.time() if t1 is None else t1, status=status,
            error=error, proc="raylet", task_id=spec.task_id.hex(), **attrs)
        self._arm_trace_flush()

    def _arm_trace_flush(self):
        """Schedule a span flush for locally-emitted spans (they land in
        the process buffer without a control frame to piggyback on)."""
        if not self._trace_timer_armed:
            self._trace_timer_armed = True
            self.add_timer(config.trace_flush_interval_s,
                           self._trace_flush_tick)

    def _trace_transition(self, spec: TaskSpec, state: str, t: float,
                          error: Optional[str] = None):
        """Lifecycle transition -> close the previous phase's interval as
        a hop span.  The first transition also closes the inbox interval
        (raylet receipt -> first classification) opened by submit_task."""
        prev = getattr(spec, "_tr_prev", None)
        if prev is None:
            t_in = getattr(spec, "_tr_in", None)
            if t_in is not None:
                self._trace_hop(spec, "raylet.inbox", t_in, t)
        else:
            name = self._TRACE_PHASE.get(prev[0])
            if name is not None:
                failed = state == "FAILED"
                self._trace_hop(spec, name, prev[1], t,
                                status="ERROR" if failed else "OK",
                                error=error if failed else None)
        spec._tr_prev = (state, t)

    def _trace_ingest(self, spans: List[dict], dropped: int = 0):
        """Append a span batch (worker control frames / the local
        process buffer) to the bounded export buffer and arm the flush."""
        buf = self._trace_buf
        cap = config.trace_buffer_size
        self._trace_export_dropped += dropped
        self._trace_dropped_total += dropped
        for sp in spans:
            buf.append(sp)
            if len(buf) > cap:
                buf.popleft()
                self._trace_export_dropped += 1
                self._trace_dropped_total += 1
        if buf:
            self._arm_trace_flush()

    def flush_trace_spans(self):
        """Drain this process's span buffer plus everything workers have
        shipped, and post the batch to the GCS trace table."""
        local, dropped = _tracing.drain_pending()
        if local or dropped:
            self._trace_ingest(local, dropped)
        if not self._trace_buf and not self._trace_export_dropped:
            return
        t0 = time.perf_counter()
        spans = list(self._trace_buf)
        self._trace_buf.clear()
        dropped = self._trace_export_dropped
        self._trace_export_dropped = 0
        try:
            if isinstance(self.gcs, GcsClient):
                self.gcs.post("add_trace_spans", self.node_id, spans,
                              dropped, incarnation=self.incarnation)
            else:
                self.gcs.add_trace_spans(self.node_id, spans, dropped,
                                         incarnation=self.incarnation)
        except (ConnectionError, TimeoutError, OSError):
            # GCS unreachable: the batch is gone — count it (locally for
            # the metric, and toward the next successful flush so
            # trace_table_stats sees the hole) instead of silently
            # reporting zero drops across an outage.
            self._trace_dropped_total += len(spans)
            self._trace_export_dropped += dropped + len(spans)
        self._audit_flush("trace", t0, batch=spans)

    def _trace_flush_tick(self):
        # One-shot timer, armed lazily by the first ingest: an untraced
        # raylet pays nothing for the span pipeline.
        self._trace_timer_armed = False
        self.flush_trace_spans()
        # The driver emits spans without notifying the raylet (same
        # process, different thread): while tracing is live, keep a slow
        # heartbeat so a trailing driver-only span (a late task.get, a
        # serve.route) can't strand in the process buffer forever.
        if not self._shutdown and (_tracing.tracing_enabled()
                                   or _tracing.has_pending()):
            self._trace_timer_armed = True
            self.add_timer(config.trace_flush_interval_s,
                           self._trace_flush_tick)

    # ---- continuous profiling (folded stack samples -> GCS table) ----

    def _profile_ingest(self, samples: List[dict], dropped: int = 0):
        """Append a folded-sample batch (worker control frames / the
        local sampler) to the bounded export buffer."""
        buf = self._profile_buf
        cap = config.profile_buffer_size
        self._profile_export_dropped += dropped
        self._profile_dropped_total += dropped
        for rec in samples:
            buf.append(rec)
            if len(buf) > cap:
                buf.popleft()
                self._profile_export_dropped += 1
                self._profile_dropped_total += 1

    def flush_profile_samples(self):
        """Drain this process's sampler window plus everything workers
        have shipped, and post the batch to the GCS profile table."""
        local, dropped = _profiling.drain_samples()
        if local or dropped:
            self._profile_ingest(local, dropped)
        if not self._profile_buf and not self._profile_export_dropped:
            return
        t0 = time.perf_counter()
        samples = list(self._profile_buf)
        self._profile_buf.clear()
        dropped = self._profile_export_dropped
        self._profile_export_dropped = 0
        try:
            if isinstance(self.gcs, GcsClient):
                self.gcs.post("add_profile_samples", self.node_id, samples,
                              dropped, incarnation=self.incarnation)
            else:
                self.gcs.add_profile_samples(self.node_id, samples, dropped,
                                             incarnation=self.incarnation)
        except (ConnectionError, TimeoutError, OSError):
            # GCS unreachable: the batch is gone — count it honestly
            self._profile_dropped_total += len(samples)
            self._profile_export_dropped += dropped + len(samples)
        self._audit_flush("profile", t0, batch=samples)

    def _profile_flush_tick(self):
        # Recurring (unlike the lazily-armed trace timer): samples
        # originate on the sampler thread, which can't arm event-thread
        # timers — with profiling off this is one empty-buffer check per
        # interval.
        if self._shutdown:
            return
        self.flush_profile_samples()
        self.add_timer(config.profile_flush_interval_s,
                       self._profile_flush_tick)

    # ---- metric time-series export (delta points -> GCS table) ----

    def _metric_points_ingest(self, points: List[dict], dropped: int = 0):
        """Append a delta-point batch (worker control frames / the local
        registry ring / the raylet's own internal set) to the bounded
        export buffer."""
        buf = self._metric_point_buf
        cap = config.metrics_history_ring
        self._metric_points_export_dropped += dropped
        self._metric_points_dropped_total += dropped
        for p in points:
            buf.append(p)
            if len(buf) > cap:
                buf.popleft()
                self._metric_points_export_dropped += 1
                self._metric_points_dropped_total += 1

    def flush_metric_points(self):
        """Drain this process's point ring plus everything workers have
        shipped, and post the batch to the GCS metrics table."""
        local, dropped = _metrics_mod.drain_points()
        if local or dropped:
            self._metric_points_ingest(local, dropped)
        if not self._metric_point_buf and \
                not self._metric_points_export_dropped:
            return
        t0 = time.perf_counter()
        points = list(self._metric_point_buf)
        self._metric_point_buf.clear()
        dropped = self._metric_points_export_dropped
        self._metric_points_export_dropped = 0
        try:
            if isinstance(self.gcs, GcsClient):
                self.gcs.post("add_metric_points", self.node_id, points,
                              dropped, incarnation=self.incarnation)
            else:
                self.gcs.add_metric_points(self.node_id, points, dropped,
                                           incarnation=self.incarnation)
        except (ConnectionError, TimeoutError, OSError):
            # GCS unreachable: the batch is gone — count it honestly
            self._metric_points_dropped_total += len(points)
            self._metric_points_export_dropped += dropped + len(points)
        self._audit_flush("metrics", t0, batch=points)

    def _audit_flush(self, subsystem: str, t0: float,
                     batch: Optional[list] = None, nbytes: float = 0.0):
        """Telemetry self-audit: accumulate wall time and approximate
        shipped bytes per export subsystem (task_events / trace / profile
        / metrics), re-exported as ray_tpu_internal_telemetry_flush_*
        counters.  Dict batches are costed as records x one sampled
        record's JSON size — serializing the whole batch just to weigh it
        would double the very cost being measured."""
        import json as _json

        slot = self._m_telemetry.get(subsystem)
        if slot is None:
            slot = self._m_telemetry[subsystem] = [0.0, 0.0]
        slot[0] += time.perf_counter() - t0
        if batch:
            try:
                rec = len(_json.dumps(batch[0], default=str))
            except (TypeError, ValueError):
                rec = 0
            nbytes += rec * len(batch)
        slot[1] += nbytes

    # ---- live introspection (stack dumps / targeted node queries) ----

    def collect_local_stacks(self, done_cb: Callable[[List[dict]], None],
                             pid: Optional[int] = None,
                             timeout_s: float = 1.5):
        """Gather all-thread stacks from this process and every
        registered worker (the ``ray stack`` payload).  Workers answer
        from their socket-reader threads, so a worker stuck in user code
        (or deadlocked) still reports.  ``done_cb(procs)`` fires on the
        event thread — with whatever arrived by ``timeout_s`` if some
        worker never answers."""
        own_label = "raylet" if self.cluster_mode else "driver"
        procs: List[dict] = []
        if pid is None or pid == os.getpid():
            procs.append({"pid": os.getpid(), "proc": own_label,
                          "node_id": self.node_id,
                          "threads": _profiling.dump_threads(
                              proc=own_label)})
        targets = [c for c in self._workers.values()
                   if c.pid is not None
                   and getattr(c, "state", None) != "driver"
                   and (pid is None or c.pid == pid)]
        if not targets:
            done_cb(procs)
            return
        token = f"s{next(self._stack_token_seq)}"
        state = {"want": len(targets), "procs": procs, "cb": done_cb,
                 "done": False}
        self._stack_queries[token] = state
        for c in targets:
            try:
                c.send({"t": "stack", "token": token})
            except OSError:
                state["want"] -= 1
        if state["want"] <= 0:
            self._stack_queries.pop(token, None)
            done_cb(procs)
            return

        def deadline(token=token):
            st = self._stack_queries.pop(token, None)
            if st is not None and not st["done"]:
                st["done"] = True
                st["cb"](st["procs"])

        self.add_timer(max(0.2, timeout_s), deadline)

    def _on_stack_reply(self, conn: _WorkerConn, msg: dict):
        st = self._stack_queries.get(msg.get("token"))
        if st is None or st["done"]:
            return  # deadline already fired (late reply) — drop it
        st["procs"].append({"pid": msg.get("pid") or conn.pid,
                            "proc": "worker", "node_id": self.node_id,
                            "actor_id": (conn.actor_id.hex()
                                         if conn.actor_id else None),
                            "threads": msg.get("threads") or []})
        st["want"] -= 1
        if st["want"] <= 0:
            st["done"] = True
            self._stack_queries.pop(msg.get("token"), None)
            st["cb"](st["procs"])

    def _handle_node_query(self, data: dict):
        """A targeted GCS introspection push (``node_query``): collect the
        answer locally and post it back as a one-way report."""
        kind, token = data.get("kind"), data.get("token")
        payload = data.get("payload") or {}
        if kind == "stacks":
            self.collect_local_stacks(
                lambda procs: self._gcs_post(
                    "node_query_report", token, self.node_id, procs),
                pid=payload.get("pid"))
        elif kind == "logs":
            try:
                value = self._logs_query(payload)
            except (OSError, ValueError) as e:
                value = {"error": repr(e)}
            self._gcs_post("node_query_report", token, self.node_id, value)
        elif kind == "profile_flush":
            self.flush_profile_samples()
            self._gcs_post("node_query_report", token, self.node_id, True)
        # unknown kinds: no report — the requester lists this node missing

    def _spawn_gcs_query(self, deferred_reply: Callable, op: str, **kw):
        """Run a BLOCKING cluster-wide GCS gather (collect_stacks /
        node_query) on a throwaway thread and reply when it returns — the
        event thread must stay free to answer this node's own share of
        the query (the GCS pushes it right back at us)."""
        def run():
            try:
                value = getattr(self.gcs, op)(**kw)
            except Exception as e:  # noqa: BLE001 — reply, don't die
                value = {"reports": {}, "nodes": {}, "missing": [],
                         "error": repr(e)}
            self.call_async(deferred_reply, value)

        threading.Thread(target=run, name=f"gcs-query-{op}",
                         daemon=True).start()

    def _record_event(self, spec: TaskSpec, state: str, **extra):
        attempt = spec.max_retries - spec.retries_left
        ev = {
            "task_id": spec.task_id.hex(),
            "name": spec.name,
            "kind": spec.kind,
            "state": state,
            "time": time.time(),
            "node_id": self.node_id,
            "job_id": spec.job_id,
            "attempt": attempt if attempt > 0 else 0,
            **extra,
        }
        if spec.trace_ctx is not None and _tracing.tracing_enabled():
            if spec.trace_ctx.get("sampled", True):
                # task events <-> traces: a slow row in summarize_tasks /
                # timeline() jumps straight to its waterfall
                ev["trace_id"] = spec.trace_ctx["trace_id"]
                self._trace_transition(spec, state, ev["time"],
                                       error=extra.get("error"))
            elif state in ("FAILED", "SHED", "EXPIRED", "CANCELLED"):
                # head-sampled out, but errored requests always export —
                # a shed/expired request still shows up as an ERROR span
                self._trace_hop(spec, f"raylet.task_{state.lower()}",
                                ev["time"], ev["time"], status="ERROR",
                                error=extra.get("error"))
        self._task_events.append(ev)
        states = self._task_states
        # pop+reinsert: dict order becomes least-recently-UPDATED first, so
        # the overflow eviction below drops stale finished tasks before a
        # long-running task that just reported RUNNING
        states.pop(spec.task_id, None)
        states[spec.task_id] = ev
        if len(states) > self._flag_state_cap.value:
            # bound the per-task state map like the event deque: a driver
            # submitting forever must not grow raylet memory without limit
            states.pop(next(iter(states)))
        if state in ("RUNNING", "DISPATCHED"):
            queued_t = getattr(spec, "_queued_t", None)
            if queued_t is not None and self._im is not None:
                spec._queued_t = None
                self._im["dispatch_latency"].observe(
                    time.monotonic() - queued_t)
        elif state in ("FINISHED", "FAILED", "SHED", "EXPIRED", "CANCELLED"):
            self._m_tasks_done[state] += 1
        # ---- export to the GCS task-event table ----
        if not self._flag_task_events.value:
            return
        buf = self._task_event_buf
        buf.append(ev)
        if len(buf) > self._flag_event_cap.value:
            buf.popleft()
            self._task_event_dropped += 1
            self._task_event_dropped_total += 1
        if not self._task_event_timer_armed:
            self._task_event_timer_armed = True
            self.add_timer(config.task_event_flush_interval_s,
                           self._task_event_flush_tick)

    def flush_task_events(self):
        """Ship the export ring buffer to the GCS task-event table (one
        one-way post; event thread only).  Driver/state-API callers invoke
        this before querying so a just-finished task is visible."""
        if not self._task_event_buf and not self._task_event_dropped:
            return
        t0 = time.perf_counter()
        events = list(self._task_event_buf)
        self._task_event_buf.clear()
        dropped, self._task_event_dropped = self._task_event_dropped, 0
        self._gcs_post("add_task_events", self.node_id, events, dropped,
                       incarnation=self.incarnation)
        self._audit_flush("task_events", t0, batch=events)

    def _task_event_flush_tick(self):
        # One-shot timer, re-armed lazily by the next _record_event: an
        # idle raylet pays nothing for the export pipeline.
        self._task_event_timer_armed = False
        self.flush_task_events()

    # ---- internal runtime metrics (ray_tpu_internal_*) ----

    def _init_internal_metrics(self):
        """Instrument the runtime with the util.metrics primitives under
        the reserved prefix (reference: the ray_* internal gauges exported
        by the per-node metrics agent, `metrics_agent.py:375`).  The raylet
        flushes these itself through the GCS KV metrics namespace — raylet
        processes have no global worker for the per-process flusher."""
        from ray_tpu_torch.util import metrics as _metrics

        tags = {"node": self.node_id[:12]}

        def gauge(name, desc):
            return _metrics.internal_metric(
                _metrics.Gauge, name, desc,
                tag_keys=("node",)).set_default_tags(tags)

        def counter(name, desc, tag_keys=("node",)):
            return _metrics.internal_metric(
                _metrics.Counter, name, desc,
                tag_keys=tag_keys).set_default_tags(tags)

        def hist(name, desc, bounds):
            return _metrics.internal_metric(
                _metrics.Histogram, name, desc, boundaries=bounds,
                tag_keys=("node",)).set_default_tags(tags)

        self._im = {
            "queue_depth": gauge(
                "ray_tpu_internal_scheduler_queue_depth",
                "Tasks in the raylet ready queue"),
            "waiting": gauge(
                "ray_tpu_internal_scheduler_waiting_tasks",
                "Tasks blocked on unresolved arguments"),
            "worker_pool": gauge(
                "ray_tpu_internal_worker_pool_size",
                "Pooled (non-actor) worker processes"),
            "objects": gauge(
                "ray_tpu_internal_objects_tracked",
                "Objects tracked by this raylet"),
            "store_bytes": gauge(
                "ray_tpu_internal_object_store_bytes_used",
                "Bytes sealed in the shm object store"),
            "spilled_bytes": gauge(
                "ray_tpu_internal_object_store_spilled_bytes",
                "Bytes spilled from the store to disk"),
            "tasks_total": counter(
                "ray_tpu_internal_tasks_total",
                "Terminal task states seen by this raylet",
                tag_keys=("node", "state")),
            "events_dropped": counter(
                "ray_tpu_internal_task_events_dropped_total",
                "Task events shed by the export ring buffer"),
            "trace_dropped": counter(
                "ray_tpu_internal_trace_spans_dropped_total",
                "Trace spans shed by the export buffers (process-local "
                "and raylet-side) before reaching the GCS trace table"),
            "profile_dropped": counter(
                "ray_tpu_internal_profile_samples_dropped_total",
                "Folded profile sample records shed by the export "
                "buffers before reaching the GCS profile table"),
            "metric_points_dropped": counter(
                "ray_tpu_internal_metric_points_dropped_total",
                "Metric time-series delta points shed by the export "
                "rings before reaching the GCS metrics table"),
            "telemetry_flush_s": counter(
                "ray_tpu_internal_telemetry_flush_seconds_total",
                "Telemetry self-audit: wall seconds spent in export "
                "flush paths, by subsystem",
                tag_keys=("node", "subsystem")),
            "telemetry_flush_bytes": counter(
                "ray_tpu_internal_telemetry_flush_bytes_total",
                "Telemetry self-audit: approximate bytes shipped by "
                "export flush paths, by subsystem",
                tag_keys=("node", "subsystem")),
            "frames": counter(
                "ray_tpu_internal_proto_frames_total",
                "Control-plane frames handled"),
            "trains": counter(
                "ray_tpu_internal_proto_trains_total",
                "Socket drains (coalesced frame trains)"),
            "dispatch_latency": hist(
                "ray_tpu_internal_dispatch_latency_s",
                "Queue-ready to dispatch latency",
                (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)),
            "train_bytes": hist(
                "ray_tpu_internal_proto_train_bytes",
                "Bytes received per socket drain",
                (256, 4096, 65536, 1 << 20)),
            "gcs_rpc_latency": hist(
                "ray_tpu_internal_gcs_rpc_latency_s",
                "Blocking GCS client RPC round-trip latency",
                (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 1.0)),
            # ---- data plane (pull manager / data channel) ----
            "pull_inflight_bytes": gauge(
                "ray_tpu_internal_pull_inflight_bytes",
                "Bytes of admitted in-flight data-plane pulls"),
            "pull_queued": gauge(
                "ray_tpu_internal_pull_queued",
                "Pulls waiting in the admission queue"),
            "pull_active": gauge(
                "ray_tpu_internal_pull_active",
                "Admitted data-plane pulls in progress"),
            "pull_bytes": counter(
                "ray_tpu_internal_pull_bytes_total",
                "Object bytes received over the data plane"),
            "pull_chunks": counter(
                "ray_tpu_internal_pull_chunks_total",
                "Chunk ranges received over the data plane"),
            "pull_source_switches": counter(
                "ray_tpu_internal_pull_source_switches_total",
                "Pull ranges rotated to another holder (stall/failure)"),
            "pull_multi_source": counter(
                "ray_tpu_internal_pull_multi_source_total",
                "Completed pulls that striped across >= 2 holders"),
            "pull_sender_saturated": counter(
                "ray_tpu_internal_pull_sender_saturated_total",
                "Fallback pull-serve submissions that queued behind a "
                "fully busy sender pool"),
            "locality_spills": counter(
                "ray_tpu_internal_locality_spills_total",
                "Tasks forwarded to the node holding their argument bytes"),
            # ---- lineage reconstruction (node death / eviction recovery) --
            "recon_attempts": counter(
                "ray_tpu_internal_reconstruction_attempts_total",
                "Creating-task re-runs started to recover lost objects"),
            "recon_successes": counter(
                "ray_tpu_internal_reconstruction_successes_total",
                "Reconstruction attempts whose returns re-sealed"),
            "recon_failures": counter(
                "ray_tpu_internal_reconstruction_failures_total",
                "Reconstruction attempts whose returns errored"),
            "recon_depth": hist(
                "ray_tpu_internal_reconstruction_depth",
                "Recursion depth at which reconstructions were started "
                "(dependency chains re-run below the lost object)",
                (1, 2, 4, 8)),
            # ---- eager availability (replication + actor checkpoints) ----
            "repl_pushes": counter(
                "ray_tpu_internal_replication_pushes_total",
                "Secondary-copy pushes initiated for sealed objects"),
            "repl_bytes": counter(
                "ray_tpu_internal_replication_bytes_total",
                "Object bytes covered by replication pushes"),
            "repl_repairs": counter(
                "ray_tpu_internal_replication_repairs_total",
                "Re-replications after a holder died (copy count "
                "restored)"),
            "repl_recoveries": counter(
                "ray_tpu_internal_replication_recoveries_total",
                "Node-death object losses recovered from a surviving "
                "copy instead of lineage recompute"),
            "ckpt_saves": counter(
                "ray_tpu_internal_checkpoint_saves_total",
                "Actor state checkpoints recorded"),
            "ckpt_bytes": counter(
                "ray_tpu_internal_checkpoint_bytes_total",
                "Serialized actor checkpoint bytes recorded"),
            "ckpt_restores": counter(
                "ray_tpu_internal_checkpoint_restores_total",
                "Actor restarts that restored from a checkpoint instead "
                "of starting cold"),
            # ---- overload protection & deadlines ----
            "shed": counter(
                "ray_tpu_internal_shed_total",
                "Requests rejected by overload protection (bounded-queue "
                "admission, lowest-deadline-headroom victim policy)"),
            "deadline_exceeded": counter(
                "ray_tpu_internal_deadline_exceeded_total",
                "Tasks whose end-to-end deadline expired (admission, "
                "queue, or pre-dispatch enforcement on this node)"),
            "cancelled": counter(
                "ray_tpu_internal_cancelled_total",
                "Tasks cancelled (explicit cancel + recursive fan-out)"),
            # ---- failure detection / fencing ----
            "fenced_frames": counter(
                "ray_tpu_internal_fenced_frames_total",
                "Stale node-attributed frames rejected by incarnation "
                "fencing (peer hellos / data-channel handshakes from a "
                "declared-dead incarnation)"),
        }
        self._im_producer = f"raylet-{os.getpid()}-{self.node_id[:8]}"
        # time-series baselines for collect_points (metrics tick only)
        self._im_points_last: Dict = {}
        if isinstance(self.gcs, GcsClient):
            self.gcs.rpc_observer = self._observe_gcs_rpc

    def _observe_gcs_rpc(self, op: str, seconds: float):
        # Called from whichever thread issued the RPC; observe() locks.
        if self._im is not None:
            self._im["gcs_rpc_latency"].observe(seconds)

    def _spilled_bytes(self) -> int:
        store = self._store  # unguarded-ok: atomic reference read (metrics sampling)
        spill_dir = getattr(store, "_spill_dir", None)
        if not spill_dir or not os.path.isdir(spill_dir):
            return 0
        total = 0
        try:
            with os.scandir(spill_dir) as it:
                for entry in it:
                    try:
                        total += entry.stat().st_size
                    except OSError:
                        pass
        except OSError:
            return 0
        return total

    def _flush_internal_metrics(self):
        """Sample event-thread state into the internal metric set and push
        the payloads under this raylet's own producer key (merged with user
        metrics by the dashboard's /metrics renderer)."""
        # Re-arm FIRST (the callback runs under _safe): an exception mid-
        # flush — e.g. a transient store-attach failure — must not silently
        # kill the export for the life of the raylet.
        if not self._shutdown:
            self.add_timer(config.internal_metrics_interval_s,
                           self._flush_internal_metrics)
        im = self._im
        im["queue_depth"].set(len(self._ready_queue))
        im["waiting"].set(len(self._waiting))
        im["worker_pool"].set(sum(
            1 for c in self._workers.values()
            if c.actor_id is None and c.state in ("idle", "busy")))
        im["objects"].set(len(self._objects))
        store = self._raylet_store()
        if store is not None and hasattr(store, "stats"):
            try:
                im["store_bytes"].set(store.stats()["bytes_in_use"])
            except Exception:  # noqa: BLE001
                pass
            im["spilled_bytes"].set(self._spilled_bytes())

        def bump(counter, key, value, tags=None):
            delta = value - self._m_last.get(key, 0)
            if delta > 0:
                counter.inc(delta, tags=tags)
            self._m_last[key] = value

        bump(im["frames"], "frames", self._m_frames)
        bump(im["trains"], "trains", self._m_trains)
        bump(im["events_dropped"], "dropped", self._task_event_dropped_total)
        bump(im["trace_dropped"], "trace_dropped", self._trace_dropped_total)
        bump(im["profile_dropped"], "profile_dropped",
             self._profile_dropped_total)
        for st, n in self._m_tasks_done.items():
            bump(im["tasks_total"], f"tasks_{st}", n, tags={"state": st})
        bump(im["pull_sender_saturated"], "pull_sat",
             self._m_pull_sender_saturated)
        bump(im["locality_spills"], "loc_spills", self._m_locality_spills)
        bump(im["recon_attempts"], "recon_att", self._m_recon_attempts)
        bump(im["recon_successes"], "recon_ok", self._m_recon_successes)
        bump(im["recon_failures"], "recon_fail", self._m_recon_failures)
        bump(im["repl_pushes"], "repl_push", self._m_repl_pushes)
        bump(im["repl_bytes"], "repl_bytes", self._m_repl_bytes)
        bump(im["repl_repairs"], "repl_repair", self._m_repl_repairs)
        bump(im["repl_recoveries"], "repl_recover", self._m_repl_recoveries)
        bump(im["ckpt_saves"], "ckpt_saves", self._m_ckpt_saves)
        bump(im["ckpt_bytes"], "ckpt_bytes", self._m_ckpt_bytes)
        bump(im["ckpt_restores"], "ckpt_restores", self._m_ckpt_restores)
        bump(im["fenced_frames"], "fenced_frames", self._m_fenced_frames)
        bump(im["shed"], "shed", self._m_shed)
        bump(im["deadline_exceeded"], "deadline_exceeded",
             self._m_deadline_exceeded)
        bump(im["cancelled"], "cancelled", self._m_cancelled)
        bump(im["metric_points_dropped"], "mpoints_dropped",
             self._metric_points_dropped_total)
        for sub, slot in self._m_telemetry.items():
            bump(im["telemetry_flush_s"], f"tel_s_{sub}", slot[0],
                 tags={"subsystem": sub})
            bump(im["telemetry_flush_bytes"], f"tel_b_{sub}", slot[1],
                 tags={"subsystem": sub})
        if self._pull_manager is not None:
            ps = self._pull_manager.stats()
            im["pull_inflight_bytes"].set(ps["inflight_bytes"])
            im["pull_queued"].set(ps["queued"])
            im["pull_active"].set(ps["active"])
            bump(im["pull_bytes"], "pull_bytes", ps["bytes_total"])
            bump(im["pull_chunks"], "pull_chunks", ps["chunks_total"])
            bump(im["pull_source_switches"], "pull_switch",
                 ps["source_switches"])
            bump(im["pull_multi_source"], "pull_multi",
                 ps["multi_source_pulls"])

        import json as _json

        t0 = time.perf_counter()
        items = []
        for m in im.values():
            payload = m._export()
            if payload is None:
                continue
            items.append((f"{self._im_producer}/{m.name}".encode(),
                          _json.dumps(payload).encode()))
        if items:
            # one post for the whole metric set (~30 keys), not one per key
            self._gcs_post("kv_multi_put", "metrics", items)
        self._audit_flush("metrics", t0,
                          nbytes=sum(len(k) + len(v) for k, v in items))
        if config.metrics_history:
            # the same cadence ships DELTA points into the GCS metrics
            # time-series table: this raylet's internal set, the local
            # registry ring (driver-process user/serve metrics), and
            # whatever workers shipped since the last tick
            points = _metrics_mod.collect_points(im.values(),
                                                 self._im_points_last)
            if points:
                self._metric_points_ingest(points)
            self.flush_metric_points()

    def state_snapshot(self, objects_limit: int = 0) -> dict:
        return {
            "node_id": self.node_id,
            "resources_total": dict(self.resources_total),
            "resources_available": dict(self.resources_available),
            "num_workers": len(self._workers),
            "tasks": list(self._task_states.values()),
            "actors": [
                {
                    "actor_id": a.actor_id.hex(),
                    "state": a.state,
                    "name": a.name,
                    "pid": a.conn.pid if a.conn else None,
                }
                for a in self._actors.values()
            ],
            "objects": {
                "num": len(self._objects),
                # detail rows only on request (``objects_limit`` > 0): the
                # limit applies HERE, at the source, before materializing —
                # and reading on the event thread makes the iteration safe.
                "items": [
                    {
                        "object_id": oid.hex(),
                        "status": st.status,
                        "size": st.size,
                        "locations": list(st.locations),
                    }
                    for oid, st in itertools.islice(
                        self._objects.items(), max(0, objects_limit))
                ] if objects_limit > 0 else None,
            },
            "placement_groups": [
                {"id": pg.pg_id, "state": pg.state,
                 "bundles": list(pg.bundles.values()),
                 "fragment": pg.fragment}
                for pg in self._pgs.values()
            ],
            "events": list(self._task_events),
        }

    # --------------------------------------------------------------- shutdown

    def shutdown(self):
        try:
            self.gcs.unregister_node(self.node_id)
        except Exception:  # noqa: BLE001
            pass
        self._shutdown = True
        try:
            self._wake_w.send(b"\x00")
        except OSError:
            pass
        self._thread.join(timeout=5)
        if isinstance(self.gcs, GcsClient):
            self.gcs.close()
        for p in self._procs:
            try:
                p.terminate()
                p.wait(timeout=2)
            except (OSError, subprocess.TimeoutExpired):
                try:
                    p.kill()
                except OSError:
                    pass
