"""GCS — the cluster control plane (head service).

Reference analogue: the GCS server (`src/ray/gcs/gcs_server/gcs_server.h:78`)
with its node / actor / KV / function / object-directory tables
(`gcs_node_manager`, `gcs_actor_manager.cc`, `gcs_kv_manager`), the GCS
client accessors (`src/ray/gcs/gcs_client/accessor.h:40`), and the
health-check manager (`gcs_health_check_manager.h`).

Re-designed for this runtime: one ``GcsCore`` object owns every table behind
a single lock (the tables are dict operations — there is nothing to gain
from an event loop), with three access paths:

  * embedded  — the single-node default: the driver's in-process raylet holds
    a direct reference to ``GcsCore`` (zero-cost control plane);
  * ``GcsServer`` — a TCP server exposing the same surface over the framed
    pickle protocol (`ray_tpu_torch/core/protocol.py`), one thread per connection
    (node counts are small; the data plane never flows through the GCS);
  * ``GcsClient`` — socket client with an identical duck-typed method
    surface, so the raylet code does not know which one it holds.

Pushes (reference: `src/ray/pubsub/`): subscribers receive node membership
events and object-directory watch notifications. The object directory is
location metadata only — object bytes move raylet-to-raylet (see
`raylet.py` pull protocol), matching the reference's split between the GCS
and the object manager (`src/ray/object_manager/object_manager.h:117`).
"""

from __future__ import annotations

import os
import random
import socket
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core import protocol
from ray_tpu_torch.core.config import config
from ray_tpu_torch.util import profiling
from ray_tpu_torch.util.locks import make_lock, make_rlock

config.define("gcs_heartbeat_interval_s", float, 0.25,
              "Raylet -> GCS resource heartbeat period.")
config.define("gcs_restart_reconcile_s", float, 5.0,
              "After a GCS restart, how long raylets get to reconnect "
              "before actors/PG bundles referencing never-returning nodes "
              "are reconciled (actors -> dead, bundles -> re-placed).")
config.define("gcs_node_timeout_s", float, 3.0,
              "Heartbeat silence after which a node is declared dead "
              "with no probe verdict — the HARD fallback behind the "
              "suspicion machine (reference: health check manager "
              "timeouts).")
config.define("gcs_node_suspect_s", float, 0.5,
              "Heartbeat silence after which a node is marked SUSPECT "
              "and actively probed (direct TCP ping plus one indirect "
              "probe via a peer raylet).  Probe failure confirms DEAD "
              "well before gcs_node_timeout_s; probe success resets the "
              "suspicion.  SUSPECT is propagated on the node-change "
              "pubsub so schedulers/pulls route around the node without "
              "triggering recovery (reference: the health-check "
              "manager's ping layer over heartbeats).")
config.define("gcs_probe_timeout_s", float, 0.4,
              "Connect/read timeout for one liveness probe attempt "
              "(direct or relayed through a peer raylet).")
config.define("gcs_probe_enabled", bool, True,
              "Active probing of SUSPECT nodes.  Off: detection falls "
              "back to the plain gcs_node_timeout_s heartbeat silence.")
config.define("drain_timeout_s", float, 30.0,
              "Default graceful-drain deadline: how long a draining "
              "raylet gets to migrate sole-copy objects out, "
              "checkpoint-and-relocate checkpointable actors, and wait "
              "for running tasks before it reports drain_complete "
              "regardless (reference: the autoscaler's DrainNode "
              "deadline).")


class GcsCore:
    """All control-plane tables. Thread-safe; no I/O of its own beyond the
    optional persistence snapshots.

    Persistence (reference: the GCS store clients —
    `src/ray/gcs/store_client/redis_store_client.h:33` for fault
    tolerance, `in_memory_store_client.h:31` otherwise): with
    ``persist_path`` set, the DURABLE tables (kv, functions, actors,
    named actors, placement groups) snapshot to disk on mutation
    (dirty-flag + background flusher, atomic rename) and reload on
    construction.  Node membership and the object directory are SOFT
    state: raylets re-register and re-publish object locations when they
    reconnect after a GCS restart (the reference's raylet↔GCS reconnect
    protocol, `test_gcs_fault_tolerance.py`)."""

    def __init__(self, persist_path: Optional[str] = None):
        self._lock = make_rlock("gcs.core")
        self._persist_path = persist_path
        self._dirty = False  # guard: _lock
        self._flush_lock = make_lock("gcs.snapshot")
        # node_id(hex) -> {address:(host,port)|None, resources_total,
        #                  resources_available, store_path, alive,
        #                  last_heartbeat, hostname}
        self._nodes: Dict[str, dict] = {}  # guard: _lock
        self._kv: Dict[Tuple[str, bytes], bytes] = {}  # guard: _lock
        self._functions: Dict[bytes, bytes] = {}  # guard: _lock
        # actor_id(bytes) -> {owner_node, state, name, namespace, spec_blob}
        self._actors: Dict[bytes, dict] = {}  # guard: _lock
        self._named: Dict[Tuple[str, str], bytes] = {}  # guard: _lock
        # cluster placement groups: pg_id -> {bundles, strategy,
        #   assignments: {bundle_idx: node_id}, origin, pending, state}
        self._cluster_pgs: Dict[str, dict] = {}  # guard: _lock
        # Task-event table (reference: the GCS task-event backend behind
        # `list_tasks`/`ray.timeline`, `python/ray/util/state/api.py:1009`):
        # job_id -> {"events": deque (raw log, timeline), "tasks": dict
        # task_id(hex) -> latest event (state API)}.  Bounded per job
        # (config.task_events_max_per_job), soft state — never persisted.
        self._task_events: Dict[str, dict] = {}  # guard: _lock
        self._task_events_dropped = 0  # guard: _lock
        # Trace-span table (request-flow tracing): job_id -> deque of span
        # records, bounded per job like the task-event table; producer-side
        # drops (raylet export buffers) and GCS-side evictions both count.
        # Soft state — never persisted.
        self._trace_spans: Dict[str, deque] = {}  # guard: _lock
        self._trace_dropped = 0  # guard: _lock
        # Profile table (continuous profiling): node_id -> deque of folded
        # stack-sample records, bounded per node (config.profile_table_max);
        # producer-side drops and GCS-side evictions both count.  Soft
        # state — never persisted.
        self._profile_samples: Dict[str, deque] = {}  # guard: _lock
        self._profile_dropped = 0  # guard: _lock
        # Metrics time-series table: node_id -> deque of timestamped DELTA
        # points (see metrics.collect_points), bounded per node
        # (config.metrics_table_max); producer-side ring drops and GCS-side
        # evictions both count.  Soft state — never persisted.
        self._metric_points: Dict[str, deque] = {}  # guard: _lock
        self._metric_points_dropped = 0  # guard: _lock
        # Alert table: transition log (firing/resolved records) bounded by
        # config.alerts_table_max, plus the live currently-firing view.
        # Only the health-monitor thread evaluates rules; readers snapshot
        # under _lock.
        self._alerts_log: deque = deque()  # guard: _lock
        self._alerts_active: Dict[str, dict] = {}  # guard: _lock
        self._alerts_dropped = 0  # guard: _lock
        # token -> {"event": Event, "reports": {node_id: payload}, "want"}
        # for targeted node queries (live stack dumps, log listings)
        # relayed through the node pubsub; replies land via the
        # node_query_report op — same shape as the indirect-probe waiters.
        self._query_waiters: Dict[str, dict] = {}  # guard: _lock
        self._query_seq = 0  # guard: _lock
        # oid(hex) -> {nodes: set[node_id], size, inline}
        self._objects: Dict[str, dict] = {}  # guard: _lock
        # oid(hex) -> set of watcher node_ids (want a push when located)
        self._object_watchers: Dict[str, set] = {}  # guard: _lock
        # subscribers: (node_id_or_None, callback(event, data))
        self._subs: List[Tuple[Optional[str], Callable[[str, Any], None]]] = []  # guard: _lock
        self._monitor: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._restored = False  # snapshot loaded => this is a restart
        self._kv_soft_ts: Dict[Tuple[str, bytes], float] = {}  # guard: _lock
        # ---- failure detection / fencing state ----
        # node_id -> highest incarnation ever assigned.  PERSISTED (tiny,
        # monotonic counters): a GCS restart must not hand a resurrected
        # partitioned node its old incarnation back — fencing depends on
        # stale incarnations staying stale.  Node MEMBERSHIP stays soft.
        self._incarnations: Dict[str, int] = {}  # guard: _lock
        # node_id -> highest incarnation ever DECLARED DEAD.  Also
        # persisted: node membership is soft, so after a GCS restart a
        # healed zombie's heartbeat would otherwise look like a plain
        # "unknown node, please re-register" — it must instead learn it
        # was fenced, kill its stale workers, and only then come back.
        self._fenced_incs: Dict[str, int] = {}  # guard: _lock
        self._probing: set = set()  # nodes with an in-flight probe  # guard: _lock
        # token -> {"event": Event, "ok": bool} for indirect (peer-relayed)
        # probes; replies land via the probe_report op.
        self._probe_waiters: Dict[str, dict] = {}  # guard: _lock
        # drain lifecycle: node_id -> {state: draining|drained, started, stats}
        self._drains: Dict[str, dict] = {}  # guard: _lock
        # detection/fencing counters (surfaced by health_stats + metrics)
        self._m_suspects = 0        # guard: _lock — SUSPECT transitions
        self._m_false_suspects = 0  # guard: _lock — suspects that recovered
        self._m_fenced = 0          # guard: _lock — rejected stale frames
        self._m_deaths = 0          # guard: _lock — detected (non-drain) deaths
        self._m_probe_deaths = 0    # guard: _lock — deaths confirmed by probe
        self._m_ttd: deque = deque(maxlen=256)  # guard: _lock — detect latencies
        self._gm: Optional[dict] = None  # internal metric instruments
        if persist_path:
            self._load_snapshot()
            self._start_flusher()

    # ------------------------------------------------------- persistence

    def _mark_dirty(self):  # requires: _lock
        if self._persist_path:
            self._dirty = True

    def _load_snapshot(self):
        import pickle

        try:
            with open(self._persist_path, "rb") as f:
                snap = pickle.load(f)
        except (OSError, EOFError, pickle.UnpicklingError):
            return
        with self._lock:
            self._kv = snap.get("kv", {})
            self._functions = snap.get("functions", {})
            self._actors = snap.get("actors", {})
            self._named = snap.get("named", {})
            self._cluster_pgs = snap.get("cluster_pgs", {})
            self._incarnations = snap.get("incarnations", {})
            self._fenced_incs = snap.get("fenced_incarnations", {})
            # Actors whose host nodes are gone (nodes are soft state) are
            # surfaced as restarting; their home raylet reconciles on
            # reconnect.  start_restart_reconciler() handles the raylets
            # that never come back.
            for info in self._actors.values():
                if info.get("state") == "alive":
                    info["state"] = "restarting"
            # Incarnations count too: a cluster of pure task nodes has no
            # durable actors/kv, but its raylets still need ghost-death
            # declarations if they vanish during the outage.
            self._restored = bool(self._actors or self._kv
                                  or self._cluster_pgs
                                  or self._incarnations)

    def _write_snapshot(self):
        import pickle

        # One writer at a time: the periodic flusher and stop()'s final
        # flush share a tmp path; unserialized concurrent writes could
        # install interleaved garbage via os.replace.
        with self._flush_lock:
            # Shallow-copy the tables under the GCS lock (values are
            # bytes/small dicts), then pickle + write OUTSIDE it so a
            # multi-MB serialization never stalls heartbeats/scheduling.
            # _dirty clears AT COPY TIME: mutations racing the write
            # re-mark it and the next flush catches them; a FAILED write
            # re-sets it so acknowledged state is never silently dropped.
            with self._lock:
                tables = {
                    "kv": {k: v for k, v in self._kv.items()
                           if k[0] not in self._SOFT_KV_NS},
                    "functions": dict(self._functions),
                    "actors": {k: dict(v) for k, v in self._actors.items()},
                    "named": dict(self._named),
                    # copy the NESTED mutables too (assignments/bundles are
                    # mutated in place by PG repair): pickling outside the
                    # lock must never iterate a dict another thread edits
                    "cluster_pgs": {
                        k: {**v,
                            "bundles": [dict(b) for b in v["bundles"]],
                            "assignments": dict(v["assignments"]),
                            "pending": set(v["pending"])}
                        for k, v in self._cluster_pgs.items()},
                    "incarnations": dict(self._incarnations),
                    "fenced_incarnations": dict(self._fenced_incs),
                }
                self._dirty = False
            try:
                snap = pickle.dumps(tables, protocol=5)
                tmp = self._persist_path + f".tmp{os.getpid()}"
                with open(tmp, "wb") as f:
                    f.write(snap)
                os.replace(tmp, self._persist_path)
            except BaseException:
                with self._lock:
                    self._dirty = True
                raise

    def _start_flusher(self):
        def loop():
            while not self._stop.wait(0.1):
                if self._dirty:  # unguarded-ok: racy flag read; rechecked under _flush_lock/_lock in _write_snapshot
                    try:
                        self._write_snapshot()
                    except Exception:  # noqa: BLE001 — flusher must live
                        traceback.print_exc()
            # unguarded-ok: shutdown-path flag read; a lost race means one
            # extra (idempotent) snapshot or a flush the NEXT start replays
            if self._dirty:  # final flush on shutdown
                try:
                    self._write_snapshot()
                except Exception:  # noqa: BLE001
                    traceback.print_exc()

        threading.Thread(target=loop, name="gcs-persist",
                         daemon=True).start()

    # ----------------------------------------------------------- pubsub

    def subscribe(self, callback: Callable[[str, Any], None],
                  node_id: Optional[str] = None):
        with self._lock:
            self._subs.append((node_id, callback))

    def unsubscribe(self, callback):
        with self._lock:
            self._subs = [(n, cb) for n, cb in self._subs if cb is not callback]

    def _publish(self, event: str, data: Any,
                 target_node: Optional[str] = None):
        with self._lock:
            subs = list(self._subs)
        for node_id, cb in subs:
            if target_node is not None and node_id != target_node:
                continue
            try:
                cb(event, data)
            except Exception:  # noqa: BLE001
                traceback.print_exc()

    # ----------------------------------------------------------- nodes

    def register_node(self, node_id: str, address: Optional[tuple],
                      resources: Dict[str, float],
                      store_path: Optional[str] = None,
                      hostname: str = "",
                      labels: Optional[Dict[str, str]] = None,
                      data_port: Optional[int] = None,
                      incarnation: Optional[int] = None) -> List[dict]:
        """``labels`` carry scheduler-visible topology metadata (SURVEY §7
        items 3-4): ``accelerator_type`` (e.g. "v5e-8"), ``tpu_slice``
        (the pod-slice id — nodes sharing it are ICI-adjacent),
        ``tpu_topology`` ("2x4"), ``tpu_worker_id`` (coords within the
        slice).  STRICT_PACK placement uses ``tpu_slice`` to pack bundles
        across hosts of ONE slice when a single node can't hold them.

        ``incarnation``: the generation the raylet LAST HELD (0 for a
        fresh node).  The assigned value is ALWAYS strictly greater than
        both it and any value this GCS previously assigned for the
        node_id, so frames stamped with an older incarnation are
        rejectable after a death declaration — the fencing that makes a
        healed partition unable to double-execute (reference: raylet
        restarts bump the node's instance id).  The caller proposal
        matters when the GCS itself lost its counters (restart without
        persistence): without it the node would be re-assigned a number
        its peers have already fenced and be rejected by them forever.
        The caller reads its assigned incarnation back out of the
        returned snapshot."""
        with self._lock:
            inc = max(self._incarnations.get(node_id, 0),
                      int(incarnation or 0)) + 1
            self._incarnations[node_id] = inc
            if self._persist_path:
                self._mark_dirty()
            self._nodes[node_id] = {
                "node_id": node_id,
                "address": address,
                # data-plane listener (zero-copy object transfer); None for
                # nodes running without a data channel
                "data_port": data_port,
                "resources_total": dict(resources),
                "resources_available": dict(resources),
                "store_path": store_path,
                "hostname": hostname,
                "labels": dict(labels or {}),
                "alive": True,
                "suspect": False,
                "incarnation": inc,
                "last_heartbeat": time.monotonic(),
                # wall-clock registration stamp: lets chaos/soak tooling
                # verify that a mass reconnect after a GCS restart
                # re-registered STAGGERED (thundering-herd regression)
                "registered_at": time.time(),
            }
            snapshot = [dict(n) for n in self._nodes.values()]
        # Persist the incarnation bump SYNCHRONOUSLY (registrations are
        # rare): if the GCS dies before the async flusher runs, a restart
        # would re-assign the fenced number and peers would reject the
        # legitimately re-registered node forever.  A failed write re-marks
        # dirty; registration still proceeds (soft membership).
        if self._persist_path:
            try:
                self._write_snapshot()
            except Exception:  # noqa: BLE001
                traceback.print_exc()
        self._publish("node_added", {"node_id": node_id, "address": address,
                                     "incarnation": inc,
                                     "data_port": data_port})
        return snapshot

    def unregister_node(self, node_id: str):
        # announced departure, not a detected failure: keep it out of the
        # time-to-detect distribution
        self._mark_dead(node_id, "node drained", detected=False)

    def drain_node(self, node_id: str,
                   timeout_s: Optional[float] = None) -> bool:
        """Begin a GRACEFUL drain: placement skips the node immediately
        (draining flag) and the node's raylet is asked — via a targeted
        ``node_drain`` push — to migrate sole-copy store objects out,
        checkpoint-and-relocate checkpointable actors, and wait for
        running tasks up to ``timeout_s``, then report ``drain_complete``
        (reference: the autoscaler's DrainNode RPC before instance
        termination).  A drained node dies with ZERO reconstructions.
        Returns False for an unknown/dead node."""
        with self._lock:
            info = self._nodes.get(node_id)
            if info is None or not info["alive"]:
                return False
            info["draining"] = True
            self._drains[node_id] = {"state": "draining",
                                     "started": time.monotonic()}
        # BROADCAST, not targeted: the draining raylet starts its drain,
        # and every OTHER raylet marks the node draining so replication
        # pushes and locality forwarding stop landing fresh bytes/tasks on
        # a node that is about to retire (their candidate filters check
        # the flag; without the broadcast they would never learn it).
        self._publish("node_drain",
                      {"node_id": node_id,
                       "timeout_s": timeout_s or config.drain_timeout_s})
        return True

    def drain_complete(self, node_id: str, stats: Optional[dict] = None):
        """The draining raylet quiesced (or hit its deadline): record the
        outcome and retire the node through the normal death path — by
        now every sole-copy object has a surviving holder, so the death
        event triggers zero reconstructions."""
        with self._lock:
            entry = self._drains.setdefault(
                node_id, {"state": "draining", "started": time.monotonic()})
            entry["state"] = "drained"
            entry["elapsed_s"] = time.monotonic() - entry["started"]
            entry["stats"] = dict(stats or {})
        self._mark_dead(node_id, "node drained", detected=False)

    def drain_status(self, node_id: str) -> dict:
        with self._lock:
            entry = self._drains.get(node_id)
            if entry is None:
                return {"state": "unknown"}
            out = dict(entry)
            out.pop("started", None)
            return out

    def _fence_ok(self, node_id: str, incarnation: Optional[int]) -> bool:  # requires: _lock
        """Accept/reject a node-attributed mutating frame.  ``None`` means
        an unstamped caller (tests, pre-fencing components): accepted as
        before.  A stamped frame is rejected when the node is not alive or
        the stamp is older than the node's current incarnation — the
        split-brain guard: a node declared dead that keeps sending
        (partition healed, process resumed) cannot resurrect directory
        entries or re-assert actors until it re-registers fresh."""
        if incarnation is None:
            return True
        info = self._nodes.get(node_id)
        if (info is not None and info["alive"]
                and int(incarnation) >= info["incarnation"]):
            return True
        self._m_fenced += 1
        return False

    def heartbeat(self, node_id: str, resources_available: Dict[str, float],
                  queue_len: int = 0, pending_shapes=None,
                  incarnation: Optional[int] = None):
        """``pending_shapes`` is the node's unfulfilled resource demand:
        ``[(shape_dict, count), ...]`` for queued tasks that cannot run with
        current availability — the load signal the autoscaler bin-packs
        (reference: raylet resource reports aggregated by
        ``monitor.py:249`` ``update_load_metrics``).

        Returns True (accepted), False (unknown node — re-register), or
        the string ``"fenced"`` (this node_id+incarnation was declared
        dead: the raylet must kill its workers and re-register under a
        fresh incarnation before any of its frames are accepted again)."""
        recovered = None
        with self._lock:
            info = self._nodes.get(node_id)
            if incarnation is not None and \
                    int(incarnation) <= self._fenced_incs.get(node_id, -1):
                # declared dead under this (or an older) incarnation —
                # membership may be gone (GCS restart; nodes are soft
                # state) but the persisted fence record is not: the
                # zombie must kill its workers before re-registering
                self._m_fenced += 1
                return "fenced"
            if info is None:
                return False
            if incarnation is not None and (
                    not info["alive"]
                    or int(incarnation) < info["incarnation"]):
                self._m_fenced += 1
                return "fenced"
            if not info["alive"]:
                return False  # unstamped legacy caller: plain re-register
            info["resources_available"] = dict(resources_available)
            info["queue_len"] = queue_len
            info["pending_shapes"] = list(pending_shapes or ())
            now = time.monotonic()
            info["last_heartbeat"] = now
            if info.get("suspect"):
                # the node was only slow (GC pause, load): clear the
                # suspicion without any recovery action
                info["suspect"] = False
                self._m_false_suspects += 1
                recovered = info["incarnation"]
            busy = (queue_len > 0 or pending_shapes
                    or any(resources_available.get(k, 0.0) + 1e-9 < v
                           for k, v in info["resources_total"].items()))
            if busy:
                info.pop("idle_since", None)
            elif "idle_since" not in info:
                info["idle_since"] = now
        if recovered is not None:
            self._publish("node_suspect",
                          {"node_id": node_id, "suspect": False,
                           "incarnation": recovered})
        return True

    def load_metrics(self) -> List[dict]:
        """Autoscaler view: per-node capacity, availability, queue depth,
        unfulfilled demand shapes, and idle duration."""
        now = time.monotonic()
        with self._lock:
            out = []
            for info in self._nodes.values():
                out.append({
                    "node_id": info["node_id"],
                    "alive": info["alive"],
                    "suspect": bool(info.get("suspect")),
                    "draining": bool(info.get("draining")),
                    "hostname": info.get("hostname", ""),
                    "resources_total": dict(info["resources_total"]),
                    "resources_available": dict(
                        info.get("resources_available", {})),
                    "queue_len": info.get("queue_len", 0),
                    "pending_shapes": list(info.get("pending_shapes", ())),
                    "idle_s": (now - info["idle_since"]
                               if info.get("idle_since") is not None
                               and info["alive"] else 0.0),
                })
            return out

    def nodes(self) -> List[dict]:
        with self._lock:
            return [dict(n) for n in self._nodes.values()]

    def get_node(self, node_id: str) -> Optional[dict]:
        with self._lock:
            info = self._nodes.get(node_id)
            return dict(info) if info else None

    def _mark_dead(self, node_id: str, reason: str, detected: bool = True):
        """``detected``: this death was INFERRED (missed heartbeats /
        failed probe) rather than announced (drain, graceful shutdown) —
        only inferred deaths feed the time-to-detect distribution."""
        with self._lock:
            info = self._nodes.get(node_id)
            if info is None or not info["alive"]:
                return
            info["alive"] = False
            info["suspect"] = False
            info["death_reason"] = reason
            incarnation = info["incarnation"]
            self._fenced_incs[node_id] = max(
                self._fenced_incs.get(node_id, 0), incarnation)
            self._mark_dirty()  # the fence must survive a GCS restart
            if detected:
                self._m_deaths += 1
                self._m_ttd.append(
                    time.monotonic() - info["last_heartbeat"])
                if self._gm is not None:
                    self._gm["ttd"].observe(self._m_ttd[-1])
            # prune the directory: bytes on a dead node are gone.  Entries
            # with no holder left are DELETED, not kept with stale
            # metadata — their max()-accumulated size must not outlive the
            # last copy (a reconstruction may re-seal the object smaller,
            # and a stale larger size would drive out-of-range pull reads
            # that scrub valid holders).
            for oid, entry in list(self._objects.items()):
                entry["nodes"].discard(node_id)
                entry.get("replicas", set()).discard(node_id)
                if not entry["nodes"]:
                    del self._objects[oid]
        self._publish("node_dead", {"node_id": node_id, "reason": reason,
                                    "incarnation": incarnation})
        self._repair_pgs_for_dead_node(node_id)

    def _repair_pgs_for_dead_node(self, node_id: str):
        """Re-place cluster-PG bundles that lived on a dead node onto the
        remaining nodes (reference: GcsPlacementGroupManager reschedules
        bundles on node failure).  Un-placeable bundles drop out of the
        assignment table — tasks pinned to them defer until capacity
        appears rather than forwarding to a corpse."""
        with self._lock:
            pgs = list(self._cluster_pgs.items())
        for pg_id, entry in pgs:
            affected = sorted(i for i, n in entry["assignments"].items()
                              if n == node_id)
            if not affected:
                continue
            with self._lock:
                entry["pending"].discard(node_id)
                for i in affected:
                    del entry["assignments"][i]
                entry["state"] = "reserving"
                self._mark_dirty()
            sub_bundles = [entry["bundles"][i] for i in affected]
            placed = self._place_bundles(sub_bundles, entry["strategy"])
            if placed is None:
                continue  # keep un-assigned; retried on next node change
            with self._lock:
                for j, node in placed.items():
                    entry["assignments"][affected[j]] = node
                    entry["pending"].add(node)
                self._mark_dirty()
            for node in set(placed.values()):
                sub = {affected[j]: sub_bundles[j]
                       for j, n in placed.items() if n == node}
                self._publish("pg_reserve",
                              {"pg_id": pg_id, "bundles": sub},
                              target_node=node)

    def start_restart_reconciler(self, delay: Optional[float] = None):
        """Post-restart sweep for raylets that never reconnect.

        Snapshot-reloaded actors come back as 'restarting' on the theory
        that their home raylet will re-assert them — but a raylet that
        died DURING the GCS outage never re-registers and (the node table
        being soft state) never produces a node-death event either, so
        those actors would stay 'restarting' forever and named-actor
        callers would hang.  Once the reconnect window elapses: raylets
        that held a live incarnation in the snapshot but never returned
        are DECLARED DEAD (fence + node_dead publish — peers must fail
        forwarded work and reconstruct, exactly as for a probe-confirmed
        death; without this, an in-flight actor call to a node killed
        during the outage never resolves), actors
        whose owner node never returned go to 'dead' (lookups then raise
        instead of hanging), and cluster-PG bundles assigned to ghost
        nodes are re-placed through the normal dead-node repair path.  A
        slow-but-alive raylet that reconnects later simply re-asserts its
        actors back to 'alive' — the sweep is recoverable, not fatal."""
        if not self._restored:
            return
        if delay is None:
            delay = config.gcs_restart_reconcile_s

        def run():
            if self._stop.wait(delay):
                return
            with self._lock:
                live = {nid for nid, i in self._nodes.items() if i["alive"]}
                # Raylets that held a live incarnation at snapshot time
                # (above their fence watermark) and never re-registered
                # died DURING the outage — the suspicion machine never saw
                # them, so without an explicit declaration here no
                # node_dead is ever published and peers keep forwarding to
                # (and waiting on) a corpse: in-flight actor calls hang
                # instead of failing over.
                ghost_raylets = [
                    (nid, inc) for nid, inc in self._incarnations.items()
                    if nid not in live
                    and inc > self._fenced_incs.get(nid, -1)]
                ghost_actors = [
                    aid for aid, i in self._actors.items()
                    if i.get("state") in ("restarting", "pending")
                    and i.get("owner_node") not in live
                ]
                ghost_nodes = set()
                for entry in self._cluster_pgs.values():
                    ghost_nodes.update(
                        n for n in entry["assignments"].values()
                        if n not in live)
                    ghost_nodes.update(
                        n for n in entry["pending"] if n not in live)
            # Declare ghost raylets dead FIRST: the node_dead push is what
            # makes peers fail forwarded work (ActorDiedError), rotate
            # pulls, and reconstruct sole-copy objects.  A slow-but-alive
            # raylet declared here recovers like any probe-death false
            # positive: its next heartbeat returns "fenced", it kills its
            # stale workers, and re-registers under a fresh incarnation.
            for nid, inc in ghost_raylets:
                with self._lock:
                    info = self._nodes.get(nid)
                    if info is not None and info["alive"]:
                        continue  # reconnected since the sweep above
                    if inc <= self._fenced_incs.get(nid, -1):
                        continue
                    self._fenced_incs[nid] = inc
                    self._m_deaths += 1
                    self._mark_dirty()  # the fence must survive a restart
                self._publish("node_dead", {
                    "node_id": nid,
                    "reason": "raylet never reconnected after GCS restart",
                    "incarnation": inc})
            for aid in ghost_actors:
                with self._lock:
                    info = self._actors.get(aid)
                    # re-check: the owner may have reconnected since
                    if (info is None
                            or info.get("state") not in ("restarting",
                                                         "pending")
                            or info.get("owner_node") in {
                                nid for nid, i in self._nodes.items()
                                if i["alive"]}):
                        continue
                    info["state"] = "dead"
                    info["death_reason"] = (
                        "owner raylet never reconnected after GCS restart")
                    self._mark_dirty()
            for nid in ghost_nodes:
                self._repair_pgs_for_dead_node(nid)

        threading.Thread(target=run, name="gcs-restart-reconcile",
                         daemon=True).start()

    def start_health_monitor(self):
        if self._monitor is not None:
            return
        self._init_health_metrics()

        def loop():
            period = max(0.05, config.gcs_heartbeat_interval_s / 2)
            soft_sweep_at = time.monotonic() + self._SOFT_KV_TTL_S
            metrics_at = time.monotonic() + 1.0
            alerts_at = time.monotonic() + config.alerts_eval_interval_s
            while not self._stop.wait(period):
                timeout = config.gcs_node_timeout_s
                suspect_after = config.gcs_node_suspect_s
                probing = config.gcs_probe_enabled
                now = time.monotonic()
                stale, suspects = [], []
                with self._lock:
                    for nid, info in self._nodes.items():
                        if not info["alive"] or info["address"] is None:
                            continue
                        silent = now - info["last_heartbeat"]
                        if silent > timeout:
                            # hard fallback: probes never concluded (or
                            # probing is off) — plain heartbeat silence
                            stale.append(nid)
                        elif (probing and silent > suspect_after
                                and not info.get("suspect")):
                            info["suspect"] = True
                            self._m_suspects += 1
                            if self._gm is not None:
                                self._gm["suspects"].inc()
                            suspects.append((nid, info["incarnation"]))
                for nid in stale:
                    self._mark_dead(nid, "missed heartbeats")
                for nid, inc in suspects:
                    # a SUSPECT node is routed around but NOT recovered:
                    # reconstruction/replication repair only fires on DEAD
                    self._publish("node_suspect",
                                  {"node_id": nid, "suspect": True,
                                   "incarnation": inc})
                    self._start_probe(nid)
                if now >= metrics_at:
                    metrics_at = now + 1.0
                    self._flush_health_metrics()
                if now >= alerts_at:
                    alerts_at = now + max(
                        0.25, config.alerts_eval_interval_s)
                    try:
                        self._eval_alerts()
                    except Exception:  # noqa: BLE001 — rules never kill
                        pass           # the failure detector's thread
                if now >= soft_sweep_at:
                    # TTL sweep of soft KV (dead metric producers)
                    soft_sweep_at = now + self._SOFT_KV_TTL_S
                    with self._lock:
                        dead_keys = [
                            k for k, ts in self._kv_soft_ts.items()
                            if now - ts > self._SOFT_KV_TTL_S]
                        for k in dead_keys:
                            self._kv_soft_ts.pop(k, None)
                            self._kv.pop(k, None)

        self._monitor = threading.Thread(target=loop, name="gcs-health",
                                         daemon=True)
        self._monitor.start()

    # ------------------------------------------------- liveness probing

    def _start_probe(self, node_id: str):
        with self._lock:
            if node_id in self._probing:
                return
            self._probing.add(node_id)
        threading.Thread(target=self._probe_node, args=(node_id,),
                         name=f"gcs-probe-{node_id[:8]}",
                         daemon=True).start()

    def _probe_node(self, node_id: str):
        """Prober thread for ONE suspect node: a direct TCP ping, then —
        so a GCS<->node link blip can't kill a healthy node — one
        indirect ping relayed through a peer raylet.  Either success
        clears the suspicion; both failing confirms DEAD immediately
        (sub-second, vs waiting out gcs_node_timeout_s)."""
        try:
            with self._lock:
                info = self._nodes.get(node_id)
                if (info is None or not info["alive"]
                        or not info.get("suspect")):
                    return
                addr = info["address"]
                inc = info["incarnation"]
                hb = info["last_heartbeat"]
            ok = self._direct_probe(addr, node_id, inc)
            if not ok:
                ok = self._indirect_probe(node_id, addr, inc)
            publish_recovered = False
            with self._lock:
                info = self._nodes.get(node_id)
                if info is None or not info["alive"]:
                    return
                if info["last_heartbeat"] > hb or not info.get("suspect"):
                    return  # a heartbeat raced the probe: already settled
                if ok:
                    info["suspect"] = False
                    # defer the next suspicion cycle: the node answered a
                    # ping NOW, so treat the probe as a liveness proof even
                    # though heartbeats are still in flight
                    info["last_heartbeat"] = time.monotonic()
                    self._m_false_suspects += 1
                    publish_recovered = True
                else:
                    self._m_probe_deaths += 1
            if publish_recovered:
                self._publish("node_suspect",
                              {"node_id": node_id, "suspect": False,
                               "incarnation": inc})
            elif not ok:
                self._mark_dead(node_id,
                                "liveness probe failed after missed "
                                "heartbeats")
        finally:
            with self._lock:
                self._probing.discard(node_id)

    def _direct_probe(self, address, node_id: str, incarnation: int) -> bool:
        return protocol.liveness_ping(address, node_id, incarnation,
                                      config.gcs_probe_timeout_s)

    def _indirect_probe(self, target: str, address, incarnation: int) -> bool:
        """Ask one healthy peer raylet to ping the target and report back
        (probe_report op).  Covers the asymmetric-partition case where the
        GCS can't reach a node its peers still can."""
        with self._lock:
            helpers = [
                nid for nid, info in self._nodes.items()
                if info["alive"] and not info.get("suspect")
                and nid != target and info["address"] is not None
            ]
            if not helpers:
                return False
            helper = random.choice(helpers)
            token = f"{target}:{incarnation}:{self._m_suspects}"
            waiter = {"event": threading.Event(), "ok": False}
            self._probe_waiters[token] = waiter
        self._publish("node_probe",
                      {"target": target, "address": tuple(address),
                       "incarnation": incarnation, "token": token},
                      target_node=helper)
        waiter["event"].wait(max(0.05, config.gcs_probe_timeout_s) * 2)
        with self._lock:
            self._probe_waiters.pop(token, None)
        return waiter["ok"]

    def probe_report(self, token: str, ok: bool):
        """Indirect-probe verdict from the helper raylet."""
        with self._lock:
            waiter = self._probe_waiters.get(token)
        if waiter is not None:
            waiter["ok"] = bool(ok)
            waiter["event"].set()

    def health_stats(self) -> dict:
        """Failure-detection observability: suspicion / fencing counters
        and the recent time-to-detect distribution (also exported as
        ray_tpu_internal_* series into the metrics KV)."""
        with self._lock:
            ttd = sorted(self._m_ttd)
            return {
                "suspects_total": self._m_suspects,
                "false_suspects_total": self._m_false_suspects,
                "fenced_frames_total": self._m_fenced,
                "deaths_detected_total": self._m_deaths,
                "probe_confirmed_deaths_total": self._m_probe_deaths,
                "time_to_detect_s": ttd,
                "time_to_detect_p50_s":
                    ttd[len(ttd) // 2] if ttd else None,
                "drains": {nid: {k: v for k, v in d.items()
                                 if k != "started"}
                           for nid, d in self._drains.items()},
            }

    def _init_health_metrics(self):
        """GCS-side ray_tpu_internal_* series, flushed straight into this
        core's OWN metrics KV namespace (the GCS has no worker/raylet
        flusher of its own; the dashboard's /metrics merges producers)."""
        try:
            from ray_tpu_torch.util import metrics as _metrics

            tags = {"node": "gcs"}
            self._gm = {
                "suspects": _metrics.internal_metric(
                    _metrics.Counter, "ray_tpu_internal_node_suspects_total",
                    "Nodes marked SUSPECT after missed heartbeats",
                    tag_keys=("node",)).set_default_tags(tags),
                "fenced": _metrics.internal_metric(
                    _metrics.Counter, "ray_tpu_internal_fenced_frames_total",
                    "Stale node-attributed frames rejected by incarnation "
                    "fencing", tag_keys=("node",)).set_default_tags(tags),
                "ttd": _metrics.internal_metric(
                    _metrics.Histogram, "ray_tpu_internal_time_to_detect_s",
                    "Last-contact to death-declaration latency for "
                    "detected node failures",
                    boundaries=(0.25, 0.5, 1.0, 2.0, 3.0, 5.0, 10.0),
                    tag_keys=("node",)).set_default_tags(tags),
                "false_suspects": _metrics.internal_metric(
                    _metrics.Counter,
                    "ray_tpu_internal_false_suspects_total",
                    "SUSPECT nodes that recovered (probe or heartbeat "
                    "cleared the suspicion)",
                    tag_keys=("node",)).set_default_tags(tags),
                "deaths": _metrics.internal_metric(
                    _metrics.Counter,
                    "ray_tpu_internal_node_deaths_detected_total",
                    "Node deaths INFERRED from silence/probes (announced "
                    "drain deaths excluded)",
                    tag_keys=("node",)).set_default_tags(tags),
                "probe_deaths": _metrics.internal_metric(
                    _metrics.Counter,
                    "ray_tpu_internal_probe_confirmed_deaths_total",
                    "Node deaths confirmed sub-second by a failed "
                    "direct+indirect probe pair",
                    tag_keys=("node",)).set_default_tags(tags),
                "drains": _metrics.internal_metric(
                    _metrics.Gauge, "ray_tpu_internal_node_drains",
                    "Nodes with a recorded drain lifecycle (draining or "
                    "drained)", tag_keys=("node",)).set_default_tags(tags),
                "alerts_firing": _metrics.internal_metric(
                    _metrics.Gauge, "ray_tpu_internal_alerts_firing",
                    "Alert rules currently in the firing state",
                    tag_keys=("node",)).set_default_tags(tags),
            }
            # delta-sync baselines: the _m_* counters are bumped inline
            # under _lock; the flusher ships increments into the Counter
            # instruments so restarts/re-inits never double-count
            self._gm_last = {"fenced": 0, "false_suspects": 0, "deaths": 0,
                             "probe_deaths": 0}
            # time-series baselines for collect_points (flusher thread only)
            self._gm_points_last = {}
        except Exception:  # noqa: BLE001 — stats-only fallback
            self._gm = None

    def _flush_health_metrics(self):
        if self._gm is None:
            return
        import json as _json

        with self._lock:
            current = {"fenced": self._m_fenced,
                       "false_suspects": self._m_false_suspects,
                       "deaths": self._m_deaths,
                       "probe_deaths": self._m_probe_deaths}
            drains = len(self._drains)
        for key, value in current.items():
            delta = value - self._gm_last[key]
            if delta > 0:
                self._gm[key].inc(delta)
            self._gm_last[key] = value
        self._gm["drains"].set(drains)
        items = []
        for m in self._gm.values():
            try:
                payload = m._export()
            except Exception:  # noqa: BLE001
                continue
            if payload is None:
                continue
            items.append((f"gcs-{os.getpid()}/{m.name}".encode(),
                          _json.dumps(payload).encode()))
        if items:
            self.kv_multi_put("metrics", items)
        if config.metrics_history:
            # the GCS's own series feed the time-series table too — the
            # alert engine's detector rules read them (false suspects,
            # fenced frames) like any other producer's
            from ray_tpu_torch.util import metrics as _metrics

            points = _metrics.collect_points(self._gm.values(),
                                             self._gm_points_last)
            if points:
                self.add_metric_points("gcs", points)

    def stop(self):
        self._stop.set()
        # Synchronous final flush: a graceful shutdown must not lose
        # acknowledged durable mutations to the async-flusher window.
        if self._persist_path and self._dirty:  # unguarded-ok: shutdown-path flag read
            try:
                self._write_snapshot()
            except OSError:
                pass

    # ----------------------------------------------------------- placement

    def place_task(self, resources: Dict[str, float],
                   exclude: Optional[List[str]] = None,
                   arg_ids: Optional[List[str]] = None) -> Optional[str]:
        """Pick an alive node whose AVAILABLE resources fit — most
        argument bytes already local first (``arg_ids``: the task's
        dependency object ids, scored against the object directory —
        reference: locality-aware leasing), then most-available (a
        spread-flavoured policy; the reference's hybrid policy packs to
        50% then spreads, `scheduling/policy/hybrid_scheduling_policy.h:50`).
        Returns None when nothing fits right now."""
        exclude = set(exclude or ())
        best, best_score = None, None
        with self._lock:
            loc_bytes: Dict[str, int] = {}
            for oid in arg_ids or ():
                entry = self._objects.get(oid)
                if entry:
                    for nid in entry["nodes"]:
                        loc_bytes[nid] = loc_bytes.get(nid, 0) \
                            + (entry["size"] or 0)
            for nid, info in self._nodes.items():
                if not info["alive"] or nid in exclude \
                        or info.get("draining") or info.get("suspect"):
                    continue
                avail = info["resources_available"]
                if all(avail.get(k, 0.0) + 1e-9 >= v
                       for k, v in resources.items()):
                    score = (loc_bytes.get(nid, 0),
                             sum(avail.values()) - len(resources))
                    if best_score is None or score > best_score:
                        best, best_score = nid, score
        return best

    def feasible_nodes(self, resources: Dict[str, float]) -> List[str]:
        """Nodes whose TOTAL capacity fits (for infeasibility diagnosis)."""
        with self._lock:
            return [
                nid for nid, info in self._nodes.items()
                if info["alive"] and not info.get("draining") and all(
                    info["resources_total"].get(k, 0.0) + 1e-9 >= v
                    for k, v in resources.items())
            ]

    # ----------------------------------------------------------- cluster PGs

    def create_pg(self, pg_id: str, bundles: List[Dict[str, float]],
                  strategy: str, origin_node: str) -> bool:
        """Place each bundle on a node per the strategy and ask the
        involved raylets (pg_reserve push) to reserve their fragments
        (reference: GcsPlacementGroupScheduler + the 2PC bundle
        reservation, `placement_group_resource_manager.cc`).  False =
        infeasible against current cluster TOTALS."""
        assignments = self._place_bundles(bundles, strategy)
        if assignments is None:
            return False
        with self._lock:
            self._cluster_pgs[pg_id] = {
                "bundles": bundles,
                "strategy": strategy,
                "assignments": assignments,
                "origin": origin_node,
                "pending": set(assignments.values()),
                "state": "reserving",
            }
            self._mark_dirty()
        for node in set(assignments.values()):
            sub = {i: bundles[i] for i, n in assignments.items()
                   if n == node}
            self._publish("pg_reserve",
                          {"pg_id": pg_id, "bundles": sub},
                          target_node=node)
        return True

    def _place_bundles(self, bundles, strategy):
        """Greedy placement against the latest heartbeat availability;
        falls back to capacity totals so a currently-busy cluster still
        places (fragments then pend locally until resources free)."""
        def placeable(info) -> bool:
            return (info["alive"] and not info.get("draining")
                    and not info.get("suspect"))

        with self._lock:
            nodes = {nid: dict(info["resources_available"])
                     for nid, info in self._nodes.items() if placeable(info)}
            totals = {nid: dict(info["resources_total"])
                      for nid, info in self._nodes.items() if placeable(info)}
            slices = {nid: info.get("labels", {}).get("tpu_slice")
                      for nid, info in self._nodes.items()
                      if placeable(info)}
        if not nodes:
            return None

        def fits(avail, b):
            return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in b.items())

        def take(avail, b):
            for k, v in b.items():
                avail[k] = avail.get(k, 0.0) - v

        def pack_into(pool, nids):
            """All bundles greedily into the given node set, or None."""
            trial = {nid: dict(pool[nid]) for nid in nids if nid in pool}
            out: Dict[int, str] = {}
            for i, b in enumerate(bundles):
                nid = next((n for n in trial if fits(trial[n], b)), None)
                if nid is None:
                    return None
                take(trial[nid], b)
                out[i] = nid
            return out

        assignments: Dict[int, str] = {}
        if strategy in ("STRICT_PACK", "PACK"):
            # one node for everything when possible
            for pool in (nodes, totals):
                for nid in pool:
                    got = pack_into(pool, [nid])
                    if got is not None:
                        return got
            # TPU extension (SURVEY §7 items 3-4): a bundle set too big for
            # one host still packs onto ONE ICI domain — all hosts sharing
            # a tpu_slice label are directly connected, so same-slice
            # multi-host placement preserves STRICT_PACK's locality intent
            # where plain Ray would just fail.
            slice_groups: Dict[str, List[str]] = {}
            for nid, sl in slices.items():
                if sl:
                    slice_groups.setdefault(sl, []).append(nid)
            for pool in (nodes, totals):
                for sl, nids in sorted(slice_groups.items()):
                    got = pack_into(pool, sorted(nids))
                    if got is not None:
                        return got
            if strategy == "STRICT_PACK":
                return None
        if strategy == "STRICT_SPREAD":
            used: set = set()
            for i, b in enumerate(bundles):
                cand = next(
                    (nid for nid in totals
                     if nid not in used and fits(totals[nid], b)), None)
                if cand is None:
                    return None
                assignments[i] = cand
                used.add(cand)
            return assignments
        # PACK overflow / SPREAD: greedy, SPREAD rotates nodes.  The
        # capacity fallback tracks CUMULATIVE placements per node — a node
        # must fit everything assigned to it even if bundles will pend
        # until running work frees resources.
        order = sorted(totals)
        trem = {nid: dict(t) for nid, t in totals.items()}
        rr = 0
        # first-fit-decreasing: big bundles place first so small ones
        # don't squat on the only node the big one fits
        by_size = sorted(range(len(bundles)),
                         key=lambda i: -sum(bundles[i].values()))
        for i in by_size:
            b = bundles[i]
            placed = None
            for attempt in range(len(order)):
                nid = order[(rr + attempt) % len(order)]
                if fits(nodes[nid], b) and fits(trem[nid], b):
                    placed = nid
                    break
            if placed is None:
                placed = next(
                    (nid for nid in order if fits(trem[nid], b)), None)
                if placed is None:
                    return None
            take(nodes[placed], b)
            take(trem[placed], b)
            assignments[i] = placed
            if strategy == "SPREAD":
                rr = (order.index(placed) + 1) % len(order)
        return assignments

    def pg_fragment_ready(self, pg_id: str, node_id: str):
        with self._lock:
            entry = self._cluster_pgs.get(pg_id)
            if entry is None:
                return
            entry["pending"].discard(node_id)
            done = not entry["pending"]
            if done:
                entry["state"] = "created"
            origin = entry["origin"]
            self._mark_dirty()
        if done:
            self._publish("pg_ready", {"pg_id": pg_id}, target_node=origin)

    def remove_cluster_pg(self, pg_id: str):
        with self._lock:
            entry = self._cluster_pgs.pop(pg_id, None)
            if entry is not None:
                self._mark_dirty()
        if entry is None:
            return False
        for node in set(entry["assignments"].values()):
            self._publish("pg_remove", {"pg_id": pg_id}, target_node=node)
        if entry["origin"] not in set(entry["assignments"].values()):
            self._publish("pg_remove", {"pg_id": pg_id},
                          target_node=entry["origin"])
        return True

    def pg_info(self, pg_id: str) -> Optional[dict]:
        with self._lock:
            entry = self._cluster_pgs.get(pg_id)
            if entry is None:
                return None
            return {"assignments": dict(entry["assignments"]),
                    "bundles": list(entry["bundles"]),
                    "state": entry["state"], "origin": entry["origin"]}

    # ----------------------------------------------------------- kv

    # Soft-state KV namespaces: high-churn, rebuildable data (per-producer
    # metric samples flush ~1/s forever) — excluded from the durable
    # snapshot (else every flush rewrites it) and TTL-swept so dead
    # producers' keys don't accumulate.  Job logs stay durable by design
    # (documented: they outlive client and driver) — they are per-job
    # bounded, not per-second unbounded.
    _SOFT_KV_NS = frozenset({"metrics"})
    _SOFT_KV_TTL_S = 120.0

    def kv_put(self, ns: str, key: bytes, val: bytes):
        with self._lock:
            self._kv[(ns, key)] = val
            if ns in self._SOFT_KV_NS:
                self._kv_soft_ts[(ns, key)] = time.monotonic()
            else:
                self._mark_dirty()

    def kv_multi_put(self, ns: str, items):
        """Batched kv_put: one RPC/post for N keys of one namespace (the
        raylets' internal-metrics flush ships ~30 keys per interval —
        per-key posts were 30x the control-plane frames for the same
        data)."""
        with self._lock:
            now = time.monotonic()
            soft = ns in self._SOFT_KV_NS
            for key, val in items:
                self._kv[(ns, key)] = val
                if soft:
                    self._kv_soft_ts[(ns, key)] = now
            if items and not soft:
                self._mark_dirty()

    def kv_get(self, ns: str, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._kv.get((ns, key))

    def kv_del(self, ns: str, key: bytes) -> bool:
        with self._lock:
            existed = self._kv.pop((ns, key), None) is not None
            self._kv_soft_ts.pop((ns, key), None)
            if existed and ns not in self._SOFT_KV_NS:
                self._mark_dirty()
            return existed

    def kv_keys(self, ns: str, prefix: bytes) -> List[bytes]:
        with self._lock:
            return [k for (n, k) in self._kv
                    if n == ns and k.startswith(prefix)]

    # ----------------------------------------------------------- functions

    def put_function(self, fid: bytes, blob: bytes):
        with self._lock:
            self._functions[fid] = blob
            self._mark_dirty()

    def get_function(self, fid: bytes) -> Optional[bytes]:
        with self._lock:
            return self._functions.get(fid)

    # ----------------------------------------------------------- actors

    def register_actor(self, actor_id: bytes, owner_node: str,
                       name: Optional[str] = None, namespace: str = "",
                       spec_blob: Optional[bytes] = None,
                       incarnation: Optional[int] = None) -> bool:
        """False when the (namespace, name) is already taken — or when the
        registering node is fenced (a resurrected partitioned node must
        not re-assert actors the cluster already restarted elsewhere)."""
        with self._lock:
            if not self._fence_ok(owner_node, incarnation):
                return False
            if name:
                existing = self._named.get((namespace, name))
                if existing is not None and existing != actor_id:
                    return False  # name collision
            self._actors[actor_id] = {
                "owner_node": owner_node,
                "state": "pending",
                "name": name,
                "namespace": namespace,
                "spec_blob": spec_blob,
            }
            if name:
                self._named[(namespace, name)] = actor_id
            self._mark_dirty()
            return True

    def update_actor(self, actor_id: bytes, state: str,
                     node_id: Optional[str] = None,
                     checkpoint: Optional[str] = None,
                     checkpoint_seq: Optional[int] = None):
        """``checkpoint``/``checkpoint_seq``: latest checkpoint object id
        (hex) + sequence number of a checkpointable actor — the actor
        table tracks the freshest snapshot so state tooling can see what
        a restart would restore from."""
        with self._lock:
            info = self._actors.get(actor_id)
            if info is None:
                return
            info["state"] = state
            if node_id is not None:
                info["exec_node"] = node_id
            if checkpoint is not None:
                info["checkpoint"] = checkpoint
                info["checkpoint_seq"] = checkpoint_seq or 0
            self._mark_dirty()

    def remove_actor(self, actor_id: bytes):
        with self._lock:
            info = self._actors.pop(actor_id, None)
            if info and info.get("name"):
                key = (info["namespace"], info["name"])
                if self._named.get(key) == actor_id:
                    del self._named[key]
            if info is not None:
                self._mark_dirty()

    def get_actor(self, actor_id: bytes) -> Optional[dict]:
        with self._lock:
            info = self._actors.get(actor_id)
            return dict(info) if info else None

    def lookup_named_actor(self, namespace: str, name: str) -> Optional[dict]:
        with self._lock:
            aid = self._named.get((namespace, name))
            if aid is None:
                return None
            info = dict(self._actors[aid])
            info["actor_id"] = aid
            return info

    def list_actors(self) -> List[dict]:
        with self._lock:
            return [{"actor_id": aid.hex() if isinstance(aid, bytes) else aid,
                     **{k: v for k, v in info.items() if k != "spec_blob"}}
                    for aid, info in self._actors.items()]

    # ----------------------------------------------------------- objects

    def add_object_location(self, oid: str, node_id: str, size: int = 0,
                            inline: bool = False, replica: bool = False,
                            incarnation: Optional[int] = None):
        """``replica``: this holder is an eager secondary copy (pushed by
        the sealing raylet for availability, not pulled by a consumer) —
        recorded so re-replication math can tell managed copies from
        incidental consumer-side caches.  Striping treats all holders the
        same, so every replica also doubles a pull's read bandwidth.

        ``incarnation``: the registering node's stamp — a fenced (dead or
        stale-incarnation) node cannot resurrect directory entries."""
        with self._lock:
            if not self._fence_ok(node_id, incarnation):
                return
            entry = self._objects.setdefault(
                oid, {"nodes": set(), "size": size, "inline": inline,
                      "replicas": set()})
            entry["nodes"].add(node_id)
            entry["size"] = max(entry["size"], size)
            entry["inline"] = entry["inline"] or inline
            if replica:
                entry.setdefault("replicas", set()).add(node_id)
            push_size, push_inline = entry["size"], entry["inline"]
            watchers = self._object_watchers.pop(oid, set())
        for w in watchers:
            self._publish("object_at",
                          {"oid": oid, "node_id": node_id,
                           "size": push_size, "inline": push_inline},
                          target_node=w)

    def remove_object_location(self, oid: str, node_id: Optional[str] = None):
        with self._lock:
            if node_id is None:
                self._objects.pop(oid, None)
                return
            entry = self._objects.get(oid)
            if entry:
                entry["nodes"].discard(node_id)
                entry.get("replicas", set()).discard(node_id)
                if not entry["nodes"]:
                    del self._objects[oid]

    def get_object_locations(self, oid: str,
                             watcher: Optional[str] = None) -> dict:
        """When no location is known and ``watcher`` is given, the watcher
        node gets an ``object_at`` push once somebody registers one
        (reference: object directory subscriptions,
        `ownership_based_object_directory.h`)."""
        with self._lock:
            entry = self._objects.get(oid)
            if entry and entry["nodes"]:
                return {"nodes": sorted(entry["nodes"]),
                        "size": entry["size"], "inline": entry["inline"],
                        "replicas": sorted(entry.get("replicas", ()))}
            if watcher is not None:
                self._object_watchers.setdefault(oid, set()).add(watcher)
            return {"nodes": [], "size": 0, "inline": False}

    def get_object_locations_batch(self, oids: List[str]) -> Dict[str, dict]:
        """One round trip for many objects (node-death recovery scans a
        dead node's whole holding set — per-object RPCs would serialize a
        raylet's event thread on GCS latency).  Objects with no known
        holder are simply absent from the result; no watches are
        registered."""
        with self._lock:
            out: Dict[str, dict] = {}
            for oid in oids:
                entry = self._objects.get(oid)
                if entry and entry["nodes"]:
                    out[oid] = {
                        "nodes": sorted(entry["nodes"]),
                        "size": entry["size"], "inline": entry["inline"],
                        "replicas": sorted(entry.get("replicas", ()))}
            return out

    # ----------------------------------------------------------- task events

    def add_task_events(self, node_id: str, events: List[dict],
                        dropped: int = 0,
                        incarnation: Optional[int] = None):
        """Batch append from one raylet's export ring buffer.  ``dropped``
        is how many events that raylet shed to backpressure since its last
        flush (the buffer never blocks dispatch — it drops and counts).
        Stamped batches from a fenced node are rejected whole (stale task
        completions must not overwrite the retried attempts' states)."""
        cap = max(1, config.task_events_max_per_job)
        with self._lock:
            if not self._fence_ok(node_id, incarnation):
                return
            self._task_events_dropped += dropped
            last_job, tasks, log = None, None, None
            for ev in events:
                job = ev.get("job_id") or "driver"
                if job != last_job:  # batches are almost always one job
                    slot = self._task_events.get(job)
                    if slot is None:
                        slot = {"events": deque(maxlen=cap), "tasks": {}}
                        self._task_events[job] = slot
                    last_job, tasks, log = job, slot["tasks"], slot["events"]
                log.append(ev)
                # pop+reinsert keeps dict order least-recently-updated
                # first, so cap overflow evicts stale finished tasks
                tid = ev["task_id"]
                tasks.pop(tid, None)
                tasks[tid] = ev
                if len(tasks) > cap:
                    tasks.pop(next(iter(tasks)))

    def _job_slots(self, job_id: Optional[str]) -> List[dict]:  # requires: _lock
        if job_id is not None:
            slot = self._task_events.get(job_id)
            return [slot] if slot else []
        return list(self._task_events.values())

    def list_task_events(self, job_id: Optional[str] = None,
                         state: Optional[str] = None,
                         limit: int = 1000) -> List[dict]:
        """Latest known state per task, cluster-wide (newest-updated
        first).  ``limit`` applies at the source."""
        with self._lock:
            rows: List[dict] = []
            for slot in self._job_slots(job_id):
                rows.extend(slot["tasks"].values())
        rows.sort(key=lambda ev: ev.get("time", 0.0), reverse=True)
        if state is not None:
            state = state.upper()
            rows = [ev for ev in rows if ev.get("state") == state]
        return rows[:max(0, limit)]

    def task_events_raw(self, job_id: Optional[str] = None,
                        limit: int = 100000) -> List[dict]:
        """The raw event log (every state transition) — timeline feed."""
        if limit <= 0:
            return []
        with self._lock:
            rows = []
            for slot in self._job_slots(job_id):
                rows.extend(slot["events"])
        rows.sort(key=lambda ev: ev.get("time", 0.0))
        return rows[-limit:]

    def summarize_task_events(self, job_id: Optional[str] = None) -> dict:
        """State -> count over the latest per-task states, plus export-drop
        and node-coverage accounting."""
        by_state: Dict[str, int] = {}
        nodes = set()
        num_tasks = 0
        with self._lock:
            for slot in self._job_slots(job_id):
                for ev in slot["tasks"].values():
                    num_tasks += 1
                    st = ev.get("state", "?")
                    by_state[st] = by_state.get(st, 0) + 1
                    if ev.get("node_id"):
                        nodes.add(ev["node_id"])
            dropped = self._task_events_dropped
        return {"by_state": by_state, "num_tasks": num_tasks,
                "num_dropped": dropped, "nodes": sorted(nodes)}

    # -------------------------------------------------------- trace table

    def add_trace_spans(self, node_id: str, spans: List[dict],
                        dropped: int = 0,
                        incarnation: Optional[int] = None):
        """Batch append from one process's span export buffer.  ``dropped``
        counts spans that producer shed to backpressure since its last
        flush.  Like task events, batches from a fenced node are rejected
        whole (a resurrected node must not rewrite request history)."""
        cap = max(1, config.trace_table_max)
        with self._lock:
            if not self._fence_ok(node_id, incarnation):
                return
            self._trace_dropped += dropped
            last_job, log = None, None
            for sp in spans:
                job = sp.get("job") or "driver"
                if job != last_job:  # batches are almost always one job
                    log = self._trace_spans.get(job)
                    if log is None:
                        log = self._trace_spans[job] = deque(maxlen=cap)
                    last_job = job
                if len(log) == cap:
                    self._trace_dropped += 1  # eviction, counted
                log.append(sp)

    def get_trace(self, trace_id: str) -> List[dict]:
        """Every retained span of one trace, cluster-wide (the flat
        record list — ``util.trace_analysis`` turns it into a tree /
        waterfall)."""
        with self._lock:
            return [sp for log in self._trace_spans.values()
                    for sp in log if sp.get("trace_id") == trace_id]

    def list_trace_spans(self, job_id: Optional[str] = None,
                         limit: int = 10000) -> List[dict]:
        """The most recent retained spans (newest last) — feed for the
        aggregate "where do the microseconds go" breakdown."""
        if limit <= 0:
            return []
        with self._lock:
            if job_id is not None:
                logs = [self._trace_spans.get(job_id) or ()]
            else:
                logs = list(self._trace_spans.values())
            rows = [sp for log in logs for sp in log]
        rows.sort(key=lambda sp: sp.get("start_us", 0))
        return rows[-limit:]

    def trace_table_stats(self) -> dict:
        with self._lock:
            num = sum(len(v) for v in self._trace_spans.values())
            traces = {sp.get("trace_id")
                      for log in self._trace_spans.values() for sp in log}
            return {"num_spans": num, "num_traces": len(traces),
                    "num_dropped": self._trace_dropped,
                    "jobs": sorted(self._trace_spans)}

    # ----------------------------------------------------- profile table

    def add_profile_samples(self, node_id: str, samples: List[dict],
                            dropped: int = 0,
                            incarnation: Optional[int] = None):
        """Batch append from one node's folded stack-sample buffers
        (every process on the node funnels through its raylet; the
        standalone GCS feeds its own samples under the "gcs" key).
        ``dropped`` counts records the producer shed to backpressure.
        Stamped batches from a fenced node are rejected whole."""
        cap = max(1, config.profile_table_max)
        with self._lock:
            if not self._fence_ok(node_id, incarnation):
                return
            self._profile_dropped += dropped
            log = self._profile_samples.get(node_id)
            if log is None:
                log = self._profile_samples[node_id] = deque(maxlen=cap)
            for rec in samples:
                if len(log) == cap:
                    self._profile_dropped += 1  # eviction, counted
                log.append(rec)

    def list_profile_samples(self, node_id: Optional[str] = None,
                             since: float = 0.0,
                             limit: int = 100000) -> List[dict]:
        """Retained folded sample records, cluster-wide or for one node
        (id prefix accepted); ``since`` keeps only records whose window
        ends at/after it — the timed-capture filter behind
        ``state.profile(duration_s)``."""
        if limit <= 0:
            return []
        with self._lock:
            if node_id is not None:
                logs = [log for nid, log in self._profile_samples.items()
                        if nid.startswith(node_id)]
            else:
                logs = list(self._profile_samples.values())
            rows = [rec for log in logs for rec in log
                    if rec.get("t1", 0.0) >= since]
        rows.sort(key=lambda rec: rec.get("t0", 0.0))
        return rows[-limit:]

    def profile_table_stats(self) -> dict:
        with self._lock:
            num = sum(len(v) for v in self._profile_samples.values())
            total = sum(int(rec.get("count", 0))
                        for log in self._profile_samples.values()
                        for rec in log)
            return {"num_records": num, "num_samples": total,
                    "num_dropped": self._profile_dropped,
                    "nodes": sorted(self._profile_samples)}

    # ------------------------------------------- metrics time-series table

    def add_metric_points(self, node_id: str, points: List[dict],
                          dropped: int = 0,
                          incarnation: Optional[int] = None):
        """Batch append from one node's metric point ring (every process
        on the node funnels through its raylet; the standalone GCS feeds
        its own points under the "gcs" key).  Points are DELTAS — counter
        and histogram-bucket increments per flush interval, gauge value
        changes — so merging across producer restarts needs no reset
        heuristics.  ``dropped`` counts points the producer's ring shed.
        Stamped batches from a fenced node are rejected whole."""
        cap = max(1, config.metrics_table_max)
        with self._lock:
            if not self._fence_ok(node_id, incarnation):
                return
            self._metric_points_dropped += dropped
            log = self._metric_points.get(node_id)
            if log is None:
                log = self._metric_points[node_id] = deque(maxlen=cap)
            for p in points:
                p["node"] = node_id
                if len(log) == cap:
                    self._metric_points_dropped += 1  # eviction, counted
                log.append(p)

    def _metric_points_snapshot(self, name: Optional[str] = None,
                                node_id: Optional[str] = None) -> List[dict]:
        """Flat point list (records are append-only after ingest, so
        handing out references is safe)."""
        with self._lock:
            if node_id is not None:
                logs = [log for nid, log in self._metric_points.items()
                        if nid.startswith(node_id)]
            else:
                logs = list(self._metric_points.values())
            if name is not None:
                return [p for log in logs for p in log
                        if p["name"] == name]
            return [p for log in logs for p in log]

    def query_metrics(self, name: Optional[str] = None, op: str = "range",
                      tags: Optional[Dict[str, str]] = None,
                      node_id: Optional[str] = None,
                      since: Optional[float] = None,
                      until: Optional[float] = None,
                      window_s: float = 60.0, q: float = 0.99,
                      limit: int = 2000) -> dict:
        """Query the time-series table.  ``op``:

        * ``range`` — the matching points themselves (newest ``limit``).
        * ``rate`` — per-second increase over the trailing ``window_s``.
        * ``quantile`` — histogram quantile ``q`` over the window (bucket
          deltas merged first — never averaged percentiles).
        * ``series`` — per-(name, tags) activity summary, the feed for
          ``ray_tpu_torch metrics top``.

        The math lives in ``util.metrics_query`` (pure, shared with the
        alert engine)."""
        from ray_tpu_torch.util import metrics_query as mq

        pts = mq.filter_points(
            self._metric_points_snapshot(name, node_id),
            name, tags, since, until)
        if op == "range":
            return {"op": "range", "count": len(pts),
                    "truncated": len(pts) > limit,
                    "points": pts[-max(0, limit):]}
        now = until
        if now is None:
            now = max((p["ts"] for p in pts), default=time.time())
        if op == "rate":
            return {"op": "rate", "window_s": window_s,
                    "points": len(pts),
                    "rate": mq.rate(pts, window_s, now=now)}
        if op == "quantile":
            return {"op": "quantile", "q": q, "window_s": window_s,
                    "points": len(pts),
                    "value": mq.quantile_over_window(pts, q, window_s,
                                                     now=now)}
        if op == "series":
            return {"op": "series",
                    "series": mq.series_summary(pts, window_s, now=now)}
        raise ValueError(f"unknown query op {op!r}")

    def metrics_table_stats(self) -> dict:
        with self._lock:
            num = sum(len(v) for v in self._metric_points.values())
            series = {(p["name"], tuple(map(tuple, p.get("tags", ()))))
                      for log in self._metric_points.values() for p in log}
            return {"num_points": num, "num_series": len(series),
                    "num_dropped": self._metric_points_dropped,
                    "nodes": sorted(self._metric_points)}

    # ------------------------------------------------------- alert table

    def list_alerts(self, state: Optional[str] = None,
                    limit: int = 100) -> dict:
        """The live firing view plus the transition log (newest first).
        ``state`` filters the log ("firing" / "resolved")."""
        with self._lock:
            firing = [dict(rec) for rec in self._alerts_active.values()]
            log = [dict(rec) for rec in self._alerts_log]
            dropped = self._alerts_dropped
        firing.sort(key=lambda r: r["since"])
        log.reverse()
        if state is not None:
            log = [rec for rec in log if rec["state"] == state]
        return {"firing": firing, "log": log[:max(0, limit)],
                "num_dropped": dropped}

    def _eval_alerts(self):
        """One alert-engine pass over the metrics table (health-monitor
        thread, alerts_eval_interval_s cadence).  Rule evaluation itself
        is pure (util.alerts); this wrapper snapshots state under _lock,
        evaluates unlocked, then commits transitions and the firing
        gauge."""
        from ray_tpu_torch.util import alerts as alerts_mod

        if not config.alerts:
            return
        rules = alerts_mod.load_rules()
        if not rules:
            return
        now = time.time()

        def query(name, tags, since):
            from ray_tpu_torch.util import metrics_query as mq

            return mq.filter_points(self._metric_points_snapshot(name),
                                    name, tags, since)

        with self._lock:
            active = {k: dict(v) for k, v in self._alerts_active.items()}
        records = alerts_mod.evaluate_rules(rules, query, now, active)
        cap = max(1, config.alerts_table_max)
        with self._lock:
            self._alerts_active = active
            for rec in records:
                if len(self._alerts_log) >= cap:
                    self._alerts_log.popleft()
                    self._alerts_dropped += 1  # eviction, counted
                self._alerts_log.append(rec)
            firing = len(active)
        if self._gm is not None:
            self._gm["alerts_firing"].set(firing)

    # ------------------------- targeted node queries (stacks / logs) ----

    def _node_query_multi(self, node_ids: List[str], kind: str,
                          payload: Optional[dict],
                          timeout_s: float) -> Tuple[Dict[str, Any],
                                                     List[str]]:
        """Publish one targeted ``node_query`` per node and gather the
        ``node_query_report`` replies: ``(reports, missing)``.  The
        introspection analogue of the indirect-probe relay — the GCS
        never dials anyone, the existing pubsub + one-way op carry both
        directions."""
        if not node_ids:
            return {}, []
        with self._lock:
            self._query_seq += 1
            token = f"q{self._query_seq}:{kind}:{time.monotonic():.6f}"
            waiter = {"event": threading.Event(), "reports": {},
                      "want": len(node_ids)}
            self._query_waiters[token] = waiter
        for nid in node_ids:
            self._publish("node_query",
                          {"kind": kind, "token": token,
                           "payload": payload or {}},
                          target_node=nid)
        waiter["event"].wait(max(0.1, timeout_s))
        with self._lock:
            self._query_waiters.pop(token, None)
            reports = dict(waiter["reports"])
        missing = [nid for nid in node_ids if nid not in reports]
        return reports, missing

    def node_query_report(self, token: str, node_id: str, payload):
        """A raylet's reply to a targeted ``node_query`` push."""
        with self._lock:
            waiter = self._query_waiters.get(token)
            if waiter is None:
                return
            waiter["reports"][node_id] = payload
            if len(waiter["reports"]) >= waiter["want"]:
                waiter["event"].set()

    def _alive_node_ids(self, node_id: Optional[str]) -> List[str]:
        with self._lock:
            return [nid for nid, info in self._nodes.items()
                    if info["alive"]
                    and (node_id is None or nid.startswith(node_id))]

    def node_query(self, node_id: Optional[str], kind: str,
                   payload: Optional[dict] = None,
                   timeout_s: float = 3.0) -> Dict[str, Any]:
        """Targeted introspection query against one node (id prefix) or
        every alive node: ``{"reports": {node_id: payload}, "missing":
        [...]}`` — ``missing`` nodes didn't answer inside the timeout
        (dead, partitioned, or busy past the deadline)."""
        targets = self._alive_node_ids(node_id)
        reports, missing = self._node_query_multi(targets, kind, payload,
                                                  timeout_s)
        return {"reports": reports, "missing": missing}

    def collect_stacks(self, node_id: Optional[str] = None,
                       pid: Optional[int] = None,
                       timeout_s: float = 3.0) -> Dict[str, Any]:
        """Live all-thread stacks from every process on the targeted
        node(s) — the cluster-wide ``ray stack`` / ``py-spy dump``
        analogue.  Each raylet dumps its own threads and relays the
        request to its workers over their control sockets; the GCS
        process contributes its own threads unless an in-process raylet
        already covered this pid (embedded single-node mode)."""
        targets = self._alive_node_ids(node_id)
        payload = {"pid": pid} if pid is not None else None
        reports, missing = self._node_query_multi(targets, "stacks",
                                                  payload, timeout_s)
        out = {"nodes": reports, "missing": missing}
        # Embedded-mode dedup: skip the self-dump only when a SAME-HOST
        # report already covers this pid (pids are per-host — a bare
        # cross-node pid match must not silently hide the control plane's
        # stacks, which is exactly what a wedged-GCS debugger came for).
        own_host = socket.gethostname()
        with self._lock:
            same_host = {nid for nid, info in self._nodes.items()
                         if info.get("hostname") == own_host}
        covered = {p.get("pid") for nid, procs in reports.items()
                   if nid in same_host for p in procs or []}
        if node_id is None and os.getpid() not in covered \
                and (pid is None or pid == os.getpid()):
            out["gcs"] = [{"pid": os.getpid(), "proc": "gcs",
                           "threads": profiling.dump_threads(proc="gcs")}]
        return out

    # ----------------------------------------------------------- snapshot

    def state_snapshot(self) -> dict:
        with self._lock:
            pgs = [
                {"pg_id": pid, "state": info["state"],
                 "strategy": info["strategy"],
                 "bundles": info["bundles"],
                 "assignments": {str(k): v
                                 for k, v in info["assignments"].items()}}
                for pid, info in self._cluster_pgs.items()
            ]
            return {
                "nodes": [dict(n) for n in self._nodes.values()],
                "actors": self.list_actors(),
                "placement_groups": pgs,
                "num_objects_tracked": len(self._objects),
                "num_kv": len(self._kv),
            }


# ---------------------------------------------------------------------------
# Socket server


_OPS = {
    "register_node", "unregister_node", "heartbeat", "nodes", "get_node",
    "place_task", "feasible_nodes", "load_metrics",
    "drain_node", "drain_complete", "drain_status",
    "probe_report", "health_stats",
    "kv_put", "kv_multi_put", "kv_get", "kv_del", "kv_keys",
    "put_function", "get_function",
    "register_actor", "update_actor", "remove_actor", "get_actor",
    "lookup_named_actor", "list_actors",
    "add_object_location", "remove_object_location", "get_object_locations",
    "get_object_locations_batch",
    "create_pg", "pg_fragment_ready", "remove_cluster_pg", "pg_info",
    "add_task_events", "list_task_events", "task_events_raw",
    "summarize_task_events",
    "add_trace_spans", "get_trace", "list_trace_spans", "trace_table_stats",
    "add_profile_samples", "list_profile_samples", "profile_table_stats",
    "add_metric_points", "query_metrics", "metrics_table_stats",
    "list_alerts",
    "collect_stacks", "node_query", "node_query_report",
    "state_snapshot",
}

# Ops that BLOCK waiting on node_query_report posts.  They must never run
# on a GcsServer conn thread synchronously: a raylet proxying such a
# gather shares ONE connection with its heartbeats and with the very
# report that completes the gather — serializing them behind the blocked
# op would suspect (then fence) the node and deadlock the query.  The
# server bounces these to a throwaway thread and replies when they finish.
_BLOCKING_OPS = {"collect_stacks", "node_query"}


class GcsServer:
    """TCP front-end for a GcsCore; one reader thread per connection."""

    def __init__(self, core: Optional[GcsCore] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 persist_path: Optional[str] = None):
        self.core = core or GcsCore(persist_path=persist_path)
        self._listener = socket.create_server((host, port))
        self.host, self.port = self._listener.getsockname()[:2]
        self._conns: List[socket.socket] = []
        self._stop = False
        self.core.start_health_monitor()
        self.core.start_restart_reconciler()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="gcs-accept", daemon=True)
        self._accept_thread.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self):
        while not self._stop:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.append(sock)
            threading.Thread(target=self._serve_conn, args=(sock,),
                             name="gcs-serve", daemon=True).start()

    def _serve_conn(self, sock: socket.socket):
        send_lock = make_lock("gcs.server_conn.send")
        push_cb = None
        reader = protocol.FrameReader(sock)
        try:
            while True:
                try:
                    msg = reader.recv_msg()
                except protocol.ProtocolError:
                    break  # desynced peer: drop the connection
                if msg is None:
                    break
                t = msg.get("t")
                if t == "request":
                    rid, op = msg["rid"], msg["op"]
                    if op in _BLOCKING_OPS:
                        # report-waiting gathers run OFF the conn thread:
                        # this connection must stay responsive for the
                        # caller's heartbeats and the node_query_report
                        # frames that complete the very gather (clients
                        # demux replies by rid, so ordering is free)
                        def run_blocking(rid=rid, op=op, msg=msg):
                            try:
                                value = getattr(self.core, op)(
                                    *msg.get("args", ()),
                                    **msg.get("kw", {}))
                                reply = {"t": "reply", "rid": rid,
                                         "ok": True, "value": value}
                            except Exception as e:  # noqa: BLE001
                                reply = {"t": "reply", "rid": rid,
                                         "ok": False, "error": e}
                            try:
                                protocol.send_msg(sock, reply, send_lock)
                            except OSError:
                                pass

                        threading.Thread(target=run_blocking,
                                         name=f"gcs-{op}",
                                         daemon=True).start()
                        continue
                    try:
                        if op == "subscribe":
                            node_id = msg.get("kw", {}).get(
                                "node_id", msg.get("node_id"))

                            def push_cb(event, data, _sl=send_lock, _s=sock):
                                try:
                                    protocol.send_msg(
                                        _s, {"t": "push", "event": event,
                                             "data": data}, _sl)
                                except OSError:
                                    pass

                            self.core.subscribe(push_cb, node_id)
                            value = True
                        elif op in _OPS:
                            value = getattr(self.core, op)(
                                *msg.get("args", ()), **msg.get("kw", {}))
                        else:
                            raise ValueError(f"unknown GCS op {op}")
                        protocol.send_msg(
                            sock, {"t": "reply", "rid": rid, "ok": True,
                                   "value": value}, send_lock)
                    except Exception as e:  # noqa: BLE001
                        try:
                            protocol.send_msg(
                                sock, {"t": "reply", "rid": rid, "ok": False,
                                       "error": e}, send_lock)
                        except OSError:
                            break
        finally:
            if push_cb is not None:
                self.core.unsubscribe(push_cb)
            try:
                sock.close()
            except OSError:
                pass

    def shutdown(self):
        self._stop = True
        self.core.stop()
        try:
            self._listener.close()
        except OSError:
            pass
        for s in self._conns:
            try:
                s.close()
            except OSError:
                pass


class GcsClient:
    """Socket client with the same method surface as GcsCore."""

    def __init__(self, address: str,
                 push_handler: Optional[Callable[[str, Any], None]] = None,
                 timeout: float = 10.0,
                 on_disconnect: Optional[Callable[[], None]] = None):
        host, port = address.rsplit(":", 1)
        self.address = address
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=timeout)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._send_lock = make_lock("gcs_client.send")
        self._rid = 0  # guard: _rid_lock
        self._rid_lock = make_lock("gcs_client.rid")
        self._pending: Dict[int, dict] = {}
        self._push_handler = push_handler
        self._on_disconnect = on_disconnect
        # Optional latency hook: called as (op, seconds) for every blocking
        # round-trip (the raylet wires it to its internal
        # ray_tpu_internal_gcs_rpc_latency_s histogram).
        self.rpc_observer: Optional[Callable[[str, float], None]] = None
        self._closed = False
        self._reader = threading.Thread(target=self._read_loop,
                                        name="gcs-client", daemon=True)
        self._reader.start()

    def _read_loop(self):
        reader = protocol.FrameReader(self._sock)
        while True:
            try:
                msg = reader.recv_msg()
            except (OSError, protocol.ProtocolError):
                msg = None
            if msg is None:
                was_closed = self._closed
                self._closed = True
                err = ConnectionError("GCS connection lost")
                for entry in list(self._pending.values()):
                    entry["msg"] = {"ok": False, "error": err}
                    entry["event"].set()
                if not was_closed and self._on_disconnect is not None:
                    try:
                        self._on_disconnect()
                    except Exception:  # noqa: BLE001
                        traceback.print_exc()
                return
            if msg.get("t") == "reply":
                entry = self._pending.pop(msg["rid"], None)
                if entry is not None:
                    entry["msg"] = msg
                    entry["event"].set()
            elif msg.get("t") == "push" and self._push_handler is not None:
                try:
                    self._push_handler(msg["event"], msg["data"])
                except Exception:  # noqa: BLE001
                    traceback.print_exc()

    def _call(self, op: str, /, *args, **kw):
        # `op` is positional-only: table ops take an `op=` KWARG of their
        # own (query_metrics op="rate") which must land in **kw, not
        # collide with the method-name parameter
        if self._closed:
            raise ConnectionError("GCS connection lost")
        from ray_tpu_torch.util import tracing as _tracing

        if _tracing.tracing_enabled() \
                and _tracing.current_trace_ctx() is not None:
            # a traced request is on this thread's stack: span the RPC
            # (GCS hops show up in the request waterfall, not just the
            # aggregate latency histogram)
            with _tracing.maybe_span(f"gcs.rpc {op}"):
                return self._call_inner(op, args, kw)
        return self._call_inner(op, args, kw)

    def _call_inner(self, op: str, args, kw):
        with self._rid_lock:
            self._rid += 1
            rid = self._rid
        entry = {"event": threading.Event(), "msg": None}
        self._pending[rid] = entry
        t0 = time.perf_counter()
        protocol.send_msg(
            self._sock,
            {"t": "request", "rid": rid, "op": op, "args": args, "kw": kw},
            self._send_lock)
        if not entry["event"].wait(60.0):
            self._pending.pop(rid, None)
            raise TimeoutError(f"GCS op {op} timed out")
        if self.rpc_observer is not None:
            try:
                self.rpc_observer(op, time.perf_counter() - t0)
            except Exception:  # noqa: BLE001
                pass
        msg = entry["msg"]
        if not msg["ok"]:
            raise msg["error"]
        return msg["value"]

    def post(self, op: str, *args, **kw):
        """Fire-and-forget: send the request without registering a pending
        reply (the server's reply is dropped by the reader).  For hot-path
        metadata updates (object locations, actor states) where a blocking
        round-trip from the raylet event thread would serialize completions
        on GCS latency."""
        if self._closed:
            raise ConnectionError("GCS connection lost")
        with self._rid_lock:
            self._rid += 1
            rid = self._rid
        protocol.send_msg(
            self._sock,
            {"t": "request", "rid": rid, "op": op, "args": args, "kw": kw},
            self._send_lock)

    def subscribe_remote(self, node_id: Optional[str] = None):
        return self._call("subscribe", node_id=node_id)

    def close(self):
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass

    def __getattr__(self, op):
        if op in _OPS:
            return lambda *a, **kw: self._call(op, *a, **kw)
        raise AttributeError(op)
