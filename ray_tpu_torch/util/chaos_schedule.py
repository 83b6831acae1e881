"""Seeded, replayable compound-fault chaos schedules + a cluster
invariant bank.

The primitives already exist — ``Cluster.remove_node`` (SIGKILL),
SIGSTOP partitions, ``restart_gcs``, graceful drain, the chaos control
file (frame drops / slow exec), and the memory-usage OOM seam.  What
was missing is COMPOSITION: real outages are compound (a node dies
while the GCS is restarting; a partition heals into a drain), and
one-fault-per-test suites never walk those interleavings.  This module
turns the primitives into randomized timelines:

* ``build_schedule(seed, ...)`` — the planned timeline is a PURE
  function of its arguments.  One ``random.Random(seed)`` drives event
  spacing, fault kind, target slot, and per-fault parameters, so the
  same seed yields a byte-identical JSONL serialization, forever.
  Faults with a duration get their paired heal event generated at plan
  time.
* ``ChaosRunner`` — executes a timeline against a ``Cluster`` while
  pluggable workload generators (lineage-heavy task fan-out, a
  checkpointed actor writing side-effect marker files, replicated
  put/get, optionally a small Serve app) run underneath.  Every
  executed event is appended to a JSONL log with its wall-clock time
  and outcome; ``load_timeline`` strips the execution-only fields so a
  failing run's log replays the identical fault sequence.
* ``check_invariants(cluster, ...)`` — after the schedule heals, the
  bank asserts what must hold no matter which faults fired:
  exactly-once side effects, no lost acked work, conservation of
  accounting, convergence to green, metrics consistent with the fault
  log, and (via ``chaos.assert_clean_host``) no leaked processes.
* MTTR — each disruptive fault gets a watcher that records
  fault → cluster green → first successful probe call, the
  recovery-latency number the soak reports per fault kind.

Events target worker SLOTS (indices into the cluster's worker-node
list), not node ids: killed or drained nodes respawn into their slot
(``Cluster.replace_node``), so a schedule stays meaningful across the
very faults it injects.

Reference analogue: Ray's chaos tests compose ``NodeKillerActor`` with
long-running workloads (`python/ray/_private/test_utils.py:1416`,
`release/nightly_tests/chaos_test/`); the invariant bank plays the role
their progress checks + ``ray memory`` leak audits play, made explicit.
"""

from __future__ import annotations

import gc
import json
import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core.config import config
from ray_tpu_torch.util.locks import make_lock

__all__ = [
    "FAULT_KINDS", "MTTR_KINDS", "build_schedule", "timeline_to_jsonl",
    "write_timeline", "load_timeline", "Workload", "TaskFanoutWorkload",
    "ActorMarkerWorkload", "PutGetWorkload", "ServeWorkload",
    "ChaosRunner", "check_invariants", "check_converged",
    "check_acked_durable", "check_exactly_once", "check_accounting",
    "check_refs_drained", "check_metrics_consistent", "check_alerts_quiet",
    "render_report",
]

config.define("chaos_schedule_min_gap_s", float, 2.0,
              "Chaos schedules: minimum seconds between consecutive "
              "injected faults.  Spacing is drawn uniformly from "
              "[min_gap, max_gap] by the schedule's seeded RNG.")
config.define("chaos_schedule_max_gap_s", float, 6.0,
              "Chaos schedules: maximum seconds between consecutive "
              "injected faults.")
config.define("chaos_mttr_timeout_s", float, 90.0,
              "Chaos runner: how long an MTTR watcher waits for the "
              "cluster to return to green and serve a probe call after "
              "a fault before recording the recovery as timed out.")
config.define("chaos_soak_seed", int, 0,
              "Randomized soak (tests/test_chaos_schedule.py, slow tier): "
              "schedule seed.  CI varies it per run; a failure report "
              "names the seed so the exact timeline replays locally.")
config.define("chaos_soak_duration_s", float, 600.0,
              "Randomized soak: fault-injection window in seconds.")
config.define("chaos_quiesce_timeout_s", float, 60.0,
              "Invariant bank: how long convergence-to-green may take "
              "after the last fault heals before it counts as a "
              "violation (covers suspicion timeouts, reconstruction, "
              "and replication repair catching up).")

# ---------------------------------------------------------------------------
# schedule building + (de)serialization
# ---------------------------------------------------------------------------

#: Primary fault kinds a schedule can draw from.
FAULT_KINDS: Tuple[str, ...] = (
    "node_kill", "partition", "gcs_restart", "drain", "slow_exec", "oom")

#: Kinds that get an MTTR watcher (disruptive enough to dent the cluster).
MTTR_KINDS = frozenset(("node_kill", "partition", "gcs_restart", "drain",
                        "oom"))

#: Fault kind -> its paired heal event kind (generated at plan time).
_HEAL_OF = {"partition": "heal_partition", "slow_exec": "heal_slow_exec",
            "oom": "heal_oom"}

#: Keys a planned event carries.  Everything else on a logged event is
#: execution-only and stripped by ``load_timeline`` so replays are exact.
_PLAN_KEYS = ("idx", "t_s", "kind", "slot", "params")


def build_schedule(seed: int, duration_s: float,
                   faults: Sequence[str] = FAULT_KINDS,
                   n_slots: int = 2,
                   min_gap_s: Optional[float] = None,
                   max_gap_s: Optional[float] = None) -> List[dict]:
    """Deterministic fault timeline: a pure function of its arguments.

    One seeded RNG drives everything — spacing, kind, slot, params — in
    a fixed draw order, so equal inputs give byte-identical timelines.
    Faults with a duration (partition / slow_exec / oom) get their heal
    event appended at ``t + duration`` before the final time-sort.
    """
    for f in faults:
        if f not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {f!r} "
                             f"(choose from {FAULT_KINDS})")
    if n_slots < 1:
        raise ValueError("n_slots must be >= 1")
    lo = config.chaos_schedule_min_gap_s if min_gap_s is None else min_gap_s
    hi = config.chaos_schedule_max_gap_s if max_gap_s is None else max_gap_s
    rng = random.Random(seed)
    events: List[dict] = []
    seq = 0
    t = 0.0
    while True:
        t += rng.uniform(lo, max(lo, hi))
        if t >= duration_s:
            break
        kind = faults[rng.randrange(len(faults))]
        slot = rng.randrange(n_slots)
        params: Dict[str, Any] = {}
        if kind == "partition":
            params["duration_s"] = round(rng.uniform(1.5, 4.0), 3)
        elif kind == "slow_exec":
            params["delay_ms"] = (50, 150, 400)[rng.randrange(3)]
            params["p"] = round(rng.uniform(0.5, 1.0), 3)
            params["duration_s"] = round(rng.uniform(2.0, 6.0), 3)
        elif kind == "oom":
            params["usage"] = round(rng.uniform(0.95, 0.99), 3)
            params["duration_s"] = round(rng.uniform(1.0, 3.0), 3)
        elif kind == "drain":
            params["timeout_s"] = round(rng.uniform(3.0, 8.0), 3)
        ev = {"t_s": round(t, 3), "kind": kind, "slot": slot,
              "params": params, "_seq": seq}
        seq += 1
        events.append(ev)
        heal = _HEAL_OF.get(kind)
        if heal:
            events.append({"t_s": round(t + params["duration_s"], 3),
                           "kind": heal, "slot": slot, "params": {},
                           "_seq": seq})
            seq += 1
    # Stable order: by time, ties broken by creation order (so a heal
    # landing exactly on another event's time sorts deterministically).
    events.sort(key=lambda e: (e["t_s"], e["_seq"]))
    for i, ev in enumerate(events):
        del ev["_seq"]
        ev["idx"] = i
    return events


def timeline_to_jsonl(events: Sequence[dict]) -> str:
    """Canonical serialization — sorted keys, no whitespace — so equal
    timelines are byte-identical strings (the determinism contract)."""
    return "".join(
        json.dumps({k: ev[k] for k in _PLAN_KEYS}, sort_keys=True,
                   separators=(",", ":")) + "\n"
        for ev in events)


def write_timeline(events: Sequence[dict], path: str) -> None:
    with open(path, "w") as f:
        f.write(timeline_to_jsonl(events))


def load_timeline(path: str) -> List[dict]:
    """Load a timeline (planned OR executed log): execution-only fields
    are stripped so a failing run's log replays the identical faults."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if not all(k in rec for k in _PLAN_KEYS):
                continue  # MTTR / summary records interleaved in a log
            events.append({k: rec[k] for k in _PLAN_KEYS})
    events.sort(key=lambda e: e["idx"])
    return events


# ---------------------------------------------------------------------------
# workload generators
# ---------------------------------------------------------------------------

def _lineage_leaf(k, n):
    import numpy as np

    return np.full(n, k, dtype=np.int64)


def _lineage_sum(arr):
    return int(arr.sum())


def _probe_fn(x):
    return 2 * x


class _MarkerActor:
    """Checkpointed counter whose every bump leaves a side-effect marker
    file — the exactly-once witness.  A tag written twice means some
    layer re-executed work it had already acknowledged."""

    def __init__(self, marker_dir):
        self.marker_dir = marker_dir
        self.n = 0

    def bump(self, tag):
        with open(os.path.join(self.marker_dir, tag), "a") as f:
            f.write("x")
        self.n += 1
        return self.n

    def __ray_save__(self):
        return self.n

    def __ray_restore__(self, state):
        self.n = state


class Workload:
    """Base workload: a driver-side submit loop with strict accounting.

    Subclasses implement ``_step(seq)`` (submit one unit, return
    ``(ref, expected)``) and optionally ``_check(value, expected)``.
    The base loop classifies every submission exactly once —
    succeeded / failed / cancelled / pending — so the invariant bank
    can reconcile totals after the storm."""

    name = "workload"
    interval_s = 0.08
    # Short enough that a fault-stalled get parks the unit in _inflight
    # (resolved at quiesce) instead of freezing the submit loop for the
    # rest of the storm.
    get_timeout_s = 5.0
    max_retained = 48

    def __init__(self, placement_resources: Optional[Dict[str, float]]
                 = None):
        # Pin the workload's tasks/actors onto the killable worker slots
        # (a custom resource the head node doesn't have) — otherwise the
        # scheduler happily parks everything on the never-faulted head
        # and the storm tests nothing.
        self.placement_resources = placement_resources
        self._lock = make_lock(f"chaos.wl.{self.name}")
        # guard: _lock — counters + retained acked (ref, expected) pairs
        self.counts = {"submitted": 0, "succeeded": 0, "failed": 0,
                       "cancelled": 0}
        self.acked: List[Tuple[Any, Any]] = []
        self._inflight: List[Tuple[Any, Any]] = []
        self.errors: List[str] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------
    def start(self) -> None:
        self._setup()
        self._thread = threading.Thread(
            target=self._loop, name=f"chaos-wl-{self.name}", daemon=True)
        self._thread.start()

    def stop_submitting(self) -> None:
        self._stop.set()

    def quiesce(self, timeout_s: float = 60.0) -> None:
        """Join the submit loop, then resolve every still-pending ref —
        after this, ``pending`` must be 0 or accounting is broken."""
        import ray_tpu_torch

        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout_s)
        deadline = time.monotonic() + timeout_s
        with self._lock:
            pending, self._inflight = self._inflight, []
        for ref, expected in pending:
            budget = max(1.0, deadline - time.monotonic())
            try:
                value = ray_tpu_torch.get(ref, timeout=budget)
                self._classify_success(ref, value, expected)
            except ray_tpu_torch.TaskCancelledError:
                self._count("cancelled")
            except Exception as e:  # noqa: BLE001 — any loss is 'failed'
                self._count("failed", note=type(e).__name__)

    def release(self) -> None:
        """Drop every retained ref (durability witnesses included) so the
        conservation check can watch the driver's ref table drain."""
        with self._lock:
            self.acked = []
            self._inflight = []

    # -- submit loop --------------------------------------------------
    def _setup(self) -> None:
        """Hook: build remote functions/actors (runs before the loop)."""

    def _step(self, seq: int):
        raise NotImplementedError

    def _check(self, value, expected) -> bool:
        return expected is None or value == expected

    def _loop(self) -> None:
        import ray_tpu_torch

        seq = 0
        while not self._stop.is_set():
            try:
                ref, expected = self._step(seq)
            except Exception as e:  # noqa: BLE001 — submit-side failure
                self._count("submitted")
                self._count("failed", note=f"submit:{type(e).__name__}")
                self._stop.wait(self.interval_s * 4)
                seq += 1
                continue
            self._count("submitted")
            try:
                value = ray_tpu_torch.get(ref, timeout=self.get_timeout_s)
                self._classify_success(ref, value, expected)
            except ray_tpu_torch.GetTimeoutError:
                with self._lock:
                    self._inflight.append((ref, expected))
            except ray_tpu_torch.TaskCancelledError:
                self._count("cancelled")
            except Exception as e:  # noqa: BLE001 — fault-induced loss
                self._count("failed", note=type(e).__name__)
            seq += 1
            self._stop.wait(self.interval_s)

    def _classify_success(self, ref, value, expected) -> None:
        if self._check(value, expected):
            with self._lock:
                self.counts["succeeded"] += 1
                self.acked.append((ref, expected))
                if len(self.acked) > self.max_retained:
                    self.acked.pop(0)
        else:
            self._count("failed", note="wrong value")

    def _count(self, key: str, note: Optional[str] = None) -> None:
        with self._lock:
            self.counts[key] += 1
            if note and len(self.errors) < 200:
                self.errors.append(note)

    # -- invariant feeds ----------------------------------------------
    def account(self) -> dict:
        with self._lock:
            out = dict(self.counts)
            out["pending"] = (out["submitted"] - out["succeeded"]
                              - out["failed"] - out["cancelled"]
                              - len(self._inflight))
            out["inflight"] = len(self._inflight)
            return out

    def recheck_acked(self, timeout_s: float = 45.0) -> List[str]:
        """No lost acked work: every ref the driver successfully got
        during the storm must STILL resolve to the same value (possibly
        via reconstruction / replication repair)."""
        import ray_tpu_torch

        with self._lock:
            snapshot = list(self.acked)
        violations = []
        deadline = time.monotonic() + timeout_s
        for ref, expected in snapshot:
            budget = max(2.0, deadline - time.monotonic())
            try:
                value = ray_tpu_torch.get(ref, timeout=budget)
            except Exception as e:  # noqa: BLE001 — acked data is gone
                violations.append(
                    f"{self.name}: acked ref {ref} lost "
                    f"({type(e).__name__}: {e})")
                continue
            if not self._check(value, expected):
                violations.append(
                    f"{self.name}: acked ref {ref} changed value "
                    f"(expected {expected!r})")
        return violations

    def marker_violations(self) -> List[str]:
        """Hook: exactly-once witnesses (only marker workloads have any)."""
        return []

    def tracked_oids(self) -> set:
        with self._lock:
            return {ref._id for ref, _ in self.acked
                    if hasattr(ref, "_id")}


class TaskFanoutWorkload(Workload):
    """Lineage-heavy fan-out: leaf produces a store-sized array, a child
    task reduces it.  Kills exercise lineage reconstruction; the
    retained leaf SUMS are the durability witnesses.  Every 13th
    submission is cancelled immediately — cancellation outcomes must
    still reconcile in the accounting check."""

    name = "fanout"
    payload_n = 32768  # 256 KiB of int64 — above the inline threshold

    def _setup(self) -> None:
        import ray_tpu_torch

        opts = {"max_retries": 8}
        if self.placement_resources:
            opts["resources"] = dict(self.placement_resources)
        self._leaf = ray_tpu_torch.remote(**opts)(_lineage_leaf)
        self._sum = ray_tpu_torch.remote(**opts)(_lineage_sum)

    def _step(self, seq: int):
        import ray_tpu_torch

        k = seq % 97 + 1
        leaf = self._leaf.remote(k, self.payload_n)
        ref = self._sum.remote(leaf)
        if seq % 13 == 5:
            ray_tpu_torch.cancel(ref, recursive=True)
        return ref, k * self.payload_n


class ActorMarkerWorkload(Workload):
    """Checkpointed counter actor whose bumps write marker files — each
    call uses a FRESH tag (never reused on retry), so the filesystem is
    an exactly-once ledger: an acked tag must have exactly one marker
    byte, and ANY tag with two means double execution."""

    name = "marker"
    interval_s = 0.10
    get_timeout_s = 6.0

    def __init__(self, marker_dir: str,
                 placement_resources: Optional[Dict[str, float]] = None):
        super().__init__(placement_resources)
        self.marker_dir = marker_dir
        self.acked_tags: List[str] = []  # guard: _lock

    def _setup(self) -> None:
        import ray_tpu_torch

        os.makedirs(self.marker_dir, exist_ok=True)
        opts = {"max_restarts": 50, "checkpoint_interval": 5}
        if self.placement_resources:
            opts["resources"] = dict(self.placement_resources)
        cls = ray_tpu_torch.remote(**opts)(_MarkerActor)
        self._actor = cls.remote(self.marker_dir)

    def _step(self, seq: int):
        tag = f"{self.name}-{seq:06d}"
        ref = self._actor.bump.remote(tag)
        return ref, ("tag", tag)

    def _check(self, value, expected) -> bool:
        if isinstance(expected, tuple) and expected[0] == "tag":
            with self._lock:
                self.acked_tags.append(expected[1])
            return isinstance(value, int) and value >= 1
        return True

    def recheck_acked(self, timeout_s: float = 45.0) -> List[str]:
        # Actor-call returns are small ints delivered inline; the durable
        # witness here is the marker ledger, checked separately.
        return []

    def marker_violations(self) -> List[str]:
        with self._lock:
            acked = list(self.acked_tags)
        violations = []
        sizes: Dict[str, int] = {}
        try:
            names = os.listdir(self.marker_dir)
        except OSError:
            return [f"{self.name}: marker dir vanished"]
        for fname in names:
            if not fname.startswith(self.name + "-"):
                continue
            try:
                sizes[fname] = os.path.getsize(
                    os.path.join(self.marker_dir, fname))
            except OSError:
                sizes[fname] = -1
        for tag, size in sorted(sizes.items()):
            if size > 1:
                violations.append(
                    f"{self.name}: tag {tag} executed {size} times "
                    f"(exactly-once violated)")
        for tag in acked:
            if sizes.get(tag, 0) != 1:
                violations.append(
                    f"{self.name}: acked tag {tag} has "
                    f"{sizes.get(tag, 0)} marker bytes (want exactly 1)")
        return violations


class PutGetWorkload(Workload):
    """Replicated driver puts — exercises the replication/repair path;
    retained (ref, checksum) pairs feed the durability check."""

    name = "putget"
    interval_s = 0.12
    get_timeout_s = 5.0
    payload_n = 16384

    def _step(self, seq: int):
        import numpy as np
        import ray_tpu_torch

        k = seq % 251
        arr = np.full(self.payload_n, k, dtype=np.int64)
        ref = ray_tpu_torch.put(arr, _replicate=True)
        return ref, k * self.payload_n

    def _check(self, value, expected) -> bool:
        try:
            return int(value.sum()) == expected
        except AttributeError:
            return False


class ServeWorkload(Workload):
    """A one-replica Serve echo app under fire — admission, routing, and
    controller recovery all in the blast radius.  Shed/timeout responses
    count as ``failed`` and must still reconcile."""

    name = "serve"
    interval_s = 0.15
    get_timeout_s = 6.0

    def _setup(self) -> None:
        from ray_tpu_torch import serve

        self._serve = serve
        serve.start()

        @serve.deployment(name="chaos_echo")
        def chaos_echo(req):
            return {"v": req["v"]}

        self._handle = serve.run(chaos_echo.bind(),
                                 route_prefix="/chaos_echo")

    def _step(self, seq: int):
        ref = self._handle.remote({"v": seq})
        return ref, {"v": seq}

    def recheck_acked(self, timeout_s: float = 45.0) -> List[str]:
        # Serve responses are request/reply, not durable objects.
        return []

    def release(self) -> None:
        super().release()
        try:
            self._serve.delete("chaos_echo")
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

class ChaosRunner:
    """Execute a fault timeline against a ``Cluster`` while workloads
    run, logging each event (JSONL) and recording per-fault MTTR.

    The cluster must be built with ``chaos_control_file=`` (slow-exec
    steering) and, for ``oom`` faults, ``memory_usage_file=``; faults
    needing an absent seam are skipped and logged as such rather than
    silently dropped."""

    def __init__(self, cluster, events: Sequence[dict],
                 workloads: Sequence[Workload],
                 control_file: Optional[str] = None,
                 memory_file: Optional[str] = None,
                 log_path: Optional[str] = None,
                 mttr_timeout_s: Optional[float] = None,
                 time_scale: float = 1.0,
                 probe_resources: Optional[Dict[str, float]] = None):
        self.cluster = cluster
        self.events = [dict(ev) for ev in events]
        self.workloads = list(workloads)
        self.control_file = control_file
        self.memory_file = memory_file
        self.log_path = log_path
        self.time_scale = time_scale
        self.mttr_timeout_s = (config.chaos_mttr_timeout_s
                               if mttr_timeout_s is None else mttr_timeout_s)
        # Worker slots: every node except the head.  Slot index is the
        # schedule's addressing unit; ``replace_node`` keeps it stable.
        self.slots = [n for n in cluster.nodes
                      if n is not getattr(cluster, "head_node", None)]
        if not self.slots:
            raise ValueError("need at least one non-head worker node")
        self.executed: List[dict] = []
        self.mttr: Dict[str, List[float]] = {}   # guard: _lock
        self._lock = make_lock("chaos.runner")
        self._paused: set = set()                # guard: _lock
        self._watchers: List[threading.Thread] = []
        self._log_fh = open(log_path, "w") if log_path else None
        self.probe_resources = probe_resources
        self._probe = None

    # -- event log ----------------------------------------------------
    def _log(self, rec: dict) -> None:
        if self._log_fh is not None:
            self._log_fh.write(json.dumps(rec, sort_keys=True,
                                          separators=(",", ":")) + "\n")
            self._log_fh.flush()

    # -- control/memory file seams ------------------------------------
    def _write_ctrl(self, spec: dict) -> None:
        tmp = self.control_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump(spec, f)
        os.replace(tmp, self.control_file)

    def _write_mem(self, usage: float) -> None:
        tmp = self.memory_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(usage))
        os.replace(tmp, self.memory_file)

    # -- fault dispatch -----------------------------------------------
    def _slot_node(self, slot: int):
        return self.slots[slot % len(self.slots)]

    def _inject(self, ev: dict) -> Tuple[bool, str]:
        kind, slot = ev["kind"], ev["slot"]
        params = ev.get("params") or {}
        node = self._slot_node(slot)
        if kind == "node_kill":
            new = self.cluster.replace_node(node)
            self.slots[slot % len(self.slots)] = new
            with self._lock:
                self._paused.discard(node)
            return True, f"killed {node.node_id[:8]} -> {new.node_id[:8]}"
        if kind == "partition":
            self.cluster.pause_node(node)
            with self._lock:
                self._paused.add(node)
            return True, f"paused {node.node_id[:8]}"
        if kind == "heal_partition":
            self.cluster.resume_node(node)
            with self._lock:
                self._paused.discard(node)
            return True, f"resumed {node.node_id[:8]}"
        if kind == "gcs_restart":
            if not getattr(self.cluster, "_gcs_persist", None):
                return False, "skipped: cluster has no gcs_persist_path"
            self.cluster.restart_gcs()
            return True, "gcs restarted"
        if kind == "drain":
            return self._inject_drain(node, slot, params)
        if kind == "slow_exec":
            if not self.control_file:
                return False, "skipped: no chaos control file"
            self._write_ctrl({"exec_delay": {
                "ms": params.get("delay_ms", 100),
                "p": params.get("p", 1.0), "names": ""}})
            return True, f"slow exec {params.get('delay_ms')}ms"
        if kind == "heal_slow_exec":
            if not self.control_file:
                return False, "skipped: no chaos control file"
            self._write_ctrl({})
            return True, "slow exec off"
        if kind == "oom":
            if not self.memory_file:
                return False, "skipped: no memory usage file"
            self._write_mem(params.get("usage", 0.97))
            return True, f"memory pressure {params.get('usage', 0.97)}"
        if kind == "heal_oom":
            if not self.memory_file:
                return False, "skipped: no memory usage file"
            self._write_mem(0.0)
            return True, "memory pressure off"
        return False, f"unknown fault kind {kind!r}"

    def _inject_drain(self, node, slot: int, params: dict):
        from ray_tpu_torch.core.gcs import GcsClient

        timeout_s = params.get("timeout_s", 5.0)
        try:
            cli = GcsClient(self.cluster.address)
        except (ConnectionError, OSError) as e:
            return False, f"drain rpc failed: {e}"
        try:
            cli.drain_node(node.node_id, timeout_s=timeout_s)
        except Exception as e:  # noqa: BLE001 — e.g. node already dead
            cli.close()
            return False, f"drain rejected: {type(e).__name__}: {e}"

        def _await_drain():
            # joined-by: ChaosRunner.run (watchers list)
            deadline = time.monotonic() + timeout_s + 15.0
            state = "draining"
            while time.monotonic() < deadline:
                try:
                    state = cli.drain_status(node.node_id).get("state")
                except (ConnectionError, OSError):
                    break
                if state not in ("draining",):
                    break
                time.sleep(0.25)
            cli.close()
            # Drained node is spent — respawn its slot so the schedule
            # keeps its target count (a real autoscaler would do this).
            new = self.cluster.replace_node(node)
            with self._lock:
                self.slots[slot % len(self.slots)] = new
                self._paused.discard(node)

        t = threading.Thread(target=_await_drain,
                             name=f"chaos-drain-{node.node_id[:8]}",
                             daemon=True)
        t.start()
        self._watchers.append(t)
        return True, f"draining {node.node_id[:8]}"

    # -- recovery observation -----------------------------------------
    def _cluster_green(self) -> bool:
        from ray_tpu_torch.core.gcs import GcsClient

        try:
            cli = GcsClient(self.cluster.address)
        except (ConnectionError, OSError):
            return False
        try:
            rows = [r for r in cli.nodes() if r.get("alive")]
            # Green means the CURRENT membership is alive — a killed
            # node's stale not-yet-declared-dead row must not count for
            # its replacement (that would zero out every MTTR reading).
            alive = {r["node_id"] for r in rows}
            want = {n.node_id for n in self.cluster.nodes}
            if not want <= alive:
                return False
            return not any(r.get("suspect") or r.get("draining")
                           for r in rows)
        except (ConnectionError, TimeoutError, OSError):
            return False
        finally:
            try:
                cli.close()
            except OSError:
                pass

    def _spawn_mttr_watcher(self, rec: dict) -> None:
        import ray_tpu_torch

        if self._probe is None:
            opts = {"num_cpus": 0.01, "max_retries": 16}
            if self.probe_resources:
                opts["resources"] = dict(self.probe_resources)
            self._probe = ray_tpu_torch.remote(**opts)(_probe_fn)
        t_fault = time.monotonic()
        kind, idx = rec["kind"], rec["idx"]

        def _watch():
            # joined-by: ChaosRunner.run (watchers list)
            deadline = t_fault + self.mttr_timeout_s
            while time.monotonic() < deadline:
                if self._cluster_green():
                    break
                time.sleep(0.25)
            else:
                rec["mttr_s"] = None
                self._log({"idx": idx, "kind": kind, "mttr_s": None})
                return
            while time.monotonic() < deadline:
                try:
                    if ray_tpu_torch.get(self._probe.remote(idx), timeout=5) \
                            == 2 * idx:
                        mttr = round(time.monotonic() - t_fault, 3)
                        rec["mttr_s"] = mttr
                        with self._lock:
                            self.mttr.setdefault(kind, []).append(mttr)
                        self._log({"idx": idx, "kind": kind,
                                   "mttr_s": mttr})
                        return
                except Exception:  # noqa: BLE001 — still recovering
                    pass
                time.sleep(0.25)
            rec["mttr_s"] = None
            self._log({"idx": idx, "kind": kind, "mttr_s": None})

        t = threading.Thread(target=_watch, name=f"chaos-mttr-{idx}",
                             daemon=True)
        t.start()
        self._watchers.append(t)

    # -- main loop ----------------------------------------------------
    def heal_all(self) -> None:
        """Lift every still-standing fault (end of schedule or abort)."""
        with self._lock:
            paused = list(self._paused)
            self._paused.clear()
        for node in paused:
            try:
                self.cluster.resume_node(node)
            except OSError:
                pass
        if self.control_file:
            self._write_ctrl({})
        if self.memory_file:
            self._write_mem(0.0)

    def run(self, quiesce_timeout_s: Optional[float] = None) -> dict:
        """Start workloads, walk the timeline, heal, quiesce, and run the
        invariant bank.  Returns the report (see ``check_invariants``),
        augmented with the executed log and per-kind MTTR stats."""
        if self.control_file:
            self._write_ctrl({})
        if self.memory_file:
            self._write_mem(0.0)
        for w in self.workloads:
            w.start()
        t0 = time.monotonic()
        try:
            for ev in self.events:
                target = t0 + ev["t_s"] * self.time_scale
                delay = target - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                try:
                    ok, detail = self._inject(ev)
                except Exception as e:  # noqa: BLE001 — log, keep going
                    ok, detail = False, f"{type(e).__name__}: {e}"
                rec = dict(ev)
                rec["t_wall"] = round(time.monotonic() - t0, 3)
                rec["ok"] = ok
                rec["detail"] = detail
                self.executed.append(rec)
                self._log(rec)
                if ok and ev["kind"] in MTTR_KINDS:
                    self._spawn_mttr_watcher(rec)
        finally:
            self.heal_all()
        for w in self.workloads:
            w.stop_submitting()
        for w in self.workloads:
            w.quiesce()
        join_deadline = time.monotonic() + self.mttr_timeout_s + 10.0
        for t in self._watchers:
            t.join(max(0.5, join_deadline - time.monotonic()))
        report = check_invariants(
            self.cluster, workloads=self.workloads,
            fault_log=self.executed,
            quiesce_timeout_s=quiesce_timeout_s)
        report["mttr_s"] = self.mttr_summary()
        report["events_executed"] = len(self.executed)
        self._log({"report": {k: report[k] for k in
                              ("ok", "violations", "mttr_s")}})
        if self._log_fh is not None:
            self._log_fh.close()
            self._log_fh = None
        return report

    def mttr_summary(self) -> Dict[str, dict]:
        with self._lock:
            snapshot = {k: list(v) for k, v in self.mttr.items()}
        out = {}
        timeouts = {}
        for rec in self.executed:
            if rec.get("ok") and rec["kind"] in MTTR_KINDS \
                    and rec.get("mttr_s", "absent") is None:
                timeouts[rec["kind"]] = timeouts.get(rec["kind"], 0) + 1
        for kind, samples in sorted(snapshot.items()):
            out[kind] = {"n": len(samples),
                         "mean_s": round(sum(samples) / len(samples), 3),
                         "max_s": round(max(samples), 3),
                         "timeouts": timeouts.get(kind, 0)}
        for kind, n in timeouts.items():
            out.setdefault(kind, {"n": 0, "mean_s": None, "max_s": None,
                                  "timeouts": n})
        return out


# ---------------------------------------------------------------------------
# the invariant bank
# ---------------------------------------------------------------------------

def _checker(name: str, fn: Callable[[], Tuple[bool, str]]) -> dict:
    try:
        ok, detail = fn()
    except Exception as e:  # noqa: BLE001 — a crashed checker is a failure
        ok, detail = False, f"checker crashed: {type(e).__name__}: {e}"
    return {"name": name, "ok": bool(ok), "detail": detail}


def check_converged(cluster, timeout_s: Optional[float] = None) -> dict:
    """Convergence to green: all expected nodes ALIVE, none stuck
    SUSPECT or DRAINING, within the quiesce window."""
    from ray_tpu_torch.core.gcs import GcsClient

    budget = (config.chaos_quiesce_timeout_s
              if timeout_s is None else timeout_s)

    def _run():
        deadline = time.monotonic() + budget
        last = "no gcs contact"
        while time.monotonic() < deadline:
            try:
                cli = GcsClient(cluster.address)
            except (ConnectionError, OSError) as e:
                last = f"gcs unreachable: {e}"
                time.sleep(0.25)
                continue
            try:
                rows = [r for r in cli.nodes() if r.get("alive")]
                bad = [r["node_id"][:8] for r in rows
                       if r.get("suspect") or r.get("draining")]
                alive = {r["node_id"] for r in rows}
                want = {n.node_id for n in cluster.nodes}
                missing = [nid[:8] for nid in want - alive]
                if not missing and not bad:
                    return True, (f"{len(rows)} alive, 0 suspect, "
                                  f"0 draining")
                last = (f"{len(alive)} alive, missing={missing}, "
                        f"stragglers={bad}")
            except (ConnectionError, TimeoutError, OSError) as e:
                last = f"gcs query failed: {e}"
            finally:
                try:
                    cli.close()
                except OSError:
                    pass
            time.sleep(0.25)
        return False, f"not green after {budget}s: {last}"

    return _checker("converged_green", _run)


def check_acked_durable(workloads: Sequence[Workload],
                        timeout_s: float = 45.0) -> dict:
    """No lost acked work: every get() that resolved during the storm
    still resolves (reconstruction / replication count as resolving)."""
    def _run():
        violations = []
        total = 0
        for w in workloads:
            total += len(w.acked)
            violations += w.recheck_acked(timeout_s)
        if violations:
            return False, "; ".join(violations[:10])
        return True, f"{total} retained acked refs all re-resolved"

    return _checker("acked_durable", _run)


def check_exactly_once(workloads: Sequence[Workload]) -> dict:
    """Exactly-once side effects: no marker tag written twice; every
    acked tag written exactly once."""
    def _run():
        violations = []
        for w in workloads:
            violations += w.marker_violations()
        if violations:
            return False, "; ".join(violations[:10])
        return True, "marker ledger clean"

    return _checker("exactly_once", _run)


def check_accounting(workloads: Sequence[Workload]) -> dict:
    """Conservation of accounting: every submission is classified
    exactly once — succeeded + failed + cancelled == submitted, nothing
    pending after quiesce."""
    def _run():
        problems = []
        detail = []
        for w in workloads:
            a = w.account()
            detail.append(f"{w.name}:{a}")
            if a["pending"] != 0 or a["inflight"] != 0:
                problems.append(
                    f"{w.name}: {a['pending']} unclassified + "
                    f"{a['inflight']} inflight of {a['submitted']}")
            if a["submitted"] == 0:
                problems.append(f"{w.name}: submitted nothing "
                                f"(workload never ran)")
        if problems:
            return False, "; ".join(problems)
        return True, " ".join(detail)

    return _checker("accounting", _run)


def check_refs_drained(workloads: Sequence[Workload],
                       grace_s: float = 10.0) -> dict:
    """Ref-count conservation: once the workloads drop their retained
    refs, the driver's ref table must forget those objects (a surviving
    entry is a leaked reference)."""
    def _run():
        tracked = set()
        for w in workloads:
            tracked |= w.tracked_oids()
            w.release()
        gc.collect()
        from ray_tpu_torch.core import worker as worker_mod

        deadline = time.monotonic() + grace_s
        leaked = tracked
        while True:
            with worker_mod._ref_lock:
                leaked = tracked & set(worker_mod._ref_counts)
            if not leaked:
                return True, f"{len(tracked)} refs drained"
            if time.monotonic() >= deadline:
                break
            time.sleep(0.2)
        return False, (f"{len(leaked)} of {len(tracked)} released refs "
                       f"still in the driver ref table")

    return _checker("refs_drained", _run)


def check_metrics_consistent(fault_log: Sequence[dict]) -> dict:
    """Recovery metrics must be explainable by the fault log: lineage
    reconstruction with no destructive fault in the log means the
    runtime lost data on its own."""
    def _run():
        destructive = {"node_kill", "partition", "oom", "gcs_restart"}
        injected = {ev["kind"] for ev in fault_log if ev.get("ok", True)}
        failed_drain = any(
            ev["kind"] == "drain" and ev.get("ok", True)
            and "drained" not in str(ev.get("detail", ""))
            for ev in fault_log)
        from ray_tpu_torch.util import state as state_api
        from ray_tpu_torch.util.metrics_query import sum_deltas

        res = state_api.query_metrics(
            "ray_tpu_internal_reconstruction_attempts_total", op="range")
        if res is None:
            return True, "no metrics table (local mode)"
        attempts = sum_deltas(res.get("points", ()))
        if attempts > 0 and not (injected & destructive) \
                and not failed_drain:
            return False, (f"{attempts:.0f} reconstruction attempts but "
                           f"the fault log has no destructive fault "
                           f"(injected: {sorted(injected)})")
        return True, (f"{attempts:.0f} reconstruction attempts, "
                      f"faults: {sorted(injected)}")

    return _checker("metrics_consistent", _run)


#: Alert rules a fault kind legitimately trips (windows are 60–300 s, so
#: they can still be firing right after quiesce).  Info-severity export
#: overflow alerts are always excusable — observability pressure, not a
#: correctness signal.
ALLOWED_ALERTS_BY_FAULT: Dict[str, frozenset] = {
    "node_kill": frozenset(("replication_repair_pressure",
                            "false_suspect_rate")),
    "partition": frozenset(("false_suspect_rate", "fenced_frame_spike",
                            "replication_repair_pressure")),
    "gcs_restart": frozenset(("fenced_frame_spike", "false_suspect_rate")),
    "oom": frozenset(("replication_repair_pressure",)),
    "drain": frozenset(("replication_repair_pressure",)),
    "slow_exec": frozenset(("serve_p99_latency", "serve_shed_burn")),
}
_ALWAYS_EXCUSED_ALERTS = frozenset((
    "task_event_drops", "trace_span_drops", "profile_sample_drops",
    "metric_point_drops"))


def check_alerts_quiet(fault_log: Sequence[dict]) -> dict:
    """No firing alerts after quiesce — except those attributable to the
    faults we injected (their rule windows outlive the storm)."""
    def _run():
        from ray_tpu_torch.util import state as state_api

        res = state_api.list_alerts(state="firing")
        if res is None:
            return True, "no alert engine (local mode)"
        firing = res.get("firing", ())
        allowed = set(_ALWAYS_EXCUSED_ALERTS)
        for ev in fault_log:
            if ev.get("ok", True):
                allowed |= ALLOWED_ALERTS_BY_FAULT.get(ev["kind"],
                                                       frozenset())
        bad = [a for a in firing if a.get("rule") not in allowed]
        if bad:
            names = sorted({a.get("rule") or "?" for a in bad})
            return False, f"unexplained firing alerts: {names}"
        excused = sorted({a.get("rule") or "?" for a in firing})
        return True, (f"{len(firing)} firing, all excused by fault log "
                      f"({excused})" if firing else "no firing alerts")

    return _checker("alerts_quiet", _run)


def check_invariants(cluster, workloads: Sequence[Workload] = (),
                     fault_log: Sequence[dict] = (),
                     quiesce_timeout_s: Optional[float] = None) -> dict:
    """Run the full bank.  Order matters: convergence first (the other
    checks assume a green cluster can serve gets), durability before
    ``refs_drained`` (which releases the witnesses)."""
    checks = [
        check_converged(cluster, quiesce_timeout_s),
        check_acked_durable(workloads),
        check_exactly_once(workloads),
        check_accounting(workloads),
        check_metrics_consistent(fault_log),
        check_alerts_quiet(fault_log),
        check_refs_drained(workloads),
    ]
    violations = [c["name"] for c in checks if not c["ok"]]
    return {"ok": not violations, "checks": checks,
            "violations": violations}


def render_report(report: dict) -> str:
    """Human-readable invariant + MTTR report (the CLI's output)."""
    lines = ["chaos invariant report",
             "======================"]
    for c in report["checks"]:
        mark = "PASS" if c["ok"] else "FAIL"
        lines.append(f"  [{mark}] {c['name']}: {c['detail']}")
    mttr = report.get("mttr_s") or {}
    if mttr:
        lines.append("")
        lines.append("  MTTR by fault kind")
        lines.append(f"  {'kind':<14}{'n':>4}{'mean_s':>10}"
                     f"{'max_s':>10}{'timeouts':>10}")
        for kind, s in sorted(mttr.items()):
            mean = "-" if s["mean_s"] is None else f"{s['mean_s']:.2f}"
            mx = "-" if s["max_s"] is None else f"{s['max_s']:.2f}"
            lines.append(f"  {kind:<14}{s['n']:>4}{mean:>10}{mx:>10}"
                         f"{s['timeouts']:>10}")
    lines.append("")
    lines.append("  verdict: " + ("OK" if report["ok"] else
                                  "VIOLATIONS: " +
                                  ", ".join(report["violations"])))
    return "\n".join(lines)
