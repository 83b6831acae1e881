"""Typed config/flag registry with environment-variable override.

Mirrors the reference's ``RAY_CONFIG`` macro system
(`src/ray/common/ray_config_def.h:22`, env override at
`src/ray/common/ray_config.h:100`): every flag has a type, a default, and can
be overridden by ``RAY_TPU_<NAME>`` in the environment.  Flags are read at
process start; ``Config.initialize(overrides)`` applies a dict (the launcher
serializes driver-side overrides into worker processes this way, like the
reference serializes its config JSON into every raylet/worker command line).

This registry is the ONLY sanctioned reader of ``RAY_TPU_*`` environment
variables: every knob and per-process identity variable is declared here (or
in its owning module via ``config.define``), and the static-analysis suite
(`tools/analysis`, env-flag-registry pass) rejects direct ``os.environ``
reads of ``RAY_TPU_*`` anywhere else in the package.  The same declarations
generate the env-var reference table in the README
(``python -m tools.analysis --write-env-table``).

Two flavors of flag:

* plain (default): the environment is read ONCE, at ``define()`` time
  (process start) — the reference's read-at-startup semantics.
* ``live=True``: attribute access re-reads the environment on every read.
  Used for per-process identity variables that a parent sets in a child's
  environment (node id, worker profile, session dir) and for test-facing
  knobs flipped via ``monkeypatch.setenv`` after import (chaos injection,
  debug locks).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict

_ENV_PREFIX = "RAY_TPU_"


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


_PARSERS: Dict[type, Callable[[str], Any]] = {
    bool: _parse_bool,
    int: int,
    float: float,
    str: str,
}


class _Flag:
    __slots__ = ("name", "type", "default", "doc", "value", "live",
                 "_env", "_last_raw", "_last_val")

    def __init__(self, name, type_, default, doc, live=False):
        self.name = name
        self.type = type_
        self.default = default
        self.doc = doc
        self.live = live
        self.value = default
        self._env = _ENV_PREFIX + name.upper()
        # live-read memo: re-parse only when the raw env STRING changes
        # (chaos/debug flags are read per task execution — the parse and
        # the per-read string building were the cost, not the env get)
        self._last_raw = None
        self._last_val = None
        if not live:
            self.reload()

    @property
    def env_name(self) -> str:
        return self._env

    def _parse(self, raw: str):
        # A malformed env value falls back to the current value instead of
        # blowing up whichever import happens to define the flag.
        try:
            return _PARSERS[self.type](raw)
        except (ValueError, TypeError):
            return self.value

    def reload(self):
        """Recompute the stored value: default, then environment override
        (so deleting the env var between reloads restores the default).
        Live flags re-read the environment on every access and never bake
        it into the stored value — reload is a no-op for them."""
        if self.live:
            return
        self.value = self.default
        env = os.environ.get(self.env_name)
        if env is not None:
            self.value = self._parse(env)

    def current(self):
        if self.live:
            env = os.environ.get(self._env)
            if env is not None:
                if env != self._last_raw:
                    self._last_val = self._parse(env)
                    self._last_raw = env
                return self._last_val
        return self.value


class _Config:
    # Non-live flag values are MATERIALIZED as plain instance attributes:
    # ``config.foo`` is then an ordinary instance-dict hit instead of a
    # ``__getattr__`` miss (the miss protocol costs ~1µs and the direct
    # transport hot path reads a dozen flags per call).  Live flags are
    # never materialized — they re-read the environment on every access
    # via the ``__getattr__`` fallback.  Every mutation path (define /
    # initialize / reload / attribute set) re-materializes.

    def __init__(self):
        self._flags: Dict[str, _Flag] = {}

    def define(self, name: str, type_: type, default, doc: str = "",
               live: bool = False):
        flag = _Flag(name, type_, default, doc, live=live)
        self._flags[name] = flag
        if not live:
            object.__setattr__(self, name, flag.value)

    def initialize(self, overrides: Dict[str, Any]):
        for k, v in overrides.items():
            if k in self._flags:
                flag = self._flags[k]
                flag.value = flag.type(v)
                if not flag.live:
                    object.__setattr__(self, k, flag.value)

    def reload(self, *names: str):
        """Re-read environment overrides — all flags, or just ``names``.
        Lets tests (and ``chaos.configure_net``) apply ``setenv`` changes
        made after the defining module was imported."""
        for name in names or list(self._flags):
            flag = self._flags[name]
            flag.reload()
            if not flag.live:
                object.__setattr__(self, name, flag.value)

    def to_dict(self) -> Dict[str, Any]:
        # Live flags are per-process identity (node id, session dir, ...):
        # serializing a driver's identity into a worker would be wrong, so
        # they never ride the override dict.
        return {k: f.value for k, f in self._flags.items() if not f.live}

    def serialize(self) -> str:
        return json.dumps(self.to_dict())

    def __getattr__(self, name: str):
        # only reached for LIVE flags (and genuinely unknown names) —
        # non-live flags are materialized instance attributes
        flags = object.__getattribute__(self, "_flags")
        if name in flags:
            return flags[name].current()
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            flag = self._flags[name]
            flag.value = flag.type(value)
            if not flag.live:
                object.__setattr__(self, name, flag.value)


config = _Config()

# --- core runtime -----------------------------------------------------------
config.define("object_store_memory_mb", int, 512, "Default shm store size.")
config.define("object_store_fallback_inproc", bool, False,
              "Force pure-Python object store (no C++ shm).")
config.define("inline_object_max_bytes", int, 100 * 1024,
              "Objects at or below this size are returned inline over the "
              "control socket instead of through the shm store (reference: "
              "task returns <=100KB are inlined, core_worker.h:988).")
config.define("num_workers_default", int, 0,
              "0 = os.cpu_count() capped by num_cpus.")
config.define("worker_start_timeout_s", float, 30.0, "")
config.define("task_retry_default", int, 3,
              "Default max retries for tasks (reference ray_option_utils.py:149).")
config.define("actor_max_restarts_default", int, 0, "")
config.define("get_timeout_poll_s", float, 0.01, "")
config.define("worker_niceness", int, 0, "")
config.define("log_to_driver", bool, True, "")
config.define("temp_dir", str, "/tmp/ray_tpu_torch", "Session root directory.")
config.define("prestart_workers", bool, True,
              "Start the worker pool eagerly at init (reference raylet "
              "prestarts workers, main.cc:48).")
config.define("dispatch_batch_max", int, 64,
              "Max same-shape normal tasks dispatched to one worker in a "
              "single coalesced frame (they execute sequentially and hold "
              "ONE task's resources; the worker requeues unstarted ones if "
              "its current task blocks).  1 disables batching.  Sized with "
              "the native frame codec: a 64-frame train is one sendall + "
              "one scan, and blocked batches hand their tail back, so the "
              "latency cost of depth is bounded by one task's runtime.")
config.define("actor_pipeline_depth", int, 32,
              "Max calls pipelined to a SYNC max_concurrency=1 actor ahead "
              "of completion (the worker's single executor thread runs "
              "them one at a time, so effective concurrency stays 1; this "
              "just keeps its queue warm instead of paying a socket "
              "round-trip of latency between calls).")
config.define("health_check_period_s", float, 1.0, "")
config.define("task_event_buffer_size", int, 10000,
              "Max buffered task state events for the state API.")

# --- overload protection & deadlines ----------------------------------------
config.define("deadlines", bool, True,
              "Kill switch for the end-to-end deadline machinery: "
              "RAY_TPU_DEADLINES=0 makes deadline_s/request_timeout_s "
              "no-ops (specs carry no deadline, nothing is shed or "
              "interrupted on expiry) — today's pre-deadline behavior.")
config.define("max_queue_depth", int, 0,
              "Bounded raylet queues: above this many queued tasks "
              "(ready queue, or one actor's call queue) new admissions "
              "shed the lowest-deadline-headroom task with a typed "
              "BackPressureError instead of queueing without limit "
              "(reference: bounded lease queues + Serve backpressure).  "
              "0 = unbounded (default).")

# --- data plane --------------------------------------------------------------
config.define("data_channel", bool, True,
              "Zero-copy raylet-to-raylet data plane: bulk object bytes "
              "move on a dedicated per-peer TCP connection with a raw "
              "binary protocol (data_channel.py) driven by the pull "
              "manager (pull_manager.py).  RAY_TPU_DATA_CHANNEL=0 falls "
              "back to single-source pickled chunks on the control "
              "socket (the pre-data-plane path, kept for parity tests).")

# --- observability -----------------------------------------------------------
config.define("task_events", bool, True,
              "Export task lifecycle events to the GCS task-event table "
              "(reference: GCS task-event backend feeding list_tasks / "
              "ray.timeline).  RAY_TPU_TASK_EVENTS=0 disables the export "
              "(local ring buffers keep working).")
config.define("task_event_flush_interval_s", float, 0.25,
              "Raylet -> GCS task-event batch flush period.")
config.define("task_event_batch_max", int, 512,
              "Flush the task-event export buffer early once it holds this "
              "many events (piggybacks on the frame-train drain cadence).")
config.define("task_event_export_buffer", int, 4096,
              "Ring-buffer cap for not-yet-flushed task events; overflow "
              "drops the OLDEST events and bumps num_dropped — export "
              "backpressure never blocks dispatch.")
config.define("task_events_max_per_job", int, 20000,
              "GCS-side cap per job: max retained task events AND max "
              "tracked per-task states (oldest evicted first).")
config.define("internal_metrics_interval_s", float, 1.0,
              "Flush period for the runtime's own ray_tpu_internal_* "
              "metrics (queue depth, dispatch latency, store bytes, codec "
              "counters) into the metrics KV -> /metrics.  0 disables.")
config.define("metrics_table_max", int, 20000,
              "GCS-side cap per NODE on retained metric time-series "
              "points (add_metric_points / query_metrics); oldest "
              "evicted first, evictions counted in metrics_table_stats.")

# --- alerting ----------------------------------------------------------------
config.define("alerts", bool, True,
              "Evaluate alert rules in the GCS on the metrics flush "
              "cadence (RAY_TPU_ALERTS=0 disables the rule engine; the "
              "alert table and list_alerts keep working, nothing new "
              "fires).")
config.define("alerts_eval_interval_s", float, 2.0,
              "Period between alert rule evaluations in the GCS health "
              "monitor.")
config.define("alerts_table_max", int, 1000,
              "GCS-side cap on retained alert records (firing/resolved "
              "transitions); oldest evicted first, evictions counted.")
config.define("alerts_rules", str, "",
              "Extra alert rules as a JSON list of rule dicts, merged "
              "over (and by name overriding) the built-in defaults "
              "(util.alerts.default_rules); re-read on every evaluation "
              "so tests can inject rules live.", live=True)
config.define("alerts_default_rules", bool, True,
              "Ship the built-in default rule set (false-suspect rate, "
              "fenced-frame spikes, replication-repair pressure, Serve "
              "shed-ratio burn rate, telemetry drop counters).  0 leaves "
              "only RAY_TPU_ALERTS_RULES rules active.")

# --- tensor plane -----------------------------------------------------------
config.define("mesh_default_axes", str, "dp,tp", "")
config.define("enable_pallas", bool, True,
              "Use Pallas kernels on TPU when shapes allow.")

# --- process identity (live: set by a parent in the child's environment) ----
config.define("address", str, "",
              "Cluster address auto-attached by ray_tpu_torch.init() when no "
              "address argument is given (reference: RAY_ADDRESS); set by "
              "the job manager for submitted entrypoints.", live=True)
config.define("node_id", str, "",
              "Hosting raylet's node id, set in every spawned worker's "
              "environment (runtime_context.get_node_id on workers).",
              live=True)
config.define("job_id", str, "driver",
              "Job attribution for task events: the job supervisor sets "
              "this in the entrypoint's environment before the driver "
              "starts (read once at import); ad-hoc drivers share one "
              "'driver' bucket.")
config.define("session_dir", str, "",
              "Session directory, set in spawned workers' environment by "
              "their raylet (log files, runtime-env staging).", live=True)
config.define("node_ip", str, "",
              "Hosting node's IP, set in spawned workers' environment by "
              "a cluster-mode raylet; a worker that sees it also listens "
              "on TCP for direct worker→worker calls from peers.",
              live=True)
config.define("node_incarnation", int, 0,
              "Hosting node's registration incarnation at worker spawn "
              "time (the PR 8 fencing token), set in the worker's "
              "environment; direct-call hellos presenting an OLDER "
              "incarnation are rejected as fenced.", live=True)
config.define("worker_profile", str, "cpu",
              "Worker-pool profile this worker process was spawned for "
              "(set by the raylet; read back at register time).", live=True)
config.define("worker_id", str, "",
              "TPU worker index within a pod slice (topology label "
              "tpu_worker_id; TPU_WORKER_ID is the non-test source).",
              live=True)
config.define("actor_restarts", int, 0,
              "Restart count the raylet stamps into a restarted actor "
              "worker's environment (was_current_actor_reconstructed).",
              live=True)
config.define("num_chips", int, 0,
              "TPU chip count to advertise as this node's TPU resource "
              "(overrides jax device discovery).", live=True)
config.define("gcs_address", str, "",
              "GCS host:port for autoscaler-provisioned nodes: the "
              "instance startup script exports it and hands it to "
              "`ray_tpu_torch start`.", live=True)
config.define("node_type", str, "",
              "Autoscaler node-type name of a provisioned instance "
              "(exported by its startup script).", live=True)
config.define("accelerator_type", str, "",
              "Accelerator type topology label (e.g. v5e-8); test "
              "override for TPU_ACCELERATOR_TYPE.", live=True)
config.define("slice_id", str, "",
              "Pod-slice identity topology label (tpu_slice): nodes "
              "sharing it are ICI-adjacent; test override for TPU_NAME.",
              live=True)
config.define("topology", str, "",
              "Slice topology label (e.g. 2x4); test override for "
              "TPU_TOPOLOGY.", live=True)

# --- developer tooling ------------------------------------------------------
config.define("debug_locks", bool, False,
              "Runtime lock-order watchdog: util.locks.make_lock() returns "
              "DebugLock wrappers that record per-thread lock acquisition "
              "order into a global graph and report potential-deadlock "
              "cycles with the stacks of both orderings.  On for the test "
              "suite in CI.", live=True)
