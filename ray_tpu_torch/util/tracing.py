"""Request-flow distributed tracing: every hop of a call spanned.

Reference analogue: `python/ray/util/tracing/tracing_helper.py`
(``_tracing_task_invocation :289`` wraps submission,
``_inject_tracing_into_function :322`` wraps execution, span context rides
in task metadata).  Grown from that two-span skeleton into a first-class
request-flow layer:

* ``remote()`` records a ``task.submit`` span and stamps a W3C-style
  context (trace_id, span_id, sampled) onto the TaskSpec; the context
  propagates through the frame protocol (local submits, ``xtask``
  forwarding, actor-call frames, Serve handle calls) so every process a
  request touches parents its spans under one trace.
* The raylet synthesizes hop spans from its task lifecycle transitions
  (inbox receipt, queue wait, dispatch, result seal), the pull manager's
  data-channel pulls, and recovery events (reconstruction, replication,
  checkpoint restore) — see ``Raylet._trace_hop``.
* The executing worker opens ``task.run`` with ``worker.get_args`` /
  ``worker.exec`` / ``worker.result_push`` children; the caller's
  ``get()`` closes the loop with a ``task.get`` wakeup span.
* Direct worker→worker calls (core/direct.py) span their two transport
  hops — ``worker.direct_send`` (caller encode + socket hand-off) and
  ``worker.direct_result`` (result receipt/demux) — under the same
  submit context, so ``trace_summary`` shows the raylet inbox/queue/
  dispatch/result hops GONE from the critical path rather than merely
  faster.  Both hops honor the unsampled fast path: sampled-out calls
  pay two dict probes, no span objects, no export traffic.

Sampling is head-based (``RAY_TPU_TRACE_SAMPLE``): the decision is made
once at the trace root, deterministically from the trace id, and rides the
context — unsampled requests cost one random id mint at submit and a dict
read per lifecycle event.  ERRORED spans are always exported regardless of
the sampling decision (`span.__exit__`), so failures are never invisible.

Export: spans append to a bounded per-process buffer (overflow drops the
oldest and counts — export backpressure never blocks the caller) and are
batch-flushed toward the cluster-wide GCS trace table: workers ship theirs
to their raylet over the control socket, raylets (which share a process
with the driver in single-node mode) drain the buffer on their task-event
cadence and post to the GCS.  The legacy per-process JSONL export under
``RAY_TPU_TRACE_DIR`` is kept for offline use, now with size-bounded
rotation.  Span ids use the 128/64-bit hex format so exported spans
correlate with any surrounding OpenTelemetry spans.
"""

from __future__ import annotations

import contextvars
import json
import os
import sys
import threading
import time

from ray_tpu_torch.core.config import config
from ray_tpu_torch.util.locks import make_lock

config.define("trace", bool, False,
              "Master tracing switch: enable_tracing() exports it so "
              "spawned workers inherit the choice even with no trace_dir "
              "(GCS-table-only export).", live=True)
config.define("trace_dir", str, "",
              "Span-export directory (optional JSONL export; "
              "enable_tracing exports it so spawned workers inherit the "
              "choice — RAY_TPU_TRACE alone decides whether tracing is "
              "on).", live=True)
config.define("trace_sample", float, 1.0,
              "Head-based sampling probability for new traces (decided "
              "deterministically from the trace id at the root, propagated "
              "in the span context).  Errored spans export regardless — "
              "failures are always visible.", live=True)
config.define("trace_export", bool, True,
              "Export spans to the cluster-wide GCS trace table "
              "(RAY_TPU_TRACE_EXPORT=0 keeps tracing file/ctx-only).",
              live=True)
config.define("trace_buffer_size", int, 4096,
              "Per-process cap on not-yet-flushed spans; overflow drops "
              "the OLDEST spans and counts them — export backpressure "
              "never blocks the traced code path.")
config.define("trace_flush_interval_s", float, 0.25,
              "Span batch-flush period (worker -> raylet -> GCS trace "
              "table).")
config.define("trace_table_max", int, 20000,
              "GCS-side trace-table cap per job: oldest spans evicted "
              "first, eviction counted in trace_table_stats.")
config.define("trace_file_max_mb", int, 64,
              "Rotation bound for the per-process JSONL trace file: at "
              "the cap the file rotates to <pid>.jsonl.1 (one rotation "
              "kept) so a long-lived traced process is disk-bounded.")

from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["enable_tracing", "tracing_enabled", "span", "maybe_span",
           "region", "current_trace_ctx", "trace_sampled", "emit_span", "hop",
           "read_spans", "drain_pending", "flush_spans", "set_flush_target"]

_ENV = "RAY_TPU_TRACE_DIR"

_enabled = False
_trace_dir: Optional[str] = None
_file = None  # guard: _file_lock
_file_bytes = 0  # guard: _file_lock
_file_lock = make_lock("tracing.file")
_proc_label = "driver"
_job = config.job_id or "driver"
_current: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_trace_ctx", default=None)  # {"trace_id","span_id","sampled"}

# Pending-span export buffer (bounded; see drain_pending)
_buf_lock = make_lock("tracing.buffer")
_pending: List[dict] = []  # guard: _buf_lock
_dropped = 0               # guard: _buf_lock
# Flush target: callable(spans, dropped) shipping a batch toward the GCS
# trace table (worker: control socket; client driver: TCP request).  The
# driver/raylet processes need none — the raylet drains the buffer itself
# on its flush timer.
_flush_fn: Optional[Callable[[List[dict], int], None]] = None
_flusher_started = False  # guard: _buf_lock

# get()-wakeup parenting: first return-oid (hex) of a sampled submit ->
# span ctx, so the caller's get() can parent its task.get span.  Bounded
# LRU — a fire-and-forget flood must not pin contexts forever.
from collections import OrderedDict as _OD

_get_ctx: "OrderedDict" = _OD()  # guard: _buf_lock
_GET_CTX_CAP = 8192


def enable_tracing(trace_dir: Optional[str] = None) -> Optional[str]:
    """Turn tracing on for this process AND future workers (the choice is
    exported via the environment, which spawned workers inherit —
    reference: tracing startup hook).  Idempotent: re-enabling with the
    same (or no) directory keeps the open export file and counters.
    Returns the trace dir (None when exporting to the GCS table only)."""
    global _enabled, _trace_dir
    trace_dir = trace_dir or config.trace_dir or None
    _live["at"] = -1.0  # take effect NOW, not at the 50ms cache expiry
    if _enabled and (trace_dir is None or trace_dir == _trace_dir):
        os.environ["RAY_TPU_TRACE"] = "1"  # undo a runtime kill switch
        return _trace_dir  # idempotent re-enable
    if trace_dir is not None:
        os.makedirs(trace_dir, exist_ok=True)
        # parent -> child transport: spawned workers inherit the choice
        os.environ[_ENV] = trace_dir
        if _trace_dir is not None and trace_dir != _trace_dir:
            with _file_lock:
                _close_file_locked()
        _trace_dir = trace_dir
    os.environ["RAY_TPU_TRACE"] = "1"
    _enabled = True
    return _trace_dir


def maybe_enable_from_env():
    """Called at worker startup: inherit the driver's tracing choice.
    RAY_TPU_TRACE is the authority — enable_tracing() always exports it
    alongside the dir, and honoring ONLY it means an operator's
    RAY_TPU_TRACE=0 kill switch is not silently undone in every newly
    started process just because a trace dir remains configured."""
    if config.trace:
        enable_tracing(config.trace_dir or None)


# Live-flag cache: RAY_TPU_TRACE / RAY_TPU_TRACE_SAMPLE are runtime
# toggles, but a registry read costs ~3us (env read + parse) and the
# submit/execute hot paths consult them several times per task.  Re-read
# at most every 50ms (the same cadence the chaos partition file uses):
# a toggle lands cluster-wide within one tick, and the per-call cost
# drops to a monotonic read + dict lookup.
_live = {"at": -1.0, "on": False, "sample": 1.0}


def _live_flags() -> dict:
    now = time.monotonic()
    if now - _live["at"] > 0.05:
        _live["on"] = config.trace
        _live["sample"] = config.trace_sample
        _live["at"] = now
    return _live


def tracing_enabled() -> bool:
    """Tracing is on when this process enabled it AND the live master
    switch agrees — RAY_TPU_TRACE=0 is a cluster-wide runtime kill switch
    (each process re-reads its env through the config registry, so the
    bench's interleaved on/off toggling needs no restart)."""
    return _enabled and _live_flags()["on"]


def set_process_label(label: str):
    """Span attribution for Perfetto lanes: 'driver' | 'worker' | 'raylet'
    | 'gcs' (set once at process start)."""
    global _proc_label
    _proc_label = label


def current_trace_ctx() -> Optional[Dict[str, Any]]:
    """The active span's context, for propagation into a TaskSpec."""
    return _current.get()


def trace_sampled(trace_id: str, rate: Optional[float] = None) -> bool:
    """Deterministic head-sampling decision: a pure function of the trace
    id, so every process that sees the id agrees without coordination.
    The rate is read live from config (via the 50ms flag cache — only
    trace ROOTS consult it)."""
    rate = _live_flags()["sample"] if rate is None else rate
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return int(trace_id[:8], 16) <= int(rate * 0xFFFFFFFF)


def _close_file_locked():  # requires: _file_lock
    global _file, _file_bytes
    if _file is not None:
        try:
            _file.close()
        except OSError:
            pass
        _file = None
        _file_bytes = 0


def _write_file(line: str):
    """JSONL export with size-bounded rotation (one .1 generation kept)."""
    global _file, _file_bytes
    with _file_lock:
        if _file is None:
            path = os.path.join(_trace_dir, f"{os.getpid()}.jsonl")
            try:
                _file_bytes = os.path.getsize(path)
            except OSError:
                _file_bytes = 0
            _file = open(path, "a", buffering=1)
        cap = config.trace_file_max_mb * (1 << 20)
        if cap > 0 and _file_bytes + len(line) > cap:
            path = os.path.join(_trace_dir, f"{os.getpid()}.jsonl")
            _close_file_locked()
            try:
                os.replace(path, path + ".1")
            except OSError:
                pass  # rotation failed: keep appending, count honestly
            _file = open(path, "a", buffering=1)
            try:
                # 0 after a successful rotation; the real size when the
                # rename failed — so the cap keeps being enforced instead
                # of restarting the count against an over-cap file
                _file_bytes = os.path.getsize(path)
            except OSError:
                _file_bytes = 0
        _file.write(line)
        _file_bytes += len(line)


def _emit(record: dict):
    """Route one finished span record to the enabled exporters."""
    if not tracing_enabled():
        return
    if _trace_dir is not None:
        try:
            _write_file(json.dumps(record) + "\n")
        except (OSError, ValueError):
            pass
    if not config.trace_export:
        return
    global _dropped
    with _buf_lock:
        _pending.append(record)
        if len(_pending) > config.trace_buffer_size:
            del _pending[0]
            _dropped += 1


def drain_pending() -> Tuple[List[dict], int]:
    """Take the buffered spans + the drop count since the last drain (the
    raylet's flush timer and the worker flusher both feed from here)."""
    global _dropped
    with _buf_lock:
        if not _pending and not _dropped:
            return [], 0
        spans, dropped = list(_pending), _dropped
        _pending.clear()
        _dropped = 0
    return spans, dropped


def has_pending() -> bool:
    return bool(_pending)  # unguarded-ok: racy len probe, callers re-check


def set_flush_target(fn: Optional[Callable[[List[dict], int], None]]):
    """Register the batch shipper for processes with no in-process raylet
    (workers, TCP client drivers) and start the cadence flusher."""
    global _flush_fn, _flusher_started
    _flush_fn = fn
    if fn is None:
        return
    with _buf_lock:
        if _flusher_started:
            return
        _flusher_started = True
    threading.Thread(target=_flush_loop, name="trace-flush",
                     daemon=True).start()


def _flush_loop():
    while True:
        time.sleep(max(0.05, config.trace_flush_interval_s))  # blocking-ok: dedicated flusher thread
        try:
            flush_spans()
        except Exception:  # noqa: BLE001 — flusher must live
            pass


def flush_spans():
    """Ship buffered spans through the registered flush target now (no-op
    without one — the raylet drains the buffer directly in that case)."""
    fn = _flush_fn
    if fn is None:
        return
    spans, dropped = drain_pending()
    if spans or dropped:
        fn(spans, dropped)


# ------------------------------------------------------------------ spans


# Id minting: seeded PRNG instead of per-span urandom syscalls (same
# trick as the protocol's task-id minting) — ids only need uniqueness,
# not cryptographic strength.  One module-level instance: CPython's
# C-implemented getrandbits is a single call under the GIL (no torn
# state across threads), and a fork hook re-seeds the child so spawned
# streams can't collide with the parent's.
import random as _random

_rand = _random.Random(os.urandom(16))
if hasattr(os, "register_at_fork"):
    os.register_at_fork(
        after_in_child=lambda: _rand.seed(os.urandom(16)))


def _new_trace_id() -> str:
    return f"{_rand.getrandbits(128):032x}"


def _new_span_id() -> str:
    return f"{_rand.getrandbits(64):016x}"


class span:
    """Context manager recording one span; nests via contextvars and
    parents across processes via an explicit ``parent`` ctx dict.  The
    root span makes the head-sampling decision; children inherit it.
    Unsampled spans still mint ids and propagate context (so a later
    ERROR anywhere in the trace exports with real ids) but are not
    exported unless they fail."""

    def __init__(self, name: str, parent: Optional[Dict[str, Any]] = None,
                 **attributes: Any):
        self.name = name
        self.attributes = attributes
        explicit = parent or _current.get()
        if explicit:
            self.trace_id = explicit["trace_id"]
            self.parent_id = explicit.get("span_id")
            self.sampled = bool(explicit.get("sampled", True))
        else:
            self.trace_id = _new_trace_id()
            self.parent_id = None
            self.sampled = trace_sampled(self.trace_id)
        self.span_id = _new_span_id()
        self._token = None
        self._t0 = 0.0

    @property
    def ctx(self) -> Dict[str, Any]:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "sampled": self.sampled}

    def set_error(self, message: str):
        """Mark the span failed without an exception crossing the with
        block (e.g. a task error converted into an error reply)."""
        self._error = message

    def __enter__(self) -> "span":
        self._t0 = time.time()
        self._error: Optional[str] = None
        self._token = _current.set(self.ctx)
        return self

    def __exit__(self, exc_type, exc, tb):
        _current.reset(self._token)
        failed = exc_type is not None or self._error is not None
        if not self.sampled and not failed:
            return False  # head-sampled out; errors always export
        if not tracing_enabled():
            return False
        end = time.time()
        _emit({
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_us": int(self._t0 * 1e6),
            "duration_us": int((end - self._t0) * 1e6),
            "pid": os.getpid(),
            "node": config.node_id[:12],
            "proc": _proc_label,
            "job": _job,
            "status": "ERROR" if failed else "OK",
            **({"error": repr(exc) if exc is not None else self._error}
               if failed else {}),
            "attributes": self.attributes,
        })
        return False


class _NullSpan:
    def __enter__(self):
        return self

    def set_error(self, message: str):
        pass

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def maybe_span(name: str, **attributes):
    """A child span when a trace context is active, else a no-op — the
    in-function instrumentation hook (worker arg resolution, GCS RPCs,
    checkpoint restore)."""
    if _current.get() is None or not tracing_enabled():
        return _NULL_SPAN
    return span(name, **attributes)


class _Region:
    """``region``'s two records of one stretch: a ``record_function`` in
    the profiler's trace and a child span of the runtime's trace, either
    of them None."""

    __slots__ = ("_record", "_span")

    def __init__(self, record, child):
        self._record, self._span = record, child

    def __enter__(self):
        # the span first: the profiler stamps its event before the
        # record's own set-up (~1 ms on its first use), so both start
        # within microseconds
        if self._span is not None:
            self._span.__enter__()
        if self._record is not None:
            self._record.__enter__()
        return self

    def __exit__(self, *exc):
        if self._record is not None:
            self._record.__exit__(*exc)
        if self._span is not None:
            self._span.__exit__(*exc)
        return False


def region(name: str, **attributes):
    """A named stretch of the program's own work (a train step's phases,
    a batch's ingest), recorded where someone is looking: as a
    ``record_function`` while torch's profiler records, so it lands in
    the device trace on the profiler's clock (kineto stamps host events
    with the wall clock, as ``span`` does), and as a child span while a
    trace context is active and tracing is on, so it exports under the
    caller's trace.  Otherwise the shared no-op: one module lookup, one
    bool and one contextvar read.  Never imports torch: the raylet and
    GCS import this module and never load it."""
    prof = sys.modules.get("torch.autograd.profiler")
    recording = prof is not None and getattr(prof, "_is_profiler_enabled",
                                             False)
    traced = _current.get() is not None and tracing_enabled()
    if not (recording or traced):
        return _NULL_SPAN
    return _Region(prof.record_function(name) if recording else None,
                   span(name, **attributes) if traced else None)


def emit_span(name: str, trace_id: str, parent_id: Optional[str],
              start: float, end: float, status: str = "OK",
              error: Optional[str] = None, proc: Optional[str] = None,
              **attributes: Any) -> str:
    """Record a span from measured timestamps (the raylet's hop spans are
    synthesized from lifecycle transition times on its single event
    thread, where contextvar nesting is meaningless).  Returns the new
    span id."""
    span_id = _new_span_id()
    _emit({
        "name": name,
        "trace_id": trace_id,
        "span_id": span_id,
        "parent_id": parent_id,
        "start_us": int(start * 1e6),
        "duration_us": max(0, int((end - start) * 1e6)),
        "pid": os.getpid(),
        "node": config.node_id[:12],
        "proc": proc or _proc_label,
        "job": _job,
        "status": status,
        **({"error": error} if error else {}),
        "attributes": attributes,
    })
    return span_id


def hop(name: str, parent: Optional[Dict[str, Any]], start: float,
        end: float, status: str = "OK", error: Optional[str] = None,
        proc: Optional[str] = None, **attributes: Any) -> Optional[str]:
    """Emit a measured hop span under ``parent`` (honoring its sampling
    bit; errored hops export regardless).  With no parent — e.g. a
    recovery event whose triggering request is unknown — a fresh root
    trace is minted and head-sampled."""
    if not tracing_enabled():
        return None
    if parent is not None:
        if not parent.get("sampled", True) and status == "OK":
            return None
        return emit_span(name, parent["trace_id"], parent.get("span_id"),
                         start, end, status=status, error=error, proc=proc,
                         **attributes)
    trace_id = _new_trace_id()
    if not trace_sampled(trace_id) and status == "OK":
        return None
    return emit_span(name, trace_id, None, start, end, status=status,
                     error=error, proc=proc, **attributes)


# ------------------------------------------------------------- submission


def submit_with_span(worker, spec, **attrs):
    """Submit a TaskSpec under a 'task.submit' span (shared by remote
    functions and actor methods); the span covers the actual submission
    and its context — including the head-sampling decision — propagates
    to every hop via the spec.

    Sampled-out requests take a fast path: the context (real ids +
    sampled=False) is stamped so a downstream ERROR can still export
    with a coherent trace, but no span object, contextvar churn, or
    export-buffer traffic happens — at RAY_TPU_TRACE_SAMPLE=0.01 the
    other 99% of submits pay only the id mint and this dict."""
    if not tracing_enabled():
        return worker.submit_spec(spec)
    parent = _current.get()
    if parent is not None:
        trace_id = parent["trace_id"]
        parent_id = parent.get("span_id")
        sampled = bool(parent.get("sampled", True))
    else:
        trace_id = _new_trace_id()
        parent_id = None
        sampled = trace_sampled(trace_id)
    if not sampled:
        spec.trace_ctx = {"trace_id": trace_id, "span_id": parent_id,
                          "sampled": False}
        return worker.submit_spec(spec)
    with span(f"task.submit {spec.name}",
              parent={"trace_id": trace_id, "span_id": parent_id,
                      "sampled": True},
              task_id=spec.task_id.hex(), **attrs) as sp:
        spec.trace_ctx = sp.ctx
        refs = worker.submit_spec(spec)
    if refs:
        with _buf_lock:
            _get_ctx[refs[0].hex()] = sp.ctx
            while len(_get_ctx) > _GET_CTX_CAP:
                _get_ctx.popitem(last=False)
    return refs


def lookup_get_ctx(refs) -> Optional[Dict[str, Any]]:
    """Span context of the submit that produced one of ``refs`` (first
    match wins, entry consumed) — parents the caller's task.get span."""
    if not tracing_enabled():
        return None
    with _buf_lock:
        for r in refs:
            ctx = _get_ctx.pop(r.hex(), None)
            if ctx is not None:
                return ctx
    return None


# ------------------------------------------------------------------ files


def read_spans(trace_dir: Optional[str] = None,
               name_prefix: Optional[str] = None):
    """All spans recorded under the trace dir (tests/tooling), including
    rotated ``.jsonl.1`` generations.  ``name_prefix`` filters at read
    time (e.g. ``"task.submit"`` — the timeline's flow-event feed) so
    callers don't materialize every execution span of a long run just to
    pick out the submits."""
    trace_dir = trace_dir or _trace_dir or config.trace_dir or None
    out = []
    if not trace_dir or not os.path.isdir(trace_dir):
        return out
    for name in sorted(os.listdir(trace_dir)):
        if not (name.endswith(".jsonl") or name.endswith(".jsonl.1")):
            continue
        with open(os.path.join(trace_dir, name)) as f:
            for line in f:
                try:
                    span_rec = json.loads(line)
                except ValueError:
                    continue
                if (name_prefix is None
                        or str(span_rec.get("name", ""))
                        .startswith(name_prefix)):
                    out.append(span_rec)
    return out
