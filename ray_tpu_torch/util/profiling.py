"""Cluster-wide continuous profiling: sampling stacks + live introspection.

Reference analogue: the dashboard's py-spy integration (``ray stack`` /
the per-worker "CPU flame graph" button, `dashboard/modules/reporter/
reporter_agent.py`) and ``ray stack``'s all-thread dumps.  Re-designed
in-process: instead of attaching an external tracer, every ray_tpu_torch
process (worker, raylet, GCS, driver) runs ONE sampling daemon thread
that walks ``sys._current_frames()`` at ``RAY_TPU_PROFILE_HZ`` and folds
each thread's stack into collapsed-stack counts — the flamegraph.pl /
speedscope "folded" format — tagged with the currently-executing task id
/ trace id / actor id (wired through the execution context the tracing
layer already propagates), so flamegraphs can be sliced per request hop,
per actor, or per Serve deployment.

Three consumers feed off this module:

* **Continuous profiles**: folded counts batch-flush toward the per-node
  GCS profile table on the task-event cadence (bounded buffers, oldest
  dropped and counted, ``RAY_TPU_PROFILE=0`` is a live kill switch) —
  ``state.profile(duration_s)`` / ``ray_tpu_torch profile`` / dashboard
  ``/api/profile`` read it back and export speedscope / collapsed text.
* **Live stacks**: ``dump_threads()`` snapshots every thread's current
  stack (plus its task/trace tags) on demand — the payload behind
  ``ray_tpu_torch stack``, ``state.list_stacks`` and dashboard ``/api/stacks``,
  the ``py-spy dump`` analogue that works on a live remote process
  because the dump runs *inside* it, relayed over the existing protocol.
* **The sampler itself is the overhead budget**: a pure-Python walker at
  the default 19 Hz costs well under the 3% bench bar (``profile_overhead``
  row in bench_core), and the kill switch reduces it to a 0.5 s idle poll.

Samples are wall-clock samples of ON-CPU *and* blocked threads (like
``py-spy --idle``): for a control plane the interesting question is
usually "what is this thread waiting on", which on-CPU-only profilers
erase.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import config
from ray_tpu_torch.util.locks import make_lock

config.define("profile", bool, True,
              "Continuous-profiling master switch (live): every process "
              "samples its threads' stacks at profile_hz into the GCS "
              "profile table.  RAY_TPU_PROFILE=0 is a cluster-wide "
              "runtime kill switch — the sampler thread idles.", live=True)
config.define("profile_hz", float, 19.0,
              "Stack-sampling rate of the in-process profiler (live).  A "
              "prime default avoids lockstep aliasing with periodic work; "
              "raise it for a sharper capture window, at sampling cost.",
              live=True)
config.define("profile_max_depth", int, 64,
              "Deepest stack recorded per sample; frames below the cutoff "
              "are folded into a '...' root segment.")
config.define("profile_buffer_size", int, 4096,
              "Per-process cap on not-yet-flushed folded sample records; "
              "overflow drops the OLDEST records and counts them — the "
              "sampler never blocks or grows without bound.")
config.define("profile_flush_interval_s", float, 1.0,
              "Folded-profile batch-flush period (worker -> raylet -> GCS "
              "profile table).")
config.define("profile_table_max", int, 50000,
              "GCS-side profile-table cap per node: oldest sample records "
              "evicted first, evictions counted in profile_table_stats.")

__all__ = ["ensure_profiler", "profiling_enabled", "set_task_tags",
           "reset_task_tags", "dump_threads", "drain_samples",
           "set_flush_target", "flush_samples", "to_speedscope",
           "to_collapsed", "summarize"]


# ------------------------------------------------------------------ state

_proc_label = "driver"
_sampler: Optional[threading.Thread] = None  # guard: _lock
_lock = make_lock("profiling.state")
# thread ident -> (task_id, trace_id, actor_id, task_name): written by the
# executing thread around each task, read (racily, by design — a torn read
# just mis-tags one sample) by the sampler thread.
_task_tags: Dict[int, tuple] = {}

# Folded aggregation window: (thread_name, folded_stack, tags) -> count,
# reset at each drain.  Only the sampler thread writes counts; drains swap
# the dict out under the lock.
_counts: Dict[tuple, int] = {}  # guard: _lock
_window_t0 = 0.0                # guard: _lock
_samples_total = 0              # guard: _lock — lifetime, for stats/tests

from collections import deque as _deque

# Drained-but-not-shipped records (bounded; oldest dropped + counted).
_pending: "deque" = _deque()  # guard: _lock
_dropped = 0               # guard: _lock
_flush_fn: Optional[Callable[[List[dict], int], None]] = None
_flusher_started = False   # guard: _lock

# frame -> "name (file:line)" label cache: code objects are interned per
# function, so this collapses the per-sample formatting cost to a dict
# hit.  Bounded — dynamically minted code (exec, lambdas in loops) must
# not grow it forever.
_label_cache: Dict[tuple, str] = {}
_LABEL_CACHE_CAP = 8192

# Live-flag cache (same trick as tracing._live_flags): the sampler ticks
# profile_hz times a second and a registry read costs ~3us.
_live = {"at": -1.0, "on": False, "hz": 19.0}


def _live_flags() -> dict:
    now = time.monotonic()
    if now - _live["at"] > 0.25:
        _live["on"] = config.profile
        _live["hz"] = config.profile_hz
        _live["at"] = now
    return _live


def profiling_enabled() -> bool:
    """The live master switch — RAY_TPU_PROFILE=0 idles every sampler in
    the cluster within one flag-cache tick, no restarts."""
    return _live_flags()["on"]


def set_process_label(label: str):
    """Sample attribution: 'driver' | 'worker' | 'raylet' | 'gcs'."""
    global _proc_label
    _proc_label = label


# ------------------------------------------------------------------- tags


def set_task_tags(task_id: Optional[str] = None,
                  trace_id: Optional[str] = None,
                  actor_id: Optional[str] = None,
                  name: Optional[str] = None, chain: bool = True):
    """Mark the calling thread as executing ``task_id`` so samples taken
    while it runs carry the attribution.  Returns a token for
    ``reset_task_tags``.  ``chain=False`` is for tasks SHARING a thread
    (asyncio actors interleave on the loop thread): the reset then clears
    rather than restores, so a task finishing out of LIFO order can't
    resurrect an already-finished task's tags onto the idle thread."""
    ident = threading.get_ident()
    prev = _task_tags.get(ident) if chain else None
    mine = (task_id, trace_id, actor_id, name)
    _task_tags[ident] = mine
    return (prev, mine)


def reset_task_tags(token):
    """Undo ``set_task_tags`` — only if this thread's tags are still the
    ones that call installed (on a shared asyncio thread a later task may
    have re-tagged it; its attribution must survive our exit)."""
    if token is None:
        return
    prev, mine = token
    ident = threading.get_ident()
    if _task_tags.get(ident) is not mine:
        return
    if prev is None:
        _task_tags.pop(ident, None)
    else:
        _task_tags[ident] = prev


# ---------------------------------------------------------------- sampling


def _frame_label(code, lineno: int) -> str:
    key = (code, lineno)
    label = _label_cache.get(key)
    if label is None:
        fname = code.co_filename
        base = fname.rsplit("/", 1)[-1]
        label = f"{code.co_name} ({base}:{lineno})"
        if len(_label_cache) >= _LABEL_CACHE_CAP:
            _label_cache.clear()
        _label_cache[key] = label
    return label


def _fold(frame, max_depth: int) -> str:
    """Collapse one thread's frame chain into 'root;...;leaf'."""
    parts: List[str] = []
    depth = 0
    while frame is not None and depth < max_depth:
        parts.append(_frame_label(frame.f_code, frame.f_lineno))
        frame = frame.f_back
        depth += 1
    if frame is not None:
        parts.append("...")
    parts.reverse()
    return ";".join(parts)


def _sample_once(own_ident: int, names: Dict[int, str], max_depth: int):
    global _samples_total
    try:
        frames = sys._current_frames()
    except RuntimeError:  # interpreter tearing down
        return
    keys = []
    for ident, frame in frames.items():
        if ident == own_ident:
            continue
        stack = _fold(frame, max_depth)
        tags = _task_tags.get(ident)
        keys.append((names.get(ident) or f"thread-{ident}", stack, tags))
    with _lock:
        counts = _counts
        for key in keys:
            counts[key] = counts.get(key, 0) + 1
        _samples_total += len(keys)


def _sampler_loop():
    global _window_t0
    own_ident = threading.get_ident()
    max_depth = config.profile_max_depth
    while True:
        flags = _live_flags()
        if not flags["on"]:
            time.sleep(0.5)  # blocking-ok: dedicated sampler thread
            continue
        time.sleep(1.0 / max(0.5, flags["hz"]))  # blocking-ok: dedicated sampler thread
        try:
            # fresh name map EVERY tick: thread idents are recycled, so a
            # cached map can attribute a new thread's stack to a dead
            # thread's name (enumerate is O(threads) — cheap at any hz)
            names = {t.ident: t.name for t in threading.enumerate()
                     if t.ident is not None}
            with _lock:
                if _window_t0 == 0.0:
                    _window_t0 = time.time()
            _sample_once(own_ident, names, max_depth)
        except Exception:  # noqa: BLE001 — the sampler must survive anything
            pass


def ensure_profiler(label: Optional[str] = None) -> bool:
    """Start this process's sampling thread (idempotent).  Safe to call
    with profiling disabled — the thread idles until the live switch
    flips on.  Returns True when a sampler is running after the call."""
    global _sampler
    if label is not None:
        set_process_label(label)
    with _lock:
        if _sampler is not None and _sampler.is_alive():
            return True
        _sampler = t = threading.Thread(target=_sampler_loop,
                                        name="profile-sampler", daemon=True)
    t.start()
    return True


# ------------------------------------------------------------------ drain


def drain_samples() -> Tuple[List[dict], int]:
    """Fold the current window into sample records, take everything
    pending, and return ``(records, dropped_since_last_drain)``.  Fed by
    the raylet's flush cadence and the worker/client flusher thread."""
    global _dropped
    _roll_window()
    with _lock:
        if not _pending and not _dropped:
            return [], 0
        records = list(_pending)
        _pending.clear()
        dropped, _dropped = _dropped, 0
    return records, dropped


def _roll_window():
    """Convert the active counting window into pending records (bounded).
    Called from drain paths and the flusher."""
    global _window_t0, _dropped
    t1 = time.time()
    with _lock:
        if not _counts:
            return
        items = list(_counts.items())
        _counts.clear()
        t0 = _window_t0 or t1
        _window_t0 = 0.0
        cap = config.profile_buffer_size
        for (tname, stack, tags), n in items:
            task_id, trace_id, actor_id, task_name = tags or (None,) * 4
            rec = {"thread": tname, "stack": stack, "count": n,
                   "t0": t0, "t1": t1, "pid": os.getpid(),
                   "proc": _proc_label, "node": config.node_id[:12]}
            if task_id:
                rec["task"] = task_id
            if trace_id:
                rec["trace"] = trace_id
            if actor_id:
                rec["actor"] = actor_id
            if task_name:
                rec["name"] = task_name
            _pending.append(rec)
        while len(_pending) > cap:
            _pending.popleft()
            _dropped += 1


def set_flush_target(fn: Optional[Callable[[List[dict], int], None]]):
    """Register the batch shipper for processes with no in-process raylet
    (workers, TCP client drivers, the standalone GCS) and start the
    cadence flusher — mirrors ``tracing.set_flush_target``."""
    global _flush_fn, _flusher_started
    _flush_fn = fn
    if fn is None:
        return
    with _lock:
        if _flusher_started:
            return
        _flusher_started = True
    threading.Thread(target=_flush_loop, name="profile-flush",
                     daemon=True).start()


def _flush_loop():
    while True:
        time.sleep(max(0.1, config.profile_flush_interval_s))  # blocking-ok: dedicated flusher thread
        try:
            flush_samples()
        except Exception:  # noqa: BLE001 — flusher must live
            pass


def flush_samples():
    """Ship pending records through the registered flush target now (no-op
    without one — the raylet drains the buffer directly in that case)."""
    fn = _flush_fn
    if fn is None:
        return
    records, dropped = drain_samples()
    if records or dropped:
        fn(records, dropped)


def stats() -> dict:
    with _lock:
        return {"samples_total": _samples_total,
                "pending": len(_pending), "dropped": _dropped,
                "window_open": _window_t0 != 0.0}


# ----------------------------------------------------------- live stacks


def dump_threads(proc: Optional[str] = None) -> List[dict]:
    """Every thread's current stack, name, and task tags — the live
    introspection payload behind ``ray_tpu_torch stack`` (the ``py-spy dump``
    analogue, run in-process and relayed over the protocol)."""
    frames = sys._current_frames()
    infos = {t.ident: t for t in threading.enumerate()
             if t.ident is not None}
    out = []
    own = threading.get_ident()
    for ident, frame in frames.items():
        t = infos.get(ident)
        tags = _task_tags.get(ident)
        entry = {
            "name": t.name if t is not None else f"thread-{ident}",
            "ident": ident,
            "daemon": bool(t.daemon) if t is not None else None,
            "current": ident == own,
            "proc": proc or _proc_label,
            "pid": os.getpid(),
            "frames": _fold(frame, config.profile_max_depth).split(";"),
        }
        if tags is not None:
            task_id, trace_id, actor_id, task_name = tags
            if task_id:
                entry["task"] = task_id
            if trace_id:
                entry["trace"] = trace_id
            if actor_id:
                entry["actor"] = actor_id
            if task_name:
                entry["task_name"] = task_name
        out.append(entry)
    out.sort(key=lambda e: e["name"])
    return out


def format_stacks(threads: List[dict]) -> str:
    """Human-readable rendering of ``dump_threads`` output (CLI)."""
    lines = []
    for t in threads:
        tag = ""
        if t.get("task"):
            tag = f"  [task={t['task'][:12]}"
            if t.get("task_name"):
                tag += f" {t['task_name']}"
            if t.get("trace"):
                tag += f" trace={t['trace'][:12]}"
            tag += "]"
        lines.append(f"  {t['name']} (ident={t['ident']}"
                     f"{', daemon' if t.get('daemon') else ''}){tag}")
        for fr in t["frames"]:
            lines.append(f"    {fr}")
    return "\n".join(lines)


# ---------------------------------------------------------------- exports


def to_collapsed(samples: List[dict],
                 include_thread: bool = True) -> str:
    """flamegraph.pl collapsed format: one ``a;b;c count`` line per
    distinct folded stack, counts merged across sample records."""
    agg: Dict[str, int] = {}
    for rec in samples:
        stack = rec.get("stack", "")
        if include_thread:
            stack = f"{rec.get('proc', '?')}:{rec.get('thread', '?')};" \
                + stack
        agg[stack] = agg.get(stack, 0) + int(rec.get("count", 0))
    return "\n".join(f"{stack} {n}"
                     for stack, n in sorted(agg.items())) + "\n"


def to_speedscope(samples: List[dict], name: str = "ray_tpu_torch profile") -> dict:
    """speedscope's JSON file format (sampled profile): load the result at
    https://www.speedscope.app or with `speedscope file.json`.  Weights
    are sample counts (unit "none"); each folded stack becomes one
    sampled entry, root-first frame indices into the shared frame list."""
    frame_idx: Dict[str, int] = {}
    frames: List[dict] = []
    sample_rows: List[List[int]] = []
    weights: List[int] = []
    agg: Dict[tuple, int] = {}
    for rec in samples:
        key = (rec.get("proc", "?"), rec.get("thread", "?"),
               rec.get("stack", ""))
        agg[key] = agg.get(key, 0) + int(rec.get("count", 0))
    for (proc, thread, stack), n in sorted(agg.items()):
        row = []
        for label in (f"{proc}:{thread}", *stack.split(";")):
            idx = frame_idx.get(label)
            if idx is None:
                idx = frame_idx[label] = len(frames)
                frames.append({"name": label})
            row.append(idx)
        sample_rows.append(row)
        weights.append(n)
    total = sum(weights)
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "exporter": "ray_tpu_torch",
        "name": name,
        "activeProfileIndex": 0,
        "shared": {"frames": frames},
        "profiles": [{
            "type": "sampled",
            "name": name,
            "unit": "none",
            "startValue": 0,
            "endValue": total,
            "samples": sample_rows,
            "weights": weights,
        }],
    }


def summarize(samples: List[dict], top: int = 30) -> dict:
    """The "where does the CPU go" table: per-function self and inclusive
    sample counts (plus per-process and per-task slices) over a batch of
    profile-table records — the profiling analogue of
    ``trace_analysis.aggregate``."""
    self_counts: Dict[str, int] = {}
    total_counts: Dict[str, int] = {}
    by_proc: Dict[str, int] = {}
    by_task: Dict[str, int] = {}
    total = 0
    for rec in samples:
        n = int(rec.get("count", 0))
        total += n
        by_proc[rec.get("proc", "?")] = \
            by_proc.get(rec.get("proc", "?"), 0) + n
        task = rec.get("task")
        if task:
            by_task[task] = by_task.get(task, 0) + n
        frames = rec.get("stack", "").split(";")
        if frames and frames[-1]:
            self_counts[frames[-1]] = self_counts.get(frames[-1], 0) + n
        for fr in set(frames):
            if fr:
                total_counts[fr] = total_counts.get(fr, 0) + n

    def table(counts: Dict[str, int]) -> List[dict]:
        rows = sorted(counts.items(), key=lambda kv: -kv[1])[:top]
        return [{"frame": fr, "samples": n,
                 "share": round(n / total, 4) if total else 0.0}
                for fr, n in rows]

    return {
        "total_samples": total,
        "num_records": len(samples),
        "by_proc": dict(sorted(by_proc.items(), key=lambda kv: -kv[1])),
        "num_tagged_tasks": len(by_task),
        "top_self": table(self_counts),
        "top_total": table(total_counts),
    }
