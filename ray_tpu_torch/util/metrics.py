"""User metrics API: Counter / Gauge / Histogram.

Reference analogue: `python/ray/util/metrics.py` (Counter `:150`,
Histogram `:215`, Gauge `:290`) backed by the C++ OpenCensus registry and a
per-node MetricsAgent re-exporting Prometheus
(`python/ray/_private/metrics_agent.py:375`).

TPU-first re-design: no per-node agent processes — each worker process
batches its metric samples and flushes them to the GCS KV (namespace
``metrics``, key ``<pid-uuid>/<metric>``); the dashboard's ``/metrics``
endpoint merges every producer's samples into one Prometheus text page
(counters sum, gauges take the latest write, histogram buckets add).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core.config import config
from ray_tpu_torch.util.locks import make_lock

__all__ = ["Counter", "Gauge", "Histogram", "flush_metrics",
           "shutdown_metrics", "render_kv_metrics", "merge_kv_metrics",
           "kv_metrics_json", "render_prom_lines", "internal_metric",
           "INTERNAL_PREFIX", "PointRing", "collect_points",
           "set_points_target", "record_points", "drain_points"]

config.define("metrics_flush_s", float, 1.0,
              "Per-process user-metric flush period into the GCS metrics "
              "KV (the dashboard's /metrics merges every producer).")
config.define("metrics_history", bool, True,
              "Time-series export: every metric flush also ships "
              "timestamped DELTA points into the GCS metrics time-series "
              "table (add_metric_points), queryable via state.query_metrics"
              " / `ray_tpu_torch metrics`.  RAY_TPU_METRICS_HISTORY=0 keeps only "
              "the instantaneous snapshot KV.")
config.define("metrics_history_ring", int, 4096,
              "Per-process ring-buffer cap for metric points awaiting "
              "export; overflow drops the OLDEST points and counts them "
              "(export backpressure never blocks recording).")

_NS = "metrics"
_FLUSH_INTERVAL_S = config.metrics_flush_s

# Metric names under this prefix are reserved for the runtime's own
# instrumentation (scheduler queue depth, dispatch latency, ...) — user
# metrics may not claim them (reference: the ray_* internal namespace,
# `metrics_agent.py:375`).  Internal metrics are built via internal_metric()
# and flushed by their owner (e.g. the raylet, which has no global worker
# in cluster mode), not by the per-process flusher thread.
INTERNAL_PREFIX = "ray_tpu_internal_"

_registry_lock = make_lock("metrics.registry")
_registry: List["Metric"] = []  # guard: _registry_lock
_producer_id = f"{os.getpid()}-{uuid.uuid4().hex[:6]}"  # guard: _registry_lock
_flusher_started = False  # guard: _registry_lock
_flusher_stop = threading.Event()
_mk_internal = threading.local()


def _kv_put(key: bytes, value: bytes) -> bool:
    from ray_tpu_torch.core import worker as worker_mod

    w = worker_mod._global_worker  # raw slot: may be None before init
    if w is None:
        return False
    try:
        w.kv_put(key, value, namespace=_NS)
        return True
    except Exception:  # noqa: BLE001
        return False


def _ensure_flusher():
    global _flusher_started
    with _registry_lock:
        if _flusher_started:
            return
        _flusher_started = True
        stop = _flusher_stop

    def loop():
        while not stop.wait(_FLUSH_INTERVAL_S):
            try:
                flush_metrics()
            except Exception:  # noqa: BLE001
                pass
            try:
                flush_points()
            except Exception:  # noqa: BLE001
                pass

    threading.Thread(target=loop, name="metrics-flush", daemon=True).start()


def flush_metrics():
    """Push every registered metric's samples to the GCS KV now.  One
    broken metric must not starve the rest of the registry — exports are
    isolated per metric."""
    with _registry_lock:
        metrics = list(_registry)
    for m in metrics:
        try:
            payload = m._export()
        except Exception:  # noqa: BLE001 — defensive: skip, don't starve
            continue
        if payload is None:
            continue
        # unguarded-ok: GIL-atomic str read; rotation only happens in
        # shutdown_metrics, where a stale id at worst double-keys one final
        # sample window (normal Prometheus counter-reset semantics).
        _kv_put(f"{_producer_id}/{m.name}".encode(),
                json.dumps(payload).encode())


def shutdown_metrics():
    """End-of-session metrics teardown, called from ``ray_tpu_torch.shutdown()``:

    * final SYNCHRONOUS flush — the daemon flusher would otherwise lose
      every sample recorded in the last ``RAY_TPU_METRICS_FLUSH_S`` window;
    * stop the flusher thread and reset ``_flusher_started`` so the next
      ``init()`` in this process starts a fresh one;
    * rotate ``_producer_id`` and clear accumulated samples so a re-init
      against the SAME GCS does not double-report the finished session's
      counters under two producer keys (counter resets are normal
      Prometheus semantics).
    """
    global _flusher_started, _producer_id, _flusher_stop, _points_ring
    global _points_target
    try:
        flush_metrics()
    except Exception:  # noqa: BLE001
        pass
    try:
        flush_points()
    except Exception:  # noqa: BLE001
        pass
    _flusher_stop.set()
    with _registry_lock:
        _flusher_started = False
        _flusher_stop = threading.Event()
        _producer_id = f"{os.getpid()}-{uuid.uuid4().hex[:6]}"
        metrics = list(_registry)
        _points_ring = None
    _points_target = None
    _points_last.clear()
    for m in metrics:
        with m._lock:
            getattr(m, "_values", {}).clear()


# ----------------------------------------------------- time-series points
#
# Each flush cadence also emits timestamped DELTA points (counters and
# histograms ship increments over the interval, gauges ship the current
# value when it changes) into a bounded per-process ring; the owner of the
# process exports the ring into the GCS metrics time-series table
# (add_metric_points) — workers via "metric_points" control frames to their
# raylet, the raylet/GCS directly on their own flush cadence.  Shipping
# deltas (not cumulative snapshots) makes the table mergeable across
# producer restarts and makes rate()/quantile-over-window pure sums.


class PointRing:
    """Bounded ring of metric points awaiting export.  Overflow evicts the
    OLDEST point and counts it; a failed flush requeues its batch so the
    data survives a dropped flush (bounded by the same cap)."""

    def __init__(self, cap: int):
        self._cap = max(1, int(cap))
        self._buf: collections.deque = collections.deque()  # guard: _lock
        self._dropped = 0  # guard: _lock
        self._lock = make_lock("metrics.points")

    def add(self, points: Sequence[dict]):
        with self._lock:
            for p in points:
                if len(self._buf) >= self._cap:
                    self._buf.popleft()
                    self._dropped += 1
                self._buf.append(p)

    def drain(self) -> Tuple[List[dict], int]:
        """Remove and return ``(points, dropped)``.  The caller owns the
        batch; on a failed hand-off it should ``requeue`` it."""
        with self._lock:
            points = list(self._buf)
            self._buf.clear()
            dropped, self._dropped = self._dropped, 0
            return points, dropped

    def requeue(self, points: Sequence[dict], dropped: int = 0):
        """Put a failed flush's batch back at the FRONT of the ring (its
        points are older than anything recorded since), evicting from the
        front when the cap would overflow — delta points lost this way are
        counted, never silently re-baselined."""
        with self._lock:
            self._dropped += dropped
            room = self._cap - len(self._buf)
            batch = list(points)
            if len(batch) > room:
                self._dropped += len(batch) - room
                batch = batch[len(batch) - room:] if room > 0 else []
            self._buf.extendleft(reversed(batch))

    def __len__(self):
        with self._lock:
            return len(self._buf)


def collect_points(metrics, last: Dict, ts: Optional[float] = None
                   ) -> List[dict]:
    """Compute timestamped delta points for ``metrics`` against the
    baseline dict ``last`` (mutated in place; key ``(name, tag_key)``).

    Counters emit their increment since the previous call, histograms the
    per-bucket/sum/count increments, gauges the current value whenever it
    differs from the last emitted one.  Quiet series emit nothing — the
    time-series table only grows when something happens."""
    now = time.time() if ts is None else ts
    points: List[dict] = []
    for m in metrics:
        with m._lock:
            values = {k: (list(v) if isinstance(v, list) else v)
                      for k, v in getattr(m, "_values", {}).items()}
        if isinstance(m, Counter):
            for key, value in values.items():
                base = last.get((m.name, key), 0.0)
                delta = value - base
                if delta > 0:
                    last[(m.name, key)] = value
                    points.append({"name": m.name, "kind": "counter",
                                   "tags": [list(t) for t in key],
                                   "ts": now, "value": delta})
        elif isinstance(m, Gauge):
            for key, (value, _vts) in values.items():
                if last.get((m.name, key)) != value:
                    last[(m.name, key)] = value
                    points.append({"name": m.name, "kind": "gauge",
                                   "tags": [list(t) for t in key],
                                   "ts": now, "value": value})
        elif isinstance(m, Histogram):
            for key, rec in values.items():
                base = last.get((m.name, key))
                if base is None:
                    delta = list(rec)
                else:
                    delta = [a - b for a, b in zip(rec, base)]
                if delta[-1] > 0:  # count increment this interval
                    last[(m.name, key)] = list(rec)
                    points.append({"name": m.name, "kind": "histogram",
                                   "tags": [list(t) for t in key],
                                   "ts": now, "value": delta,
                                   "bounds": list(m.boundaries)})
    return points


_points_ring: Optional[PointRing] = None  # guard: _registry_lock (creation)
_points_last: Dict = {}  # baselines; only touched by the flusher/raylet tick
_points_target: Optional[Callable[[List[dict], int], None]] = None


def _ring() -> PointRing:
    global _points_ring
    with _registry_lock:
        if _points_ring is None:
            _points_ring = PointRing(config.metrics_history_ring)
        return _points_ring


def set_points_target(fn: Optional[Callable[[List[dict], int], None]]):
    """Register the export hand-off for this process's metric points
    (worker processes: a ``metric_points`` control frame to the raylet).
    Without a target the ring just accumulates — the in-process raylet
    drains it on its own flush cadence (driver mode)."""
    global _points_target
    _points_target = fn


def record_points(ts: Optional[float] = None):
    """Snapshot registered metrics' deltas into the point ring."""
    if not config.metrics_history:
        return
    with _registry_lock:
        metrics = list(_registry)
    pts = collect_points(metrics, _points_last, ts)
    if pts:
        _ring().add(pts)


def drain_points() -> Tuple[List[dict], int]:
    """Drain the pending point ring — used by the in-process raylet, which
    ships the batch inside its own add_metric_points post."""
    # unguarded-ok: _points_ring is write-once (created under
    # _registry_lock, never reset); PointRing itself is internally locked
    if _points_ring is None:
        return [], 0
    return _points_ring.drain()  # unguarded-ok: see above


def flush_points():
    """Record this interval's deltas and, when a target is registered,
    hand the ring's contents off; a failed hand-off requeues the batch so
    one dropped flush loses nothing (the ring cap bounds the debt)."""
    record_points()
    target = _points_target
    # unguarded-ok: _points_ring is write-once (created under
    # _registry_lock, never reset); PointRing itself is internally locked
    if target is None or _points_ring is None:
        return
    points, dropped = _points_ring.drain()  # unguarded-ok: see above
    if not points and not dropped:
        return
    try:
        target(points, dropped)
    except Exception:  # noqa: BLE001 — transport hiccup: retry next tick
        _points_ring.requeue(points, dropped)  # unguarded-ok: see above


def internal_metric(cls, name: str, *args, register: bool = False,
                    **kwargs):
    """Construct a runtime-internal metric: the reserved
    ``ray_tpu_internal_`` prefix is allowed (enforced on the name).  By
    default the instance is NOT registered with the per-process flusher —
    the owning component exports it explicitly (see
    ``Raylet._flush_internal_metrics``, which works even in raylet
    processes that have no global worker).  ``register=True`` keeps the
    reserved name but hands export to the normal per-process flusher —
    for internal series owned by ordinary worker/driver processes (the
    Serve router/replica/proxy telemetry)."""
    if not name.startswith(INTERNAL_PREFIX):
        name = INTERNAL_PREFIX + name
    _mk_internal.on = True
    _mk_internal.register = register
    try:
        return cls(name, *args, **kwargs)
    finally:
        _mk_internal.on = False
        _mk_internal.register = False


class Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        if not name or any(c in name for c in " \n\t"):
            raise ValueError(f"invalid metric name {name!r}")
        internal = getattr(_mk_internal, "on", False)
        if name.startswith(INTERNAL_PREFIX) and not internal:
            raise ValueError(
                f"metric name prefix {INTERNAL_PREFIX!r} is reserved for "
                "runtime-internal metrics")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._default_key: Tuple = ()
        self._lock = make_lock("metrics.metric")
        if not internal or getattr(_mk_internal, "register", False):
            with _registry_lock:
                _registry.append(self)
            _ensure_flusher()

    def set_default_tags(self, tags: Dict[str, str]):
        unknown = set(tags) - set(self.tag_keys)
        if unknown:
            raise ValueError(f"tags {unknown} not in tag_keys")
        self._default_tags = dict(tags)
        self._default_key = tuple(sorted(self._default_tags.items()))
        return self

    def _resolve_tags(self, tags: Optional[Dict[str, str]]) -> Tuple:
        if tags is None:
            # Hot path (per-observation internal metrics): the default-tag
            # key is precomputed — no dict copy/sort per sample.
            return self._default_key
        merged = dict(self._default_tags)
        merged.update(tags)
        unknown = set(merged) - set(self.tag_keys)
        if unknown:
            raise ValueError(f"tags {unknown} not in tag_keys "
                             f"{self.tag_keys}")
        return tuple(sorted(merged.items()))

    def _export(self) -> Optional[dict]:
        raise NotImplementedError


class Counter(Metric):
    """Monotonic cumulative count (reference `metrics.py:150`)."""

    def __init__(self, name, description: str = "", tag_keys=None):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}  # guard: _lock

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None):
        if value < 0:
            raise ValueError("Counter.inc() takes a non-negative value")
        key = self._resolve_tags(tags)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def _export(self):
        with self._lock:
            if not self._values:
                return None
            return {"type": "counter", "desc": self.description,
                    "samples": [[list(k), v]
                                for k, v in self._values.items()]}


class Gauge(Metric):
    """Point-in-time value (reference `metrics.py:290`)."""

    def __init__(self, name, description: str = "", tag_keys=None):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, Tuple[float, float]] = {}  # guard: _lock

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = self._resolve_tags(tags)
        with self._lock:
            self._values[key] = (float(value), time.time())

    def _export(self):
        with self._lock:
            if not self._values:
                return None
            return {"type": "gauge", "desc": self.description,
                    "samples": [[list(k), v, ts]
                                for k, (v, ts) in self._values.items()]}


class Histogram(Metric):
    """Bucketed distribution (reference `metrics.py:215`)."""

    def __init__(self, name, description: str = "",
                 boundaries: Optional[Sequence[float]] = None, tag_keys=None):
        # Validate BEFORE super().__init__: the base class registers the
        # metric with the flusher, so raising after it would leave a
        # half-constructed entry in the registry whose _export crashes
        # every later flush (and silently starves the metrics registered
        # after it — an ordering-dependent whole-suite failure).
        bounds = sorted(boundaries or (0.1, 1.0, 10.0, 100.0))
        if any(b <= 0 for b in bounds):
            raise ValueError("histogram boundaries must be positive")
        super().__init__(name, description, tag_keys)
        self.boundaries = tuple(bounds)
        # key -> [bucket_counts..., +inf_count, sum, count]
        self._values: Dict[Tuple, list] = {}  # guard: _lock

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = self._resolve_tags(tags)
        with self._lock:
            rec = self._values.get(key)
            if rec is None:
                rec = [0] * (len(self.boundaries) + 1) + [0.0, 0]
                self._values[key] = rec
            idx = next((i for i, b in enumerate(self.boundaries)
                        if value <= b), len(self.boundaries))
            rec[idx] += 1
            rec[-2] += float(value)
            rec[-1] += 1

    def _export(self):
        with self._lock:
            if not self._values:
                return None
            return {"type": "histogram", "desc": self.description,
                    "bounds": list(self.boundaries),
                    "samples": [[list(k), list(v)]
                                for k, v in self._values.items()]}


# --------------------------------------------------------------- rendering


def merge_kv_metrics(gcs) -> Dict[str, dict]:
    """Merge every producer's KV samples into one slot per metric name:
    ``{name: {type, desc, bounds, data: {tag_key: value}}}`` — counters
    summed, gauges last-writer-wins by timestamp, histogram records summed
    element-wise.  ``gcs`` is a GcsClient (or any object with
    kv_keys/kv_get taking (namespace, key))."""
    merged: Dict[str, dict] = {}
    for key in gcs.kv_keys(_NS, b""):
        raw = gcs.kv_get(_NS, key)
        if not raw:
            continue
        try:
            payload = json.loads(raw)
        except ValueError:
            continue
        name = key.decode().split("/", 1)[1]
        slot = merged.setdefault(
            name, {"type": payload["type"], "desc": payload.get("desc", ""),
                   "bounds": payload.get("bounds"), "data": {}})
        if slot["type"] != payload["type"]:
            continue
        for sample in payload["samples"]:
            tag_key = tuple(tuple(t) for t in sample[0])
            if payload["type"] == "counter":
                slot["data"][tag_key] = slot["data"].get(tag_key, 0.0) + \
                    sample[1]
            elif payload["type"] == "gauge":
                v, ts = sample[1], sample[2]
                cur = slot["data"].get(tag_key)
                if cur is None or ts >= cur[1]:
                    slot["data"][tag_key] = (v, ts)
            else:  # histogram
                rec = slot["data"].get(tag_key)
                if rec is None:
                    slot["data"][tag_key] = list(sample[1])
                else:
                    for i, v in enumerate(sample[1]):
                        rec[i] += v
    return merged


def kv_metrics_json(merged: Dict[str, dict]) -> List[dict]:
    """JSON-friendly view of ``merge_kv_metrics`` output — the dashboard's
    ``/metrics?format=json`` body (tags as dicts, histograms as
    buckets/sum/count)."""
    out: List[dict] = []
    for name, slot in sorted(merged.items()):
        series = []
        for tag_key, val in sorted(slot["data"].items()):
            tags = dict(tag_key)
            if slot["type"] == "counter":
                series.append({"tags": tags, "value": val})
            elif slot["type"] == "gauge":
                series.append({"tags": tags, "value": val[0], "ts": val[1]})
            else:
                series.append({"tags": tags, "buckets": list(val[:-2]),
                               "sum": val[-2], "count": val[-1]})
        out.append({"name": name, "type": slot["type"],
                    "desc": slot["desc"], "bounds": slot.get("bounds"),
                    "series": series})
    return out


def render_prom_lines(merged: Dict[str, dict]) -> List[str]:
    """Prometheus/OpenMetrics text lines from ``merge_kv_metrics`` output:
    # HELP / # TYPE per family, escaped label values, cumulative
    ``_bucket``/``_sum``/``_count`` expansion for histograms."""

    def esc(v: str) -> str:
        return str(v).replace("\\", "\\\\").replace('"', '\\"') \
            .replace("\n", "\\n")

    def labels(tag_key, extra=None) -> str:
        parts = [f'{k}="{esc(v)}"' for k, v in tag_key]
        parts.extend(extra or ())
        return "{" + ",".join(parts) + "}" if parts else ""

    lines: List[str] = []
    for name, slot in sorted(merged.items()):
        kind = {"counter": "counter", "gauge": "gauge",
                "histogram": "histogram"}[slot["type"]]
        if slot["desc"]:
            lines.append(f"# HELP {name} {slot['desc']}")
        lines.append(f"# TYPE {name} {kind}")
        for tag_key, val in sorted(slot["data"].items()):
            if slot["type"] == "counter":
                lines.append(f"{name}{labels(tag_key)} {val}")
            elif slot["type"] == "gauge":
                lines.append(f"{name}{labels(tag_key)} {val[0]}")
            else:
                bounds = slot["bounds"] or []
                cum = 0
                for i, b in enumerate(bounds):
                    cum += val[i]
                    le = 'le="%s"' % b
                    lines.append(
                        f"{name}_bucket{labels(tag_key, [le])} {cum}")
                cum += val[len(bounds)]
                inf = 'le="+Inf"'
                lines.append(
                    f"{name}_bucket{labels(tag_key, [inf])} {cum}")
                lines.append(f"{name}_sum{labels(tag_key)} {val[-2]}")
                lines.append(f"{name}_count{labels(tag_key)} {val[-1]}")
    return lines


def render_kv_metrics(gcs) -> List[str]:
    """Prometheus text lines for every producer's KV samples — the
    dashboard's /metrics endpoint body."""
    return render_prom_lines(merge_kv_metrics(gcs))
