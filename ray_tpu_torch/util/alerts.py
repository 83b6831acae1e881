"""Declarative alert rules over the metrics time-series table.

A rule is a plain JSON-able dict; the GCS evaluates the active rule set
on its metrics flush cadence against its own ``_metric_points`` table and
appends typed alert records (firing / resolved transitions) into a
bounded alert table (``gcs.list_alerts``, ``ray_tpu_torch alerts``,
``/api/alerts``).  Evaluation itself is a pure function over a point
query callback, so the firing/resolve semantics are testable without a
cluster.

Two rule kinds:

* ``threshold`` — aggregate one series over a trailing window (``rate``,
  ``sum``, ``last``, ``max``, ``p50``/``p90``/``p99``) and compare against
  a bound::

      {"name": "fenced_frame_spike", "kind": "threshold",
       "metric": "ray_tpu_internal_fenced_frames_total",
       "agg": "rate", "window_s": 60, "op": ">", "threshold": 1.0,
       "severity": "warn", "summary": "..."}

* ``burn_rate`` — multi-window SLO burn (Google SRE workbook shape): the
  bad/total event ratio must exceed ``factor`` times the error budget
  (``1 - objective``) in BOTH a short and a long trailing window.  The
  long window gates on sustained damage, the short window makes the alert
  resolve promptly once the condition clears::

      {"name": "serve_shed_burn", "kind": "burn_rate",
       "bad": "ray_tpu_internal_serve_shed_total",
       "total": "ray_tpu_internal_serve_requests_total",
       "objective": 0.99, "short_s": 15, "long_s": 120, "factor": 10,
       "severity": "critical", "summary": "..."}

Ratios are computed from delta sums over each window, so a partially
filled window is exact (both numerator and denominator cover the same
span) — no warm-up distortion.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import config
from ray_tpu_torch.util import metrics_query as mq

__all__ = ["evaluate_rules", "default_rules", "load_rules", "eval_threshold",
           "eval_burn_rate"]

# query callback: (metric_name, tags, since) -> list of point dicts
QueryFn = Callable[[str, Optional[Dict[str, str]], Optional[float]],
                   List[dict]]

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


def default_rules() -> List[dict]:
    """Built-in rules for the invariants earlier PRs established."""
    return [
        {"name": "false_suspect_rate", "kind": "threshold",
         "metric": "ray_tpu_internal_false_suspects_total",
         "agg": "rate", "window_s": 300.0, "op": ">", "threshold": 0.02,
         "severity": "warn",
         "summary": "failure detector is suspecting healthy nodes "
                    "(probes keep rescuing them) — check net health or "
                    "raise gcs_node_suspect_s"},
        {"name": "fenced_frame_spike", "kind": "threshold",
         "metric": "ray_tpu_internal_fenced_frames_total",
         "agg": "rate", "window_s": 60.0, "op": ">", "threshold": 1.0,
         "severity": "warn",
         "summary": "stale-incarnation frames are being fenced at a "
                    "sustained rate — a zombie raylet or partitioned "
                    "node is still talking"},
        {"name": "replication_repair_pressure", "kind": "threshold",
         "metric": "ray_tpu_internal_replication_repairs_total",
         "agg": "rate", "window_s": 120.0, "op": ">", "threshold": 1.0,
         "severity": "warn",
         "summary": "replication repair is running continuously — "
                    "object copies are being lost faster than steady "
                    "state"},
        {"name": "serve_shed_burn", "kind": "burn_rate",
         "bad": "ray_tpu_internal_serve_shed_total",
         "total": "ray_tpu_internal_serve_requests_total",
         "objective": 0.99, "short_s": 15.0, "long_s": 120.0,
         "factor": 10.0, "severity": "critical",
         "summary": "Serve is shedding requests fast enough to burn the "
                    "99% admission SLO 10x faster than budget — scale "
                    "out replicas or shed upstream"},
        {"name": "serve_p99_latency", "kind": "threshold",
         "metric": "ray_tpu_internal_serve_request_latency_s",
         "agg": "p99", "window_s": 60.0, "op": ">", "threshold": 1.0,
         "severity": "warn",
         "summary": "Serve p99 request latency is above the 1s default "
                    "objective over the last minute"},
        {"name": "task_event_drops", "kind": "threshold",
         "metric": "ray_tpu_internal_task_events_dropped_total",
         "agg": "rate", "window_s": 60.0, "op": ">", "threshold": 0.0,
         "severity": "info",
         "summary": "task-event export buffer is overflowing — state "
                    "API history has holes (raise "
                    "task_event_export_buffer)"},
        {"name": "trace_span_drops", "kind": "threshold",
         "metric": "ray_tpu_internal_trace_spans_dropped_total",
         "agg": "rate", "window_s": 60.0, "op": ">", "threshold": 0.0,
         "severity": "info",
         "summary": "trace spans are being dropped before export — "
                    "lower the sample rate or raise trace_buffer_size"},
        {"name": "profile_sample_drops", "kind": "threshold",
         "metric": "ray_tpu_internal_profile_samples_dropped_total",
         "agg": "rate", "window_s": 60.0, "op": ">", "threshold": 0.0,
         "severity": "info",
         "summary": "profile samples are being dropped before export"},
        {"name": "metric_point_drops", "kind": "threshold",
         "metric": "ray_tpu_internal_metric_points_dropped_total",
         "agg": "rate", "window_s": 60.0, "op": ">", "threshold": 0.0,
         "severity": "info",
         "summary": "metric time-series points are being dropped before "
                    "export — raise metrics_history_ring"},
    ]


def load_rules() -> List[dict]:
    """The active rule set: defaults (unless disabled) overridden/extended
    by the RAY_TPU_ALERTS_RULES JSON list, keyed by rule name.  Malformed
    JSON or non-list payloads are ignored rather than killing the health
    monitor."""
    rules = {r["name"]: r for r in default_rules()} \
        if config.alerts_default_rules else {}
    raw = config.alerts_rules
    if raw:
        try:
            extra = json.loads(raw)
        except ValueError:
            extra = None
        if isinstance(extra, list):
            for r in extra:
                if isinstance(r, dict) and r.get("name"):
                    rules[r["name"]] = r
    return list(rules.values())


def eval_threshold(rule: dict, query: QueryFn, now: float
                   ) -> Tuple[bool, Optional[float]]:
    """Evaluate one threshold rule.  Returns ``(firing, value)``;
    ``value`` is None when the window holds no data (never firing —
    absence of telemetry is the drop-counter rules' job, not a threshold
    breach)."""
    window = float(rule.get("window_s", 60.0))
    pts = query(rule["metric"], rule.get("tags"), now - window)
    pts = [p for p in pts if p["ts"] <= now]
    agg = rule.get("agg", "rate")
    value: Optional[float]
    if agg == "rate":
        value = mq.rate(pts, window, now=now) if pts else None
    elif agg == "sum":
        value = mq.sum_deltas(pts) if pts else None
    elif agg == "last":
        value = mq.last_value(pts)
    elif agg == "max":
        vals = [p["value"] for p in pts
                if not isinstance(p["value"], list)]
        value = max(vals) if vals else None
    elif agg in ("p50", "p90", "p99"):
        q = {"p50": 0.5, "p90": 0.9, "p99": 0.99}[agg]
        value = mq.quantile_over_window(pts, q, window, now=now)
    else:
        raise ValueError(f"unknown agg {agg!r} in rule {rule['name']!r}")
    if value is None:
        return False, None
    op = _OPS[rule.get("op", ">")]
    return op(value, float(rule["threshold"])), value


def eval_burn_rate(rule: dict, query: QueryFn, now: float
                   ) -> Tuple[bool, Optional[float]]:
    """Evaluate one multi-window burn-rate rule.  Returns ``(firing,
    value)`` where ``value`` is the binding (smaller) window's burn
    multiple — how many times faster than budget the SLO is burning."""
    budget = 1.0 - float(rule.get("objective", 0.99))
    if budget <= 0:
        raise ValueError(f"objective must be < 1 in rule {rule['name']!r}")
    factor = float(rule.get("factor", 10.0))
    tags = rule.get("tags")
    burns = []
    for window in (float(rule.get("short_s", 15.0)),
                   float(rule.get("long_s", 120.0))):
        bad_pts = [p for p in query(rule["bad"], tags, now - window)
                   if p["ts"] <= now]
        tot_pts = [p for p in query(rule["total"], tags, now - window)
                   if p["ts"] <= now]
        bad = mq.sum_deltas(bad_pts)
        total = mq.sum_deltas(tot_pts)
        ratio = (bad / total) if total > 0 else 0.0
        burns.append(ratio / budget)
    value = min(burns)
    return value > factor, value


def evaluate_rules(rules: List[dict], query: QueryFn, now: float,
                   active: Dict[str, dict]) -> List[dict]:
    """One evaluation pass.  ``active`` (rule name -> firing record) is
    mutated in place to track alert state across passes; the return value
    is the list of NEW transition records to append to the alert log —
    one on firing, one on resolve, nothing while a state persists.  A
    rule that errors (bad metric name, malformed spec) is skipped: one
    broken rule must not silence the rest."""
    records: List[dict] = []
    for rule in rules:
        try:
            if rule.get("kind") == "burn_rate":
                firing, value = eval_burn_rate(rule, query, now)
                threshold = float(rule.get("factor", 10.0))
            else:
                firing, value = eval_threshold(rule, query, now)
                threshold = float(rule["threshold"])
        except Exception:  # noqa: BLE001 — skip broken rule, keep rest
            continue
        name = rule["name"]
        cur = active.get(name)
        if firing:
            if cur is None:
                rec = {"rule": name, "state": "firing",
                       "severity": rule.get("severity", "warn"),
                       "kind": rule.get("kind", "threshold"),
                       "value": value, "threshold": threshold,
                       "since": now, "ts": now,
                       "summary": rule.get("summary", "")}
                active[name] = rec
                records.append(dict(rec))
            else:
                # still firing: refresh the live view, no new log record
                cur["value"] = value
                cur["ts"] = now
        elif cur is not None:
            active.pop(name)
            rec = dict(cur)
            rec.update({"state": "resolved", "value": value,
                        "ts": now})
            records.append(rec)
    return records
