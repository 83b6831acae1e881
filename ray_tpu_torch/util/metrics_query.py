"""Pure query math over metric time-series points.

The GCS metrics table (``gcs.add_metric_points``) stores timestamped DELTA
points — counters and histograms ship increments per flush interval,
gauges ship value changes (see ``metrics.collect_points``).  Everything
here is a pure function over lists of those point dicts, so the query ops
(`state.query_metrics`, ``ray_tpu_torch metrics``, ``/api/metrics_range``) and
the alert rule engine share one implementation and the math is testable
without a cluster.

Shapes:

* point: ``{"name", "kind", "tags": [[k, v], ...], "ts", "value"}`` plus
  ``"bounds"`` for histograms (``value`` is then
  ``[bucket_deltas..., +inf_delta, sum_delta, count_delta]``).
* quantiles are computed Prometheus-style: merge the bucket deltas over
  the window, then linearly interpolate inside the target bucket — never
  by averaging per-producer percentiles (which has no meaning).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["filter_points", "rate", "sum_deltas", "merge_histogram",
           "quantile_from_buckets", "quantile_over_window", "last_value",
           "series_summary"]


def _tags_match(point_tags: Sequence, want: Optional[Dict[str, str]]) -> bool:
    if not want:
        return True
    have = {k: v for k, v in point_tags}
    return all(have.get(k) == v for k, v in want.items())


def filter_points(points: Iterable[dict], name: Optional[str] = None,
                  tags: Optional[Dict[str, str]] = None,
                  since: Optional[float] = None,
                  until: Optional[float] = None) -> List[dict]:
    """Range read: points for ``name`` whose tags contain ``tags`` and
    whose timestamp falls in ``(since, until]``, in timestamp order."""
    out = [p for p in points
           if (name is None or p["name"] == name)
           and (since is None or p["ts"] > since)
           and (until is None or p["ts"] <= until)
           and _tags_match(p.get("tags", ()), tags)]
    out.sort(key=lambda p: p["ts"])
    return out


def sum_deltas(points: Iterable[dict]) -> float:
    """Total increment across counter delta points (histogram points count
    their ``count`` increment)."""
    total = 0.0
    for p in points:
        v = p["value"]
        total += v[-1] if isinstance(v, list) else v
    return total


def rate(points: Iterable[dict], window_s: float,
         now: Optional[float] = None) -> float:
    """Per-second increase over the trailing window.  Because stored
    points are already deltas, this is a plain sum over the window divided
    by the window — no counter-reset heuristics needed."""
    if window_s <= 0:
        raise ValueError("window_s must be positive")
    pts = list(points)
    if now is None:
        now = max((p["ts"] for p in pts), default=0.0)
    windowed = [p for p in pts if now - window_s < p["ts"] <= now]
    return sum_deltas(windowed) / window_s


def last_value(points: Iterable[dict]) -> Optional[float]:
    """Latest gauge value (or counter delta) by timestamp."""
    best = None
    for p in points:
        if best is None or p["ts"] >= best["ts"]:
            best = p
    if best is None:
        return None
    v = best["value"]
    return v[-1] if isinstance(v, list) else v


def merge_histogram(points: Iterable[dict]
                    ) -> Optional[Tuple[List[float], List[float]]]:
    """Merge histogram delta points into one ``(bounds, totals)`` pair
    where ``totals`` is ``[bucket_counts..., +inf, sum, count]``.  Points
    with mismatched bounds are skipped (a redefined histogram mid-window —
    merging those buckets would be nonsense)."""
    bounds: Optional[List[float]] = None
    totals: Optional[List[float]] = None
    for p in points:
        if p.get("kind") != "histogram" or "bounds" not in p:
            continue
        if bounds is None:
            bounds = list(p["bounds"])
            totals = [0.0] * len(p["value"])
        elif list(p["bounds"]) != bounds or \
                len(p["value"]) != len(totals):
            continue
        for i, v in enumerate(p["value"]):
            totals[i] += v
    if bounds is None:
        return None
    return bounds, totals


def quantile_from_buckets(q: float, bounds: Sequence[float],
                          totals: Sequence[float]) -> Optional[float]:
    """Prometheus-style ``histogram_quantile`` over merged bucket counts
    (``totals`` = ``[per-bucket..., +inf, sum, count]``): walk the
    cumulative distribution to the target rank and interpolate linearly
    inside the containing bucket.  The +inf bucket clamps to the highest
    finite bound (nothing better is known).  Returns None on empty data."""
    if not 0.0 <= q <= 1.0:
        raise ValueError("q must be in [0, 1]")
    count = totals[-1]
    if count <= 0:
        return None
    target = q * count
    cum = 0.0
    for i, bound in enumerate(bounds):
        prev_cum = cum
        cum += totals[i]
        if cum >= target:
            lo = bounds[i - 1] if i > 0 else 0.0
            if totals[i] == 0:
                return bound
            return lo + (bound - lo) * (target - prev_cum) / totals[i]
    return float(bounds[-1]) if bounds else None


def quantile_over_window(points: Iterable[dict], q: float,
                         window_s: Optional[float] = None,
                         now: Optional[float] = None) -> Optional[float]:
    """Quantile of a histogram series over a trailing window: merge the
    window's bucket DELTAS, then take the quantile of the merged
    distribution."""
    pts = [p for p in points if p.get("kind") == "histogram"]
    if window_s is not None:
        if now is None:
            now = max((p["ts"] for p in pts), default=0.0)
        pts = [p for p in pts if now - window_s < p["ts"] <= now]
    merged = merge_histogram(pts)
    if merged is None:
        return None
    bounds, totals = merged
    return quantile_from_buckets(q, bounds, totals)


def series_summary(points: Iterable[dict], window_s: float = 60.0,
                   now: Optional[float] = None) -> List[dict]:
    """Group points into distinct ``(name, tags)`` series with activity
    stats — the backing for ``ray_tpu_torch metrics top``.  Counter/histogram
    series report their per-second rate over the trailing window; gauges
    report their latest value."""
    groups: Dict[Tuple, List[dict]] = {}
    for p in points:
        key = (p["name"], tuple(tuple(t) for t in p.get("tags", ())))
        groups.setdefault(key, []).append(p)
    if now is None:
        now = max((p["ts"] for g in groups.values() for p in g),
                  default=0.0)
    out = []
    for (name, tags), pts in groups.items():
        kind = pts[-1].get("kind", "counter")
        row = {"name": name, "tags": [list(t) for t in tags],
               "kind": kind, "points": len(pts),
               "last_ts": max(p["ts"] for p in pts)}
        if kind == "gauge":
            row["value"] = last_value(pts)
        else:
            row["rate"] = rate(pts, window_s, now=now)
            row["total"] = sum_deltas(pts)
            if kind == "histogram":
                row["p99"] = quantile_over_window(pts, 0.99, window_s, now)
        out.append(row)
    out.sort(key=lambda r: -(r.get("rate") or 0.0))
    return out
