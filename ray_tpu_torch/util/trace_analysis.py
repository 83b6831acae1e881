"""Trace analysis: span-tree reassembly, critical-path attribution,
cross-request aggregation, Perfetto/chrome://tracing export.

The raw material is the flat span records the tracing layer exports
(``util/tracing.py`` — one dict per finished span, cross-process parenting
via ``parent_id``).  Everything here is pure computation over those dicts
so the same code serves ``get_trace`` in the driver, the dashboard's
``/api/trace/<id>``, and the ``ray_tpu_torch trace`` CLI.

Critical-path model: request hops are (mostly) sequential wall-clock
intervals — submit encode, raylet inbox, queue wait, dispatch, arg
resolution, execution, result push, seal, caller wakeup.  Attribution is a
sweep over the trace window assigning every instant to the LATEST-STARTED
span active at that instant (the most specific work going on: during
execution ``worker.exec`` out-ranks the enclosing ``task.run``, which
out-ranks the caller's ``task.get``); instants covered by no span are
``(untraced)``.  The attributed self-times sum exactly to the trace window,
so "where do the microseconds go" tables account for the whole request.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

__all__ = ["build_tree", "critical_path", "aggregate", "to_chrome_trace"]

UNTRACED = "(untraced)"


def _hop_name(sp: dict) -> str:
    """Aggregation key: span name minus the per-request suffix
    (``raylet.queue sq.m`` -> ``raylet.queue``)."""
    return str(sp.get("name", "?")).split(" ", 1)[0]


def build_tree(spans: List[dict]) -> List[dict]:
    """Reassemble the cross-process span tree: each node is the span dict
    plus a ``children`` list (sorted by start time).  Spans whose parent
    never exported (e.g. an unsampled ancestor of an errored span) float
    up as roots rather than being dropped."""
    by_id: Dict[str, dict] = {}
    for sp in spans:
        node = dict(sp)
        node["children"] = []
        by_id[sp["span_id"]] = node
    roots: List[dict] = []
    for node in by_id.values():
        parent = by_id.get(node.get("parent_id") or "")
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    for node in by_id.values():
        node["children"].sort(key=lambda n: n.get("start_us", 0))
    roots.sort(key=lambda n: n.get("start_us", 0))
    return roots


def critical_path(spans: List[dict]) -> Dict[str, Any]:
    """Latency waterfall + per-hop attribution for ONE trace.

    Returns ``{"total_us", "start_us", "rows", "by_hop"}``: ``rows`` is
    the waterfall (every span, start-ordered, with its attributed
    ``self_us``); ``by_hop`` sums attributed time per hop name (plus
    ``(untraced)`` for instants no span covered).  ``sum(by_hop.values())
    == total_us`` by construction."""
    spans = [sp for sp in spans if sp.get("duration_us") is not None]
    if not spans:
        return {"total_us": 0, "start_us": 0, "rows": [], "by_hop": {}}
    ivs = []  # (start, end, order-index, span)
    # sort: start ascending, then duration DESCENDING — among same-start
    # spans the shorter (more specific) one gets the higher order index
    # and wins the tie-break below
    for sp in sorted(spans, key=lambda s: (s["start_us"],
                                           -s.get("duration_us", 0))):
        s = sp["start_us"]
        ivs.append((s, s + max(0, sp.get("duration_us", 0)), len(ivs), sp))
    t0 = min(iv[0] for iv in ivs)
    t1 = max(iv[1] for iv in ivs)
    bounds = sorted({b for iv in ivs for b in iv[:2]})
    self_us = [0] * len(ivs)
    by_hop: Dict[str, int] = {}
    for lo, hi in zip(bounds, bounds[1:]):
        seg = hi - lo
        if seg <= 0:
            continue
        # latest-started active span wins the segment (ties: the later,
        # shorter entry — the more specific child)
        winner = None
        for iv in ivs:
            if iv[0] <= lo and iv[1] >= hi:
                if winner is None or (iv[0], iv[2]) >= (winner[0],
                                                        winner[2]):
                    winner = iv
        if winner is None:
            by_hop[UNTRACED] = by_hop.get(UNTRACED, 0) + seg
        else:
            self_us[winner[2]] += seg
            key = _hop_name(winner[3])
            by_hop[key] = by_hop.get(key, 0) + seg
    rows = []
    for start, end, idx, sp in ivs:
        rows.append({
            "name": sp.get("name"),
            "hop": _hop_name(sp),
            "span_id": sp.get("span_id"),
            "parent_id": sp.get("parent_id"),
            "offset_us": start - t0,
            "duration_us": end - start,
            "self_us": self_us[idx],
            "proc": sp.get("proc"),
            "node": sp.get("node"),
            "status": sp.get("status", "OK"),
        })
    return {"total_us": t1 - t0, "start_us": t0, "rows": rows,
            "by_hop": by_hop}


def _pct(sorted_vals: List[int], q: float) -> int:
    if not sorted_vals:
        return 0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


def aggregate(spans: List[dict]) -> Dict[str, Any]:
    """The "where do the microseconds go" table: group spans by trace,
    run critical-path attribution per trace, then distribute — per hop:
    request count, p50/p95/total attributed self-time, and the hop's share
    of summed request latency.  This is the before/after yardstick for
    transport/cold-start work: run a fixed workload, diff the table."""
    by_trace: Dict[str, List[dict]] = {}
    for sp in spans:
        by_trace.setdefault(sp.get("trace_id", "?"), []).append(sp)
    per_hop: Dict[str, List[int]] = {}
    totals: List[int] = []
    errored = 0
    for tid, tspans in by_trace.items():
        cp = critical_path(tspans)
        totals.append(cp["total_us"])
        if any(sp.get("status") == "ERROR" for sp in tspans):
            errored += 1
        for hop_name, us in cp["by_hop"].items():
            per_hop.setdefault(hop_name, []).append(us)
    table = {}
    grand = sum(totals) or 1
    for hop_name, vals in per_hop.items():
        vals.sort()
        table[hop_name] = {
            "requests": len(vals),
            "p50_us": _pct(vals, 0.50),
            "p95_us": _pct(vals, 0.95),
            "total_us": sum(vals),
            "share": round(sum(vals) / grand, 4),
        }
    totals.sort()
    return {
        "requests": len(by_trace),
        "errored": errored,
        "e2e_p50_us": _pct(totals, 0.50),
        "e2e_p95_us": _pct(totals, 0.95),
        "by_hop": dict(sorted(table.items(),
                              key=lambda kv: -kv[1]["total_us"])),
    }


def to_chrome_trace(spans: List[dict]) -> Dict[str, Any]:
    """Perfetto / chrome://tracing JSON (object form with ``traceEvents``):
    one complete ('X') event per span, lanes keyed by producing process
    (proc label + node + pid), named via process_name metadata events."""
    events: List[dict] = []
    lanes: Dict[tuple, int] = {}
    for sp in spans:
        key = (sp.get("proc", "?"), sp.get("node", ""), sp.get("pid", 0))
        lane = lanes.get(key)
        if lane is None:
            lane = lanes[key] = len(lanes) + 1
            label = f"{key[0]} {key[1]}".strip() + f" (pid={key[2]})"
            events.append({"ph": "M", "name": "process_name", "pid": lane,
                           "tid": 0, "args": {"name": label}})
        args = dict(sp.get("attributes") or {})
        args.update({"trace_id": sp.get("trace_id"),
                     "span_id": sp.get("span_id"),
                     "parent_id": sp.get("parent_id"),
                     "status": sp.get("status", "OK")})
        if sp.get("error"):
            args["error"] = sp["error"]
        events.append({
            "ph": "X", "cat": "span",
            "name": sp.get("name", "?"),
            "pid": lane, "tid": lane,
            "ts": sp.get("start_us", 0),
            "dur": max(0, sp.get("duration_us", 0)),
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
