"""State API — queryable cluster state.

Reference analogue: `python/ray/util/state/api.py` (``list_actors`` `:782`,
``list_nodes`` `:874`, ``list_tasks`` `:1009`, ``list_objects`` `:1054`,
``summarize_tasks`` `:1367`) over the dashboard's StateAggregator.  Sources:
the GCS tables — nodes/actors AND, since the task-event export landed, the
cluster-wide task-event table (every raylet batch-flushes its task
lifecycle events there) — plus the connected raylet's snapshot for
node-local object detail.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional


def _worker():
    from ray_tpu_torch.core.worker import global_worker

    return global_worker()


def _snapshot(objects_limit: int = 0) -> dict:
    w = _worker()
    if w.mode == "driver":
        return w.raylet.call(w.raylet.state_snapshot, objects_limit).result()
    if w.mode == "local":
        return {"node_id": "local", "tasks": [], "actors": [],
                "objects": {"num": 0, "items": []}, "events": [],
                "resources_total": {}, "resources_available": {}}
    return w._request("state_snapshot", objects_limit=objects_limit)


def _task_table_call(op: str, **kw):
    """Query the GCS task-event table cluster-wide.  The connected raylet's
    export buffer is flushed first so just-finished local tasks are visible;
    remote raylets flush on their own cadence (poll for their tail)."""
    w = _worker()
    if w.mode == "local":
        return None
    if w.mode == "driver":
        w.raylet.call(w.raylet.flush_task_events).result()
        return getattr(w.raylet.gcs, op)(**kw)
    # worker / client modes: the raylet flushes locally and proxies the op
    return w._request(op, **kw)


def _trace_table_call(op: str, **kw):
    """Query the GCS trace-span table cluster-wide.  This process's span
    buffer and the connected raylet's export buffer are flushed first so
    the freshest local spans count; remote raylets flush on their own
    cadence (poll for their tail)."""
    w = _worker()
    if w.mode == "local":
        return None
    from ray_tpu_torch.util import tracing as _tracing

    if w.mode == "driver":
        # driver + raylet share a process: the raylet drains the shared
        # span buffer itself
        w.raylet.call(w.raylet.flush_trace_spans).result()
        return getattr(w.raylet.gcs, op)(**kw)
    # worker / client modes: ship this process's buffer to the raylet,
    # which flushes locally and proxies the read
    _tracing.flush_spans()
    return w._request(op, **kw)


def _gcs_call(op: str, **kw):
    """Call a GCS op that must NOT be proxied synchronously through the
    raylet event thread (cluster-wide gathers like ``collect_stacks``
    push a ``node_query`` back at every raylet — a blocking proxy would
    deadlock against our own node's share).  Driver and client modes hold
    a GCS handle and call it from this thread; worker mode bounces off
    the raylet, which runs the gather on a throwaway thread."""
    w = _worker()
    if w.mode == "driver":
        return getattr(w.raylet.gcs, op)(**kw)
    if w.mode == "client":
        return getattr(w.gcs, op)(**kw)
    return None


def _profile_table_call(op: str, **kw):
    """Query the GCS profile table cluster-wide.  This process's sample
    window and the connected raylet's export buffer are flushed first so
    the freshest local samples count; remote raylets flush on their own
    cadence (``profile_flush_interval_s``)."""
    w = _worker()
    if w.mode == "local":
        return None
    from ray_tpu_torch.util import profiling as _profiling

    if w.mode == "driver":
        # driver + raylet share a process: the raylet drains the shared
        # sampler window itself
        w.raylet.call(w.raylet.flush_profile_samples).result()
        if op == "flush_profile_samples":
            return None
        return getattr(w.raylet.gcs, op)(**kw)
    # worker / client modes: ship this process's window to the raylet,
    # which flushes locally and proxies the read
    _profiling.flush_samples()
    return w._request(op, **kw)


def _metrics_table_call(op: str, **kw):
    """Query the GCS metrics time-series table cluster-wide.  This
    process's point ring and the connected raylet's export buffer are
    flushed first so the freshest local deltas count; remote raylets
    flush on their own cadence (``internal_metrics_interval_s``)."""
    w = _worker()
    if w.mode == "local":
        return None
    from ray_tpu_torch.util import metrics as _metrics

    if w.mode == "driver":
        # driver + raylet share a process: record this process's deltas
        # into the shared ring, which the raylet's flush drains itself
        _metrics.record_points()
        w.raylet.call(w.raylet.flush_metric_points).result()
        if op == "flush_metric_points":
            return None
        if "query_op" in kw:
            kw["op"] = kw.pop("query_op")
        return getattr(w.raylet.gcs, op)(**kw)
    # worker / client modes: ship this process's ring to the raylet,
    # which flushes locally and proxies the read.  The query kind rides
    # as query_op (the request frame's own "op" key is the table op);
    # the raylet proxy maps it back.
    _metrics.flush_points()
    return w._request(op, **kw)


# ----------------------------------------------------- metrics & alerts


def query_metrics(name: Optional[str] = None, op: str = "range",
                  tags: Optional[Dict[str, str]] = None,
                  node_id: Optional[str] = None,
                  since: Optional[float] = None,
                  until: Optional[float] = None,
                  window_s: float = 60.0, q: float = 0.99,
                  limit: int = 2000) -> Optional[Dict[str, Any]]:
    """Query the cluster metrics time-series table (timestamped DELTA
    points shipped by every node on its flush cadence).

    ``op``: ``range`` (the points), ``rate`` (per-second increase over
    the trailing ``window_s``), ``quantile`` (histogram quantile ``q``
    over the window — bucket deltas merged, never averaged percentiles),
    or ``series`` (per-series activity summary).  Returns None in local
    mode (no cluster, no table)."""
    return _metrics_table_call("query_metrics", name=name, query_op=op,
                               tags=tags, node_id=node_id, since=since,
                               until=until, window_s=window_s, q=q,
                               limit=limit)


def metrics_table_stats() -> Optional[Dict[str, Any]]:
    """Size/eviction accounting for the GCS metrics time-series table."""
    return _metrics_table_call("metrics_table_stats")


def list_alerts(state: Optional[str] = None,
                limit: int = 100) -> Optional[Dict[str, Any]]:
    """The alert table: currently-firing alerts plus the recent
    firing/resolved transition log (``state`` filters the log)."""
    w = _worker()
    if w.mode == "local":
        return None
    if w.mode == "driver":
        return w.raylet.gcs.list_alerts(state=state, limit=limit)
    return w._request("list_alerts", state=state, limit=limit)


# ------------------------------------------------------------- profiling


def list_stacks(target: Optional[str] = None,
                timeout_s: float = 3.0) -> Dict[str, Any]:
    """Live all-thread stacks from every process the target matches — the
    ``ray stack`` analogue, served by the processes themselves over the
    protocol (no external tracer, works on remote nodes).

    ``target``: ``None`` for the whole cluster (plus the GCS process), a
    node-id prefix for one node, or an actor name / actor-id prefix for
    exactly that actor's worker process.  Returns ``{"nodes": {node_id:
    [{"pid", "proc", "threads": [...]}, ...]}, "missing": [...]}`` —
    ``missing`` nodes didn't answer inside the timeout."""
    w = _worker()
    if w.mode == "local":
        return {"nodes": {}, "missing": []}
    node_id, actor_id = None, None
    if target is not None:
        nodes = [n["node_id"] for n in list_nodes()
                 if n["node_id"].startswith(target)]
        if nodes:
            node_id = target
        else:
            for a in list_actors():
                if (a["actor_id"].startswith(target)
                        or a.get("name") == target):
                    actor_id, node_id = a["actor_id"], a.get("node_id")
                    break
            if actor_id is None:
                raise ValueError(
                    f"stack target {target!r} matches no alive node id "
                    "prefix, actor id prefix, or actor name")
    kw = dict(node_id=node_id, timeout_s=timeout_s)
    if w.mode == "worker":
        out = w._request("collect_stacks", **kw)
    else:
        out = _gcs_call("collect_stacks", **kw)
    out = dict(out or {})
    if actor_id is not None:
        # keep only the matched actor's worker process (the raylet tags
        # each worker dump with its hosting actor id)
        out["nodes"] = {
            nid: [p for p in procs or []
                  if p.get("actor_id") == actor_id]
            for nid, procs in out.get("nodes", {}).items()
        }
        out["nodes"] = {nid: procs
                        for nid, procs in out["nodes"].items() if procs}
        out.pop("gcs", None)
    return out


def list_profile_samples(node_id: Optional[str] = None, since: float = 0.0,
                         limit: int = 100000) -> List[Dict[str, Any]]:
    """Retained folded stack-sample records (GCS profile table), oldest
    first — every process samples its threads at RAY_TPU_PROFILE_HZ and
    batch-flushes here (see ``util.profiling``)."""
    return list(_profile_table_call("list_profile_samples",
                                    node_id=node_id, since=since,
                                    limit=limit) or [])


def profile(duration_s: float = 2.0,
            node_id: Optional[str] = None) -> Dict[str, Any]:
    """Timed capture from the always-on samplers: wait out ``duration_s``
    (plus the flush cadence, so every node's window lands in the GCS
    table), then return the samples whose windows overlap the capture —
    with per-record task/trace/actor attribution — plus ready-to-load
    speedscope and collapsed-format exports.  Requires RAY_TPU_PROFILE=1
    (the default); with the kill switch thrown the capture comes back
    empty."""
    from ray_tpu_torch.core.config import config as _config
    from ray_tpu_torch.util import profiling as _profiling

    t0 = time.time()
    end = t0 + max(0.0, duration_s)
    time.sleep(max(0.0, duration_s))
    # stragglers: worker flushers tick every profile_flush_interval_s,
    # then each raylet posts on its own recurring tick — wait out both
    time.sleep(2.0 * _config.profile_flush_interval_s + 0.3)
    _profile_table_call("flush_profile_samples")
    samples = [rec for rec in list_profile_samples(node_id=node_id,
                                                   since=t0)
               if rec.get("t0", 0.0) <= end]
    return {
        "duration_s": duration_s,
        "t0": t0,
        "samples": samples,
        "num_samples": sum(int(r.get("count", 0)) for r in samples),
        "summary": _profiling.summarize(samples),
        "speedscope": _profiling.to_speedscope(
            samples, name=f"ray_tpu_torch profile ({duration_s:.1f}s)"),
        "collapsed": _profiling.to_collapsed(samples),
    }


def profile_summary(node_id: Optional[str] = None, since: float = 0.0,
                    limit: int = 100000, top: int = 30) -> Dict[str, Any]:
    """The "where does the CPU go" table over the retained continuous
    profile: per-function self/inclusive sample counts and shares, per
    process kind, plus the profile-table accounting."""
    from ray_tpu_torch.util import profiling as _profiling

    samples = list_profile_samples(node_id=node_id, since=since,
                                   limit=limit)
    out = _profiling.summarize(samples, top=top)
    out["table"] = dict(_profile_table_call("profile_table_stats") or {})
    return out


def export_profile(filename: str, fmt: str = "speedscope",
                   node_id: Optional[str] = None, since: float = 0.0,
                   limit: int = 100000) -> int:
    """Write retained profile samples as a speedscope JSON document
    (https://speedscope.app) or flamegraph.pl collapsed text.  Returns
    the number of sample records exported."""
    import json as _json

    from ray_tpu_torch.util import profiling as _profiling

    samples = list_profile_samples(node_id=node_id, since=since,
                                   limit=limit)
    if fmt == "speedscope":
        with open(filename, "w") as f:
            _json.dump(_profiling.to_speedscope(samples), f)
    elif fmt == "collapsed":
        with open(filename, "w") as f:
            f.write(_profiling.to_collapsed(samples))
    else:
        raise ValueError(f"unknown profile export format {fmt!r} "
                         "(speedscope | collapsed)")
    return len(samples)


# ------------------------------------------------------------------ logs


def _logs_query(node_id: Optional[str], payload: dict,
                timeout_s: float) -> Dict[str, Any]:
    w = _worker()
    if w.mode == "local":
        return {"reports": {}, "missing": []}
    kw = dict(node_id=node_id, kind="logs", payload=payload,
              timeout_s=timeout_s)
    if w.mode == "worker":
        return dict(w._request("gcs_node_query", **kw) or {})
    return dict(_gcs_call("node_query", **kw) or {})


def list_logs(node_id: Optional[str] = None,
              timeout_s: float = 3.0) -> Dict[str, List[dict]]:
    """Per-worker log files under each node's ``session_dir/logs``
    (cluster mode), as ``{node_id: [{"name", "size", "mtime", "pid"}]}``
    — the ``ray logs`` listing, served by each raylet over the
    protocol."""
    out = _logs_query(node_id, {"action": "list"}, timeout_s)
    return {nid: rep for nid, rep in out.get("reports", {}).items()
            if isinstance(rep, list)}


def tail_log(name: str, node_id: Optional[str] = None,
             offset: Optional[int] = None, lines: int = 100,
             timeout_s: float = 3.0) -> Optional[Dict[str, Any]]:
    """One read of a worker log file: the last ``lines`` lines (or, with
    ``offset``, everything after it — feed the returned ``offset`` back
    to poll/follow).  With no ``node_id`` the first node holding the file
    answers."""
    out = _logs_query(node_id, {"action": "tail", "name": name,
                                "offset": offset, "lines": lines},
                      timeout_s)
    hits = [rep for _nid, rep in sorted(out.get("reports", {}).items())
            if isinstance(rep, dict) and "data" in rep]
    if not hits:
        return None
    if len(hits) > 1:
        # worker log names are per-raylet sequences (worker-00001.log
        # exists on EVERY node): never silently serve the wrong node's
        # file — flag the ambiguity so callers can re-ask with node_id
        hits[0]["ambiguous_nodes"] = [rep["node_id"] for rep in hits]
    return hits[0]


def list_trace_spans(job_id: Optional[str] = None,
                     limit: int = 10000) -> List[Dict[str, Any]]:
    """The most recent retained span records, cluster-wide (GCS trace
    table, start-time ordered)."""
    return list(_trace_table_call("list_trace_spans", job_id=job_id,
                                  limit=limit) or [])


def get_trace(trace_id: str) -> Dict[str, Any]:
    """Reassemble one request's cross-process span tree plus its latency
    waterfall: ``{"trace_id", "spans", "tree", "critical_path"}`` —
    ``tree`` nests children under parents across every process the
    request touched; ``critical_path`` is the per-hop attribution (see
    ``util.trace_analysis``)."""
    from ray_tpu_torch.util import trace_analysis

    spans = list(_trace_table_call("get_trace", trace_id=trace_id) or [])
    return {
        "trace_id": trace_id,
        "spans": spans,
        "tree": trace_analysis.build_tree(spans),
        "critical_path": trace_analysis.critical_path(spans),
    }


def trace_summary(job_id: Optional[str] = None,
                  limit: int = 100000) -> Dict[str, Any]:
    """The "where do the microseconds go" table: per-hop p50/p95/total
    attributed self-time aggregated over every retained trace, plus the
    trace-table accounting (span/trace counts, drop counter)."""
    from ray_tpu_torch.util import trace_analysis

    spans = list(_trace_table_call("list_trace_spans", job_id=job_id,
                                   limit=limit) or [])
    out = trace_analysis.aggregate(spans)
    out["table"] = dict(_trace_table_call("trace_table_stats") or {})
    return out


def export_trace(filename: str, trace_id: Optional[str] = None,
                 job_id: Optional[str] = None, limit: int = 100000) -> int:
    """Write retained spans (one trace, or everything) as
    Perfetto/chrome://tracing JSON.  Returns the event count."""
    import json as _json

    from ray_tpu_torch.util import trace_analysis

    if trace_id is not None:
        spans = list(_trace_table_call("get_trace", trace_id=trace_id)
                     or [])
    else:
        spans = list(_trace_table_call("list_trace_spans", job_id=job_id,
                                       limit=limit) or [])
    doc = trace_analysis.to_chrome_trace(spans)
    with open(filename, "w") as f:
        _json.dump(doc, f)
    return len(doc["traceEvents"])


def list_nodes() -> List[Dict[str, Any]]:
    """Cluster membership with resources (GCS node table)."""
    w = _worker()
    return [
        {
            "node_id": n["node_id"],
            "state": ("DEAD" if not n.get("alive", True)
                      else "DRAINING" if n.get("draining")
                      else "SUSPECT" if n.get("suspect")
                      else "ALIVE"),
            "incarnation": n.get("incarnation", 0),
            "address": n.get("address"),
            "hostname": n.get("hostname", ""),
            "resources_total": n.get("resources_total", {}),
            "resources_available": n.get("resources_available", {}),
        }
        for n in w.gcs_nodes()
    ]


def list_actors(state: Optional[str] = None) -> List[Dict[str, Any]]:
    """Cluster-wide actor table (GCS) merged with the local raylet's
    richer per-actor detail when available."""
    w = _worker()
    local = {a["actor_id"]: a for a in _snapshot().get("actors", [])}
    if w.mode == "driver":
        gcs_actors = w.raylet.gcs.list_actors()
    elif w.mode == "client":
        gcs_actors = w.gcs.list_actors()
    elif w.mode == "worker":
        gcs_actors = w._request("gcs_list_actors")
    else:
        gcs_actors = []
    out = {}
    for a in gcs_actors:
        out[a["actor_id"]] = {
            "actor_id": a["actor_id"],
            "state": a.get("state", "?").upper(),
            "name": a.get("name"),
            "owner_node": a.get("owner_node"),
            "node_id": a.get("exec_node") or a.get("owner_node"),
        }
    for aid, a in local.items():
        entry = out.setdefault(aid, {"actor_id": aid})
        entry.update({
            "state": a["state"].upper(),
            "name": a.get("name"),
            "pid": a.get("pid"),
        })
    results = list(out.values())
    if state is not None:
        results = [a for a in results if a.get("state") == state.upper()]
    return results


def list_tasks(state: Optional[str] = None,
               limit: int = 1000) -> List[Dict[str, Any]]:
    """Cluster-wide task table: latest known state per task from the GCS
    task-event table (reference: ``list_tasks``, `api.py:1009`), including
    tasks executed on OTHER nodes."""
    rows = _task_table_call("list_task_events", state=state, limit=limit)
    return list(rows or [])


def list_objects(limit: int = 1000) -> List[Dict[str, Any]]:
    """Object metadata known to the connected raylet.  Routed through the
    raylet-thread ``state_snapshot`` (never reads ``_objects`` off-thread)
    with ``limit`` applied at the source, before materializing."""
    snap = _snapshot(objects_limit=max(1, limit))
    return list(snap.get("objects", {}).get("items") or [])


def summarize_tasks() -> Dict[str, int]:
    """State -> count, cluster-wide (reference: ``summarize_tasks``,
    `api.py:1367`)."""
    summary = _task_table_call("summarize_task_events")
    return dict((summary or {}).get("by_state", {}))


def task_events_summary() -> Dict[str, Any]:
    """Full task-event accounting: state counts, distinct reporting nodes,
    and the cluster-wide export drop counter (ring-buffer backpressure)."""
    return dict(_task_table_call("summarize_task_events") or {})


def summarize_objects() -> Dict[str, Any]:
    objs = list_objects(limit=100000)
    by_status: Dict[str, int] = {}
    for o in objs:
        by_status[o["status"]] = by_status.get(o["status"], 0) + 1
    return {"total": len(objs), "by_status": by_status,
            "bytes_known": sum(o.get("size", 0) for o in objs)}


# --------------------------------------------------------------- timeline


def build_timeline(events: List[dict], spans: Optional[List[dict]] = None,
                   now: Optional[float] = None) -> List[dict]:
    """chrome://tracing trace from raw task events (and, when tracing is
    on, driver-side submit spans).

    Per task attempt, TWO sub-slices make queue wait visible next to run
    time: ``queue_wait`` (QUEUED/PENDING_ARGS -> dispatch) and ``run``
    (dispatch -> terminal).  Still-in-flight tasks get an OPEN-ENDED slice
    ending at ``now`` instead of being silently dropped, and tasks that
    fail before dispatch close their queue slice at the failure — nothing
    leaks (reference: ``ray.timeline``, `python/ray/_private/state.py:416`).
    Submit spans become flow arrows (``s``/``f``) from the submitting
    process to the first run slice of the task.
    """
    now = time.time() if now is None else now
    per_task: Dict[str, List[dict]] = {}
    for ev in sorted(events, key=lambda e: e.get("time", 0.0)):
        per_task.setdefault(ev["task_id"], []).append(ev)

    trace: List[dict] = []
    first_run: Dict[str, dict] = {}  # task_id -> first run slice (flow tgt)

    def emit(name, phase, t0, t1, pid, tid_hex, **args):
        sl = {
            "cat": "task", "name": name, "ph": "X",
            "ts": t0 * 1e6, "dur": max(0.0, (t1 - t0)) * 1e6,
            "pid": pid, "tid": pid,
            "args": {"phase": phase, "task_id": tid_hex, **args},
        }
        trace.append(sl)
        return sl

    for tid, evs in per_task.items():
        name = next((e.get("name") for e in evs if e.get("name")), tid[:8])
        queued_t: Optional[float] = None
        run_t: Optional[float] = None
        pid = 0
        node = evs[-1].get("node_id", "")
        # task events <-> traces: a sampled request's timeline slices
        # carry its trace id, so a slow slice jumps to its waterfall
        trace_id = next((e["trace_id"] for e in evs
                         if e.get("trace_id")), None)
        targs = {"trace_id": trace_id} if trace_id else {}
        for ev in evs:
            st = ev.get("state")
            t = ev.get("time", 0.0)
            if st in ("PENDING_ARGS", "QUEUED", "PENDING"):
                if queued_t is None:
                    queued_t = t
            elif st in ("RUNNING", "DISPATCHED"):
                if run_t is None:
                    run_t = t
                    pid = ev.get("pid") or 0
                    if queued_t is not None:
                        emit(name, "queue_wait", queued_t, t, pid, tid,
                             node_id=ev.get("node_id", node), **targs)
                        queued_t = None
            elif st in ("FINISHED", "FAILED", "OOM_KILLED"):
                start = run_t if run_t is not None else t
                sl = emit(name, "run", start, t, pid, tid, state=st,
                          node_id=ev.get("node_id", node), **targs,
                          **({"error": ev["error"]} if ev.get("error")
                             else {}))
                first_run.setdefault(tid, sl)
                run_t = queued_t = None
            elif st in ("RETRYING", "REQUEUED", "SPILLED", "FORWARDED",
                        "RECONSTRUCTING"):
                # attempt boundary: close whatever phase was open here
                if run_t is not None:
                    sl = emit(name, "run", run_t, t, pid, tid, state=st,
                              node_id=ev.get("node_id", node), **targs)
                    first_run.setdefault(tid, sl)
                elif queued_t is not None:
                    emit(name, "queue_wait", queued_t, t, pid, tid, state=st,
                         node_id=ev.get("node_id", node), **targs)
                run_t = queued_t = None
        # in-flight work: open-ended slices up to `now` (never dropped)
        if run_t is not None:
            sl = emit(name, "run", run_t, now, pid, tid, state="RUNNING",
                      in_flight=True, node_id=node, **targs)
            first_run.setdefault(tid, sl)
        elif queued_t is not None:
            emit(name, "queue_wait", queued_t, now, pid, tid,
                 in_flight=True, node_id=node, **targs)

    # flow arrows from submit spans (tracing on): submitting process ->
    # the task's first run slice
    for sp in spans or []:
        tid = (sp.get("attributes") or {}).get("task_id")
        if not tid or not str(sp.get("name", "")).startswith("task.submit"):
            continue
        t0 = sp.get("start_us", 0) / 1e6
        t1 = t0 + sp.get("duration_us", 0) / 1e6
        spid = sp.get("pid", 0)
        trace.append({"cat": "submit", "name": sp["name"], "ph": "X",
                      "ts": t0 * 1e6,
                      "dur": sp.get("duration_us", 0), "pid": spid,
                      "tid": spid, "args": {"task_id": tid}})
        target = first_run.get(tid)
        if target is None:
            continue
        trace.append({"cat": "flow", "name": "submit", "ph": "s",
                      "id": tid, "ts": t1 * 1e6, "pid": spid, "tid": spid})
        trace.append({"cat": "flow", "name": "submit", "ph": "f",
                      "bp": "e", "id": tid, "ts": target["ts"],
                      "pid": target["pid"], "tid": target["tid"]})
    return trace


def raw_task_events(limit: int = 100000) -> List[dict]:
    """The cluster-wide raw event log (every recorded transition)."""
    return list(_task_table_call("task_events_raw", limit=limit) or [])
