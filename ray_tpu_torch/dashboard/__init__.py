"""Dashboard head: HTTP API over cluster state + Prometheus metrics.

Reference analogue: `dashboard/head.py:81` (aiohttp app with per-subsystem
modules) + `dashboard/state_aggregator.py`.  Re-designed small: one
threaded HTTP server reading the GCS tables directly over the existing
framed-socket client — no agent processes, no driver attach — so it can
run next to the GCS on the head node or anywhere that can reach it.

Endpoints:
  GET /                      tiny HTML overview
  GET /api/nodes             GCS node table
  GET /api/actors            GCS actor table
  GET /api/jobs              job-submission records (GCS KV)
  GET /api/cluster_resources {total, available} aggregated over alive nodes
  GET /api/load              autoscaler load metrics (demand + idle)
  GET /api/placement_groups  cluster PG table
  GET /api/tasks             cluster-wide task table (GCS task events)
  GET /api/task_summary      state->count + export-drop accounting
  GET /api/timeline          chrome://tracing trace of the task events
  GET /api/trace/<trace_id>  one request's span tree + latency waterfall
  GET /api/trace_summary     per-hop p50/p95 attribution over all traces
  GET /api/health            GCS failure-detection stats (health_stats)
  GET /api/stacks            live all-thread stacks from every cluster
                             process (?node=<prefix> targets one node)
  GET /api/profile           continuous-profiling summary over the GCS
                             profile table (?node=&since=&top=); add
                             &format=speedscope|collapsed for a raw
                             flamegraph export
  GET /api/logs              per-worker log files per node (?node=);
                             ?node=<prefix>&file=<name>[&lines=N] tails
  GET /metrics               Prometheus/OpenMetrics text exposition
                             (system gauges + internal ray_tpu_internal_*
                             incl. the GCS-side health series + user
                             metrics); ?format=json for the same series
                             as a JSON document
  GET /api/metrics_range     time-series reads over the GCS metrics table
                             (?name=&op=range|rate|quantile|series&tags=
                             k=v,...&node=&since=&until=&window=&q=&limit=)
  GET /api/alerts            firing alerts + transition log from the GCS
                             rule engine (?state=firing|resolved&limit=)
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ray_tpu_torch.core.gcs import GcsClient

__all__ = ["DashboardHead"]


def _prom_escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class DashboardHead:
    def __init__(self, gcs_address: str, host: str = "127.0.0.1",
                 port: int = 0):
        self._gcs = GcsClient(gcs_address)
        self._gcs_address = gcs_address
        dash = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                try:
                    parsed = urlparse(self.path)
                    query = {k: v[0] for k, v in
                             parse_qs(parsed.query).items()}
                    body, ctype = dash._route(parsed.path, query)
                except KeyError:
                    self.send_error(404)
                    return
                except ValueError as e:
                    # malformed query parameter (?lines=foo): caller error
                    self.send_error(400, str(e))
                    return
                except Exception as e:  # noqa: BLE001
                    self.send_error(500, str(e))
                    return
                data = body.encode() if isinstance(body, str) else body
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="dashboard", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # ------------------------------------------------------------- routing

    def _route(self, path: str, query: Optional[dict] = None):
        query = query or {}
        if path == "/":
            return self._index(), "text/html"
        if path == "/metrics":
            if query.get("format") == "json":
                return (json.dumps(self._metrics_json(), default=str),
                        "application/json")
            return self._metrics(), "text/plain; version=0.0.4"
        if path == "/api/metrics_range":
            return (json.dumps(self._metrics_range(query), default=str),
                    "application/json")
        if path == "/api/alerts":
            return (json.dumps(self._alerts(query), default=str),
                    "application/json")
        if path == "/api/stacks":
            return (json.dumps(self._stacks(query), default=str),
                    "application/json")
        if path == "/api/profile":
            body = self._profile(query)
            if isinstance(body, str):  # collapsed text export
                return body, "text/plain"
            return json.dumps(body, default=str), "application/json"
        if path == "/api/logs":
            body = self._logs(query)
            if isinstance(body, str):  # tail text
                return body, "text/plain"
            return json.dumps(body, default=str), "application/json"
        api = {
            "/api/nodes": self._nodes,
            "/api/actors": self._actors,
            "/api/jobs": self._jobs,
            "/api/cluster_resources": self._cluster_resources,
            "/api/load": self._load,
            "/api/placement_groups": self._pgs,
            "/api/tasks": self._tasks,
            "/api/task_summary": self._task_summary,
            "/api/timeline": self._timeline,
            "/api/trace_summary": self._trace_summary,
            "/api/health": self._health,
        }
        if path in api:
            return json.dumps(api[path](), default=str), "application/json"
        if path.startswith("/api/trace/"):
            trace_id = path[len("/api/trace/"):]
            if not trace_id:
                raise KeyError(path)
            return (json.dumps(self._trace(trace_id), default=str),
                    "application/json")
        if path.startswith("/api/jobs/") and path.endswith("/logs"):
            job_id = path[len("/api/jobs/"):-len("/logs")]
            raw = self._gcs.kv_get("jobs", (job_id + "/logs").encode())
            if raw is None:
                raise KeyError(path)
            return raw, "text/plain"
        raise KeyError(path)

    # ------------------------------------------------------------- sources

    def _nodes(self):
        return self._gcs.nodes()

    def _actors(self):
        return self._gcs.list_actors()

    def _jobs(self):
        out = []
        for key in self._gcs.kv_keys("jobs", b""):
            if key.endswith(b"/logs"):
                continue
            raw = self._gcs.kv_get("jobs", key)
            if raw:
                out.append(json.loads(raw))
        return out

    def _cluster_resources(self):
        total: dict = {}
        avail: dict = {}
        for n in self._gcs.nodes():
            if not n["alive"]:
                continue
            for k, v in n["resources_total"].items():
                total[k] = total.get(k, 0.0) + v
            for k, v in n.get("resources_available", {}).items():
                avail[k] = avail.get(k, 0.0) + v
        return {"total": total, "available": avail}

    def _load(self):
        return self._gcs.load_metrics()

    def _pgs(self):
        return self._gcs.state_snapshot().get("placement_groups", [])

    def _tasks(self):
        """Latest state per task, cluster-wide (GCS task-event table —
        raylets batch-flush their lifecycle events there)."""
        return self._gcs.list_task_events()

    def _task_summary(self):
        return self._gcs.summarize_task_events()

    def _timeline(self):
        from ray_tpu_torch.util.state import build_timeline

        return build_timeline(self._gcs.task_events_raw())

    def _trace(self, trace_id: str):
        """One request's reassembled span tree + critical-path waterfall
        (GCS trace table — every process batch-flushes its spans there)."""
        from ray_tpu_torch.util import trace_analysis

        spans = self._gcs.get_trace(trace_id)
        return {
            "trace_id": trace_id,
            "num_spans": len(spans),
            "tree": trace_analysis.build_tree(spans),
            "critical_path": trace_analysis.critical_path(spans),
        }

    def _trace_summary(self):
        from ray_tpu_torch.util import trace_analysis

        out = trace_analysis.aggregate(self._gcs.list_trace_spans())
        out["table"] = self._gcs.trace_table_stats()
        return out

    def _health(self):
        """Failure-detection observability (suspicions, fencing, drains,
        time-to-detect) straight from the GCS health monitor."""
        return self._gcs.health_stats()

    def _stacks(self, query: dict):
        """Live all-thread stacks, cluster-wide (or one node with
        ?node=<prefix>) — the GCS relays a targeted query to each raylet,
        which dumps itself and its workers (see ``ray_tpu_torch stack``)."""
        return self._gcs.collect_stacks(
            node_id=query.get("node"),
            timeout_s=float(query.get("timeout", 3.0)))

    def _profile(self, query: dict):
        """Continuous-profiling readout over the GCS profile table:
        the per-function summary by default; ?format=speedscope returns
        a loadable speedscope document, ?format=collapsed flamegraph.pl
        text."""
        from ray_tpu_torch.util import profiling

        samples = self._gcs.list_profile_samples(
            node_id=query.get("node"),
            since=float(query.get("since", 0.0)),
            limit=int(query.get("limit", 100000)))
        fmt = query.get("format")
        if fmt == "speedscope":
            return profiling.to_speedscope(samples)
        if fmt == "collapsed":
            return profiling.to_collapsed(samples)
        out = profiling.summarize(samples,
                                  top=int(query.get("top", 30)))
        out["table"] = self._gcs.profile_table_stats()
        return out

    def _logs(self, query: dict):
        """Worker log files: the per-node listing, or — with ?node= and
        ?file= — that file's tail as plain text."""
        name = query.get("file")
        if name:
            out = self._gcs.node_query(
                query.get("node"), "logs",
                {"action": "tail", "name": name,
                 "lines": int(query.get("lines", 100))},
                timeout_s=float(query.get("timeout", 3.0)))
            hits = [rep for _nid, rep in
                    sorted(out.get("reports", {}).items())
                    if isinstance(rep, dict) and "data" in rep]
            if len(hits) > 1:
                # per-raylet sequence names repeat on every node: make
                # the caller disambiguate rather than guessing for them
                raise ValueError(
                    f"log file {name!r} exists on "
                    + ", ".join(r["node_id"][:12] for r in hits)
                    + " — pass ?node=<prefix>")
            if hits:
                return hits[0]["data"]
            raise KeyError(f"log file {name!r}")
        out = self._gcs.node_query(query.get("node"), "logs",
                                   {"action": "list"},
                                   timeout_s=float(query.get("timeout",
                                                             3.0)))
        return {nid: rep for nid, rep in out.get("reports", {}).items()
                if isinstance(rep, list)}

    def _metrics_range(self, query: dict):
        """Time-series reads over the GCS metrics table: range dumps the
        retained points, rate/quantile evaluate over ?window= seconds,
        series summarizes every retained series."""
        tags = None
        if query.get("tags"):
            tags = dict(kv.split("=", 1)
                        for kv in query["tags"].split(",") if "=" in kv)
        return self._gcs.query_metrics(
            name=query.get("name"),
            op=query.get("op", "range"),
            tags=tags,
            node_id=query.get("node"),
            since=float(query["since"]) if "since" in query else None,
            until=float(query["until"]) if "until" in query else None,
            window_s=float(query.get("window", 60.0)),
            q=float(query.get("q", 0.99)),
            limit=int(query.get("limit", 2000)))

    def _alerts(self, query: dict):
        """Firing alerts + the recent firing/resolved transition log from
        the GCS rule engine."""
        return self._gcs.list_alerts(state=query.get("state"),
                                     limit=int(query.get("limit", 100)))

    # ------------------------------------------------------------- metrics

    def _system_gauges(self):
        """The dashboard-computed cluster gauges (not in the metrics KV):
        alive nodes, per-node resources, actor-state counts."""
        nodes = self._gcs.nodes()
        alive = [n for n in nodes if n["alive"]]
        states: dict = {}
        for a in self._gcs.list_actors():
            st = a.get("state", "?")
            states[st] = states.get(st, 0) + 1
        return alive, states

    def _metrics_json(self):
        """The /metrics series as a JSON document (?format=json): system
        gauges plus every merged producer family."""
        from ray_tpu_torch.util.metrics import kv_metrics_json, merge_kv_metrics

        alive, states = self._system_gauges()
        resources = [
            {"node": n["node_id"][:12],
             "total": n["resources_total"],
             "available": n.get("resources_available", {})}
            for n in alive]
        return {
            "nodes_alive": len(alive),
            "resources": resources,
            "actors": states,
            "metrics": kv_metrics_json(merge_kv_metrics(self._gcs)),
        }

    def _metrics(self) -> str:
        """Prometheus text exposition (reference: the per-node MetricsAgent
        re-export, `python/ray/_private/metrics_agent.py:375`).  System
        gauges from GCS state + any user metrics pushed to the GCS KV by
        ``ray_tpu_torch.util.metrics``."""
        lines = []
        alive, states = self._system_gauges()
        lines.append("# HELP ray_tpu_nodes_alive Alive raylets in the "
                     "GCS node table.")
        lines.append("# TYPE ray_tpu_nodes_alive gauge")
        lines.append(f"ray_tpu_nodes_alive {len(alive)}")
        lines.append("# HELP ray_tpu_resource_total Per-node declared "
                     "resource capacity.")
        lines.append("# TYPE ray_tpu_resource_total gauge")
        lines.append("# HELP ray_tpu_resource_available Per-node "
                     "currently-unclaimed resources.")
        lines.append("# TYPE ray_tpu_resource_available gauge")
        for n in alive:
            nid = _prom_escape(n["node_id"][:12])
            for k, v in n["resources_total"].items():
                lines.append(
                    f'ray_tpu_resource_total{{node="{nid}",'
                    f'resource="{_prom_escape(k)}"}} {v}')
            for k, v in n.get("resources_available", {}).items():
                lines.append(
                    f'ray_tpu_resource_available{{node="{nid}",'
                    f'resource="{_prom_escape(k)}"}} {v}')
        lines.append("# HELP ray_tpu_actors Actor count per lifecycle "
                     "state.")
        lines.append("# TYPE ray_tpu_actors gauge")
        for st, count in sorted(states.items()):
            lines.append(f'ray_tpu_actors{{state="{_prom_escape(st)}"}} '
                         f'{count}')
        # User metrics: serialized samples under KV ns "metrics".
        try:
            from ray_tpu_torch.util.metrics import render_kv_metrics

            lines.extend(render_kv_metrics(self._gcs))
        except ImportError:
            pass
        return "\n".join(lines) + "\n"

    # -------------------------------------------------------------- index

    def _index(self) -> str:
        import html as _html

        res = self._cluster_resources()
        nodes = self._nodes()
        jobs = self._jobs()
        rows = "".join(
            f"<tr><td>{_html.escape(n['node_id'][:12])}</td>"
            f"<td>{'ALIVE' if n['alive'] else 'DEAD'}</td>"
            f"<td>{_html.escape(json.dumps(n['resources_total']))}</td></tr>"
            for n in nodes)
        job_rows = "".join(
            f"<tr><td>{_html.escape(j['submission_id'])}</td>"
            f"<td>{_html.escape(j['status'])}</td>"
            f"<td><code>{_html.escape(j['entrypoint'][:80])}</code></td></tr>"
            for j in jobs)
        return f"""<!doctype html><html><head><title>ray_tpu_torch dashboard</title>
<style>body{{font-family:sans-serif;margin:2em}}table{{border-collapse:
collapse}}td,th{{border:1px solid #ccc;padding:4px 8px}}</style></head>
<body><h1>ray_tpu_torch</h1>
<p>GCS: <code>{self._gcs_address}</code></p>
<p>resources: <code>{json.dumps(res)}</code></p>
<h2>nodes</h2><table><tr><th>id</th><th>state</th><th>resources</th></tr>
{rows}</table>
<h2>jobs</h2><table><tr><th>id</th><th>status</th><th>entrypoint</th></tr>
{job_rows}</table>
<p>APIs: /api/nodes /api/actors /api/jobs /api/cluster_resources /api/load
/api/placement_groups /api/tasks /api/task_summary /api/timeline
/api/trace/&lt;id&gt; /api/trace_summary /api/health /api/stacks
/api/profile /api/logs /api/metrics_range /api/alerts /metrics</p>
</body></html>"""

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()
        try:
            self._gcs.close()
        except Exception:  # noqa: BLE001
            pass
