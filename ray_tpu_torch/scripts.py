"""``ray_tpu_torch`` CLI — cluster lifecycle + state inspection.

Reference analogue: `python/ray/scripts/scripts.py` (``ray start`` `:540`,
``ray stop`` `:1004`, ``ray status``).  argparse instead of click (no extra
dependency); run as ``python -m ray_tpu_torch.scripts <command>``.

Commands:
  start --head [--port P] [--resources JSON]   start GCS + a raylet here
  start --address HOST:PORT [--resources JSON] join an existing cluster
  stop                                         stop local ray_tpu_torch processes
  status --address HOST:PORT                   cluster resource summary
  list {nodes,actors,tasks} --address ...      state tables
  timeline --address ... --out FILE            chrome://tracing dump
  trace {export,summary} --address ...         request-flow traces:
                                               Perfetto export / per-hop
                                               latency attribution
  stack [target] --address ...                 live all-thread stacks from
                                               cluster processes (ray stack)
  profile {export,summary} --address ...       continuous profiling:
                                               speedscope/collapsed export,
                                               top-function table
  logs [file] --address ... [--follow]         list/tail per-worker log
                                               files (ray logs)
  metrics {query,top} --address ...            metric time-series:
                                               range/rate/quantile reads,
                                               busiest-series table
  alerts --address ... [--log]                 firing alerts + transitions
  chaos [--seed N] [--duration S] [--faults..] seeded compound-fault soak
                                               + invariant bank + MTTR
                                               report on a local cluster
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile

_PID_DIR = os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "pids")


def _save_pid(kind: str, pid: int):
    os.makedirs(_PID_DIR, exist_ok=True)
    with open(os.path.join(_PID_DIR, f"{kind}_{pid}.pid"), "w") as f:
        f.write(str(pid))


def cmd_start(args) -> int:
    resources = args.resources or "{}"
    if args.head:
        gcs = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.gcs_main",
             "--port", str(args.port)],
            stdout=subprocess.PIPE, text=True)
        line = gcs.stdout.readline().strip()
        address = line.split()[1]
        _save_pid("gcs", gcs.pid)
        print(f"GCS started at {address}")
    else:
        if not args.address:
            print("error: --address required without --head",
                  file=sys.stderr)
            return 2
        address = args.address
    raylet = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.core.raylet_main",
         "--gcs", address, "--resources", resources],
        stdout=subprocess.PIPE, text=True)
    line = raylet.stdout.readline().strip()
    _save_pid("raylet", raylet.pid)
    print(f"raylet started: {line}")
    print(f"\nconnect with: ray_tpu_torch.init(address=\"{address}\")")
    return 0


def cmd_stop(args) -> int:
    stopped = 0
    if os.path.isdir(_PID_DIR):
        for name in os.listdir(_PID_DIR):
            path = os.path.join(_PID_DIR, name)
            try:
                with open(path) as f:
                    pid = int(f.read().strip())
                os.kill(pid, signal.SIGTERM)
                stopped += 1
            except (OSError, ValueError):
                pass
            os.unlink(path)
    print(f"stopped {stopped} process(es)")
    return 0


def _connect(args):
    import ray_tpu_torch

    ray_tpu_torch.init(address=args.address)
    return ray_tpu_torch


def cmd_status(args) -> int:
    ray_tpu_torch = _connect(args)
    nodes = ray_tpu_torch.nodes()
    alive = [n for n in nodes if n["Alive"]]
    print(f"nodes: {len(alive)} alive / {len(nodes)} total")
    total = ray_tpu_torch.cluster_resources()
    print("resources:", json.dumps(total))
    for n in nodes:
        mark = "+" if n["Alive"] else "-"
        print(f"  {mark} {n['NodeID'][:12]} {n.get('Hostname','')} "
              f"{json.dumps(n['Resources'])}")
    return 0


def cmd_drain(args) -> int:
    """Gracefully drain a node out of the cluster (reference: the
    autoscaler's DrainNode RPC): placement stops immediately, sole-copy
    store objects migrate to surviving nodes, checkpointable actors
    checkpoint-and-relocate, running tasks get up to the deadline — then
    the node retires with ZERO reconstructions."""
    import time as _time

    from ray_tpu_torch.core.gcs import GcsClient

    cli = GcsClient(args.address)
    try:
        node_id = args.node_id
        matches = [n["node_id"] for n in cli.nodes()
                   if n["alive"] and n["node_id"].startswith(node_id)]
        if len(matches) != 1:
            print(f"error: node id prefix {node_id!r} matches "
                  f"{len(matches)} alive node(s)", file=sys.stderr)
            return 2
        node_id = matches[0]
        if not cli.drain_node(node_id, timeout_s=args.timeout):
            print(f"error: node {node_id} unknown or already dead",
                  file=sys.stderr)
            return 1
        print(f"draining {node_id} (deadline {args.timeout:.0f}s)")
        if args.no_wait:
            return 0
        deadline = _time.monotonic() + args.timeout + 10.0
        while _time.monotonic() < deadline:
            status = cli.drain_status(node_id)
            if status.get("state") == "drained":
                print(f"drained: {json.dumps(status)}")
                return 0
            _time.sleep(0.5)
        print("drain did not complete in time", file=sys.stderr)
        return 1
    finally:
        cli.close()


def cmd_list(args) -> int:
    _connect(args)
    from ray_tpu_torch.util import state

    fn = {"nodes": state.list_nodes, "actors": state.list_actors,
          "tasks": state.list_tasks}[args.what]
    for row in fn():
        print(json.dumps(row, default=str))
    return 0


def cmd_tasks(args) -> int:
    """Cluster-wide task table from the GCS task-event export
    (reference: ``ray list tasks``)."""
    _connect(args)
    from ray_tpu_torch.util import state

    for row in state.list_tasks(state=args.state, limit=args.limit):
        print(json.dumps(row, default=str))
    return 0


def cmd_task_summary(args) -> int:
    """State -> count over every job's tasks, plus export-drop and
    node-coverage accounting (reference: ``ray summary tasks``)."""
    _connect(args)
    from ray_tpu_torch.util import state

    print(json.dumps(state.task_events_summary(), indent=1, default=str))
    return 0


_CLUSTER_DIR = os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "clusters")


def cmd_up(args) -> int:
    """Launch a cluster from a YAML config (reference: ``ray up``,
    `scripts.py:1238`): GCS + head raylet + autoscaler in one supervised
    head process; workers come and go via the autoscaler."""
    import yaml

    with open(args.config) as f:
        name = (yaml.safe_load(f) or {}).get("cluster_name", "default")
    os.makedirs(_CLUSTER_DIR, exist_ok=True)
    # Detach: the monitor must not hold the CLI's stdio (callers capturing
    # this command's output would otherwise wait on the long-lived child).
    log = open(os.path.join(_CLUSTER_DIR, f"{name}.log"), "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.autoscaler.monitor_main",
         "--config", os.path.abspath(args.config)],
        stdout=subprocess.PIPE, stderr=log, stdin=subprocess.DEVNULL,
        start_new_session=True, text=True)
    log.close()
    address = None
    for _ in range(600):
        line = proc.stdout.readline()
        if not line:
            break
        if line.startswith("CLUSTER_ADDRESS"):
            address = line.split()[1]
            break
    if address is None:
        print("cluster failed to start", file=sys.stderr)
        return 1
    proc.stdout.close()  # monitor keeps running detached
    with open(os.path.join(_CLUSTER_DIR, f"{name}.json"), "w") as f:
        json.dump({"name": name, "pid": proc.pid, "address": address}, f)
    print(f"cluster {name!r} up at {address}")
    print(f"connect with: ray_tpu_torch.init(address=\"{address}\")")
    print(f"tear down with: ray_tpu_torch down --name {name}")
    return 0


def cmd_down(args) -> int:
    """Tear down a cluster started with ``up`` (reference: ``ray down``)."""
    path = os.path.join(_CLUSTER_DIR, f"{args.name}.json")
    try:
        with open(path) as f:
            rec = json.load(f)
    except OSError:
        print(f"no cluster record {args.name!r}", file=sys.stderr)
        return 1
    try:
        os.kill(rec["pid"], signal.SIGTERM)
    except ProcessLookupError:
        pass
    os.unlink(path)
    print(f"cluster {args.name!r} down")
    return 0


def cmd_memory(args) -> int:
    """Object-store usage + object table (reference: ``ray memory``)."""
    ray_tpu_torch = _connect(args)
    from ray_tpu_torch.util import state

    summary = state.summarize_objects()
    print(json.dumps(summary, indent=1, default=str))
    if args.verbose:
        for row in state.list_objects(limit=args.limit):
            print(json.dumps(row, default=str))
    return 0


def cmd_job(args) -> int:
    from ray_tpu_torch.job_submission import JobSubmissionClient

    client = JobSubmissionClient(args.address)
    if args.job_command == "submit":
        import shlex

        # One token = a pre-quoted shell command string (Ray-style
        # `job submit -- "python train.py --lr 1e-3"`): pass through
        # verbatim.  Multiple tokens = argv, re-quoted to survive the
        # supervisor's shell=True.
        if len(args.entrypoint) == 1:
            entrypoint = args.entrypoint[0]
        else:
            entrypoint = shlex.join(args.entrypoint)
        job_id = client.submit_job(
            entrypoint=entrypoint, submission_id=args.submission_id)
        print(f"submitted {job_id}")
        if not args.no_wait:
            for chunk in client.tail_job_logs(job_id):
                sys.stdout.write(chunk)
                sys.stdout.flush()
            status = client.get_job_status(job_id)
            print(f"job {job_id}: {status}")
            return 0 if status == "SUCCEEDED" else 1
    elif args.job_command == "status":
        print(client.get_job_status(args.job_id))
    elif args.job_command == "logs":
        sys.stdout.write(client.get_job_logs(args.job_id))
    elif args.job_command == "stop":
        ok = client.stop_job(args.job_id)
        print("stopped" if ok else "not running")
    elif args.job_command == "list":
        for job in client.list_jobs():
            print(f"{job['submission_id']}\t{job['status']}\t"
                  f"{job['entrypoint'][:60]}")
    return 0


def cmd_serve(args) -> int:
    """Serve control (reference: `serve deploy/status/shutdown` CLI)."""
    _connect(args)
    from ray_tpu_torch import serve

    if args.serve_command == "deploy":
        serve.start()
        apps = serve.run_config(args.config)
        print(f"deployed {len(apps)} application(s); "
              f"http port {serve.http_port()}")
    elif args.serve_command == "status":
        print(json.dumps(serve.status(), indent=1, default=str))
    elif args.serve_command == "shutdown":
        serve.shutdown()
        print("serve shut down")
    return 0


def cmd_timeline(args) -> int:
    ray_tpu_torch = _connect(args)
    events = ray_tpu_torch.timeline(args.out)
    print(f"wrote {len(events)} events to {args.out}")
    return 0


def cmd_trace(args) -> int:
    """Request-flow traces (GCS trace table): ``export`` writes
    Perfetto/chrome://tracing JSON (one trace with --trace-id, else every
    retained span); ``summary`` prints the per-hop "where do the
    microseconds go" attribution table."""
    _connect(args)
    from ray_tpu_torch.util import state

    if args.action == "export":
        n = state.export_trace(args.out, trace_id=args.trace_id,
                               job_id=args.job, limit=args.limit)
        print(f"wrote {n} events to {args.out}")
        return 0
    summary = state.trace_summary(job_id=args.job, limit=args.limit)
    table = summary.get("table", {})
    print(f"traces: {summary['requests']} ({summary['errored']} errored)  "
          f"spans retained: {table.get('num_spans', 0)}  "
          f"dropped: {table.get('num_dropped', 0)}")
    print(f"e2e latency: p50 {summary['e2e_p50_us']}us  "
          f"p95 {summary['e2e_p95_us']}us")
    print(f"{'hop':<28}{'reqs':>7}{'p50_us':>10}{'p95_us':>10}"
          f"{'total_us':>12}{'share':>8}")
    for hop, row in summary["by_hop"].items():
        print(f"{hop:<28}{row['requests']:>7}{row['p50_us']:>10}"
              f"{row['p95_us']:>10}{row['total_us']:>12}"
              f"{row['share']:>8.1%}")
    return 0


def cmd_stack(args) -> int:
    """Live all-thread stacks from running cluster processes (reference:
    ``ray stack`` / the dashboard's py-spy dump, served in-process over
    the protocol — works on remote nodes and busy/deadlocked workers)."""
    _connect(args)
    from ray_tpu_torch.util import profiling, state

    out = state.list_stacks(target=args.target, timeout_s=args.timeout)
    shown = 0
    for nid, procs in sorted(out.get("nodes", {}).items()):
        for p in procs or []:
            shown += 1
            actor = f" actor={p['actor_id'][:12]}" if p.get("actor_id") \
                else ""
            print(f"== node {nid[:12]} pid={p['pid']} "
                  f"({p['proc']}{actor}) ==")
            print(profiling.format_stacks(p.get("threads") or []))
    for p in out.get("gcs") or []:
        shown += 1
        print(f"== gcs pid={p['pid']} ==")
        print(profiling.format_stacks(p.get("threads") or []))
    if out.get("missing"):
        print(f"no report from {len(out['missing'])} node(s): "
              + " ".join(n[:12] for n in out["missing"]), file=sys.stderr)
    if not shown:
        print("no processes matched", file=sys.stderr)
        return 1
    return 0


def cmd_profile(args) -> int:
    """Continuous-profiling surfaces (GCS profile table): ``export``
    writes a speedscope JSON (or flamegraph.pl collapsed text) of the
    retained folded samples; ``summary`` prints the per-function "where
    does the CPU go" table."""
    _connect(args)
    from ray_tpu_torch.util import state

    since = args.since if args.since is not None else 0.0
    if args.action == "export":
        n = state.export_profile(args.out, fmt=args.format,
                                 node_id=args.node, since=since,
                                 limit=args.limit)
        print(f"wrote {n} sample records to {args.out} ({args.format})")
        return 0
    summary = state.profile_summary(node_id=args.node, since=since,
                                    limit=args.limit, top=args.top)
    table = summary.get("table", {})
    print(f"samples: {summary['total_samples']} "
          f"({summary['num_records']} records, "
          f"{table.get('num_dropped', 0)} dropped)  "
          f"by_proc: {json.dumps(summary['by_proc'])}")
    print(f"{'frame':<52}{'self':>8}{'share':>8}")
    for row in summary["top_self"]:
        print(f"{row['frame'][:50]:<52}{row['samples']:>8}"
              f"{row['share']:>8.1%}")
    return 0


def cmd_metrics(args) -> int:
    """Metric time-series (GCS metrics table): ``query`` runs a range /
    rate / quantile read over one series; ``top`` prints the busiest
    series cluster-wide (rate-ranked summary)."""
    _connect(args)
    from ray_tpu_torch.util import state

    if args.action == "top":
        out = state.query_metrics(op="series", window_s=args.window,
                                  limit=args.limit)
        series = (out or {}).get("series", [])[:args.top]
        if not series:
            print("no metric points retained", file=sys.stderr)
            return 1
        print(f"{'series':<64}{'kind':<11}{'rate/s':>10}{'value':>12}")
        for row in series:
            tags = ",".join(f"{k}={v}" for k, v in row.get("tags", []))
            label = row["name"].replace("ray_tpu_internal_", "")
            if tags:
                label += "{" + tags + "}"
            rate = row.get("rate")
            val = row.get("value", row.get("total"))
            p99 = row.get("p99")
            extra = f"  p99={p99:.4f}" if p99 is not None else ""
            print(f"{label[:62]:<64}{row['kind']:<11}"
                  f"{(f'{rate:.2f}' if rate is not None else '-'):>10}"
                  f"{(f'{val:.4g}' if val is not None else '-'):>12}"
                  f"{extra}")
        return 0
    tags = dict(kv.split("=", 1) for kv in (args.tag or []))
    out = state.query_metrics(
        name=args.name, op=args.op, tags=tags or None, node_id=args.node,
        since=args.since, until=args.until, window_s=args.window,
        q=args.q, limit=args.limit)
    if out is None:
        print("error: no cluster (metrics table needs a GCS)",
              file=sys.stderr)
        return 1
    if args.op == "range":
        for p in out.get("points", []):
            print(json.dumps(p, default=str))
        if out.get("truncated"):
            print(f"(truncated to {args.limit} points)", file=sys.stderr)
    else:
        print(json.dumps(out, default=str))
    return 0


def cmd_alerts(args) -> int:
    """Alert table (GCS rule engine): firing alerts plus the recent
    transition log (firing -> resolved)."""
    _connect(args)
    from ray_tpu_torch.util import state

    out = state.list_alerts(state=args.state, limit=args.limit)
    if out is None:
        print("error: no cluster (alerts need a GCS)", file=sys.stderr)
        return 1
    firing = out.get("firing", [])
    print(f"firing: {len(firing)}  (log dropped: "
          f"{out.get('num_dropped', 0)})")
    for a in firing:
        print(f"  [{a['severity']}] {a['rule']}  value={a['value']:.4g} "
              f"threshold={a['threshold']:.4g}  since={a['since']:.1f}")
        if a.get("summary"):
            print(f"      {a['summary']}")
    if args.log:
        print("log (newest first):")
        for a in out.get("log", []):
            print(f"  {a['ts']:.1f} {a['state']:<9} [{a['severity']}] "
                  f"{a['rule']}  value={a['value']:.4g}")
    return 0


def cmd_chaos(args) -> int:
    """Seeded compound-fault soak: spawn a disposable local cluster, run
    a deterministic fault timeline against live workloads, then run the
    invariant bank (``util.chaos_schedule``).  Exit 0 only if every
    invariant holds; the executed timeline (JSONL) replays a failing
    seed exactly via ``--replay``."""
    import tempfile

    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util import chaos
    from ray_tpu_torch.util import chaos_schedule as cs

    faults = [f.strip() for f in args.faults.split(",") if f.strip()]
    for f in faults:
        if f not in cs.FAULT_KINDS:
            print(f"error: unknown fault {f!r} "
                  f"(choose from {', '.join(cs.FAULT_KINDS)})",
                  file=sys.stderr)
            return 2
    workdir = args.workdir or tempfile.mkdtemp(prefix="ray_tpu_chaos_")
    os.makedirs(workdir, exist_ok=True)
    if args.replay:
        events = cs.load_timeline(args.replay)
        print(f"replaying {len(events)} events from {args.replay}")
    else:
        events = cs.build_schedule(args.seed, args.duration,
                                   faults=faults, n_slots=args.nodes)
        print(f"seed {args.seed}: {len(events)} events over "
              f"{args.duration:.0f}s")
    plan_path = os.path.join(workdir, "timeline.jsonl")
    cs.write_timeline(events, plan_path)
    log_path = os.path.join(workdir, "events.jsonl")
    baseline = chaos.snapshot_host()
    control_file = os.path.join(workdir, "chaos_ctrl.json")
    memory_file = os.path.join(workdir, "mem_usage")
    cluster = Cluster(
        gcs_persist_path=os.path.join(workdir, "gcs_snapshot"),
        chaos_control_file=control_file,
        memory_usage_file=memory_file,
        env={"RAY_TPU_GCS_RECONNECT_TIMEOUT_S": "30"})
    try:
        # Worker slots carry a "chaos" resource so the workloads and the
        # MTTR probe land on killable nodes, never the quiet head.
        pin = {"chaos": 0.01}
        for _ in range(args.nodes):
            cluster.add_node(num_cpus=2, resources={"chaos": 4})
        cluster.connect()
        cluster.wait_for_nodes()
        workloads = [
            cs.TaskFanoutWorkload(placement_resources=pin),
            cs.ActorMarkerWorkload(os.path.join(workdir, "markers"),
                                   placement_resources=pin),
            cs.PutGetWorkload(placement_resources=pin),
        ]
        if args.serve:
            workloads.append(cs.ServeWorkload())
        runner = cs.ChaosRunner(cluster, events, workloads,
                                control_file=control_file,
                                memory_file=memory_file,
                                log_path=log_path,
                                probe_resources=pin)
        report = runner.run()
    finally:
        cluster.shutdown()
    host_check = {"name": "clean_host", "ok": True, "detail": ""}
    try:
        chaos.assert_clean_host(baseline)
        host_check["detail"] = "no leaked processes/shm"
    except chaos.HostLeakError as e:
        host_check["ok"] = False
        host_check["detail"] = str(e)
        report["ok"] = False
        report["violations"].append("clean_host")
    report["checks"].append(host_check)
    # Persist the verdict next to the timelines so CI can ship the whole
    # workdir as one artifact and a failing seed is replayable offline.
    report_path = os.path.join(workdir, "report.json")
    with open(report_path, "w") as f:
        json.dump(report, f, indent=1, default=str)
    print()
    print(cs.render_report(report))
    print(f"\n  timeline: {plan_path}\n  event log: {log_path}"
          f"\n  report: {report_path}")
    return 0 if report["ok"] else 1


def cmd_logs(args) -> int:
    """List / tail the per-worker log files each raylet writes under its
    ``session_dir/logs`` (reference: ``ray logs``).  With a file name the
    tail prints; ``--follow`` polls the returned offset like tail -f."""
    import time as _time

    _connect(args)
    from ray_tpu_torch.util import state

    if not args.file:
        listing = state.list_logs(node_id=args.node,
                                  timeout_s=args.timeout)
        if not any(listing.values()):
            print("no worker log files (single-node runs share the "
                  "driver's stdio)", file=sys.stderr)
            return 1
        for nid, entries in sorted(listing.items()):
            print(f"== node {nid[:12]} ==")
            for e in entries:
                pid = f" pid={e['pid']}" if e.get("pid") else ""
                print(f"  {e['name']:<24}{e['size']:>10} bytes{pid}")
        return 0
    tail = state.tail_log(args.file, node_id=args.node, lines=args.lines,
                          timeout_s=args.timeout)
    if tail is None:
        print(f"error: no node serves log file {args.file!r}",
              file=sys.stderr)
        return 1
    if tail.get("ambiguous_nodes"):
        print(f"warning: {args.file!r} exists on "
              f"{len(tail['ambiguous_nodes'])} nodes "
              f"({' '.join(n[:12] for n in tail['ambiguous_nodes'])}); "
              f"showing {tail['node_id'][:12]} — pass --node to pick",
              file=sys.stderr)
    sys.stdout.write(tail["data"])
    sys.stdout.flush()
    if not args.follow:
        return 0
    node, offset = tail["node_id"], tail["offset"]
    while True:
        _time.sleep(0.5)
        tail = state.tail_log(args.file, node_id=node, offset=offset,
                              timeout_s=args.timeout)
        if tail is None:
            continue  # node busy/briefly unreachable: keep polling
        offset = tail["offset"]
        if tail["data"]:
            sys.stdout.write(tail["data"])
            sys.stdout.flush()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ray_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("start", help="start cluster processes on this host")
    p.add_argument("--head", action="store_true")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--address", default=None, help="GCS host:port to join")
    p.add_argument("--resources", default=None, help='JSON, e.g. {"CPU":8}')
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("stop", help="stop processes started here")
    p.set_defaults(fn=cmd_stop)

    p = sub.add_parser("status", help="cluster resource summary")
    p.add_argument("--address", required=True)
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("drain", help="gracefully drain a node (migrate "
                                     "objects/actors, then retire it)")
    p.add_argument("node_id", help="node id (unique prefix accepted)")
    p.add_argument("--address", required=True)
    p.add_argument("--timeout", type=float, default=30.0,
                   help="drain deadline seconds (default 30)")
    p.add_argument("--no-wait", action="store_true",
                   help="start the drain and return immediately")
    p.set_defaults(fn=cmd_drain)

    p = sub.add_parser("list", help="state tables")
    p.add_argument("what", choices=["nodes", "actors", "tasks"])
    p.add_argument("--address", required=True)
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("tasks", help="cluster-wide task table (GCS "
                                     "task-event export)")
    p.add_argument("--address", required=True)
    p.add_argument("--state", default=None,
                   help="filter, e.g. FINISHED / FAILED / RUNNING")
    p.add_argument("--limit", type=int, default=1000)
    p.set_defaults(fn=cmd_tasks)

    p = sub.add_parser("task-summary",
                       help="task state counts + export-drop accounting")
    p.add_argument("--address", required=True)
    p.set_defaults(fn=cmd_task_summary)

    p = sub.add_parser("up", help="launch a cluster from YAML (ray up)")
    p.add_argument("config")
    p.set_defaults(fn=cmd_up)

    p = sub.add_parser("down", help="tear down an up'd cluster (ray down)")
    p.add_argument("--name", default="default")
    p.set_defaults(fn=cmd_down)

    p = sub.add_parser("memory", help="object store usage (ray memory)")
    p.add_argument("--address", required=True)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--limit", type=int, default=100)
    p.set_defaults(fn=cmd_memory)

    p = sub.add_parser("job", help="job submission (reference: ray job ...)")
    jsub = p.add_subparsers(dest="job_command", required=True)
    js = jsub.add_parser("submit")
    js.add_argument("--address", required=True)
    js.add_argument("--submission-id", default=None)
    js.add_argument("--no-wait", action="store_true")
    js.add_argument("entrypoint", nargs=argparse.REMAINDER)
    js.set_defaults(fn=cmd_job)
    for name in ("status", "logs", "stop"):
        jp = jsub.add_parser(name)
        jp.add_argument("--address", required=True)
        jp.add_argument("job_id")
        jp.set_defaults(fn=cmd_job)
    jl = jsub.add_parser("list")
    jl.add_argument("--address", required=True)
    jl.set_defaults(fn=cmd_job)

    p = sub.add_parser("serve", help="model serving control")
    ssub = p.add_subparsers(dest="serve_command", required=True)
    sd = ssub.add_parser("deploy")
    sd.add_argument("--address", required=True)
    sd.add_argument("config", help="YAML/JSON app config")
    sd.set_defaults(fn=cmd_serve)
    for name in ("status", "shutdown"):
        sp = ssub.add_parser(name)
        sp.add_argument("--address", required=True)
        sp.set_defaults(fn=cmd_serve)

    p = sub.add_parser("timeline", help="chrome://tracing dump")
    p.add_argument("--address", required=True)
    p.add_argument("--out", default="timeline.json")
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser(
        "trace", help="request-flow traces: export Perfetto JSON / "
                      "per-hop latency summary")
    p.add_argument("action", choices=["export", "summary"])
    p.add_argument("--address", required=True)
    p.add_argument("--trace-id", default=None,
                   help="export just this trace (default: all retained)")
    p.add_argument("--job", default=None, help="filter by job id")
    p.add_argument("--limit", type=int, default=100000)
    p.add_argument("--out", default="trace.json")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser(
        "stack", help="live all-thread stacks from cluster processes "
                      "(ray stack)")
    p.add_argument("target", nargs="?", default=None,
                   help="node-id prefix, actor name, or actor-id prefix "
                        "(default: every process cluster-wide)")
    p.add_argument("--address", required=True)
    p.add_argument("--timeout", type=float, default=3.0)
    p.set_defaults(fn=cmd_stack)

    p = sub.add_parser(
        "profile", help="continuous profiling: speedscope/collapsed "
                        "export / top-function summary")
    p.add_argument("action", choices=["export", "summary"])
    p.add_argument("--address", required=True)
    p.add_argument("--node", default=None, help="node-id prefix filter")
    p.add_argument("--since", type=float, default=None,
                   help="only samples whose window ends at/after this "
                        "unix time")
    p.add_argument("--limit", type=int, default=100000)
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--format", choices=["speedscope", "collapsed"],
                   default="speedscope")
    p.add_argument("--out", default="profile.speedscope.json")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser(
        "metrics", help="metric time-series: range/rate/quantile query / "
                        "busiest-series table")
    p.add_argument("action", choices=["query", "top"])
    p.add_argument("--address", required=True)
    p.add_argument("--name", default=None,
                   help="metric name (required for query)")
    p.add_argument("--op", choices=["range", "rate", "quantile"],
                   default="range")
    p.add_argument("--tag", action="append", default=None,
                   metavar="K=V", help="label filter (repeatable)")
    p.add_argument("--node", default=None, help="node-id prefix filter")
    p.add_argument("--since", type=float, default=None,
                   help="unix time lower bound (exclusive)")
    p.add_argument("--until", type=float, default=None,
                   help="unix time upper bound (inclusive)")
    p.add_argument("--window", type=float, default=60.0,
                   help="window seconds for rate/quantile/top")
    p.add_argument("--q", type=float, default=0.99,
                   help="quantile for --op quantile (default 0.99)")
    p.add_argument("--limit", type=int, default=2000)
    p.add_argument("--top", type=int, default=30,
                   help="rows for the top table")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser(
        "alerts", help="firing alerts + recent transitions (GCS rule "
                       "engine)")
    p.add_argument("--address", required=True)
    p.add_argument("--state", choices=["firing", "resolved"], default=None)
    p.add_argument("--limit", type=int, default=100)
    p.add_argument("--log", action="store_true",
                   help="also print the transition log")
    p.set_defaults(fn=cmd_alerts)

    p = sub.add_parser(
        "chaos", help="seeded compound-fault soak on a disposable local "
                      "cluster: fault timeline + invariant bank + MTTR "
                      "report (nonzero exit on any violation)")
    p.add_argument("--seed", type=int, default=0,
                   help="schedule seed — same seed, same fault timeline")
    p.add_argument("--duration", type=float, default=60.0,
                   help="seconds of fault injection (soak runs longer: "
                        "quiesce + invariant checks follow)")
    p.add_argument("--faults", default=",".join(
        ("node_kill", "partition", "gcs_restart", "drain", "slow_exec")),
        help="comma-separated fault kinds to draw from")
    p.add_argument("--nodes", type=int, default=2,
                   help="worker nodes (= schedule target slots)")
    p.add_argument("--serve", action="store_true",
                   help="also run a small Serve app under fire")
    p.add_argument("--replay", default=None, metavar="JSONL",
                   help="replay a previously logged timeline instead of "
                        "building one from --seed")
    p.add_argument("--workdir", default=None,
                   help="where timelines/logs/markers go (default: a "
                        "fresh temp dir)")
    p.set_defaults(fn=cmd_chaos)

    p = sub.add_parser(
        "logs", help="list/tail per-worker log files (ray logs)")
    p.add_argument("file", nargs="?", default=None,
                   help="log file name to tail (default: list files)")
    p.add_argument("--address", required=True)
    p.add_argument("--node", default=None, help="node-id prefix")
    p.add_argument("--lines", type=int, default=100)
    p.add_argument("--follow", "-f", action="store_true",
                   help="poll for new lines like tail -f")
    p.add_argument("--timeout", type=float, default=3.0)
    p.set_defaults(fn=cmd_logs)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
