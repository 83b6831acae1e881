"""Standalone cluster head process: GCS + head raylet + autoscaler monitor.

Reference analogue: the head-node process set `ray up` brings up
(`python/ray/autoscaler/_private/monitor.py:126` runs the autoscaler next
to the GCS; `python/ray/scripts/scripts.py` ``up :1238`` / ``down :1314``).

Run: ``python -m ray_tpu_torch.autoscaler.monitor_main --config cluster.yaml``
Prints ``CLUSTER_ADDRESS host:port`` once the control plane is up, then
supervises until SIGTERM.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def load_config(path: str) -> dict:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg.setdefault("cluster_name", "default")
    cfg.setdefault("max_workers", 8)
    cfg.setdefault("idle_timeout_s", 60.0)
    cfg.setdefault("head_node", {"resources": {"CPU": 1}})
    cfg.setdefault("worker_node_types", {})
    provider = cfg.setdefault("provider", {"type": "local"})
    if provider.get("type", "local") not in ("local", "gce"):
        raise ValueError(
            f"provider type {provider.get('type')!r} not available — "
            "'local' and 'gce' are implemented; others plug in via "
            "ray_tpu_torch.autoscaler.NodeProvider")
    if provider.get("type") == "gce":
        for key in ("project", "zone"):
            if not provider.get(key):
                raise ValueError(f"gce provider config needs {key!r}")
    return cfg


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--update-interval", type=float, default=2.0)
    args = parser.parse_args()
    cfg = load_config(args.config)

    from ray_tpu_torch import cluster_utils
    from ray_tpu_torch.autoscaler import (
        LocalNodeProvider,
        Monitor,
        StandardAutoscaler,
    )

    env = cluster_utils.make_cluster_env()
    gcs_proc, address = cluster_utils.spawn_gcs(env)
    head_res = {str(k): float(v)
                for k, v in cfg["head_node"].get("resources",
                                                 {"CPU": 1}).items()}
    head = cluster_utils.spawn_raylet(
        address, head_res, cfg["head_node"].get("object_store_mb", 128), env)
    if cfg["provider"].get("type") == "gce":
        from ray_tpu_torch.autoscaler.gce import GceNodeProvider, RestGceApi

        provider = GceNodeProvider(
            address, cfg["worker_node_types"],
            RestGceApi(cfg["provider"]["project"], cfg["provider"]["zone"]),
            cluster_name=cfg["cluster_name"])
    else:
        provider = LocalNodeProvider(address, cfg["worker_node_types"])
    autoscaler = StandardAutoscaler(
        address, provider, cfg["worker_node_types"],
        max_workers=cfg["max_workers"],
        idle_timeout_s=cfg["idle_timeout_s"],
        head_node_id=head.node_id)
    monitor = Monitor(autoscaler, args.update_interval).start()

    print(f"CLUSTER_ADDRESS {address}", flush=True)

    stop = threading.Event()

    def _term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    stop.wait()

    monitor.stop()
    provider.shutdown()
    for proc in (head.proc, gcs_proc):
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except Exception:  # noqa: BLE001
                proc.kill()
    return 0


if __name__ == "__main__":
    sys.exit(main())
