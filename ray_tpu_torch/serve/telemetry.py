"""Serve data-plane telemetry — label-structured internal series.

Reference analogue: `python/ray/serve/_private/metrics_utils.py` and the
per-deployment ``serve_*`` Prometheus families the reference exports
(QPS, admission outcomes, latency, queue depths).  All series here are
internal-prefixed but REGISTERED with the per-process flusher
(``internal_metric(register=True)``): Serve's data plane runs in ordinary
driver/worker processes, so export rides the normal route — metrics KV
for /metrics, delta points for the GCS time-series table (range / rate /
quantile queries, SLO burn-rate alerting on the shed ratio).

Created lazily on first touch: importing serve must not start the
metrics flusher in processes that never serve traffic.
"""

from __future__ import annotations

import threading
from typing import Dict

__all__ = ["serve_metrics", "set_replica_identity", "replica_identity"]

_lock = threading.Lock()
_m: Dict[str, object] = {}  # guard: _lock (filled once, then read-only)

#: This process's replica identity (one replica actor per worker process)
#: — lets in-replica code (batcher, stream TTFT) tag series without
#: threading names through every call.
_identity = {"deployment": "", "replica": ""}

_LATENCY_BOUNDS = (0.001, 0.005, 0.025, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0)
_BATCH_BOUNDS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


def set_replica_identity(deployment: str, replica: str):
    _identity["deployment"] = deployment
    _identity["replica"] = replica


def replica_identity() -> dict:
    return dict(_identity)


def serve_metrics() -> Dict[str, object]:
    """The Serve series, created (and flusher-registered) on first use."""
    # unguarded-ok: double-checked fast path — _m is populated exactly
    # once (one update() under _lock) and only read afterwards
    if _m:
        return _m  # unguarded-ok: see above
    with _lock:
        if _m:
            return _m
        from ray_tpu_torch.util.metrics import (
            Counter,
            Gauge,
            Histogram,
            internal_metric,
        )

        made = {
            "requests": internal_metric(
                Counter, "ray_tpu_internal_serve_requests_total",
                "Requests offered to a deployment (router-observed: "
                "every call()/remote(), including ones later shed).",
                ("deployment",), register=True),
            "admitted": internal_metric(
                Counter, "ray_tpu_internal_serve_admitted_total",
                "Dispatch attempts that passed router-side admission.",
                ("deployment",), register=True),
            "shed": internal_metric(
                Counter, "ray_tpu_internal_serve_shed_total",
                "Requests shed with BackPressureError after the "
                "reject-retry budget was exhausted.",
                ("deployment",), register=True),
            "retries": internal_metric(
                Counter, "ray_tpu_internal_serve_retries_total",
                "Re-pick attempts after a full-replica reject.",
                ("deployment",), register=True),
            "latency": internal_metric(
                Histogram, "ray_tpu_internal_serve_request_latency_s",
                "End-to-end call() latency (admission + replica "
                "execution + resolve).",
                boundaries=_LATENCY_BOUNDS, tag_keys=("deployment",),
                register=True),
            "ttft": internal_metric(
                Histogram, "ray_tpu_internal_serve_ttft_s",
                "Time from stream-request entry to the first yielded "
                "item.",
                boundaries=_LATENCY_BOUNDS, tag_keys=("deployment",),
                register=True),
            "batch": internal_metric(
                Histogram, "ray_tpu_internal_serve_batch_size",
                "Formed @serve.batch sizes.",
                boundaries=_BATCH_BOUNDS, tag_keys=("deployment",),
                register=True),
            "inflight": internal_metric(
                Gauge, "ray_tpu_internal_serve_replica_inflight",
                "In-flight (admitted, executing) requests on a replica.",
                ("deployment", "replica"), register=True),
            "queue": internal_metric(
                Gauge, "ray_tpu_internal_serve_replica_queue_depth",
                "Requests parked in this replica's @serve.batch queues.",
                ("deployment", "replica"), register=True),
            "http_requests": internal_metric(
                Counter, "ray_tpu_internal_serve_http_requests_total",
                "HTTP proxy responses by matched route and status code.",
                ("route", "status"), register=True),
            "http_latency": internal_metric(
                Histogram, "ray_tpu_internal_serve_http_latency_s",
                "HTTP proxy end-to-end latency by matched route.",
                boundaries=_LATENCY_BOUNDS, tag_keys=("route",),
                register=True),
        }
        _m.update(made)
    return _m  # unguarded-ok: populated above; read-only once non-empty
