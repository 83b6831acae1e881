"""Replica — the actor hosting one copy of a deployment's callable.

Reference analogue: `python/ray/serve/_private/replica.py:447`
(``RayServeReplica.handle_request``) — minus the Cython/asyncio plumbing:
requests dispatch through the core actor transport with
``max_concurrency``, and the replica self-reports its in-flight count for
the router's power-of-two probes and the controller's autoscaler.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from ray_tpu_torch.core.config import config

config.define("serve_backpressure", bool, True,
              "Serve overload protection: replicas REJECT requests beyond "
              "max_ongoing_requests with a typed BackPressureError "
              "(router retries another replica, proxy sheds 503) instead "
              "of queueing without bound.  0 restores silent queueing.")


class Replica:
    def __init__(self, deployment_def, init_args, init_kwargs,
                 user_config: Optional[dict] = None,
                 max_ongoing_requests: int = 0,
                 deployment_name: str = "", replica_name: str = ""):
        from ray_tpu_torch._vendor import cloudpickle

        fn_or_class = cloudpickle.loads(deployment_def)
        self._ongoing = 0
        self._total = 0
        self._rejected = 0
        # 0 = unenforced (legacy replicas / tests constructing directly)
        self._max_ongoing = int(max_ongoing_requests or 0)
        self._lock = threading.Lock()
        self._start_time = time.time()
        self._deployment = deployment_name
        self._tags = {"deployment": deployment_name,
                      "replica": replica_name}
        if deployment_name:
            from ray_tpu_torch.serve.telemetry import set_replica_identity

            set_replica_identity(deployment_name, replica_name)
        if isinstance(fn_or_class, type):
            self._callable = fn_or_class(*init_args, **(init_kwargs or {}))
        else:
            self._callable = fn_or_class
        if user_config is not None:
            self.reconfigure(user_config)

    # ------------------------------------------------------------- serving

    def _admit(self):
        """max_ongoing_requests admission: REJECT (typed, retryable by the
        router) instead of silently queueing — bounded work is what keeps
        p99 finite under overload (reference: Serve max_ongoing_requests
        backpressure)."""
        from ray_tpu_torch.core.exceptions import BackPressureError

        with self._lock:
            if (self._max_ongoing > 0 and config.serve_backpressure
                    and self._ongoing >= self._max_ongoing):
                self._rejected += 1
                raise BackPressureError(
                    f"replica at max_ongoing_requests="
                    f"{self._max_ongoing} ({self._ongoing} in flight)")
            self._ongoing += 1
            self._total += 1
        self._observe_load()

    def _observe_load(self):
        """Per-replica load gauges: admitted in-flight count plus the
        depth of any @serve.batch queues in this process (the only place
        admitted-but-not-executing requests can park)."""
        if not self._deployment:
            return
        from ray_tpu_torch.serve import batching
        from ray_tpu_torch.serve.telemetry import serve_metrics

        m = serve_metrics()
        m["inflight"].set(float(self._ongoing), tags=self._tags)
        depth = sum(b.queue.qsize() for b in batching._registry.values())
        m["queue"].set(float(depth), tags=self._tags)

    def _chaos_user_call(self):
        """Slow-executor chaos seam INSIDE the admission-counted window
        (the worker-level pre-exec seam sleeps before ``_admit`` runs, so
        it can't pile up ``_ongoing``): matches
        ``RAY_TPU_CHAOS_EXEC_DELAY_NAMES`` substring 'Replica.user' or the
        user callable's own name."""
        from ray_tpu_torch.util import chaos

        name = getattr(self._callable, "__name__",
                       type(self._callable).__name__)
        chaos.exec_delay(f"Replica.user:{name}")

    def handle_request(self, request: Any, method: str = "__call__",
                       multiplexed_model_id: str = ""):
        from ray_tpu_torch.serve.multiplex import _set_model_id

        self._admit()
        token = _set_model_id(multiplexed_model_id)
        try:
            if method == "__call__" and callable(self._callable):
                fn = self._callable  # plain function or __call__ instance
            else:
                fn = getattr(self._callable, method)
            self._chaos_user_call()
            return fn(request)
        finally:
            from ray_tpu_torch.serve.multiplex import _model_id_ctx

            _model_id_ctx.reset(token)
            with self._lock:
                self._ongoing -= 1
            self._observe_load()

    def handle_request_stream(self, request: Any, method: str = "__call__",
                              multiplexed_model_id: str = ""):
        """Generator variant (invoked with num_returns="streaming"): the
        user callable returns an iterator whose items stream to the caller
        as they are produced (reference: Serve streaming responses over
        streaming generator returns)."""
        from ray_tpu_torch.serve.multiplex import _model_id_ctx, _set_model_id
        from ray_tpu_torch.util import tracing

        self._admit()
        token = _set_model_id(multiplexed_model_id)
        try:
            if method == "__call__" and callable(self._callable):
                fn = self._callable
            else:
                fn = getattr(self._callable, method)
            self._chaos_user_call()
            # time-to-first-token: the interval from request entry to the
            # first streamed item, emitted as a sub-span of this call's
            # task.run (the generator body runs inside its context)
            t0 = time.time()
            ttft_ctx = tracing.current_trace_ctx() \
                if tracing.tracing_enabled() else None
            first = True
            for item in fn(request):
                if first:
                    first = False
                    if ttft_ctx is not None:
                        tracing.hop("serve.ttft", ttft_ctx, t0, time.time(),
                                    proc="worker", method=method)
                    if self._deployment:
                        from ray_tpu_torch.serve.telemetry import serve_metrics

                        serve_metrics()["ttft"].observe(
                            time.time() - t0,
                            tags={"deployment": self._deployment})
                yield item
        finally:
            _model_id_ctx.reset(token)
            with self._lock:
                self._ongoing -= 1
            self._observe_load()

    def multiplexed_model_ids(self) -> list:
        """Model ids currently loaded by any @multiplexed method on this
        replica (for tests/state; the reference broadcasts these to the
        router for affinity)."""
        out = []
        cal = self._callable
        for name in dir(type(cal)):
            attr = getattr(type(cal), name, None)
            if callable(attr) and getattr(attr, "_serve_multiplexed", False):
                out.extend(attr._serve_model_ids(cal))
        return out

    # ------------------------------------------------------------- control

    def get_queue_len(self) -> int:
        return self._ongoing

    def stats(self) -> dict:
        return {"ongoing": self._ongoing, "total": self._total,
                "rejected": self._rejected,
                "max_ongoing_requests": self._max_ongoing,
                "uptime_s": time.time() - self._start_time}

    def reconfigure(self, user_config: dict):
        if hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)
        return True

    def check_health(self) -> bool:
        if hasattr(self._callable, "check_health"):
            return bool(self._callable.check_health())
        return True
