"""Replica — hosts one copy of a deployment's callable.

Port of ``ray_tpu/serve/replica.py``: admission against
``max_ongoing_requests``, ``handle_request`` and its streaming variant,
``stats``, ``multiplexed_model_ids``, ``reconfigure`` and
``check_health``.  The deployment definition is the class or function
itself, or bytes made by the stdlib ``pickle`` (not cloudpickle).  The
telemetry, tracing and chaos hooks of the JAX replica are not ported yet
(ROADMAP).
"""

from __future__ import annotations

import pickle
import threading
import time
from typing import Any, Optional

from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.exceptions import BackPressureError
from ray_tpu_torch.serve.multiplex import _model_id_ctx, _set_model_id

config.define("serve_backpressure", bool, True,
              "Serve overload protection: replicas REJECT requests beyond "
              "max_ongoing_requests with a typed BackPressureError "
              "instead of queueing without bound.  0 restores silent "
              "queueing.")


class Replica:
    def __init__(self, deployment_def, init_args=(), init_kwargs=None,
                 user_config: Optional[dict] = None,
                 max_ongoing_requests: int = 0):
        if isinstance(deployment_def, bytes):
            deployment_def = pickle.loads(deployment_def)
        self._ongoing = 0
        self._total = 0
        self._rejected = 0
        # 0 = unenforced
        self._max_ongoing = int(max_ongoing_requests or 0)
        self._lock = threading.Lock()
        self._start_time = time.time()
        if isinstance(deployment_def, type):
            self._callable = deployment_def(*init_args, **(init_kwargs or {}))
        else:
            self._callable = deployment_def
        if user_config is not None:
            self.reconfigure(user_config)

    # ------------------------------------------------------------- serving

    def _admit(self):
        """max_ongoing_requests admission: REJECT (typed, retryable by the
        caller) instead of silently queueing."""
        with self._lock:
            if (self._max_ongoing > 0 and config.serve_backpressure
                    and self._ongoing >= self._max_ongoing):
                self._rejected += 1
                raise BackPressureError(
                    f"replica at max_ongoing_requests="
                    f"{self._max_ongoing} ({self._ongoing} in flight)")
            self._ongoing += 1
            self._total += 1

    def _release(self):
        with self._lock:
            self._ongoing -= 1

    def _method(self, method: str):
        if method == "__call__" and callable(self._callable):
            return self._callable  # plain function or __call__ instance
        return getattr(self._callable, method)

    def handle_request(self, request: Any, method: str = "__call__",
                       multiplexed_model_id: str = ""):
        self._admit()
        token = _set_model_id(multiplexed_model_id)
        try:
            return self._method(method)(request)
        finally:
            _model_id_ctx.reset(token)
            self._release()

    def handle_request_stream(self, request: Any, method: str = "__call__",
                              multiplexed_model_id: str = ""):
        """Generator variant: the user callable returns an iterator whose
        items are yielded to the caller as they are produced.  The request
        is admitted when the first item is asked for."""
        self._admit()
        token = _set_model_id(multiplexed_model_id)
        try:
            yield from self._method(method)(request)
        finally:
            _model_id_ctx.reset(token)
            self._release()

    def multiplexed_model_ids(self) -> list:
        """Model ids currently loaded by any @multiplexed method on this
        replica (the reference broadcasts these to the router for
        affinity)."""
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
