"""Runtime context: where am I running?

Reference analogue: `python/ray/runtime_context.py`
(``ray.get_runtime_context()`` → node id, worker id, task id, actor id).
"""

from __future__ import annotations

import contextvars
from typing import Optional

__all__ = ["RuntimeContext", "get_runtime_context"]

#: set by the worker's execute paths around each task
_current_task_id: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_current_task_id", default=None)

#: absolute deadline (time.time()) of the currently executing task, set by
#: the worker's execute paths — nested submits inherit the tightest
#: enclosing deadline through it (deadline propagation)
_current_deadline: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_current_deadline", default=None)


class RuntimeContext:
    def get_node_id(self) -> Optional[str]:
        from ray_tpu_torch.core.worker import global_worker

        w = global_worker()
        if w.mode == "driver":
            return w.raylet.node_id
        if w.mode == "client":
            return getattr(w, "node_id", None)
        from ray_tpu_torch.core.config import config

        return config.node_id or None

    def get_worker_id(self) -> str:
        from ray_tpu_torch.core.worker import global_worker

        return global_worker().worker_id.hex()

    def get_task_id(self) -> Optional[str]:
        """Inside a task: its TaskID hex; None on the driver."""
        tid = _current_task_id.get()
        return tid.hex() if tid is not None else None

    def get_actor_id(self) -> Optional[str]:
        """Inside an actor method: the hosting actor's id."""
        from ray_tpu_torch.core.worker import global_worker

        aid = getattr(global_worker(), "current_actor_id", None)
        return aid.hex() if aid is not None else None

    @property
    def was_current_actor_reconstructed(self) -> bool:
        from ray_tpu_torch.core.config import config

        return bool(config.actor_restarts)


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext()
