"""The multiplexed model id of the current request.

The part of ``ray_tpu/serve/multiplex.py`` that the port's ``Replica``
uses: it sets the id for the length of a request and resets it after.
The ``@multiplexed`` LRU model loader is not ported yet (ROADMAP).
"""

from __future__ import annotations

import contextvars

__all__ = ["get_multiplexed_model_id"]

_model_id_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "serve_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """Inside a replica: the model id of the CURRENT request (reference:
    ``serve.get_multiplexed_model_id``)."""
    return _model_id_ctx.get()


def _set_model_id(model_id: str):
    return _model_id_ctx.set(model_id)
