"""Model multiplexing: many models share one deployment's replicas.

Reference analogue: `python/ray/serve/multiplex.py` (`@serve.multiplexed`
LRU model loading) + `serve/api.py get_multiplexed_model_id`.  A
deployment method decorated with ``@multiplexed(max_num_models_per_replica
=N)`` is an async-free model loader; each replica keeps an LRU of loaded
models, and requests carry the target model id (HTTP header
``serve_multiplexed_model_id`` or the handle option), which the router
uses for replica affinity — repeat requests for a model land on the
replica that already has it in memory.
"""

from __future__ import annotations

import contextvars
import functools
import threading
from collections import OrderedDict
from typing import Any, Callable

__all__ = ["multiplexed", "get_multiplexed_model_id"]

_model_id_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "serve_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """Inside a replica: the model id of the CURRENT request (reference:
    ``serve.get_multiplexed_model_id``)."""
    return _model_id_ctx.get()


def _set_model_id(model_id: str):
    return _model_id_ctx.set(model_id)


class _ModelCache:
    """Per-replica LRU of loaded models."""

    def __init__(self, loader: Callable, max_models: int):
        self._loader = loader
        self._max = max_models
        self._models: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, owner, model_id: str) -> Any:
        with self._lock:
            if model_id in self._models:
                self._models.move_to_end(model_id)
                return self._models[model_id]
        # load OUTSIDE the lock (loads can be slow); last writer wins
        model = self._loader(owner, model_id)
        with self._lock:
            self._models[model_id] = model
            self._models.move_to_end(model_id)
            while len(self._models) > self._max:
                # Drop the reference and let GC finalize exactly once; an
                # explicit __del__ call here would run it a second time at
                # collection.  Models wanting prompt cleanup define
                # ``unload()``.
                _, evicted = self._models.popitem(last=False)
                unload = getattr(evicted, "unload", None)
                if callable(unload):
                    try:
                        unload()
                    except Exception:  # noqa: BLE001
                        pass
                del evicted
        return model

    def ids(self):
        with self._lock:
            return list(self._models)


def multiplexed(max_num_models_per_replica: int = 3):
    """Decorator for a deployment method ``def load(self, model_id) ->
    model`` (reference: `serve/multiplex.py:multiplexed`).  Calling the
    decorated method returns the cached model, loading + LRU-evicting as
    needed."""
    if max_num_models_per_replica < 1:
        raise ValueError("max_num_models_per_replica must be >= 1")

    def deco(func):
        # The cache lives on the replica INSTANCE (created lazily at call
        # time), not in this closure: the deployment class is cloudpickled
        # to replica actors, and a closure-held Lock would break that.
        attr = f"_serve_mux_cache_{func.__name__}"

        def cache_for(self_obj) -> _ModelCache:
            cache = self_obj.__dict__.get(attr)
            if cache is None:
                # dict setdefault is atomic under the GIL: one winner
                cache = self_obj.__dict__.setdefault(
                    attr, _ModelCache(func, max_num_models_per_replica))
            return cache

        @functools.wraps(func)
        def inner(self_obj, model_id: str = None):  # noqa: RUF013
            if model_id is None:
                model_id = get_multiplexed_model_id()
            if not model_id:
                raise ValueError(
                    "no multiplexed model id for this request — send the "
                    "'serve_multiplexed_model_id' header (or model_id "
                    "query param), or set it via handle.options("
                    "multiplexed_model_id=...)")
            return cache_for(self_obj).get(self_obj, model_id)

        inner._serve_multiplexed = True
        inner._serve_model_ids = lambda self_obj: cache_for(self_obj).ids()
        return inner

    return deco
