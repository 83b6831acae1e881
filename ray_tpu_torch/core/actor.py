"""Actors: class wrapper, handles, methods.

Reference analogues: ``ActorClass`` (`python/ray/actor.py:383`),
``ActorHandle`` (`:1024`), ``ActorMethod`` (`:98`).  An actor occupies a
dedicated worker process; method calls are dispatched FIFO by the raylet's
per-actor queue (`ray_tpu_torch/core/raylet.py`), matching the reference's ordered
actor scheduling queues (`src/ray/core_worker/transport/actor_scheduling_queue.cc`).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.ids import ActorID, TaskID
from ray_tpu_torch.core.remote_function import (
    _build_resources,
    _placement_from_opts,
    _prepare_env,
    deadline_from_opts,
)
from ray_tpu_torch.core.task_spec import (
    ACTOR_CREATION_TASK,
    ACTOR_TASK,
    TaskSpec,
)
from ray_tpu_torch.core.worker import global_worker
from ray_tpu_torch.util.tracing import submit_with_span


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str, **options):
        self._handle = handle
        self._method_name = method_name
        self._options = options

    def options(self, **new_options) -> "ActorMethod":
        merged = copy.copy(self._options)
        merged.update(new_options)
        return ActorMethod(self._handle, self._method_name, **merged)

    def remote(self, *args, **kwargs):
        return self._handle._invoke(self._method_name, args, kwargs,
                                    self._options)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method '{self._method_name}' cannot be called directly; "
            f"use '.{self._method_name}.remote()'."
        )


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_name: str = "Actor",
                 method_groups: Optional[Dict[str, str]] = None):
        self._actor_id = actor_id
        self._class_name = class_name
        # method -> concurrency group (actors with named groups only)
        self._method_groups = method_groups or {}

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def _invoke(self, method_name, args, kwargs, opts):
        worker = global_worker()
        out_args, out_kwargs, inner_refs = worker._prepare_args(args, kwargs)
        num_returns = opts.get("num_returns", 1)
        streaming = num_returns == "streaming"
        if streaming:
            from ray_tpu_torch.core.task_spec import STREAMING_RETURNS

            num_returns = STREAMING_RETURNS
        spec = TaskSpec(
            task_id=TaskID.from_random(),
            kind=ACTOR_TASK,
            name=f"{self._class_name}.{method_name}",
            args=out_args,
            kwargs=out_kwargs,
            inner_refs=inner_refs or None,
            num_returns=num_returns,
            actor_id=self._actor_id,
            method_name=method_name,
            replicate=bool(opts.get("_replicate", False)),
            concurrency_group=(opts.get("concurrency_group")
                               or self._method_groups.get(method_name)),
            deadline=deadline_from_opts(opts),
        )
        refs = submit_with_span(worker, spec,
                                actor_id=self._actor_id.hex())
        if streaming:
            from ray_tpu_torch.core.object_ref import ObjectRefGenerator

            return ObjectRefGenerator(spec.task_id)
        return refs[0] if spec.num_returns == 1 else refs

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        # Cache the bound ActorMethod on the instance: a submit burst
        # probes the same method once per call, and __getattr__ only
        # fires on lookup MISS — after this, attribute access is a plain
        # dict hit instead of a fresh allocation per call.  (.options()
        # still mints a new ActorMethod; the cached one is optionless.)
        method = ActorMethod(self, name)
        self.__dict__[name] = method
        return method

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name,
                              self._method_groups))

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id


class ActorClass:
    def __init__(self, cls, **options):
        self._cls = cls
        self._options = options
        self.__name__ = getattr(cls, "__name__", "Actor")

    def options(self, **new_options) -> "ActorClass":
        merged = copy.copy(self._options)
        merged.update(new_options)
        return ActorClass(self._cls, **merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._remote(args, kwargs, self._options)

    def _remote(self, args, kwargs, opts) -> ActorHandle:
        # Reference semantics: actors default to num_cpus=0 (they hold their
        # resources for life, so a 1-CPU default would starve the node).
        opts = dict(opts)
        opts.setdefault("num_cpus", 0)
        worker = global_worker()
        fid, blob = worker.register_function(self._cls)
        out_args, out_kwargs, inner_refs = worker._prepare_args(args, kwargs)
        actor_id = ActorID.from_random()
        max_restarts = opts.get("max_restarts",
                                config.actor_max_restarts_default)
        groups = opts.get("concurrency_groups")
        declared_conc = opts.get("max_concurrency", 1)
        method_groups: Optional[Dict[str, str]] = None
        if groups:
            if "_default" in groups:
                raise ValueError(
                    "'_default' is reserved; set its size via "
                    "max_concurrency")
            for gname, n in groups.items():
                if not isinstance(n, int) or n < 1:
                    raise ValueError(
                        f"concurrency group {gname!r} size must be a "
                        f"positive int, got {n!r}")
            # method -> group map from @ray_tpu_torch.method tags, shipped on the
            # creation spec so the raylet can admit per group and any
            # handle (incl. get_actor) can stamp calls.
            method_groups = {}
            for mname, attr in vars(self._cls).items():
                tag = getattr(attr, "__ray_tpu_method_options__", None)
                if tag and tag.get("concurrency_group"):
                    g = tag["concurrency_group"]
                    if g not in groups:
                        raise ValueError(
                            f"method {mname!r} tagged with undeclared "
                            f"concurrency group {g!r}")
                    method_groups[mname] = g
            concurrency_groups = {"_default": declared_conc, **groups}
            # raylet total admission cap = sum of per-group slots
            total_concurrency = declared_conc + sum(groups.values())
        else:
            concurrency_groups = None
            total_concurrency = declared_conc
        # Checkpointable actors (reference: Ray actor checkpointing
        # lineage, SURVEY §5): opt-in protocol — the class defines
        # __ray_save__(self) -> state and __ray_restore__(self, state);
        # the worker snapshots every `checkpoint_interval` completed
        # calls and a restart restores from the latest snapshot instead
        # of starting cold.
        checkpoint_interval = int(opts.get("checkpoint_interval", 0) or 0)
        if checkpoint_interval < 0:
            raise ValueError("checkpoint_interval must be >= 0")
        if checkpoint_interval:
            for proto in ("__ray_save__", "__ray_restore__"):
                if not callable(getattr(self._cls, proto, None)):
                    raise TypeError(
                        f"checkpoint_interval requires the actor class to "
                        f"define {proto}")
            if groups or declared_conc > 1:
                # a snapshot taken while other threads mutate the instance
                # would tear state — checkpointing is sync-actor only
                raise ValueError(
                    "checkpoint_interval requires a plain sync actor "
                    "(max_concurrency=1, no concurrency groups)")
        placement = _placement_from_opts(opts) or {}
        if opts.get("name"):
            placement["name"] = opts["name"]
            placement["namespace"] = opts.get("namespace", "")
        spec = TaskSpec(
            task_id=TaskID.from_random(),
            kind=ACTOR_CREATION_TASK,
            name=f"{self.__name__}.__init__",
            function_blob=blob,
            function_id=fid,
            args=out_args,
            kwargs=out_kwargs,
            inner_refs=inner_refs or None,
            num_returns=1,
            resources=_build_resources(opts),
            max_restarts=max_restarts,
            max_concurrency=total_concurrency,
            checkpoint_interval=checkpoint_interval,
            concurrency_groups=concurrency_groups,
            method_groups=method_groups,
            actor_id=actor_id,
            runtime_env=_prepare_env(worker, opts.get("runtime_env")),
            placement=placement or None,
        )
        worker.submit_spec(spec)
        return ActorHandle(actor_id, self.__name__, method_groups)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self.__name__}' cannot be instantiated directly; "
            f"use '{self.__name__}.remote()'."
        )


def get_actor(name: str, namespace: str = "") -> ActorHandle:
    worker = global_worker()
    if worker.mode == "driver":
        raylet = worker.raylet
        # Through the event loop: an actor created just before via the
        # async submit path is guaranteed registered once this runs.
        info = raylet.call(
            lambda: raylet.gcs.lookup_named_actor(namespace, name)).result()
        if info is None:
            raise ValueError(f"no actor named {name!r}")
        if info.get("state") == "dead":
            from ray_tpu_torch.core.exceptions import ActorDiedError

            raise ActorDiedError(
                info["actor_id"].hex(),
                info.get("death_reason", "actor is dead"))
        aid = ActorID(info["actor_id"])
        if info.get("spec_blob"):
            from ray_tpu_torch._vendor import cloudpickle as _cp

            creation_spec = _cp.loads(info["spec_blob"])
        else:
            raylet = worker.raylet
            creation_spec = raylet.call(
                lambda: raylet._actors[aid].creation_spec).result()
    else:
        info = worker._request("named_actor", name=name, namespace=namespace)
        aid, creation_spec = info["actor_id"], info["creation_spec"]
    return ActorHandle(aid, creation_spec.name.split(".")[0],
                       getattr(creation_spec, "method_groups", None))


def kill(actor: ActorHandle, no_restart: bool = True):
    worker = global_worker()
    if worker._direct is not None:
        # the kill travels the raylet path; frames already in flight on a
        # direct channel must reconcile rather than race the SIGKILL
        worker._direct.forget_actor(actor.actor_id)
    if worker.mode == "driver":
        worker.raylet.call_async(
            worker.raylet.kill_actor, actor.actor_id, no_restart
        )
    elif worker.mode == "local":
        worker._actors.pop(actor.actor_id, None)
    else:
        worker._request("kill_actor", actor_id=actor.actor_id,
                        no_restart=no_restart)
