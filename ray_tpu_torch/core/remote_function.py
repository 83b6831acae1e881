"""``@ray_tpu_torch.remote`` functions (reference: `python/ray/remote_function.py`)."""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, Optional

from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.ids import TaskID
from ray_tpu_torch.core.task_spec import NORMAL_TASK, TaskSpec
from ray_tpu_torch.core.worker import global_worker
from ray_tpu_torch.util.tracing import submit_with_span


def _build_resources(opts: Dict[str, Any]) -> Dict[str, float]:
    res = dict(opts.get("resources") or {})
    num_cpus = opts.get("num_cpus")
    num_tpus = opts.get("num_tpus", opts.get("num_gpus"))
    res["CPU"] = float(1 if num_cpus is None else num_cpus)
    if num_tpus:
        res["TPU"] = float(num_tpus)
    return {k: v for k, v in res.items() if v}


def _prepare_env(worker, env: Optional[dict]) -> Optional[dict]:
    if not env or not (env.get("working_dir") or env.get("py_modules")
                       or env.get("pip") or env.get("conda")):
        return env
    from ray_tpu_torch.core.runtime_env import prepare_runtime_env

    return prepare_runtime_env(worker, env)


def _placement_from_opts(opts) -> Optional[dict]:
    strategy = opts.get("scheduling_strategy")
    if strategy is None:
        return None
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
        PlacementGroupSchedulingStrategy,
    )

    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        return {
            "pg": strategy.placement_group.id.hex(),
            "bundle": strategy.placement_group_bundle_index,
        }
    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        return {"node_id": strategy.node_id, "soft": strategy.soft}
    return None


def deadline_from_opts(opts) -> Optional[float]:
    """``deadline_s`` (relative seconds) -> absolute wall-clock deadline;
    None when unset or the RAY_TPU_DEADLINES kill switch is off."""
    ds = opts.get("deadline_s")
    if ds is None or not config.deadlines:
        return None
    ds = float(ds)
    if ds < 0:
        raise ValueError("deadline_s must be >= 0")
    return time.time() + ds


class RemoteFunction:
    def __init__(self, function, **options):
        self._function = function
        self._options = options
        # Resources are a pure function of the (immutable) options:
        # build once and share the SAME dict across every spec this
        # function submits — nobody mutates spec.resources, and within
        # one dburst frame the pickler memoizes the shared dict so a
        # burst pays its serialization once instead of per call.
        self._resources = _build_resources(options)
        self.__name__ = getattr(function, "__name__", "remote_fn")
        self.__doc__ = getattr(function, "__doc__", None)

    def options(self, **new_options) -> "RemoteFunction":
        merged = copy.copy(self._options)
        merged.update(new_options)
        return RemoteFunction(self._function, **merged)

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._options)

    def _remote(self, args, kwargs, opts):
        worker = global_worker()
        fid, blob = worker.register_function(self._function)
        out_args, out_kwargs, inner_refs = worker._prepare_args(args, kwargs)
        num_returns = opts.get("num_returns", 1)
        streaming = num_returns == "streaming"
        if streaming:
            from ray_tpu_torch.core.task_spec import STREAMING_RETURNS

            num_returns = STREAMING_RETURNS
        max_retries = (0 if streaming
                       else opts.get("max_retries", config.task_retry_default))
        spec = TaskSpec(
            task_id=TaskID.from_random(),
            kind=NORMAL_TASK,
            name=opts.get("name") or self.__name__,
            function_blob=blob,
            function_id=fid,
            args=out_args,
            kwargs=out_kwargs,
            inner_refs=inner_refs or None,
            num_returns=num_returns,
            resources=(self._resources if opts is self._options
                       else _build_resources(opts)),
            max_retries=max_retries,
            retries_left=max_retries,
            retry_exceptions=bool(opts.get("retry_exceptions", False)),
            replicate=bool(opts.get("_replicate", False)),
            runtime_env=_prepare_env(worker, opts.get("runtime_env")),
            placement=_placement_from_opts(opts),
            deadline=deadline_from_opts(opts),
        )
        refs = submit_with_span(worker, spec)
        if streaming:
            from ray_tpu_torch.core.object_ref import ObjectRefGenerator

            return ObjectRefGenerator(spec.task_id)
        if spec.num_returns == 1:
            return refs[0]
        return refs

    def bind(self, *args, **kwargs):
        """Build a lazy DAG node (reference: ``RemoteFunction.bind`` →
        `python/ray/dag/dag_node.py`); execute with ``node.execute()`` or
        run durably via ``ray_tpu_torch.workflow.run``."""
        from ray_tpu_torch.dag import FunctionNode

        return FunctionNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self.__name__}' cannot be called directly; "
            f"use '{self.__name__}.remote()'."
        )
