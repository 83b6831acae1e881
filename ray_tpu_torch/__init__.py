"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package beside ``ray_tpu`` with the same module paths
(``ray_tpu_torch/ops/flash_attention.py`` is the counterpart of
``ray_tpu/ops/flash_attention.py``).  It imports ``torch`` and nothing of
JAX or of ``ray_tpu``; where it needs a pure-Python module of ``ray_tpu``
it keeps its own copy.  Every Pallas kernel on a ported path is a kernel
written by hand for ``sm_90a`` under ``csrc/``.

The public API is ``ray_tpu``'s (`ray_tpu/__init__.py`): ``init``,
``@remote``, ``get``, ``put``, ``wait``, ``cancel``, actors, placement
groups, ``cluster_resources``, ``nodes`` and ``timeline``, on a copy of its
core runtime (``core``, ``util``, ``native``'s host libraries, with
cloudpickle vendored under ``_vendor``).  The resource key ``"TPU"`` means
one accelerator chip, here a CUDA card; ``num_gpus=`` is its alias.

Sub-packages: ``core`` (the runtime: ids, protocol, GCS, raylet, object
store, workers, actors, placement groups), ``util`` (locks, metrics,
tracing, profiling, the state API, chaos), ``native`` (the nvcc build of
``csrc`` and the g++ build of the runtime's host libraries), ``ops`` (flash
attention), ``models`` (GPT-2, Llama, the MNIST CNN), ``serve`` (deployments
on replica actors: the controller, the router and its handles, the HTTP
proxy, batching, multiplexing, telemetry), ``parallel`` (mesh, sharding
rules, ring and Ulysses attention, the pipeline, spawned ranks),
``collective`` (named-axis collectives over process groups), ``train``
(``TorchTrainer`` and its workers), ``tune`` (trials in actors, searchers and
schedulers) and ``rllib`` (``Algorithm``, a Tune ``Trainable``, with its
rollout actors and learners: PPO, IMPALA, DQN, SAC, BC and multi-agent
PPO).
No runtime is started on import: ``init()`` starts one.
"""

from __future__ import annotations

import inspect
from typing import Any, List, Optional, Sequence, Union

from ray_tpu_torch._version import __version__
from ray_tpu_torch.core import worker as _worker_mod
from ray_tpu_torch.core.actor import ActorClass, ActorHandle, get_actor, kill
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.exceptions import (
    ActorDiedError,
    BackPressureError,
    DeadlineExceededError,
    GetTimeoutError,
    ObjectLostError,
    OutOfMemoryError,
    RayTpuError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.placement_group import (
    PlacementGroup,
    placement_group,
    remove_placement_group,
)
from ray_tpu_torch.core.remote_function import RemoteFunction
from ray_tpu_torch.core.worker import (
    DriverWorker,
    LocalWorker,
    clear_worker,
    global_worker,
    init_worker,
    is_initialized,
)

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "cancel", "get_actor", "method", "ObjectRef", "ActorHandle",
    "placement_group", "remove_placement_group", "PlacementGroup",
    "cluster_resources", "available_resources", "nodes", "timeline",
    "RayTpuError", "TaskError", "ActorDiedError", "WorkerCrashedError",
    "GetTimeoutError", "ObjectLostError", "DeadlineExceededError",
    "TaskCancelledError", "BackPressureError", "OutOfMemoryError",
    "__version__",
    # sub-packages
    "air", "autoscaler", "collective", "core", "dashboard", "data",
    "job_submission", "models", "native", "ops", "parallel", "rllib",
    "serve", "train", "tune", "util", "workflow",
]


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[int] = None,
    num_tpus: Optional[int] = None,
    resources: Optional[dict] = None,
    object_store_memory: Optional[int] = None,
    local_mode: bool = False,
    namespace: str = "",
    ignore_reinit_error: bool = False,
    log_to_driver: bool = True,
    runtime_env: Optional[dict] = None,
    configure_logging: bool = True,
    **kwargs,
):
    """Start the runtime (reference: `python/ray/_private/worker.py:1106`).

    ``address``: GCS address ``"host:port"`` to join an existing cluster as
    a driver (reference ``ray.init(address=...)``); None starts the embedded
    single-node runtime.
    """
    if is_initialized():
        if ignore_reinit_error:
            return
        raise RuntimeError("ray_tpu_torch.init() called twice "
                           "(pass ignore_reinit_error=True to allow)")
    if local_mode:
        init_worker(LocalWorker())
        return
    if address is None:
        # Auto-attach for entrypoints launched by the job manager
        # (reference: RAY_ADDRESS handling in ray.init).
        address = config.address or None
    if address is not None:
        from ray_tpu_torch.core.client import ClientWorker

        # "ray://host:port" (reference Ray Client URI scheme,
        # `python/ray/client_builder.py:90`) and bare "host:port" both
        # attach this process as a remote driver — the client-mode
        # ClientWorker IS the remote-driver proxy here (same TCP path for
        # local and remote drivers; no separate proxy server needed).
        if address.startswith("ray://"):
            address = address[len("ray://"):]
        init_worker(ClientWorker(address, log_to_driver=log_to_driver))
        return
    init_worker(
        DriverWorker(
            num_cpus=num_cpus,
            num_tpus=num_tpus,
            resources=resources,
            object_store_memory=object_store_memory,
            namespace=namespace,
        )
    )


def shutdown():
    if not is_initialized():
        return
    # Final synchronous metrics flush BEFORE the worker goes away (the
    # daemon flusher would drop the last window) + flusher/producer reset
    # so a re-init in this process doesn't double-report.
    try:
        from ray_tpu_torch.util.metrics import shutdown_metrics

        shutdown_metrics()
    except Exception:  # noqa: BLE001
        pass
    w = global_worker()
    clear_worker()
    if hasattr(w, "shutdown"):
        w.shutdown()


def remote(*args, **kwargs):
    """``@remote`` decorator for functions and classes
    (reference: `python/ray/_private/worker.py:2923`)."""

    def wrap(obj):
        if inspect.isclass(obj):
            return ActorClass(obj, **kwargs)
        return RemoteFunction(obj, **kwargs)

    if len(args) == 1 and not kwargs and callable(args[0]):
        return wrap(args[0])
    if args:
        raise TypeError("@remote takes keyword options only, e.g. "
                        "@remote(num_cpus=2)")
    return wrap


def method(**options):
    """Per-method options decorator (e.g. num_returns) — kept for parity;
    options can also be given at the call site via ``.options()``."""

    def wrap(m):
        m.__ray_tpu_method_options__ = options
        return m

    return wrap


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None) -> Any:
    w = global_worker()
    if isinstance(refs, ObjectRef):
        return w.get([refs], timeout=timeout)[0]
    if isinstance(refs, (list, tuple)):
        if not refs:
            return []
        if not all(isinstance(r, ObjectRef) for r in refs):
            raise TypeError("get() accepts an ObjectRef or a list of ObjectRefs")
        return w.get(list(refs), timeout=timeout)
    raise TypeError(f"get() got {type(refs)}")


def put(value: Any, *, _replicate: bool = False) -> ObjectRef:
    """``_replicate=True`` eagerly pushes a secondary copy of the object
    to another node (cheap availability: losing the holder then costs a
    pull from the replica, not a lineage recompute)."""
    if isinstance(value, ObjectRef):
        raise TypeError("put() of an ObjectRef is not allowed")
    return global_worker().put(value, _replicate=_replicate)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    if len(set(refs)) != len(refs):
        # Reference semantics: duplicate refs make num_returns ambiguous.
        raise ValueError("wait() got duplicate ObjectRefs")
    if num_returns <= 0 or num_returns > len(refs):
        raise ValueError(f"num_returns must be in [1, {len(refs)}]")
    return global_worker().wait(refs, num_returns=num_returns, timeout=timeout)


def get_runtime_context():
    """Where am I running? (reference: ``ray.get_runtime_context``,
    `python/ray/runtime_context.py`)."""
    from ray_tpu_torch.runtime_context import get_runtime_context as _grc

    return _grc()


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    """Cancel a task (reference: ``ray.cancel``): queued work is dropped
    (``TaskCancelledError`` on its returns), RUNNING work is interrupted
    at the next bytecode boundary, and with ``recursive=True`` (default)
    the cancel fans out to every task the target spawned — a timed-out
    request does not orphan its downstream tree.  Cancel frames reach
    directly-dialed callees (PR 11 transport) as well as raylet queues.
    Returns True if anything was found to cancel."""
    w = global_worker()
    return w.cancel(ref, force=force, recursive=recursive)


def free(refs: Sequence[ObjectRef]):
    global_worker().free(list(refs))


def cluster_resources() -> dict:
    """Aggregate TOTAL resources across alive nodes."""
    w = global_worker()
    if w.mode == "local":
        return {}
    total: dict = {}
    for n in w.gcs_nodes():
        if n.get("alive"):
            for k, v in n["resources_total"].items():
                total[k] = total.get(k, 0.0) + v
    return total


def available_resources() -> dict:
    w = global_worker()
    if w.mode == "driver":
        return w.raylet.call(lambda: dict(w.raylet.resources_available)).result()
    if w.mode == "client":
        return w._request("available_resources")
    return {}


def nodes() -> List[dict]:
    """Cluster membership (reference: ``ray.nodes()``)."""
    w = global_worker()
    if w.mode == "local":
        return []
    return [{
        "NodeID": n["node_id"],
        "Alive": n.get("alive", True),
        "Suspect": bool(n.get("suspect")),
        "Draining": bool(n.get("draining")),
        "Incarnation": n.get("incarnation", 0),
        "Resources": n.get("resources_total", {}),
        "Address": n.get("address"),
        "Hostname": n.get("hostname", ""),
    } for n in w.gcs_nodes()]


def timeline(filename: Optional[str] = None):
    """Dump the CLUSTER-WIDE task timeline as chrome://tracing JSON
    (reference: `python/ray/_private/state.py:416`), fed by the GCS
    task-event table: per-task queue-wait vs run sub-slices, open-ended
    slices for still-running tasks (they are not silently dropped), and —
    when tracing is enabled — flow arrows from the driver's submit spans
    to the matching run slices."""
    import json

    from ray_tpu_torch.util import tracing as _tracing
    from ray_tpu_torch.util.state import build_timeline, raw_task_events

    w = global_worker()
    events = [] if w.mode == "local" else raw_task_events()
    spans = None
    if _tracing.tracing_enabled():
        # flow-arrow feed: per-process JSONL files when a trace dir is
        # configured, else the cluster-wide GCS trace table
        spans = _tracing.read_spans(name_prefix="task.submit")
        if not spans and w.mode != "local":
            from ray_tpu_torch.util.state import list_trace_spans

            spans = [sp for sp in list_trace_spans()
                     if str(sp.get("name", "")).startswith("task.submit")]
    trace = build_timeline(events, spans=spans)
    if filename:
        with open(filename, "w") as f:
            json.dump(trace, f)
    return trace


# Convenience namespaced access (lazy imports to keep `import ray_tpu_torch` light).
def __getattr__(name):
    if name in ("air", "autoscaler", "collective", "core", "dashboard",
                "data", "job_submission", "models", "native", "ops",
                "parallel", "rllib", "serve", "train", "tune", "util",
                "workflow"):
        import importlib

        return importlib.import_module(f"ray_tpu_torch.{name}")
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")
