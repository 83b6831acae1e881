"""TaskSpec — the unit of work shipped from submitter to executor.

Reference analogue: ``TaskSpecification`` (`src/ray/common/task/task_spec.h`).
Covers normal tasks, actor-creation tasks, and actor method calls.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.ids import ActorID, FunctionID, ObjectID, TaskID

_JOB_ID = config.job_id or "driver"


def _default_job_id() -> str:
    """Job attribution for task events: entrypoints launched by the job
    manager carry their submission id in RAY_TPU_JOB_ID (set by the job
    supervisor before the driver process starts, so read-once is safe);
    ad-hoc drivers fall back to one shared bucket."""
    return _JOB_ID

NORMAL_TASK = "normal"
ACTOR_CREATION_TASK = "actor_creation"
ACTOR_TASK = "actor_task"

# num_returns sentinel: the task is a generator streaming its yields as
# they are produced (reference: ``num_returns="streaming"`` /
# ObjectRefGenerator, `python/ray/_raylet.pyx:209,224`).
STREAMING_RETURNS = -1


@dataclass
class TaskSpec:
    task_id: TaskID
    kind: str = NORMAL_TASK
    name: str = ""
    # Either inline pickled function/class bytes, or a FunctionID referencing
    # the GCS function table (large callables are shipped once; reference:
    # `python/ray/_private/function_manager.py`).
    function_blob: Optional[bytes] = None
    function_id: Optional[FunctionID] = None
    # Args: list of ("v", pickled_bytes) inline values or ("ref", ObjectID).
    args: List[Tuple[str, Any]] = field(default_factory=list)
    kwargs: List[Tuple[str, Tuple[str, Any]]] = field(default_factory=list)
    num_returns: int = 1
    resources: Dict[str, float] = field(default_factory=dict)
    max_retries: int = 0
    retries_left: int = 0
    # Retry on application exceptions too (reference: retry_exceptions=False
    # by default — retries only cover system failures).
    retry_exceptions: bool = False
    # Actor fields
    actor_id: Optional[ActorID] = None
    method_name: Optional[str] = None
    max_restarts: int = 0
    max_concurrency: int = 1
    # Named concurrency groups (reference: concurrency_group_manager.cc):
    # creation task carries {"_default": n, "io": 2, ...} — the raylet
    # gates on the SUM; the worker enforces per-group limits with one
    # thread pool per group.  Actor tasks carry their target group.
    concurrency_groups: Optional[Dict[str, int]] = None
    concurrency_group: Optional[str] = None
    # method -> group map (creation task; lets get_actor handles stamp
    # tagged methods' calls with their group)
    method_groups: Optional[Dict[str, str]] = None
    # Eager availability (reference: secondary object copies, SURVEY §5):
    # True = every store-sized return of this task is pushed to a second
    # node when it seals, regardless of the RAY_TPU_REPLICATION_MIN_BYTES
    # auto-threshold (``_replicate=True`` task/actor-method option).
    replicate: bool = False
    # Checkpointable actors (creation task only): snapshot the actor's
    # __ray_save__() state into a replicated object every N completed
    # calls; 0 disables.
    checkpoint_interval: int = 0
    # Actor restart: restore the new instance from this checkpoint object
    # (set by the owning raylet when it resubmits the creation task).
    # Rides dependency_ids() so the ordinary dependency machinery pulls
    # the checkpoint local before dispatch, wherever the restart lands.
    restore_oid: Optional[ObjectID] = None
    # Runtime env (env_vars, working_dir) — per-task override
    runtime_env: Optional[dict] = None
    # Placement: pg id hex + bundle index, or node-affinity
    placement: Optional[dict] = None
    # ObjectIDs of refs serialized INSIDE inline arg values (not declared
    # top-level deps): pinned alongside deps until the task completes so
    # the executor can still resolve them however late it deserializes
    # (borrow pinning; reference: reference_count.h:233).
    inner_refs: Optional[List[ObjectID]] = None
    # Owner bookkeeping
    submitter: str = "driver"
    # Job attribution (GCS task-event table is bounded per job)
    job_id: str = field(default_factory=_default_job_id)
    # Tracing: submit-span context {trace_id, span_id} propagated to the
    # executing worker (reference: span context in task metadata,
    # `tracing_helper.py:289`)
    trace_ctx: Optional[dict] = None
    # End-to-end request deadline: ABSOLUTE wall-clock time.time() at
    # which this task (and everything it spawns — nested submits inherit
    # the tightest enclosing deadline) must be done.  Rides the frame
    # protocol, xtask forwarding and the direct transport like any other
    # spec field; enforced at raylet admission, pre-dispatch, worker
    # pre-exec and mid-exec (reference: Serve request_timeout_s +
    # task cancellation).  None = no deadline.
    deadline: Optional[float] = None
    # TaskID of the task whose execution submitted this one (None for
    # driver submissions): the raylet's cancel fan-out walks this edge so
    # cancel(recursive=True) / deadline expiry reaps downstream work.
    parent_task_id: Optional[TaskID] = None

    # Dynamic attributes (dataclass __dict__ pickles them with the spec):
    #   _direct_generation — actor restart generation stamped by the
    #       owning raylet onto creation specs (the hosted worker validates
    #       direct-call hellos against it) and onto direct-call reconciles.
    #   _direct_retry — this spec reconciles an in-flight DIRECT call
    #       after a channel teardown: the raylet skips it when its returns
    #       already resolved, and fences it (retryable ActorDiedError)
    #       when the actor's generation moved — never a double execution.
    # Scheduler-side transients (_acquired_pool, _batch, _spill_count,
    # _queued_t, _tr_in, _tr_prev) are set and consumed raylet-side.

    def return_ids(self) -> List[ObjectID]:
        if self.num_returns == STREAMING_RETURNS:
            # the completion marker object (stream items are indexed 1..n)
            return [ObjectID.for_task_return(self.task_id, 0)]
        return [
            ObjectID.for_task_return(self.task_id, i)
            for i in range(self.num_returns)
        ]

    def stream_item_id(self, index: int) -> ObjectID:
        """ObjectID of the index-th yielded item (0-based) of a streaming
        task; slot 0 is the completion marker."""
        return ObjectID.for_task_return(self.task_id, index + 1)

    def dependency_ids(self) -> List[ObjectID]:
        deps = [a[1] for a in self.args if a[0] == "ref"]
        deps += [v[1] for _, v in self.kwargs if v[0] == "ref"]
        if self.restore_oid is not None:
            deps.append(self.restore_oid)
        return deps
