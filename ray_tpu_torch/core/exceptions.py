"""User-visible exception types (reference: `python/ray/exceptions.py`)."""

from __future__ import annotations


class RayTpuError(Exception):
    pass


class TaskError(RayTpuError):
    """A task raised an exception; re-raised on ``get`` with the remote
    traceback appended (reference ``RayTaskError``)."""

    def __init__(self, function_name: str, traceback_str: str,
                 cause: Exception | None = None):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(
            f"task {function_name} failed:\n{traceback_str}"
        )

    def __reduce__(self):
        # Exceptions with non-(args)-compatible __init__ need an explicit
        # reduce to survive the control-plane pickle round trip.
        return (TaskError, (self.function_name, self.traceback_str, None))


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class ActorDiedError(RayTpuError):
    """The actor is dead; pending and future method calls fail."""

    def __init__(self, actor_id_hex: str = "", reason: str = ""):
        self.actor_id_hex = actor_id_hex
        self.reason = reason
        super().__init__(f"actor {actor_id_hex} died: {reason}")

    def __reduce__(self):
        return (ActorDiedError, (self.actor_id_hex, self.reason))


class ObjectLostError(RayTpuError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class DeadlineExceededError(RayTpuError, TimeoutError):
    """The request's end-to-end deadline expired somewhere in the pipeline
    (admission, queue, pre-exec, or mid-exec) — the work was shed or
    interrupted, never silently continued (reference: Serve request
    timeouts + task cancellation semantics).  ``hop`` names where the
    deadline was enforced."""

    def __init__(self, message: str = "deadline exceeded", hop: str = ""):
        self._raw_message = message
        self.hop = hop
        super().__init__(message if not hop
                         else f"{message} (at {hop})")

    def __reduce__(self):
        # reconstruct from the RAW message + hop (the error is always
        # minted worker/raylet-side and pickled to the caller, so
        # dropping hop here would blank the documented dispatch surface)
        return (DeadlineExceededError, (self._raw_message, self.hop))


class TaskCancelledError(RayTpuError):
    """The task was cancelled (``ray_tpu_torch.cancel`` or deadline-driven
    cancel fan-out) before or while it ran (reference
    ``ray.exceptions.TaskCancelledError``)."""

    def __init__(self, message: str = "task was cancelled"):
        super().__init__(message)


class BackPressureError(RayTpuError):
    """The target refused to queue the request: a Serve replica at
    ``max_ongoing_requests``, or a raylet whose bounded ready queue is
    full.  Retryable by the caller — against another replica, or after
    ``Retry-After`` (reference: Serve backpressure / 503 shedding)."""

    def __init__(self, message: str = "request rejected (overloaded)"):
        super().__init__(message)


class OutOfMemoryError(RayTpuError):
    """The worker running the task was OOM-killed by the raylet's memory
    monitor (reference ``ray.exceptions.OutOfMemoryError``): the kill is
    counted against the task's retry budget and the final failure carries
    the crash-forensics log excerpt."""


class RuntimeEnvSetupError(RayTpuError):
    pass


class PendingCallsLimitExceeded(RayTpuError):
    pass
