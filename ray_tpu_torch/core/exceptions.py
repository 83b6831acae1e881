"""User-visible exception types: the subset of ``ray_tpu/core/exceptions.py``
that the ported modules raise."""

from __future__ import annotations


class RayTpuError(Exception):
    pass


class BackPressureError(RayTpuError):
    """The target refused to queue the request: a Serve replica at
    ``max_ongoing_requests``.  Retryable by the caller — against another
    replica, or after ``Retry-After`` (reference: Serve backpressure / 503
    shedding)."""

    def __init__(self, message: str = "request rejected (overloaded)"):
        super().__init__(message)
