"""API errors the port raises and catches (the port's own copy of the part
of odh_kubeflow_tpu/apimachinery/errors.py it needs): `TooManyRequestsError`,
the 429 that flow control sheds with and the router turns into `QueueFull`,
and `InvalidError`, the 422 of a `spec.tpu` that the GPU slice planner
(gpu/topology.py) cannot plan."""
from __future__ import annotations


class ApiError(Exception):
    code = 500
    reason = "InternalError"

    def __init__(self, message: str = "", *, kind: str = "", name: str = ""):
        self.kind = kind
        self.name = name
        if not message and kind:
            message = f'{self.reason}: {kind} "{name}"'
        super().__init__(message or self.reason)


class InvalidError(ApiError):
    code = 422
    reason = "Invalid"


class TooManyRequestsError(ApiError):
    """Priority-and-fairness or client-throttling rejection (HTTP 429). It
    carries the server's suggested Retry-After so clients can honor it."""

    code = 429
    reason = "TooManyRequests"

    def __init__(self, message: str = "", *, retry_after: float = 1.0, **kw):
        super().__init__(message, **kw)
        self.retry_after = retry_after
