"""Structured API errors, mirroring k8s.io/apimachinery/pkg/api/errors semantics
the reference relies on (IsNotFound / IsAlreadyExists / IsConflict branches in
every reconciler)."""
from __future__ import annotations

from typing import Optional


class ApiError(Exception):
    code = 500
    reason = "InternalError"

    def __init__(self, message: str = "", *, kind: str = "", name: str = ""):
        self.kind = kind
        self.name = name
        if not message and kind:
            message = f'{self.reason}: {kind} "{name}"'
        super().__init__(message or self.reason)


class NotFoundError(ApiError):
    code = 404
    reason = "NotFound"


class AlreadyExistsError(ApiError):
    code = 409
    reason = "AlreadyExists"


class ConflictError(ApiError):
    """resourceVersion mismatch on update — optimistic-concurrency failure."""

    code = 409
    reason = "Conflict"


class InvalidError(ApiError):
    code = 422
    reason = "Invalid"


class ForbiddenError(ApiError):
    code = 403
    reason = "Forbidden"


class GoneError(ApiError):
    """Watch resume window expired (HTTP 410): the requested resourceVersion
    is older than the server's retained event history. Clients must re-list
    and re-watch — the standard informer relist path."""

    code = 410
    reason = "Expired"


class UnauthorizedError(ApiError):
    code = 401
    reason = "Unauthorized"


class TooManyRequestsError(ApiError):
    """API priority-and-fairness / client throttling rejection (HTTP 429).
    Carries the server's suggested Retry-After so clients can honor it
    (kube-apiserver puts it in Status.details.retryAfterSeconds)."""

    code = 429
    reason = "TooManyRequests"

    def __init__(self, message: str = "", *, retry_after: float = 1.0, **kw):
        super().__init__(message, **kw)
        self.retry_after = retry_after


class AdmissionDeniedError(ApiError):
    """A mutating/validating webhook rejected the request (failurePolicy: Fail)."""

    code = 400
    reason = "AdmissionDenied"


def is_not_found(err: Optional[BaseException]) -> bool:
    return isinstance(err, NotFoundError)


def is_conflict(err: Optional[BaseException]) -> bool:
    return isinstance(err, ConflictError)


def is_already_exists(err: Optional[BaseException]) -> bool:
    return isinstance(err, AlreadyExistsError)


def ignore_not_found(err: Optional[BaseException]) -> None:
    """client.IgnoreNotFound analog: re-raise anything but NotFound."""
    if err is None or is_not_found(err):
        return None
    raise err
