"""Typed client over the Store — the controller-runtime client.Client analog.

Controllers speak typed objects; this layer handles scheme round-trips and
provides retry_on_conflict (the retry.RetryOnConflict pattern the reference
uses at every multi-writer annotation/finalizer site, e.g.
culling_controller.go:171, odh notebook_controller.go:269)."""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Type, TypeVar

from ..apimachinery import (
    ConflictError,
    ForbiddenError,
    KubeObject,
    Scheme,
    TooManyRequestsError,
    default_scheme,
)
from ..utils import deployguard
from .store import Store

T = TypeVar("T", bound=KubeObject)


# CPPROFILE takeover hook (runtime/cpprofile.py), resolved lazily and
# cached: cluster modules must not import the runtime package at load time
# (runtime.manager imports cluster.client while runtime/__init__ is mid-init).
# A successful write reports the writing client so a taking-over
# manager's first-owned-write phase can close; off, one list check.
_cpprofile_mod = None


def _cpprofile():
    global _cpprofile_mod
    if _cpprofile_mod is None:
        from ..runtime import cpprofile

        _cpprofile_mod = cpprofile
    return _cpprofile_mod


class Client:
    # 429 handling: honor the server's Retry-After for a bounded number of
    # attempts, then surface the error (the controller's workqueue backoff
    # takes over). Sleeps are capped so a hostile/buggy Retry-After cannot
    # park a reconcile worker for minutes.
    MAX_THROTTLE_RETRIES = 4
    MAX_RETRY_AFTER_S = 2.0

    # leader-election fencing (runtime/manager.py): when set, every WRITE
    # consults it first — a partitioned ex-leader whose lease lapsed must
    # stop mutating the cluster even while its reconciles are mid-flight
    # (controller-runtime gets this by killing the process; here the gate
    # closes the window between lease loss and controller shutdown)
    write_fence: Optional[Callable[[], bool]] = None

    # flow identity (cluster/flowcontrol.py): an explicit per-client override
    # of the thread-local flow (the elector's client sets "leader-election"
    # so lease traffic always lands on the exempt priority level). Empty =
    # inherit whatever flow_context() the calling thread carries.
    flow: str = ""

    def __init__(self, store: Store, scheme: Scheme = default_scheme):
        self.store = store
        self.scheme = scheme

    def _flow(self) -> str:
        if self.flow:
            return self.flow
        from .flowcontrol import current_flow

        return current_flow()

    def _check_fence(self) -> None:
        fence = self.write_fence
        if fence is not None and not fence():
            from ..runtime.metrics import fenced_writes_total

            fenced_writes_total.inc()
            raise ForbiddenError("write fenced: leader lease not held")

    def _call(
        self,
        fn: Callable[[], T],
        write: bool = False,
        kind: str = "",
        method: str = "",
    ) -> T:
        """Run a store op, honoring 429 Retry-After with bounded retries."""
        # DEPLOYGUARD (utils/deployguard.py): when armed, every call reports
        # its (flow, method, kind) BEFORE dispatch — a request exceeding the
        # declared RBAC for a manager flow raises RBACDriftError right here,
        # at the offending call. Off: one attribute check, nothing else.
        guard = deployguard.ACTIVE
        if guard is not None and method:
            guard.observe(self._flow(), method, kind)
        # API priority & fairness, sim mode: a Store carrying a FlowController
        # (cluster/flowcontrol.py) admits every typed-client op at the
        # caller's priority level before it reaches the store — the
        # in-process analog of the ApiServer's admission point. A shed raises
        # TooManyRequestsError, which rides the bounded retry loop below
        # exactly like a server-side 429.
        flowcontrol = getattr(self.store, "flowcontrol", None)
        if flowcontrol is not None and not getattr(
            self.store, "handles_throttle_retries", False
        ):
            inner = fn

            def fn() -> T:  # type: ignore[misc]
                with flowcontrol.admit(
                    self._flow(), verb="write" if write else "read", kind=kind
                ):
                    return inner()

        if getattr(self.store, "handles_throttle_retries", False):
            # the transport already retries 429s (RemoteStore._request);
            # stacking this loop on top would multiply the attempts and the
            # cumulative Retry-After sleeps — one bounded layer only.
            # Known limit: the transport's internal retries are not
            # fence-gated (the store is shared with the elector's own
            # client, whose Lease writes must stay unfenced), so a remote
            # fenced write has a lease-lapse window of one request's
            # bounded retries; lease loss also stops the controllers,
            # which bounds what can enter that window.
            out = fn()
            if write:
                _cpprofile().note_write(self)
            return out
        for attempt in range(self.MAX_THROTTLE_RETRIES + 1):
            if write and attempt:
                # the Retry-After sleeps can span a lease lapse: a fenced
                # writer must not commit on a LATER attempt after standing
                # down — re-check per attempt, not just at entry
                self._check_fence()
            try:
                out = fn()
                if write:
                    _cpprofile().note_write(self)
                return out
            except TooManyRequestsError as e:
                if attempt == self.MAX_THROTTLE_RETRIES:
                    raise
                from ..runtime.metrics import client_retries_total

                client_retries_total.inc(cause="throttle")
                time.sleep(
                    min(max(e.retry_after, 0.0), self.MAX_RETRY_AFTER_S)
                )
        raise AssertionError("unreachable")  # pragma: no cover

    # -- helpers --
    def _av_kind(self, cls: Type[KubeObject]) -> tuple:
        gvk = self.scheme.gvk_for(cls)
        return gvk.api_version, gvk.kind

    def _prepare(self, obj: KubeObject) -> dict:
        self.scheme.fill_type_meta(obj)
        return obj.to_dict()

    def _decode(self, cls: Type[T], data: dict) -> T:
        return cls.from_dict(data)  # type: ignore[return-value]

    # -- CRUD --
    def create(self, obj: T) -> T:
        self._check_fence()
        payload = self._prepare(obj)
        out = self._call(
            lambda: self.store.create_raw(payload),
            write=True,
            kind=payload.get("kind", ""),
            method="create",
        )
        return self._decode(type(obj), out)

    def get(self, cls: Type[T], namespace: str, name: str) -> T:
        av, kind = self._av_kind(cls)
        return self._decode(
            cls,
            self._call(
                lambda: self.store.get_raw(av, kind, namespace, name),
                kind=kind,
                method="get",
            ),
        )

    def list(
        self,
        cls: Type[T],
        namespace: Optional[str] = None,
        labels: Optional[Dict[str, str]] = None,
    ) -> List[T]:
        av, kind = self._av_kind(cls)
        return [
            self._decode(cls, d)
            for d in self._call(
                lambda: self.store.list_raw(
                    av, kind, namespace=namespace, label_selector=labels
                ),
                kind=kind,
                method="list",
            )
        ]

    def update(self, obj: T) -> T:
        self._check_fence()
        payload = self._prepare(obj)
        out = self._call(
            lambda: self.store.update_raw(payload),
            write=True,
            kind=payload.get("kind", ""),
            method="update",
        )
        return self._decode(type(obj), out)

    def update_status(self, obj: T) -> T:
        self._check_fence()
        payload = self._prepare(obj)
        out = self._call(
            lambda: self.store.update_raw(payload, subresource="status"),
            write=True,
            kind=payload.get("kind", ""),
            method="update_status",
        )
        return self._decode(type(obj), out)

    def patch(self, cls: Type[T], namespace: str, name: str, patch: dict) -> T:
        self._check_fence()
        av, kind = self._av_kind(cls)
        return self._decode(
            cls,
            self._call(
                lambda: self.store.patch_raw(av, kind, namespace, name, patch),
                write=True,
                kind=kind,
                method="patch",
            ),
        )

    def patch_status(self, cls: Type[T], namespace: str, name: str, patch: dict) -> T:
        """Merge-patch the status subresource. The conflict-free write for
        status controllers with DISJOINT field ownership: one request, no
        read-modify-write loop, no optimistic-concurrency retries (the
        server merges against current state under its own lock)."""
        self._check_fence()
        av, kind = self._av_kind(cls)
        return self._decode(
            cls,
            self._call(
                lambda: self.store.patch_raw(
                    av, kind, namespace, name, {"status": patch}, subresource="status"
                ),
                write=True,
                kind=kind,
                method="patch_status",
            ),
        )

    def delete(self, cls: Type[KubeObject], namespace: str, name: str) -> None:
        self._check_fence()
        av, kind = self._av_kind(cls)
        self._call(
            lambda: self.store.delete_raw(av, kind, namespace, name),
            write=True,
            kind=kind,
            method="delete",
        )


def retry_on_conflict(
    fn: Callable[[], T],
    steps: int = 5,
    base_delay: float = 0.01,
    factor: float = 2.0,
) -> T:
    """Run fn until it stops raising ConflictError (fn must re-GET each try)."""
    delay = base_delay
    for i in range(steps):
        try:
            return fn()
        except ConflictError:
            if i == steps - 1:
                raise
            time.sleep(delay)
            delay *= factor
    raise AssertionError("unreachable")
