"""Controller: reconcile dispatch with per-key single-flight, error backoff,
and RequeueAfter — the controller-runtime contract the reference's reconcilers
are written against (SURVEY §3.2/§3.3)."""
from __future__ import annotations

import logging
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Callable, List, Optional

from ..utils.logging import log_context
from . import cpprofile
from .flightrecorder import recorder
from .metrics import (
    reconcile_duration_seconds,
    reconcile_errors_total,
    reconcile_total,
)
from .workqueue import RateLimiter, WorkQueue

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class Request:
    namespace: str
    name: str

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}" if self.namespace else self.name


@dataclass
class Result:
    requeue: bool = False
    requeue_after: float = 0.0


Reconciler = Callable[[Request], Optional[Result]]


class Controller:
    def __init__(
        self,
        name: str,
        reconciler: Reconciler,
        workers: int = 1,
        max_retries: Optional[int] = None,
    ):
        self.name = name
        self.reconciler = reconciler
        self.workers = workers
        self.max_retries = max_retries
        self.queue: WorkQueue[Request] = WorkQueue(name=name)
        self.rate_limiter = RateLimiter()
        self._threads: List[threading.Thread] = []
        self._stopped = threading.Event()
        # counters for observability/tests
        self.reconcile_count = 0
        self.error_count = 0

    def enqueue(self, namespace: str, name: str) -> None:
        self.queue.add(Request(namespace=namespace, name=name))

    def enqueue_after(self, namespace: str, name: str, delay: float) -> None:
        self.queue.add_after(Request(namespace=namespace, name=name), delay)

    def start(self) -> None:
        for i in range(self.workers):
            t = threading.Thread(
                target=self._worker, name=f"{self.name}-worker-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stopped.set()
        self.queue.shutdown()

    def _worker(self) -> None:
        # lazy import: cluster/__init__ imports back into runtime, so the
        # flowcontrol thread-local must be resolved at worker start, not at
        # module import
        from ..cluster.flowcontrol import flow_context

        while not self._stopped.is_set():
            req = self.queue.get()
            if req is None:
                return
            # CPPROFILE=1 (runtime/cpprofile.py): consume the cause stamped
            # at informer fan-out + the measured queue wait, and open the
            # per-reconcile scan-accounting context on this worker thread.
            # None disarmed (one env check).
            cp = cpprofile.reconcile_begin(self.name, req.key, ctrl_id=id(self))
            t0 = time.perf_counter()
            outcome = "error"
            try:
                # log_context threads controller + object identity into every
                # structured log record emitted below this frame
                # flow_context stamps this worker's API traffic with the
                # controller's identity for priority & fairness
                # classification (sim client + wire header both read it)
                with log_context(
                    controller=self.name, namespace=req.namespace, name=req.name
                ), flow_context(self.name), reconcile_duration_seconds.time(
                    controller=self.name
                ):
                    result = self.reconciler(req)
                self.reconcile_count += 1
                self.rate_limiter.forget(req)
                outcome = "success"
                if result is not None:
                    if result.requeue_after > 0:
                        outcome = "requeue_after"
                        self.queue.add_after(req, result.requeue_after)
                    elif result.requeue:
                        outcome = "requeue"
                        self.queue.add_after(req, self.rate_limiter.when(req))
                reconcile_total.inc(controller=self.name, result=outcome)
            except Exception:
                self.error_count += 1
                reconcile_total.inc(controller=self.name, result="error")
                reconcile_errors_total.inc(controller=self.name)
                log.error(
                    "reconciler %s failed for %s:\n%s",
                    self.name,
                    req.key,
                    traceback.format_exc(),
                )
                if (
                    self.max_retries is None
                    or self.rate_limiter.retries(req) < self.max_retries
                ):
                    self.queue.add_after(req, self.rate_limiter.when(req))
            finally:
                # flight-recorder sample: one line per reconcile (controller,
                # key, wall-clock, outcome, queue depth) — the incident
                # bundle's answer to "what was the control plane doing".
                # CPPROFILE=1 adds the cause-chain fields (cause_kind,
                # cause_verb, queue_wait_ms) so a bundle answers "what storm
                # caused this" without a separate capture.
                extra = cpprofile.reconcile_end(cp, outcome=outcome) if cp else {}
                recorder.record(
                    "reconcile",
                    controller=self.name,
                    key=req.key,
                    ms=round((time.perf_counter() - t0) * 1e3, 3),
                    outcome=outcome,
                    depth=len(self.queue),
                    **extra,
                )
                self.queue.done(req)

    def wait_idle(self, timeout: float = 10.0, settle: float = 0.05) -> bool:
        """Test helper: wait until the queue is empty and stays empty briefly."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if len(self.queue) == 0 and not self.queue._processing:
                time.sleep(settle)
                if len(self.queue) == 0 and not self.queue._processing:
                    return True
            time.sleep(0.01)
        return False
