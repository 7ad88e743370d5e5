"""Rate-limited deduplicating workqueue — client-go workqueue semantics,
which the reference's controllers get implicitly from controller-runtime:

- a key present in the queue is never handed to two workers at once,
- re-adds during processing mark the key dirty and requeue it after done(),
- per-key exponential backoff for failures (forget() resets),
- add_after for delayed requeues (RequeueAfter drives the culling cadence —
  reference culling_controller.go:202,519-523).
"""
from __future__ import annotations

import heapq
import threading
import time
from typing import Dict, Generic, Hashable, List, Optional, Set, Tuple, TypeVar

from . import cpprofile
from .metrics import (
    workqueue_adds_total,
    workqueue_depth,
    workqueue_queue_duration_seconds,
    workqueue_retries_total,
)

K = TypeVar("K", bound=Hashable)


class RateLimiter:
    """Per-item exponential backoff: base_delay * 2^failures, capped."""

    def __init__(self, base_delay: float = 0.005, max_delay: float = 60.0):
        self.base_delay = base_delay
        self.max_delay = max_delay
        self._failures: Dict[Hashable, int] = {}
        self._lock = threading.Lock()

    def when(self, item: Hashable) -> float:
        with self._lock:
            n = self._failures.get(item, 0)
            self._failures[item] = n + 1
        return min(self.base_delay * (2**n), self.max_delay)

    def forget(self, item: Hashable) -> None:
        with self._lock:
            self._failures.pop(item, None)

    def retries(self, item: Hashable) -> int:
        with self._lock:
            return self._failures.get(item, 0)


class WorkQueue(Generic[K]):
    def __init__(self, name: str = "") -> None:
        self.name = name
        self._cond = threading.Condition()
        self._queue: List[K] = []
        self._queued: Set[K] = set()
        self._processing: Set[K] = set()
        self._dirty: Set[K] = set()
        self._added_at: Dict[K, float] = {}  # key -> monotonic enqueue time
        self._delayed: List[Tuple[float, int, K]] = []  # heap of (when, seq, key)
        self._seq = 0
        self._shutdown = False
        self._delay_thread = threading.Thread(target=self._delay_loop, daemon=True)
        self._delay_thread.start()

    def _enqueue_locked(self, key: K) -> None:
        """Append under self._cond: the single site that grows the queue, so
        depth/adds/latency telemetry can never drift from the real queue."""
        self._queued.add(key)
        self._queue.append(key)
        self._added_at.setdefault(key, time.monotonic())
        workqueue_adds_total.inc(name=self.name)
        workqueue_depth.set(len(self._queue), name=self.name)

    def add(self, key: K) -> None:
        with self._cond:
            if self._shutdown:
                return
            if key in self._processing:
                self._dirty.add(key)
                return
            if key in self._queued:
                return
            self._enqueue_locked(key)
            self._cond.notify_all()

    def add_after(self, key: K, delay: float) -> None:
        if delay <= 0:
            self.add(key)
            return
        with self._cond:
            if self._shutdown:
                return
            self._seq += 1
            heapq.heappush(self._delayed, (time.monotonic() + delay, self._seq, key))
            workqueue_retries_total.inc(name=self.name)
            self._cond.notify_all()

    def _delay_loop(self) -> None:
        while True:
            with self._cond:
                if self._shutdown:
                    return
                now = time.monotonic()
                timeout = None
                while self._delayed and self._delayed[0][0] <= now:
                    _, _, key = heapq.heappop(self._delayed)
                    if key not in self._processing and key not in self._queued:
                        self._enqueue_locked(key)
                        self._cond.notify_all()
                    elif key in self._processing:
                        self._dirty.add(key)
                if self._delayed:
                    timeout = max(0.0, self._delayed[0][0] - now)
                self._cond.wait(timeout=timeout if timeout is not None else 0.5)

    def get(self, timeout: Optional[float] = None) -> Optional[K]:
        """Blocks until a key is available; None on shutdown/timeout."""
        deadline = time.monotonic() + timeout if timeout is not None else None
        with self._cond:
            while not self._queue:
                if self._shutdown:
                    return None
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                self._cond.wait(timeout=remaining if remaining is not None else 0.5)
            key = self._queue.pop(0)
            self._queued.discard(key)
            self._processing.add(key)
            added = self._added_at.pop(key, None)
            if added is not None:
                wait = time.monotonic() - added
                workqueue_queue_duration_seconds.observe(wait, name=self.name)
                # CPPROFILE=1 cause chain: the measured queue wait rides to
                # the reconcile that begins next on this key (one env check
                # inside when disarmed)
                cpprofile.note_dequeue(self.name, key, wait)
            workqueue_depth.set(len(self._queue), name=self.name)
            return key

    def done(self, key: K) -> None:
        with self._cond:
            self._processing.discard(key)
            if key in self._dirty:
                self._dirty.discard(key)
                if key not in self._queued:
                    self._enqueue_locked(key)
                    self._cond.notify_all()

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return len(self._queue)
