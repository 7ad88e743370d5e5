"""Per-key circuit breaker (the port's copy of
odh_kubeflow_tpu/runtime/breaker.py); the router keeps one breaker per
replica, so a failing replica leaves rotation and earns its way back:

- CLOSED: requests flow; `failure_threshold` consecutive failures OPEN it.
- OPEN: `allow()` is False for a cooldown that doubles per consecutive trip
  (capped), so a dead replica costs one skipped pick per cooldown.
- HALF-OPEN: after the cooldown one trial is let through; success closes
  the breaker and resets the cooldown, failure re-opens it.

Thread-safe; time is injected for tests via the `clock` callable.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from ..utils import racecheck
from ..utils.metrics import global_registry

breaker_trips_total = global_registry.counter(
    "probe_breaker_trips_total",
    "Probe circuit-breaker open transitions (repeated probe failures)",
)


class _Entry:
    __slots__ = ("failures", "opened_at", "cooldown", "half_open_probe")

    def __init__(self) -> None:
        self.failures = 0
        self.opened_at: Optional[float] = None
        self.cooldown = 0.0
        self.half_open_probe = False


class CircuitBreaker:
    def __init__(
        self,
        failure_threshold: int = 3,
        cooldown_s: float = 30.0,
        max_cooldown_s: float = 300.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.max_cooldown_s = max_cooldown_s
        self.clock = clock
        self._lock = racecheck.make_lock("CircuitBreaker._lock")
        self._entries: Dict[str, _Entry] = {}
        self.trips = 0  # observability mirror of breaker_trips_total

    def allow(self, key: str) -> bool:
        """May a probe for `key` proceed right now? An OPEN breaker admits
        exactly one trial per elapsed cooldown (half-open)."""
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.opened_at is None:
                return True
            if self.clock() - e.opened_at < e.cooldown:
                return False
            if e.half_open_probe:
                return False  # a trial is already in flight
            e.half_open_probe = True
            return True

    def retry_after(self, key: str) -> float:
        """Seconds until the breaker would admit a trial (0 when closed) —
        the requeue delay for a skipped reconcile."""
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.opened_at is None:
                return 0.0
            return max(0.0, e.cooldown - (self.clock() - e.opened_at))

    def record_success(self, key: str) -> None:
        with self._lock:
            self._entries.pop(key, None)

    def record_failure(self, key: str) -> bool:
        """Returns True when this failure OPENED (or re-opened) the breaker."""
        with self._lock:
            e = self._entries.setdefault(key, _Entry())
            e.failures += 1
            if e.opened_at is not None:
                # half-open trial failed: re-open with a doubled cooldown
                e.opened_at = self.clock()
                e.cooldown = min(e.cooldown * 2, self.max_cooldown_s)
                e.half_open_probe = False
                return False
            if e.failures >= self.failure_threshold:
                e.opened_at = self.clock()
                e.cooldown = self.cooldown_s
                e.half_open_probe = False
                self.trips += 1
                breaker_trips_total.inc()
                return True
            return False

    def is_open(self, key: str) -> bool:
        with self._lock:
            e = self._entries.get(key)
            return bool(e and e.opened_at is not None)

    def forget(self, key: str) -> None:
        self.record_success(key)
