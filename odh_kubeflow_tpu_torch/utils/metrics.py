"""Metric families of the port: small thread-safe counters, gauges and
histograms in process memory (the port's own copy; the JAX package keeps
them in runtime/metrics.py's global registry).

The serving families (`serving.metrics`) and the workload telemetry
(`telemetry`) are built from these classes. A family's `snapshot()` is what
`ServingEngine.stats()["metrics"]` and `telemetry.snapshot()` show.
Prometheus exposition of these families is not ported yet.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Sequence, Tuple, Union


class _Labeled:
    """Values keyed by label values, in the order the family names them."""

    def __init__(self, name: str, help: str, labels: Sequence[str] = ()):
        self.name, self.help, self.labels = name, help, tuple(labels)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labels):
            raise ValueError(f"{self.name} takes labels {self.labels}, got {sorted(labels)}")
        return tuple(str(labels[name]) for name in self.labels)

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def snapshot(self) -> Union[float, Dict[str, float]]:
        """A family without labels gives its one value; one with labels, a
        dict keyed by the comma-joined label values."""
        with self._lock:
            if not self.labels:
                return self._values.get((), 0.0)
            return {",".join(key): v for key, v in self._values.items()}


class Counter(_Labeled):
    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Gauge(_Labeled):
    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)


class Histogram:
    def __init__(self, name: str, help: str, buckets: Sequence[float]):
        self.name, self.help = name, help
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # last: +Inf
        self._sum = 0.0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value

    def snapshot(self) -> dict:
        with self._lock:
            counts, total = list(self._counts), self._sum
        cumulative, running = {}, 0
        for le, n in zip([*map(str, self.buckets), "+Inf"], counts):
            running += n
            cumulative[le] = running
        return {"count": running, "sum": total, "buckets": cumulative}
