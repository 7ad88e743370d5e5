"""Serving metric families the engine feeds (counterpart of
odh_kubeflow_tpu/serving/metrics.py, own copy).

Small thread-safe counters, gauges and histograms in process memory,
surfaced through `ServingEngine.stats()["metrics"]`. Prometheus exposition
of these families is not ported yet.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Sequence, Tuple


class Counter:
    def __init__(self, name: str, help: str, labels: Sequence[str] = ()):
        self.name, self.help, self.labels = name, help, tuple(labels)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labels):
            raise ValueError(f"{self.name} takes labels {self.labels}, got {sorted(labels)}")
        return tuple(str(labels[name]) for name in self.labels)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {",".join(key) or "": v for key, v in self._values.items()}


class Gauge:
    def __init__(self, name: str, help: str):
        self.name, self.help = name, help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> float:
        return self.value()


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


# TTFT: submit -> first generated token (queue wait + prefill)
inference_ttft_seconds = Histogram(
    "inference_ttft_seconds",
    "Time to first token per request: submit -> first generated token",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0),
)
inference_token_latency_seconds = Histogram(
    "inference_token_latency_seconds",
    "Per-token decode latency (inter-token gap) per active sequence",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0, 2.5),
)
inference_goodput_tokens_per_s = Gauge(
    "inference_goodput_tokens_per_s",
    "Cumulative generated tokens per second of engine wall time",
)
inference_queue_depth = Gauge(
    "inference_queue_depth",
    "Requests waiting in the bounded admission queue",
)
inference_slot_occupancy_ratio = Gauge(
    "inference_slot_occupancy_ratio",
    "Active KV-cache slots / total slots",
)
inference_requests_total = Counter(
    "inference_requests_total",
    "Serving requests by terminal result: ok, rejected (admission-queue "
    "backpressure), canceled",
    labels=("result",),
)

FAMILIES = (
    inference_ttft_seconds,
    inference_token_latency_seconds,
    inference_goodput_tokens_per_s,
    inference_queue_depth,
    inference_slot_occupancy_ratio,
    inference_requests_total,
)


def snapshot() -> dict:
    """Every family's current value, by name."""
    return {family.name: family.snapshot() for family in FAMILIES}
