"""Metric registry of the port: thread-safe counters, gauges and histograms
with labels, rendered in the Prometheus text exposition format (the port's
own copy of odh_kubeflow_tpu/runtime/metrics.py's registry; `render()`
gives the same text for the same families and observations).

Every family of the port registers in `global_registry` when its module
is imported: the serving and router families (`serving.metrics`), the
workload telemetry (`telemetry`), the profiler's `profile_*` families
(`utils.profiler`), the breaker, flow-control and trace-root families. A
family's `snapshot()` is what `ServingEngine.stats()["metrics"]` and
`telemetry.snapshot()` show. No HTTP route serves `render()`: the JAX
serving pod serves no `/metrics` either.

The control plane's families (workqueue, reconcile, informer, client
retries) register here too, from `runtime.metrics`; the notebook
controllers' `NotebookMetrics` adds a pull-style collector
(`add_collector`) that `render()` runs first.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Sequence, Tuple


def escape_label_value(value: str) -> str:
    """Text-exposition escaping for label values: backslash, double quote
    and newline, the escapes first."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def escape_help(text: str) -> str:
    """HELP lines escape backslash and newline (not quotes)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


class _Metric:
    type_name = ""

    def __init__(self, name: str, help: str, labels: Sequence[str] = ()):
        self.name, self.help, self.labels = name, help, tuple(labels)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], Any] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labels):
            raise ValueError(f"{self.name} takes labels {self.labels}, got {sorted(labels)}")
        return tuple(str(labels[name]) for name in self.labels)

    def labels_str(self, key: Tuple[str, ...]) -> str:
        if not self.labels:
            return ""
        return "{" + ",".join(
            f'{k}="{escape_label_value(v)}"' for k, v in zip(self.labels, key)
        ) + "}"

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def snapshot(self) -> Any:
        """A family without labels gives its one value; one with labels, a
        dict keyed by the comma-joined label values."""
        with self._lock:
            if not self.labels:
                return self._values.get((), 0.0)
            return {",".join(key): v for key, v in self._values.items()}

    def series(self) -> List[Tuple[Dict[str, str], Any]]:
        """Every (labels, value) pair of the family (the slice pool's gauge
        refresh reads which labels it has set)."""
        with self._lock:
            return [(dict(zip(self.labels, k)), v) for k, v in self._values.items()]

    def clear(self) -> None:
        """Drop every series, returning the family to its never-observed
        state (a cleared ratio gauge reads as no data, not as 0.0)."""
        with self._lock:
            self._values.clear()

    def sum_matching(self, labels: Dict[str, str]) -> float:
        """Sum of the series whose labels include every given (name, value)
        pair ({} sums the whole family): the SLO engine's good and total
        events, e.g. canary_probes_total{result="ok"} over the family."""
        positions = [(i, labels[name]) for i, name in enumerate(self.labels) if name in labels]
        with self._lock:
            return sum(v for k, v in self._values.items() if all(k[i] == want for i, want in positions))

    def render_lines(self) -> List[str]:
        with self._lock:
            lines = [f"{self.name} 0"] if not self._values and not self.labels else []
            lines += [f"{self.name}{self.labels_str(k)} {v}" for k, v in sorted(self._values.items())]
        return lines


class Counter(_Metric):
    type_name = "counter"

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Gauge(_Metric):
    type_name = "gauge"

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = value

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)


class _HistogramTimer:
    """`with histogram.time(**labels):` observes the elapsed monotonic time
    on exit."""

    def __init__(self, histogram: "Histogram", labels: Dict[str, str]):
        self._histogram, self._labels, self._t0 = histogram, labels, 0.0

    def __enter__(self) -> "_HistogramTimer":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._histogram.observe(time.monotonic() - self._t0, **self._labels)


class Histogram(_Metric):
    type_name = "histogram"

    def __init__(self, name: str, help: str, labels: Sequence[str] = (),
                 buckets: Sequence[float] = ()):
        super().__init__(name, help, labels)
        self.buckets = tuple(sorted(buckets))
        # per label key: cumulative count at each finite bucket, the sum and
        # the total (the +Inf bucket)
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        self._totals: Dict[Tuple[str, ...], int] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def clear(self) -> None:
        with self._lock:
            self._values.clear()
            self._counts.clear()
            self._sums.clear()
            self._totals.clear()

    def time(self, **labels: str) -> _HistogramTimer:
        return _HistogramTimer(self, labels)

    def cumulative_le(self, le: float) -> Tuple[float, float]:
        """(observations <= le, all observations) over every label set: the
        latency SLO's good and total events. `le` should sit on a bucket
        boundary; between two, the next bucket up answers."""
        idx = next((i for i, b in enumerate(self.buckets) if le <= b), None)
        with self._lock:
            good = sum(counts[idx] if idx is not None else self._totals.get(k, 0)
                       for k, counts in self._counts.items())
            total = sum(self._totals.get(k, 0) for k in self._counts)
        return float(good), float(total)

    def _snapshot_key(self, key: Tuple[str, ...]) -> dict:
        counts = self._counts.get(key, [0] * len(self.buckets))
        cumulative = {str(b): c for b, c in zip(self.buckets, counts)}
        cumulative["+Inf"] = self._totals.get(key, 0)
        return {"count": self._totals.get(key, 0), "sum": self._sums.get(key, 0.0),
                "buckets": cumulative}

    def snapshot(self) -> dict:
        """{"count", "sum", "buckets": {le: cumulative count}}; a family
        with labels gives one such dict per comma-joined label values."""
        with self._lock:
            if not self.labels:
                return self._snapshot_key(())
            return {",".join(key): self._snapshot_key(key) for key in self._totals}

    def render_lines(self) -> List[str]:
        lines = []
        with self._lock:
            for key, counts in self._counts.items():
                base = self.labels_str(key)

                def le_labels(le: str) -> str:
                    return "{" + base[1:-1] + f',le="{le}"' + "}" if base else f'{{le="{le}"}}'

                lines += [f"{self.name}_bucket{le_labels(str(b))} {c}"
                          for b, c in zip(self.buckets, counts)]
                lines.append(f'{self.name}_bucket{le_labels("+Inf")} {self._totals[key]}')
                lines.append(f"{self.name}_sum{base} {self._sums[key]}")
                lines.append(f"{self.name}_count{base} {self._totals[key]}")
        return lines


class Registry:
    """Families by name, rendered together in registration order."""

    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: List[Callable[[], None]] = []
        self._lock = threading.Lock()

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter(name, help, labels))

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge(name, help, labels))

    def histogram(self, name: str, help: str = "", labels: Sequence[str] = (),
                  buckets: Sequence[float] = ()) -> Histogram:
        return self._register(Histogram(name, help, labels, buckets))

    def _register(self, family: Any) -> Any:
        with self._lock:
            # idempotent: a second registration of a name returns the first
            return self._metrics.setdefault(family.name, family)

    def get(self, name: str) -> Any:
        with self._lock:
            return self._metrics.get(name)

    def add_collector(self, fn: Callable[[], None]) -> None:
        """fn runs before each render and may set gauges (pull-style)."""
        with self._lock:
            self._collectors.append(fn)

    def remove_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            fn()

    def render(self) -> str:
        with self._lock:
            families = list(self._metrics.values())
        self.run_collectors()
        lines: List[str] = []
        for m in families:
            lines.append(f"# HELP {m.name} {escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.type_name}")
            lines += m.render_lines()
        return "\n".join(lines) + "\n"


global_registry = Registry()
