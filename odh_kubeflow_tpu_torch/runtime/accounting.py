"""Goodput ledgers (the port's copy of the `GoodputLedger` of
odh_kubeflow_tpu/runtime/accounting.py, with its two process-wide views).

A ledger is a good/total seconds accumulator behind a 0..1 ratio gauge:
slice goodput is (lifetime - downtime) / lifetime, fed by the slice-repair
controller through `telemetry.GoodputAccounting`; job goodput is
productive / wall seconds, fed by the job controller once it is ported. The
gauge is bound by the module that registered it; the accumulators live
here so a harness gets one `reset_for_test()`.

The rest of the reference module — the fleet chip-time accountant, its
phases and conservation check, and the `tpu_chip_seconds_*` families —
comes with the chip accountant's port.
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..utils import racecheck
from .metrics import Gauge


class GoodputLedger:
    """good/total second accumulators behind a 0..1 ratio gauge, fed
    incrementally from concurrent reconcile workers."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = racecheck.make_lock(f"GoodputLedger.{name}")
        self._good_s = 0.0
        self._total_s = 0.0
        self._gauge: Optional[Gauge] = None

    def bind_gauge(self, gauge: Gauge) -> None:
        self._gauge = gauge

    def record(self, good_s: float, total_s: float) -> None:
        with self._lock:
            self._good_s += max(0.0, good_s)
            self._total_s += max(0.0, total_s)
            ratio = (
                min(1.0, max(0.0, self._good_s / self._total_s))
                if self._total_s > 0
                else None
            )
        if ratio is not None and self._gauge is not None:
            self._gauge.set(ratio)

    def totals(self) -> Tuple[float, float]:
        with self._lock:
            return self._good_s, self._total_s

    def ratio(self) -> Optional[float]:
        good, total = self.totals()
        return min(1.0, good / total) if total > 0 else None

    def reset_for_test(self) -> None:
        """Zero the accumulators AND the bound gauge's series, so a fresh
        run starts from the never-set state (a series-less gauge reads as
        no data, not as 0% goodput)."""
        with self._lock:
            self._good_s = 0.0
            self._total_s = 0.0
        if self._gauge is not None:
            self._gauge.clear()


# process-wide views: telemetry.GoodputAccounting.observe delegates to the
# slice ledger; the job ledger waits for the job controller
job_goodput = GoodputLedger("job")
slice_goodput = GoodputLedger("slice")
