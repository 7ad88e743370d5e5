"""Flight recorder: an always-on bounded telemetry ring plus incident
bundles (the port's copy of odh_kubeflow_tpu/runtime/flightrecorder.py).

After a bad day the question is never "did something fail" — the counters
say so — it is "what exactly happened around this failure". The recorder
keeps a cheap process-wide ring of recent observations:

- completed trace spans (subscribed via utils.tracing.add_span_listener),
- structured log records (install `recorder.log_handler()` on a logger),
- per-reconcile samples from every controller worker (runtime/controller.py:
  controller, key, wall-clock, outcome, queue depth at completion),
- state-machine transitions and condition writes (slice repair, probe gate,
  culler — each calls `recorder.record(...)` at its transition points),
- the probe agent's readiness edges.

A slice entering Degraded or a terminal RepairFailed snapshots the ring plus
the affected CR/pod state into ONE JSON incident bundle. Bundles are capped
in count and deduplicated per (reason, subject) within a window, listed by
`incidents()` and fetched by `get()`. Under PROFILE=1 a bundle also carries
the profiler's hot-region timings.

A bundle also freezes the fleet chip-time ledger of the active accountant
(`runtime.accounting.current()`), once it has ticked, and under CPPROFILE=1
the control-plane profiler's snapshot (`cpprofile`). The manager's debug
mux serves the bundles at `/debug/incidents`.

Cost discipline: `record()` is a dict append into a deque under one lock
(zero-allocation fast path when disabled).
"""
from __future__ import annotations

import logging
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import time

from ..utils import racecheck
from .metrics import global_registry

log = logging.getLogger(__name__)

flight_recorder_records_total = global_registry.counter(
    "flight_recorder_records_total",
    "Observations appended to the flight-recorder ring, by kind",
    labels=("kind",),
)
flight_recorder_incidents_total = global_registry.counter(
    "flight_recorder_incidents_total",
    "Incident bundles snapshotted, by reason",
    labels=("reason",),
)


class _RingLogHandler(logging.Handler):
    def __init__(self, recorder: "FlightRecorder", level: int = logging.INFO):
        super().__init__(level=level)
        self._recorder = recorder

    def emit(self, record: logging.LogRecord) -> None:
        try:
            from ..utils.logging import record_fields

            self._recorder.record("log", **record_fields(record))
        except Exception:  # a broken sink must never break the logging caller
            pass


class FlightRecorder:
    def __init__(
        self,
        capacity: int = 4096,
        max_incidents: int = 32,
        snapshot_records: int = 512,
        dedup_window_s: float = 60.0,
        clock: Callable[[], float] = time.time,
    ):
        self.clock = clock
        self.snapshot_records = snapshot_records
        self.dedup_window_s = dedup_window_s
        self._ring: Deque[Dict[str, Any]] = deque(maxlen=capacity)
        self._incidents: Deque[Dict[str, Any]] = deque(maxlen=max_incidents)
        self._last_snapshot: Dict[Tuple[str, str], Tuple[float, str]] = {}
        self._lock = racecheck.make_lock("FlightRecorder._lock")
        self._enabled = True
        self._seq = 0

    # -- the ring --

    def set_enabled(self, on: bool) -> None:
        """Kill switch for overhead A/Bs."""
        self._enabled = on

    def enabled(self) -> bool:
        return self._enabled

    def record(self, kind: str, **fields: Any) -> None:
        if not self._enabled:
            return
        entry = {"t": self.clock(), "kind": kind}
        entry.update(fields)
        with self._lock:
            self._ring.append(entry)
        flight_recorder_records_total.inc(kind=kind)

    def records(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._ring)
        if kind is not None:
            out = [r for r in out if r["kind"] == kind]
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- incidents --

    def snapshot(
        self,
        reason: str,
        subject: str = "",
        client: Any = None,
        notebooks: Sequence[Tuple[str, str]] = (),
        extra: Optional[Dict[str, Any]] = None,
    ) -> Optional[str]:
        """Freeze the ring (+ the named notebooks' CR/pod state read through
        `client`) into one bundle; returns the bundle id. A repeat of the
        same (reason, subject) inside the dedup window returns the existing
        id instead of flooding the cap — one degradation episode is one
        bundle, however many reconcile passes re-observe it."""
        if not self._enabled:
            return None
        now = self.clock()
        key = (reason, subject)
        with self._lock:
            last = self._last_snapshot.get(key)
            if last is not None and now - last[0] < self.dedup_window_s:
                return last[1]
            # expired memo entries are dead weight: prune them here or a
            # months-long process accumulates one key per notebook that ever
            # degraded (the recorder is always-on by design)
            self._last_snapshot = {
                k: v
                for k, v in self._last_snapshot.items()
                if now - v[0] < self.dedup_window_s
            }
            self._seq += 1
            incident_id = f"inc-{self._seq:04d}"
            self._last_snapshot[key] = (now, incident_id)
            records = list(self._ring)[-self.snapshot_records :]
        state = self._capture_state(client, notebooks)
        bundle: Dict[str, Any] = {
            "id": incident_id,
            "reason": reason,
            "subject": subject,
            "at": now,
            "records": records,
            "state": state,
        }
        if extra:
            bundle["extra"] = dict(extra)
        # PROFILE=1: freeze the continuous profiler's hot-region timings into
        # the bundle — an incident during a decode-latency regression carries
        # its own where-the-time-went evidence. Armed check first so the
        # disarmed path stays import-only.
        try:
            from ..utils import profiler

            if profiler.enabled():
                prof = profiler.snapshot(limit=8)
                if prof["regions"] or prof["spans"]:
                    bundle["profile"] = prof
        except Exception:  # pragma: no cover - never costs the bundle
            pass
        # CPPROFILE=1: freeze the control-plane profiler — an incident
        # carries its own why-did-the-reconciles-fire evidence (cause mix,
        # scan accounting, takeover decomposition). Same never-costs-the-
        # bundle discipline as the profiler block above.
        try:
            from . import cpprofile

            if cpprofile.enabled():
                cp = cpprofile.snapshot(limit=5)
                if cp["controllers"] or cp["takeovers"]:
                    bundle["cpprofile"] = cp
        except Exception:  # pragma: no cover - never costs the bundle
            pass
        # freeze the fleet chip-time ledger — an incident carries its own
        # where-did-the-chips-go evidence (per-phase chip-seconds,
        # conservation arithmetic, top consumers). Same never-costs-the-
        # bundle discipline as the profiler block above.
        try:
            from . import accounting

            acct = accounting.current()
            if acct is not None:
                snap = acct.snapshot(limit=16)
                if snap["ticks"] > 0:
                    bundle["accounting"] = snap
        except Exception:  # pragma: no cover - never costs the bundle
            pass
        with self._lock:
            self._incidents.append(bundle)
        flight_recorder_incidents_total.inc(reason=reason)
        log.warning(
            "flight recorder: incident %s captured (%s%s, %d records)",
            incident_id, reason, f" on {subject}" if subject else "", len(records),
        )
        return incident_id

    @staticmethod
    def _capture_state(
        client: Any, notebooks: Sequence[Tuple[str, str]]
    ) -> Dict[str, Any]:
        """Best-effort CR + pod snapshots for the bundle; a failed read never
        fails the snapshot (the ring is the primary evidence)."""
        state: Dict[str, Any] = {}
        if client is None or not notebooks:
            return state
        from ..api.core import Pod
        from ..api.notebook import Notebook
        from ..controllers import constants as C

        for namespace, name in notebooks:
            key = f"{namespace}/{name}" if namespace else name
            entry: Dict[str, Any] = {}
            try:
                entry["notebook"] = client.get(Notebook, namespace, name).to_dict()
            except Exception as e:
                entry["notebook_error"] = repr(e)[:200]
            try:
                entry["pods"] = [
                    p.to_dict()
                    for p in client.list(
                        Pod,
                        namespace=namespace,
                        labels={C.NOTEBOOK_NAME_LABEL: name},
                    )
                ]
            except Exception as e:
                entry["pods_error"] = repr(e)[:200]
            state[key] = entry
        return state

    def incidents(self) -> List[Dict[str, Any]]:
        """Newest-last summaries (the /debug/incidents listing)."""
        with self._lock:
            return [
                {
                    "id": b["id"],
                    "reason": b["reason"],
                    "subject": b["subject"],
                    "at": b["at"],
                    "records": len(b["records"]),
                }
                for b in self._incidents
            ]

    def get(self, incident_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            for b in self._incidents:
                if b["id"] == incident_id:
                    return b
        return None

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._incidents.clear()
            self._last_snapshot.clear()

    # -- capture hooks --

    def log_handler(self, level: int = logging.WARNING) -> logging.Handler:
        """A logging.Handler that mirrors records into the ring."""
        return _RingLogHandler(self, level=level)


# process-wide instance: the ring is one artifact per process, like the trace
# buffer — the controllers and the probe agent all feed/snapshot this one
recorder = FlightRecorder()


def _on_span(span) -> None:
    recorder.record(
        "span",
        name=span.name,
        trace_id=span.trace_id,
        duration_ms=round(span.duration * 1e3, 3),
        attributes=dict(span.attributes),
    )


# self-wire the span feed once at import (idempotent per process): every
# exported span — reconcile phases, repair episodes, canary probes — is
# automatically part of any later incident bundle
def _install_span_capture() -> None:
    from ..utils import tracing

    if _on_span not in tracing._span_listeners:
        tracing.add_span_listener(_on_span)


_install_span_capture()
