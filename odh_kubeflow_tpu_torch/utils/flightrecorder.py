"""A bounded ring of recent observations (the port's own counterpart of the
ring in odh_kubeflow_tpu/runtime/flightrecorder.py, without its incident
bundles): `record(kind, **fields)` appends {"t", "kind", **fields} under
one lock, and the oldest records fall off the end. The probe agent writes
its readiness edges here.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

CAPACITY = 4096


class FlightRecorder:
    def __init__(self):
        self._ring: Deque[Dict[str, Any]] = deque(maxlen=CAPACITY)
        self._lock = threading.Lock()

    def record(self, kind: str, **fields: Any) -> None:
        entry = {"t": time.time(), "kind": kind}
        entry.update(fields)
        with self._lock:
            self._ring.append(entry)

    def records(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._ring)
        if kind is not None:
            out = [r for r in out if r["kind"] == kind]
        return out


# the process-wide ring, as the reference keeps one
recorder = FlightRecorder()
