"""Status-write coalescing: batch adjacent status PATCHes (the port's copy
of odh_kubeflow_tpu/runtime/coalesce.py).

The notebook/endpoint/job status mirrors react to every watch event; under a
sync wave one object can see several adjacent mirror patches milliseconds
apart, each costing an API write. The coalescer turns that into at most one
PATCH per object per window:

- the FIRST patch for an idle object writes through synchronously (leading
  edge — steady-state latency is unchanged; a single mirror write never
  waits),
- patches arriving within `window_s` of that write deep-merge into one
  pending patch, flushed by a background timer at the window's end.

Merging is a recursive dict merge where later values win — INCLUDING owned
zeros and explicit nulls (the omitempty contract: `hostsReady: 0` and
`containerState: None` survive coalescing byte-for-byte; nothing is treated
as "empty" and dropped).

Flush errors are absorbed: NotFound means the object is gone (nothing to
mirror), Forbidden means the write fence closed mid-flight (the ex-leader
must NOT retry — the new leader re-mirrors from its own watch), and anything
else is logged and dropped because mirrors are level-based — the next
reconcile regenerates the full status.
"""
from __future__ import annotations

import copy
import logging
import threading
import time
from typing import Any, Dict, Optional, Tuple, Type

from ..apimachinery import ForbiddenError, NotFoundError
from ..utils import racecheck

log = logging.getLogger(__name__)

Key = Tuple[type, str, str]


def merge_patches(base: Dict[str, Any], overlay: Dict[str, Any]) -> Dict[str, Any]:
    """Recursive merge, later values win. None is a VALUE (explicit-null
    delete in merge-patch semantics), never a tombstone to skip."""
    for k, v in overlay.items():
        if (
            isinstance(v, dict)
            and isinstance(base.get(k), dict)
        ):
            merge_patches(base[k], v)
        else:
            base[k] = copy.deepcopy(v)
    return base


class StatusCoalescer:
    """One per manager (`manager.status_coalescer`), sharing its fenced
    client; rides the manager lifecycle via add_service."""

    def __init__(self, client, window_s: float = 0.05):
        self.client = client
        self.window_s = window_s
        self._lock = racecheck.make_lock("StatusCoalescer._lock")
        self._pending: Dict[Key, Dict[str, Any]] = {}
        self._due: Dict[Key, float] = {}  # key -> monotonic flush deadline
        self._last_write: Dict[Key, float] = {}
        self._timer: Optional[threading.Timer] = None
        self._stopped = False
        # counters for the write-rate regression test
        self.writes = 0
        self.coalesced = 0

    # -- manager service contract --

    def start(self) -> None:
        with self._lock:
            self._stopped = False

    def stop(self) -> None:
        """Flush everything still pending, then stop scheduling."""
        with self._lock:
            self._stopped = True
            timer, self._timer = self._timer, None
        if timer is not None:
            timer.cancel()
        self.flush()

    # -- the patch path --

    def patch_status(
        self, cls: Type, namespace: str, name: str, patch: Dict[str, Any]
    ) -> None:
        """Coalescing analog of Client.patch_status. Returns None always:
        mirror callers are fire-and-forget (they re-read through the cache
        next reconcile, never from the patch response)."""
        if self.window_s <= 0:
            self._write(cls, namespace, name, patch)
            return
        key: Key = (cls, namespace, name)
        now = time.monotonic()
        with self._lock:
            if self._stopped:
                write_through = True
            elif key in self._pending:
                merge_patches(self._pending[key], patch)
                self.coalesced += 1
                return
            elif now - self._last_write.get(key, -1e9) >= self.window_s:
                # leading edge: idle object, write straight through
                self._last_write[key] = now
                write_through = True
            else:
                # within the window of the last write: park and batch
                self._pending[key] = copy.deepcopy(patch)
                self._due[key] = self._last_write.get(key, now) + self.window_s
                self._schedule_locked()
                write_through = False
        if write_through:
            self._write(cls, namespace, name, patch)

    def flush(self) -> None:
        """Write out every pending patch now (stop() and tests)."""
        with self._lock:
            pending = list(self._pending.items())
            self._pending.clear()
            self._due.clear()
            now = time.monotonic()
            for key, _ in pending:
                self._last_write[key] = now
        for (cls, ns, name), patch in pending:
            self._write(cls, ns, name, patch)

    # -- internals --

    def _write(self, cls: Type, namespace: str, name: str, patch: Dict[str, Any]) -> None:
        self.writes += 1
        try:
            self.client.patch_status(cls, namespace, name, patch)
        except NotFoundError:
            pass  # object deleted; nothing to mirror
        except ForbiddenError:
            # fence closed between park and flush: the ex-leader drops the
            # write (the new leader's own mirror regenerates it) — retrying
            # here would be exactly the duplicate the fence exists to stop
            log.debug("coalesced status write fenced for %s/%s", namespace, name)
        except Exception:
            log.warning(
                "coalesced status write failed for %s/%s (next sync wave "
                "re-mirrors)", namespace, name, exc_info=True,
            )

    def _schedule_locked(self) -> None:
        if self._timer is not None or self._stopped or not self._due:
            return
        delay = max(0.001, min(self._due.values()) - time.monotonic())
        self._timer = threading.Timer(delay, self._on_timer)
        self._timer.daemon = True
        self._timer.start()

    def _on_timer(self) -> None:
        now = time.monotonic()
        with self._lock:
            self._timer = None
            due = [k for k, t in self._due.items() if t <= now + 0.001]
            batch = []
            for key in due:
                patch = self._pending.pop(key, None)
                self._due.pop(key, None)
                if patch is not None:
                    self._last_write[key] = now
                    batch.append((key, patch))
            self._schedule_locked()
        for (cls, ns, name), patch in batch:
            self._write(cls, ns, name, patch)
