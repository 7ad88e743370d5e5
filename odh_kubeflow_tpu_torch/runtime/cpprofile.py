"""CPPROFILE=1 — opt-in control-plane continuous profiler (the port's copy
of odh_kubeflow_tpu/runtime/cpprofile.py), a sibling of RACECHECK, INVCHECK,
TORCHGUARD and PROFILE.

PROFILE=1 answers "where did the data-plane time go"; the workqueue/reconcile
metrics answer "how long did reconciles take". This module answers the two
questions neither can: *why did each reconcile fire* and *what did it scan* —
plus a per-phase decomposition of standby leader takeover.

Three legs, one accounting model:

- **cause chain**: the originating watch event (kind, verb, source object,
  resourceVersion) is stamped at informer fan-out (runtime/builder.py, right
  where a handler decides to enqueue), carried across the workqueue keyed by
  (controller, request-key), and consumed at dequeue — so every reconcile
  reports (cause_kind, cause_verb, origin watch-vs-requeue, queue_wait,
  work_time). WorkQueue dedup semantics are preserved by `setdefault`: the
  FIRST stamp for a queued key wins (later adds of the same key are dropped
  by the queue too), and a stamp landing while the key is being processed
  becomes the cause of the dirty requeue the queue makes at done().
  Self-requeues (RequeueAfter / error backoff) carry no stamp and report as
  origin="requeue".
- **scan accounting**: the cache/list read paths (Informer.list for cached
  reads, Store.list_raw for direct reads) report objects-scanned vs
  objects-used per call. Attribution: the reconcile in flight on this thread
  (set by Controller._worker) wins; otherwise an explicit `sweep(name)`
  scope (the chip accountant's tick thread); otherwise the flowcontrol
  thread-local flow; otherwise "unattributed". scanned==cache/bucket size,
  used==matches returned — the flat-cache cost item 5 wants to kill.
- **takeover decomposition**: Manager.start() is instrumented into five
  SEQUENTIAL phases — lease-acquire (last failed leadership poll → lease
  held; the waiting clock re-stamps each failed poll so a standby's healthy
  months of waiting don't count), relist (lease → every informer synced),
  cache-warm (synced → controllers/runnables/services running), first-sweep
  (start returns → first reconcile COMPLETES on one of this manager's
  controllers), first-owned-write (→ first successful write through this
  manager's fenced client). Phase boundaries are computed with a running
  max, so an out-of-order mark (a write landing mid-first-sweep) zeroes its
  phase instead of going negative and the phases always PARTITION the
  total. Completed takeovers emit a `manager.takeover` trace root with one
  child span per phase and observe cp_takeover_phase_seconds{phase}.

Everything registers its Prometheus families at import (profiler.py idiom).
Zero-cost off: every public hook checks `enabled()` (one env check) before
touching any state.
"""
from __future__ import annotations

import collections
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Set

from .metrics import global_registry


def enabled() -> bool:
    return os.environ.get("CPPROFILE", "") not in ("", "0", "false")


# ---------------------------------------------------------------------------
# Prometheus families (registered at import). Sub-ms buckets: a
# sim-mode reconcile lands in tens of microseconds (the satellite-2 bucket
# audit found the seconds-scale queue buckets saturating their lowest bin).
# ---------------------------------------------------------------------------

CP_WAIT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0)
CP_TAKEOVER_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5,
                       1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

cp_reconcile_cause_total = global_registry.counter(
    "cp_reconcile_cause_total",
    "Reconciles by originating watch event (CPPROFILE=1): which kind+verb "
    "woke this controller; self-requeues report kind=self, verb=requeue",
    labels=("controller", "kind", "verb"),
)
cp_cache_scan_objects_total = global_registry.counter(
    "cp_cache_scan_objects_total",
    "Objects scanned by cache/store list paths (CPPROFILE=1), attributed "
    "to the reconciling controller or named sweep — the flat-cache cost",
    labels=("controller",),
)
cp_queue_wait_seconds = global_registry.histogram(
    "cp_queue_wait_seconds",
    "Enqueue-to-dequeue wait per reconcile (CPPROFILE=1), by controller",
    labels=("controller",),
    buckets=CP_WAIT_BUCKETS,
)
cp_reconcile_work_seconds = global_registry.histogram(
    "cp_reconcile_work_seconds",
    "Reconciler work time per reconcile (CPPROFILE=1), by controller — "
    "queue wait excluded, the cause chain's work_time leg",
    labels=("controller",),
    buckets=CP_WAIT_BUCKETS,
)
cp_takeover_phase_seconds = global_registry.histogram(
    "cp_takeover_phase_seconds",
    "Manager takeover decomposition (CPPROFILE=1): per-phase wall clock "
    "(lease-acquire, relist, cache-warm, first-sweep, first-owned-write)",
    labels=("phase",),
    buckets=CP_TAKEOVER_BUCKETS,
)


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

_MAX_SAMPLES = 64       # per-controller ring of recent reconcile samples
_MAX_PENDING = 4096     # stamped-but-never-dequeued causes (shutdown leak cap)

_mu = threading.Lock()
_tls = threading.local()
_controllers: Dict[str, Dict[str, Any]] = {}
_sweeps: Dict[str, Dict[str, int]] = {}
_pending: Dict[tuple, Dict[str, Any]] = {}       # (controller, key) -> cause
_pending_wait: Dict[tuple, float] = {}           # (queue name, key) -> wait_s
_takeovers: "collections.deque" = collections.deque(maxlen=16)
_active_takeovers: List["_Takeover"] = []

_clock = time.perf_counter


def _controller_stats(name: str) -> Dict[str, Any]:
    stats = _controllers.get(name)
    if stats is None:
        stats = _controllers[name] = {
            "reconciles": 0,
            "causes": {},                      # "Kind/VERB" -> count
            "origins": {"watch": 0, "requeue": 0},
            "queue_wait_s": 0.0,
            "work_s": 0.0,
            "scan_calls": 0,
            "scanned": 0,
            "used": 0,
            "samples": collections.deque(maxlen=_MAX_SAMPLES),
        }
    return stats


# ---------------------------------------------------------------------------
# cause chain: stamp (builder) -> wait (workqueue) -> consume (controller)
# ---------------------------------------------------------------------------


def stamp_cause(controller: str, key: str, kind: str, verb: str,
                obj: Optional[dict] = None) -> None:
    """Record the watch event that is about to enqueue `key` on
    `controller`'s queue. Called from the builder's event handlers, after
    predicates and the shard filter — only events that actually enqueue
    stamp a cause."""
    if not enabled():
        return
    meta = (obj or {}).get("metadata", {})
    src_ns = meta.get("namespace", "")
    src = f"{src_ns}/{meta.get('name', '')}" if src_ns else meta.get("name", "")
    cause = {
        "kind": kind,
        "verb": verb,
        "object": src,
        "rv": meta.get("resourceVersion", ""),
        "t": time.monotonic(),
    }
    with _mu:
        if len(_pending) >= _MAX_PENDING:
            return
        # keep-first matches the queue's dedup: a second add of a queued
        # key is dropped, so its cause must not displace the one that won
        _pending.setdefault((controller, key), cause)


def note_dequeue(queue: str, key: Any, wait_s: float) -> None:
    """WorkQueue.get() reports the measured enqueue-to-dequeue wait; the
    reconcile that begins next on this key picks it up."""
    if not enabled():
        return
    kstr = getattr(key, "key", None) or str(key)
    with _mu:
        if len(_pending_wait) >= _MAX_PENDING:
            _pending_wait.clear()
        _pending_wait[(queue, kstr)] = wait_s


def reconcile_begin(controller: str, key: str,
                    ctrl_id: int = 0) -> Optional[Dict[str, Any]]:
    """Open a reconcile context on this worker thread: consume the pending
    cause + queue wait, start the work clock, and begin per-reconcile scan
    accounting. Returns None disarmed (one env check)."""
    if not enabled():
        return None
    with _mu:
        cause = _pending.pop((controller, key), None)
        wait = _pending_wait.pop((controller, key), None)
    if wait is None:
        wait = (time.monotonic() - cause["t"]) if cause else 0.0
    ctx = {
        "controller": controller,
        "ctrl_id": ctrl_id,
        "key": key,
        "cause": cause,
        "queue_wait_s": wait,
        "scan_calls": 0,
        "scanned": 0,
        "used": 0,
        "t0": _clock(),
    }
    _tls.recon = ctx
    return ctx


def reconcile_end(ctx: Dict[str, Any], outcome: str = "") -> Dict[str, Any]:
    """Close the reconcile context: fold the sample into the per-controller
    aggregates and the Prometheus families. Returns the cause-chain fields
    the flight recorder appends to its per-reconcile sample (satellite 1)."""
    _tls.recon = None
    work_s = _clock() - ctx["t0"]
    cause = ctx["cause"]
    if cause is not None:
        kind, verb, origin = cause["kind"], cause["verb"], "watch"
    else:
        kind, verb, origin = "self", "requeue", "requeue"
    controller = ctx["controller"]
    wait = ctx["queue_wait_s"]
    sample = {
        "key": ctx["key"],
        "cause_kind": kind,
        "cause_verb": verb,
        "cause_object": cause["object"] if cause else "",
        "cause_rv": cause["rv"] if cause else "",
        "origin": origin,
        "outcome": outcome,
        "queue_wait_ms": round(wait * 1e3, 3),
        "work_ms": round(work_s * 1e3, 3),
        "scanned": ctx["scanned"],
        "used": ctx["used"],
    }
    with _mu:
        stats = _controller_stats(controller)
        stats["reconciles"] += 1
        ck = f"{kind}/{verb}"
        stats["causes"][ck] = stats["causes"].get(ck, 0) + 1
        stats["origins"][origin] += 1
        stats["queue_wait_s"] += wait
        stats["work_s"] += work_s
        stats["samples"].append(sample)
        trackers = list(_active_takeovers)
    cp_reconcile_cause_total.inc(controller=controller, kind=kind, verb=verb)
    cp_queue_wait_seconds.observe(wait, controller=controller)
    cp_reconcile_work_seconds.observe(work_s, controller=controller)
    for tr in trackers:  # usually empty; first-sweep mark for takeovers
        tr.on_reconcile_done(ctx["ctrl_id"])
    return {
        "cause_kind": kind,
        "cause_verb": verb,
        "queue_wait_ms": sample["queue_wait_ms"],
    }


# ---------------------------------------------------------------------------
# scan accounting (Informer.list / Store.list_raw / explicit sweeps)
# ---------------------------------------------------------------------------


def note_scan(kind: str, scanned: int, used: int) -> None:
    """One list/iteration over a cache or store bucket: `scanned` objects
    examined to yield `used` matches. Attribution order: the reconcile in
    flight on this thread, else the enclosing sweep(...) scope, else the
    flowcontrol thread-local flow, else 'unattributed'."""
    if not enabled():
        return
    ctx = getattr(_tls, "recon", None)
    if ctx is not None:
        ctx["scan_calls"] += 1
        ctx["scanned"] += scanned
        ctx["used"] += used
        who = ctx["controller"]
        with _mu:
            stats = _controller_stats(who)
            stats["scan_calls"] += 1
            stats["scanned"] += scanned
            stats["used"] += used
    else:
        who = getattr(_tls, "sweep", None)
        if who is None:
            from ..cluster.flowcontrol import current_flow

            who = current_flow() or "unattributed"
        with _mu:
            s = _sweeps.setdefault(
                who, {"scan_calls": 0, "scanned": 0, "used": 0}
            )
            s["scan_calls"] += 1
            s["scanned"] += scanned
            s["used"] += used
    if scanned:
        cp_cache_scan_objects_total.inc(scanned, controller=who)


@contextmanager
def sweep(name: str):
    """Attribute this thread's scans to a named sweep — the off-worker list
    walkers (the chip accountant's tick thread) that have neither a
    reconcile context nor a flow identity."""
    if not enabled():
        yield
        return
    prev = getattr(_tls, "sweep", None)
    _tls.sweep = name
    try:
        yield
    finally:
        _tls.sweep = prev


# ---------------------------------------------------------------------------
# takeover decomposition
# ---------------------------------------------------------------------------

TAKEOVER_PHASES = ("lease-acquire", "relist", "cache-warm", "first-sweep",
                   "first-owned-write")
# phase -> the mark that ends it (phases are sequential; boundaries are
# folded with a running max so a mark landing early zeroes its phase)
_PHASE_MARKS = ("leader", "synced", "started", "sweep", "write")


class _Takeover:
    """One manager takeover in flight. Marks arrive from Manager.start()
    (leader/synced/started), reconcile_end (sweep, matched by controller
    identity), and the client write path (write, matched by client
    identity); when the set completes, the decomposition is frozen, the
    histogram family observed, and the `manager.takeover` trace emitted."""

    def __init__(self, manager_id: str, client_ids: Set[int]):
        self.manager_id = manager_id
        self.client_ids = client_ids
        self.controller_ids: Set[int] = set()
        self.t0 = _clock()
        self.wall0 = time.time()
        self.marks: Dict[str, float] = {}
        self.complete = False
        self.result: Optional[Dict[str, Any]] = None

    def touch_waiting(self) -> None:
        """Still polling for leadership: restart the clock so lease-acquire
        measures acquisition, not the standby's healthy wait."""
        if not self.marks:
            self.t0 = _clock()
            self.wall0 = time.time()

    def mark(self, name: str, controller_ids: Optional[Set[int]] = None,
             ) -> None:
        with _mu:
            if self.complete or name in self.marks:
                return
            self.marks[name] = _clock()
            if controller_ids is not None:
                self.controller_ids = controller_ids
            finished = all(m in self.marks for m in _PHASE_MARKS)
        if finished:
            self._finish()

    def on_reconcile_done(self, ctrl_id: int) -> None:
        if "started" in self.marks and ctrl_id in self.controller_ids:
            self.mark("sweep")

    def on_write(self, client_id: int) -> None:
        if "started" in self.marks and client_id in self.client_ids:
            self.mark("write")

    def _segments(self) -> Dict[str, float]:
        prev = self.t0
        phases = {}
        for phase, mname in zip(TAKEOVER_PHASES, _PHASE_MARKS):
            t = max(prev, self.marks.get(mname, prev))
            phases[phase] = t - prev
            prev = t
        return phases

    def _finish(self) -> None:
        from ..utils import tracing

        phases = self._segments()
        total = sum(phases.values())
        self.result = {
            "manager": self.manager_id,
            "total_s": round(total, 6),
            "phases": {p: round(v, 6) for p, v in phases.items()},
            "relist_share": round(phases["relist"] / total, 6) if total else 0.0,
            "complete": True,
        }
        self.complete = True
        with _mu:
            if self in _active_takeovers:
                _active_takeovers.remove(self)
            _takeovers.append(self.result)
        for phase, v in phases.items():
            cp_takeover_phase_seconds.observe(v, phase=phase)
        # one connected trace: root manager.takeover, a child per phase
        trace_id = tracing.new_trace_id()
        root_span = tracing.new_span_id()
        root = tracing.format_traceparent(trace_id, root_span)
        t = self.wall0
        for phase, v in phases.items():
            tracing.record_span(
                f"takeover.{phase}", traceparent=root, trace_id=trace_id,
                start_time=t, end_time=t + v, manager=self.manager_id,
            )
            t += v
        tracing.record_span(
            "manager.takeover", trace_id=trace_id, span_id=root_span,
            start_time=self.wall0, end_time=self.wall0 + total,
            manager=self.manager_id,
            **{f"phase_{p.replace('-', '_')}_s": round(v, 6)
               for p, v in phases.items()},
        )

    def abandon(self) -> None:
        """Manager stopped before the takeover completed: freeze what we
        have (partial decomposition, complete=False), stop matching."""
        with _mu:
            if self.complete:
                return
            self.complete = True
            if self in _active_takeovers:
                _active_takeovers.remove(self)
            phases = self._segments()
            _takeovers.append({
                "manager": self.manager_id,
                "total_s": round(sum(phases.values()), 6),
                "phases": {p: round(v, 6) for p, v in phases.items()},
                "relist_share": 0.0,
                "complete": False,
            })


def takeover_begin(manager_id: str, client_ids: Set[int]) -> Optional[_Takeover]:
    """Manager.start() opens a takeover tracker (None disarmed)."""
    if not enabled():
        return None
    tr = _Takeover(manager_id, client_ids)
    with _mu:
        if len(_active_takeovers) >= 8:
            _active_takeovers.pop(0)
        _active_takeovers.append(tr)
    return tr


def note_write(client: Any) -> None:
    """A successful write through a typed client — the first one through a
    taking-over manager's fenced client ends its first-owned-write phase."""
    if not _active_takeovers:
        return
    cid = id(client)
    for tr in list(_active_takeovers):
        tr.on_write(cid)


# ---------------------------------------------------------------------------
# snapshot / reset
# ---------------------------------------------------------------------------


def _round(v: Any) -> Any:
    return round(v, 6) if isinstance(v, float) else v


def snapshot(controller: Optional[str] = None,
             limit: Optional[int] = None) -> Dict[str, Any]:
    """The /debug/reconciles + incident-bundle payload: per-controller cause
    mix, queue-wait/work totals, scan accounting, recent samples, plus the
    sweep table and takeover decompositions. `controller` narrows to one
    controller, `limit` caps the recent-sample rows per controller."""
    with _mu:
        names = sorted(
            _controllers,
            key=lambda n: _controllers[n]["reconciles"],
            reverse=True,
        )
        if controller is not None:
            names = [n for n in names if n == controller]
        controllers_out = {}
        for name in names:
            s = _controllers[name]
            samples = list(s["samples"])
            if limit is not None:
                samples = samples[-limit:] if limit else []
            n = s["reconciles"]
            controllers_out[name] = {
                "reconciles": n,
                "causes": dict(sorted(
                    s["causes"].items(), key=lambda kv: kv[1], reverse=True
                )),
                "origins": dict(s["origins"]),
                "queue_wait_s": _round(s["queue_wait_s"]),
                "work_s": _round(s["work_s"]),
                "scan_calls": s["scan_calls"],
                "scanned": s["scanned"],
                "used": s["used"],
                "scans_per_reconcile": _round(s["scanned"] / n) if n else 0.0,
                "samples": samples,
            }
        sweeps_out = {name: dict(s) for name, s in sorted(_sweeps.items())}
        takeovers_out = list(_takeovers) + [
            {
                "manager": tr.manager_id,
                "phases": {p: _round(v) for p, v in tr._segments().items()},
                "complete": False,
                "in_progress": True,
            }
            for tr in _active_takeovers
        ]
    return {
        "enabled": enabled(),
        "controllers": controllers_out,
        "sweeps": sweeps_out,
        "takeovers": takeovers_out,
    }


def reset() -> None:
    """Clear aggregates (test isolation, or a boundary between runs). In-flight reconcile contexts belong to
    their worker threads and are left alone — same contract as
    profiler.reset()."""
    with _mu:
        _controllers.clear()
        _sweeps.clear()
        _pending.clear()
        _pending_wait.clear()
        _takeovers.clear()
        # detached trackers are dead: a Manager still holding one must not
        # resurrect a takeover row into the cleared aggregates
        for tr in _active_takeovers:
            tr.complete = True
        del _active_takeovers[:]
