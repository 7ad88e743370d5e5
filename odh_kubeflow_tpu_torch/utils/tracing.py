"""W3C trace-context tracing (the port's copy of
odh_kubeflow_tpu/utils/tracing.py).

Real 128/64-bit trace and span ids with `traceparent` propagation, so one
trace ties a routed request together: the router's `router.request`
envelope span, its `router.pick` / `router.retry` / `router.hedge` children
and the engine's `inference.request` span (serving/router.py,
serving/engine.py) share the caller's trace id.

- In-process context is a thread-local span stack shared by all tracers
  (`current_traceparent()`; `attach()` adopts an incoming header);
- completed spans land in one process-wide ring buffer (`global_buffer`,
  `recent_spans()`), and every completed span is handed to the span
  listeners (the profiler aggregates span durations by name through one);
- `record_span` records an already-complete span with known start and end;
  `begin_root`/`finish_root` keep long-lived root spans, whose count the
  `tracing_roots_*` families publish.

Tracing is on by default and cheap (a dataclass and a deque append per
span); `set_enabled(False)` turns every start into a no-op.
"""
from __future__ import annotations

import collections
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional
from . import racecheck
from .metrics import global_registry

# ---------------------------------------------------------------------------
# W3C trace-context primitives
# ---------------------------------------------------------------------------

def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def format_traceparent(trace_id: str, span_id: str, sampled: bool = True) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def parse_traceparent(header: Optional[str]) -> Optional[tuple]:
    """`00-{trace-id}-{parent-id}-{flags}` -> (trace_id, span_id), or None
    for anything malformed (all-zero ids are invalid per the spec)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    _version, trace_id, span_id, _flags = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
            return None
    except ValueError:
        return None
    return trace_id.lower(), span_id.lower()


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


@dataclass
class SpanEvent:
    name: str
    attributes: Dict[str, Any] = field(default_factory=dict)
    timestamp: float = 0.0


@dataclass
class Span:
    name: str
    trace_id: str = ""
    span_id: str = ""
    parent_id: str = ""
    attributes: Dict[str, Any] = field(default_factory=dict)
    events: List[SpanEvent] = field(default_factory=list)
    parent: Optional["Span"] = None  # in-process parent (back-compat surface)
    start_time: float = 0.0
    end_time: float = 0.0
    recording: bool = True  # attach()ed remote contexts propagate, not record

    @property
    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id)

    @property
    def duration(self) -> float:
        return max(0.0, self.end_time - self.start_time)

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, **attributes: Any) -> None:
        self.events.append(SpanEvent(name, attributes, time.time()))

    def end(self) -> None:
        self.end_time = time.time()

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_time": self.start_time,
            "end_time": self.end_time,
            "duration_ms": round(self.duration * 1e3, 3),
            "attributes": dict(self.attributes),
            "events": [
                {"name": e.name, "timestamp": e.timestamp, "attributes": dict(e.attributes)}
                for e in self.events
            ],
        }


# ---------------------------------------------------------------------------
# Process-wide context + export
# ---------------------------------------------------------------------------

_ctx = threading.local()  # .stack: List[Span] — shared by ALL tracers


def _stack() -> List[Span]:
    stack = getattr(_ctx, "stack", None)
    if stack is None:
        stack = _ctx.stack = []
    return stack


def current_span() -> Optional[Span]:
    stack = getattr(_ctx, "stack", None)
    return stack[-1] if stack else None


def current_traceparent() -> Optional[str]:
    span = current_span()
    return span.traceparent if span is not None else None


_enabled = True


def set_enabled(on: bool) -> None:
    """Global kill switch: False turns every span start into a no-op (the
    overhead A/B in tests/test_tracing.py runs the reconcile loop both ways)."""
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


class TraceBuffer:
    """Ring buffer of completed spans — the /debug/traces backing store."""

    def __init__(self, maxlen: int = 4096):
        self._spans: "collections.deque[Span]" = collections.deque(maxlen=maxlen)
        self._lock = racecheck.make_lock("TraceBuffer._lock")

    def append(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def spans(self, trace_id: Optional[str] = None, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


global_buffer = TraceBuffer()

# completed-span listeners (the flight recorder subscribes): called once per
# exported span, after it lands in the buffer, outside any tracing lock
_span_listeners: List[Any] = []


def add_span_listener(fn) -> None:
    _span_listeners.append(fn)


def remove_span_listener(fn) -> None:
    try:
        _span_listeners.remove(fn)
    except ValueError:
        pass


def _export(span: Span) -> None:
    global_buffer.append(span)
    for fn in list(_span_listeners):
        try:
            fn(span)
        except Exception:
            pass  # a broken listener must never break the traced code path


def recent_spans(trace_id: Optional[str] = None, name: Optional[str] = None) -> List[dict]:
    """Completed spans as JSON-ready dicts (newest last) — the /debug/traces
    payload of a debug route or a benchmark's phase breakdown."""
    return [s.to_dict() for s in global_buffer.spans(trace_id=trace_id, name=name)]


def clear() -> None:
    global_buffer.clear()
    with _roots_lock:
        _open_roots.clear()
        _root_id_by_key.clear()
        _key_by_root_id.clear()
    _publish_root_stats(0)


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------

class _NoopSpan(Span):
    """Shared no-op span handed out while tracing is disabled: attribute and
    event writes vanish (a shared mutable span would accumulate them)."""

    def set_attribute(self, key: str, value: Any) -> None:
        pass

    def add_event(self, name: str, **attributes: Any) -> None:
        pass

    def end(self) -> None:
        pass


_NOOP = _NoopSpan(name="", recording=False)


class Tracer:
    """Named span factory. All tracers share the thread-local context stack
    and the global buffer; a per-tracer InMemoryExporter can additionally be
    attached (the seed's test surface, kept)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.exporter: Optional["InMemoryExporter"] = None

    def start_span(
        self, name: str, traceparent: Optional[str] = None, **attributes: Any
    ) -> "SpanContext":
        if not _enabled:
            return SpanContext(self, _NOOP, push=False)
        parent = current_span()
        trace_id, parent_id = "", ""
        ctx = parse_traceparent(traceparent)
        if ctx is not None:
            trace_id, parent_id = ctx
        elif parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        span = Span(
            name=name,
            trace_id=trace_id or new_trace_id(),
            span_id=new_span_id(),
            parent_id=parent_id,
            attributes=dict(attributes),
            parent=parent,
            start_time=time.time(),
        )
        return SpanContext(self, span)

    def _record(self, span: Span) -> None:
        if not span.recording:
            return
        _export(span)
        if self.exporter is not None:
            self.exporter.spans.append(span)


class SpanContext:
    def __init__(self, tracer: Tracer, span: Span, push: bool = True):
        self.tracer = tracer
        self.span = span
        self._push = push

    def __enter__(self) -> Span:
        if self._push:
            _stack().append(self.span)
        return self.span

    def __exit__(self, *exc) -> None:
        if not self._push:
            return
        self.span.end()
        stack = _stack()
        if stack and stack[-1] is self.span:
            stack.pop()
        self.tracer._record(self.span)


class _Attached:
    """Context manager that adopts a remote traceparent (HTTP header) as the
    current context WITHOUT recording a span — server-side propagation."""

    def __init__(self, span: Optional[Span]):
        self.span = span

    def __enter__(self) -> Optional[Span]:
        if self.span is not None:
            _stack().append(self.span)
        return self.span

    def __exit__(self, *exc) -> None:
        if self.span is not None:
            stack = _stack()
            if stack and stack[-1] is self.span:
                stack.pop()


def attach(traceparent: Optional[str]) -> _Attached:
    """Adopt an incoming `traceparent` header for the current thread (no-op
    for absent/malformed headers): spans started inside become children of
    the remote caller's span."""
    ctx = parse_traceparent(traceparent) if _enabled else None
    if ctx is None:
        return _Attached(None)
    trace_id, span_id = ctx
    return _Attached(
        Span(name="remote-parent", trace_id=trace_id, span_id=span_id, recording=False)
    )


def record_span(
    name: str,
    traceparent: Optional[str] = None,
    start_time: Optional[float] = None,
    end_time: Optional[float] = None,
    trace_id: Optional[str] = None,
    span_id: Optional[str] = None,
    **attributes: Any,
) -> Optional[Span]:
    """Record an already-complete span (known start/end) under `traceparent`
    — the one-shot form for phase boundaries observed after the fact, e.g.
    the kubelet sim's container-start window."""
    if not _enabled:
        return None
    parent_trace, parent_span = "", ""
    ctx = parse_traceparent(traceparent)
    if ctx is not None:
        parent_trace, parent_span = ctx
    now = time.time()
    span = Span(
        name=name,
        trace_id=trace_id or parent_trace or new_trace_id(),
        span_id=span_id or new_span_id(),
        parent_id=parent_span,
        attributes=dict(attributes),
        start_time=start_time if start_time is not None else now,
        end_time=end_time if end_time is not None else now,
    )
    _export(span)
    return span


# ---------------------------------------------------------------------------
# Long-lived root spans (an envelope that outlives any one call stack)
# ---------------------------------------------------------------------------

_open_roots: Dict[str, Span] = {}  # trace_id -> open root span
_root_id_by_key: Dict[str, str] = {}  # dedup key (e.g. ns/name) -> trace_id
_key_by_root_id: Dict[str, str] = {}  # reverse, for cleanup on finish/evict
_roots_lock = racecheck.make_lock("tracing._roots_lock")
# roots that never finish (CPU notebooks, deletes before ready) must not
# grow without bound: oldest-first eviction past this cap
_MAX_OPEN_ROOTS = 2048


def _drop_root_locked(trace_id: str) -> Optional[Span]:
    span = _open_roots.pop(trace_id, None)
    key = _key_by_root_id.pop(trace_id, None)
    if key is not None and _root_id_by_key.get(key) == trace_id:
        _root_id_by_key.pop(key, None)
    return span


tracing_roots_active = global_registry.gauge(
    "tracing_roots_active",
    "Open long-lived trace roots (notebook.ready envelopes not yet closed)",
)
tracing_roots_evicted_total = global_registry.counter(
    "tracing_roots_evicted_total",
    "Open trace roots dropped without finishing, by reason (capacity | "
    "reopened | deleted | discarded)",
    labels=("reason",),
)


def _publish_root_stats(active: int, evicted_reason: Optional[str] = None) -> None:
    """Mirror the root registry into tracing_roots_active /
    tracing_roots_evicted_total, so a leak shows instead of silently aging
    out. Never called under _roots_lock: metrics stay out of tracing's lock
    order."""
    tracing_roots_active.set(float(active))
    if evicted_reason is not None:
        tracing_roots_evicted_total.inc(reason=evicted_reason)


def begin_root(name: str, key: Optional[str] = None, **attributes: Any) -> Optional[Span]:
    """Open a root span that outlives any one call stack (the webhook opens
    `notebook.ready` here at CREATE admission; the probe-status gate closes
    it at first mesh-ready). A `key` (e.g. "ns/name") dedups re-openings:
    retried CREATEs whose earlier attempt failed AFTER admission would
    otherwise strand one root per attempt. Returns None when disabled."""
    if not _enabled:
        return None
    span = Span(
        name=name,
        trace_id=new_trace_id(),
        span_id=new_span_id(),
        attributes=dict(attributes),
        start_time=time.time(),
    )
    reopened = evicted = 0
    with _roots_lock:
        if key is not None:
            stale = _root_id_by_key.get(key)
            if stale is not None:
                _drop_root_locked(stale)
                reopened += 1
            _root_id_by_key[key] = span.trace_id
            _key_by_root_id[span.trace_id] = key
        while len(_open_roots) >= _MAX_OPEN_ROOTS:
            _drop_root_locked(next(iter(_open_roots)))  # insertion order = oldest
            evicted += 1
        _open_roots[span.trace_id] = span
        active = len(_open_roots)
    for _ in range(reopened):
        _publish_root_stats(active, "reopened")
    for _ in range(evicted):
        _publish_root_stats(active, "capacity")
    if not reopened and not evicted:
        _publish_root_stats(active)
    return span


def finish_root(trace_id: str, end_time: Optional[float] = None, **attributes: Any) -> Optional[Span]:
    """Close + export the open root for `trace_id`; None if unknown (e.g. the
    root was opened in another process — callers then synthesize via
    record_span with the annotation's ids)."""
    with _roots_lock:
        span = _drop_root_locked(trace_id)
        active = len(_open_roots)
    if span is None:
        return None
    _publish_root_stats(active)
    span.attributes.update(attributes)
    span.end_time = end_time if end_time is not None else time.time()
    _export(span)
    return span


def open_root(trace_id: str) -> Optional[Span]:
    with _roots_lock:
        return _open_roots.get(trace_id)


def discard_root(trace_id: str) -> None:
    """Drop an open root without exporting it (an admission denial after the
    webhook opened the root must not leak the entry, nor record a phantom
    readiness trace)."""
    with _roots_lock:
        span = _drop_root_locked(trace_id)
        active = len(_open_roots)
    _publish_root_stats(active, "discarded" if span is not None else None)


def discard_root_for(key: str) -> Optional[Span]:
    """Drop the open root registered under a dedup key ("ns/name") — the
    notebook reconciler calls this when the owning CR is deleted, so a
    notebook that never reached ready closes its root deterministically
    instead of leaking until capacity eviction. Returns the dropped span
    (None when no root was open for the key)."""
    with _roots_lock:
        trace_id = _root_id_by_key.get(key)
        span = _drop_root_locked(trace_id) if trace_id is not None else None
        active = len(_open_roots)
    _publish_root_stats(active, "deleted" if span is not None else None)
    return span


class InMemoryExporter:
    def __init__(self) -> None:
        self.spans: List[Span] = []

    def by_name(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]
