"""PROFILE=1: the opt-in data-plane profiler of the port (counterpart of
odh_kubeflow_tpu/utils/profiler.py). It answers where the time of a hot
region went, on the region table of `utils/hotregions.py`: every
`torchguard.region(...)` entry reports here when armed, and explicit
`profiler.phase(...)` contexts decompose a region into named phases (a
decode burst into admit -> prefill -> scan -> batched_drain -> emit).

The accounting model (one thread-local frame stack):

- **region frames** time one entry of a hot region. A region nested inside
  another (serving.prefill inside the engine's serving.decode_burst step)
  counts toward its own totals and subtracts from the enclosing region's
  *self* time. Re-entering a region name already on the stack is a no-op:
  the torchguard burst guard inside the engine's step-wide scope must not
  double-count.
- **phase frames** attribute wall time to (innermost enclosing region,
  phase name). Nested phases subtract from the parent phase's self time,
  so the SELF times of a region's phases partition the region total (the
  `where_time_went` invariant).
- **compile/run timing**: `on_compile` (a CUDA-graph capture or another
  compile, reported through `torchguard.record_compile`) and `on_jit_call`
  attribute to the region, never to a phase.
- **consumers**: `profiler.region(name, consumer=...)` attributes its
  entries per consumer label.
- **device-memory watermarks**: `on_device_memory()` (fed by
  `telemetry.record_device_memory` from the probe agent's allocator
  sampler, and by `update_device_memory`) records the peak bytes in use
  observed while each region was active.
- **span phases**: a tracing span listener (installed at import, inert
  unless armed) aggregates completed span durations by name.

The four `profile_*` families register in the port's registry at import.
The clock is `time.perf_counter` unless `set_clock` injects another (the
tests run the accounting on a fake clock, exactly). Zero cost off: one env
check per region or phase enter; no state is touched disarmed.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from . import hotregions
from .metrics import global_registry


def enabled() -> bool:
    return os.environ.get("PROFILE", "") not in ("", "0", "false")


# ---------------------------------------------------------------------------
# Prometheus families
# ---------------------------------------------------------------------------

# ms-scale phases: a decode-burst phase on hardware is ~0.1-50ms; the
# seconds-scale default buckets would collapse every phase into one bucket
PHASE_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)
REGION_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                  0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
COMPILE_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0, 30.0, 60.0)

profile_phase_seconds = global_registry.histogram(
    "profile_phase_seconds",
    "Self wall-clock per profiler phase entry (PROFILE=1), by hot region "
    "and phase — the where_time_went decomposition",
    labels=("region", "phase"),
    buckets=PHASE_BUCKETS,
)
profile_region_seconds = global_registry.histogram(
    "profile_region_seconds",
    "Total wall-clock per hot-region entry (PROFILE=1), by region",
    labels=("region",),
    buckets=REGION_BUCKETS,
)
profile_compile_seconds = global_registry.histogram(
    "profile_compile_seconds",
    "Trace/compile wall-clock per guarded-jit (re)trace (PROFILE=1), by "
    "hot region",
    labels=("region",),
    buckets=COMPILE_BUCKETS,
)
profile_region_hbm_peak_bytes = global_registry.gauge(
    "profile_region_hbm_peak_bytes",
    "Peak device bytes-in-use observed while the region was active "
    "(PROFILE=1; fed by the probe agent's device-memory sampler)",
    labels=("region",),
)


# ---------------------------------------------------------------------------
# state: per-thread frame stack + process-wide aggregates
# ---------------------------------------------------------------------------

_REGION, _PHASE = 0, 1

_mu = threading.Lock()
_tls = threading.local()
_regions: Dict[str, Dict[str, Any]] = {}
_spans: Dict[str, Dict[str, float]] = {}
_MAX_SPAN_NAMES = 256
# region name -> active entry count across ALL threads: the HBM sampler
# runs on its own thread, so attribution can't ride the frame stack
_active: Dict[str, int] = {}
_hbm: Dict[str, Optional[float]] = {"peak_bytes": None, "limit_bytes": None}

_clock: Callable[[], float] = time.perf_counter


def set_clock(clock: Optional[Callable[[], float]] = None) -> None:
    """Use `clock` for every later frame (None: `time.perf_counter`)."""
    global _clock
    _clock = clock or time.perf_counter


class _Frame:
    __slots__ = ("kind", "name", "region", "consumer", "t0", "child_s")

    def __init__(self, kind: int, name: str, region: str, consumer: str):
        self.kind = kind
        self.name = name
        self.region = region  # enclosing region for phases; own name for regions
        self.consumer = consumer
        self.t0 = _clock()
        self.child_s = 0.0


def _stack() -> List[_Frame]:
    stack = getattr(_tls, "frames", None)
    if stack is None:
        stack = _tls.frames = []
    return stack


def _region_stats(name: str) -> Dict[str, Any]:
    stats = _regions.get(name)
    if stats is None:
        stats = _regions[name] = {
            "count": 0,
            "total_s": 0.0,
            "self_s": 0.0,
            "compiles": 0,
            "compile_s": 0.0,
            "jit_calls": 0,
            "jit_run_s": 0.0,
            "phases": {},
            "consumers": {},
            "hbm_peak_bytes": None,
        }
    return stats


# ---------------------------------------------------------------------------
# region / phase machinery
# ---------------------------------------------------------------------------


def region_enter(name: str, consumer: str = "default") -> Optional[_Frame]:
    """Push a region frame; returns None (inert) when disarmed or when
    `name` is already active on this thread — re-entry, e.g. the torchguard
    burst guard inside the engine's step-wide profiler scope, must not
    double-count. The torchguard.region hook calls this."""
    if not enabled():
        return None
    stack = _stack()
    for f in stack:
        if f.kind == _REGION and f.name == name:
            return None
    frame = _Frame(_REGION, name, name, consumer)
    stack.append(frame)
    with _mu:
        _active[name] = _active.get(name, 0) + 1
    return frame


def region_exit(frame: Optional[_Frame]) -> None:
    if frame is None:
        return
    elapsed = _clock() - frame.t0
    stack = _stack()
    # balanced by construction (phases are context managers); pop
    # defensively past any frame an exception-skipped exit left behind
    while stack:
        if stack.pop() is frame:
            break
    # nested region time subtracts from the enclosing REGION's self time
    # (phase frames are skipped: a region inside a phase is the phase's
    # own time — serving.prefill inside the burst's "prefill" phase)
    for parent in reversed(stack):
        if parent.kind == _REGION:
            parent.child_s += elapsed
            break
    with _mu:
        _active[frame.name] = max(0, _active.get(frame.name, 1) - 1)
        stats = _region_stats(frame.name)
        stats["count"] += 1
        stats["total_s"] += elapsed
        stats["self_s"] += max(0.0, elapsed - frame.child_s)
        cons = stats["consumers"].setdefault(
            frame.consumer, {"count": 0, "total_s": 0.0}
        )
        cons["count"] += 1
        cons["total_s"] += elapsed
    profile_region_seconds.observe(elapsed, region=frame.name)


class region:
    """Profiler-only region scope (the engine wraps its whole step in one so
    phases have a denominator; torchguard regions report through the module
    hooks instead). Unknown names raise at construction — same contract as
    torchguard.region."""

    def __init__(self, name: str, consumer: str = "default"):
        hotregions.get(name)
        self.name = name
        self.consumer = consumer
        self._frame: Optional[_Frame] = None

    def __enter__(self) -> "region":
        self._frame = region_enter(self.name, self.consumer)
        return self

    def __exit__(self, *exc: Any) -> None:
        frame, self._frame = self._frame, None
        region_exit(frame)


class phase:
    """Attribute a sub-step's wall time to (innermost active region, name).
    Nested phases subtract from the parent phase's self time, so a region's
    phase SELF times partition its total — the where_time_went invariant."""

    __slots__ = ("name", "_frame")

    def __init__(self, name: str):
        self.name = name
        self._frame: Optional[_Frame] = None

    def __enter__(self) -> "phase":
        if not enabled():
            return self
        stack = _stack()
        region_name = "process"
        for f in reversed(stack):
            if f.kind == _REGION:
                region_name = f.name
                break
        frame = _Frame(_PHASE, self.name, region_name, "default")
        stack.append(frame)
        self._frame = frame
        return self

    def __exit__(self, *exc: Any) -> None:
        frame, self._frame = self._frame, None
        if frame is None:
            return
        elapsed = _clock() - frame.t0
        stack = _stack()
        while stack:
            if stack.pop() is frame:
                break
        # only a parent PHASE absorbs this as child time (self-time
        # partitioning); the enclosing region keeps the full elapsed —
        # phases are the region total's decomposition, not a deduction
        if stack and stack[-1].kind == _PHASE:
            stack[-1].child_s += elapsed
        self_s = max(0.0, elapsed - frame.child_s)
        with _mu:
            stats = _region_stats(frame.region)
            p = stats["phases"].setdefault(
                frame.name, {"count": 0, "total_s": 0.0, "self_s": 0.0}
            )
            p["count"] += 1
            p["total_s"] += elapsed
            p["self_s"] += self_s
        profile_phase_seconds.observe(
            self_s, region=frame.region, phase=frame.name
        )


# ---------------------------------------------------------------------------
# compile and run hooks (called from utils/torchguard.py)
# ---------------------------------------------------------------------------


def on_compile(region_name: str, duration_s: float) -> None:
    """One compile (a CUDA-graph capture, a compiled program) attributed
    to the region, with its wall time; torchguard.record_compile calls
    this beside its count."""
    with _mu:
        stats = _region_stats(region_name)
        stats["compiles"] += 1
        stats["compile_s"] += duration_s
    profile_compile_seconds.observe(duration_s, region=region_name)


def on_jit_call(region_name: str, duration_s: float) -> None:
    """One launch of a compiled program of the region (a graph replay):
    its host wall time."""
    with _mu:
        stats = _region_stats(region_name)
        stats["jit_calls"] += 1
        stats["jit_run_s"] += duration_s


# ---------------------------------------------------------------------------
# device-memory watermarks (fed by telemetry from the probe agent's sampler)
# ---------------------------------------------------------------------------


def on_device_memory(
    bytes_in_use: float, limit_bytes: Optional[float] = None
) -> None:
    """One device-memory observation (max across local devices): update the
    global high-water mark and every currently-active region's. The sampler
    thread is not the workload thread, so attribution uses the cross-thread
    active-region counts, not the frame stack."""
    if not enabled():
        return
    with _mu:
        if _hbm["peak_bytes"] is None or bytes_in_use > _hbm["peak_bytes"]:
            _hbm["peak_bytes"] = bytes_in_use
        if limit_bytes is not None:
            _hbm["limit_bytes"] = limit_bytes
        active = [name for name, n in _active.items() if n > 0]
        for name in active:
            stats = _region_stats(name)
            prev = stats["hbm_peak_bytes"]
            if prev is None or bytes_in_use > prev:
                stats["hbm_peak_bytes"] = bytes_in_use
    for name in active:
        profile_region_hbm_peak_bytes.set(bytes_in_use, region=name)


def hbm_stats() -> Dict[str, Optional[float]]:
    """Global device-memory watermark + headroom (a serving benchmark reports
    this; None until a sampler with memory_stats has fed us)."""
    with _mu:
        peak, limit = _hbm["peak_bytes"], _hbm["limit_bytes"]
    headroom = (
        limit - peak if (peak is not None and limit is not None) else None
    )
    return {"peak_bytes": peak, "limit_bytes": limit,
            "headroom_bytes": headroom}


# ---------------------------------------------------------------------------
# span phases (suspend/resume et al) — installed at import, inert unless armed
# ---------------------------------------------------------------------------


def _on_span(span: Any) -> None:
    if not enabled():
        return
    with _mu:
        s = _spans.get(span.name)
        if s is None:
            if len(_spans) >= _MAX_SPAN_NAMES:
                return
            s = _spans[span.name] = {"count": 0, "total_s": 0.0}
        s["count"] += 1
        s["total_s"] += span.duration


def _install_span_capture() -> None:
    from . import tracing

    if _on_span not in tracing._span_listeners:
        tracing.add_span_listener(_on_span)


_install_span_capture()


# ---------------------------------------------------------------------------
# snapshot / reset
# ---------------------------------------------------------------------------


def _round(v: Any) -> Any:
    return round(v, 6) if isinstance(v, float) else v


def snapshot(
    region: Optional[str] = None, limit: Optional[int] = None
) -> Dict[str, Any]:
    """The profile payload: per-region self/total,
    compile/run split, phases, per-consumer attribution, HBM marks — top-N
    by self time (`limit`), or one region (`region`)."""
    with _mu:
        names = sorted(
            _regions, key=lambda n: _regions[n]["self_s"], reverse=True
        )
        if region is not None:
            names = [n for n in names if n == region]
        if limit is not None:
            names = names[:limit]
        regions_out = {}
        for name in names:
            s = _regions[name]
            regions_out[name] = {
                "count": s["count"],
                "total_s": _round(s["total_s"]),
                "self_s": _round(s["self_s"]),
                "compiles": s["compiles"],
                "compile_s": _round(s["compile_s"]),
                "jit_calls": s["jit_calls"],
                "jit_run_s": _round(s["jit_run_s"]),
                "phases": {
                    p: {k: _round(v) for k, v in ps.items()}
                    for p, ps in s["phases"].items()
                },
                "consumers": {
                    c: {k: _round(v) for k, v in cs.items()}
                    for c, cs in s["consumers"].items()
                },
                "hbm_peak_bytes": s["hbm_peak_bytes"],
            }
        spans_out = {
            name: {"count": s["count"], "total_s": _round(s["total_s"])}
            for name, s in sorted(
                _spans.items(), key=lambda kv: kv[1]["total_s"], reverse=True
            )
        }
    return {
        "enabled": enabled(),
        "regions": regions_out,
        "spans": spans_out,
        "hbm": hbm_stats(),
    }


def reset() -> None:
    """Clear aggregates (test isolation / measurement boundaries). Active
    frames belong to their owners and are left alone — same contract as
    torchguard.reset()."""
    with _mu:
        _regions.clear()
        _spans.clear()
        _hbm["peak_bytes"] = None
        _hbm["limit_bytes"] = None
