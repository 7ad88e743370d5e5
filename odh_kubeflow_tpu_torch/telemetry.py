"""Workload telemetry of the port (counterpart of the workload half of
odh_kubeflow_tpu/tpu/telemetry.py): train/decode step-time histograms,
throughput and MFU gauges, and per-device memory.

The families keep the reference's names, help text and buckets, because
the manager's scrape and alert rules read those names. Sources:

- explicit observations from the workload's loop (`observe_train_step`,
  `observe_decode_step`; the serving engine calls the latter once per
  decode burst),
- the probe agent's allocator sampler (probe/agent.py `CudaMonitor`), which
  feeds `record_device_memory` from the `read_allocator_stats` it already
  takes for activity detection.

The slice-repair families and goodput accounting are control plane and
stay in the JAX package.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch

from .utils import profiler
from .utils.metrics import global_registry

_STEP_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30)
# decode needs the sub-ms resolution the train buckets lack
_DECODE_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30)

train_step_seconds = global_registry.histogram(
    "tpu_train_step_duration_seconds",
    "Per-step wall-clock of the training loop (host-observed, jit dispatch "
    "amortized by the caller's timing method)",
    buckets=_STEP_BUCKETS,
)
decode_step_seconds = global_registry.histogram(
    "tpu_decode_step_duration_seconds",
    "Per-token wall-clock of autoregressive decode",
    buckets=_DECODE_BUCKETS,
)
tokens_per_second = global_registry.gauge(
    "tpu_tokens_per_second",
    "Most recent throughput, by phase (train | decode)",
    labels=("phase",),
)
mfu = global_registry.gauge(
    "tpu_mfu",
    "Most recent model-FLOPs utilization (0-1), by phase (train | decode)",
    labels=("phase",),
)
device_memory_bytes = global_registry.gauge(
    "tpu_device_memory_bytes",
    "Bytes in use per local device (from the runtime's memory_stats)",
    labels=("device",),
)

FAMILIES = (train_step_seconds, decode_step_seconds, tokens_per_second, mfu,
            device_memory_bytes)


def snapshot() -> dict:
    """Every family's current value, by name."""
    return {family.name: family.snapshot() for family in FAMILIES}


def observe_train_step(step_s: float, tokens: Optional[float] = None,
                       mfu_est: Optional[float] = None) -> None:
    """One training step: step wall-clock, plus derived throughput and MFU
    when the caller knows them."""
    train_step_seconds.observe(step_s)
    if tokens is not None and step_s > 0:
        tokens_per_second.set(tokens / step_s, phase="train")
    if mfu_est is not None:
        mfu.set(mfu_est, phase="train")


def observe_decode_step(step_s: float, tokens: Optional[float] = None,
                        mfu_est: Optional[float] = None) -> None:
    decode_step_seconds.observe(step_s)
    if tokens is not None and step_s > 0:
        tokens_per_second.set(tokens / step_s, phase="decode")
    if mfu_est is not None:
        mfu.set(mfu_est, phase="decode")


def record_device_memory(mems: Iterable[Tuple[Optional[float], Optional[float]]]) -> None:
    """Publish per-device bytes in use from (bytes_in_use, n_allocs) pairs
    (the probe agent's sampler shape); devices are labeled by local index.
    Under PROFILE=1 the max across devices also feeds the profiler's
    per-region memory watermarks (`profiler.on_device_memory`)."""
    peak: Optional[float] = None
    for i, (bytes_in_use, _allocs) in enumerate(mems):
        if bytes_in_use is not None:
            device_memory_bytes.set(float(bytes_in_use), device=str(i))
            peak = float(bytes_in_use) if peak is None else max(peak, float(bytes_in_use))
    if peak is not None:
        profiler.on_device_memory(peak)


def read_allocator_stats() -> Optional[List[Tuple[Optional[int], Optional[int]]]]:
    """(allocated bytes, cumulative allocation requests) of each visible
    card's caching allocator, or None before this process has initialised
    CUDA: a CPU-only process, or one that never touched the card, reads
    nothing rather than creating a CUDA context to read an empty allocator.
    Never raises."""
    try:
        if not torch.cuda.is_initialized():
            return None
        stats = [torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())]
    except (RuntimeError, AssertionError):
        return None
    return [(s.get("allocated_bytes.all.current"), s.get("allocation.all.allocated")) for s in stats]


def update_device_memory() -> int:
    """Publish every visible card's bytes in use directly (for processes
    that run no probe agent); returns the devices published. Never raises."""
    mems = read_allocator_stats() or []
    record_device_memory(mems)
    return sum(bytes_in_use is not None for bytes_in_use, _ in mems)
