"""Serving metric families the engine feeds (counterpart of
odh_kubeflow_tpu/serving/metrics.py, own copy), surfaced through
`ServingEngine.stats()["metrics"]`. The classes are in `utils/metrics.py`;
the engine's decode-step telemetry is in `telemetry.py`.
"""
from __future__ import annotations

from ..utils.metrics import Counter, Gauge, Histogram

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
