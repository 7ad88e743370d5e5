"""Serving metric families the engine, the router and the InferenceEndpoint
reconciler feed (counterpart of odh_kubeflow_tpu/serving/metrics.py, own
copy: the same names, help text, labels and buckets, so the port's
`render()` equals the reference's). They register in the port's
`global_registry` (`utils/metrics.py`); the engine's six families are also
surfaced through `ServingEngine.stats()["metrics"]`. The engine's
decode-step telemetry is in `telemetry.py`.
"""
from __future__ import annotations

from ..utils.metrics import global_registry

# TTFT: submit -> first generated token (prefill admission wait + prefill
# compute)
inference_ttft_seconds = global_registry.histogram(
    "inference_ttft_seconds",
    "Time to first token per request: submit -> first generated token "
    "(queue wait + prefill)",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0),
)
inference_token_latency_seconds = global_registry.histogram(
    "inference_token_latency_seconds",
    "Per-token decode latency (inter-token gap) per active sequence — the "
    "token-latency SLO judges the 0.25s bucket",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0, 2.5),
)
inference_goodput_tokens_per_s = global_registry.gauge(
    "inference_goodput_tokens_per_s",
    "Cumulative generated tokens per second of engine wall time — the "
    "continuous-batching headline the bench compares against the "
    "static-batch decode baseline",
)
inference_queue_depth = global_registry.gauge(
    "inference_queue_depth",
    "Requests waiting in the bounded admission queue (backpressure rejects "
    "past spec.serving.maxQueueDepth)",
)
inference_slot_occupancy_ratio = global_registry.gauge(
    "inference_slot_occupancy_ratio",
    "Active KV-cache slots / total slots (the idle-HBM headroom continuous "
    "batching exists to convert into goodput)",
)
inference_requests_total = global_registry.counter(
    "inference_requests_total",
    "Serving requests by terminal result: ok (completed), rejected "
    "(admission-queue backpressure), error, canceled (engine stopped "
    "mid-request) — the serving-availability SLO's good/total ratio",
    labels=("result",),
)

inference_endpoint_promotions_total = global_registry.counter(
    "inference_endpoint_promotions_total",
    "Notebook->endpoint promotions by bind path: warm (claimed the source "
    "notebook's pooled slice) or cold (fresh placement)",
    labels=("bind",),
)
inference_restore_verifications_total = global_registry.counter(
    "inference_restore_verifications_total",
    "Endpoint-side checkpoint restore verifications by result (ok / "
    "mismatch / unverified)",
    labels=("result",),
)

# ---- the token router (serving/router.py): picks_total{result} is the
# router-level availability ratio; the added latency is the routing
# overhead a fleet benchmark reports as router_added_latency_p50_ms
inference_router_picks_total = global_registry.counter(
    "inference_router_picks_total",
    "Routed generations by terminal outcome: ok (served), shed (admission "
    "or retry budget -> wire 429), error (retry budget exhausted on "
    "failures), no_replica (fleet parked/ejected — the cold-wake signal)",
    labels=("result",),
)
inference_router_retries_total = global_registry.counter(
    "inference_router_retries_total",
    "Cross-replica retries by trigger: queue_full (replica shed, tried "
    "another), error (submit raised), canceled (request died mid-flight on "
    "a torn-down replica)",
    labels=("reason",),
)
inference_router_hedges_total = global_registry.counter(
    "inference_router_hedges_total",
    "Tail-latency hedges: launched (second submit fired), primary_won / "
    "hedge_won (which completion counted; the loser is canceled)",
    labels=("outcome",),
)
inference_router_ejections_total = global_registry.counter(
    "inference_router_ejections_total",
    "Replica rotation changes: eject (breaker opened on probe/error "
    "breach), readmit (half-open trial succeeded)",
    labels=("action",),
)
inference_router_added_latency_seconds = global_registry.histogram(
    "inference_router_added_latency_seconds",
    "Router-added latency per request: generate() entry -> accepted engine "
    "submit (pick scoring + admission + any cross-replica retries)",
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
             0.05, 0.1, 0.25, 0.5, 1.0),
)

# the engine's families, as ServingEngine.stats()["metrics"] shows them
FAMILIES = (
    inference_ttft_seconds,
    inference_token_latency_seconds,
    inference_goodput_tokens_per_s,
    inference_queue_depth,
    inference_slot_occupancy_ratio,
    inference_requests_total,
)


def snapshot() -> dict:
    """Every engine family's current value, by name."""
    return {family.name: family.snapshot() for family in FAMILIES}
