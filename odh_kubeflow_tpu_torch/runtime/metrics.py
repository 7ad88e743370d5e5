"""The control plane's metric families (the port's copy of the families of
odh_kubeflow_tpu/runtime/metrics.py that its store, client, webhook
dispatcher, workqueue, controllers, informers and replica autoscaler emit),
registered in the port's one registry, `utils.metrics.global_registry`,
which this module re-exports."""
from __future__ import annotations

from ..utils.metrics import Counter, Gauge, Histogram, Registry, global_registry

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "global_registry"]

watch_restarts_total = global_registry.counter(
    "informer_watch_restarts_total",
    "Watch streams re-established after a drop, by kind",
    labels=("kind",),
)
relists_total = global_registry.counter(
    "informer_relists_total",
    "Full relist+diff recoveries (410 Expired resume), by kind",
    labels=("kind",),
)
client_retries_total = global_registry.counter(
    "client_retries_total",
    "Client-side request retries, by cause (429 throttle, ...)",
    labels=("cause",),
)
webhook_dispatch_failures_total = global_registry.counter(
    "webhook_dispatch_failures_total",
    "Admission webhook callout failures, by the failurePolicy applied",
    labels=("policy",),
)
fenced_writes_total = global_registry.counter(
    "fenced_writes_total",
    "Writes refused by leader-election fencing (lease not held)",
)

# sub-ms low end: a sim-mode reconcile dequeues and completes in tens of
# microseconds
_QUEUE_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1,
                  0.5, 1, 5, 10, 30, 60)

workqueue_depth = global_registry.gauge(
    "workqueue_depth",
    "Items currently waiting in the workqueue, by queue name",
    labels=("name",),
)
workqueue_adds_total = global_registry.counter(
    "workqueue_adds_total",
    "Items enqueued (dedup'd re-adds excluded), by queue name",
    labels=("name",),
)
workqueue_queue_duration_seconds = global_registry.histogram(
    "workqueue_queue_duration_seconds",
    "How long an item waits in the queue before a worker picks it up",
    labels=("name",),
    buckets=_QUEUE_BUCKETS,
)
workqueue_retries_total = global_registry.counter(
    "workqueue_retries_total",
    "Delayed re-adds (backoff/RequeueAfter) into the workqueue, by queue name",
    labels=("name",),
)
reconcile_duration_seconds = global_registry.histogram(
    "controller_reconcile_duration_seconds",
    "Wall-clock per reconcile invocation, by controller",
    labels=("controller",),
    buckets=_QUEUE_BUCKETS,
)
reconcile_total = global_registry.counter(
    "controller_reconcile_total",
    "Reconcile results (success | requeue | requeue_after | error), by controller",
    labels=("controller", "result"),
)
reconcile_errors_total = global_registry.counter(
    "controller_reconcile_errors_total",
    "Reconciles that raised, by controller",
    labels=("controller",),
)
informer_synced = global_registry.gauge(
    "informer_synced",
    "Whether the informer cache has completed its initial sync (1/0), by kind",
    labels=("kind",),
)
informer_last_sync_timestamp_seconds = global_registry.gauge(
    "informer_last_sync_timestamp_seconds",
    "Unix time the informer cache last (re)synced (initial sync or relist), by kind",
    labels=("kind",),
)
informer_cache_sync_age_seconds = global_registry.gauge(
    "informer_cache_sync_age_seconds",
    "Seconds since the informer cache last (re)synced, by kind (set at scrape "
    "by the manager's collector)",
    labels=("kind",),
)

# SLO-burn replica autoscaler (runtime/autoscaler.py)
autoscaler_decisions_total = global_registry.counter(
    "autoscaler_decisions_total",
    "Autoscaler decisions per tick per endpoint: up (burn/queue pressure), "
    "down (stabilized below half target), park (scale-to-zero idle), hold",
    labels=("action",),
)
endpoint_desired_replicas_gauge = global_registry.gauge(
    "inference_endpoint_desired_replicas",
    "Fleet size the autoscaler currently wants per endpoint (the "
    "desired-replicas annotation the endpoint controller converges toward)",
    labels=("endpoint",),
)
