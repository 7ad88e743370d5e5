"""Batch-job metric families (the port's copy of
odh_kubeflow_tpu/runtime/jobmetrics.py) — the judgement surface of the
gang-scheduled TPUJob class.

These register into the global registry at import, so a manager that never
loads the workload libraries still exposes them. The job controller
(controllers/job.py) feeds them. The families keep the reference's `tpu_`
names, so one set of dashboards and SLO rules reads both packages.
"""
from __future__ import annotations

from .metrics import global_registry

tpu_job_queue_wait_seconds = global_registry.histogram(
    "tpu_job_queue_wait_seconds",
    "Per-episode queue wait: job submit (or requeue) -> gang admission "
    "(all slices secured, workload created)",
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0,
             1800.0),
)
tpu_job_completion_seconds = global_registry.histogram(
    "tpu_job_completion_seconds",
    "First submit -> Succeeded wallclock per job, every preempt-requeue "
    "round trip included",
    buckets=(0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0, 1800.0, 7200.0),
)
tpu_jobs_total = global_registry.counter(
    "tpu_jobs_total",
    "Jobs reaching a terminal state, by result (succeeded / failed) — the "
    "job-completion SLO's good/total ratio",
    labels=("result",),
)
tpu_job_preemptions_total = global_registry.counter(
    "tpu_job_preemptions_total",
    "Checkpoint-preempt-requeue round trips, by cause (reclaim = the "
    "oversubscription reclaimer took the slice; host-loss = GPU host "
    "preemption/readiness lost mid-run; user = operator-requested)",
    labels=("cause",),
)
tpu_job_requeues_total = global_registry.counter(
    "tpu_job_requeues_total",
    "Preempted -> Pending requeues (each resumes from the saved step)",
)
tpu_job_goodput_ratio = global_registry.gauge(
    "tpu_job_goodput_ratio",
    "Cumulative productive step-time / wallclock across completed jobs: "
    "run-seconds whose progress survived (banked at checkpoint acks) over "
    "submit->terminal wall time — queue waits, preemption round trips, and "
    "progress lost since the last checkpoint all burn the ratio",
)

# the cumulative accumulators behind the gauge live in the fleet accounting
# ledger (one accounting source of truth): this module keeps the public
# family and call surface, the ledger supplies the locking and
# `reset_for_test()`
from .accounting import job_goodput as _ledger  # noqa: E402

_ledger.bind_gauge(tpu_job_goodput_ratio)


def record_job_outcome(productive_s: float, wall_s: float) -> None:
    """One terminal job's contribution to the cumulative goodput ratio."""
    _ledger.record(productive_s, wall_s)


def reset_for_test() -> None:
    """Zero the cumulative goodput ledger AND its gauge — isolation between
    back-to-back runs in one process."""
    _ledger.reset_for_test()
