"""The admitted card demand of the three workload classes (the port's copy
of `admitted_chip_demand` from odh_kubeflow_tpu/controllers/suspend.py).

The job reconciler's budget gate reads this (controllers/job.py
`_admitted_chips_with`). The rest of the reference module — the
checkpoint-before-evict `SuspendResumeController`, the oversubscription
reclaimer that shares this budget math, and the prewarmer's manager wiring
— comes with the suspend controller's port.
"""
from __future__ import annotations

import logging

from ..api.inference import InferenceEndpoint
from ..api.job import TPUJob
from ..api.notebook import Notebook
from ..gpu import plan_slice
from . import constants as C
from .inference import STATE_TERMINATED as EP_STATE_TERMINATED
from .job import (
    STATE_ADMITTED as JOB_STATE_ADMITTED,
    STATE_CHECKPOINTING as JOB_STATE_CHECKPOINTING,
    STATE_RUNNING as JOB_STATE_RUNNING,
    job_gangs,
)

log = logging.getLogger(__name__)


def admitted_chip_demand(client, exclude_job: str = "") -> int:
    """Total admitted card demand across ALL THREE workload classes —
    notebooks (active + suspended), non-Terminated endpoints, and ADMITTED
    jobs (Admitted/Running/Checkpointing; Pending and Preempted jobs
    re-pass the job controller's own budget gate at (re)admission before
    their demand stands, so a queue of never-admitted jobs cannot block
    notebook reclaim). The ONE budget math the reclaimer's gate and the
    job controller's queued-over-budget admission share; `exclude_job`
    (ns/name) lets the job controller count its own gangs exactly once."""
    total = 0
    for cand in client.list(Notebook):
        if cand.spec.tpu is None or not cand.spec.tpu.accelerator:
            continue
        if cand.metadata.deletion_timestamp:
            continue
        try:
            total += plan_slice(
                cand.spec.tpu.accelerator,
                cand.spec.tpu.topology,
                cand.spec.tpu.chips,
            ).chips
        except Exception as e:
            # a junk spec must not crash the budget math, but it must be
            # visible — an unplannable notebook holds zero budget
            log.debug(
                "budget math: skipping unplannable %s/%s: %s",
                cand.metadata.namespace, cand.metadata.name, e,
            )
            continue
    # the second workload class holds budget too: an admitted endpoint
    # is card demand exactly like a notebook (Terminated ones released
    # their slice and dropped out of the demand picture)
    from .inference import resolve_endpoint_tpu

    for ep in client.list(InferenceEndpoint):
        if ep.metadata.deletion_timestamp:
            continue
        if (
            ep.metadata.annotations.get(C.INFERENCE_STATE_ANNOTATION)
            == EP_STATE_TERMINATED
        ):
            continue
        tpu = resolve_endpoint_tpu(client, ep)
        if tpu is None:
            continue
        try:
            total += plan_slice(
                tpu.accelerator, tpu.topology, tpu.chips
            ).chips
        except Exception as e:
            log.debug(
                "budget math: skipping unplannable endpoint %s/%s: %s",
                ep.metadata.namespace, ep.metadata.name, e,
            )
            continue
    # ...and the third: every gang of every ADMITTED job. Pending and
    # Preempted jobs pass through the job controller's own budget gate
    # (again, at requeue) before their demand stands — counting them here
    # would let a queue of never-admitted jobs block notebook reclaim.
    for job in client.list(TPUJob):
        if job.metadata.deletion_timestamp:
            continue
        key = f"{job.metadata.namespace}/{job.metadata.name}"
        if exclude_job and key == exclude_job:
            continue
        if job.metadata.annotations.get(C.JOB_STATE_ANNOTATION, "") not in (
            JOB_STATE_ADMITTED, JOB_STATE_RUNNING, JOB_STATE_CHECKPOINTING,
        ):
            continue
        try:
            total += sum(shape.chips for _, shape in job_gangs(job))
        except Exception as e:
            log.debug(
                "budget math: skipping unplannable job %s/%s: %s",
                job.metadata.namespace, job.metadata.name, e,
            )
            continue
    return total
