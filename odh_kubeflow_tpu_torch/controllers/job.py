"""TPUJob reconciler: gang-scheduled batch/RL workloads (the port's copy of
odh_kubeflow_tpu/controllers/job.py, on GPU slices).

The third workload class: Podracer-style batch/RL training jobs (anakin: one
SPMD gang; sebulba: a split actor-gang + learner-gang co-scheduled
atomically) contending for the same cards as the interactive fleet and the
serving endpoints. The reconciler reuses the notebook stack end to end —
StatefulSet + headless per-host Service for gang DNS, the GPU scheduler's
gang placement and claimed-pool reservations, the warm slice pool, the probe
agent's /tpu/* surface — rather than growing a parallel batch stack. A
gang's pod fields (replicas, the node selector with the pool's slice shape,
the `nvidia.com/gpu` toleration, requests and limits, the torchrun env) come
from `gpu.apply_slice`, the notebook path's one rendering rule.

State machine (annotation-durable like suspend/repair/inference; declared
as data in analysis/machines.py, which INVCHECK's transition invariant
judges):

    Pending ("") ──gangs secured──> Admitted ──all hosts ready──> Running
         ^                             │ preempt                     │ cadence
         │ requeue                     v                             v
         └──────────────────────── Preempted <──preempt── Checkpointing
                                       ^                     │ acked
              host loss / reclaim ─────┘       Running <─────┤
                                                             └─> Succeeded
    Running ──backoffLimit / maxRuntime──> Failed (terminal, incident)

- **Admission is all-or-nothing gang placement.** Pending secures EVERY
  gang before anything is created: matching warm slices are claimed first
  (a suspended notebook's released slice is a batch job's fast start), the
  rest must have whole free slices. A sebulba job claims BOTH gangs
  atomically or neither — a half-placed split job would deadlock against
  another half-placed one. Demand over the card budget queues with a
  `QueuedOverBudget` condition instead of reclaiming anything.
- **Preemption is checkpoint-first.** A preempt request
  (`preempt-requested`, stamped by a user or by the oversubscription
  reclaimer) is answered with a bounded Checkpointing window; the acked
  step is recorded, the job parks `Preempted` and requeues — it resumes
  from the saved step, losing only progress since the last checkpoint.
- **Host preemption is survived the same way.** Lost readiness mid-Running
  parks the job Preempted and requeues; the slice-repair controller never
  touches jobs, so there is no machine fight by construction. Unexplained
  interruptions charge `backoffLimit`; reclaim-driven preemptions never do.
- **Progress is checkpoint acks.** The workload reports its step counter
  through the /tpu/checkpoint ack (probe/agent.py; a job pod run as
  processes forwards it to its worker, probe/behavior.py); the cadence
  window banks productive run-seconds (the `tpu_job_goodput_ratio`
  numerator) and the job Succeeds when the acked step reaches steps x
  completions.
"""
from __future__ import annotations

import json
import logging
import time
from typing import Dict, List, Optional, Tuple

from ..api.apps import StatefulSet
from ..api.core import (
    Container,
    Node,
    Pod,
    Service,
    ServicePort,
    emit_deduped_event,
)
from ..api.job import LAYOUT_SEBULBA, TPUJob
from ..api.notebook import TPUStatus
from ..apimachinery import (
    AlreadyExistsError,
    NotFoundError,
    parse_time,
    rfc3339_precise,
    sanitize_name,
)
from ..cluster.client import retry_on_conflict
from ..cluster.slicepool import POOL_STATE_ANNOTATION, SlicePool
from ..runtime import jobmetrics as JM
from ..runtime.controller import Request, Result
from ..runtime.flightrecorder import recorder
from ..runtime.manager import Manager
from ..gpu import (
    GKE_GPU_ACCELERATOR_LABEL,
    GKE_NODEPOOL_LABEL,
    GPU_TOPOLOGY_LABEL,
    SliceShape,
    apply_slice,
    plan_slice,
)
from ..utils import tracing
from ..utils.tracing import record_span
from . import constants as C
from .conditions import upsert_condition
from .config import Config
from .culling import HTTPGet, _default_http_get

log = logging.getLogger(__name__)

# annotation values of the job machine ("" = Pending)
STATE_ADMITTED = "admitted"
STATE_RUNNING = "running"
STATE_CHECKPOINTING = "checkpointing"
STATE_PREEMPTED = "preempted"
STATE_SUCCEEDED = "succeeded"
STATE_FAILED = "failed"


def job_priority(job: TPUJob) -> int:
    """Reclaim ordering for jobs: spec.tpu.priority, with the unset default
    BELOW interactive notebooks (JOB_DEFAULT_PRIORITY) — contention
    suspends batch before it ever touches a user's session."""
    if job.spec.tpu is not None:
        try:
            explicit = int(job.spec.tpu.priority)
        except (TypeError, ValueError):
            explicit = 0
        if explicit:
            return explicit
    return C.JOB_DEFAULT_PRIORITY


def job_gangs(job: TPUJob) -> List[Tuple[str, SliceShape]]:
    """The job's gang layout as (gang name, slice shape) pairs: anakin is
    one learner gang; sebulba adds the actor gang with its OWN topology.
    Shared with the reclaimer's shape matching and the budget math."""
    gangs: List[Tuple[str, SliceShape]] = []
    if job.spec.tpu is not None and job.spec.tpu.accelerator:
        gangs.append((C.JOB_GANG_LEARNER, plan_slice(
            job.spec.tpu.accelerator, job.spec.tpu.topology,
            job.spec.tpu.chips,
        )))
    if job.spec.layout == LAYOUT_SEBULBA and job.spec.actors is not None \
            and job.spec.actors.accelerator:
        gangs.append((C.JOB_GANG_ACTORS, plan_slice(
            job.spec.actors.accelerator, job.spec.actors.topology,
            job.spec.actors.chips,
        )))
    return gangs


def job_target_step(job: TPUJob) -> int:
    """The acked step at which the job is done: the step budget runs
    `completions` times."""
    return max(1, int(job.spec.steps)) * max(1, int(job.spec.completions))


def job_statefulset_name(name: str, gang: str) -> str:
    return sanitize_name(f"{name}-{gang}", max_len=52)


def job_hosts_service_name(name: str, gang: str) -> str:
    return sanitize_name(f"{name}-{gang}-hosts", max_len=63)


class TPUJobReconciler:
    def __init__(
        self,
        manager: Manager,
        config: Optional[Config] = None,
        http_get: Optional[HTTPGet] = None,
    ):
        self.manager = manager
        self.client = manager.client
        self.api_reader = manager.api_reader
        self.config = config or Config()
        self.http_get = http_get or _default_http_get
        self.pool = SlicePool(manager.client, reader=manager.api_reader)
        # in-memory only (the durable machine lives in annotations):
        # per-episode checkpoint acks (ordinal -> acked step); re-derivable
        self._ckpt_acked: Dict[str, Dict[int, Optional[int]]] = {}
        # requeued job -> when its preempted gang's last pod was first seen
        # gone (the requeue backoff runs from there)
        self._gang_gone_at: Dict[str, float] = {}

    def setup(self) -> None:
        def pod_is_job(ev: str, obj: dict, old: Optional[dict]) -> bool:
            return C.JOB_NAME_LABEL in obj.get("metadata", {}).get(
                "labels", {}
            )

        def map_pod(obj: dict) -> List[tuple]:
            meta = obj.get("metadata", {})
            name = meta.get("labels", {}).get(C.JOB_NAME_LABEL)
            return [(meta.get("namespace", ""), name)] if name else []

        (
            self.manager.builder("tpu-job")
            .for_(TPUJob)
            .owns(StatefulSet)
            .owns(Service)
            .watches(Pod, map_pod, predicate=pod_is_job)
            .with_workers(self.config.max_concurrent_reconciles)
            .complete(self.reconcile)
        )

    # ---------- reconcile ----------

    def reconcile(self, req: Request) -> Optional[Result]:
        try:
            job = self.api_reader.get(TPUJob, req.namespace, req.name)
        except NotFoundError:
            self._release_claims(req.key, back_to_warm=True)
            self._ckpt_acked.pop(req.key, None)
            self._gang_gone_at.pop(req.key, None)
            tracing.discard_root_for(f"job:{req.key}")
            return None
        if job.metadata.deletion_timestamp:
            self._release_claims(req.key, back_to_warm=True)
            self._ckpt_acked.pop(req.key, None)
            self._gang_gone_at.pop(req.key, None)
            tracing.discard_root_for(f"job:{req.key}")
            return None

        gangs = job_gangs(job)
        if not gangs:
            self._emit_event(
                job, "JobInvalid",
                "no TPU spec: set spec.tpu (and spec.actors for "
                "layout=sebulba) to shape the gang(s)",
            )
            return None
        if job.spec.layout == LAYOUT_SEBULBA and len(gangs) < 2:
            self._emit_event(
                job, "JobInvalid",
                "layout=sebulba needs spec.actors: the split actor gang has "
                "no shape to co-schedule",
            )
            return None

        self._ensure_trace_root(job)
        ann = job.metadata.annotations
        state = ann.get(C.JOB_STATE_ANNOTATION, "")
        now = time.time()

        if state == STATE_PREEMPTED:
            # requeue: a fresh Pending episode resumes from the saved step.
            # The saved checkpoint step SURVIVES the clear — it is the whole
            # point of checkpoint-preempt-requeue.
            preemptions = self._int_ann(job, C.JOB_PREEMPTIONS_ANNOTATION) + 1
            self._patch_annotations(
                job,
                {
                    C.JOB_STATE_ANNOTATION: None,
                    C.JOB_PREEMPT_ANNOTATION: None,
                    C.JOB_ADMITTED_AT_ANNOTATION: None,
                    C.JOB_RUN_STARTED_AT_ANNOTATION: None,
                    C.JOB_CHECKPOINT_DEADLINE_ANNOTATION: None,
                    C.JOB_EPISODE_QUEUED_AT_ANNOTATION: rfc3339_precise(now),
                    C.JOB_PREEMPTIONS_ANNOTATION: str(preemptions),
                },
            )
            JM.tpu_job_requeues_total.inc()
            self._emit_event(
                job, "JobRequeued",
                f"requeued after preemption #{preemptions}: will resume "
                f"from checkpoint step "
                f"{ann.get(C.JOB_CHECKPOINT_STEP_ANNOTATION, '0')}",
                etype="Normal",
            )
            recorder.record(
                "transition", machine="job", job=req.key, state="pending",
                from_state=STATE_PREEMPTED, preemptions=preemptions,
            )
            record_span(
                "job.requeue",
                traceparent=ann.get(C.TRACEPARENT_ANNOTATION),
                job=job.metadata.name, namespace=job.metadata.namespace,
                resume_step=ann.get(C.JOB_CHECKPOINT_STEP_ANNOTATION, "0"),
            )
            return Result(requeue_after=0.02)
        if state in (STATE_SUCCEEDED, STATE_FAILED):
            if job.metadata.generation and job.status.phase and \
                    job.metadata.generation != job.status.observed_generation:
                # spec bump after a terminal state: user rerun/self-heal —
                # a fresh Pending episode re-converges level-triggered
                self._patch_annotations(
                    job,
                    {
                        C.JOB_STATE_ANNOTATION: None,
                        C.JOB_CHECKPOINT_STEP_ANNOTATION: None,
                        C.JOB_FAILURES_ANNOTATION: None,
                        C.JOB_PREEMPTIONS_ANNOTATION: None,
                        C.JOB_RUN_SECONDS_ANNOTATION: None,
                        C.JOB_QUEUED_AT_ANNOTATION: None,
                        C.JOB_EPISODE_QUEUED_AT_ANNOTATION: None,
                        C.JOB_FIRST_ADMITTED_AT_ANNOTATION: None,
                    },
                )
                recorder.record(
                    "transition", machine="job", job=req.key,
                    state="pending", from_state=state, reason="rerun",
                )
                return Result(requeue_after=0.02)
            # parked terminal: keep replicas at 0, nothing else to converge
            self._reconcile_workloads(job, gangs, replicas=0)
            self._mirror_status(
                job, gangs,
                phase="Succeeded" if state == STATE_SUCCEEDED else "Failed",
            )
            return None
        if state == "":
            return self._run_pending(job, gangs, now, req)
        if state == STATE_ADMITTED:
            return self._run_admitted(job, gangs, now, req)
        if state == STATE_RUNNING:
            return self._run_running(job, gangs, now, req)
        if state == STATE_CHECKPOINTING:
            return self._run_checkpoint_window(job, gangs, now, req)
        log.warning("unknown job state %r on %s; clearing", state, req.key)
        self._patch_annotations(job, {C.JOB_STATE_ANNOTATION: None})
        return Result(requeue_after=0.05)

    # ---------- Pending: all-or-nothing gang admission ----------

    def _run_pending(
        self, job: TPUJob, gangs: List[Tuple[str, SliceShape]], now: float,
        req: Request,
    ) -> Optional[Result]:
        ann = job.metadata.annotations
        if C.JOB_QUEUED_AT_ANNOTATION not in ann:
            self._patch_annotations(
                job,
                {
                    C.JOB_QUEUED_AT_ANNOTATION: rfc3339_precise(now),
                    C.JOB_EPISODE_QUEUED_AT_ANNOTATION: rfc3339_precise(now),
                },
            )
            return Result(requeue_after=0.01)
        self._mirror_status(job, gangs, phase="Pending")

        # requeue backoff: a just-preempted job re-admitting instantly would
        # race the very requester its slice was reclaimed for. It runs from
        # the preempted gang's last pod gone, not from the requeue (the
        # reference's): a pod of processes stops gracefully for seconds, and
        # until its object goes the requester's pod cannot bind there, while
        # a free-slice search that skips terminating pods would see the
        # slice free and take it back first
        backoff = self.config.job_requeue_backoff_s
        if backoff > 0 and self._int_ann(job, C.JOB_PREEMPTIONS_ANNOTATION):
            if self.api_reader.list(Pod, namespace=job.metadata.namespace,
                                    labels={C.JOB_NAME_LABEL: job.metadata.name}):
                self._gang_gone_at.pop(req.key, None)
                return Result(requeue_after=max(
                    0.02, self.config.readiness_probe_period_s / 2
                ))
            queued = max(
                self._time_ann(job, C.JOB_EPISODE_QUEUED_AT_ANNOTATION, now),
                self._gang_gone_at.setdefault(req.key, now),
            )
            if now - queued < backoff:
                return Result(requeue_after=max(
                    0.02, backoff - (now - queued)
                ))

        # over-budget demand queues with a condition — reclaiming to serve
        # demand the operator never admitted would cascade suspensions
        budget = self.config.chip_budget
        if budget > 0 and self._admitted_chips_with(job, gangs) > budget:
            if self._set_queued_condition(
                job, "True", "ChipBudget",
                f"admitted chip demand exceeds the chip budget ({budget}); "
                "queued without reclaim",
            ):
                self._emit_event(
                    job, "JobQueuedOverBudget",
                    f"total admitted chip demand exceeds the chip budget "
                    f"({budget}); queued",
                )
            return Result(requeue_after=max(
                1.0, self.config.reclaim_pending_grace_s
            ))

        secured, claims = self._secure_gangs(job, gangs, req.key)
        if not secured:
            # atomicity: whatever was claimed this pass went back warm in
            # _secure_gangs; wait for capacity (write-free, so a queued job
            # quiesces instead of churning the store)
            self._set_queued_condition(
                job, "True", "WaitingForCapacity",
                "not every gang could be secured (no matching warm slice "
                "and no whole free slice); queued",
            )
            return Result(requeue_after=max(
                0.1, self.config.reclaim_pending_grace_s
            ))

        self._set_queued_condition(job, "False", "Admitted", "")
        self._gang_gone_at.pop(req.key, None)
        # pin the episode's resume step BEFORE the template is generated —
        # the template env reads it, and it must not move again until the
        # next admission (a live value would roll the gang mid-run)
        resume_step = job.metadata.annotations.get(
            C.JOB_CHECKPOINT_STEP_ANNOTATION, "0"
        )
        job.metadata.annotations[C.JOB_RESUME_STEP_ANNOTATION] = resume_step
        self._reconcile_workloads(job, gangs, replicas=None)
        episode_queued = self._time_ann(
            job, C.JOB_EPISODE_QUEUED_AT_ANNOTATION, now
        )
        JM.tpu_job_queue_wait_seconds.observe(max(0.0, now - episode_queued))
        admitted_updates = {
            C.JOB_STATE_ANNOTATION: STATE_ADMITTED,
            C.JOB_ADMITTED_AT_ANNOTATION: rfc3339_precise(now),
            C.JOB_RESUME_STEP_ANNOTATION: resume_step,
        }
        if C.JOB_FIRST_ADMITTED_AT_ANNOTATION not in job.metadata.annotations:
            # the maxRuntime clock: starts at the FIRST admission and
            # survives requeues (queue wait before it is free)
            admitted_updates[C.JOB_FIRST_ADMITTED_AT_ANNOTATION] = (
                rfc3339_precise(now)
            )
            job.metadata.annotations[C.JOB_FIRST_ADMITTED_AT_ANNOTATION] = (
                admitted_updates[C.JOB_FIRST_ADMITTED_AT_ANNOTATION]
            )
        self._patch_annotations(job, admitted_updates)
        warm_gangs = sorted(claims)
        self._emit_event(
            job, "JobAdmitted",
            f"admitted: {len(gangs)} gang(s) secured "
            + (f"(warm claim: {', '.join(warm_gangs)})" if warm_gangs
               else "(cold placement)")
            + f"; resuming from step "
              f"{job.metadata.annotations.get(C.JOB_CHECKPOINT_STEP_ANNOTATION, '0')}",
            etype="Normal",
        )
        recorder.record(
            "transition", machine="job", job=req.key, state=STATE_ADMITTED,
            warm_gangs=warm_gangs,
        )
        record_span(
            "job.admit",
            traceparent=job.metadata.annotations.get(C.TRACEPARENT_ANNOTATION),
            job=job.metadata.name, namespace=job.metadata.namespace,
            warm_gangs=",".join(warm_gangs) or "none",
            queue_wait_s=round(max(0.0, now - episode_queued), 3),
        )
        log.info("job %s admitted (%s)", req.key,
                 f"warm: {warm_gangs}" if warm_gangs else "cold")
        return Result(requeue_after=0.02)

    def _secure_gangs(
        self, job: TPUJob, gangs: List[Tuple[str, SliceShape]], key: str
    ) -> Tuple[bool, Dict[str, str]]:
        """Secure EVERY gang — warm claim first, whole free slices second —
        or nothing: partial claims made this pass are released back warm
        (sebulba both-or-neither). Returns (secured, {gang: claimed pool}).

        Free slices are reserved THROUGH the pool too: the pool is parked
        warm (priority 0, the prewarm idiom) and then claimed under the
        job's key via the lead-node CAS — so two Pending jobs counting the
        same free slice resolve at the CAS, not at pod-bind time. A bare
        free-count check here would be check-then-act: both jobs admit,
        one gang never binds, and a pair of sebulba jobs reproduces
        exactly the half-placed deadlock admission exists to prevent."""
        claims: Dict[str, str] = {}
        claimed_entries = []
        # a restart mid-admission may already hold claims: match them to
        # gangs by shape instead of claiming twice
        held = [
            e for e in self.pool.entries(include_unhealthy=True)
            if e.claimed_by == key
        ]
        unsecured: List[Tuple[str, SliceShape]] = []
        for gang, shape in gangs:
            prior = next(
                (e for e in held
                 if e.accelerator == shape.gke_accelerator
                 and e.topology == shape.topology),
                None,
            )
            if prior is not None:
                held.remove(prior)
                claims[gang] = prior.pool
                # prior-pass claims unwind with this pass's on failure: a
                # crash-mid-admission must not leave a queued job pinning a
                # claimed slice forever (two such sebulba jobs holding each
                # other's needed shape would deadlock permanently)
                claimed_entries.append(prior)
                continue
            entry = self.pool.claim(shape.gke_accelerator, shape.topology, key)
            if entry is not None:
                claims[gang] = entry.pool
                claimed_entries.append(entry)
            else:
                unsecured.append((gang, shape))
        # the rest need whole free slices, distinct per gang: park-then-CAS
        # each one; a raced pool just means try the next
        parked_here: set = set()
        for gang, shape in unsecured:
            entry = None
            for pool_name, nodes in sorted(self._free_pools(
                shape.gke_accelerator, shape.topology
            ).items()):
                if not self.pool.release(pool_name, nodes, priority=0):
                    continue  # node raced away mid-park; try the next pool
                parked_here.add(pool_name)
                entry = self.pool.claim(
                    shape.gke_accelerator, shape.topology, key
                )
                if entry is not None:
                    break
                # a rival claimed the slice we just parked: it is theirs
                # now; keep walking the remaining free pools
            if entry is None:
                for e in claimed_entries:  # unwind: all-or-nothing
                    if e.pool in parked_here:
                        # free capacity we parked ourselves this pass goes
                        # BACK to general capacity — left warm it would
                        # block cold creates until an idle-reclaim
                        self.pool.unclaim(e.pool)
                    else:
                        self.pool.release(e.pool, e.nodes,
                                          priority=e.priority)
                return False, {}
            claims[gang] = entry.pool
            claimed_entries.append(entry)
        return True, claims

    def _free_pools(
        self, gke_accelerator: str, topology: str
    ) -> Dict[str, List[str]]:
        """Whole healthy, unreserved, unoccupied pools of one shape (pool
        name -> node names) — a gang-placeable slice the scheduler can
        bind. Read from the store, not the cache (the reference's): a pod
        cache that has not yet seen a notebook's pod bound showed its slice
        free, the job parked and claimed it under that pod, and the
        notebook's suspend then released the slice warm over the claim,
        leaving the job Admitted on a slice its gang could never bind."""
        occupied = {
            p.spec.node_name
            for p in self.api_reader.list(Pod)
            if p.spec.node_name and not p.metadata.deletion_timestamp
        }
        pools: Dict[str, List[Node]] = {}
        for node in self.api_reader.list(Node):
            labels = node.metadata.labels
            if labels.get(GKE_GPU_ACCELERATOR_LABEL) != gke_accelerator:
                continue
            if labels.get(GPU_TOPOLOGY_LABEL) != topology:
                continue
            pools.setdefault(
                labels.get(GKE_NODEPOOL_LABEL, node.metadata.name), []
            ).append(node)
        out: Dict[str, List[str]] = {}
        for pool, nodes in sorted(pools.items()):
            if all(
                n.metadata.name not in occupied
                and not n.metadata.annotations.get(POOL_STATE_ANNOTATION)
                and self.pool.node_healthy(n)
                for n in nodes
            ):
                out[pool] = [n.metadata.name for n in nodes]
        return out

    def _admitted_chips_with(
        self, job: TPUJob, gangs: List[Tuple[str, SliceShape]]
    ) -> int:
        """Total admitted chip demand INCLUDING this job's gangs — the
        budget gate; notebooks/endpoints/other jobs counted by the shared
        reclaimer math (controllers/suspend.py admitted_chip_demand)."""
        from .suspend import admitted_chip_demand

        my_key = f"{job.metadata.namespace}/{job.metadata.name}"
        return admitted_chip_demand(self.client, exclude_job=my_key) + sum(
            shape.chips for _, shape in gangs
        )

    # ---------- Admitted ----------

    def _run_admitted(
        self, job: TPUJob, gangs: List[Tuple[str, SliceShape]], now: float,
        req: Request,
    ) -> Optional[Result]:
        if C.JOB_PREEMPT_ANNOTATION in job.metadata.annotations:
            # nothing running yet: nothing to checkpoint, just park
            return self._preempt(job, gangs, now, req)
        # bind timeout: a claimed slice can still die under the gang mid-
        # bind (host loss sweeps the claim, pods stay unschedulable) — park
        # and requeue instead of wedging in Admitted forever
        bind_window = self.config.job_admission_timeout_s
        admitted_at = self._time_ann(job, C.JOB_ADMITTED_AT_ANNOTATION, now)
        if bind_window > 0 and now - admitted_at > bind_window \
                and not self._gangs_ready(job, gangs):
            self._patch_annotations(
                job, {C.JOB_PREEMPT_ANNOTATION: "bind-timeout"}
            )
            job.metadata.annotations[C.JOB_PREEMPT_ANNOTATION] = (
                "bind-timeout"
            )
            self._emit_event(
                job, "JobBindTimeout",
                f"gang(s) secured but not every host bound within "
                f"{bind_window:.0f}s; requeueing",
            )
            return self._preempt(job, gangs, now, req)
        self._reconcile_workloads(job, gangs, replicas=None)
        self._mirror_status(job, gangs, phase="Admitted")
        if self._gangs_ready(job, gangs):
            # bind window over: the slices are plainly owned by their pods
            self._release_claims(req.key, back_to_warm=False)
            self._patch_annotations(
                job,
                {
                    C.JOB_STATE_ANNOTATION: STATE_RUNNING,
                    C.JOB_RUN_STARTED_AT_ANNOTATION: rfc3339_precise(now),
                },
            )
            self._emit_event(
                job, "JobRunning",
                "every host of every gang ready; steps progressing",
                etype="Normal",
            )
            recorder.record(
                "transition", machine="job", job=req.key, state=STATE_RUNNING,
            )
            if not self._int_ann(job, C.JOB_PREEMPTIONS_ANNOTATION):
                self._close_ready_root(job, now)
            return Result(requeue_after=0.02)
        return Result(requeue_after=max(
            0.05, self.config.readiness_probe_period_s / 2
        ))

    # ---------- Running ----------

    def _run_running(
        self, job: TPUJob, gangs: List[Tuple[str, SliceShape]], now: float,
        req: Request,
    ) -> Optional[Result]:
        ann = job.metadata.annotations
        self._reconcile_workloads(job, gangs, replicas=None)
        self._mirror_status(job, gangs, phase="Running")

        if job.spec.max_runtime_s > 0 and \
                now - self._time_ann(
                    job, C.JOB_FIRST_ADMITTED_AT_ANNOTATION, now
                ) > job.spec.max_runtime_s:
            return self._fail(
                job, gangs, now, req,
                f"maxRuntime ({job.spec.max_runtime_s:.0f}s since first "
                "admission) exceeded",
            )

        if not self._gangs_ready(job, gangs):
            # host preemption / readiness lost mid-run: progress since the
            # last checkpoint is gone — park, requeue, resume from the save.
            # Unexplained losses (no preempt notice) charge backoffLimit.
            if C.JOB_PREEMPT_ANNOTATION not in ann:
                failures = self._int_ann(job, C.JOB_FAILURES_ANNOTATION) + 1
                if failures > max(0, int(job.spec.backoff_limit)):
                    return self._fail(
                        job, gangs, now, req,
                        f"backoffLimit ({job.spec.backoff_limit}) exhausted: "
                        f"{failures} unexplained interruptions",
                    )
                self._patch_annotations(
                    job, {C.JOB_FAILURES_ANNOTATION: str(failures)}
                )
            return self._preempt(job, gangs, now, req)

        if C.JOB_PREEMPT_ANNOTATION in ann or self._cadence_due(job, now):
            window = self.config.job_checkpoint_window_s
            self._ckpt_acked.pop(req.key, None)
            self._patch_annotations(
                job,
                {
                    C.JOB_STATE_ANNOTATION: STATE_CHECKPOINTING,
                    C.JOB_CHECKPOINT_DEADLINE_ANNOTATION: (
                        rfc3339_precise(now + window)
                    ),
                },
            )
            recorder.record(
                "transition", machine="job", job=req.key,
                state=STATE_CHECKPOINTING,
                preempt=C.JOB_PREEMPT_ANNOTATION in ann,
            )
            return Result(requeue_after=0.01)
        period = max(0.05, job.spec.checkpoint_period_s)
        started = self._time_ann(job, C.JOB_RUN_STARTED_AT_ANNOTATION, now)
        return Result(requeue_after=max(
            0.05,
            min(self.config.readiness_probe_period_s,
                started + period - now),
        ))

    def _cadence_due(self, job: TPUJob, now: float) -> bool:
        period = max(0.05, job.spec.checkpoint_period_s)
        started = self._time_ann(job, C.JOB_RUN_STARTED_AT_ANNOTATION, now)
        return now - started >= period

    # ---------- Checkpointing ----------

    def _run_checkpoint_window(
        self, job: TPUJob, gangs: List[Tuple[str, SliceShape]], now: float,
        req: Request,
    ) -> Optional[Result]:
        ann = job.metadata.annotations
        try:
            deadline = parse_time(
                ann.get(C.JOB_CHECKPOINT_DEADLINE_ANNOTATION, "")
            ).timestamp()
        except ValueError:
            deadline = now

        learner_shape = gangs[0][1]
        pods = self._pods(job, C.JOB_GANG_LEARNER)
        ready_ordinals = set()
        for p in pods:
            if not p.is_ready():
                continue
            try:
                ready_ordinals.add(int(p.metadata.name.rsplit("-", 1)[1]))
            except (IndexError, ValueError):
                continue
        acked = self._ckpt_acked.setdefault(req.key, {})
        pending = sorted(ready_ordinals - set(acked))
        if pending and now < deadline:
            urls = self._probe_urls(
                job, C.JOB_GANG_LEARNER, learner_shape, "/tpu/checkpoint"
            )
            for ordinal in pending:
                if ordinal >= len(urls):
                    continue
                ack = self._probe(urls[ordinal])
                if ack and ack.get("saved"):
                    acked[ordinal] = ack.get("step")
        all_acked = bool(ready_ordinals) and ready_ordinals <= set(acked)
        if not (all_acked or not ready_ordinals or now >= deadline):
            return Result(requeue_after=max(
                0.02,
                min(self.config.readiness_probe_period_s, deadline - now),
            ))
        return self._complete_checkpoint(job, gangs, now, req, acked)

    def _complete_checkpoint(
        self, job: TPUJob, gangs: List[Tuple[str, SliceShape]], now: float,
        req: Request, acked: Dict[int, Optional[int]],
    ) -> Optional[Result]:
        """Window closed: bank the save, then continue, finish, or park —
        the one function that decides where a checkpoint leads."""
        ann = job.metadata.annotations
        self._ckpt_acked.pop(req.key, None)
        saved_before = self._int_ann(job, C.JOB_CHECKPOINT_STEP_ANNOTATION)
        steps = [s for s in acked.values() if s is not None]
        # ordinal 0's ack is the canonical step (per-shard saves: digests
        # and steps of different ordinals are not comparable) — fall
        # back to the max only when ordinal 0 never answered
        step = acked.get(0)
        if step is None:
            step = max(steps) if steps else None
        saved = max(saved_before, int(step)) if step is not None \
            else saved_before
        updates: Dict[str, Optional[str]] = {
            C.JOB_CHECKPOINT_DEADLINE_ANNOTATION: None,
        }
        run_s = self._float_ann(job, C.JOB_RUN_SECONDS_ANNOTATION)
        if step is not None:
            updates[C.JOB_CHECKPOINT_STEP_ANNOTATION] = str(saved)
            # productive time banked ONLY when a save landed: progress
            # without a checkpoint does not survive a preemption
            started = self._time_ann(
                job, C.JOB_RUN_STARTED_AT_ANNOTATION, now
            )
            run_s += max(0.0, now - started)
            updates[C.JOB_RUN_SECONDS_ANNOTATION] = f"{run_s:.3f}"
        record_span(
            "job.checkpoint",
            traceparent=ann.get(C.TRACEPARENT_ANNOTATION),
            job=job.metadata.name, namespace=job.metadata.namespace,
            step=saved, hosts_acked=len(acked),
        )

        if C.JOB_PREEMPT_ANNOTATION in ann:
            self._patch_annotations(job, updates)
            for k, v in updates.items():  # keep the in-hand object honest
                if v is None:
                    ann.pop(k, None)
                else:
                    ann[k] = v
            return self._preempt(job, gangs, now, req)

        if step is not None and saved >= job_target_step(job):
            updates[C.JOB_STATE_ANNOTATION] = STATE_SUCCEEDED
            updates[C.JOB_RUN_STARTED_AT_ANNOTATION] = None
            self._patch_annotations(job, updates)
            for k, v in updates.items():  # keep the in-hand object honest
                if v is None:
                    ann.pop(k, None)
                else:
                    ann[k] = v
            self._teardown(job, gangs, req.key, park_warm=True)
            queued = self._time_ann(job, C.JOB_QUEUED_AT_ANNOTATION, now)
            wall = max(0.0, now - queued)
            JM.tpu_jobs_total.inc(result="succeeded")
            JM.tpu_job_completion_seconds.observe(wall)
            JM.record_job_outcome(run_s, wall)
            self._mirror_status(job, gangs, phase="Succeeded")
            self._emit_event(
                job, "JobSucceeded",
                f"completed at step {saved} in {wall:.2f}s "
                f"({run_s:.2f}s productive; "
                f"{self._int_ann(job, C.JOB_PREEMPTIONS_ANNOTATION)} "
                "preemption(s) survived)",
                etype="Normal",
            )
            recorder.record(
                "transition", machine="job", job=req.key,
                state=STATE_SUCCEEDED, step=saved,
                productive_s=round(run_s, 3), wall_s=round(wall, 3),
            )
            record_span(
                "job.run",
                traceparent=ann.get(C.TRACEPARENT_ANNOTATION),
                start_time=queued, end_time=now,
                job=job.metadata.name, namespace=job.metadata.namespace,
                step=saved, productive_s=round(run_s, 3),
            )
            log.info("job %s succeeded at step %d (%.2fs productive / "
                     "%.2fs wall)", req.key, saved, run_s, wall)
            return None

        # cadence checkpoint: keep running, cadence clock re-arms from the
        # ack, not from `now` (read before the probes, which wait for the
        # save: the learner is idle meanwhile, and re-arming at `now` opened
        # the next window one save early)
        updates[C.JOB_STATE_ANNOTATION] = STATE_RUNNING
        updates[C.JOB_RUN_STARTED_AT_ANNOTATION] = rfc3339_precise(time.time())
        self._patch_annotations(job, updates)
        recorder.record(
            "transition", machine="job", job=req.key, state=STATE_RUNNING,
            step=saved, reason="cadence",
        )
        return Result(requeue_after=0.05)

    # ---------- Preempted / Failed ----------

    def _preempt(
        self, job: TPUJob, gangs: List[Tuple[str, SliceShape]], now: float,
        req: Request,
    ) -> Optional[Result]:
        ann = job.metadata.annotations
        reason = ann.get(C.JOB_PREEMPT_ANNOTATION, "")
        reclaim_forced = reason.startswith("capacity-pressure")
        # bounded label set: unknown operator-stamped reasons read as "user"
        cause = (
            "reclaim" if reclaim_forced
            else "bind-timeout" if reason == "bind-timeout"
            else "user" if reason
            else "host-loss"
        )
        # reclaim-forced: the requester needs the cards — general capacity.
        # Anything else parks warm at the JOB's priority: a priority-0 park
        # would make the job's own slice the first idle-reclaim victim,
        # defeating the fast requeue.
        self._teardown(job, gangs, req.key, park_warm=not reclaim_forced)
        self._patch_annotations(
            job,
            {
                C.JOB_STATE_ANNOTATION: STATE_PREEMPTED,
                C.JOB_RUN_STARTED_AT_ANNOTATION: None,
                C.JOB_CHECKPOINT_DEADLINE_ANNOTATION: None,
            },
        )
        JM.tpu_job_preemptions_total.inc(cause=cause)
        self._mirror_status(job, gangs, phase="Preempted")
        self._emit_event(
            job, "JobPreempted",
            f"preempted ({cause}): checkpoint step "
            f"{ann.get(C.JOB_CHECKPOINT_STEP_ANNOTATION, '0')} saved; will "
            "requeue and resume from it",
        )
        recorder.record(
            "transition", machine="job", job=req.key, state=STATE_PREEMPTED,
            cause=cause,
            step=ann.get(C.JOB_CHECKPOINT_STEP_ANNOTATION, "0"),
        )
        record_span(
            "job.preempt",
            traceparent=ann.get(C.TRACEPARENT_ANNOTATION),
            job=job.metadata.name, namespace=job.metadata.namespace,
            cause=cause,
        )
        log.warning("job %s preempted (%s)", req.key, cause)
        return Result(requeue_after=0.05)

    def _fail(
        self, job: TPUJob, gangs: List[Tuple[str, SliceShape]], now: float,
        req: Request, message: str,
    ) -> Optional[Result]:
        self._teardown(job, gangs, req.key, park_warm=True)
        self._patch_annotations(
            job,
            {
                C.JOB_STATE_ANNOTATION: STATE_FAILED,
                C.JOB_RUN_STARTED_AT_ANNOTATION: None,
                C.JOB_CHECKPOINT_DEADLINE_ANNOTATION: None,
            },
        )
        queued = self._time_ann(job, C.JOB_QUEUED_AT_ANNOTATION, now)
        JM.tpu_jobs_total.inc(result="failed")
        JM.record_job_outcome(
            self._float_ann(job, C.JOB_RUN_SECONDS_ANNOTATION),
            max(0.0, now - queued),
        )
        self._mirror_status(job, gangs, phase="Failed")
        self._emit_event(job, "JobFailed", message)
        recorder.record(
            "transition", machine="job", job=req.key, state=STATE_FAILED,
            message=message,
        )
        recorder.snapshot(
            "job-failed", subject=req.key, client=self.client,
            extra={"message": message},
        )
        log.error("job %s FAILED: %s", req.key, message)
        return None

    def _teardown(
        self, job: TPUJob, gangs: List[Tuple[str, SliceShape]], key: str,
        park_warm: bool,
    ) -> None:
        """Scale every gang away and settle the slice pool: bound slices
        release warm at the job's priority (park_warm) or return to general
        capacity; unbound claims always go back warm."""
        pools = self._slice_pools_of(job)
        self._reconcile_workloads(job, gangs, replicas=0)
        if park_warm:
            for pool, nodes in pools.items():
                self.pool.release(pool, nodes, priority=job_priority(job))
        # claims that never bound were warm capacity all along: back to warm
        # (at their prior priority) whatever forced the teardown
        self._release_claims(key, back_to_warm=True)

    # ---------- workload generation ----------

    def generate_statefulset(
        self, job: TPUJob, gang: str, shape: SliceShape, replicas: int
    ) -> StatefulSet:
        sts = StatefulSet()
        sts.metadata.name = job_statefulset_name(job.metadata.name, gang)
        sts.metadata.namespace = job.metadata.namespace
        sts.metadata.labels = {
            C.JOB_NAME_LABEL: job.metadata.name,
            C.JOB_GANG_LABEL: gang,
        }
        sts.spec.replicas = replicas
        sts.spec.selector.match_labels = {
            C.JOB_NAME_LABEL: job.metadata.name,
            C.JOB_GANG_LABEL: gang,
        }
        sts.spec.service_name = job_hosts_service_name(
            job.metadata.name, gang
        )
        sts.spec.pod_management_policy = "Parallel"

        template = sts.spec.template
        template.metadata.labels = {
            C.JOB_NAME_LABEL: job.metadata.name,
            C.JOB_GANG_LABEL: gang,
        }
        template.metadata.annotations = {}
        traceparent = job.metadata.annotations.get(C.TRACEPARENT_ANNOTATION)
        if traceparent:
            template.metadata.annotations[C.TRACEPARENT_ANNOTATION] = (
                traceparent
            )
        template.spec = job.spec.template.spec.deepcopy()
        self._default_container(job, gang, template.spec)
        sts.set_owner(job)
        # the slice's pod fields: the notebook path's rendering rule (the
        # node selector carries the pool's slice shape, so a one-host gang
        # never lands on a multi-host pool's node)
        return StatefulSet.from_dict(apply_slice(
            sts.to_dict(), shape, job.metadata.namespace,
            self.config.cluster_domain, container=job.metadata.name,
        ))

    def _default_container(self, job: TPUJob, gang: str, podspec) -> None:
        """The workload contract's env on the primary container (the one
        named after the job, else the first); the GPU resources and the
        torchrun env are apply_slice's."""
        container: Optional[Container] = None
        for c in podspec.containers:
            if c.name == job.metadata.name:
                container = c
                break
        if container is None:
            if not podspec.containers:
                podspec.containers.append(
                    Container(name=job.metadata.name, image="")
                )
            container = podspec.containers[0]
        # workload contract (the training loop reads these in the pod)
        container.set_env("TPU_JOB_GANG", gang)
        container.set_env("TPU_JOB_STEPS", str(job_target_step(job)))
        # pinned per admission episode (JOB_RESUME_STEP_ANNOTATION): the
        # live checkpoint-step here would roll the gang on every cadence save
        container.set_env(
            "TPU_JOB_RESUME_STEP",
            job.metadata.annotations.get(C.JOB_RESUME_STEP_ANNOTATION, "0"),
        )

    def generate_hosts_service(self, job: TPUJob, gang: str) -> Service:
        svc = Service()
        svc.metadata.name = job_hosts_service_name(job.metadata.name, gang)
        svc.metadata.namespace = job.metadata.namespace
        svc.metadata.labels = {
            C.JOB_NAME_LABEL: job.metadata.name,
            C.JOB_GANG_LABEL: gang,
        }
        svc.spec.cluster_ip = "None"
        svc.spec.selector = {
            C.JOB_NAME_LABEL: job.metadata.name,
            C.JOB_GANG_LABEL: gang,
        }
        svc.spec.ports = [
            ServicePort(name="jax-coordinator", port=8476, target_port=8476),
            ServicePort(name="probe", port=self.config.probe_port,
                        target_port=self.config.probe_port),
        ]
        svc.set_owner(job)
        return svc

    def _reconcile_workloads(
        self, job: TPUJob, gangs: List[Tuple[str, SliceShape]],
        replicas: Optional[int],
    ) -> None:
        """Converge one STS + headless gang-DNS Service per gang; replicas
        None = each gang's host count (the running shape), 0 = scaled away."""
        for gang, shape in gangs:
            desired = self.generate_statefulset(
                job, gang, shape,
                shape.hosts if replicas is None else replicas,
            )

            def attempt(desired=desired):
                try:
                    current = self.api_reader.get(
                        StatefulSet, job.metadata.namespace,
                        desired.metadata.name,
                    )
                except NotFoundError:
                    try:
                        self.client.create(desired)
                    except AlreadyExistsError:
                        pass  # racing reconcile won; level-triggered
                    return
                changed = False
                if current.spec.replicas != desired.spec.replicas:
                    current.spec.replicas = desired.spec.replicas
                    changed = True
                if current.spec.template.to_dict() != \
                        desired.spec.template.to_dict():
                    current.spec.template = desired.spec.template
                    changed = True
                if changed:
                    self.client.update(current)

            retry_on_conflict(attempt)
            svc = self.generate_hosts_service(job, gang)
            try:
                self.client.get(Service, job.metadata.namespace,
                                svc.metadata.name)
            except NotFoundError:
                try:
                    self.client.create(svc)
                except AlreadyExistsError:
                    pass

    # ---------- readiness / probing ----------

    def _pods(self, job: TPUJob, gang: Optional[str] = None) -> List[Pod]:
        labels = {C.JOB_NAME_LABEL: job.metadata.name}
        if gang:
            labels[C.JOB_GANG_LABEL] = gang
        return [
            p
            for p in self.client.list(
                Pod, namespace=job.metadata.namespace, labels=labels
            )
            if not p.metadata.deletion_timestamp
        ]

    def _gangs_ready(
        self, job: TPUJob, gangs: List[Tuple[str, SliceShape]]
    ) -> bool:
        for gang, shape in gangs:
            ready = sum(1 for p in self._pods(job, gang) if p.is_ready())
            if ready < shape.hosts:
                return False
        return True

    def _ready_count(self, job: TPUJob) -> int:
        return sum(1 for p in self._pods(job) if p.is_ready())

    def _probe_urls(
        self, job: TPUJob, gang: str, shape: SliceShape, path: str
    ) -> List[str]:
        sts_name = job_statefulset_name(job.metadata.name, gang)
        svc = job_hosts_service_name(job.metadata.name, gang)
        return [
            f"http://{sts_name}-{i}.{svc}.{job.metadata.namespace}.svc."
            f"{self.config.cluster_domain}:{self.config.probe_port}{path}"
            for i in range(shape.hosts)
        ]

    CHECKPOINT_TIMEOUT_S = 2.0

    def _probe(self, url: str) -> Optional[dict]:
        try:
            try:
                status, body = self.http_get(
                    url, timeout=self.CHECKPOINT_TIMEOUT_S
                )
            except TypeError:  # custom http_get without timeout kwarg
                status, body = self.http_get(url)
            if status != 200:
                raise ConnectionError(f"GET {url} -> {status}")
            return json.loads(body.decode() or "null")
        except Exception as e:
            log.debug("job checkpoint probe %s failed: %s", url, e)
            return None

    # ---------- pools / claims ----------

    def _slice_pools_of(self, job: TPUJob) -> Dict[str, List[str]]:
        """pool name -> node names for every pool the job's gangs occupy."""
        pools: Dict[str, List[str]] = {}
        names = set()
        for p in self._pods(job):
            if not p.spec.node_name:
                continue
            try:
                node = self.client.get(Node, "", p.spec.node_name)
            except NotFoundError:
                continue
            names.add(node.metadata.labels.get(GKE_NODEPOOL_LABEL, ""))
        names.discard("")
        for node in self.client.list(Node):
            pool = node.metadata.labels.get(GKE_NODEPOOL_LABEL, "")
            if pool in names:
                pools.setdefault(pool, []).append(node.metadata.name)
        return pools

    def _release_claims(self, key: str, back_to_warm: bool) -> None:
        for entry in self.pool.entries(include_unhealthy=True):
            if entry.claimed_by != key:
                continue
            if back_to_warm:
                self.pool.release(entry.pool, entry.nodes,
                                  priority=entry.priority)
            else:
                self.pool.unclaim(entry.pool)

    # ---------- status / helpers ----------

    def _mirror_status(
        self, job: TPUJob, gangs: List[Tuple[str, SliceShape]], phase: str
    ) -> None:
        learner_shape = gangs[0][1]
        ready = self._ready_count(job)
        before = job.status.to_dict()
        status = job.status
        status.phase = phase
        status.ready_replicas = ready
        status.completed_steps = self._int_ann(
            job, C.JOB_CHECKPOINT_STEP_ANNOTATION
        )
        status.preemptions = self._int_ann(job, C.JOB_PREEMPTIONS_ANNOTATION)
        status.failures = self._int_ann(job, C.JOB_FAILURES_ANNOTATION)
        status.observed_generation = job.metadata.generation
        status.tpu = status.tpu or TPUStatus()
        status.tpu.accelerator = learner_shape.accelerator
        status.tpu.topology = learner_shape.topology
        status.tpu.hosts = sum(s.hosts for _, s in gangs)
        status.tpu.hosts_ready = ready
        status.tpu.chips_per_host = learner_shape.chips_per_host
        status.tpu.chips_expected = sum(s.chips for _, s in gangs)
        status.tpu.mesh_ready = phase == "Running"
        if status.to_dict() == before:
            return
        spatch = status.to_dict()
        spatch["readyReplicas"] = status.ready_replicas  # zero must be written
        try:
            # coalesced when available (runtime/coalesce.py): one PATCH per
            # job per sync wave instead of one per watch event
            coalescer = getattr(self.manager, "status_coalescer", None)
            if coalescer is not None:
                coalescer.patch_status(
                    TPUJob, job.metadata.namespace, job.metadata.name, spatch
                )
            else:
                self.client.patch_status(
                    TPUJob, job.metadata.namespace, job.metadata.name, spatch
                )
        except NotFoundError:
            pass  # deleted mid-reconcile

    def _set_queued_condition(
        self, job: TPUJob, status: str, reason: str, message: str
    ) -> bool:
        """Upsert the QueuedOverBudget condition; write-free when nothing
        changed (a queued job must quiesce, not churn the store)."""
        if not upsert_condition(
            job.status.conditions, C.JOB_QUEUED_CONDITION, status, reason,
            message,
        ):
            return False
        try:
            self.client.patch_status(
                TPUJob, job.metadata.namespace, job.metadata.name,
                {"conditions": [c.to_dict() for c in job.status.conditions]},
            )
        except NotFoundError:
            pass
        return True

    def _ensure_trace_root(self, job: TPUJob) -> None:
        """First reconcile opens the `job.ready` root (closed at the first
        Running) and stamps its traceparent, so admission/checkpoint/
        preempt/requeue spans join one trace."""
        if C.TRACEPARENT_ANNOTATION in job.metadata.annotations:
            return
        root = tracing.begin_root(
            "job.ready",
            key=f"job:{job.key()}",
            job=job.metadata.name,
            namespace=job.metadata.namespace,
        )
        if root is None:
            return
        job.metadata.annotations[C.TRACEPARENT_ANNOTATION] = root.traceparent
        self._patch_annotations(
            job, {C.TRACEPARENT_ANNOTATION: root.traceparent}
        )

    def _close_ready_root(self, job: TPUJob, now: float) -> None:
        traceparent = job.metadata.annotations.get(C.TRACEPARENT_ANNOTATION)
        ctx = tracing.parse_traceparent(traceparent)
        if ctx is None:
            return
        trace_id, root_span_id = ctx
        if tracing.finish_root(trace_id, end_time=now) is None:
            start = now
            try:
                start = parse_time(
                    job.metadata.creation_timestamp
                ).timestamp()
            except (ValueError, TypeError):
                pass
            tracing.record_span(
                "job.ready",
                trace_id=trace_id,
                span_id=root_span_id,
                start_time=start,
                end_time=now,
                job=job.metadata.name,
            )

    def _int_ann(self, job: TPUJob, key: str) -> int:
        try:
            return int(job.metadata.annotations.get(key, "0") or 0)
        except ValueError:
            return 0

    def _float_ann(self, job: TPUJob, key: str) -> float:
        try:
            return float(job.metadata.annotations.get(key, "0") or 0)
        except ValueError:
            return 0.0

    def _time_ann(self, job: TPUJob, key: str, default: float) -> float:
        try:
            return parse_time(
                job.metadata.annotations.get(key, "")
            ).timestamp()
        except (ValueError, TypeError):
            return default

    def _patch_annotations(self, job: TPUJob, updates: dict) -> None:
        def attempt():
            return self.client.patch(
                TPUJob,
                job.metadata.namespace,
                job.metadata.name,
                {"metadata": {"annotations": updates}},
            )

        try:
            retry_on_conflict(attempt)
        except NotFoundError:
            pass  # deleted mid-transition; the delete path releases claims

    def _emit_event(
        self, job: TPUJob, reason: str, message: str, etype: str = "Warning"
    ) -> None:
        emit_deduped_event(
            self.client, job, f"{job.metadata.name}.{reason.lower()}",
            reason=reason, message=message, etype=etype,
            api_version=job.api_version or "kubeflow.org/v1beta1",
            kind="TPUJob",
        )


__all__ = [
    "TPUJobReconciler",
    "job_gangs",
    "job_priority",
    "job_statefulset_name",
    "job_target_step",
]
