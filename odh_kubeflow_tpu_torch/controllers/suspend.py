"""Suspend/resume controller: checkpointed capacity multiplexing (the port's
copy of odh_kubeflow_tpu/controllers/suspend.py, on GPU slices).

The NotebookOS direction (PAPERS.md): serve many more notebooks than cards. The culling path used to scale replicas to 0 and throw
the slice back into general capacity, so every user return paid the full cold
admission→schedule→mesh path — the north-star metric. This controller makes
the cull a SUSPEND and the return a RESUME:

State machine (durable in annotations, mirrored as Events — the same idiom
as the slice-repair machine):

    Active ──cull/stop──> Checkpointing ──acked/window──> Suspended
                                                              │ unstop
    Active <──mesh ready── Resuming <──warm claim | cold miss─┘
                              │ (bounded re-claims while the pool/capacity
                              │  recovers; a poisoned warm slice re-claims)
                              └── attempts exhausted ──> ResumeFailed
                                   (terminal-but-self-healing, like
                                    RepairFailed: ready again closes it)

- **Checkpointing**: the culler stamps `suspend-state=checkpointing`
  atomically with the stop annotation, so the core reconciler HOLDS replicas
  while every ready host's `/tpu/checkpoint` hook (probe/agent.py →
  models/checkpoint.py; a process pod forwards it to its worker,
  probe/behavior.py) is driven inside a bounded window —
  with bounded, jittered per-ordinal retries (the cluster/client.py 429
  pattern), so one transient probe blip never aborts the whole suspend.
- **Suspended**: the slice's node pool is released WARM into the slice pool
  (cluster/slicepool.py) — its nodes held for the next resume — instead of
  torn down; replicas go to 0 and the cards multiplex to someone else only via
  explicit reclaim.
- **Resuming**: unstop claims a matching warm slice (pool hit — the fast
  path the `resume_vs_cold_create_p50` bench headline measures) or falls
  back to cold placement (miss); mesh-ready completes the round trip,
  re-arms the idleness clock FROM RESUME TIME (a just-resumed notebook must
  not be instantly re-culled off its pre-suspend last-activity), and feeds
  the `notebook_resume_seconds` histogram behind the resume-latency SLO.

Oversubscription policy: admitted card demand may exceed physical cards up
to `chip_budget`. When a cold create or a resume sits unschedulable past a
grace, the reclaimer frees capacity gracefully — lowest-priority MATCHING
pool-idle warm slice first, then the lowest-priority suspend-eligible
running notebook (checkpoint-before-reclaim through this very machine) —
so pressure degrades into queueing/suspension, never RepairFailed. Canary
CRs (`reclaim-exempt` label) are never victims.

Where the port departs from the reference (ROADMAP Queue 3 names each):

- the pool verbs read Nodes from the store, not the manager's cache
  (`SlicePool(reader=)`), as the endpoint and job reconcilers' do: a cached
  read right after a release or a claim sees the pool as it was;
- once every pod of a resuming notebook is bound, an attempt window that
  runs out re-arms without dropping the claim those pods are bound on and
  without a fresh claim (`_await_resume`): a card pod's start to its CUDA
  context (8-16 s) outlasts one attempt window at Config's defaults, and
  the reference's re-claim then released the slice under the bound pod
  back to warm, where any claimant could take it, and counted a pool hit or
  miss for a placement that had already happened. The attempt still
  counts, so a pod that never comes up still ends in ResumeFailed.
"""
from __future__ import annotations

import json
import logging
import random
import time
from typing import Dict, List, Optional, Tuple

from .. import telemetry
from ..api.core import Pod, emit_deduped_event
from ..api.inference import InferenceEndpoint
from ..api.job import TPUJob
from ..api.notebook import Notebook
from ..apimachinery import (
    NotFoundError,
    now_rfc3339,
    parse_time,
    rfc3339_precise,
)
from ..cluster.client import retry_on_conflict
from ..cluster.slicepool import (
    SlicePool,
    notebook_reclaims_total,
    notebook_restore_verifications_total,
    notebook_resume_seconds,
    record_claim,
)
from ..runtime.controller import Request, Result
from ..runtime.flightrecorder import recorder
from ..runtime.manager import Manager
from ..gpu import GKE_NODEPOOL_LABEL, plan_slice
from ..utils.tracing import record_span
from . import constants as C
from .config import Config
from .culling import HTTPGet, _default_http_get
from .inference import (
    STATE_DRAINING as EP_STATE_DRAINING,
    STATE_SERVING as EP_STATE_SERVING,
    STATE_TERMINATED as EP_STATE_TERMINATED,
    endpoint_priority,
)
from .job import (
    STATE_ADMITTED as JOB_STATE_ADMITTED,
    STATE_CHECKPOINTING as JOB_STATE_CHECKPOINTING,
    STATE_RUNNING as JOB_STATE_RUNNING,
    job_gangs,
    job_priority,
)
from .notebook import per_ordinal_probe_urls

log = logging.getLogger(__name__)

# annotation values of the suspend-state machine
STATE_CHECKPOINTING = "checkpointing"
STATE_SUSPENDED = "suspended"
STATE_RESUMING = "resuming"
STATE_RESUME_FAILED = "resume-failed"


def notebook_priority(nb: Notebook) -> int:
    """Reclaim ordering: spec.tpu.priority (higher = more important; the
    lowest-priority eligible slice is reclaimed first)."""
    if nb.spec.tpu is None:
        return 0
    try:
        return int(nb.spec.tpu.priority)
    except (TypeError, ValueError):
        return 0


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


class SuspendResumeController:
    def __init__(
        self,
        manager: Manager,
        config: Optional[Config] = None,
        http_get: Optional[HTTPGet] = None,
    ):
        self.manager = manager
        self.client = manager.client
        # state transitions decide on fresh reads (the cached view after our
        # own annotation writes is stale exactly in the dispatch window)
        self.api_reader = manager.api_reader
        self.config = config or Config()
        self.http_get = http_get or _default_http_get
        self.pool = SlicePool(manager.client, reader=manager.api_reader)
        # in-memory only (the durable machine lives in annotations):
        # per-episode checkpoint acks (ordinal -> acked step), their state
        # checksums (ordinal -> digest; the restore-side verification
        # contract), and resume attempt deadlines; all re-derivable
        self._ckpt_acked: Dict[str, Dict[int, Optional[int]]] = {}
        self._ckpt_checksums: Dict[str, Dict[int, str]] = {}
        self._resume_deadline: Dict[str, float] = {}
        # requester -> last active-suspend reclaim: a short cooldown bridges
        # the victim-drained -> scheduler-caught-up gap, so one pressure
        # episode never suspends a second victim for the same slice
        self._victim_cooldown: Dict[str, float] = {}
        # the pool sweep is GLOBAL (full node scan): damped to once per
        # heartbeat interval process-wide, however many suspended notebooks
        # heartbeat — O(nodes), not O(suspended x nodes)
        self._last_sweep = 0.0

    def setup(self) -> None:
        def pod_is_labeled(ev: str, obj: dict, old: Optional[dict]) -> bool:
            return C.NOTEBOOK_NAME_LABEL in obj.get("metadata", {}).get("labels", {})

        def map_pod(obj: dict) -> List[tuple]:
            meta = obj.get("metadata", {})
            name = meta.get("labels", {}).get(C.NOTEBOOK_NAME_LABEL)
            return [(meta.get("namespace", ""), name)] if name else []

        (
            self.manager.builder("suspend-resume")
            .for_(Notebook)
            # pending pods (unschedulable -> reclaim pressure) and pod
            # readiness flips (resume completion) both re-judge the notebook
            .watches(Pod, map_pod, predicate=pod_is_labeled)
            .with_workers(self.config.max_concurrent_reconciles)
            .complete(self.reconcile)
        )

    # ---------- reconcile ----------

    def reconcile(self, req: Request) -> Optional[Result]:
        try:
            nb = self.api_reader.get(Notebook, req.namespace, req.name)
        except NotFoundError:
            # a claim held by a deleted notebook goes back to warm — a
            # phantom claim would hold the slice out of the pool forever.
            # (Gated: with the feature off no claims can exist, and a
            # node-scan per deleted notebook would tax delete storms.)
            if self.config.suspend_enabled or req.key in self._resume_deadline:
                self._release_claims(req.key, back_to_warm=True)
            self._forget(req.key)
            return None
        if nb.metadata.deletion_timestamp:
            if self.config.suspend_enabled or req.key in self._resume_deadline:
                self._release_claims(req.key, back_to_warm=True)
            self._forget(req.key)
            return None
        if nb.spec.tpu is None or not nb.spec.tpu.accelerator:
            return None  # CPU notebook: nothing to multiplex

        ann = nb.metadata.annotations
        state = ann.get(C.TPU_SUSPEND_STATE_ANNOTATION, "")
        if not state and not self.config.suspend_enabled:
            return None  # feature off and nothing in flight to drain

        now = time.time()
        # the webhook's reconciliation lock rides the SAME annotation key
        # with a sentinel value (reference idiom; cleared by the extension
        # controller once ready) — a freshly created notebook is NOT stopped,
        # and treating the lock as a stop ran a phantom suspend/resume
        # episode at birth, polluting the pool hit ratio and the
        # resume-latency histogram with bring-up time
        stopped = (
            C.STOP_ANNOTATION in ann
            and ann[C.STOP_ANNOTATION] != C.RECONCILIATION_LOCK_VALUE
        )
        shape = plan_slice(
            nb.spec.tpu.accelerator, nb.spec.tpu.topology, nb.spec.tpu.chips
        )

        if stopped:
            if not state:
                # a stop that arrived WITHOUT the culler's atomic stamp (user
                # stop, older tooling): enter checkpointing best-effort — the
                # scale-down may already be racing us, and the window logic
                # proceeds on "no ready pods" if it wins
                if (
                    self.config.suspend_enabled
                    and C.TPU_REPAIR_STATE_ANNOTATION not in ann
                ):
                    self._patch_annotations(
                        nb,
                        {C.TPU_SUSPEND_STATE_ANNOTATION: STATE_CHECKPOINTING},
                    )
                    return Result(requeue_after=0.01)
                return None
            if state == STATE_CHECKPOINTING:
                return self._run_checkpoint_window(nb, shape, now, req)
            if state in (STATE_RESUMING, STATE_RESUME_FAILED):
                # re-stopped (or re-culled) mid-resume: park back in
                # Suspended; any claimed warm slice returns to warm
                self._release_claims(req.key, back_to_warm=True, nb=nb)
                self._patch_annotations(
                    nb,
                    {
                        C.TPU_SUSPEND_STATE_ANNOTATION: STATE_SUSPENDED,
                        C.TPU_RESUME_STARTED_ANNOTATION: None,
                        C.TPU_RESUME_ATTEMPTS_ANNOTATION: None,
                    },
                )
                self._forget(req.key)
                return Result(requeue_after=0.05)
            # STATE_SUSPENDED: parked. Heartbeat keeps the pool honest (a
            # preempted warm host must not sit in the pool as a trap) and
            # re-judges on missed unstop events.
            self._sweep_pool(now)
            return Result(
                requeue_after=max(1.0, self.config.readiness_probe_period_s * 6)
            )

        # -- not stopped --
        if not state:
            # Active. The only suspend-machine work here is oversubscription
            # pressure: pods of THIS notebook sitting unschedulable trigger
            # the reclaimer (this also serves a mid-repair re-placement that
            # cannot find capacity — degrade by reclaiming, not RepairFailed).
            return self._maybe_reclaim_for(nb, shape, now, req)
        if state == STATE_CHECKPOINTING:
            # user returned before the suspend finished: abort — the slice
            # was never released, the pods never scaled away
            self._patch_annotations(nb, self._clear_updates())
            self._emit_event(
                nb, "SuspendAborted",
                "suspend aborted: notebook unstopped during the checkpoint "
                "window", etype="Normal",
            )
            self._forget(req.key)
            return None
        if state == STATE_SUSPENDED:
            return self._begin_resume(nb, shape, now, req)
        if state == STATE_RESUMING:
            return self._await_resume(nb, shape, now, req)
        if state == STATE_RESUME_FAILED:
            # terminal, but not a dead end (RepairFailed idiom): capacity or
            # the pool recovering closes the episode
            if self._resumed(nb, shape):
                return self._complete_resume(nb, now, req)
            # keep pressure on: a failed resume is exactly the unschedulable
            # shape the reclaimer exists for
            result = self._maybe_reclaim_for(nb, shape, now, req)
            if self._pending_pods(nb):
                return result or Result(requeue_after=1.0)
            return Result(requeue_after=1.0)
        log.warning("unknown suspend state %r on %s; clearing", state, req.key)
        self._patch_annotations(nb, {C.TPU_SUSPEND_STATE_ANNOTATION: None})
        return Result(requeue_after=0.05)

    # ---------- checkpoint-before-suspend ----------

    CHECKPOINT_TIMEOUT_S = 2.0

    def _run_checkpoint_window(
        self, nb: Notebook, shape, now: float, req: Request
    ) -> Result:
        ann = nb.metadata.annotations
        deadline_s = ann.get(C.TPU_SUSPEND_CHECKPOINT_DEADLINE_ANNOTATION, "")
        if not deadline_s:
            # first pass of the episode: open the window
            self._ckpt_acked.pop(req.key, None)
            deadline = now + self.config.suspend_checkpoint_window_s
            self._patch_annotations(
                nb,
                {
                    C.TPU_SUSPEND_STARTED_ANNOTATION: rfc3339_precise(now),
                    C.TPU_SUSPEND_CHECKPOINT_DEADLINE_ANNOTATION: (
                        rfc3339_precise(deadline)
                    ),
                },
            )
            recorder.record(
                "transition", machine="suspend", notebook=req.key,
                state=STATE_CHECKPOINTING,
                reclaim=bool(ann.get(C.TPU_RECLAIM_ANNOTATION)),
            )
            return Result(requeue_after=0.01)
        try:
            deadline = parse_time(deadline_s).timestamp()
        except ValueError:
            deadline = now

        pods = self._pods(nb)
        ready_ordinals = set()
        for p in pods:
            if not p.is_ready():
                continue
            try:
                ready_ordinals.add(int(p.metadata.name.rsplit("-", 1)[1]))
            except (IndexError, ValueError):
                continue
        acked = self._ckpt_acked.setdefault(req.key, {})
        checksums = self._ckpt_checksums.setdefault(req.key, {})
        pending = sorted(ready_ordinals - set(acked))
        if pending and now < deadline:
            for ordinal, ack in self._checkpoint_sweep(
                nb, shape.hosts, pending, deadline
            ):
                if ack and ack.get("saved"):
                    acked[ordinal] = ack.get("step")
                    if ack.get("checksum"):
                        checksums[ordinal] = str(ack["checksum"])
        all_acked = bool(ready_ordinals) and ready_ordinals <= set(acked)
        if not (all_acked or not ready_ordinals or now >= deadline):
            return Result(requeue_after=max(
                0.02,
                min(self.config.readiness_probe_period_s, deadline - now),
            ))

        # window closed: record the save, release the slice, park Suspended
        updates = {
            C.TPU_SUSPEND_STATE_ANNOTATION: STATE_SUSPENDED,
            C.TPU_SUSPENDED_AT_ANNOTATION: rfc3339_precise(now),
            C.TPU_SUSPEND_CHECKPOINT_DEADLINE_ANNOTATION: None,
        }
        self._ckpt_acked.pop(req.key, None)
        checksums = self._ckpt_checksums.pop(req.key, {})
        if acked:
            telemetry.slice_checkpoint_saves_total.inc(len(acked))
            steps = [s for s in acked.values() if s is not None]
            if steps:
                updates[C.TPU_CHECKPOINT_SAVED_ANNOTATION] = str(max(steps))
                # ordinal 0's digest ONLY, and only when ordinal 0 acked the
                # step being recorded: saves are per-shard (each host writes
                # what it owns), so digests are host-specific — the one
                # well-defined comparison is ordinal 0's save vs ordinal 0's
                # restore. Storing another ordinal's digest would
                # manufacture a guaranteed mismatch on multi-host slices;
                # no digest means verification reports "unverified", never
                # a false alarm.
                if acked.get(0) == max(steps) and 0 in checksums:
                    updates[C.TPU_CHECKPOINT_CHECKSUM_ANNOTATION] = (
                        checksums[0]
                    )
        reclaimed = ann.get(C.TPU_RECLAIM_ANNOTATION, "")
        pool_name = self._slice_pool_of(pods)
        released = False
        if pool_name and not reclaimed:
            # warm release: the whole point of the suspend — the slice stays
            # mesh-formed for the next resume. A reclaim-forced suspend skips
            # this: the requester that triggered it needs the cards.
            released = self.pool.release(
                pool_name,
                self._pool_nodes(pool_name),
                priority=notebook_priority(nb),
            )
        started = now
        try:
            started = parse_time(
                ann.get(C.TPU_SUSPEND_STARTED_ANNOTATION, "")
            ).timestamp()
        except ValueError:
            pass
        record_span(
            "notebook.suspend",
            traceparent=ann.get(C.TRACEPARENT_ANNOTATION),
            start_time=started,
            end_time=now,
            notebook=nb.metadata.name,
            namespace=nb.metadata.namespace,
            hosts_acked=len(acked),
            released_warm=released,
            reclaimed=bool(reclaimed),
        )
        self._patch_annotations(nb, updates)
        self._emit_event(
            nb, "NotebookSuspended",
            f"suspended after checkpoint ({len(acked)}/{shape.hosts} hosts "
            + ("acked); slice released to the warm pool" if released
               else "acked); slice returned to general capacity"),
            etype="Normal",
        )
        recorder.record(
            "transition", machine="suspend", notebook=req.key,
            state=STATE_SUSPENDED, hosts_acked=len(acked),
            released_warm=released, reclaimed=bool(reclaimed),
        )
        log.info(
            "suspended %s (%d/%d hosts checkpointed%s)",
            req.key, len(acked), shape.hosts,
            f"; {pool_name} released warm" if released else "",
        )
        return None

    def _checkpoint_sweep(
        self, nb: Notebook, hosts: int, ordinals: List[int], deadline: float
    ) -> List[Tuple[int, Optional[dict]]]:
        """Drive /tpu/checkpoint on the given ordinals concurrently, each
        with bounded jittered retries inside the window (cluster/client.py's
        429 discipline: capped sleeps, bounded attempts, then give up and let
        the next poll or the window expiry decide) — a single transient
        probe-agent blip must not abort the whole suspend."""
        from concurrent.futures import ThreadPoolExecutor

        retries = max(0, self.config.suspend_checkpoint_retries)
        base = self.config.suspend_checkpoint_backoff_s

        def probe(url: str) -> Optional[dict]:
            for attempt in range(retries + 1):
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
                    if attempt == retries:
                        log.debug("checkpoint probe %s gave up: %s", url, e)
                        return None
                    # jittered, capped, and never past the window deadline
                    sleep = min(
                        base * (2 ** attempt) * (0.75 + 0.5 * random.random()),
                        2.0,
                        max(0.0, deadline - time.time()),
                    )
                    if sleep <= 0:
                        return None
                    time.sleep(sleep)
            return None

        urls = per_ordinal_probe_urls(
            self.client, self.config, nb, hosts, "/tpu/checkpoint"
        )
        targets = [(i, urls[i]) for i in ordinals if i < len(urls)]
        if not targets:
            return []
        with ThreadPoolExecutor(max_workers=min(16, len(targets))) as pool:
            acks = list(pool.map(probe, [u for _, u in targets]))
        return [(i, a) for (i, _), a in zip(targets, acks)]

    # ---------- resume ----------

    def _begin_resume(
        self, nb: Notebook, shape, now: float, req: Request
    ) -> Result:
        hit = self._claim_for(nb, shape, req.key)
        self._patch_annotations(
            nb,
            {
                C.TPU_SUSPEND_STATE_ANNOTATION: STATE_RESUMING,
                C.TPU_RESUME_STARTED_ANNOTATION: rfc3339_precise(now),
                C.TPU_RESUME_ATTEMPTS_ANNOTATION: "1",
            },
        )
        self._resume_deadline[req.key] = now + self._resume_backoff(1)
        recorder.record(
            "transition", machine="suspend", notebook=req.key,
            state=STATE_RESUMING, warm_hit=hit,
        )
        log.info("resuming %s (%s)", req.key,
                 "warm pool hit" if hit else "pool miss; cold placement")
        return Result(requeue_after=0.05)

    def _claim_for(self, nb: Notebook, shape, key: str) -> bool:
        """One warm-claim attempt; counts the hit/miss for the pool ratio.
        (claim() itself never picks an unhealthy pool — entries() filters
        them — so the damped sweep here is eviction bookkeeping, not the
        safety check.)"""
        self._sweep_pool(time.time())
        entry = self.pool.claim(shape.gke_accelerator, shape.topology, key)
        record_claim(entry is not None)
        return entry is not None

    def _resumed(self, nb: Notebook, shape) -> bool:
        return (
            nb.status.tpu is not None
            and nb.status.tpu.mesh_ready
            and nb.status.ready_replicas >= shape.hosts
        )

    def _await_resume(
        self, nb: Notebook, shape, now: float, req: Request
    ) -> Optional[Result]:
        if self._resumed(nb, shape):
            return self._complete_resume(nb, now, req)

        ann = nb.metadata.annotations
        attempts = int(ann.get(C.TPU_RESUME_ATTEMPTS_ANNOTATION, "1") or 1)
        deadline = self._resume_deadline.get(req.key)
        if deadline is None:
            # controller restarted mid-resume: re-derive from the durable
            # attempt counter
            deadline = now + self._resume_backoff(attempts)
            self._resume_deadline[req.key] = deadline

        # pressure valve: pods sitting unschedulable mid-resume reclaim
        # (the warm claim may have been poisoned away, or a cold fallback
        # found the cluster full)
        reclaim_result = self._maybe_reclaim_for(nb, shape, now, req)

        if now < deadline:
            return Result(requeue_after=max(
                0.02, min(deadline - now, self.config.readiness_probe_period_s)
            ))

        # one full attempt window without mesh-ready: re-claim
        attempts += 1
        if attempts > self.config.resume_max_attempts:
            return self._fail_resume(nb, now, req)
        pods = self._pods(nb)
        if len(pods) >= shape.hosts and all(p.spec.node_name for p in pods):
            # placed, not yet up (a card pod's start to its CUDA context
            # outlasts an attempt window): the slice under the bound pods is
            # theirs — releasing it to warm would offer it to any claimant,
            # and a fresh claim cannot move a bound pod
            self._patch_annotations(
                nb, {C.TPU_RESUME_ATTEMPTS_ANNOTATION: str(attempts)}
            )
            self._resume_deadline[req.key] = now + self._resume_backoff(attempts)
            log.info(
                "resume %s placed, not yet mesh-ready (attempt %d/%d)",
                req.key, attempts, self.config.resume_max_attempts,
            )
            return Result(requeue_after=max(
                0.02, self._resume_deadline[req.key] - now
            ))
        # drop a claim that never bound (poisoned slice, raced reclaim) back
        # to warm so someone else can use it, then try fresh
        self._release_claims(req.key, back_to_warm=True, nb=nb)
        hit = self._claim_for(nb, shape, req.key)
        self._patch_annotations(
            nb, {C.TPU_RESUME_ATTEMPTS_ANNOTATION: str(attempts)}
        )
        self._resume_deadline[req.key] = now + self._resume_backoff(attempts)
        log.info(
            "resume %s still pending (attempt %d/%d, %s)",
            req.key, attempts, self.config.resume_max_attempts,
            "warm re-claim" if hit else "cold",
        )
        del reclaim_result  # pressure already applied above
        return Result(requeue_after=max(
            0.02, self._resume_deadline[req.key] - now
        ))

    def _complete_resume(
        self, nb: Notebook, now: float, req: Request
    ) -> Optional[Result]:
        ann = nb.metadata.annotations
        started = now
        try:
            started = parse_time(
                ann.get(C.TPU_RESUME_STARTED_ANNOTATION, "")
            ).timestamp()
        except ValueError:
            pass
        latency = max(0.0, now - started)
        self._verify_restore(nb, req)
        # the bind window is over: the slice is plainly owned by its pods —
        # pool marks off, so a later suspend re-releases it cleanly
        self._release_claims(req.key, back_to_warm=False, nb=nb)
        updates = self._clear_updates()
        # culling-clock contract (ISSUE 7 satellite): the idleness clock
        # re-arms FROM RESUME TIME — the preserved pre-suspend last-activity
        # would read as hours of idleness and re-cull the notebook instantly
        updates[C.LAST_ACTIVITY_ANNOTATION] = now_rfc3339()
        updates[C.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION] = now_rfc3339()
        self._patch_annotations(nb, updates)
        notebook_resume_seconds.observe(latency)
        record_span(
            "notebook.resume",
            traceparent=ann.get(C.TRACEPARENT_ANNOTATION),
            start_time=started,
            end_time=now,
            notebook=nb.metadata.name,
            namespace=nb.metadata.namespace,
            latency_s=round(latency, 3),
        )
        self._emit_event(
            nb, "NotebookResumed",
            f"resumed to mesh-ready in {latency:.2f}s"
            + (f" (restoring checkpoint step "
               f"{ann.get(C.TPU_CHECKPOINT_SAVED_ANNOTATION)})"
               if ann.get(C.TPU_CHECKPOINT_SAVED_ANNOTATION) else ""),
            etype="Normal",
        )
        recorder.record(
            "transition", machine="suspend", notebook=req.key,
            state="active", resume_s=round(latency, 3),
        )
        self._forget(req.key)
        log.info("resumed %s in %.2fs", req.key, latency)
        return None

    def _verify_restore(self, nb: Notebook, req: Request) -> None:
        """Restore-side verification (ISSUE 9 satellite): the resumed
        kernel must equal the saved one. Ordinal 0's /tpu/restore ack is
        compared against the checksum the suspend-side checkpoint recorded;
        a mismatch is surfaced loudly (Warning event + counter) but never
        blocks the resume — a live-but-suspect notebook beats a wedged one,
        and the operator sees exactly which state diverged."""
        from .inference import classify_restore, probe_restore_ack

        ann = nb.metadata.annotations
        expected = ann.get(C.TPU_CHECKPOINT_CHECKSUM_ANNOTATION, "")
        if not expected:
            return  # nothing was acked with a digest: nothing to verify
        shape = plan_slice(
            nb.spec.tpu.accelerator, nb.spec.tpu.topology, nb.spec.tpu.chips
        )
        urls = per_ordinal_probe_urls(
            self.client, self.config, nb, shape.hosts, "/tpu/restore"
        )
        ack = probe_restore_ack(self.http_get, urls[0]) if urls else None
        verdict, detail = classify_restore(ack, expected)
        notebook_restore_verifications_total.inc(result=verdict)
        if verdict == "ok":
            self._emit_event(
                nb, "RestoreVerified",
                f"restored kernel verified: {detail}", etype="Normal",
            )
        elif verdict == "mismatch":
            self._emit_event(
                nb, "RestoreVerifyFailed",
                f"restored kernel does NOT equal the saved one: {detail}",
            )
            log.error("restore verification MISMATCH for %s: %s",
                      req.key, detail)

    def _fail_resume(self, nb: Notebook, now: float, req: Request) -> None:
        self._patch_annotations(
            nb, {C.TPU_SUSPEND_STATE_ANNOTATION: STATE_RESUME_FAILED}
        )
        msg = (
            f"resume abandoned after {self.config.resume_max_attempts} "
            "attempts (no warm slice bound and cold capacity never "
            "appeared); the reclaimer keeps watching — capacity returning "
            "completes the resume"
        )
        self._emit_event(nb, "ResumeFailed", msg)
        recorder.record(
            "transition", machine="suspend", notebook=req.key,
            state=STATE_RESUME_FAILED,
        )
        recorder.snapshot(
            "resume-failed", subject=req.key, client=self.client,
            notebooks=[(nb.metadata.namespace, nb.metadata.name)],
            extra={"attempts": self.config.resume_max_attempts},
        )
        self._resume_deadline.pop(req.key, None)
        log.error("resume FAILED: %s", req.key)
        return None

    def _resume_backoff(self, attempts: int) -> float:
        base = self.config.resume_timeout_s / max(
            1, self.config.resume_max_attempts
        )
        # jitter so a fleet-wide unstop (morning rush) doesn't re-claim in
        # lockstep against the draining pool
        return base * (0.85 + 0.3 * random.random())

    # ---------- oversubscription reclaim ----------

    def _maybe_reclaim_for(
        self, nb: Notebook, shape, now: float, req: Request
    ) -> Optional[Result]:
        """Free capacity for `nb` when its pods sit unschedulable: matching
        pool-idle warm slice first, then the lowest-priority suspend-eligible
        running notebook. Policy-gated by the chip budget."""
        pending = self._pending_pods(nb)
        if not pending:
            return None
        oldest = now
        for p in pending:
            try:
                oldest = min(
                    oldest, parse_time(p.metadata.creation_timestamp).timestamp()
                )
            except (ValueError, TypeError):
                pass
        grace = self.config.reclaim_pending_grace_s
        if now - oldest < grace:
            # the scheduler's capacity-freed fast path gets first shot
            return Result(requeue_after=max(0.05, grace - (now - oldest)))

        if nb.metadata.labels.get(C.TPU_RECLAIM_EXEMPT_LABEL):
            # exempt CRs (the canary) neither PAY for pressure nor CAUSE it:
            # a synthetic probe queueing in a saturated cluster is exactly
            # the signal the canary exists to measure — reclaiming a user's
            # warm slice once per probe period to serve it would convert
            # measurement into damage
            return Result(requeue_after=max(1.0, grace))

        # never reclaim anything while a matching slice is ALREADY free —
        # the window between capacity freeing and the scheduler's bind is
        # one event hop, and a reclaim pass landing inside it (or plain
        # scheduler backoff lag) would strip a warm slice or take a second
        # victim for capacity the requester is about to get
        if self._matching_capacity_free(shape):
            return Result(requeue_after=0.2)

        # one victim at a time: a reclaim-forced suspend takes a checkpoint
        # window (and a reclaim-forced endpoint drain takes its drain
        # window) to free its slice, and the requester's pods stay pending
        # the whole while — without this guard every reclaim pass in that
        # window would pick a FRESH victim and cascade for one slice (the
        # durable reclaim annotation is the in-flight marker, so the guard
        # survives controller restarts)
        for ep in self.client.list(InferenceEndpoint):
            if (
                ep.metadata.annotations.get(C.TPU_RECLAIM_ANNOTATION)
                != f"capacity-pressure:{req.key}"
            ):
                continue
            estate = ep.metadata.annotations.get(
                C.INFERENCE_STATE_ANNOTATION
            )
            still_draining = estate == EP_STATE_DRAINING or (
                estate == EP_STATE_TERMINATED
                and any(
                    True
                    for p in self.client.list(
                        Pod,
                        namespace=ep.metadata.namespace,
                        labels={
                            C.INFERENCE_NAME_LABEL: ep.metadata.name
                        },
                    )
                    if not p.metadata.deletion_timestamp
                )
            )
            if still_draining:
                return Result(requeue_after=0.2)
        for cand in self.client.list(Notebook):
            if (
                cand.metadata.annotations.get(C.TPU_RECLAIM_ANNOTATION)
                != f"capacity-pressure:{req.key}"
            ):
                continue
            cstate = cand.metadata.annotations.get(
                C.TPU_SUSPEND_STATE_ANNOTATION
            )
            still_draining = cstate == STATE_CHECKPOINTING or (
                cstate == STATE_SUSPENDED
                and any(
                    True
                    for p in self.client.list(
                        Pod,
                        namespace=cand.metadata.namespace,
                        labels={
                            C.NOTEBOOK_NAME_LABEL: cand.metadata.name
                        },
                    )
                )
            )
            if still_draining:
                return Result(requeue_after=0.2)
        for jc in self.client.list(TPUJob):
            # a job we already victimized is mid checkpoint-preempt-requeue:
            # its preempt stamp survives until the requeue clears it, so the
            # guard holds exactly as long as the slice is still coming free
            if (
                jc.metadata.annotations.get(C.JOB_PREEMPT_ANNOTATION)
                == f"capacity-pressure:{req.key}"
            ):
                return Result(requeue_after=0.2)

        budget = self.config.chip_budget
        if budget > 0 and self._admitted_chips() > budget:
            # over budget: this demand queues — reclaiming would cascade
            # suspensions to serve demand the operator never admitted
            self._emit_event(
                nb, "QueuedOverBudget",
                f"unschedulable and total admitted chip demand exceeds the "
                f"chip budget ({budget}); queued without reclaim",
            )
            return Result(requeue_after=max(1.0, grace))

        # 1) an idle warm slice of the right shape is free capacity wearing
        #    a reservation — take the lowest-priority one
        victim_entry = self.pool.reclaim_idle(
            shape.gke_accelerator, shape.topology
        )
        if victim_entry is not None:
            self._emit_event(
                nb, "SliceReclaimed",
                f"reclaimed idle warm slice {victim_entry.pool} "
                f"(priority {victim_entry.priority}) to place this notebook",
                etype="Normal",
            )
            recorder.record(
                "transition", machine="suspend", notebook=req.key,
                state="reclaim", victim=victim_entry.pool, reason="pool-idle",
            )
            recorder.snapshot(
                "reclaim", subject=req.key, client=self.client,
                notebooks=[(nb.metadata.namespace, nb.metadata.name)],
                extra={
                    "reason": "pool-idle",
                    "victim_pool": victim_entry.pool,
                    "victim_priority": victim_entry.priority,
                },
            )
            return Result(requeue_after=0.05)

        # 2) suspend (or drain) the lowest-priority eligible running
        #    workload — notebooks and Serving endpoints compete in ONE
        #    priority order (ISSUE 9 bugfix: endpoints default above
        #    interactive, and a Draining endpoint is never re-victimized)
        cooldown = max(1.0, self.config.suspend_checkpoint_window_s * 0.5)
        if now - self._victim_cooldown.get(req.key, 0.0) < cooldown:
            return Result(requeue_after=0.2)
        victim = self._pick_suspend_victim(nb, shape)
        ep_victim = self._pick_endpoint_victim(nb, shape)
        job_victim = self._pick_job_victim(nb, shape)
        # ONE ordering across all three classes: the strictly-lowest
        # priority loses; ties drain batch first (most preemptible — a job
        # requeues and resumes from its checkpoint), then suspend the
        # notebook, and an endpoint only when UNAMBIGUOUSLY the cheapest
        ranked = []
        if job_victim is not None:
            ranked.append((job_priority(job_victim), 0, "job"))
        if victim is not None:
            ranked.append((notebook_priority(victim), 1, "nb"))
        if ep_victim is not None:
            ranked.append((endpoint_priority(ep_victim), 2, "ep"))
        winner = min(ranked)[2] if ranked else None
        if winner != "nb":
            victim = None
        if winner != "ep":
            ep_victim = None
        if winner != "job":
            job_victim = None
        if job_victim is not None:
            self._victim_cooldown[req.key] = now
            jkey = f"{job_victim.metadata.namespace}/{job_victim.metadata.name}"
            self._patch_job_victim(
                job_victim,
                {C.JOB_PREEMPT_ANNOTATION: f"capacity-pressure:{req.key}"},
            )
            notebook_reclaims_total.inc(reason="job-preempt")
            self._emit_event(
                nb, "SliceReclaimed",
                f"preempting batch job {jkey} (priority "
                f"{job_priority(job_victim)}) to free capacity for "
                f"{req.key} (priority {notebook_priority(nb)}); the job "
                "checkpoints before its slice moves and requeues to resume "
                "from the saved step",
                etype="Normal",
            )
            recorder.record(
                "transition", machine="suspend", notebook=req.key,
                state="reclaim", victim=jkey, reason="job-preempt",
            )
            recorder.snapshot(
                "reclaim", subject=jkey, client=self.client,
                notebooks=[(nb.metadata.namespace, nb.metadata.name)],
                extra={
                    "reason": "job-preempt",
                    "requester": req.key,
                    "requester_priority": notebook_priority(nb),
                    "victim_priority": job_priority(job_victim),
                },
            )
            log.warning(
                "reclaim: preempting job %s (priority %d) for %s "
                "(priority %d)", jkey, job_priority(job_victim),
                req.key, notebook_priority(nb),
            )
            return Result(requeue_after=0.1)
        if ep_victim is not None:
            self._victim_cooldown[req.key] = now
            ekey = f"{ep_victim.metadata.namespace}/{ep_victim.metadata.name}"
            self._patch_endpoint_victim(
                ep_victim,
                {
                    C.STOP_ANNOTATION: now_rfc3339(),
                    C.TPU_RECLAIM_ANNOTATION: f"capacity-pressure:{req.key}",
                },
            )
            notebook_reclaims_total.inc(reason="endpoint-drain")
            self._emit_event(
                nb, "SliceReclaimed",
                f"draining serving endpoint {ekey} (priority "
                f"{endpoint_priority(ep_victim)}) to free capacity for "
                f"{req.key} (priority {notebook_priority(nb)}); in-flight "
                "requests drain bounded before the slice moves",
                etype="Normal",
            )
            recorder.record(
                "transition", machine="suspend", notebook=req.key,
                state="reclaim", victim=ekey, reason="endpoint-drain",
            )
            recorder.snapshot(
                "reclaim", subject=ekey, client=self.client,
                notebooks=[(nb.metadata.namespace, nb.metadata.name)],
                extra={
                    "reason": "endpoint-drain",
                    "requester": req.key,
                    "requester_priority": notebook_priority(nb),
                    "victim_priority": endpoint_priority(ep_victim),
                },
            )
            log.warning(
                "reclaim: draining endpoint %s (priority %d) for %s "
                "(priority %d)", ekey, endpoint_priority(ep_victim),
                req.key, notebook_priority(nb),
            )
            return Result(requeue_after=0.1)
        if victim is None:
            return Result(requeue_after=max(1.0, grace))
        self._victim_cooldown[req.key] = now
        vkey = f"{victim.metadata.namespace}/{victim.metadata.name}"
        self._patch_victim(
            victim,
            {
                C.STOP_ANNOTATION: now_rfc3339(),
                C.TPU_SUSPEND_STATE_ANNOTATION: STATE_CHECKPOINTING,
                C.TPU_RECLAIM_ANNOTATION: f"capacity-pressure:{req.key}",
            },
        )
        notebook_reclaims_total.inc(reason="suspend")
        self._emit_event(
            victim, "NotebookReclaimed",
            f"suspending (priority {notebook_priority(victim)}) to free "
            f"capacity for {req.key} (priority {notebook_priority(nb)}); "
            "state checkpoints before the slice is released",
        )
        recorder.record(
            "transition", machine="suspend", notebook=req.key,
            state="reclaim", victim=vkey, reason="suspend",
        )
        recorder.snapshot(
            "reclaim", subject=vkey, client=self.client,
            notebooks=[
                (nb.metadata.namespace, nb.metadata.name),
                (victim.metadata.namespace, victim.metadata.name),
            ],
            extra={
                "reason": "suspend",
                "requester": req.key,
                "requester_priority": notebook_priority(nb),
                "victim_priority": notebook_priority(victim),
            },
        )
        log.warning(
            "reclaim: suspending %s (priority %d) for %s (priority %d)",
            vkey, notebook_priority(victim), req.key, notebook_priority(nb),
        )
        return Result(requeue_after=0.1)

    def _pick_suspend_victim(
        self, requester: Notebook, shape
    ) -> Optional[Notebook]:
        """Lowest-priority running notebook whose slice matches the
        requester's shape and whose priority is strictly below the
        requester's. Canary/exempt CRs, stopped/suspending/repairing
        notebooks, and not-yet-ready slices are never victims."""
        my_priority = notebook_priority(requester)
        my_key = f"{requester.metadata.namespace}/{requester.metadata.name}"
        candidates: List[Tuple[int, str, Notebook]] = []
        for cand in self.client.list(Notebook):
            if cand.spec.tpu is None or not cand.spec.tpu.accelerator:
                continue
            key = f"{cand.metadata.namespace}/{cand.metadata.name}"
            if key == my_key or cand.metadata.deletion_timestamp:
                continue
            if cand.metadata.labels.get(C.TPU_RECLAIM_EXEMPT_LABEL):
                continue  # the canary measures pressure; it never pays for it
            ann = cand.metadata.annotations
            if (
                C.STOP_ANNOTATION in ann
                or ann.get(C.TPU_SUSPEND_STATE_ANNOTATION)
                or ann.get(C.TPU_REPAIR_STATE_ANNOTATION)
            ):
                continue
            if cand.status.tpu is None or not cand.status.tpu.mesh_ready:
                continue  # only a formed slice frees usable capacity
            cshape = plan_slice(
                cand.spec.tpu.accelerator,
                cand.spec.tpu.topology,
                cand.spec.tpu.chips,
            )
            if (
                cshape.gke_accelerator != shape.gke_accelerator
                or cshape.topology != shape.topology
            ):
                continue
            pri = notebook_priority(cand)
            if pri >= my_priority:
                continue
            # oldest-idle tie break: prefer the notebook idle longest. A
            # MISSING last-activity means the culler hasn't judged it yet
            # (typically just-became-ready, in active use) — that must sort
            # LAST, not first ("" < any timestamp would pick exactly the
            # wrong victim)
            last = ann.get(C.LAST_ACTIVITY_ANNOTATION, "") or "9999-12-31"
            candidates.append((pri, last, key, cand))
        if not candidates:
            return None
        candidates.sort(key=lambda t: (t[0], t[1], t[2]))
        return candidates[0][3]

    def _pick_endpoint_victim(
        self, requester: Notebook, shape
    ) -> Optional[InferenceEndpoint]:
        """Serving endpoints are reclaim victims by `spec.tpu.priority`
        exactly like notebooks — but they default ABOVE interactive
        (ENDPOINT_DEFAULT_PRIORITY), only a Serving endpoint is eligible
        (its slice is confirmed live capacity), and a Draining endpoint is
        NEVER re-victimized mid-drain (ISSUE 9 bugfix): its slice is
        already on the way out, a second stamp would only reset the drain
        window it is racing to finish."""
        from .inference import resolve_endpoint_tpu

        my_priority = notebook_priority(requester)
        candidates: List[Tuple[int, str, InferenceEndpoint]] = []
        for cand in self.client.list(InferenceEndpoint):
            if cand.metadata.deletion_timestamp:
                continue
            ann = cand.metadata.annotations
            state = ann.get(C.INFERENCE_STATE_ANNOTATION, "")
            if state != EP_STATE_SERVING:
                continue  # Draining/Terminated/Loading free nothing usable
            if C.STOP_ANNOTATION in ann:
                continue  # already winding down
            if cand.metadata.labels.get(C.TPU_RECLAIM_EXEMPT_LABEL):
                continue
            tpu = resolve_endpoint_tpu(self.client, cand)
            if tpu is None:
                continue
            try:
                cshape = plan_slice(tpu.accelerator, tpu.topology, tpu.chips)
            except Exception as e:
                log.debug("victim scan: unplannable endpoint %s/%s: %s",
                          cand.metadata.namespace, cand.metadata.name, e)
                continue
            if (
                cshape.gke_accelerator != shape.gke_accelerator
                or cshape.topology != shape.topology
            ):
                continue
            pri = endpoint_priority(cand)
            if pri >= my_priority:
                continue
            key = f"{cand.metadata.namespace}/{cand.metadata.name}"
            candidates.append((pri, key, cand))
        if not candidates:
            return None
        candidates.sort(key=lambda t: (t[0], t[1]))
        return candidates[0][2]

    def _pick_job_victim(
        self, requester: Notebook, shape
    ) -> Optional[TPUJob]:
        """Batch jobs are reclaim victims by `spec.tpu.priority` in the
        same ordering as notebooks/endpoints — but they default BELOW
        interactive (JOB_DEFAULT_PRIORITY), only a Running job is eligible
        (its slice is confirmed live capacity), and a job mid-Checkpointing
        is NEVER victimized (the Draining rule's mirror, ISSUE 10 bugfix
        sweep): its save is exactly what makes the preemption survivable,
        and a preempt stamp racing the window would re-enter it."""
        my_priority = notebook_priority(requester)
        candidates: List[Tuple[int, str, TPUJob]] = []
        for cand in self.client.list(TPUJob):
            if cand.metadata.deletion_timestamp:
                continue
            ann = cand.metadata.annotations
            state = ann.get(C.JOB_STATE_ANNOTATION, "")
            if state != JOB_STATE_RUNNING:
                continue  # Pending/Admitted/Preempted free nothing usable;
                # Checkpointing is explicitly protected mid-window
            if C.JOB_PREEMPT_ANNOTATION in ann:
                continue  # already on the way out
            if cand.metadata.labels.get(C.TPU_RECLAIM_EXEMPT_LABEL):
                continue
            try:
                gangs = job_gangs(cand)
            except Exception as e:
                log.debug("victim scan: unplannable job %s/%s: %s",
                          cand.metadata.namespace, cand.metadata.name, e)
                continue
            if not any(
                gshape.gke_accelerator == shape.gke_accelerator
                and gshape.topology == shape.topology
                for _, gshape in gangs
            ):
                continue  # no gang of this job frees the requested shape
            pri = job_priority(cand)
            if pri >= my_priority:
                continue
            key = f"{cand.metadata.namespace}/{cand.metadata.name}"
            candidates.append((pri, key, cand))
        if not candidates:
            return None
        candidates.sort(key=lambda t: (t[0], t[1]))
        return candidates[0][2]

    def _patch_job_victim(self, victim: TPUJob, updates: dict) -> None:
        def attempt():
            return self.client.patch(
                TPUJob,
                victim.metadata.namespace,
                victim.metadata.name,
                {"metadata": {"annotations": updates}},
            )

        try:
            retry_on_conflict(attempt)
        except NotFoundError:
            pass  # deleted mid-reclaim; pressure re-judges next pass

    def _patch_endpoint_victim(
        self, victim: InferenceEndpoint, updates: dict
    ) -> None:
        def attempt():
            return self.client.patch(
                InferenceEndpoint,
                victim.metadata.namespace,
                victim.metadata.name,
                {"metadata": {"annotations": updates}},
            )

        try:
            retry_on_conflict(attempt)
        except NotFoundError:
            pass  # deleted mid-reclaim; pressure re-judges next pass

    def _matching_capacity_free(self, shape) -> bool:
        """True when a whole healthy, unreserved pool of the requester's
        shape has no GPU pods on it — a gang-placeable slice the scheduler
        simply hasn't bound yet."""
        from ..api.core import Node
        from ..cluster.slicepool import POOL_STATE_ANNOTATION
        from ..gpu import GKE_GPU_ACCELERATOR_LABEL, GPU_TOPOLOGY_LABEL

        occupied = set()
        for p in self.client.list(Pod):
            if p.spec.node_name and not p.metadata.deletion_timestamp:
                occupied.add(p.spec.node_name)
        pools: Dict[str, List] = {}
        for node in self.client.list(Node):
            labels = node.metadata.labels
            if labels.get(GKE_GPU_ACCELERATOR_LABEL) != shape.gke_accelerator:
                continue
            if labels.get(GPU_TOPOLOGY_LABEL) != shape.topology:
                continue
            pools.setdefault(
                labels.get(GKE_NODEPOOL_LABEL, node.metadata.name), []
            ).append(node)
        for nodes in pools.values():
            if len(nodes) < shape.hosts:
                continue
            free = all(
                n.metadata.name not in occupied
                and not n.metadata.annotations.get(POOL_STATE_ANNOTATION)
                # ONE health predicate with the pool (claim eligibility and
                # this free-capacity judgment must never drift apart)
                and self.pool.node_healthy(n)
                for n in nodes
            )
            if free:
                return True
        return False

    def _admitted_chips(self) -> int:
        return admitted_chip_demand(self.client)

    # ---------- helpers ----------

    def _sweep_pool(self, now: float) -> None:
        interval = max(1.0, self.config.readiness_probe_period_s * 6)
        if now - self._last_sweep < interval:
            return
        self._last_sweep = now
        self.pool.sweep()
        self.pool.refresh_gauges()

    def _pods(self, nb: Notebook) -> List[Pod]:
        return [
            p
            for p in self.client.list(
                Pod,
                namespace=nb.metadata.namespace,
                labels={C.NOTEBOOK_NAME_LABEL: nb.metadata.name},
            )
            if not p.metadata.deletion_timestamp
        ]

    def _pending_pods(self, nb: Notebook) -> List[Pod]:
        return [p for p in self._pods(nb) if not p.spec.node_name]

    def _slice_pool_of(self, pods: List[Pod]) -> str:
        """The node pool the gang occupies (gang placement guarantees one)."""
        from ..api.core import Node

        for p in pods:
            if not p.spec.node_name:
                continue
            try:
                node = self.client.get(Node, "", p.spec.node_name)
            except NotFoundError:
                continue
            return node.metadata.labels.get(GKE_NODEPOOL_LABEL, "")
        return ""

    def _pool_nodes(self, pool: str) -> List[str]:
        from ..api.core import Node

        return [
            n.metadata.name
            for n in self.client.list(Node)
            if n.metadata.labels.get(GKE_NODEPOOL_LABEL) == pool
        ]

    def _release_claims(
        self, key: str, back_to_warm: bool, nb: Optional[Notebook] = None
    ) -> None:
        """Drop (or re-warm) every pool claim held by `key`."""
        for entry in self.pool.entries(include_unhealthy=True):
            if entry.claimed_by != key:
                continue
            if back_to_warm:
                self.pool.release(
                    entry.pool, entry.nodes,
                    priority=entry.priority if nb is None
                    else notebook_priority(nb),
                )
            else:
                self.pool.unclaim(entry.pool)

    def _forget(self, key: str) -> None:
        self._ckpt_acked.pop(key, None)
        self._ckpt_checksums.pop(key, None)
        self._resume_deadline.pop(key, None)
        self._victim_cooldown.pop(key, None)

    @staticmethod
    def _clear_updates() -> dict:
        return {
            C.TPU_SUSPEND_STATE_ANNOTATION: None,
            C.TPU_SUSPEND_STARTED_ANNOTATION: None,
            C.TPU_SUSPENDED_AT_ANNOTATION: None,
            C.TPU_SUSPEND_CHECKPOINT_DEADLINE_ANNOTATION: None,
            C.TPU_RESUME_STARTED_ANNOTATION: None,
            C.TPU_RESUME_ATTEMPTS_ANNOTATION: None,
            C.TPU_RECLAIM_ANNOTATION: None,
        }

    def _patch_annotations(self, nb: Notebook, updates: dict) -> None:
        def attempt():
            return self.client.patch(
                Notebook,
                nb.metadata.namespace,
                nb.metadata.name,
                {"metadata": {"annotations": updates}},
            )

        try:
            retry_on_conflict(attempt)
        except NotFoundError:
            pass  # deleted mid-transition; the delete path forgets state

    def _patch_victim(self, victim: Notebook, updates: dict) -> None:
        self._patch_annotations(victim, updates)

    def _emit_event(
        self, nb: Notebook, reason: str, message: str, etype: str = "Warning"
    ) -> None:
        emit_deduped_event(
            self.client, nb, f"{nb.metadata.name}.{reason.lower()}",
            reason=reason, message=message, etype=etype,
            api_version=nb.api_version or "kubeflow.org/v1beta1",
            kind="Notebook",
        )
