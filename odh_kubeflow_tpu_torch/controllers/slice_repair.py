"""Slice-repair controller: survive the accelerator layer (the port's copy
of odh_kubeflow_tpu/controllers/slice_repair.py, on GPU slices).

Host preemptions and maintenance events, lost cards and degraded links take
down a whole multi-host slice at once, and without repair a preempted host
leaves the StatefulSet half-dead and the Notebook permanently Ready=False.

State machine (durable in annotations — the API server is the database —
mirrored into the `Degraded` condition for humans; analysis/machines.py
REPAIR_MACHINE declares it):

    Ready ──fault──> Degraded ──evict──> Repairing ──mesh ready──> Ready
                        │                    │
                        │ (checkpoint-       │ (bounded, jittered retry
                        │  before-evict      │  while capacity recovers)
                        │  window)           └──attempts exhausted──> RepairFailed

Fault detection, two layers:
- **node-level**: a pod's node carries the preemption taint / maintenance
  notice or has gone Ready=False (cluster/faults.py PREEMPTION_TAINT_KEY) —
  trusted immediately, a taint is not a transient,
- **device-level**: the `TPUHealthy` condition the probe gate aggregates from
  per-host /tpu/readiness reports (controllers/probe_status.py). ChipFailure
  (a card the host should see is gone) and ICIDegraded (a degraded link)
  are affirmative measurements from reachable agents and trigger immediately
  (when every pod is Ready — the devices are sick, not the pods);
  HostUnreachable must persist for a dwell before it counts, so a transient
  probe partition never evicts a healthy gang. The reasons keep the
  reference's names: they are part of the CR's API.

Repair path: coordinate a checkpoint-before-evict window (annotation-signaled;
every host's /tpu/checkpoint hook is driven — probe/agent.py wired to
models/checkpoint.py), evict the whole gang, and let the scheduler re-place it
all-or-nothing — landing in a different node pool of the same shape when the
original pool is short. While capacity recovers the controller retries with
bounded, jittered backoff; exhaustion is an explicit terminal `RepairFailed`
event, never a silently stuck notebook. The restarted workload re-forms its
process group and restores from the checkpoint
(parallel/distributed.py reinitialize_after_repair + models/checkpoint.py).

Telemetry closes the loop: interruption counters, the MTTR histogram, the
goodput integrator (telemetry.py) and `slice.repair` trace spans joined to
the notebook's readiness trace, so one preemption→ready-again episode is one
connected trace.
"""
from __future__ import annotations

import json
import logging
import random
import time
from typing import Dict, List, Optional, Tuple

from .. import telemetry
from ..api.core import Node, Pod, emit_deduped_event
from ..api.notebook import Notebook
from ..apimachinery import (
    NotFoundError,
    now_rfc3339,
    parse_time,
    rfc3339_precise,
)
from ..cluster.client import retry_on_conflict
from ..cluster.faults import MAINTENANCE_WINDOW_ANNOTATION, PREEMPTION_TAINT_KEY
from ..gpu import plan_slice
from ..runtime.controller import Request, Result
from ..runtime.flightrecorder import recorder
from ..runtime.manager import Manager
from ..utils.tracing import record_span
from . import constants as C
from .conditions import condition_is, get_condition, write_condition
from .config import Config
from .culling import HTTPGet, _default_http_get
from .notebook import per_ordinal_probe_urls

log = logging.getLogger(__name__)

# annotation values of the repair-state machine
STATE_DEGRADED = "degraded"
STATE_REPAIRING = "repairing"
STATE_FAILED = "failed"

# HostUnreachable (probe-measured absence) must persist this long before it
# becomes a repair trigger — affirmative faults (taints, chip/ICI reports)
# need no dwell. Overridable per-instance for tests.
DEFAULT_UNREACHABLE_DWELL_S = 15.0


class SliceRepairController:
    def __init__(
        self,
        manager: Manager,
        config: Optional[Config] = None,
        http_get: Optional[HTTPGet] = None,
    ):
        self.manager = manager
        self.client = manager.client
        # repair decisions and state transitions read fresh (the informer
        # cache after our own annotation writes is stale exactly in the
        # write-to-dispatch window)
        self.api_reader = manager.api_reader
        self.config = config or Config()
        self.http_get = http_get or _default_http_get
        self.unreachable_dwell_s = DEFAULT_UNREACHABLE_DWELL_S
        # in-memory only (best-effort across restarts; the durable machine
        # lives in annotations): goodput integrator anchors, next-attempt
        # deadlines, evict timestamps for the reschedule trace span, and
        # per-episode checkpoint acks (ordinal -> acked step) so a host that
        # saved once is not re-driven every poll of the window
        self._last_seen: Dict[str, float] = {}
        self._next_attempt: Dict[str, float] = {}
        self._evicted_at: Dict[str, float] = {}
        self._ckpt_acked: Dict[str, Dict[int, Optional[int]]] = {}
        # notebooks currently inside a repair episode, mirrored into the
        # tpu_slice_repairs_in_progress gauge (the alert manager's
        # slice-repair inhibitor reads it)
        self._in_repair: set = set()

    def setup(self) -> None:
        def pod_is_labeled(ev: str, obj: dict, old: Optional[dict]) -> bool:
            return C.NOTEBOOK_NAME_LABEL in obj.get("metadata", {}).get("labels", {})

        def map_pod(obj: dict) -> List[tuple]:
            meta = obj.get("metadata", {})
            name = meta.get("labels", {}).get(C.NOTEBOOK_NAME_LABEL)
            return [(meta.get("namespace", ""), name)] if name else []

        def map_node(obj: dict) -> List[tuple]:
            """Node events (taint landing, drain, restore) -> the notebooks
            whose pods sit on that node."""
            node_name = obj.get("metadata", {}).get("name", "")
            out = set()
            for p in self.client.list(Pod):
                if p.spec.node_name != node_name:
                    continue
                nb = p.metadata.labels.get(C.NOTEBOOK_NAME_LABEL)
                if nb:
                    out.add((p.metadata.namespace, nb))
            return sorted(out)

        (
            self.manager.builder("slice-repair")
            .for_(Notebook)
            .watches(Node, map_node)
            .watches(Pod, map_pod, predicate=pod_is_labeled)
            .with_workers(self.config.max_concurrent_reconciles)
            .complete(self.reconcile)
        )

    # ---------- reconcile ----------

    def reconcile(self, req: Request) -> Optional[Result]:
        try:
            # FRESH read: the state machine transitions on its own annotation
            # writes, and the cached view is stale exactly in the write-to-
            # informer-dispatch window — a cached read could re-enter a state
            # and double-count the interruption
            nb = self.api_reader.get(Notebook, req.namespace, req.name)
        except NotFoundError:
            self._forget(req.key)
            return None
        if nb.metadata.deletion_timestamp:
            self._forget(req.key)
            return None
        if nb.spec.tpu is None or not nb.spec.tpu.accelerator:
            return None  # CPU notebook: no slice to repair

        ann = nb.metadata.annotations
        state = ann.get(C.TPU_REPAIR_STATE_ANNOTATION, "")
        # gauge for the alert manager's inhibitor: an ACTIVE episode
        # (degraded/repairing) inhibits readiness-category alerts; terminal
        # RepairFailed does not — a permanently broken slice must page
        self._track_repair(req.key, state in (STATE_DEGRADED, STATE_REPAIRING))

        if C.STOP_ANNOTATION in ann:
            # stopped (user or culler): a scaled-away slice has nothing to
            # repair — abort any in-flight episode explicitly
            if state:
                self._patch_annotations(nb, self._clear_updates())
                write_condition(
                    self.client, self.api_reader, nb,
                    C.TPU_DEGRADED_CONDITION, "False", "Stopped",
                    "repair aborted: notebook stopped",
                )
            self._forget(req.key)
            return None

        if ann.get(C.TPU_SUSPEND_STATE_ANNOTATION):
            # suspend machine owns the slice (resuming: stop already cleared
            # but the warm-pool bind is in flight). A half-started resume
            # looks exactly like HostUnreachable — "repairing" (evicting) it
            # would race the suspend controller for the same warm slice.
            # Contract: repair waits; the suspend machine's own bounded
            # attempts + the reclaimer handle a wedged resume.
            if state:
                self._patch_annotations(nb, self._clear_updates())
                write_condition(
                    self.client, self.api_reader, nb,
                    C.TPU_DEGRADED_CONDITION, "False", "Suspended",
                    "repair aborted: suspend/resume machine owns the slice",
                )
            self._forget(req.key)
            return None

        now = time.time()
        # goodput integrator: every reconcile extends tracked lifetime; time
        # spent in any repair state is downtime
        last = self._last_seen.get(req.key)
        self._last_seen[req.key] = now
        if last is not None and now > last:
            telemetry.goodput.observe(
                now - last, downtime_s=(now - last) if state else 0.0
            )

        shape = plan_slice(
            nb.spec.tpu.accelerator, nb.spec.tpu.topology, nb.spec.tpu.chips
        )
        pods = [
            p
            for p in self.client.list(
                Pod,
                namespace=nb.metadata.namespace,
                labels={C.NOTEBOOK_NAME_LABEL: nb.metadata.name},
            )
            if not p.metadata.deletion_timestamp
        ]
        threat = self._detect(nb, pods, shape, now)

        # The pod-condition mirror (notebook.py) preserves repair-owned
        # conditions from ITS cached snapshot, so a stale snapshot can
        # resurrect an older Degraded value over a fresh write. Ownership is
        # therefore level-triggered: every pass re-asserts the condition the
        # current state implies (a no-op write when it already matches).
        if not state:
            if threat is None:
                cur = get_condition(nb, C.TPU_DEGRADED_CONDITION)
                if cur is not None and cur.status == "True":
                    self._assert_degraded(
                        nb, "False", "Repaired",
                        "slice healthy; stale Degraded condition healed",
                    )
                # steady-state heartbeat (probe-gate idiom): keeps detection
                # alive when events are missed AND gives the goodput
                # integrator fair samples of healthy time — purely
                # event-driven sampling clusters during repair and would
                # overstate downtime
                return Result(
                    requeue_after=max(1.0, self.config.readiness_probe_period_s * 6)
                )
            return self._enter_degraded(nb, threat, now)
        if state == STATE_DEGRADED:
            self._assert_degraded(
                nb, "True", nb.metadata.annotations.get(
                    C.TPU_REPAIR_CAUSE_ANNOTATION, "SliceDegraded"
                ),
                "slice degraded; checkpoint-before-evict window open",
            )
            return self._run_checkpoint_window(nb, shape, pods, now, req)
        if state == STATE_REPAIRING:
            self._assert_degraded(
                nb, "True", "Repairing",
                "gang evicted; waiting for all-or-nothing re-placement",
            )
            return self._await_repair(nb, shape, pods, threat, now, req)
        if state == STATE_FAILED:
            # terminal — but not a dead end: if the slice comes back anyway
            # (capacity restored, operator intervention), close the episode
            if self._slice_healthy(nb, pods, shape, threat):
                return self._complete(nb, now, req, after_failure=True)
            self._assert_degraded(
                nb, "True", "RepairFailed",
                "repair abandoned; operator attention required",
            )
            return None
        log.warning("unknown repair state %r on %s; clearing", state, req.key)
        self._patch_annotations(nb, {C.TPU_REPAIR_STATE_ANNOTATION: None})
        return Result(requeue_after=0.05)

    # ---------- detection ----------

    def _detect(
        self, nb: Notebook, pods: List[Pod], shape, now: float
    ) -> Optional[Tuple[str, str, Optional[float]]]:
        """(cause, message, evict_by_ts) or None. Node-level signals always
        count; device-level signals (TPUHealthy) per the dwell rules above."""
        for p in pods:
            if not p.spec.node_name:
                continue
            try:
                node = self.client.get(Node, "", p.spec.node_name)
            except NotFoundError:
                return (
                    "HostPreempted",
                    f"node {p.spec.node_name} is gone",
                    None,
                )
            tainted = any(
                t.get("key") == PREEMPTION_TAINT_KEY
                for t in node.spec.get("taints", [])
            )
            not_ready = any(
                c.type == "Ready" and c.status == "False"
                for c in node.status.conditions
            )
            if tainted or not_ready:
                evict_by = None
                notice = node.metadata.annotations.get(
                    MAINTENANCE_WINDOW_ANNOTATION, ""
                )
                if notice:
                    try:
                        evict_by = parse_time(notice).timestamp()
                    except ValueError:
                        evict_by = None
                return (
                    "HostPreempted",
                    f"host {node.metadata.name} "
                    + ("has a maintenance/preemption taint" if tainted else "is NotReady"),
                    evict_by,
                )

        cond = get_condition(nb, C.TPU_HEALTHY_CONDITION)
        if cond is None or cond.status != "False":
            return None
        ready_pods = sum(1 for p in pods if p.is_ready())
        reason = cond.reason or "TPUUnhealthy"
        if reason in ("ChipFailure", "ICIDegraded") and ready_pods >= shape.hosts:
            # affirmative device fault measured by reachable agents on a
            # fully-Ready gang: trust it immediately
            return reason, cond.message or reason, None
        persisted = 0.0
        if cond.last_transition_time:
            try:
                persisted = now - parse_time(cond.last_transition_time).timestamp()
            except ValueError:
                persisted = 0.0
        if persisted >= self.unreachable_dwell_s:
            # probe-measured absence (crashed agent, wedged host, half-dead
            # gang) that outlived the dwell: no longer a transient
            return (
                "HostUnreachable",
                cond.message or "hosts unreachable beyond the dwell window",
                None,
            )
        return None

    def _slice_healthy(
        self, nb: Notebook, pods: List[Pod], shape, threat
    ) -> bool:
        return (
            threat is None
            and nb.status.tpu is not None
            and nb.status.tpu.mesh_ready
            and condition_is(nb, C.TPU_HEALTHY_CONDITION, "True")
            and sum(1 for p in pods if p.is_ready()) >= shape.hosts
        )

    # ---------- state transitions ----------

    def _enter_degraded(
        self, nb: Notebook, threat: Tuple[str, str, Optional[float]], now: float
    ) -> Result:
        cause, message, evict_by = threat
        # fresh episode: no checkpoint acks carried over from a prior one
        self._ckpt_acked.pop(
            f"{nb.metadata.namespace}/{nb.metadata.name}", None
        )
        deadline = now + self.config.checkpoint_window_s
        if evict_by is not None:
            # the host is going away at evict_by regardless: the checkpoint
            # window must finish before the platform drains under us
            deadline = min(deadline, evict_by)
        self._patch_annotations(
            nb,
            {
                C.TPU_REPAIR_STATE_ANNOTATION: STATE_DEGRADED,
                C.TPU_REPAIR_STARTED_ANNOTATION: rfc3339_precise(now),
                C.TPU_REPAIR_CAUSE_ANNOTATION: cause,
                C.TPU_REPAIR_ATTEMPTS_ANNOTATION: "0",
                C.TPU_CHECKPOINT_REQUEST_ANNOTATION: rfc3339_precise(deadline),
            },
        )
        write_condition(
            self.client, self.api_reader, nb,
            C.TPU_DEGRADED_CONDITION, "True", cause, message,
        )
        self._emit_event(nb, "SliceDegraded", f"slice degraded ({cause}): {message}")
        telemetry.slice_interruptions_total.inc(cause=cause)
        key = f"{nb.metadata.namespace}/{nb.metadata.name}"
        self._track_repair(key, True)
        # flight recorder: the Degraded entry IS an incident — snapshot the
        # ring + CR/pod state now, while the evidence is still in the buffer
        recorder.record(
            "transition", machine="slice-repair", notebook=key,
            state=STATE_DEGRADED, cause=cause,
        )
        recorder.snapshot(
            "slice-degraded", subject=key, client=self.client,
            notebooks=[(nb.metadata.namespace, nb.metadata.name)],
            extra={"cause": cause, "message": message},
        )
        log.warning(
            "slice degraded: %s/%s (%s) — checkpoint window until %s",
            nb.metadata.namespace, nb.metadata.name, cause, rfc3339_precise(deadline),
        )
        return Result(requeue_after=0.01)

    def _run_checkpoint_window(
        self, nb: Notebook, shape, pods: List[Pod], now: float, req: Request
    ) -> Result:
        ann = nb.metadata.annotations
        deadline = now
        try:
            deadline = parse_time(
                ann.get(C.TPU_CHECKPOINT_REQUEST_ANNOTATION, "")
            ).timestamp()
        except ValueError:
            pass
        ready_pods = [p for p in pods if p.is_ready()]
        # which ORDINALS are ready right now (pod {sts}-{i}): only those can
        # ack, and every one of them must before an early proceed — counting
        # acks against a shifting ready-count could skip a live host's save
        ready_ordinals = set()
        for p in ready_pods:
            try:
                ready_ordinals.add(int(p.metadata.name.rsplit("-", 1)[1]))
            except (IndexError, ValueError):
                continue
        # drive only ready, not-yet-acked ordinals: a saved host must not
        # re-save on every poll, and a dead host's connect timeout must not
        # be paid every poll either
        acked = self._ckpt_acked.setdefault(req.key, {})
        pending = sorted(ready_ordinals - set(acked))
        if pending:
            for ordinal, ack in self._checkpoint_sweep(nb, shape.hosts, pending):
                if ack and ack.get("saved"):
                    acked[ordinal] = ack.get("step")
        # proceed when every currently-ready host acked, when nothing is
        # left to checkpoint, or when the window lapses — never block the
        # evict past the deadline (the platform's drain won't wait either)
        all_acked = bool(ready_ordinals) and ready_ordinals <= set(acked)
        if not (all_acked or not ready_pods or now >= deadline):
            # un-acked hosts left: re-poll at the probe cadence, not a tight
            # loop — each sweep can block on a dead host's connect timeout
            return Result(requeue_after=max(
                0.02,
                min(self.config.readiness_probe_period_s, deadline - now),
            ))

        updates = {
            C.TPU_REPAIR_STATE_ANNOTATION: STATE_REPAIRING,
            C.TPU_REPAIR_ATTEMPTS_ANNOTATION: "1",
            C.TPU_CHECKPOINT_REQUEST_ANNOTATION: None,
        }
        self._ckpt_acked.pop(req.key, None)
        if acked:
            telemetry.slice_checkpoint_saves_total.inc(len(acked))
            steps = [s for s in acked.values() if s is not None]
            if steps:
                # the contract: the LAST ACKED STEP, for the resumed
                # workload to restore — never a timestamp masquerading as one
                updates[C.TPU_CHECKPOINT_SAVED_ANNOTATION] = str(max(steps))
        started = self._started_ts(nb, now)
        record_span(
            "slice.checkpoint",
            traceparent=nb.metadata.annotations.get(C.TRACEPARENT_ANNOTATION),
            start_time=started,
            end_time=now,
            notebook=nb.metadata.name,
            hosts_acked=len(acked),
            hosts_ready=len(ready_pods),
        )
        self._patch_annotations(nb, updates)
        write_condition(
            self.client, self.api_reader, nb,
            C.TPU_DEGRADED_CONDITION, "True", "Repairing",
            f"gang evicted after checkpoint window ({len(acked)} hosts saved); "
            "waiting for all-or-nothing re-placement",
        )
        self._emit_event(
            nb, "SliceRepairing",
            f"evicting gang for repair ({len(acked)}/{shape.hosts} hosts "
            "checkpointed); rescheduling all-or-nothing",
        )
        self._evict(nb, pods)
        self._evicted_at[req.key] = now
        self._next_attempt[req.key] = now + self._backoff(1)
        recorder.record(
            "transition", machine="slice-repair", notebook=req.key,
            state=STATE_REPAIRING, hosts_acked=len(acked),
        )
        log.info(
            "slice repair: evicted gang of %s/%s (%d/%d hosts checkpointed)",
            nb.metadata.namespace, nb.metadata.name, len(acked), shape.hosts,
        )
        return Result(requeue_after=0.05)

    def _await_repair(
        self, nb: Notebook, shape, pods: List[Pod], threat, now: float, req: Request
    ) -> Optional[Result]:
        if self._slice_healthy(nb, pods, shape, threat):
            return self._complete(nb, now, req)

        # a rescheduled pod that landed on an unhealthy node (raced the taint)
        # poisons the gang: re-evict immediately, uncounted — this is a
        # placement race, not a capacity wait
        placed = [p for p in pods if p.spec.node_name]
        if any(not self._node_ok(p.spec.node_name) for p in placed):
            self._evict(nb, pods)
            return Result(requeue_after=0.05)

        deadline = self._next_attempt.get(req.key)
        ann = nb.metadata.annotations
        attempts = int(ann.get(C.TPU_REPAIR_ATTEMPTS_ANNOTATION, "1") or 1)
        if deadline is None:
            # controller restarted mid-repair: re-derive from the durable
            # attempt counter
            deadline = now + self._backoff(attempts)
            self._next_attempt[req.key] = deadline
        if now < deadline:
            return Result(requeue_after=max(0.02, deadline - now))

        # one full backoff window without recovery: count an attempt
        attempts += 1
        if attempts > self.config.repair_max_attempts:
            return self._fail(nb, now, req)
        self._patch_annotations(
            nb, {C.TPU_REPAIR_ATTEMPTS_ANNOTATION: str(attempts)}
        )
        self._next_attempt[req.key] = now + self._backoff(attempts)
        # a gang that sat out a whole window either half-placed (sibling
        # pinning holds it in a pool that cannot complete) or fully placed
        # under an AFFIRMATIVE threat (taint still there / devices still
        # sick: an evict raced or the replacement is equally bad) is wedged:
        # evict and let the scheduler try fresh, all-or-nothing, possibly
        # elsewhere. HostUnreachable deliberately does not count — it is
        # what a merely-slow bring-up looks like, and evicting on it would
        # loop a recovering gang back to zero.
        affirmative = threat is not None and threat[0] in (
            "HostPreempted", "ChipFailure", "ICIDegraded",
        )
        if placed and (len(placed) < shape.hosts or affirmative):
            self._evict(nb, pods)
        log.info(
            "slice repair: %s/%s still down (attempt %d/%d)",
            nb.metadata.namespace, nb.metadata.name,
            attempts, self.config.repair_max_attempts,
        )
        return Result(requeue_after=max(0.02, self._next_attempt[req.key] - now))

    def _complete(
        self, nb: Notebook, now: float, req: Request, after_failure: bool = False
    ) -> Optional[Result]:
        ann = nb.metadata.annotations
        started = self._started_ts(nb, now)
        mttr = max(0.0, now - started)
        cause = ann.get(C.TPU_REPAIR_CAUSE_ANNOTATION, "")
        attempts = ann.get(C.TPU_REPAIR_ATTEMPTS_ANNOTATION, "")
        telemetry.slice_repair_duration_seconds.observe(mttr)
        telemetry.slice_repairs_total.inc(result="repaired")
        span = record_span(
            "slice.repair",
            traceparent=ann.get(C.TRACEPARENT_ANNOTATION),
            start_time=started,
            end_time=now,
            notebook=nb.metadata.name,
            namespace=nb.metadata.namespace,
            cause=cause,
            attempts=attempts,
            mttr_s=round(mttr, 3),
            result="repaired" if not after_failure else "repaired-after-failure",
        )
        evicted = self._evicted_at.pop(req.key, None)
        if evicted is not None and span is not None:
            record_span(
                "slice.reschedule",
                traceparent=span.traceparent,
                start_time=evicted,
                end_time=now,
                notebook=nb.metadata.name,
            )
        updates = self._clear_updates()
        # culling-clock contract: the repair window must not count as
        # idleness — restart the idle clock at repair completion
        updates[C.LAST_ACTIVITY_ANNOTATION] = now_rfc3339()
        updates[C.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION] = now_rfc3339()
        self._patch_annotations(nb, updates)
        write_condition(
            self.client, self.api_reader, nb,
            C.TPU_DEGRADED_CONDITION, "False", "Repaired",
            f"slice repaired in {mttr:.1f}s ({cause})",
        )
        self._emit_event(
            nb, "SliceRepaired",
            f"slice repaired in {mttr:.1f}s (cause: {cause or 'unknown'}, "
            f"attempts: {attempts or '1'})",
            etype="Normal",
        )
        self._next_attempt.pop(req.key, None)
        self._track_repair(req.key, False)
        recorder.record(
            "transition", machine="slice-repair", notebook=req.key,
            state="ready", mttr_s=round(mttr, 3), cause=cause,
        )
        log.info(
            "slice repaired: %s/%s in %.2fs (%s)",
            nb.metadata.namespace, nb.metadata.name, mttr, cause,
        )
        return None

    def _fail(self, nb: Notebook, now: float, req: Request) -> Optional[Result]:
        ann = nb.metadata.annotations
        started = self._started_ts(nb, now)
        cause = ann.get(C.TPU_REPAIR_CAUSE_ANNOTATION, "")
        telemetry.slice_repairs_total.inc(result="failed")
        record_span(
            "slice.repair",
            traceparent=ann.get(C.TRACEPARENT_ANNOTATION),
            start_time=started,
            end_time=now,
            notebook=nb.metadata.name,
            namespace=nb.metadata.namespace,
            cause=cause,
            result="failed",
        )
        self._patch_annotations(
            nb, {C.TPU_REPAIR_STATE_ANNOTATION: STATE_FAILED}
        )
        msg = (
            f"repair abandoned after {self.config.repair_max_attempts} "
            f"attempts (cause: {cause or 'unknown'}); slice capacity never "
            "recovered — operator attention required"
        )
        write_condition(
            self.client, self.api_reader, nb,
            C.TPU_DEGRADED_CONDITION, "True", "RepairFailed", msg,
        )
        self._emit_event(nb, "RepairFailed", msg)
        self._next_attempt.pop(req.key, None)
        self._evicted_at.pop(req.key, None)
        self._track_repair(req.key, False)
        recorder.record(
            "transition", machine="slice-repair", notebook=req.key,
            state=STATE_FAILED, cause=cause,
        )
        recorder.snapshot(
            "repair-failed", subject=req.key, client=self.client,
            notebooks=[(nb.metadata.namespace, nb.metadata.name)],
            extra={"cause": cause, "attempts": self.config.repair_max_attempts},
        )
        log.error("slice repair FAILED: %s/%s (%s)",
                  nb.metadata.namespace, nb.metadata.name, cause)
        return None

    # ---------- checkpoint sweep ----------

    CHECKPOINT_TIMEOUT_S = 2.0

    def _checkpoint_sweep(
        self, nb: Notebook, hosts: int, ordinals: List[int]
    ) -> List[Tuple[int, Optional[dict]]]:
        """Drive the given ordinals' /tpu/checkpoint hooks concurrently
        (same transport/addressing as the readiness gate); (ordinal, None)
        for unreachable hosts."""
        from concurrent.futures import ThreadPoolExecutor

        def probe(url: str) -> Optional[dict]:
            try:
                try:
                    status, body = self.http_get(url, timeout=self.CHECKPOINT_TIMEOUT_S)
                except TypeError:  # custom http_get without timeout kwarg
                    status, body = self.http_get(url)
                if status != 200:
                    raise ConnectionError(f"GET {url} -> {status}")
                return json.loads(body.decode() or "null")
            except Exception as e:
                log.debug("checkpoint probe %s unreachable: %s", url, e)
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

    # ---------- helpers ----------

    def _assert_degraded(
        self, nb: Notebook, status: str, reason: str, message: str
    ) -> None:
        """Re-assert the owned Degraded condition when status/reason drifted
        (stale mirror snapshot); keeps the richer original message when the
        condition is already right, so steady state costs zero writes."""
        cur = get_condition(nb, C.TPU_DEGRADED_CONDITION)
        if cur is not None and cur.status == status and cur.reason == reason:
            return
        write_condition(
            self.client, self.api_reader, nb,
            C.TPU_DEGRADED_CONDITION, status, reason, message,
        )

    def _node_ok(self, node_name: str) -> bool:
        try:
            node = self.client.get(Node, "", node_name)
        except NotFoundError:
            return False
        if any(
            t.get("key") == PREEMPTION_TAINT_KEY
            for t in node.spec.get("taints", [])
        ):
            return False
        return not any(
            c.type == "Ready" and c.status == "False"
            for c in node.status.conditions
        )

    def _evict(self, nb: Notebook, pods: List[Pod]) -> None:
        """Delete the whole gang: the StatefulSet recreates every ordinal and
        the scheduler re-places them all-or-nothing (a fresh gang — no
        sibling pinning — so a healthy pool of the same topology can win)."""
        for p in pods:
            try:
                self.client.delete(Pod, p.metadata.namespace, p.metadata.name)
            except NotFoundError:
                pass  # racing drain/scale-down deleted it first

    def _backoff(self, attempts: int) -> float:
        base = min(
            self.config.repair_backoff_max_s,
            self.config.repair_backoff_s * (2 ** max(0, attempts - 1)),
        )
        # jitter so a pool-wide preemption's repairs don't re-place in
        # lockstep against the recovering capacity
        return base * (0.75 + 0.5 * random.random())

    def _started_ts(self, nb: Notebook, fallback: float) -> float:
        try:
            return parse_time(
                nb.metadata.annotations.get(C.TPU_REPAIR_STARTED_ANNOTATION, "")
            ).timestamp()
        except ValueError:
            return fallback

    @staticmethod
    def _clear_updates() -> dict:
        return {
            C.TPU_REPAIR_STATE_ANNOTATION: None,
            C.TPU_REPAIR_STARTED_ANNOTATION: None,
            C.TPU_REPAIR_CAUSE_ANNOTATION: None,
            C.TPU_REPAIR_ATTEMPTS_ANNOTATION: None,
            C.TPU_CHECKPOINT_REQUEST_ANNOTATION: None,
        }

    def _track_repair(self, key: str, active: bool) -> None:
        if active:
            self._in_repair.add(key)
        else:
            self._in_repair.discard(key)
        # written unconditionally (not only on change): the gauge is
        # process-global, and a controller stopped mid-episode leaves a
        # stale non-zero value a fresh instance's empty set would otherwise
        # never overwrite — permanently inhibiting readiness alerts
        telemetry.slice_repairs_in_progress.set(float(len(self._in_repair)))

    def _forget(self, key: str) -> None:
        self._last_seen.pop(key, None)
        self._next_attempt.pop(key, None)
        self._evicted_at.pop(key, None)
        self._ckpt_acked.pop(key, None)
        self._track_repair(key, False)

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

    def _emit_event(
        self, nb: Notebook, reason: str, message: str, etype: str = "Warning"
    ) -> None:
        """One Event per notebook+reason, deduplicated Kubernetes-style via
        the shared emitter (api/core.py emit_deduped_event — same mechanics
        as the scheduler's Unschedulable events)."""
        emit_deduped_event(
            self.client, nb, f"{nb.metadata.name}.{reason.lower()}",
            reason=reason, message=message, etype=etype,
            api_version=nb.api_version or "kubeflow.org/v1beta1",
            kind="Notebook",
        )
