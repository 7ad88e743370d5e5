"""Systematic interleaving explorer for the state machines of the port's
operator (the port's copy of odh_kubeflow_tpu/analysis/explore.py, on GPU
slices: an h100 1x4 slice where the reference plans a v5e 2x2, both one
host of four devices).

The dynamic half of the verification subsystem: drive the REAL controllers
(culling, suspend/resume, slice-repair — not models of them) one reconcile
at a time against an in-process Store, and let a deterministic DPOR-lite
scheduler enumerate interleavings of those steps with fault-injector ops
(host preemption/restore), a rival pool-CAS attempt, and the cluster model's
pod lifecycle — asserting the global invariants (utils/invcheck.py) after
EVERY store write and the steady-state contracts at quiescence.

Scheduler model (CHESS-style bounded search):

- every operation is atomic (one reconcile call / one fault op); the unit
  of interleaving is the operation, so intra-reconcile TOCTOU windows are
  deliberately out of scope — those are the RACECHECK lane's job,
- an op that runs without changing the store resourceVersion is QUIESCED
  until someone else makes progress; a leaf (fully-explored schedule) is
  reached when every repeatable op is quiesced and every one-shot op ran,
- switching away from an actor that still has work counts as a PREEMPTION;
  schedules are enumerated exhaustively within (max_depth, max_preemptions)
  and deduplicated by a normalized state hash (uids/resourceVersions/
  timestamps stripped), so permutations of no-op steps collapse,
- everything is seeded and wall-clock-free in its CONTROL FLOW (controller
  backoff windows are configured far past the run, retry jitter damped), so
  a violating schedule replays exactly and minimizes by greedy delta
  reduction — the finding ships the minimized interleaving trace.

Known-bad mutants (the explorer must be able to FAIL, or a green run means
nothing): `skip-checkpoint` suspends straight past the checkpoint window
(no checkpoint-saved evidence), `cas-blind` claims warm slices while
ignoring the lead-node CAS. `explore_mutant()` deterministically reproduces
each as a minimized trace; tests/test_torch_explore.py pins both against
the reference's traces.
"""
# this module IS the verification harness: the scenario setup writes state
# annotations as premises, the unstop op models the user's kubectl patch,
# and the mutants exist to violate the machine contract on purpose — the
# machine-conformance checker must not police its own test bench
# lint: disable-file=machine-conformance
from __future__ import annotations

import copy
import hashlib
import itertools
import json
import random
import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..api.core import Container, Node, Pod
from ..api.notebook import Notebook, TPUSpec, TPUStatus
from ..apimachinery import Condition, NotFoundError
from ..cluster.slicepool import (
    POOL_CLAIMED_BY_ANNOTATION,
    POOL_PRIORITY_ANNOTATION,
    POOL_SINCE_ANNOTATION,
    POOL_STATE_ANNOTATION,
    POOL_STATE_WARM,
    SlicePool,
)
from ..cluster.store import Store
from ..controllers import constants as C
from ..controllers.config import Config
from ..controllers.culling import CullingReconciler
from ..controllers.slice_repair import SliceRepairController
from ..controllers.suspend import SuspendResumeController
from ..runtime.controller import Request
from ..gpu import (
    GKE_GPU_ACCELERATOR_LABEL,
    GKE_NODEPOOL_LABEL,
    GPU_RESOURCE,
    GPU_TOPOLOGY_LABEL,
    plan_slice,
)
from ..runtime.manager import Manager
from ..utils import invcheck

NS = "explore"
OLD_TS = "2020-01-01T00:00:00Z"

# control flow must not depend on wall clock: cull thresholds zero (always
# idle, always due), checkpoint windows generous (the fake agents ack on
# the first sweep, so windows close by all-acked, never by deadline), and
# retry/backoff deadlines far past any run (waiting states quiesce instead
# of burning attempts)
EXPLORE_CONFIG = Config(
    enable_culling=True,
    suspend_enabled=True,
    cull_idle_time_min=0.0,
    idleness_check_period_min=0.0,
    readiness_probe_period_s=1000.0,
    suspend_checkpoint_window_s=600.0,
    suspend_checkpoint_retries=0,
    suspend_checkpoint_backoff_s=0.0,
    resume_timeout_s=36000.0,
    resume_max_attempts=10,
    reclaim_pending_grace_s=0.0,
    checkpoint_window_s=600.0,
    repair_max_attempts=1000,
    repair_backoff_s=36000.0,
    repair_backoff_max_s=36000.0,
    # job machine: generous checkpoint window (acks instant, so
    # windows close by all-acked), cadence never fires on wall clock (the
    # preempt op is the only checkpoint trigger), requeue backoff off,
    # bind timeout far past the run (a threshold that can lapse mid-
    # exploration makes schedules irreproducible)
    job_checkpoint_window_s=600.0,
    job_requeue_backoff_s=0.0,
    job_admission_timeout_s=36000.0,
)


def fake_http_get(url: str, timeout: float = 0.0) -> Tuple[int, bytes]:
    """Deterministic in-pod agent: kernels idle since the epoch of boredom,
    device duty cycle zero, checkpoint hooks ack instantly (the agent's
    routes keep the reference's /tpu/ paths)."""
    if "/api/kernels" in url:
        body = [{"execution_state": "idle", "last_activity": OLD_TS}]
    elif "/api/terminals" in url:
        body = []
    elif "/tpu/utilization" in url:
        body = {"duty_cycle": 0.0, "last_busy": OLD_TS}
    elif "/tpu/checkpoint" in url:
        body = {"saved": True, "step": 100}
    else:
        body = {}
    return 200, json.dumps(body).encode()


# ---------------------------------------------------------------------------
# mutants — the seeded known-bad fixtures
# ---------------------------------------------------------------------------


class SkipCheckpointSuspendController(SuspendResumeController):
    """MUTANT: the suspend transition skips the checkpoint window — straight
    checkpointing -> suspended with no /tpu/checkpoint sweep and no
    checkpoint-saved record. Violates the `checkpoint-before-suspend`
    invariant on the first suspend of a notebook with live ready hosts."""

    def _run_checkpoint_window(self, nb, shape, now, req):
        from ..apimachinery import rfc3339_precise

        pods = self._pods(nb)
        pool_name = self._slice_pool_of(pods)
        if pool_name and not nb.metadata.annotations.get(C.TPU_RECLAIM_ANNOTATION):
            self.pool.release(pool_name, self._pool_nodes(pool_name))
        self._patch_annotations(
            nb,
            {
                C.TPU_SUSPEND_STATE_ANNOTATION: "suspended",
                C.TPU_SUSPENDED_AT_ANNOTATION: rfc3339_precise(now),
                C.TPU_SUSPEND_CHECKPOINT_DEADLINE_ANNOTATION: None,
            },
        )
        return None


class CASBlindSlicePool(SlicePool):
    """MUTANT: pool claims ignore the lead-node CAS — a blind re-read-and-
    overwrite on Conflict, no expect_state guard. Two racing claimants both
    'win'; the second steals the first's claim, which the `pool-claim-cas`
    invariant catches at the stealing write."""

    def _stamp(self, node_name, updates, expect_state=SlicePool._ANY_STATE):
        from ..apimachinery import ConflictError

        for _ in range(3):
            try:
                node = self.client.get(Node, "", node_name)
            except NotFoundError:
                return False
            # BUG under test: no expect_state re-judge, conflicts ignored
            for key, value in updates.items():
                if value is None:
                    node.metadata.annotations.pop(key, None)
                else:
                    node.metadata.annotations[key] = value
            try:
                self.client.update(node)
                return True
            except ConflictError:
                continue
            except NotFoundError:
                return False
        return False

    def claim(self, gke_accelerator, topology, notebook_key):
        # ...and claims don't even require warm (the entries() filter is the
        # polite half of the contract this mutant discards)
        for entry in self.entries(include_unhealthy=True):
            if entry.accelerator != gke_accelerator or entry.topology != topology:
                continue
            for name in entry.nodes:
                self._stamp(name, {
                    POOL_STATE_ANNOTATION: "claimed",
                    POOL_CLAIMED_BY_ANNOTATION: notebook_key,
                })
            return entry
        return None


# ---------------------------------------------------------------------------
# the world: real controllers over a bare store, plus a deterministic
# cluster model standing in for scheduler/statefulset/kubelet
# ---------------------------------------------------------------------------


@dataclass
class Op:
    name: str
    fn: Callable[["World"], None]
    once: bool = False
    after: Optional[str] = None  # one-shot ordering (restore needs preempt)


class World:
    """One freshly-built scenario. Snapshot/restore is what makes DFS over
    interleavings affordable: store buckets are dicts of canonical-JSON
    strings and controller scratch state is a handful of small dicts."""

    def __init__(self, suspend_cls=SuspendResumeController,
                 pool_cls=None, chip_budget: int = 8):
        self.monitor = invcheck.Monitor(
            extra={
                "checkpoint-before-suspend":
                    invcheck.check_checkpoint_before_suspend,
            },
            collect=True,
            chip_budget=chip_budget,
        )
        # snapshot/restore reaches into the store's buckets (_PyBucket._objs:
        # the port's store is pure Python). The collecting monitor is
        # injected explicitly so an ambient INVCHECK=1 cannot swap in a
        # raising one mid-construction.
        self.store = Store(invariants=self.monitor)
        self.manager = Manager(self.store, cached_reads=False)
        self.client = self.manager.client
        cfg = EXPLORE_CONFIG
        self.culler = CullingReconciler(self.manager, cfg, http_get=fake_http_get)
        self.suspend = suspend_cls(self.manager, cfg, http_get=fake_http_get)
        self.repair = SliceRepairController(self.manager, cfg, http_get=fake_http_get)
        self.repair.unreachable_dwell_s = 1e9  # taints only; no probe dwell
        if pool_cls is not None:
            self.suspend.pool = pool_cls(self.manager.client)
        self.rival_pool = (pool_cls or SlicePool)(self.manager.client)
        self.shape = plan_slice("h100", "1x4", 0)
        self._setup()
        # the scenario's initial objects are a premise, not transitions —
        # anything the setup writes tripped is discarded before ops run
        self.monitor.reset()

    # ---------- initial scenario ----------

    def _add_node(self, name: str, pool: str) -> None:
        node = Node()
        node.metadata.name = name
        node.metadata.labels.update({
            GKE_NODEPOOL_LABEL: pool,
            GKE_GPU_ACCELERATOR_LABEL: self.shape.gke_accelerator,
            GPU_TOPOLOGY_LABEL: self.shape.topology,
        })
        node.status.capacity[GPU_RESOURCE] = str(self.shape.chips_per_host)
        node.status.conditions.append(Condition(type="Ready", status="True"))
        self.client.create(node)

    def _add_nb(self, name: str, annotations: Dict[str, str]) -> None:
        nb = Notebook()
        nb.metadata.name = name
        nb.metadata.namespace = NS
        nb.metadata.annotations.update(annotations)
        nb.spec.template.spec.containers = [Container(name=name, image="torch:1")]
        nb.spec.tpu = TPUSpec(accelerator="h100", topology="1x4")
        self.client.create(nb)

    def _setup(self) -> None:
        self._add_node("node-a", "pool-a")
        self._add_node("node-b", "pool-b")
        # nb1: active and idle on pool-a — the culler's next victim
        self._add_nb("nb1", {
            C.LAST_ACTIVITY_ANNOTATION: OLD_TS,
            C.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION: OLD_TS,
        })
        self._bind("nb1", "node-a")
        # nb2: already suspended warm on pool-b — resumes when unstopped
        self._add_nb("nb2", {
            C.STOP_ANNOTATION: OLD_TS,
            C.TPU_SUSPEND_STATE_ANNOTATION: "suspended",
            C.TPU_SUSPENDED_AT_ANNOTATION: OLD_TS,
            C.TPU_CHECKPOINT_SAVED_ANNOTATION: "100",
        })
        node = self.client.get(Node, "", "node-b")
        node.metadata.annotations.update({
            POOL_STATE_ANNOTATION: POOL_STATE_WARM,
            POOL_SINCE_ANNOTATION: OLD_TS,
            POOL_PRIORITY_ANNOTATION: "0",
        })
        self.client.update(node)

    # ---------- cluster model (scheduler + statefulset + kubelet) ----------

    def _pods(self, name: str) -> List[Pod]:
        return [
            p for p in self.client.list(
                Pod, namespace=NS, labels={C.NOTEBOOK_NAME_LABEL: name}
            )
            if not p.metadata.deletion_timestamp
        ]

    def _node_free_for(self, node: Node, nb_key: str) -> bool:
        if any(t.get("key") for t in node.spec.get("taints", [])):
            return False
        if any(c.type == "Ready" and c.status == "False"
               for c in node.status.conditions):
            return False
        state = node.metadata.annotations.get(POOL_STATE_ANNOTATION)
        if state == POOL_STATE_WARM:
            return False  # reserved: the scheduler places nobody here
        if state == "claimed" and node.metadata.annotations.get(
                POOL_CLAIMED_BY_ANNOTATION) != nb_key:
            return False
        occupied = {
            p.spec.node_name
            for p in self.client.list(Pod)
            if p.spec.node_name and not p.metadata.deletion_timestamp
        }
        return node.metadata.name not in occupied

    def _bind(self, name: str, node_name: str) -> None:
        pod = Pod()
        pod.metadata.name = f"{name}-0"
        pod.metadata.namespace = NS
        pod.metadata.labels[C.NOTEBOOK_NAME_LABEL] = name
        pod.spec.node_name = node_name
        pod.status.phase = "Running"
        pod.status.conditions.append(Condition(type="Ready", status="True"))
        self.client.create(pod)
        self._mirror_status(name)

    def _mirror_status(self, name: str) -> None:
        try:
            nb = self.client.get(Notebook, NS, name)
        except NotFoundError:
            return
        pods = self._pods(name)
        ready = sum(1 for p in pods if p.is_ready())
        mesh = ready >= self.shape.hosts
        tpu = nb.status.tpu or TPUStatus()
        if (nb.status.ready_replicas, tpu.mesh_ready) == (ready, mesh):
            return
        tpu.mesh_ready = mesh
        tpu.chips_visible = self.shape.chips if mesh else 0
        nb.status.ready_replicas = ready
        nb.status.tpu = tpu
        if mesh:
            from ..controllers.conditions import upsert_condition

            upsert_condition(
                nb.status.conditions, C.TPU_HEALTHY_CONDITION, "True",
                "AllDevicesHealthy", "",
            )
        self.client.update_status(nb)

    def cluster_step(self, name: str) -> None:
        """One deterministic pass of the cluster side for one notebook:
        scale down a suspended slice, place/bind a wanted pod (honoring
        warm/claimed pool reservations), mirror pod facts into status."""
        try:
            nb = self.client.get(Notebook, NS, name)
        except NotFoundError:
            return
        ann = nb.metadata.annotations
        stopped = (
            C.STOP_ANNOTATION in ann
            and ann[C.STOP_ANNOTATION] != C.RECONCILIATION_LOCK_VALUE
        )
        state = ann.get(C.TPU_SUSPEND_STATE_ANNOTATION, "")
        # notebook.py's replica hold: checkpointing keeps the slice up
        desired = 0 if (stopped and state != "checkpointing") else 1
        pods = self._pods(name)
        if desired == 0:
            for p in pods:
                self.client.delete(Pod, NS, p.metadata.name)
            if pods:
                self._mirror_status(name)
            return
        if not pods:
            nb_key = f"{NS}/{name}"
            for node in sorted(self.client.list(Node),
                               key=lambda n: n.metadata.name):
                if self._node_free_for(node, nb_key):
                    self._bind(name, node.metadata.name)
                    return
            # no capacity: a pending pod is the reclaimer's pressure signal
            pod = Pod()
            pod.metadata.name = f"{name}-0"
            pod.metadata.namespace = NS
            pod.metadata.labels[C.NOTEBOOK_NAME_LABEL] = name
            self.client.create(pod)
            return
        pending = [p for p in pods if not p.spec.node_name]
        nb_key = f"{NS}/{name}"
        for p in pending:
            for node in sorted(self.client.list(Node),
                               key=lambda n: n.metadata.name):
                if self._node_free_for(node, nb_key):
                    p.spec.node_name = node.metadata.name
                    p = self.client.update(p)
                    # status is a subresource: Ready must land separately
                    p.status.phase = "Running"
                    p.status.conditions = [Condition(type="Ready", status="True")]
                    self.client.update_status(p)
                    break
        self._mirror_status(name)

    # ---------- fault / scripted ops ----------

    def preempt(self, node_name: str) -> None:
        from ..cluster.faults import PREEMPTION_TAINT_KEY

        node = self.client.get(Node, "", node_name)
        taints = node.spec.setdefault("taints", [])
        taints.append({"key": PREEMPTION_TAINT_KEY, "effect": "NoSchedule"})
        node = self.client.update(node)
        for cond in node.status.conditions:
            if cond.type == "Ready":
                cond.status = "False"
        self.client.update_status(node)

    def restore(self, node_name: str) -> None:
        node = self.client.get(Node, "", node_name)
        node.spec["taints"] = []
        node = self.client.update(node)
        for cond in node.status.conditions:
            if cond.type == "Ready":
                cond.status = "True"
        self.client.update_status(node)

    def unstop(self, name: str) -> None:
        self.client.patch(
            Notebook, NS, name,
            {"metadata": {"annotations": {C.STOP_ANNOTATION: None}}},
        )

    def rival_cas(self) -> None:
        """A racing resume: claim any matching slice, then abandon the bind
        and return it warm — the CAS-contention probe. With the honest pool
        the loser backs off cleanly; the cas-blind mutant steals instead."""
        entry = self.rival_pool.claim(
            self.shape.gke_accelerator, self.shape.topology, f"{NS}/rival"
        )
        if entry is not None:
            self.rival_pool.release(entry.pool, entry.nodes)

    # ---------- op table ----------

    def ops(self) -> List[Op]:
        def reconcile(ctrl, name):
            return lambda w: ctrl.reconcile(Request(namespace=NS, name=name))

        return [
            Op("cull-1", reconcile(self.culler, "nb1")),
            Op("suspend-1", reconcile(self.suspend, "nb1")),
            Op("suspend-2", reconcile(self.suspend, "nb2")),
            Op("repair-1", reconcile(self.repair, "nb1")),
            # one cluster actor (scheduler/sts/kubelet act as one serialized
            # control loop here — pod-level sub-interleavings are the
            # RACECHECK soaks' territory)
            Op("cluster", lambda w: (w.cluster_step("nb1"),
                                     w.cluster_step("nb2"))),
            Op("unstop-2", lambda w: w.unstop("nb2"), once=True),
            Op("preempt-a", lambda w: w.preempt("node-a"), once=True),
            Op("restore-a", lambda w: w.restore("node-a"), once=True,
               after="preempt-a"),
            Op("rival-cas", lambda w: w.rival_cas(), once=True),
        ]

    # ---------- snapshot / restore ----------

    def snapshot(self) -> dict:
        return {
            "buckets": {
                skey: dict(bucket._objs)
                for skey, bucket in self.store._objects.items()
            },
            "last_rv": self.store._last_rv,
            "violations": len(self.monitor.violations),
            "suspend": copy.deepcopy({
                "acked": self.suspend._ckpt_acked,
                "deadline": self.suspend._resume_deadline,
                "cooldown": self.suspend._victim_cooldown,
                "sweep": self.suspend._last_sweep,
            }),
            "repair": copy.deepcopy({
                "seen": self.repair._last_seen,
                "next": self.repair._next_attempt,
                "evicted": self.repair._evicted_at,
                "acked": self.repair._ckpt_acked,
                "in_repair": self.repair._in_repair,
            }),
        }

    def restore_snapshot(self, snap: dict) -> None:
        self.store._objects = {}
        for skey, objs in snap["buckets"].items():
            bucket = self.store._bucket(*skey)
            bucket._objs = dict(objs)
        self.store._last_rv = snap["last_rv"]
        self.store._rv = itertools.count(snap["last_rv"] + 1)
        self.store._history.clear()
        self.store._history_dropped_rv.clear()
        # resourceVersions are REUSED across sibling branches after a
        # restore, so an rv-keyed hash from another branch would lie
        self._hash_cache = (-1, "")
        del self.monitor.violations[snap["violations"]:]
        s = copy.deepcopy(snap["suspend"])
        self.suspend._ckpt_acked = s["acked"]
        self.suspend._resume_deadline = s["deadline"]
        self.suspend._victim_cooldown = s["cooldown"]
        self.suspend._last_sweep = s["sweep"]
        r = copy.deepcopy(snap["repair"])
        self.repair._last_seen = r["seen"]
        self.repair._next_attempt = r["next"]
        self.repair._evicted_at = r["evicted"]
        self.repair._ckpt_acked = r["acked"]
        self.repair._in_repair = r["in_repair"]

    # ---------- normalized state hash ----------

    def scratch_token(self) -> Tuple:
        """Controller in-memory scratch, normalized for the memo key: two
        schedules are only equivalent when the controllers REMEMBER the
        same things, not just when the store matches (a parked backoff
        deadline vs none changes what the next reconcile does). Wall-clock
        floats reduce to presence — within a run every deadline is either
        unset or far-future by construction. (repair._last_seen is
        deliberately absent: it only feeds the goodput integrator, never a
        branch.)"""
        def keyed(d: Dict) -> Tuple:
            return tuple(sorted(d))

        return (
            tuple(sorted(
                (k, tuple(sorted(v.items())))
                for k, v in self.suspend._ckpt_acked.items()
            )),
            keyed(self.suspend._resume_deadline),
            keyed(self.suspend._victim_cooldown),
            bool(self.suspend._last_sweep),
            tuple(sorted(
                (k, tuple(sorted(v.items())))
                for k, v in self.repair._ckpt_acked.items()
            )),
            keyed(self.repair._next_attempt),
            keyed(self.repair._evicted_at),
            tuple(sorted(self.repair._in_repair)),
        )

    _TS_RE = re.compile(
        r"\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}(\.\d+)?(Z|\+00:00)?|\d+\.\d+"
    )
    _hash_cache: Tuple[int, str] = (-1, "")

    def state_hash(self) -> str:
        # the store is the only hashed state, so the hash is valid as long
        # as the last resourceVersion is (no-op drains re-use it for free)
        if self._hash_cache[0] == self.store._last_rv:
            return self._hash_cache[1]
        view = []
        for (av, kind) in sorted(self.store._objects):
            if kind == "Event":
                continue  # dedup counters/timestamps, not machine state
            for key, raw in sorted(self.store._objects[(av, kind)]._objs.items()):
                obj = json.loads(raw)
                meta = obj.get("metadata", {})
                for f in ("uid", "resourceVersion", "creationTimestamp",
                          "generation"):
                    meta.pop(f, None)
                view.append((kind, key, obj))
        text = self._TS_RE.sub("<t>", json.dumps(view, sort_keys=True))
        digest = hashlib.sha256(text.encode()).hexdigest()
        self._hash_cache = (self.store._last_rv, digest)
        return digest


class JobWorld(World):
    """World + the third workload class: a batch TPUJob whose
    admission warm-claims the suspended nb2's slice, so nb2's resume is a
    pool miss that pressures the reclaimer into the job — the full
    job-vs-suspend-vs-reclaim interleaving space (warm-claim admission,
    checkpoint-before-preempt, requeue, re-admission) driven through the
    REAL TPUJobReconciler and the REAL reclaimer.

    `churn_ops` adds the base world's cull/suspend actors for nb1 on top —
    the full three-actor churn space (the slow tier; the tight default
    keeps nb1 as static occupancy so the tier-1 run exhausts in seconds)."""

    def __init__(self, churn_ops: bool = False, **kw):
        super().__init__(**kw)
        from ..controllers.job import TPUJobReconciler

        self.churn_ops = churn_ops
        self.job = TPUJobReconciler(
            self.manager, EXPLORE_CONFIG, http_get=fake_http_get
        )
        self._add_job("job1")

    def _add_job(self, name: str) -> None:
        from ..api.job import TPUJob

        job = TPUJob()
        job.metadata.name = name
        job.metadata.namespace = NS
        job.spec.tpu = TPUSpec(accelerator="h100", topology="1x4")
        job.spec.template.spec.containers = [
            Container(name=name, image="torch:1")
        ]
        job.spec.steps = 1000  # never completes inside a run (step acks 100)
        job.spec.checkpoint_period_s = 36000.0  # cadence never fires
        self.client.create(job)
        self.monitor.reset()  # premise, not a transition

    def job_cluster_step(self, name: str) -> None:
        """The cluster model's job half: one learner-gang pod keyed by the
        job state annotation, honoring warm/claimed pool reservations under
        the job's OWN claim key."""
        from ..api.job import TPUJob

        try:
            job = self.client.get(TPUJob, NS, name)
        except NotFoundError:
            return
        state = job.metadata.annotations.get(C.JOB_STATE_ANNOTATION, "")
        desired = 1 if state in ("admitted", "running", "checkpointing") \
            else 0
        pods = [
            p for p in self.client.list(
                Pod, namespace=NS, labels={C.JOB_NAME_LABEL: name}
            )
            if not p.metadata.deletion_timestamp
        ]
        if desired == 0:
            for p in pods:
                self.client.delete(Pod, NS, p.metadata.name)
            return
        job_key = f"{NS}/{name}"
        if not pods:
            pod = Pod()
            pod.metadata.name = f"{name}-{C.JOB_GANG_LEARNER}-0"
            pod.metadata.namespace = NS
            pod.metadata.labels[C.JOB_NAME_LABEL] = name
            pod.metadata.labels[C.JOB_GANG_LABEL] = C.JOB_GANG_LEARNER
            for node in sorted(self.client.list(Node),
                               key=lambda n: n.metadata.name):
                if self._node_free_for(node, job_key):
                    pod.spec.node_name = node.metadata.name
                    break
            self.client.create(pod)
            if pod.spec.node_name:
                placed = self.client.get(Pod, NS, pod.metadata.name)
                placed.status.phase = "Running"
                placed.status.conditions = [
                    Condition(type="Ready", status="True")
                ]
                self.client.update_status(placed)
            return
        for p in pods:
            if p.spec.node_name:
                continue
            for node in sorted(self.client.list(Node),
                               key=lambda n: n.metadata.name):
                if self._node_free_for(node, job_key):
                    p.spec.node_name = node.metadata.name
                    p = self.client.update(p)
                    p.status.phase = "Running"
                    p.status.conditions = [
                        Condition(type="Ready", status="True")
                    ]
                    self.client.update_status(p)
                    break

    def ops(self) -> List[Op]:
        def reconcile(ctrl, name):
            return lambda w: ctrl.reconcile(Request(namespace=NS, name=name))

        # the job space drops the repair/fault/rival ops (that cross product
        # is the base World's territory) and adds the job actor: the
        # reclaimer preempt rides the REAL suspend-2 reconcile once nb2's
        # resume finds its warm slice claimed away by the job's admission
        ops = [
            Op("suspend-2", reconcile(self.suspend, "nb2")),
            Op("job-1", reconcile(self.job, "job1")),
            Op("cluster", lambda w: (w.cluster_step("nb1"),
                                     w.cluster_step("nb2"),
                                     w.job_cluster_step("job1"))),
            Op("unstop-2", lambda w: w.unstop("nb2"), once=True),
        ]
        if self.churn_ops:
            ops[0:0] = [
                Op("cull-1", reconcile(self.culler, "nb1")),
                Op("suspend-1", reconcile(self.suspend, "nb1")),
            ]
        return ops

    # the port's job reconciler also remembers when a preempted gang's last
    # pod was first seen gone (its requeue backoff runs from there, where
    # the reference's runs from the preemption): scratch the explorer must
    # snapshot and key on like the checkpoint acks
    def snapshot(self) -> dict:
        snap = super().snapshot()
        snap["job"] = copy.deepcopy({
            "acked": self.job._ckpt_acked,
            "gone": self.job._gang_gone_at,
        })
        return snap

    def restore_snapshot(self, snap: dict) -> None:
        super().restore_snapshot(snap)
        job = copy.deepcopy(snap["job"])
        self.job._ckpt_acked = job["acked"]
        self.job._gang_gone_at = job["gone"]

    def scratch_token(self) -> Tuple:
        return super().scratch_token() + (
            tuple(sorted(
                (k, tuple(sorted(v.items())))
                for k, v in self.job._ckpt_acked.items()
            )),
            tuple(sorted(self.job._gang_gone_at)),
        )


# ---------------------------------------------------------------------------
# steady-state (quiescence) contracts
# ---------------------------------------------------------------------------


def steady_violations(world: World) -> List[invcheck.InvariantViolation]:
    """Judged at a leaf, after every actor quiesced: the transient windows
    level-triggered controllers are allowed are OVER, so exclusion, stuck
    states, condition/state consistency, and phantom claims are now hard."""
    out: List[invcheck.InvariantViolation] = []

    def v(name: str, detail: str) -> None:
        out.append(invcheck.InvariantViolation(name, detail))

    from ..api.job import TPUJob

    notebooks = world.client.list(Notebook, namespace=NS)
    jobs = world.client.list(TPUJob, namespace=NS)
    keys = {f"{nb.metadata.namespace}/{nb.metadata.name}" for nb in notebooks}
    keys |= {f"{j.metadata.namespace}/{j.metadata.name}" for j in jobs}
    for j in jobs:
        jkey = f"{NS}/{j.metadata.name}"
        jstate = j.metadata.annotations.get(C.JOB_STATE_ANNOTATION, "")
        # legitimate parks: queued Pending (""), a long Running stretch
        # (cadence is wall-clock), and the terminal states. Admitted /
        # Checkpointing / Preempted must always advance — an actor out of
        # work with a job wedged there is exactly the silent-stuck bug the
        # requeue contract exists to prevent.
        if jstate not in ("", "running", "succeeded", "failed"):
            v("stuck-state",
              f"{jkey} quiesced in non-parked job state {jstate!r} — every "
              "actor is out of work and nothing will ever advance it")
    for nb in notebooks:
        ann = nb.metadata.annotations
        key = f"{NS}/{nb.metadata.name}"
        sus = ann.get(C.TPU_SUSPEND_STATE_ANNOTATION, "")
        rep = ann.get(C.TPU_REPAIR_STATE_ANNOTATION, "")
        if sus and rep:
            v("machine-exclusion",
              f"{key} owned by BOTH machines at quiescence "
              f"(suspend={sus!r}, repair={rep!r})")
        if sus not in ("", "suspended") or rep:
            v("stuck-state",
              f"{key} quiesced in non-parked state "
              f"(suspend={sus!r}, repair={rep!r}) — every actor is out of "
              "work and nothing will ever advance it")
        deg = next((c for c in nb.status.conditions
                    if c.type == C.TPU_DEGRADED_CONDITION), None)
        if not rep and deg is not None and deg.status == "True":
            v("condition-consistency",
              f"{key}: Degraded=True ({deg.reason}) but the repair machine "
              "is at rest")
    for node in world.client.list(Node):
        ann = node.metadata.annotations
        state = ann.get(POOL_STATE_ANNOTATION)
        if state is None:
            continue
        pods_here = [
            p for p in world.client.list(Pod)
            if p.spec.node_name == node.metadata.name
            and not p.metadata.deletion_timestamp
        ]
        if state == POOL_STATE_WARM and pods_here:
            v("pool-consistency",
              f"node {node.metadata.name} is warm-reserved but hosts "
              f"{len(pods_here)} pod(s)")
        if state == "claimed":
            claimant = ann.get(POOL_CLAIMED_BY_ANNOTATION, "")
            if claimant not in keys:
                v("pool-consistency",
                  f"node {node.metadata.name} quiesced claimed by "
                  f"{claimant!r}, which does not exist — a phantom claim "
                  "holding the slice out of the pool forever")
    # chip-accounting attribution: the ledger's conservation
    # contract depends on classify() being exhaustive and exclusive — every
    # GPU node maps to exactly ONE valid (class, phase) bucket in every
    # reachable quiesced state, so no chip-second can ever go unattributed
    # or be double-counted regardless of which interleaving produced the
    # state. The wall-clock half (sum == chips x dt) is the INVCHECK-armed
    # runtime check; THIS half is interleaving coverage.
    from ..runtime.accounting import PHASES, ChipAccountant

    accountant = ChipAccountant(world.client, clock=lambda: 0.0)
    try:
        attrs = accountant.classify(now=0.0)
    except Exception as e:  # classification must never throw on a real state
        v("accounting-attribution",
          f"classify() raised on a quiesced reachable state: {e!r}")
        attrs = []
    gpu_nodes = {
        n.metadata.name
        for n in world.client.list(Node)
        if int(n.status.capacity.get(GPU_RESOURCE, "0") or 0) > 0
    }
    seen: Dict[str, int] = {}
    for a in attrs:
        seen[a.node] = seen.get(a.node, 0) + 1
        if a.phase not in PHASES:
            v("accounting-attribution",
              f"node {a.node} attributed to unknown phase {a.phase!r}")
    for name, count in seen.items():
        if count > 1:
            v("accounting-attribution",
              f"node {name} attributed {count} times in one pass — its "
              "chip-seconds would be double-counted")
    missing = gpu_nodes - set(seen)
    if missing:
        v("accounting-attribution",
          f"GPU node(s) {sorted(missing)} unattributed — their "
          "chip-seconds would leak from the conservation ledger")
    return out


# ---------------------------------------------------------------------------
# the explorer
# ---------------------------------------------------------------------------


@dataclass
class Violation:
    invariant: str
    detail: str
    trace: Tuple[str, ...]


@dataclass
class ExplorationResult:
    schedules: int = 0  # leaves fully explored to quiescence
    visited: int = 0  # scheduler decision points
    pruned: int = 0  # memo hits
    truncated: int = 0  # paths cut by max_depth (0 == exhaustive)
    exhausted: bool = False  # frontier fully drained within budgets
    violations: List[Violation] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.exhausted and not self.violations and not self.truncated


class Explorer:
    def __init__(
        self,
        world_factory: Callable[[], World] = World,
        max_depth: int = 64,
        max_preemptions: int = 1,
        max_visited: int = 200_000,
        seed: int = 0,
        stop_on_violation: bool = False,
    ):
        self.world_factory = world_factory
        self.max_depth = max_depth
        self.max_preemptions = max_preemptions
        self.max_visited = max_visited
        self.seed = seed
        self.stop_on_violation = stop_on_violation

    def explore(self) -> ExplorationResult:
        world = self.world_factory()
        ops = world.ops()
        order = list(range(len(ops)))
        random.Random(self.seed).shuffle(order)
        result = ExplorationResult()
        memo = set()
        self._dfs(world, ops, order, (), frozenset(), frozenset(),
                  None, 0, (-1, -1), memo, result)
        result.exhausted = result.visited < self.max_visited
        return result

    def _dfs(self, world, ops, order, trace, quiesced, done_once,
             last_actor, preemptions, drain, memo, result) -> bool:
        """Returns True to abort the whole search (budget / stop-on-hit)."""
        result.visited += 1
        if result.visited >= self.max_visited:
            return True
        enabled = []
        for pos, idx in enumerate(order):
            op = ops[idx]
            if op.once and op.name in done_once:
                continue
            if op.after is not None and op.after not in done_once:
                continue
            if not op.once and op.name in quiesced:
                continue
            enabled.append((pos, idx))
        if not enabled:
            # leaf: a fully-quiesced schedule
            result.schedules += 1
            for violation in steady_violations(world):
                result.violations.append(Violation(
                    violation.invariant, violation.detail, trace))
                if self.stop_on_violation:
                    return True
            return False
        if len(trace) >= self.max_depth:
            result.truncated += 1
            return False
        drain_start, last_idle_pos = drain
        n = len(order)
        for pos, idx in enabled:
            op = ops[idx]
            cost = int(
                last_actor is not None
                and op.name != last_actor
                and last_actor not in quiesced
                and not self._is_done_once(ops, last_actor, done_once)
            )
            if preemptions + cost > self.max_preemptions:
                continue
            snap = world.snapshot()
            violations_before = len(world.monitor.violations)
            rv_before = world.store._last_rv
            try:
                op.fn(world)
                failure = None
            except Exception as e:  # a crashed reconcile is itself a finding
                failure = e
            progress = world.store._last_rv != rv_before
            # canonical drain order: consecutive no-op runs commute, so of
            # their permutations only the one ascending CYCLICALLY from the
            # drain's first idle op is explored — judged after the run
            # (whether an op progresses cannot be known in advance);
            # progressing ops are never constrained
            if (
                not progress
                and drain_start >= 0
                and (pos - drain_start) % n < (last_idle_pos - drain_start) % n
            ):
                world.restore_snapshot(snap)
                continue
            new_trace = trace + (op.name,)
            aborted = False
            if failure is not None:
                result.violations.append(Violation(
                    "op-exception", f"{op.name} raised {failure!r}", new_trace))
                aborted = self.stop_on_violation
            for violation in world.monitor.violations[violations_before:]:
                result.violations.append(Violation(
                    violation.invariant, violation.detail, new_trace))
                if self.stop_on_violation:
                    aborted = True
            if aborted:
                return True
            next_quiesced = (
                frozenset() if progress
                else quiesced | ({op.name} if not op.once else frozenset())
            )
            next_done = done_once | ({op.name} if op.once else frozenset())
            next_drain = (
                (-1, -1) if progress
                else (drain_start if drain_start >= 0 else pos, pos)
            )
            key = (world.state_hash(), world.scratch_token(), next_quiesced,
                   next_done, op.name, preemptions + cost, next_drain)
            if key in memo:
                result.pruned += 1
            else:
                memo.add(key)
                if self._dfs(world, ops, order, new_trace, next_quiesced,
                             next_done, op.name, preemptions + cost,
                             next_drain, memo, result):
                    return True
            world.restore_snapshot(snap)
        return False

    @staticmethod
    def _is_done_once(ops, name, done_once) -> bool:
        return name in done_once

    # ---------- replay + minimization ----------

    def replay(self, trace: Sequence[str]) -> List[Violation]:
        world = self.world_factory()
        ops = {op.name: op for op in world.ops()}
        out: List[Violation] = []
        for i, name in enumerate(trace):
            before = len(world.monitor.violations)
            try:
                ops[name].fn(world)
            except Exception as e:
                out.append(Violation("op-exception", f"{name} raised {e!r}",
                                     tuple(trace[: i + 1])))
            for violation in world.monitor.violations[before:]:
                out.append(Violation(violation.invariant, violation.detail,
                                     tuple(trace[: i + 1])))
        return out

    def minimize(self, trace: Sequence[str], invariant: str) -> Tuple[str, ...]:
        """Greedy delta reduction: drop every op whose removal still
        reproduces the invariant; deterministic, so the minimized trace is
        stable across runs (the test pins it)."""
        current = list(trace)

        def reproduces(candidate: List[str]) -> bool:
            return any(v.invariant == invariant
                       for v in self.replay(candidate))

        changed = True
        while changed:
            changed = False
            i = 0
            while i < len(current):
                candidate = current[:i] + current[i + 1:]
                if reproduces(candidate):
                    current = candidate
                    changed = True
                else:
                    i += 1
        return tuple(current)


# ---------------------------------------------------------------------------
# entry points (tests + `python -m odh_kubeflow_tpu_torch.analysis --explore`)
# ---------------------------------------------------------------------------

MUTANTS: Dict[str, Callable[[], World]] = {
    "skip-checkpoint": lambda: World(
        suspend_cls=SkipCheckpointSuspendController),
    "cas-blind": lambda: World(pool_cls=CASBlindSlicePool),
}
MUTANT_INVARIANT = {
    "skip-checkpoint": "checkpoint-before-suspend",
    "cas-blind": "pool-claim-cas",
}


def explore_default(max_preemptions: int = 0, seed: int = 0,
                    max_visited: int = 200_000) -> ExplorationResult:
    """The acceptance run: bounded-exhaustive over the suspend x repair x
    reclaim interleaving space with the SHIPPED controllers — must come
    back exhausted, un-truncated, and violation-free. max_preemptions=0
    still interleaves every actor ordering at every quiescence point
    (~40 s); 1 adds an arbitrary preemptive switch anywhere (~3 min, the
    slow-marked soak tier)."""
    return Explorer(World, max_preemptions=max_preemptions, seed=seed,
                    max_visited=max_visited).explore()


def explore_jobs(max_preemptions: int = 0, seed: int = 0,
                 max_visited: int = 200_000,
                 churn_ops: bool = False) -> ExplorationResult:
    """The job space's acceptance run: bounded-exhaustive over the job-vs-suspend-vs-
    reclaim interleaving space (JobWorld: warm-claim admission steals the
    suspended notebook's slice, the resume pressures the REAL reclaimer
    into checkpoint-preempting the REAL job controller, the job requeues) —
    must come back exhausted, un-truncated, and violation-free. The default
    space exhausts in seconds; churn_ops=True adds the interactive
    cull/suspend actors (the slow tier, ~2 min)."""
    return Explorer(lambda: JobWorld(churn_ops=churn_ops),
                    max_preemptions=max_preemptions, seed=seed,
                    max_visited=max_visited).explore()


def explore_mutant(name: str, seed: int = 0) -> Tuple[Violation, Tuple[str, ...]]:
    """Deterministically reproduce a seeded known-bad mutant: first
    violating schedule, then the minimized replayable trace."""
    explorer = Explorer(MUTANTS[name], max_preemptions=1, seed=seed,
                        stop_on_violation=True)
    result = explorer.explore()
    target = MUTANT_INVARIANT[name]
    hits = [v for v in result.violations if v.invariant == target]
    if not hits:
        raise AssertionError(
            f"mutant {name!r} produced no {target} violation "
            f"({len(result.violations)} other violations, "
            f"{result.schedules} schedules)"
        )
    first = hits[0]
    minimized = explorer.minimize(first.trace, target)
    return first, minimized


def overhead_ratio(n: int = 300) -> Tuple[float, float]:
    """(per-write seconds off, on): the INVCHECK calm-path cost probe the
    acceptance bound (<10% per reconcile) is measured from — a reconcile-
    shaped loop of annotation patches against a bare store."""
    def loop(store: Store) -> float:
        client = Manager(store, cached_reads=False).client
        nb = Notebook()
        nb.metadata.name = "calm"
        nb.metadata.namespace = NS
        nb.spec.tpu = TPUSpec(accelerator="h100", topology="1x4")
        client.create(nb)
        t0 = time.perf_counter()
        for i in range(n):
            client.patch(Notebook, NS, "calm", {
                "metadata": {"annotations": {
                    C.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION: f"t{i}",
                }},
            })
        return time.perf_counter() - t0

    def bare_store() -> Store:
        store = Store()
        store.invariants = None  # ambient INVCHECK must not skew "off"
        return store

    off = min(loop(bare_store()) for _ in range(3))
    on = min(
        loop(Store(invariants=invcheck.Monitor()))
        for _ in range(3)
    )
    return off / n, on / n
