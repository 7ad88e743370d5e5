"""GPU-aware scheduler for the in-process cluster (the port's copy of
odh_kubeflow_tpu/cluster/scheduler.py, on `nvidia.com/gpu`).

Models the piece of GKE the operator depends on: GPU slice node pools where
every multi-host pool is one slice (the reference's ICI slice; here the
hosts of one pool share a network fabric). Placement rules:

- nodeSelector labels must match the node,
- `nvidia.com/gpu` requests bind whole hosts (one GPU pod per node),
- **gang placement**: all pods of a multi-host StatefulSet must land in the
  SAME node pool (= same ICI slice), all-or-nothing — if the pool can't hold
  every replica, nothing schedules and an Unschedulable event is emitted
  (SURVEY §7 hard part (d): scheduling atomicity for multi-host slices),
- CPU/memory capacity accounting for non-TPU pods,
- NotReady nodes (drained/preempted hosts) take no new pods,
- unschedulable pods requeue with exponential backoff AND are re-attempted
  the moment capacity frees (node added/restored, a scheduled pod deleted) —
  a waiting gang must not sit out a full backoff window after the slice it
  needs opens up,
- **warm slice pools** (cluster/slicepool.py): a pool whose nodes carry
  `pool-state=warm` is held for resume binds — no pods land there until the
  suspend controller claims it or the reclaimer returns it to general
  capacity; `pool-state=claimed` pools accept ONLY the claiming notebook's
  pods (the resume fast path).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..api.apps import StatefulSet
from ..api.core import Node, Pod, emit_deduped_event
from ..apimachinery import NotFoundError, controller_owner
from ..runtime.controller import Request, Result
from ..runtime.manager import Manager
from ..gpu import GKE_NODEPOOL_LABEL, GPU_RESOURCE
from ..utils import parse_quantity
from .slicepool import (
    POOL_CLAIMED_BY_ANNOTATION,
    POOL_STATE_ANNOTATION,
    POOL_STATE_CLAIMED,
    POOL_STATE_WARM,
)
from .store import DELETED


def claim_owner_labels() -> tuple:
    """The claim-owner table: pod labels that name the workload owning a
    claimed slice pool, in precedence order. Three workload classes share
    the pool's claim namespace (ns/name keys), so a FOURTH class joins by
    adding its label here — not by growing another special case inline in
    the scheduler (`_pod_owner` used to if/else
    notebook and inference-endpoint owners by hand)."""
    from ..controllers.constants import (
        INFERENCE_NAME_LABEL,
        JOB_NAME_LABEL,
        NOTEBOOK_NAME_LABEL,
    )

    return (NOTEBOOK_NAME_LABEL, INFERENCE_NAME_LABEL, JOB_NAME_LABEL)


def pod_claim_owner(pod: Pod) -> str:
    """ns/name of the workload that owns this pod — what a claimed pool's
    `pool-claimed-by` must equal for the bind to be allowed; "" for an
    owner-less pod (which must never slip through the warm sentinel)."""
    for label in claim_owner_labels():
        owner = pod.metadata.labels.get(label, "")
        if owner:
            return f"{pod.metadata.namespace}/{owner}"
    return ""


def pod_tpu_request(pod: Pod) -> int:
    total = 0
    for c in pod.spec.containers:
        if c.resources and c.resources.requests.get(GPU_RESOURCE):
            total += int(parse_quantity(c.resources.requests[GPU_RESOURCE]))
        elif c.resources and c.resources.limits.get(GPU_RESOURCE):
            total += int(parse_quantity(c.resources.limits[GPU_RESOURCE]))
    return total


def pod_resource_request(pod: Pod, resource: str) -> float:
    total = 0.0
    for c in pod.spec.containers:
        if c.resources and c.resources.requests.get(resource):
            total += parse_quantity(c.resources.requests[resource])
    return total


class Scheduler:
    # unschedulable requeue: exponential from base to cap. The cap stays
    # coarse because the capacity-freed watches below are the fast path —
    # backoff is only the safety net for capacity changes with no event.
    backoff_base_s = 0.25
    backoff_max_s = 5.0

    def __init__(self, manager: Manager):
        self.manager = manager
        self.client = manager.client
        # pod key -> consecutive unschedulable attempts (single scheduler
        # worker: no lock needed; pruned on schedule/delete)
        self._unsched_attempts: Dict[str, int] = {}

    def setup(self) -> None:
        def pending_pods(_obj: dict) -> List[tuple]:
            """Capacity-freed mapper: re-enqueue every unscheduled pod."""
            return [
                (p.metadata.namespace, p.metadata.name)
                for p in self.client.list(Pod)
                if not p.spec.node_name and not p.metadata.deletion_timestamp
            ]

        def frees_capacity(ev: str, obj: dict, _old: Optional[dict]) -> bool:
            # a scheduled pod leaving the cluster returns its node's capacity
            return ev == DELETED and bool(obj.get("spec", {}).get("nodeName"))

        (
            self.manager.builder("scheduler")
            .for_(Pod, predicate=lambda ev, obj, old: not obj.get("spec", {}).get("nodeName"))
            # nodes appearing/changing (new pool, maintenance ending) and
            # scheduled pods departing both free capacity: re-attempt every
            # pending pod immediately instead of waiting out its backoff
            .watches(Node, pending_pods)
            .watches(Pod, pending_pods, predicate=frees_capacity)
            .complete(self.reconcile)
        )

    # -- capacity --
    def _assignment_map(self) -> Dict[str, List[Pod]]:
        """node name -> assigned pods, built once per scheduling pass."""
        out: Dict[str, List[Pod]] = {}
        for p in self.client.list(Pod):
            if p.spec.node_name and not p.metadata.deletion_timestamp:
                out.setdefault(p.spec.node_name, []).append(p)
        return out

    def _node_free(
        self, node: Node, pod: Pod, tpu_chips: int, assignment: Dict[str, List[Pod]]
    ) -> bool:
        assigned = assignment.get(node.metadata.name, [])
        if tpu_chips > 0:
            cap = int(parse_quantity(node.status.allocatable.get(GPU_RESOURCE, "0")))
            if cap < tpu_chips:
                return False
            # GPU hosts are exclusively bound: one GPU workload pod per node
            if any(pod_tpu_request(p) > 0 for p in assigned):
                return False
            return True
        for resource in ("cpu", "memory"):
            want = pod_resource_request(pod, resource)
            if want == 0:
                continue
            cap = parse_quantity(node.status.allocatable.get(resource, "0"))
            used = sum(pod_resource_request(p, resource) for p in assigned)
            if used + want > cap:
                return False
        return True

    def _node_healthy(self, node: Node) -> bool:
        """Ready=False nodes (drained/preempted hosts) take no new pods; a
        node with no Ready condition at all is healthy (sim default)."""
        return not any(
            c.type == "Ready" and c.status == "False"
            for c in node.status.conditions
        )

    def _selector_matches(self, pod: Pod, node: Node) -> bool:
        if not self._node_healthy(node):
            return False
        for k, v in pod.spec.node_selector.items():
            if node.metadata.labels.get(k) != v:
                return False
        return self._tolerates(pod, node)

    def _tolerates(self, pod: Pod, node: Node) -> bool:
        """NoSchedule taint semantics (GKE GPU pools carry an nvidia.com/gpu
        taint so non-GPU pods never land on GPU hosts)."""
        for taint in node.spec.get("taints", []):
            if taint.get("effect") not in ("NoSchedule", "NoExecute"):
                continue
            key = taint.get("key", "")
            if key == GPU_RESOURCE and pod_tpu_request(pod) > 0:
                continue  # device-plugin auto-toleration
            if not any(
                t.key == key or (not t.key and t.operator == "Exists")
                for t in pod.spec.tolerations
            ):
                return False
        return True

    def _gang_size(self, pod: Pod) -> int:
        """Replicas of the owning StatefulSet (1 for standalone pods)."""
        ref = controller_owner(pod)
        if ref is None or ref.kind != "StatefulSet":
            return 1
        try:
            sts = self.client.get(StatefulSet, pod.metadata.namespace, ref.name)
        except NotFoundError:
            return 1
        return sts.spec.replicas if sts.spec.replicas is not None else 1

    def reconcile(self, req: Request) -> Optional[Result]:
        try:
            pod = self.client.get(Pod, req.namespace, req.name)
        except NotFoundError:
            self._unsched_attempts.pop(req.key, None)
            return None
        if pod.spec.node_name or pod.metadata.deletion_timestamp:
            self._unsched_attempts.pop(req.key, None)
            return None

        # the nodes as the store has them, not as the cache has applied
        # them: a pool claimed for this pod's owner before the pod was
        # created is then reserved for it, not seen as warm (taking nobody)
        nodes = self.manager.api_reader.list(Node)
        candidates = [n for n in nodes if self._selector_matches(pod, n)]
        tpu_chips = pod_tpu_request(pod)
        assignment = self._assignment_map()
        chosen: Optional[Node] = None

        if tpu_chips > 0:
            # group candidate nodes by pool; a pool == one slice
            pools: Dict[str, List[Node]] = {}
            for n in candidates:
                pools.setdefault(
                    n.metadata.labels.get(GKE_NODEPOOL_LABEL, n.metadata.name), []
                ).append(n)
            gang = self._gang_size(pod)
            sibling_pool = self._sibling_pool(pod)
            for pool_name in sorted(pools):
                # siblings already placed in a pool pin the gang there
                if sibling_pool is not None and sibling_pool != pool_name:
                    continue
                pool_nodes = pools[pool_name]
                # warm-pool reservation: warm slices take nobody; claimed
                # slices take only the claiming notebook's pods. An owner-less
                # pod (no notebook-name label) must never slip through the
                # warm sentinel ("" == "") onto a reserved slice.
                reservation = self._pool_reservation(pool_nodes)
                if reservation is not None:
                    owner = self._pod_owner(pod)
                    if not owner or reservation != owner:
                        continue
                free = [
                    n for n in pool_nodes if self._node_free(n, pod, tpu_chips, assignment)
                ]
                if sibling_pool is None and gang > 1 and len(free) < gang:
                    continue  # all-or-nothing: a fresh gang needs the whole slice
                if free:
                    ordinal = pod.metadata.labels.get("apps.kubernetes.io/pod-index")
                    free.sort(key=lambda n: n.metadata.name)
                    idx = int(ordinal) % len(free) if ordinal is not None else 0
                    chosen = free[min(idx, len(free) - 1)]
                    break
        else:
            free = [n for n in candidates if self._node_free(n, pod, 0, assignment)]
            chosen = min(
                free,
                key=lambda n: len(assignment.get(n.metadata.name, [])),
                default=None,
            )

        if chosen is None:
            self._emit_unschedulable(pod, tpu_chips)
            # exponential backoff; the capacity-freed watches (setup) are the
            # fast path back in, so the poll only backstops eventless changes
            attempts = self._unsched_attempts.get(req.key, 0)
            self._unsched_attempts[req.key] = attempts + 1
            return Result(
                requeue_after=min(
                    self.backoff_max_s, self.backoff_base_s * (2 ** attempts)
                )
            )

        self._unsched_attempts.pop(req.key, None)
        pod.spec.node_name = chosen.metadata.name
        self.client.update(pod)
        return None

    @staticmethod
    def _pod_owner(pod: Pod) -> str:
        """Delegates to the shared claim-owner table (pod_claim_owner):
        notebooks, InferenceEndpoints, and TPUJobs share the claim
        namespace — a promoted endpoint claims its source notebook's
        released slice under its OWN key, a batch job warm-claims
        a suspended notebook's slice the same way — and only the
        claimant's pods may land there."""
        return pod_claim_owner(pod)

    @staticmethod
    def _pool_reservation(pool_nodes: List[Node]) -> Optional[str]:
        """None = unreserved; "" = warm (held for resume binds, takes
        nobody); "ns/name" = claimed by that notebook. Judged off the lead
        node — the claim CAS serializes on it (cluster/slicepool.py)."""
        lead = min(pool_nodes, key=lambda n: n.metadata.name)
        state = lead.metadata.annotations.get(POOL_STATE_ANNOTATION, "")
        if state == POOL_STATE_WARM:
            return ""
        if state == POOL_STATE_CLAIMED:
            return lead.metadata.annotations.get(POOL_CLAIMED_BY_ANNOTATION, "")
        return None

    def _sibling_pool(self, pod: Pod) -> Optional[str]:
        ref = controller_owner(pod)
        if ref is None or ref.kind != "StatefulSet":
            return None
        for p in self.client.list(Pod, namespace=pod.metadata.namespace):
            if p.metadata.name == pod.metadata.name or not p.spec.node_name:
                continue
            pref = controller_owner(p)
            if pref and pref.uid == ref.uid:
                try:
                    node = self.client.get(Node, "", p.spec.node_name)
                except NotFoundError:
                    continue
                return node.metadata.labels.get(GKE_NODEPOOL_LABEL)
        return None

    def _emit_unschedulable(self, pod: Pod, tpu_chips: int) -> None:
        """One Event per pod+reason, deduplicated Kubernetes-style via the
        shared emitter (api/core.py emit_deduped_event): repeats bump
        count/lastTimestamp instead of growing the store."""
        message = (
            f"0/{len(self.client.list(Node))} nodes available for "
            f"{tpu_chips} {GPU_RESOURCE} chips (gang all-or-nothing)"
            if tpu_chips
            else "no node with sufficient cpu/memory"
        )
        emit_deduped_event(
            self.client, pod, f"{pod.metadata.name}.unschedulable",
            reason="FailedScheduling", message=message, etype="Warning",
            api_version="v1", kind="Pod",
        )
