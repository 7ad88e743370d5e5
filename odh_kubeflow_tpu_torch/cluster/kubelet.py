"""Kubelet simulator: brings scheduled pods to life.

The KinD-CI analog (SURVEY §4 tier 4): envtest has no kubelet, so the
reference can never assert pod behavior in-process — this build can. Pods
transition Pending -> Running -> Ready under a pluggable PodBehavior, which
can also start a REAL localhost HTTP server per pod (the in-pod probe agent),
registered in the cluster DNS so the culling controller's HTTP probes travel
an actual socket. A pod whose behavior asks for it (`PodDecision.graceful`,
a pod whose containers are real processes) is deleted gracefully, as a
kubelet deletes every pod: the kubelet holds a finalizer on it while its
containers run, so a delete only marks it terminating; once its containers
have stopped the finalizer comes off and the object goes (a container
that outlives its stop keeps the object, and the stop is tried again
until it holds). A StatefulSet
recreates the ordinal only then, so two pods of one identity never run
at once."""
from __future__ import annotations

import itertools
import logging
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from ..api.core import ContainerState, ContainerStatus, Node, Pod
from ..apimachinery import (
    Condition,
    ConflictError,
    NotFoundError,
    now_rfc3339,
    parse_time,
)
from ..runtime.controller import Request, Result
from ..runtime.manager import Manager
from ..utils import racecheck
from .client import retry_on_conflict
from .faults import MAINTENANCE_WINDOW_ANNOTATION, PREEMPTION_TAINT_KEY

log = logging.getLogger(__name__)

_ip_seq = itertools.count(2)

# held on a graceful pod while its containers run
TERMINATION_FINALIZER = "kubelet.sim/containers"


@dataclass
class PodDecision:
    """What the behavior wants for a pod."""

    ready_after: float = 0.0  # seconds of simulated startup
    fail: str = ""  # nonempty -> container stuck waiting with this reason
    # start a real server for this pod; returns (host, port) or
    # (host, port, close_fn) to register in cluster DNS
    serve: Optional[Callable[[Pod], tuple]] = None
    # delete the pod object only once close_fn has returned
    graceful: bool = False
    # the container's readiness probe: with it, a started pod goes Ready
    # only once it returns true (polled every READY_POLL_S)
    ready: Optional[Callable[[], bool]] = None
    # the pod's IP, when the behavior gives the pod an address its
    # processes listen on (a loopback address of its own); else the
    # kubelet makes one up
    pod_ip: str = ""


READY_POLL_S = 0.05


# behavior(pod) -> PodDecision; matched first-wins
Behavior = Callable[[Pod], Optional[PodDecision]]


class Kubelet:
    # Parallel bring-up: `workers`
    # reconcile workers fan pods out concurrently, bounded per node by
    # `max_starting_per_node` — the container runtime's parallel image-pull /
    # start budget. N pods across M nodes start in ~max(per-node serial
    # chains), not the sum of every pod's ready_after.
    def __init__(
        self,
        manager: Manager,
        workers: int = 8,
        max_starting_per_node: int = 4,
    ):
        self.manager = manager
        self.client = manager.client
        self.workers = max(1, workers)
        self.max_starting_per_node = max(1, max_starting_per_node)
        self._behaviors: list[Behavior] = []
        # pod key -> (pod uid, host, port, close_fn|None); uid detects recreation
        self._servers: Dict[str, tuple] = {}
        self._started_at: Dict[str, Tuple[str, float]] = {}  # key -> (uid, t0)
        self._starting: Dict[str, str] = {}  # key -> node, while starting up
        self._lock = racecheck.make_lock("Kubelet._lock")

    def add_behavior(self, behavior: Behavior) -> None:
        with self._lock:
            self._behaviors.insert(0, behavior)

    def server_for(self, namespace: str, pod_name: str) -> Optional[Tuple[str, int]]:
        with self._lock:
            entry = self._servers.get(f"{namespace}/{pod_name}")
            # port 0 is the closed-agent sentinel (probe/agent.py serve()):
            # a dead in-pod server must resolve as unreachable, never as a
            # stale (possibly OS-reused) ephemeral port
            if entry is None or not entry[2]:
                return None
            return (entry[1], entry[2])

    def _drop_state(self, key: str, expect_uid: Optional[str] = None, keep_failed: bool = False) -> bool:
        """Clear per-pod state (closing any server, outside the lock: a
        pod's processes can take seconds to stop, and cluster DNS must keep
        answering meanwhile). With expect_uid, only state belonging to a
        DIFFERENT uid is cleared (pod recreation). Returns False when the
        close raised; with keep_failed the entry then stays, unreachable
        (port 0), for the next call to close again."""
        close = None
        with self._lock:
            entry = self._servers.get(key)
            if entry and (expect_uid is None or entry[0] != expect_uid):
                self._servers.pop(key, None)
                close = entry[3]
            started = self._started_at.get(key)
            if started and (expect_uid is None or started[0] != expect_uid):
                self._started_at.pop(key, None)
                self._starting.pop(key, None)
        if close is not None:
            try:
                close()
            except Exception:
                log.exception("closing the server of pod %s failed", key)
                if keep_failed:
                    with self._lock:
                        self._servers.setdefault(key, (entry[0], entry[1], 0, close))
                return False
        return True

    def shutdown_servers(self) -> None:
        with self._lock:
            keys = list(self._servers)
        for k in keys:
            self._drop_state(k)

    def setup(self) -> None:
        (
            self.manager.builder("kubelet")
            .for_(Pod, predicate=lambda ev, obj, old: bool(obj.get("spec", {}).get("nodeName")))
            .with_workers(self.workers)
            .complete(self.reconcile)
        )

    def _decide(self, pod: Pod) -> PodDecision:
        with self._lock:
            behaviors = list(self._behaviors)
        for b in behaviors:
            d = b(pod)
            if d is not None:
                return d
        return PodDecision()

    def reconcile(self, req: Request) -> Optional[Result]:
        import time

        try:
            pod = self.client.get(Pod, req.namespace, req.name)
        except NotFoundError:
            self._drop_state(req.key)
            return None
        # recreated pod (same name, new uid): reset start time / server
        self._drop_state(req.key, expect_uid=pod.metadata.uid)
        if pod.metadata.deletion_timestamp and TERMINATION_FINALIZER in pod.metadata.finalizers:
            # graceful deletion: stop the containers, then let the object
            # go; while one outlives its stop, the object stays and the stop
            # is tried again
            if not self._drop_state(req.key, keep_failed=True):
                return Result(requeue_after=1.0)
            self._release(pod)
            return None
        if not pod.spec.node_name or pod.metadata.deletion_timestamp:
            return None

        decision = self._decide(pod)
        key = req.key

        faults = getattr(self.manager.store, "faults", None)
        if faults is not None:
            rule = faults.decide("kubelet.pod", namespace=req.namespace,
                                 name=req.name, obj=pod)
            if rule is not None and rule.action == "crash":
                self._crash(pod, key)
                return Result(requeue_after=0.05)

        if decision.fail:
            with self._lock:
                self._starting.pop(key, None)
            already_failed = (
                pod.status.container_statuses
                and pod.status.container_statuses[0].state
                and pod.status.container_statuses[0].state.waiting
                and pod.status.container_statuses[0].state.waiting.get("reason")
                == decision.fail
            )
            if already_failed:
                return None  # steady state: don't churn status/watch events
            pod.status.phase = "Pending"
            pod.status.container_statuses = [
                ContainerStatus(
                    name=c.name,
                    ready=False,
                    state=ContainerState(
                        waiting={"reason": decision.fail, "message": decision.fail}
                    ),
                )
                for c in pod.spec.containers
            ]
            pod.status.conditions = [
                Condition(type="PodScheduled", status="True"),
                Condition(
                    type="Ready", status="False", reason=decision.fail
                ),
            ]
            self._update_status(pod)
            return None

        with self._lock:
            if key not in self._started_at:
                # per-node startup budget: the container runtime starts at
                # most max_starting_per_node pods concurrently; the rest
                # wait WITHOUT their startup clock running (that's the
                # whole point — a queued pod hasn't started pulling)
                node = pod.spec.node_name
                active = sum(1 for n in self._starting.values() if n == node)
                if active >= self.max_starting_per_node:
                    throttled = True
                else:
                    throttled = False
                    self._started_at[key] = (pod.metadata.uid, time.monotonic())
                    if decision.ready_after > 0:
                        self._starting[key] = node
            else:
                throttled = False
            started = self._started_at[key][1] if not throttled else 0.0
        if throttled:
            return Result(requeue_after=0.02)
        elapsed = time.monotonic() - started
        if elapsed < decision.ready_after:
            if pod.status.phase != "Pending" or not pod.status.container_statuses:
                pod.status.phase = "Pending"
                pod.status.container_statuses = [
                    ContainerStatus(
                        name=c.name,
                        ready=False,
                        state=ContainerState(waiting={"reason": "ContainerCreating"}),
                    )
                    for c in pod.spec.containers
                ]
                pod.status.conditions = [
                    Condition(type="PodScheduled", status="True"),
                    Condition(type="Ready", status="False", reason="ContainersNotReady"),
                ]
                self._update_status(pod)
            return Result(requeue_after=max(0.01, decision.ready_after - elapsed))

        # startup finished: free this pod's slot in the node's start budget
        with self._lock:
            self._starting.pop(key, None)

        if decision.serve is not None:
            with self._lock:
                have_server = key in self._servers
            if not have_server:
                if decision.graceful and TERMINATION_FINALIZER not in pod.metadata.finalizers:
                    try:
                        pod = self.client.patch(Pod, pod.metadata.namespace, pod.metadata.name, {
                            "metadata": {"finalizers": [*pod.metadata.finalizers, TERMINATION_FINALIZER]}})
                    except (ConflictError, NotFoundError):
                        return Result(requeue_after=0.02)
                    if pod.metadata.deletion_timestamp:
                        return Result(requeue_after=0.0)
                result = decision.serve(pod)
                host, port = result[0], result[1]
                close = result[2] if len(result) > 2 else None
                if port:
                    with self._lock:
                        self._servers[key] = (pod.metadata.uid, host, port, close)
                else:
                    # port 0: the agent is permanently closed (crashed probe
                    # process) — purge any stale registration too, so cluster
                    # DNS answers "no endpoints" instead of routing probes to
                    # the dead (or worse, OS-reused) previous port
                    with self._lock:
                        entry = self._servers.get(key)
                        if entry is not None and entry[0] == pod.metadata.uid:
                            self._servers.pop(key)

        if pod.status.phase == "Running" and pod.is_ready():
            return None
        if decision.ready is not None and not decision.ready():
            # started, its readiness probe not passing yet: Running, not Ready
            if pod.status.phase != "Running":
                pod.status.phase = "Running"
                pod.status.pod_ip = pod.status.pod_ip or decision.pod_ip
                pod.status.container_statuses = [
                    ContainerStatus(name=c.name, ready=False, image=c.image,
                                    state=ContainerState(running={"startedAt": now_rfc3339()}))
                    for c in pod.spec.containers
                ]
                pod.status.conditions = [
                    Condition(type="PodScheduled", status="True"),
                    Condition(type="Initialized", status="True"),
                    Condition(type="Ready", status="False", reason="ContainersNotReady"),
                ]
                self._update_status(pod)
            return Result(requeue_after=READY_POLL_S)
        # readiness trace: the container-start window (scheduled -> Ready),
        # joined to the notebook's trace via the template-propagated
        # traceparent annotation. Recorded once per incarnation — this branch
        # only runs on the not-ready -> Ready transition.
        from ..utils.tracing import TRACEPARENT_ANNOTATION

        traceparent = pod.metadata.annotations.get(TRACEPARENT_ANNOTATION)
        if traceparent:
            from ..utils.tracing import record_span

            record_span(
                "kubelet.container.start",
                traceparent=traceparent,
                start_time=time.time() - elapsed,
                end_time=time.time(),
                pod=pod.metadata.name,
                namespace=pod.metadata.namespace,
            )
        # carry restart counts across status rewrites (crash-restart
        # injection bumps them; a Ready transition must not zero them)
        prior_restarts = {
            s.name: s.restart_count for s in pod.status.container_statuses
        }
        pod.status.phase = "Running"
        pod.status.pod_ip = (pod.status.pod_ip or decision.pod_ip
                             or f"10.1.{next(_ip_seq) % 250}.{next(_ip_seq) % 250}")
        pod.status.container_statuses = [
            ContainerStatus(
                name=c.name,
                ready=True,
                restart_count=prior_restarts.get(c.name, 0),
                state=ContainerState(running={"startedAt": now_rfc3339()}),
                image=c.image,
            )
            for c in pod.spec.containers
        ]
        pod.status.conditions = [
            Condition(type="PodScheduled", status="True"),
            Condition(type="Initialized", status="True"),
            Condition(type="ContainersReady", status="True"),
            Condition(type="Ready", status="True"),
        ]
        self._update_status(pod)
        return None

    def _crash(self, pod: Pod, key: str) -> None:
        """Injected container crash-restart: the in-pod server dies (its
        close() is permanent — a fresh incarnation serves the restarted
        container), the container goes not-ready with CrashLoopBackOff and
        restartCount+1, and the startup clock resets so recovery replays the
        normal bring-up path."""
        self._drop_state(key)
        already_crashed = (
            pod.status.container_statuses
            and not pod.status.container_statuses[0].ready
            and pod.status.container_statuses[0].state
            and pod.status.container_statuses[0].state.waiting
            and pod.status.container_statuses[0].state.waiting.get("reason")
            == "CrashLoopBackOff"
        )
        prior = {s.name: s for s in pod.status.container_statuses}
        pod.status.phase = "Running"
        pod.status.container_statuses = [
            ContainerStatus(
                name=c.name,
                ready=False,
                restart_count=(
                    prior[c.name].restart_count if c.name in prior else 0
                ) + (0 if already_crashed else 1),
                state=ContainerState(
                    waiting={"reason": "CrashLoopBackOff",
                             "message": "injected container crash"}
                ),
                image=c.image,
            )
            for c in pod.spec.containers
        ]
        pod.status.conditions = [
            Condition(type="PodScheduled", status="True"),
            Condition(type="Ready", status="False", reason="CrashLoopBackOff"),
        ]
        self._update_status(pod)

    def _release(self, pod: Pod) -> None:
        """Takes the termination finalizer off a pod whose containers have
        stopped; the store then removes the object."""
        def attempt():
            cur = self.client.get(Pod, pod.metadata.namespace, pod.metadata.name)
            if TERMINATION_FINALIZER in cur.metadata.finalizers:
                self.client.patch(Pod, pod.metadata.namespace, pod.metadata.name, {"metadata": {
                    "finalizers": [f for f in cur.metadata.finalizers if f != TERMINATION_FINALIZER]}})

        try:
            retry_on_conflict(attempt)
        except NotFoundError:
            pass

    def _update_status(self, pod: Pod) -> None:
        try:
            self.client.update_status(pod)
        except (ConflictError, NotFoundError):
            pass  # re-reconciled via watch anyway


class NodeLifecycle:
    """Node-agent half of host preemption (GKE maintenance semantics).

    A node carrying the deletion-candidate taint + maintenance-window notice
    (cluster/faults.py: preempt_host / SimCluster.preempt_node) keeps its
    pods alive through the grace window — that window is the slice-repair
    controller's checkpoint-before-evict opportunity — then drains: every
    pod still bound to the host is deleted and the node goes Ready=False
    until restored. The taint alone already keeps NEW pods off the host
    (scheduler taint semantics), so a drained gang can never be re-placed
    onto the dying node."""

    def __init__(self, manager: Manager):
        self.manager = manager
        self.client = manager.client

    def setup(self) -> None:
        self.manager.builder("node-lifecycle").for_(Node).complete(self.reconcile)

    def reconcile(self, req: Request) -> Optional[Result]:
        try:
            node = self.client.get(Node, "", req.name)
        except NotFoundError:
            return None
        if not any(
            t.get("key") == PREEMPTION_TAINT_KEY
            for t in node.spec.get("taints", [])
        ):
            return None
        deadline = 0.0
        notice = node.metadata.annotations.get(MAINTENANCE_WINDOW_ANNOTATION, "")
        if notice:
            try:
                deadline = parse_time(notice).timestamp()
            except ValueError:
                deadline = 0.0  # malformed notice: drain immediately
        remaining = deadline - time.time()
        if remaining > 0:
            return Result(requeue_after=max(0.01, remaining))

        # grace lapsed: drain. The host is going away — kill its pods (their
        # owners recreate them elsewhere) and mark the node NotReady.
        for pod in self.client.list(Pod):
            if (
                pod.spec.node_name == node.metadata.name
                and not pod.metadata.deletion_timestamp
            ):
                try:
                    self.client.delete(
                        Pod, pod.metadata.namespace, pod.metadata.name
                    )
                except NotFoundError:
                    pass  # racing deletion; drained either way
        if not any(
            c.type == "Ready" and c.status == "False"
            for c in node.status.conditions
        ):
            node.status.conditions = [
                Condition(
                    type="Ready",
                    status="False",
                    reason="TerminationDueToMaintenance",
                    message="host preempted (maintenance window lapsed)",
                    last_transition_time=now_rfc3339(),
                )
            ]
            try:
                self.client.update_status(node)
            except (ConflictError, NotFoundError):
                log.debug("node %s drain status write raced; re-reconciled", req.name)
        return None
