"""SimCluster: the one-process cluster fixture (the port's copy of
odh_kubeflow_tpu/cluster/sim.py, with GPU node pools).

Boots the store plus the system controllers (scheduler, statefulset, kubelet)
on their own manager — the analog of envtest + KinD — extended with GPU node
pools and real per-pod HTTP servers. Product controllers run on a SEPARATE
manager, like a controller process and an API server. Every cluster carries
a fault injector (cluster/faults.py), inert until rules are added."""
from __future__ import annotations

import time
from typing import List, Optional, Tuple
from urllib.parse import urlparse

from ..api.core import Node
from ..apimachinery import (
    AlreadyExistsError,
    Condition,
    now_rfc3339,
    rfc3339_precise,
)
from ..runtime.manager import Manager
from ..gpu import GKE_GPU_ACCELERATOR_LABEL, GKE_NODEPOOL_LABEL, GPU_RESOURCE, GPU_TOPOLOGY_LABEL, plan_slice
from .client import Client
from .faults import (
    MAINTENANCE_WINDOW_ANNOTATION,
    PREEMPTION_TAINT_KEY,
    FaultInjector,
)
from .kubelet import Behavior, Kubelet, NodeLifecycle, PodDecision
from .scheduler import Scheduler
from .statefulset import StatefulSetController
from .store import Store


class SimCluster:
    def __init__(self, faults: Optional[FaultInjector] = None) -> None:
        # every cluster carries an injector (inert until rules are added):
        # tests script faults without rebuilding the fixture
        self.faults = faults or FaultInjector()
        self.store = Store(faults=self.faults)
        self.client = Client(self.store)
        # system controllers are the CLUSTER side (kube-controller-manager /
        # kubelet analogs): they read authoritative store state, not a cache
        self.system = Manager(self.store, cached_reads=False)
        self.scheduler = Scheduler(self.system)
        self.sts_controller = StatefulSetController(self.system)
        self.kubelet = Kubelet(self.system)
        self.node_lifecycle = NodeLifecycle(self.system)
        self.scheduler.setup()
        self.sts_controller.setup()
        self.kubelet.setup()
        self.node_lifecycle.setup()
        self.faults.bind_cluster(self)
        self._started = False

    # -- lifecycle --
    def start(self) -> "SimCluster":
        self.system.start()
        self._started = True
        return self

    def stop(self) -> None:
        self.system.stop()
        self.kubelet.shutdown_servers()
        self._started = False

    def __enter__(self) -> "SimCluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def wait_idle(self, timeout: float = 30.0) -> bool:
        return self.system.wait_idle(timeout=timeout)

    # -- node pools --
    def add_gpu_pool(
        self, name: str, accelerator: str, topology: str, slices: int = 1
    ) -> List[Node]:
        """One GKE-style GPU node pool per slice: `slices` slices of
        `accelerator`/`topology`, each slice its own pool `{name}-{i}`. Each
        node carries the pool, GKE accelerator and slice-shape labels, the
        `nvidia.com/gpu=present:NoSchedule` taint, and one host's cards as
        allocatable `nvidia.com/gpu` (gpu.plan_slice)."""
        shape = plan_slice(accelerator, topology=topology)
        nodes = []
        for s in range(slices):
            pool = f"{name}-{s}" if slices > 1 else name
            for h in range(shape.hosts):
                node = Node()
                node.metadata.name = f"{pool}-w{h}"
                node.metadata.labels = {
                    GKE_NODEPOOL_LABEL: pool,
                    GKE_GPU_ACCELERATOR_LABEL: shape.gke_accelerator,
                    GPU_TOPOLOGY_LABEL: shape.topology,
                }
                node.spec = {
                    "taints": [
                        {"key": GPU_RESOURCE, "value": "present", "effect": "NoSchedule"}
                    ]
                }
                node.status.allocatable = {
                    "cpu": "96",
                    "memory": str(400 * 2**30),
                    GPU_RESOURCE: str(shape.chips_per_host),
                }
                node.status.capacity = dict(node.status.allocatable)
                try:
                    nodes.append(self.client.create(node))
                except AlreadyExistsError:
                    pass
        return nodes

    def add_cpu_pool(self, name: str, nodes: int = 1, cpu: str = "16", memory_gi: int = 64) -> List[Node]:
        out = []
        for i in range(nodes):
            node = Node()
            node.metadata.name = f"{name}-{i}"
            node.metadata.labels = {GKE_NODEPOOL_LABEL: name}
            node.status.allocatable = {"cpu": cpu, "memory": str(memory_gi * 2**30)}
            node.status.capacity = dict(node.status.allocatable)
            try:
                out.append(self.client.create(node))
            except AlreadyExistsError:
                pass
        return out

    # -- pod behaviors (startup latency, failures, real servers) --
    def add_pod_behavior(self, behavior: Behavior) -> None:
        self.kubelet.add_behavior(behavior)

    # -- host preemption / maintenance (the slice-level fault substrate) --
    @staticmethod
    def _retry_persistent(fn, attempts: int = 40) -> None:
        """Scripted writes (taint/restore) must land even while the
        cluster's own injector is throwing 409/429 at everything — the fault
        being scripted must not eat the script."""
        from ..apimachinery import ConflictError, TooManyRequestsError

        for i in range(attempts):
            try:
                fn()
                return
            except (ConflictError, TooManyRequestsError):
                if i == attempts - 1:
                    raise
                time.sleep(0.02)

    def preempt_node(self, name: str, grace_s: float = 0.5) -> None:
        """Announce a host preemption the way GKE does: deletion-candidate
        taint + maintenance-window notice with the drain deadline. Pods stay
        up through the grace window (checkpoint-before-evict opportunity);
        NodeLifecycle drains the host when it lapses."""

        def attempt():
            node = self.client.get(Node, "", name)
            taints = [
                t
                for t in node.spec.get("taints", [])
                if t.get("key") != PREEMPTION_TAINT_KEY
            ]
            taints.append(
                {
                    "key": PREEMPTION_TAINT_KEY,
                    "value": "preempt",
                    "effect": "NoSchedule",
                }
            )
            node.spec["taints"] = taints
            # precise form: whole-second rfc3339() FLOORS, collapsing a
            # sub-second grace window to zero — the drain would beat the
            # checkpoint opportunity the notice exists to announce
            node.metadata.annotations[MAINTENANCE_WINDOW_ANNOTATION] = (
                rfc3339_precise(time.time() + grace_s)
            )
            self.client.update(node)

        self._retry_persistent(attempt)

    def fail_node(self, name: str) -> None:
        """Silent host failure: the node goes Ready=False with NO taint and
        NO maintenance notice — nothing announced it. This is the
        pool-poisoning shape: a WARM slice whose host
        dies silently sits in the pool as a trap until the suspend
        controller's sweep (or a claim-time health check) evicts it.
        Heal with restore_node."""

        def attempt():
            node = self.client.get(Node, "", name)
            node.status.conditions = [
                Condition(
                    type="Ready",
                    status="False",
                    reason="NodeFailure",
                    message="host failed silently (injected)",
                    last_transition_time=now_rfc3339(),
                )
            ]
            self.client.update_status(node)

        self._retry_persistent(attempt)

    def restore_node(self, name: str) -> None:
        """Maintenance over: taint + notice removed, node Ready again —
        capacity returns and the scheduler's capacity-freed watch re-attempts
        any pending gang."""

        def attempt():
            node = self.client.get(Node, "", name)
            node.spec["taints"] = [
                t
                for t in node.spec.get("taints", [])
                if t.get("key") != PREEMPTION_TAINT_KEY
            ]
            node.metadata.annotations.pop(MAINTENANCE_WINDOW_ANNOTATION, None)
            self.client.update(node)

        def heal_status():
            node = self.client.get(Node, "", name)
            if any(
                c.type == "Ready" and c.status == "False"
                for c in node.status.conditions
            ):
                node.status.conditions = [
                    Condition(
                        type="Ready",
                        status="True",
                        reason="MaintenanceComplete",
                        last_transition_time=now_rfc3339(),
                    )
                ]
                self.client.update_status(node)

        self._retry_persistent(attempt)
        self._retry_persistent(heal_status)

    # -- cluster DNS --
    def resolve(self, host: str) -> Optional[Tuple[str, int]]:
        """Resolve '{pod}.{svc}.{ns}.svc...' / '{svc}.{ns}.svc...' to a real
        (host, port) if the pod runs a registered server."""
        parts = host.split(".")
        if len(parts) >= 4 and parts[2] == "svc":
            #  {svc}.{ns}.svc... -> ordinal-0 pod of the same-named notebook
            svc, ns = parts[0], parts[1]
            return self.kubelet.server_for(ns, f"{svc}-0")
        if len(parts) >= 5 and parts[3] == "svc":
            pod, _svc, ns = parts[0], parts[1], parts[2]
            return self.kubelet.server_for(ns, pod)
        return None

    def http_get(self, url: str, timeout: float = 10.0) -> Tuple[int, bytes]:
        """Cluster-DNS-aware HTTP GET (the culler's probe transport)."""
        import urllib.request

        u = urlparse(url)
        # probe-agent network partition: injected at the transport, so the
        # agent itself stays healthy and heals the instant the rule lifts
        self.faults.check("probe.http", host=u.hostname or "", url=url)
        target = self.resolve(u.hostname or "")
        if target is None:
            raise ConnectionError(f"no endpoints for {u.hostname}")
        host, port = target
        rewritten = u._replace(netloc=f"{host}:{port}").geturl()
        with urllib.request.urlopen(rewritten, timeout=timeout) as resp:
            return resp.status, resp.read()
