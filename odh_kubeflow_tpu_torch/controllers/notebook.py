"""Core Notebook reconciler: Notebook CR -> StatefulSet + Service(s) + status
(the port's copy of odh_kubeflow_tpu/controllers/notebook.py, on GPU slices).

The slice's pod fields come from `gpu.apply_slice`, the one rendering rule of
a GPU slice: the reconciler builds the set without them and hands its JSON to
apply_slice (replicas, the GKE GPU node selector, the `nvidia.com/gpu`
toleration, requests and limits, and the `gpu_env` / `ordinal_env` torchrun
env).

A re-design of the Go reference's NotebookReconciler
(reference components/notebook-controller/controllers/notebook_controller.go:
Reconcile :93-297, generateStatefulSet :433-523, generateService :525-552,
updateNotebookStatus :299-374, setPrefixEnvVar :417-431):

- `spec.tpu` drives the slice: replicas = hosts (the reference hard-wires 1),
  `nvidia.com/gpu` requests at cards-per-host granularity, the GKE
  accelerator node selector, and a headless per-host Service for stable pod
  DNS (torchrun's rendezvous address on a multi-host slice),
- the stop annotation (`kubeflow-resource-stopped`) scales to 0 — culling a
  GPU notebook frees the WHOLE slice,
- status mirrors pod conditions/container state like the reference, plus
  `status.tpu` slice bring-up (hosts ready / chips visible / mesh ready),
- the restart annotation deletes all ordinal pods, not just {name}-0.
"""
from __future__ import annotations

import logging
from typing import List, Optional

from ..api.apps import StatefulSet
from ..api.core import (
    Container,
    ContainerPort,
    Event,
    ObjectReference,
    Pod,
    PodSecurityContext,
    Service,
    ServicePort,
)
from ..api.notebook import Notebook, TPUStatus
from ..apimachinery import (
    AlreadyExistsError,
    Condition,
    NotFoundError,
    now_rfc3339,
    sanitize_name,
)
from ..cluster.client import retry_on_conflict
from ..runtime.controller import Request, Result
from ..runtime.manager import Manager
from ..gpu import SliceShape, apply_slice, plan_slice
from ..utils import tracing
from ..utils.tracing import reconcile_tracer
from . import constants as C
from .conditions import REPAIR_OWNED_CONDITIONS
from .config import Config
from .metrics import NotebookMetrics

log = logging.getLogger(__name__)


def statefulset_name(nb_name: str) -> str:
    """Deterministic 52-char clamp (truncate + hash) where the reference
    switches to generateName `nb-` past 52 chars (notebook_controller.go:
    58-59): pod ordinals append `-N` and the name must stay a valid DNS
    label — multi-host coordinator addressing depends on it. Deterministic
    (unlike generateName) so level-triggered reconciles converge."""
    return sanitize_name(nb_name, max_len=52)


def hosts_service_name(nb_name: str) -> str:
    # a DNS label itself (pod DNS is {pod}.{svc}.{ns}.svc...): clamp at 63
    return sanitize_name(f"{nb_name}-hosts", max_len=63)


def per_ordinal_probe_urls(
    client, config, nb: Notebook, hosts: int, path: str
) -> List[str]:
    """One agent endpoint per ordinal over per-pod DNS — shared by the
    culler's /tpu/utilization probe and the readiness gate's /tpu/readiness
    probe so addressing fixes land once. Rides the StatefulSet's ACTUAL
    serviceName (immutable in real k8s: an STS created before a rename keeps
    its old headless svc), falling back to the derived name."""
    svc = hosts_service_name(nb.metadata.name)
    sts_name = statefulset_name(nb.metadata.name)
    try:
        sts = client.get(StatefulSet, nb.metadata.namespace, sts_name)
        if sts.spec.service_name:
            svc = sts.spec.service_name
    except NotFoundError:
        pass
    return [
        f"http://{sts_name}-{i}.{svc}.{nb.metadata.namespace}.svc."
        f"{config.cluster_domain}:{config.probe_port}{path}"
        for i in range(hosts)
    ]


class NotebookReconciler:
    def __init__(self, manager: Manager, config: Optional[Config] = None,
                 metrics: Optional[NotebookMetrics] = None):
        self.manager = manager
        self.client = manager.client
        self.api_reader = manager.api_reader
        self.config = config or Config()
        self.metrics = metrics or NotebookMetrics(manager.metrics, manager.client)

    def setup(self) -> None:
        def pod_is_labeled(ev: str, obj: dict, old: Optional[dict]) -> bool:
            # predNBPodIsLabeled analog (reference notebook_controller.go:740-751)
            return C.NOTEBOOK_NAME_LABEL in obj.get("metadata", {}).get("labels", {})

        def map_pod(obj: dict) -> List[tuple]:
            meta = obj.get("metadata", {})
            name = meta.get("labels", {}).get(C.NOTEBOOK_NAME_LABEL)
            return [(meta.get("namespace", ""), name)] if name else []

        (
            self.manager.builder("notebook")
            .for_(Notebook)
            .owns(StatefulSet)
            .owns(Service)
            .watches(Pod, map_pod, predicate=pod_is_labeled)
            .with_workers(self.config.max_concurrent_reconciles)
            .complete(self.reconcile)
        )

    # ---------- generation ----------

    def plan(self, nb: Notebook) -> Optional[SliceShape]:
        if nb.spec.tpu is None or not nb.spec.tpu.accelerator:
            return None
        return plan_slice(
            nb.spec.tpu.accelerator, nb.spec.tpu.topology, nb.spec.tpu.chips
        )

    def generate_statefulset(self, nb: Notebook, shape: Optional[SliceShape]) -> StatefulSet:
        sts = StatefulSet()
        sts.metadata.name = statefulset_name(nb.metadata.name)
        sts.metadata.namespace = nb.metadata.namespace
        sts.metadata.labels = {C.NOTEBOOK_NAME_LABEL: nb.metadata.name}

        stopped = C.STOP_ANNOTATION in nb.metadata.annotations
        if (
            stopped
            and nb.metadata.annotations.get(C.TPU_SUSPEND_STATE_ANNOTATION)
            == "checkpointing"
        ):
            # checkpoint-before-suspend window (controllers/suspend.py): the
            # stop is real but the scale-down waits — every ready host's
            # /tpu/checkpoint hook must be driven while the pods still exist.
            # The suspend controller flips the state to "suspended" (bounded
            # window), and THEN replicas go to 0.
            stopped = False
        hosts = shape.hosts if shape else 1
        sts.spec.replicas = 0 if stopped else hosts
        sts.spec.selector.match_labels = {C.NOTEBOOK_NAME_LABEL: nb.metadata.name}
        # Always the headless service: per-pod DNS records only exist behind a
        # headless Service, and the culler's TPU probe needs {name}-0.{svc}
        # even for single-host slices (a ClusterIP service can't resolve pods)
        sts.spec.service_name = hosts_service_name(nb.metadata.name)
        sts.spec.pod_management_policy = "Parallel"  # slice hosts boot together

        template = sts.spec.template
        template.metadata.labels = {C.NOTEBOOK_NAME_LABEL: nb.metadata.name}
        template.metadata.annotations = {}
        # propagate the readiness trace to the pods: the kubelet (sim) and
        # the in-pod probe agent join the trace via this annotation
        traceparent = nb.metadata.annotations.get(C.TRACEPARENT_ANNOTATION)
        if traceparent:
            template.metadata.annotations[C.TRACEPARENT_ANNOTATION] = traceparent
        template.spec = nb.spec.template.spec.deepcopy()
        self._default_container(nb, template.spec)

        if self.config.add_fsgroup:
            if template.spec.security_context is None:
                template.spec.security_context = PodSecurityContext()
            if template.spec.security_context.fs_group is None:
                template.spec.security_context.fs_group = C.DEFAULT_FS_GROUP

        sts.set_owner(nb)
        if shape is not None:
            sts = StatefulSet.from_dict(apply_slice(
                sts.to_dict(), shape, nb.metadata.namespace, self.config.cluster_domain
            ))
        return sts

    def _default_container(self, nb: Notebook, podspec) -> None:
        """Defaulting the reference applies to the primary container
        (notebook_controller.go:493-521); the GPU resource binding and env
        are apply_slice's."""
        container: Optional[Container] = None
        for c in podspec.containers:
            if c.name == nb.metadata.name:
                container = c
                break
        if container is None:
            if not podspec.containers:
                podspec.containers.append(Container(name=nb.metadata.name, image=""))
            container = podspec.containers[0]

        if not container.working_dir:
            container.working_dir = C.DEFAULT_WORKING_DIR
        if not container.ports:
            container.ports = [
                ContainerPort(
                    name="notebook-port", container_port=C.NOTEBOOK_PORT, protocol="TCP"
                )
            ]
        container.set_env(
            C.PREFIX_ENV, f"/notebook/{nb.metadata.namespace}/{nb.metadata.name}"
        )

    def generate_service(self, nb: Notebook) -> Service:
        svc = Service()
        svc.metadata.name = nb.metadata.name
        svc.metadata.namespace = nb.metadata.namespace
        svc.metadata.labels = {C.NOTEBOOK_NAME_LABEL: nb.metadata.name}
        svc.spec.type = "ClusterIP"
        svc.spec.selector = {C.NOTEBOOK_NAME_LABEL: nb.metadata.name}
        svc.spec.ports = [
            ServicePort(
                name=C.NOTEBOOK_PORT_NAME,
                port=80,
                target_port=C.NOTEBOOK_PORT,
                protocol="TCP",
            )
        ]
        svc.set_owner(nb)
        return svc

    def generate_hosts_service(self, nb: Notebook) -> Service:
        """Headless Service: stable {pod}.{svc} DNS for every slice host —
        torchrun's static rendezvous at the ordinal-0 pod on 8476 (the port
        keeps the reference's port and its name)."""
        svc = Service()
        svc.metadata.name = hosts_service_name(nb.metadata.name)
        svc.metadata.namespace = nb.metadata.namespace
        svc.metadata.labels = {C.NOTEBOOK_NAME_LABEL: nb.metadata.name}
        svc.spec.cluster_ip = "None"
        svc.spec.selector = {C.NOTEBOOK_NAME_LABEL: nb.metadata.name}
        svc.spec.ports = [
            ServicePort(name="jax-coordinator", port=8476, target_port=8476),
            ServicePort(name="probe", port=self.config.probe_port,
                        target_port=self.config.probe_port),
        ]
        svc.set_owner(nb)
        return svc

    # ---------- reconcile ----------

    def reconcile(self, req: Request) -> Optional[Result]:
        try:
            nb = self.client.get(Notebook, req.namespace, req.name)
        except NotFoundError:
            # the CR is gone: close the readiness root the webhook opened
            # under this key, or a deleted-before-ready notebook leaks its
            # root until capacity eviction (tracing_roots_evicted_total
            # reason="deleted" counts these)
            tracing.discard_root_for(req.key)
            return None
        if nb.metadata.deletion_timestamp:
            tracing.discard_root_for(req.key)
            return None

        shape = self.plan(nb)
        # per-phase child spans of the readiness trace (annotation-carried):
        # one reconcile = one `reconcile.notebook` span with STS/service/
        # status children, so bench.py can decompose where bring-up time goes
        traceparent = nb.metadata.annotations.get(C.TRACEPARENT_ANNOTATION)
        with reconcile_tracer.start_span(
            "reconcile.notebook", traceparent=traceparent,
            notebook=nb.metadata.name, namespace=nb.metadata.namespace,
        ):
            with reconcile_tracer.start_span("reconcile.statefulset"):
                self._reconcile_statefulset(nb, shape)
            with reconcile_tracer.start_span("reconcile.service"):
                self._reconcile_service(nb, self.generate_service(nb))
                self._reconcile_service(nb, self.generate_hosts_service(nb))
            with reconcile_tracer.start_span("reconcile.status"):
                self._update_status(nb, shape)
            self._handle_restart(nb)
        return None

    def _reconcile_statefulset(self, nb: Notebook, shape: Optional[SliceShape]) -> None:
        desired = self.generate_statefulset(nb, shape)

        def sts_diff(current) -> bool:
            return (
                current.metadata.labels != desired.metadata.labels
                or current.spec.replicas != desired.spec.replicas
                or current.spec.template.to_dict() != desired.spec.template.to_dict()
            )

        # cached no-op pre-check (controller-runtime reads through the cache
        # here): a steady-state reconcile costs zero API requests. Cache lag
        # is level-triggered-safe — the event that updates the cache
        # re-enqueues the notebook.
        try:
            if not sts_diff(self.client.get(
                StatefulSet, nb.metadata.namespace, desired.metadata.name
            )):
                return
        except NotFoundError:
            # cache-absent -> straight create, skipping the fresh-read
            # attempt (first reconcile of every notebook; a stale cache
            # lands in AlreadyExists and falls through to the RMW)
            try:
                self.client.create(desired)
                self.metrics.notebook_create_total.inc()
                return
            except AlreadyExistsError:
                pass
            except Exception:
                self.metrics.notebook_create_failed_total.inc()
                raise

        def attempt():
            try:
                # FRESH read: the cached view after our own create/update is
                # stale exactly in the write-to-informer-dispatch window
                current = self.api_reader.get(
                    StatefulSet, nb.metadata.namespace, desired.metadata.name
                )
            except NotFoundError:
                try:
                    self.client.create(desired)
                    self.metrics.notebook_create_total.inc()
                except AlreadyExistsError:
                    return  # a racing reconcile created it: converged
                except Exception:
                    self.metrics.notebook_create_failed_total.inc()
                    raise
                return
            # CopyStatefulSetFields semantics (reference common/
            # reconcilehelper/util.go:107-160): labels/annotations/replicas/
            # template copied over
            changed = False
            if current.metadata.labels != desired.metadata.labels:
                current.metadata.labels = desired.metadata.labels
                changed = True
            if current.spec.replicas != desired.spec.replicas:
                current.spec.replicas = desired.spec.replicas
                changed = True
            if current.spec.template.to_dict() != desired.spec.template.to_dict():
                current.spec.template = desired.spec.template
                changed = True
            if changed:
                self.client.update(current)

        retry_on_conflict(attempt)

    def _reconcile_service(self, nb: Notebook, desired: Service) -> None:
        def svc_diff(current) -> bool:
            return (
                current.metadata.labels != desired.metadata.labels
                or current.spec.selector != desired.spec.selector
                or [p.to_dict() for p in current.spec.ports]
                != [p.to_dict() for p in desired.spec.ports]
            )

        # cached no-op pre-check (see _reconcile_statefulset)
        try:
            if not svc_diff(self.client.get(
                Service, nb.metadata.namespace, desired.metadata.name
            )):
                return
        except NotFoundError:
            try:
                self.client.create(desired)
                return
            except AlreadyExistsError:
                pass  # stale cache or racing reconcile: RMW below

        def attempt():
            try:
                current = self.api_reader.get(
                    Service, nb.metadata.namespace, desired.metadata.name
                )
            except NotFoundError:
                try:
                    self.client.create(desired)
                except AlreadyExistsError:
                    pass  # racing reconcile won; level-triggered convergence
                return
            # CopyServiceFields: keep clusterIP, copy selector/ports/labels
            changed = False
            if current.metadata.labels != desired.metadata.labels:
                current.metadata.labels = desired.metadata.labels
                changed = True
            if current.spec.selector != desired.spec.selector:
                current.spec.selector = desired.spec.selector
                changed = True
            if [p.to_dict() for p in current.spec.ports] != [
                p.to_dict() for p in desired.spec.ports
            ]:
                current.spec.ports = desired.spec.ports
                changed = True
            if changed:
                self.client.update(current)

        retry_on_conflict(attempt)

    def _update_status(self, nb: Notebook, shape: Optional[SliceShape]) -> None:
        # CACHED reads build the candidate status (the reference's status
        # mirroring reads pods/STS through mgr.GetClient()'s cache too);
        # level-triggered reconciles make cache lag self-healing — the event
        # that updates the cache re-enqueues this notebook. The write path
        # below still read-modify-writes against a FRESH read, and skips the
        # API entirely when the cached object already carries the candidate
        # status (under a create storm this is the difference between ~3
        # uncached reads per event and none).
        try:
            sts = self.client.get(
                StatefulSet, nb.metadata.namespace, statefulset_name(nb.metadata.name)
            )
        except NotFoundError:
            return
        pods = [
            p
            for p in self.client.list(
                Pod,
                namespace=nb.metadata.namespace,
                labels={C.NOTEBOOK_NAME_LABEL: nb.metadata.name},
            )
            if not p.metadata.deletion_timestamp
        ]
        ready_pods = sum(1 for p in pods if p.is_ready())

        before = nb.status.to_dict()  # pre-mutation snapshot for the no-op check
        status = nb.status
        # ready_replicas derives from the CACHED pod set rather than
        # sts.status.readyReplicas (the reference copies the latter,
        # notebook_controller.go:299-313): the value is identical — the STS
        # controller computes it from the same pods — but pod-derived is one
        # event hop fresher during bring-up (pod-ready -> mirror directly,
        # instead of pod-ready -> STS status write -> mirror; measured
        # ~300 ms of storm-time informer backlog on that extra hop, which
        # the mesh_ready gate would otherwise serialize onto every slice)
        status.ready_replicas = min(
            ready_pods,
            sts.spec.replicas if sts.spec.replicas is not None else ready_pods,
        )

        # mirror pod 0 (PodCondToNotebookCond analog, :376-415)
        pod0 = next(
            (
                p
                for p in pods
                if p.metadata.name == f"{statefulset_name(nb.metadata.name)}-0"
            ),
            None,
        )
        if pod0 is not None:
            # the pod-condition mirror must not stomp the repair stack's
            # conditions (TPUHealthy/Degraded — probe_status + slice_repair
            # own those; see controllers/conditions.py)
            preserved = [
                c
                for c in status.conditions
                if c.type in REPAIR_OWNED_CONDITIONS
            ]
            status.conditions = [
                Condition(
                    type=c.type,
                    status=c.status,
                    reason=c.reason,
                    message=c.message,
                    last_probe_time=c.last_probe_time,
                    last_transition_time=c.last_transition_time,
                )
                for c in pod0.status.conditions
            ] + preserved
            primary = next(
                (
                    cs
                    for cs in pod0.status.container_statuses
                    if cs.name == nb.metadata.name
                ),
                None,
            ) or (pod0.status.container_statuses[0] if pod0.status.container_statuses else None)
            if primary is not None:
                status.container_state = primary.state

        if shape is not None:
            status.tpu = status.tpu or TPUStatus()
            status.tpu.accelerator = shape.accelerator
            status.tpu.topology = shape.topology
            status.tpu.hosts = shape.hosts
            status.tpu.chips_per_host = shape.chips_per_host
            status.tpu.chips_expected = shape.chips
            status.tpu.hosts_ready = ready_pods
            # chips_visible / mesh_ready / first_ready_time are OWNED by the
            # device-visibility gate (controllers/probe_status.py): pod-Ready
            # alone must never flip them — a host whose libtpu sees 2 of 4
            # chips keeps mesh_ready false even with every pod Ready

        # no-op pre-check against the object in hand (cache-served): the
        # mirroring above never touches the probe controller's fields, so if
        # the candidate equals the pre-mutation snapshot, the write — one
        # API call — can be skipped entirely
        if status.to_dict() == before:
            return

        # merge-PATCH of this controller's OWNED fields only: one request,
        # no read-modify-write loop, conflict-free against the probe
        # controller by construction (disjoint ownership — its
        # chipsVisible/meshReady/firstReadyTime never appear in this patch,
        # so the server-side merge preserves them)
        spatch = status.to_dict()
        tpu_patch = spatch.get("tpu")
        if tpu_patch is not None:
            for k in ("chipsVisible", "meshReady", "firstReadyTime"):
                tpu_patch.pop(k, None)
            # zero must be WRITTEN, not omitted: to_dict's omitempty drops
            # hostsReady=0, so a drained slice's stored non-zero count could
            # never converge — the no-op pre-check then failed on every
            # pass and each content-identical patch still bumped
            # resourceVersion, re-enqueueing this notebook in a ~165/s
            # write loop for as long as it stayed suspended (found by the
            # promotion drive when the loop's spans flooded the
            # trace ring)
            tpu_patch["hostsReady"] = status.tpu.hosts_ready
        spatch["readyReplicas"] = status.ready_replicas  # same zero contract
        if "containerState" not in spatch:
            spatch["containerState"] = None  # explicit null deletes (pod gone)
        try:
            # route through the status coalescer when the manager carries one
            # (runtime/coalesce.py): adjacent mirror patches in one sync wave
            # batch into a single PATCH, owned zeros/nulls preserved
            coalescer = getattr(self.manager, "status_coalescer", None)
            if coalescer is not None:
                coalescer.patch_status(
                    Notebook, nb.metadata.namespace, nb.metadata.name, spatch
                )
            else:
                self.client.patch_status(
                    Notebook, nb.metadata.namespace, nb.metadata.name, spatch
                )
        except NotFoundError:
            pass  # deleted mid-reconcile

    def _handle_restart(self, nb: Notebook) -> None:
        """notebooks.opendatahub.io/notebook-restart handling (reference
        notebook_controller.go:262-294), generalized to all ordinals."""
        if nb.metadata.annotations.get(C.NOTEBOOK_RESTART_ANNOTATION) != "true":
            return
        for pod in self.client.list(
            Pod,
            namespace=nb.metadata.namespace,
            labels={C.NOTEBOOK_NAME_LABEL: nb.metadata.name},
        ):
            try:
                self.client.delete(Pod, pod.metadata.namespace, pod.metadata.name)
            except NotFoundError:
                pass

        def clear():
            self.client.patch(
                Notebook,
                nb.metadata.namespace,
                nb.metadata.name,
                {"metadata": {"annotations": {C.NOTEBOOK_RESTART_ANNOTATION: None}}},
            )

        retry_on_conflict(clear)


class EventMirrorController:
    """Re-emits pod/StatefulSet events onto the owning Notebook CR so users
    see scheduling/image failures on the CR itself (reference folds this into
    the main Reconcile at notebook_controller.go:98-126; a dedicated
    controller is the cleaner factoring)."""

    def __init__(self, manager: Manager):
        self.manager = manager
        self.client = manager.client

    def setup(self) -> None:
        def is_workload_event(ev: str, obj: dict, old: Optional[dict]) -> bool:
            inv = obj.get("involvedObject", {})
            return inv.get("kind") in ("Pod", "StatefulSet") and not obj.get(
                "metadata", {}
            ).get("annotations", {}).get(C.TPU_MIRRORED_EVENT_ANNOTATION)

        (
            self.manager.builder("event-mirror")
            .for_(Event, predicate=is_workload_event)
            .complete(self.reconcile)
        )

    def _notebook_for(self, inv: ObjectReference) -> Optional[Notebook]:
        """nbNameFromInvolvedObject analog (reference :705-729)."""
        if inv.kind == "Pod":
            try:
                pod = self.client.get(Pod, inv.namespace, inv.name)
            except NotFoundError:
                return None
            nb_name = pod.metadata.labels.get(C.NOTEBOOK_NAME_LABEL)
        elif inv.kind == "StatefulSet":
            nb_name = inv.name
        else:
            return None
        if not nb_name:
            return None
        try:
            nb = self.client.get(Notebook, inv.namespace, nb_name)
        except NotFoundError:
            return None
        return nb

    def reconcile(self, req: Request) -> Optional[Result]:
        try:
            ev = self.client.get(Event, req.namespace, req.name)
        except NotFoundError:
            return None
        if ev.metadata.annotations.get(C.TPU_MIRRORED_EVENT_ANNOTATION):
            return None
        if ev.involved_object.kind not in ("Pod", "StatefulSet"):
            return None
        nb = self._notebook_for(ev.involved_object)
        if nb is None:
            return None
        mirrored = Event()
        mirrored.metadata.name = f"{nb.metadata.name}.{ev.metadata.uid[:8]}"
        mirrored.metadata.namespace = nb.metadata.namespace
        mirrored.metadata.annotations = {C.TPU_MIRRORED_EVENT_ANNOTATION: "true"}
        mirrored.involved_object = ObjectReference(
            api_version=nb.api_version or "kubeflow.org/v1beta1",
            kind="Notebook",
            name=nb.metadata.name,
            namespace=nb.metadata.namespace,
            uid=nb.metadata.uid,
        )
        mirrored.reason = ev.reason
        mirrored.message = ev.message
        mirrored.type = ev.type
        mirrored.count = ev.count
        mirrored.last_timestamp = ev.last_timestamp or now_rfc3339()
        try:
            self.client.create(mirrored)
        except AlreadyExistsError:
            # source event recurred (count bumped): keep the mirror current
            try:
                self.client.patch(
                    Event,
                    mirrored.metadata.namespace,
                    mirrored.metadata.name,
                    {
                        "count": ev.count,
                        "message": ev.message,
                        "lastTimestamp": mirrored.last_timestamp,
                    },
                )
            except NotFoundError:
                pass  # event-GC race: mirror TTL'd between create and patch
        return None
