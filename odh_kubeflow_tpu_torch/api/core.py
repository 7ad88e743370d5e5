"""Core (v1) workload types — the subset of corev1 the notebook stack speaks,
as from-scratch dataclasses. Field shapes/JSON keys match Kubernetes so specs
written for the reference (whose NotebookSpec.Template.Spec is a raw
corev1.PodSpec — reference api/v1beta1/notebook_types.go:27-40) parse here
unchanged. Unmodeled fields ride through losslessly via KubeModel._extra."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..apimachinery import (
    Condition,
    KubeObject,
    KubeModel,
    ObjectMeta,
    default_scheme,
    jfield,
)


@dataclass
class EnvVarSource(KubeModel):
    field_ref: Optional[Dict[str, Any]] = None
    config_map_key_ref: Optional[Dict[str, Any]] = None
    secret_key_ref: Optional[Dict[str, Any]] = None


@dataclass
class EnvVar(KubeModel):
    name: str = ""
    value: str = ""
    value_from: Optional[EnvVarSource] = None


@dataclass
class ContainerPort(KubeModel):
    name: str = ""
    container_port: int = 0
    protocol: str = ""


@dataclass
class VolumeMount(KubeModel):
    name: str = ""
    mount_path: str = ""
    sub_path: str = ""
    read_only: Optional[bool] = None


@dataclass
class ResourceRequirements(KubeModel):
    limits: Dict[str, str] = field(default_factory=dict)
    requests: Dict[str, str] = field(default_factory=dict)


@dataclass
class Probe(KubeModel):
    http_get: Optional[Dict[str, Any]] = None
    tcp_socket: Optional[Dict[str, Any]] = None
    exec_: Optional[Dict[str, Any]] = jfield("exec", default=None)
    initial_delay_seconds: int = 0
    period_seconds: int = 0
    timeout_seconds: int = 0
    failure_threshold: int = 0


@dataclass
class Container(KubeModel):
    name: str = ""
    image: str = ""
    command: List[str] = field(default_factory=list)
    args: List[str] = field(default_factory=list)
    working_dir: str = ""
    env: List[EnvVar] = field(default_factory=list)
    ports: List[ContainerPort] = field(default_factory=list)
    resources: Optional[ResourceRequirements] = None
    volume_mounts: List[VolumeMount] = field(default_factory=list)
    image_pull_policy: str = ""
    liveness_probe: Optional[Probe] = None
    readiness_probe: Optional[Probe] = None
    security_context: Optional[Dict[str, Any]] = None

    def env_dict(self) -> Dict[str, str]:
        return {e.name: e.value for e in self.env}

    def set_env(self, name: str, value: str) -> None:
        for e in self.env:
            if e.name == name:
                e.value = value
                return
        self.env.append(EnvVar(name=name, value=value))

    def get_env(self, name: str) -> Optional[EnvVar]:
        for e in self.env:
            if e.name == name:
                return e
        return None


@dataclass
class Volume(KubeModel):
    name: str = ""
    config_map: Optional[Dict[str, Any]] = None
    secret: Optional[Dict[str, Any]] = None
    empty_dir: Optional[Dict[str, Any]] = None
    persistent_volume_claim: Optional[Dict[str, Any]] = None
    projected: Optional[Dict[str, Any]] = None


@dataclass
class PodSecurityContext(KubeModel):
    fs_group: Optional[int] = None
    run_as_user: Optional[int] = None
    run_as_non_root: Optional[bool] = None


@dataclass
class Toleration(KubeModel):
    key: str = ""
    operator: str = ""
    value: str = ""
    effect: str = ""


@dataclass
class PodSpec(KubeModel):
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    volumes: List[Volume] = field(default_factory=list)
    service_account_name: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    tolerations: List[Toleration] = field(default_factory=list)
    security_context: Optional[PodSecurityContext] = None
    affinity: Optional[Dict[str, Any]] = None
    subdomain: str = ""
    hostname: str = ""
    enable_service_links: Optional[bool] = None
    restart_policy: str = ""
    scheduler_name: str = ""
    node_name: str = ""

    def container(self, name: str) -> Optional[Container]:
        for c in self.containers:
            if c.name == name:
                return c
        return None

    def volume(self, name: str) -> Optional[Volume]:
        for v in self.volumes:
            if v.name == name:
                return v
        return None


@dataclass
class PodTemplateSpec(KubeModel):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)


@dataclass
class ContainerState(KubeModel):
    running: Optional[Dict[str, Any]] = None
    waiting: Optional[Dict[str, Any]] = None
    terminated: Optional[Dict[str, Any]] = None


@dataclass
class ContainerStatus(KubeModel):
    name: str = ""
    ready: bool = False
    restart_count: int = 0
    state: Optional[ContainerState] = None
    image: str = ""


@dataclass
class PodStatus(KubeModel):
    phase: str = ""
    conditions: List[Condition] = field(default_factory=list)
    container_statuses: List[ContainerStatus] = field(default_factory=list)
    pod_ip: str = ""
    host_ip: str = ""
    message: str = ""
    reason: str = ""


@dataclass
class Pod(KubeObject):
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    def is_ready(self) -> bool:
        """Pod Ready condition is True (the single definition every
        controller shares — kubelet sim, STS status, probe gate, culler)."""
        return any(
            c.type == "Ready" and c.status == "True"
            for c in self.status.conditions
        )


@dataclass
class ServicePort(KubeModel):
    name: str = ""
    port: int = 0
    target_port: Any = None
    protocol: str = ""


@dataclass
class ServiceSpec(KubeModel):
    ports: List[ServicePort] = field(default_factory=list)
    selector: Dict[str, str] = field(default_factory=dict)
    cluster_ip: str = ""
    type: str = ""


@dataclass
class Service(KubeObject):
    spec: ServiceSpec = field(default_factory=ServiceSpec)
    status: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ConfigMap(KubeObject):
    data: Dict[str, str] = field(default_factory=dict)
    binary_data: Dict[str, str] = field(default_factory=dict)


@dataclass
class Secret(KubeObject):
    data: Dict[str, str] = field(default_factory=dict)
    string_data: Dict[str, str] = field(default_factory=dict)
    type: str = ""


@dataclass
class LocalObjectReference(KubeModel):
    name: str = ""


@dataclass
class ServiceAccount(KubeObject):
    secrets: List[Dict[str, Any]] = field(default_factory=list)
    image_pull_secrets: List[LocalObjectReference] = field(default_factory=list)


@dataclass
class ObjectReference(KubeModel):
    api_version: str = ""
    kind: str = ""
    name: str = ""
    namespace: str = ""
    uid: str = ""


@dataclass
class Event(KubeObject):
    """Events are re-emitted onto Notebook CRs by the core reconciler
    (reference notebook_controller.go:98-126)."""

    involved_object: ObjectReference = field(default_factory=ObjectReference)
    reason: str = ""
    message: str = ""
    type: str = ""
    count: int = 0
    first_timestamp: str = ""
    last_timestamp: str = ""
    source: Dict[str, Any] = field(default_factory=dict)
    reporting_component: str = ""


def emit_deduped_event(
    client,
    owner: KubeObject,
    name: str,
    reason: str,
    message: str,
    etype: str = "Warning",
    api_version: str = "",
    kind: str = "",
) -> None:
    """Kubernetes-style deduplicated Event on `owner`: a repeat of the same
    event `name` bumps count/lastTimestamp instead of piling up objects; the
    first occurrence is created with an ownerRef so it's GC'd with the
    owner. The ONE emitter behind the scheduler's Unschedulable events, the
    slice-repair episode events, and the alert manager's SLOBurnRate events
    — dedup/race semantics live here exactly once."""
    from ..apimachinery import AlreadyExistsError, NotFoundError, now_rfc3339

    namespace = owner.metadata.namespace
    try:
        existing = client.get(Event, namespace, name)
        client.patch(
            Event,
            namespace,
            name,
            {
                "count": existing.count + 1,
                "lastTimestamp": now_rfc3339(),
                "message": message,
            },
        )
        return
    except NotFoundError:
        pass
    ev = Event()
    ev.metadata.name = name
    ev.metadata.namespace = namespace
    ev.involved_object = ObjectReference(
        api_version=api_version or owner.api_version,
        kind=kind or owner.kind or type(owner).__name__,
        name=owner.metadata.name,
        namespace=namespace,
        uid=owner.metadata.uid,
    )
    ev.set_owner(owner)  # GC'd with the owner
    ev.reason = reason
    ev.type = etype
    ev.message = message
    ev.first_timestamp = now_rfc3339()
    ev.last_timestamp = now_rfc3339()
    ev.count = 1
    try:
        client.create(ev)
    except AlreadyExistsError:
        pass  # racing emitter created it; count bump next time


@dataclass
class Namespace(KubeObject):
    status: Dict[str, Any] = field(default_factory=dict)


@dataclass
class NodeStatus(KubeModel):
    capacity: Dict[str, str] = field(default_factory=dict)
    allocatable: Dict[str, str] = field(default_factory=dict)
    conditions: List[Condition] = field(default_factory=list)
    addresses: List[Dict[str, str]] = field(default_factory=list)


@dataclass
class Node(KubeObject):
    spec: Dict[str, Any] = field(default_factory=dict)
    status: NodeStatus = field(default_factory=NodeStatus)


@dataclass
class PersistentVolumeClaim(KubeObject):
    spec: Dict[str, Any] = field(default_factory=dict)
    status: Dict[str, Any] = field(default_factory=dict)


for _kind, _cls in [
    ("Pod", Pod),
    ("Service", Service),
    ("ConfigMap", ConfigMap),
    ("Secret", Secret),
    ("ServiceAccount", ServiceAccount),
    ("Event", Event),
    ("Namespace", Namespace),
    ("Node", Node),
    ("PersistentVolumeClaim", PersistentVolumeClaim),
]:
    default_scheme.register("v1", _kind, _cls)
