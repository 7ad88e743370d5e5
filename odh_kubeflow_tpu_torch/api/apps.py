"""apps/v1 — StatefulSet (the workload primitive: one Notebook -> one STS whose
replicas = TPU slice host count) and a minimal Deployment (the reference's
reconcilehelper also handles Deployments — common/reconcilehelper/util.go:18-60)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..apimachinery import KubeObject, KubeModel, default_scheme
from ..apimachinery.labels import LabelSelector
from .core import PodTemplateSpec


@dataclass
class StatefulSetSpec(KubeModel):
    replicas: Optional[int] = None
    selector: LabelSelector = field(default_factory=LabelSelector)
    service_name: str = ""
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    pod_management_policy: str = ""
    volume_claim_templates: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class StatefulSetStatus(KubeModel):
    replicas: int = 0
    ready_replicas: int = 0
    current_replicas: int = 0
    updated_replicas: int = 0
    observed_generation: int = 0


@dataclass
class StatefulSet(KubeObject):
    spec: StatefulSetSpec = field(default_factory=StatefulSetSpec)
    status: StatefulSetStatus = field(default_factory=StatefulSetStatus)


@dataclass
class DeploymentSpec(KubeModel):
    replicas: Optional[int] = None
    selector: LabelSelector = field(default_factory=LabelSelector)
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)


@dataclass
class DeploymentStatus(KubeModel):
    replicas: int = 0
    ready_replicas: int = 0


@dataclass
class Deployment(KubeObject):
    spec: DeploymentSpec = field(default_factory=DeploymentSpec)
    status: DeploymentStatus = field(default_factory=DeploymentStatus)


default_scheme.register("apps/v1", "StatefulSet", StatefulSet)
default_scheme.register("apps/v1", "Deployment", Deployment)
