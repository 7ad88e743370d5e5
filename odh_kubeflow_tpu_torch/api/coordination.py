"""coordination.k8s.io/v1 — Lease, for manager leader election (the reference
enables it as "kubeflow-notebook-controller" / "odh-notebook-controller" —
notebook-controller/main.go:91-93, odh main.go:133-135)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..apimachinery import KubeObject, KubeModel, default_scheme


@dataclass
class LeaseSpec(KubeModel):
    holder_identity: str = ""
    lease_duration_seconds: Optional[int] = None
    acquire_time: str = ""
    renew_time: str = ""
    lease_transitions: int = 0


@dataclass
class Lease(KubeObject):
    spec: LeaseSpec = field(default_factory=LeaseSpec)


default_scheme.register("coordination.k8s.io/v1", "Lease", Lease)
