"""rbac.authorization.k8s.io/v1 — the auth-delegation objects the extension
controller manages (reference odh controllers/notebook_kube_rbac_auth.go,
notebook_rbac.go)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from ..apimachinery import KubeObject, KubeModel, default_scheme


@dataclass
class Subject(KubeModel):
    kind: str = ""
    name: str = ""
    namespace: str = ""
    api_group: str = ""


@dataclass
class RoleRef(KubeModel):
    api_group: str = "rbac.authorization.k8s.io"
    kind: str = ""
    name: str = ""


@dataclass
class PolicyRule(KubeModel):
    api_groups: List[str] = field(default_factory=list)
    resources: List[str] = field(default_factory=list)
    resource_names: List[str] = field(default_factory=list)
    verbs: List[str] = field(default_factory=list)


@dataclass
class Role(KubeObject):
    rules: List[PolicyRule] = field(default_factory=list)


@dataclass
class RoleBinding(KubeObject):
    subjects: List[Subject] = field(default_factory=list)
    role_ref: RoleRef = field(default_factory=RoleRef)


@dataclass
class ClusterRoleBinding(KubeObject):
    subjects: List[Subject] = field(default_factory=list)
    role_ref: RoleRef = field(default_factory=RoleRef)


_g = "rbac.authorization.k8s.io/v1"
default_scheme.register(_g, "Role", Role)
default_scheme.register(_g, "RoleBinding", RoleBinding)
default_scheme.register(_g, "ClusterRoleBinding", ClusterRoleBinding)
