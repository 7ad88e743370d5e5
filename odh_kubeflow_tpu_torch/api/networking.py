"""networking.k8s.io/v1 — NetworkPolicy (per-notebook ingress isolation,
reference odh controllers/notebook_network.go:132-211)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..apimachinery import KubeObject, KubeModel, default_scheme
from ..apimachinery.labels import LabelSelector


@dataclass
class NetworkPolicyPort(KubeModel):
    protocol: str = ""
    port: Any = None


@dataclass
class NetworkPolicyPeer(KubeModel):
    pod_selector: Optional[LabelSelector] = None
    namespace_selector: Optional[LabelSelector] = None
    ip_block: Dict[str, Any] = field(default_factory=dict)


@dataclass
class NetworkPolicyIngressRule(KubeModel):
    ports: List[NetworkPolicyPort] = field(default_factory=list)
    from_: List[NetworkPolicyPeer] = field(
        default_factory=list, metadata={"json": "from"}
    )


@dataclass
class NetworkPolicySpec(KubeModel):
    pod_selector: LabelSelector = field(default_factory=LabelSelector)
    ingress: List[NetworkPolicyIngressRule] = field(default_factory=list)
    policy_types: List[str] = field(default_factory=list)


@dataclass
class NetworkPolicy(KubeObject):
    spec: NetworkPolicySpec = field(default_factory=NetworkPolicySpec)


default_scheme.register("networking.k8s.io/v1", "NetworkPolicy", NetworkPolicy)
