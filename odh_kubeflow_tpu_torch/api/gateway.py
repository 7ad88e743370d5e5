"""gateway.networking.k8s.io — HTTPRoute / ReferenceGrant / Gateway.

The reference routes every notebook through a central-namespace HTTPRoute with
a cross-namespace backendRef authorized by a per-user-namespace ReferenceGrant
(reference odh controllers/notebook_route.go:50-131,
notebook_referencegrant.go:39-69). Same model here, on GKE Gateway API.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..apimachinery import KubeObject, KubeModel, default_scheme

GATEWAY_V1 = "gateway.networking.k8s.io/v1"
GATEWAY_V1BETA1 = "gateway.networking.k8s.io/v1beta1"


@dataclass
class ParentReference(KubeModel):
    group: str = ""
    kind: str = ""
    namespace: str = ""
    name: str = ""


@dataclass
class HTTPPathMatch(KubeModel):
    type: str = "PathPrefix"
    value: str = "/"


@dataclass
class HTTPRouteMatch(KubeModel):
    path: Optional[HTTPPathMatch] = None


@dataclass
class BackendRef(KubeModel):
    group: str = ""
    kind: str = ""
    name: str = ""
    namespace: str = ""
    port: Optional[int] = None
    weight: Optional[int] = None


@dataclass
class HTTPBackendRef(BackendRef):
    pass


@dataclass
class HTTPRouteRule(KubeModel):
    matches: List[HTTPRouteMatch] = field(default_factory=list)
    backend_refs: List[HTTPBackendRef] = field(default_factory=list)
    filters: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class HTTPRouteSpec(KubeModel):
    parent_refs: List[ParentReference] = field(default_factory=list)
    hostnames: List[str] = field(default_factory=list)
    rules: List[HTTPRouteRule] = field(default_factory=list)


@dataclass
class HTTPRoute(KubeObject):
    spec: HTTPRouteSpec = field(default_factory=HTTPRouteSpec)
    status: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ReferenceGrantFrom(KubeModel):
    group: str = ""
    kind: str = ""
    namespace: str = ""


@dataclass
class ReferenceGrantTo(KubeModel):
    group: str = ""
    kind: str = ""
    name: str = ""


@dataclass
class ReferenceGrantSpec(KubeModel):
    from_: List[ReferenceGrantFrom] = field(
        default_factory=list, metadata={"json": "from"}
    )
    to: List[ReferenceGrantTo] = field(default_factory=list)


@dataclass
class ReferenceGrant(KubeObject):
    spec: ReferenceGrantSpec = field(default_factory=ReferenceGrantSpec)


@dataclass
class GatewayListener(KubeModel):
    name: str = ""
    hostname: str = ""
    port: int = 0
    protocol: str = ""


@dataclass
class GatewaySpec(KubeModel):
    gateway_class_name: str = ""
    listeners: List[GatewayListener] = field(default_factory=list)


@dataclass
class Gateway(KubeObject):
    spec: GatewaySpec = field(default_factory=GatewaySpec)
    status: Dict[str, Any] = field(default_factory=dict)


default_scheme.register(GATEWAY_V1, "HTTPRoute", HTTPRoute)
default_scheme.register(GATEWAY_V1, "Gateway", Gateway)
default_scheme.register(GATEWAY_V1BETA1, "ReferenceGrant", ReferenceGrant)
