"""RESTMapper: GVK <-> REST resource mapping for the HTTP transport.

The analog of apimachinery's RESTMapper that controller-runtime builds from
discovery (the reference gets this via client-go; e.g. its typed clients
resolve Notebook -> /apis/kubeflow.org/v1beta1/namespaces/{ns}/notebooks).
Here the mapping is derived from the scheme registrations (call
`populate_from_scheme`, as the API server does at startup) plus a small
cluster-scoped override set, so both the API server and the remote client
agree on URL layout without a discovery round-trip.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


def pluralize(kind: str) -> str:
    """Lowercase-pluralize a kind the way CRD registration does."""
    word = kind.lower()
    if word.endswith("y") and word[-2:-1] not in "aeiou":
        return word[:-1] + "ies"
    if word.endswith(("s", "x", "z", "ch", "sh")):
        return word + "es"
    return word + "s"


# kinds that live at cluster scope (no /namespaces/{ns}/ segment)
_CLUSTER_SCOPED = {
    "Namespace",
    "Node",
    "ClusterRole",
    "ClusterRoleBinding",
    "MutatingWebhookConfiguration",
    "ValidatingWebhookConfiguration",
    "CustomResourceDefinition",
    "PersistentVolume",
    "OAuthClient",
}


@dataclass(frozen=True)
class RESTMapping:
    api_version: str
    kind: str
    plural: str
    namespaced: bool

    @property
    def prefix(self) -> str:
        """URL prefix: legacy core group under /api, everything else /apis."""
        return "/api/v1" if self.api_version == "v1" else f"/apis/{self.api_version}"

    def path(self, namespace: str = "", name: str = "", subresource: str = "") -> str:
        parts = [self.prefix]
        if self.namespaced and namespace:
            parts += ["namespaces", namespace]
        parts.append(self.plural)
        if name:
            parts.append(name)
        if subresource:
            parts.append(subresource)
        return "/".join(parts)


class RESTMapper:
    def __init__(self) -> None:
        self._by_gvk: Dict[Tuple[str, str], RESTMapping] = {}
        self._by_resource: Dict[Tuple[str, str], Tuple[str, str]] = {}

    def register(
        self,
        api_version: str,
        kind: str,
        plural: Optional[str] = None,
        namespaced: Optional[bool] = None,
    ) -> RESTMapping:
        m = RESTMapping(
            api_version=api_version,
            kind=kind,
            plural=plural or pluralize(kind),
            namespaced=(kind not in _CLUSTER_SCOPED) if namespaced is None else namespaced,
        )
        self._by_gvk[(api_version, kind)] = m
        self._by_resource[(api_version, m.plural)] = (api_version, kind)
        return m

    def mapping_for(self, api_version: str, kind: str) -> RESTMapping:
        m = self._by_gvk.get((api_version, kind))
        if m is None:
            m = self.register(api_version, kind)
        return m

    def kind_for(self, api_version: str, plural: str) -> Optional[Tuple[str, str]]:
        return self._by_resource.get((api_version, plural))

    def populate_from_scheme(self, scheme) -> None:
        """Eagerly register every scheme GVK so reverse (plural -> kind)
        lookups work from the first request, independent of call order."""
        for (api_version, kind) in scheme.registrations():
            if (api_version, kind) not in self._by_gvk:
                self.register(api_version, kind)


default_rest_mapper = RESTMapper()
