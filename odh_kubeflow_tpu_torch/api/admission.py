"""admissionregistration.k8s.io/v1 — MutatingWebhookConfiguration.

The reference registers its webhook endpoint via a kustomize-shipped
MutatingWebhookConfiguration (reference odh-notebook-controller
config/webhook/manifests.yaml; served at main.go:213-227). Here the type is
first-class so the in-tree API server can perform the same callout: on
matching writes it POSTs AdmissionReview v1 to clientConfig.url (verified
against caBundle) and applies the returned JSONPatch.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..apimachinery import KubeModel, KubeObject, default_scheme


@dataclass
class WebhookServiceReference(KubeModel):
    name: str = ""
    namespace: str = ""
    path: str = ""
    port: int = 443


@dataclass
class WebhookClientConfig(KubeModel):
    url: str = ""
    service: Optional[WebhookServiceReference] = None
    ca_bundle: str = ""  # base64 PEM, as on the wire


@dataclass
class RuleWithOperations(KubeModel):
    operations: List[str] = field(default_factory=list)  # CREATE/UPDATE/*
    api_groups: List[str] = field(default_factory=list)
    api_versions: List[str] = field(default_factory=list)
    resources: List[str] = field(default_factory=list)


@dataclass
class MutatingWebhook(KubeModel):
    name: str = ""
    client_config: WebhookClientConfig = field(default_factory=WebhookClientConfig)
    rules: List[RuleWithOperations] = field(default_factory=list)
    failure_policy: str = "Fail"
    side_effects: str = "None"
    admission_review_versions: List[str] = field(default_factory=lambda: ["v1"])
    timeout_seconds: int = 10


@dataclass
class MutatingWebhookConfiguration(KubeObject):
    webhooks: List[MutatingWebhook] = field(default_factory=list)


default_scheme.register(
    "admissionregistration.k8s.io/v1",
    "MutatingWebhookConfiguration",
    MutatingWebhookConfiguration,
)
