"""Base deployment manifests for the port's single-manager operator.

The reference ships two kustomize trees (reference components/notebook-controller/
config/ and components/odh-notebook-controller/config/: crd, rbac, manager,
webhook, default) with params.env image pinning and per-platform overlays.
This module is the manifest *builder* — plain dicts, one function per object —
and `overlay.py` is the merge/params engine. `python -m
odh_kubeflow_tpu_torch.deploy build <overlay>` renders the tree.

Accelerator deltas vs the reference manifests:
- the manager Deployment tolerates/schedules like any control-plane pod, but
  its RBAC covers the accelerator surface (nodes for topology discovery and
  the slice pool's marks, the probe agent's status reports);
- the webhook/controller are ONE Deployment (single manager, SURVEY §7);
- GKE overlay swaps the OpenShift serving-cert annotation for cert-manager
  and sets the Gateway to the GKE L7 class.

Object names, labels and the culler's keys are the ones the operator has
always shipped (`tpu-notebook-controller`, TPU_IDLE_THRESHOLD): the port's
manager takes the same place in a cluster.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from .crdgen import inference_endpoint_crd, notebook_crd, tpu_job_crd

APP_LABELS = {"app.kubernetes.io/part-of": "tpu-notebook-controller"}


def _meta(
    name: str,
    namespace: Optional[str],
    labels: Optional[Dict[str, str]] = None,
    annotations: Optional[Dict[str, str]] = None,
) -> Dict[str, Any]:
    m: Dict[str, Any] = {"name": name, "labels": {**APP_LABELS, **(labels or {})}}
    if namespace:
        m["namespace"] = namespace
    if annotations:
        m["annotations"] = annotations
    return m


def namespace(ns: str) -> Dict[str, Any]:
    return {"apiVersion": "v1", "kind": "Namespace", "metadata": _meta(ns, None)}


def service_account(ns: str) -> Dict[str, Any]:
    return {
        "apiVersion": "v1",
        "kind": "ServiceAccount",
        "metadata": _meta("tpu-notebook-controller", ns),
    }


def cluster_role() -> Dict[str, Any]:
    """Everything the manager touches — mirrors the union of the reference's
    two ClusterRoles (notebook-controller/config/rbac/role.yaml + odh
    config/rbac/role.yaml), plus the accelerator additions (nodes read for
    topology discovery; leases for leader election)."""
    # Every rule below is held against the code by the rbac-coverage checker
    # (analysis/checkers/deploylint.py) and, armed, by DEPLOYGUARD at the
    # offending call: verbs the code issues but a rule omits AND rules
    # nothing exercises both fail CI. Granted-but-unexercised rules that the
    # deployed shape still needs live in deploysurface.RBAC_EXEMPTIONS.
    rules: List[Dict[str, Any]] = [
        {
            "apiGroups": ["kubeflow.org"],
            "resources": ["notebooks", "inferenceendpoints", "tpujobs"],
            "verbs": ["get", "list", "watch", "create", "update", "patch", "delete"],
        },
        {
            "apiGroups": ["kubeflow.org"],
            "resources": [
                "notebooks/status",
                "inferenceendpoints/status",
                "tpujobs/status",
            ],
            "verbs": ["get", "update", "patch"],
        },
        {
            # OwnerReferencesPermissionEnforcement: setting ownerRefs with
            # blockOwnerDeletion needs finalizers update even though the code
            # writes finalizers through the main resource
            "apiGroups": ["kubeflow.org"],
            "resources": [
                "notebooks/finalizers",
                "inferenceendpoints/finalizers",
                "tpujobs/finalizers",
            ],
            "verbs": ["update"],
        },
        {
            "apiGroups": ["apps"],
            "resources": ["statefulsets"],
            "verbs": ["get", "list", "watch", "create", "update", "patch", "delete"],
        },
        {
            "apiGroups": [""],
            "resources": [
                "services",
                "configmaps",
                "secrets",
                "serviceaccounts",
                "events",
                "pods",
            ],
            "verbs": ["get", "list", "watch", "create", "update", "patch", "delete"],
        },
        {
            # read for topology discovery; update for the slice-pool's node
            # cordon/annotation writes (cluster/slicepool.py)
            "apiGroups": [""],
            "resources": ["nodes"],
            "verbs": ["get", "list", "watch", "update"],
        },
        {
            "apiGroups": ["networking.k8s.io"],
            "resources": ["networkpolicies"],
            "verbs": ["get", "list", "watch", "create", "update", "patch", "delete"],
        },
        {
            "apiGroups": ["gateway.networking.k8s.io"],
            "resources": ["httproutes", "referencegrants", "gateways"],
            "verbs": ["get", "list", "watch", "create", "update", "patch", "delete"],
        },
        {
            "apiGroups": ["rbac.authorization.k8s.io"],
            "resources": ["roles", "rolebindings", "clusterrolebindings"],
            "verbs": ["get", "list", "watch", "create", "update", "patch", "delete"],
        },
        {
            "apiGroups": ["authorization.k8s.io"],
            "resources": ["subjectaccessreviews"],
            "verbs": ["create"],
        },
        {
            # the extension controller reads the namespace DSPA to decide
            # pipeline wiring (controllers/extension.py)
            "apiGroups": ["datasciencepipelinesapplications.opendatahub.io"],
            "resources": ["datasciencepipelinesapplications"],
            "verbs": ["get"],
        },
        {
            # leader election: the elector only ever gets/creates/updates its
            # Lease (runtime/manager.py)
            "apiGroups": ["coordination.k8s.io"],
            "resources": ["leases"],
            "verbs": ["get", "create", "update"],
        },
    ]
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "ClusterRole",
        "metadata": _meta("tpu-notebook-controller", None),
        "rules": rules,
    }


def cluster_role_binding(ns: str) -> Dict[str, Any]:
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "ClusterRoleBinding",
        "metadata": _meta("tpu-notebook-controller", None),
        "roleRef": {
            "apiGroup": "rbac.authorization.k8s.io",
            "kind": "ClusterRole",
            "name": "tpu-notebook-controller",
        },
        "subjects": [
            {
                "kind": "ServiceAccount",
                "name": "tpu-notebook-controller",
                "namespace": ns,
            }
        ],
    }


def manager_deployment(
    ns: str,
    image: str,
    auth_proxy_image: str,
    env: Optional[Dict[str, str]] = None,
) -> Dict[str, Any]:
    """Single manager Deployment. Resource envelope matches the reference's
    (odh config/manager/manager.yaml:50-68: 500m CPU / 4Gi limit, GOMEMLIMIT
    analog via PYTHONMALLOC arena trim is not needed — memory is bounded by
    the informer cache strip, same trick as odh main.go:154-186)."""
    env = dict(env or {})
    env.setdefault("K8S_NAMESPACE", ns)
    env.setdefault("AUTH_PROXY_IMAGE", auth_proxy_image)
    env_list = [{"name": k, "value": v} for k, v in sorted(env.items())]
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": _meta(
            "tpu-notebook-controller-manager", ns, {"control-plane": "controller-manager"}
        ),
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels": {"control-plane": "controller-manager"}},
            "template": {
                "metadata": {"labels": {"control-plane": "controller-manager"}},
                "spec": {
                    "serviceAccountName": "tpu-notebook-controller",
                    "containers": [
                        {
                            "name": "manager",
                            "image": image,
                            "args": ["--leader-elect"],
                            "env": env_list,
                            "ports": [
                                {"name": "webhook", "containerPort": 9443},
                                {"name": "metrics", "containerPort": 8080},
                                {"name": "health", "containerPort": 8081},
                            ],
                            "livenessProbe": {
                                "httpGet": {"path": "/healthz", "port": 8081},
                                "initialDelaySeconds": 15,
                                "periodSeconds": 20,
                            },
                            "readinessProbe": {
                                "httpGet": {"path": "/readyz", "port": 8081},
                                "initialDelaySeconds": 5,
                                "periodSeconds": 10,
                            },
                            "resources": {
                                "requests": {"cpu": "500m", "memory": "256Mi"},
                                "limits": {"cpu": "500m", "memory": "4Gi"},
                            },
                            "volumeMounts": [
                                {
                                    "name": "webhook-certs",
                                    "mountPath": "/tmp/k8s-webhook-server/serving-certs",
                                    "readOnly": True,
                                }
                            ],
                        }
                    ],
                    "volumes": [
                        {
                            "name": "webhook-certs",
                            "secret": {"secretName": "webhook-server-cert"},
                        }
                    ],
                },
            },
        },
    }


def webhook_service(ns: str) -> Dict[str, Any]:
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": _meta("tpu-notebook-webhook-service", ns),
        "spec": {
            "ports": [{"port": 443, "targetPort": 9443}],
            "selector": {"control-plane": "controller-manager"},
        },
    }


def metrics_service(ns: str) -> Dict[str, Any]:
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": _meta("tpu-notebook-controller-metrics", ns),
        "spec": {
            "ports": [{"name": "metrics", "port": 8080, "targetPort": 8080}],
            "selector": {"control-plane": "controller-manager"},
        },
    }


def mutating_webhook_configuration(ns: str) -> Dict[str, Any]:
    """failurePolicy Fail, exactly as the reference (odh config/webhook/
    manifests.yaml) — CR writes are rejected when the webhook is down."""
    return {
        "apiVersion": "admissionregistration.k8s.io/v1",
        "kind": "MutatingWebhookConfiguration",
        "metadata": _meta("tpu-notebook-mutating-webhook", None),
        "webhooks": [
            {
                "name": "notebooks.kubeflow.org",
                "admissionReviewVersions": ["v1"],
                "sideEffects": "None",
                "failurePolicy": "Fail",
                "clientConfig": {
                    "service": {
                        "name": "tpu-notebook-webhook-service",
                        "namespace": ns,
                        "path": "/mutate-notebook-v1",
                    }
                },
                "rules": [
                    {
                        "apiGroups": ["kubeflow.org"],
                        "apiVersions": ["v1beta1", "v1", "v1alpha1"],
                        "operations": ["CREATE", "UPDATE"],
                        "resources": ["notebooks"],
                    }
                ],
            }
        ],
    }


def culler_config(
    ns: str,
    enable: bool = False,
    idle_minutes: int = 1440,
    period_minutes: int = 1,
    tpu_idle_threshold: float = 0.05,
) -> Dict[str, Any]:
    """The culler ConfigMap (reference notebook-controller-culler-config,
    config/overlays/kubeflow/kustomization.yaml:6-12) plus the device
    duty-cycle threshold that has no reference counterpart."""
    return {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": _meta("notebook-controller-culler-config", ns),
        "data": {
            "ENABLE_CULLING": "true" if enable else "false",
            "CULL_IDLE_TIME": str(idle_minutes),
            "IDLENESS_CHECK_PERIOD": str(period_minutes),
            "TPU_IDLE_THRESHOLD": str(tpu_idle_threshold),
        },
    }


def gateway(ns: str, class_name: str = "istio") -> Dict[str, Any]:
    return {
        "apiVersion": "gateway.networking.k8s.io/v1",
        "kind": "Gateway",
        "metadata": _meta("data-science-gateway", ns),
        "spec": {
            "gatewayClassName": class_name,
            "listeners": [
                {"name": "http", "port": 80, "protocol": "HTTP"},
            ],
        },
    }


def base_manifests(ns: str, image: str, auth_proxy_image: str) -> List[Dict[str, Any]]:
    """The `config/default`-equivalent aggregate."""
    return [
        namespace(ns),
        notebook_crd(),
        inference_endpoint_crd(),
        tpu_job_crd(),
        service_account(ns),
        cluster_role(),
        cluster_role_binding(ns),
        manager_deployment(ns, image, auth_proxy_image),
        webhook_service(ns),
        metrics_service(ns),
        mutating_webhook_configuration(ns),
        culler_config(ns),
    ]
