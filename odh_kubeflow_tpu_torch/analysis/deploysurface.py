"""The declared deployment surface — the ONE contract deploylint + DEPLOYGUARD share.

The machines.py pattern applied to the deployment surface itself: this
module declares what the port's committed manifests promise (RBAC verbs per
resource, webhook paths, env knobs, flow schemas), the static checkers
(analysis/checkers/deploylint.py) prove the code agrees at lint time, and
the runtime twin (utils/deployguard.py) proves the live request stream
agrees while an operator runs.

Three layers of truth, kept honest against each other:

- the *generator* (deploy/manifests.py) is authoritative for what RBAC the
  manager's ServiceAccount is granted — `declared_rbac()` calls it, so the
  contract can never drift from what `generate` writes;
- the *scheme* kinds map onto RBAC (group, resource) pairs via
  `KIND_RESOURCES` — the table the AST pass and the runtime guard both use
  to turn a typed-client call into an RBAC requirement;
- the crd-schema-drift checker pins the committed tree (deploy/tree/) to the
  generator, closing the loop (generator == committed == code).

Import-light: constants only at module scope; everything touching
deploy/manifests.py or controllers/config.py resolves lazily.
"""
from __future__ import annotations

import re
from typing import Dict, FrozenSet, Optional, Set, Tuple

# ---------------------------------------------------------------------------
# kinds -> RBAC (apiGroup, resource) — every kind the scheme registers
# ---------------------------------------------------------------------------

KIND_RESOURCES: Dict[str, Tuple[str, str]] = {
    "Notebook": ("kubeflow.org", "notebooks"),
    "InferenceEndpoint": ("kubeflow.org", "inferenceendpoints"),
    "TPUJob": ("kubeflow.org", "tpujobs"),
    "StatefulSet": ("apps", "statefulsets"),
    "Deployment": ("apps", "deployments"),
    "Lease": ("coordination.k8s.io", "leases"),
    "Gateway": ("gateway.networking.k8s.io", "gateways"),
    "HTTPRoute": ("gateway.networking.k8s.io", "httproutes"),
    "ReferenceGrant": ("gateway.networking.k8s.io", "referencegrants"),
    "NetworkPolicy": ("networking.k8s.io", "networkpolicies"),
    "Role": ("rbac.authorization.k8s.io", "roles"),
    "RoleBinding": ("rbac.authorization.k8s.io", "rolebindings"),
    "ClusterRoleBinding": ("rbac.authorization.k8s.io", "clusterrolebindings"),
    "MutatingWebhookConfiguration": (
        "admissionregistration.k8s.io",
        "mutatingwebhookconfigurations",
    ),
    "DataSciencePipelinesApplication": (
        "datasciencepipelinesapplications.opendatahub.io",
        "datasciencepipelinesapplications",
    ),
    "ConfigMap": ("", "configmaps"),
    "Event": ("", "events"),
    "Namespace": ("", "namespaces"),
    "Node": ("", "nodes"),
    "PersistentVolumeClaim": ("", "persistentvolumeclaims"),
    "Pod": ("", "pods"),
    "Secret": ("", "secrets"),
    "Service": ("", "services"),
    "ServiceAccount": ("", "serviceaccounts"),
}

# typed-client method -> (RBAC verb, subresource). update_status/patch_status
# hit `<resource>/status`; everything else hits the main resource.
CLIENT_VERBS: Dict[str, Tuple[str, str]] = {
    "create": ("create", ""),
    "get": ("get", ""),
    "list": ("list", ""),
    "update": ("update", ""),
    "update_status": ("update", "status"),
    "patch": ("patch", ""),
    "patch_status": ("patch", "status"),
    "delete": ("delete", ""),
}

# informer registration (runtime/builder): a watched kind is read via
# list+watch (+get on cache misses through the api_reader)
WATCH_METHODS = ("for_", "owns", "watches")
WATCH_VERBS = ("get", "list", "watch")


def required_rbac(method: str, kind: str) -> Optional[Tuple[str, str, str]]:
    """(apiGroup, resource[, /status], verb) one typed-client call needs,
    or None when the kind is outside the declared contract."""
    if kind not in KIND_RESOURCES or method not in CLIENT_VERBS:
        return None
    group, resource = KIND_RESOURCES[kind]
    verb, sub = CLIENT_VERBS[method]
    return (group, f"{resource}/{sub}" if sub else resource, verb)


# ---------------------------------------------------------------------------
# attribution: which modules run under the manager's ServiceAccount
# ---------------------------------------------------------------------------

# Everything here issues API requests AS the manager in a real deployment.
# The sim-cluster actors (cluster/kubelet.py, scheduler.py, statefulset.py,
# sim.py) model node agents / kube controllers with their OWN identities, so
# their traffic never counts against the manager's RBAC.
_MANAGER_MODULE_RE = re.compile(
    r"odh_kubeflow_tpu_torch/(?:"
    r"controllers/[^/]+\.py"
    r"|runtime/[^/]+\.py"
    r"|cluster/slicepool\.py"
    r"|api/core\.py"
    r"|main\.py"
    r")$"
)


def is_manager_module(path: str) -> bool:
    return bool(_MANAGER_MODULE_RE.search(path.replace("\\", "/")))


# flows owned by the manager's controllers (runtime/controller.py enters
# flow_context(name) around every reconcile) plus the canary prober. Traffic
# on these flows is DEPLOYGUARD-enforced against declared_rbac(); everything
# else (sim actors, loadtest drivers, bare test clients) is record-only.
MANAGER_FLOWS: FrozenSet[str] = frozenset(
    {
        "notebook",
        "event-mirror",
        "tpu-workbench",
        "probe-status",
        "culling",
        "slice-repair",
        "suspend-resume",
        "inference-endpoint",
        "tpu-job",
        "canary",
        # the autoscaler sweep and the router's cold-wake patch are manager
        # traffic — RBAC-enforced like every controller flow
        "endpoint-autoscaler",
        "token-router",
    }
)

# ---------------------------------------------------------------------------
# reviewed exemptions: granted-but-not-code-exercised RBAC that is still
# required by the deployed shape. Keyed (apiGroup, resource) -> rationale;
# the stale-rule direction of rbac-coverage skips these.
# ---------------------------------------------------------------------------

RBAC_EXEMPTIONS: Dict[Tuple[str, str], str] = {
    ("authorization.k8s.io", "subjectaccessreviews"): (
        "issued by the kube-rbac-proxy sidecar under the same "
        "ServiceAccount, not by manager code"
    ),
    ("kubeflow.org", "notebooks/finalizers"): (
        "OwnerReferencesPermissionEnforcement needs finalizers update even "
        "though code writes finalizers through the main resource"
    ),
    ("kubeflow.org", "inferenceendpoints/finalizers"): (
        "OwnerReferencesPermissionEnforcement needs finalizers update even "
        "though code writes finalizers through the main resource"
    ),
    ("kubeflow.org", "tpujobs/finalizers"): (
        "OwnerReferencesPermissionEnforcement needs finalizers update even "
        "though code writes finalizers through the main resource"
    ),
}


# ---------------------------------------------------------------------------
# lazy views over the generator + env registry (the authoritative halves)
# ---------------------------------------------------------------------------

_rbac_cache: Optional[Dict[Tuple[str, str], FrozenSet[str]]] = None


def declared_rbac() -> Dict[Tuple[str, str], FrozenSet[str]]:
    """(apiGroup, resource) -> granted verbs, straight from the generator
    (deploy/manifests.py cluster_role()) — the same dict `generate` writes,
    so the contract cannot drift from the committed manifests once the
    crd-schema-drift checker and the tree's drift test pin those to the
    generator."""
    global _rbac_cache
    if _rbac_cache is None:
        from ..deploy.manifests import cluster_role

        out: Dict[Tuple[str, str], Set[str]] = {}
        for rule in cluster_role()["rules"]:
            for group in rule["apiGroups"]:
                for resource in rule["resources"]:
                    out.setdefault((group, resource), set()).update(rule["verbs"])
        _rbac_cache = {k: frozenset(v) for k, v in out.items()}
    return _rbac_cache


def rbac_allows(method: str, kind: str) -> Tuple[bool, str]:
    """Does declared RBAC cover one typed-client call? Returns (ok, detail);
    kinds outside the contract are (False, why) — the runtime guard turns
    that into a drift error on manager flows."""
    req = required_rbac(method, kind)
    if req is None:
        return False, (
            f"kind {kind!r} is outside the declared deployment contract "
            "(analysis/deploysurface.py KIND_RESOURCES)"
        )
    group, resource, verb = req
    granted = declared_rbac().get((group, resource), frozenset())
    if verb in granted:
        return True, ""
    return False, (
        f"verb {verb!r} on {group or 'core'}/{resource} is not granted to "
        "the manager ServiceAccount (deploy/manifests.py cluster_role())"
    )


def declared_webhook_paths() -> FrozenSet[str]:
    """Every clientConfig path the generated webhook registration points at."""
    from ..deploy.manifests import mutating_webhook_configuration

    paths = set()
    for wh in mutating_webhook_configuration("ns")["webhooks"]:
        path = wh.get("clientConfig", {}).get("service", {}).get("path")
        if path:
            paths.add(path)
    return frozenset(paths)


def declared_env() -> Dict[str, object]:
    """name -> EnvKnob from the ENV_CONTRACT registry (controllers/config.py)."""
    from ..controllers.config import ENV_CONTRACT

    return {knob.name: knob for knob in ENV_CONTRACT}


def manifest_env_names() -> FrozenSet[str]:
    """Env names the generated Deployment stanza + culler ConfigMap carry."""
    from ..deploy.manifests import culler_config, manager_deployment

    names: Set[str] = set()
    dep = manager_deployment("ns", "img", "proxy-img")
    for container in dep["spec"]["template"]["spec"]["containers"]:
        for entry in container.get("env", []):
            names.add(entry["name"])
    names.update(culler_config("ns")["data"].keys())
    return frozenset(names)


def surface_tuples_from_artifact(data: object) -> Set[Tuple[str, str, str, str]]:
    """Normalize a surface artifact (utils/deployguard.py dump) to
    {(flow, method, kind, subresource)} tuples."""
    out: Set[Tuple[str, str, str, str]] = set()
    if isinstance(data, dict):
        data = data.get("surface", [])
    for entry in data or []:
        if isinstance(entry, dict):
            out.add(
                (
                    str(entry.get("flow", "")),
                    str(entry.get("method", "")),
                    str(entry.get("kind", "")),
                    str(entry.get("subresource", "")),
                )
            )
        elif isinstance(entry, (list, tuple)) and len(entry) == 4:
            out.add(tuple(str(x) for x in entry))  # type: ignore[arg-type]
    return out


def exercised_resources_from_surface(
    surface: Set[Tuple[str, str, str, str]],
) -> Set[Tuple[str, str]]:
    """(apiGroup, resource) pairs the recorded runtime surface touched."""
    out: Set[Tuple[str, str]] = set()
    for _flow, method, kind, _sub in surface:
        req = required_rbac(method, kind)
        if req is not None:
            out.add((req[0], req[1]))
    return out
