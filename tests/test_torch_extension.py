"""The port's workbench extension (odh_kubeflow_tpu_torch.controllers.extension,
`TPUWorkbenchReconciler`) with the admission webhook in front of it, against
the JAX operator, on the CPU: one sequence driven through both stacks at
once, the objects compared on `to_dict()` JSON after each step.

- JAX stack: a SimCluster with `odh_kubeflow_tpu.main.build_manager`.
- Port stack: a port SimCluster with `odh_kubeflow_tpu_torch.main.build_manager`.

The sequence: a notebook; one with `inject-auth`; one with the pipeline
secret and RBAC; one with a runtime-image source ConfigMap; the sources
removed; every notebook deleted. Compared after each step: the HTTPRoutes,
ReferenceGrants, NetworkPolicies, Services, ServiceAccounts, Roles and
RoleBindings, ClusterRoleBindings, the CA-bundle, runtime-image and
proxy ConfigMaps, the Elyra Secret, each notebook's finalizers and whether
its reconciliation lock is gone, and the events (reason, object, message).
Uids, timestamps and resourceVersions are left out; each side's cluster
and manager stop in a `finally`.
"""
import copy
import json
import time
from types import SimpleNamespace

import pytest

import torch_threads

import odh_kubeflow_tpu.api.core as j_core
import odh_kubeflow_tpu.api.gateway as j_gateway
import odh_kubeflow_tpu.api.networking as j_networking
import odh_kubeflow_tpu.api.notebook as j_notebook
import odh_kubeflow_tpu.api.rbac as j_rbac
import odh_kubeflow_tpu.apimachinery as j_am
import odh_kubeflow_tpu.cluster as j_cluster
import odh_kubeflow_tpu.controllers as j_ctrl
import odh_kubeflow_tpu.controllers.extension as j_ext
import odh_kubeflow_tpu.probe as j_probe
from odh_kubeflow_tpu.main import build_manager
import odh_kubeflow_tpu_torch.api.core as p_core
import odh_kubeflow_tpu_torch.api.gateway as p_gateway
import odh_kubeflow_tpu_torch.api.networking as p_networking
import odh_kubeflow_tpu_torch.api.notebook as p_notebook
import odh_kubeflow_tpu_torch.api.rbac as p_rbac
import odh_kubeflow_tpu_torch.apimachinery as p_am
import odh_kubeflow_tpu_torch.cluster as p_cluster
import odh_kubeflow_tpu_torch.controllers as p_ctrl
import odh_kubeflow_tpu_torch.controllers.extension as p_ext
import odh_kubeflow_tpu_torch.probe.behavior as p_probe
from odh_kubeflow_tpu_torch.main import build_manager as p_build_manager

torch_threads.cap()

NS, CTRL_NS = "user", "tpu-notebooks-system"
CONFIG = dict(controller_namespace=CTRL_NS, set_pipeline_rbac=True, set_pipeline_secret=True,
              readiness_probe_period_s=0.1)
JAX = SimpleNamespace(name="jax", core=j_core, gateway=j_gateway, networking=j_networking, nb=j_notebook,
                      rbac=j_rbac, am=j_am, cluster=j_cluster, ctrl=j_ctrl, ext=j_ext,
                      behavior=j_probe.sim_agent_behavior)
PORT = SimpleNamespace(name="port", core=p_core, gateway=p_gateway, networking=p_networking, nb=p_notebook,
                       rbac=p_rbac, am=p_am, cluster=p_cluster, ctrl=p_ctrl, ext=p_ext,
                       behavior=p_probe.sim_agent_behavior)


class Stack:
    def __init__(self, pkg):
        self.pkg = pkg
        self.C = pkg.ctrl.constants
        self.cluster = pkg.cluster.SimCluster().start()
        self.mgr = None
        try:
            self.cluster.add_cpu_pool("cpu", nodes=2)
            self.cluster.add_pod_behavior(pkg.behavior({}))
            config = pkg.ctrl.Config(**CONFIG)
            build = build_manager if pkg is JAX else p_build_manager
            self.mgr = build(self.cluster.store, config, http_get=self.cluster.http_get)
            self.mgr.start()
        except BaseException:
            self.stop()
            raise
        self.client = self.cluster.client

    def stop(self):
        try:
            if self.mgr is not None:
                self.mgr.stop()
        finally:
            self.cluster.stop()

    def notebook(self, name, annotations=None):
        nb = self.pkg.nb.Notebook()
        nb.metadata.name, nb.metadata.namespace = name, NS
        nb.metadata.annotations = dict(annotations or {})
        nb.spec.template.spec.containers = [self.pkg.core.Container(name=name, image="wb:1")]
        return self.client.create(nb)

    def create(self, cls, name, ns, labels=None, **fields):
        obj = cls()
        obj.metadata.name, obj.metadata.namespace = name, ns
        obj.metadata.labels = dict(labels or {})
        for k, v in fields.items():
            setattr(obj, k, v)
        return self.client.create(obj)

    def snapshot(self):
        """What the comparison reads, by kind: each object's normalized
        JSON by (namespace, name)."""
        p = self.pkg
        kinds = {"HTTPRoute": p.gateway.HTTPRoute, "ReferenceGrant": p.gateway.ReferenceGrant,
                 "NetworkPolicy": p.networking.NetworkPolicy, "Service": p.core.Service,
                 "ServiceAccount": p.core.ServiceAccount, "Role": p.rbac.Role, "RoleBinding": p.rbac.RoleBinding,
                 "ClusterRoleBinding": p.rbac.ClusterRoleBinding, "ConfigMap": p.core.ConfigMap,
                 "Secret": p.core.Secret}
        out = {kind: {(o.metadata.namespace, o.metadata.name): _norm(o) for o in self.client.list(cls)}
               for kind, cls in kinds.items()}
        out["Notebook"] = {
            nb.metadata.name: {"finalizers": sorted(nb.metadata.finalizers),
                               "locked": nb.metadata.annotations.get(self.C.STOP_ANNOTATION)
                               == self.C.RECONCILIATION_LOCK_VALUE,
                               "deleting": bool(nb.metadata.deletion_timestamp)}
            for nb in self.client.list(p.nb.Notebook)}
        out["Event"] = sorted({(e.involved_object.kind, e.involved_object.name, e.reason, e.message)
                               for e in self.client.list(p.core.Event)})
        return out


def _norm(obj):
    d = copy.deepcopy(obj.to_dict())
    meta = d.get("metadata", {})
    for key in ("uid", "creationTimestamp", "resourceVersion", "generation"):
        meta.pop(key, None)
    for ref in meta.get("ownerReferences", []):
        ref.pop("uid", None)
    if d.get("kind") == "Service":  # the cluster IP the sim allocates
        (d.get("spec") or {}).pop("clusterIP", None)
    return d


@pytest.fixture()
def stacks():
    made = []
    try:
        for pkg in (JAX, PORT):
            made.append(Stack(pkg))
        yield made
    finally:
        for s in made:
            s.stop()


def _settled(stacks, ready, what, timeout=20.0):
    """Waits until `ready(stack)` holds on both sides and their snapshots
    are equal; on a timeout, asserts the snapshots equal (the diff)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if all(ready(s) for s in stacks):
                snaps = [s.snapshot() for s in stacks]
                if snaps[0] == snaps[1]:
                    return snaps[1]
        except Exception as e:  # NotFound while objects appear
            if not isinstance(e, (j_am.NotFoundError, p_am.NotFoundError)):
                raise
        time.sleep(0.05)
    assert all(ready(s) for s in stacks), f"{what}: not ready"
    jax_snap, port_snap = (s.snapshot() for s in stacks)
    for kind in jax_snap:
        assert port_snap[kind] == jax_snap[kind], f"{what}: {kind} differs"
    raise AssertionError(f"{what}: snapshots did not settle")


def _unlocked(s, name):
    nb = s.client.get(s.pkg.nb.Notebook, NS, name)
    return s.C.STOP_ANNOTATION not in nb.metadata.annotations and s.C.ROUTE_FINALIZER in nb.metadata.finalizers


def _gone(s, cls, ns, name):
    try:
        s.client.get(cls, ns, name)
    except (j_am.NotFoundError, p_am.NotFoundError):
        return True
    return False


def test_extension_objects_match_jax_through_create_auth_pipelines_images_and_delete(stacks):
    for s in stacks:
        s.notebook("wb")
    snap = _settled(stacks, lambda s: _unlocked(s, "wb"), "create")
    assert snap["Notebook"]["wb"] == {"finalizers": sorted(p_ext.FINALIZERS), "locked": False, "deleting": False}
    assert {(NS, "wb-ctrl-np")} <= set(snap["NetworkPolicy"]) and snap["HTTPRoute"]
    assert (NS, p_ext.REFERENCE_GRANT_NAME) in snap["ReferenceGrant"]

    for s in stacks:
        s.notebook("secure", {s.C.INJECT_AUTH_ANNOTATION: "true"})
    snap = _settled(stacks, lambda s: _unlocked(s, "secure") and s.client.get(
        s.pkg.rbac.ClusterRoleBinding, "", s.pkg.ext.auth_binding_name(
            s.client.get(s.pkg.nb.Notebook, NS, "secure"))), "create with inject-auth")
    assert (NS, "secure-kube-rbac-proxy") in snap["Service"] and (NS, "secure") in snap["ServiceAccount"]
    assert (NS, "secure-kube-rbac-proxy-np") in snap["NetworkPolicy"]

    for s in stacks:
        s.create(s.pkg.rbac.Role, p_ext.PIPELINE_ROLE_NAME, NS)
        s.create(s.pkg.core.Secret, p_ext.PIPELINE_SERVER_SECRET, CTRL_NS, string_data={
            "api_endpoint": "https://dspa.svc:8443", "cos_endpoint": "https://minio.svc",
            "cos_bucket": "pipelines", "cos_username": "minio", "cos_password": "secret"})
        s.notebook("pl")
        for name in ("wb", "secure"):  # nothing watches Roles: a write re-reconciles the earlier notebooks
            s.client.patch(s.pkg.nb.Notebook, NS, name, {"metadata": {"annotations": {"poke": "1"}}})
    snap = _settled(stacks, lambda s: _unlocked(s, "pl") and all(
        s.client.get(s.pkg.rbac.RoleBinding, NS, f"elyra-pipelines-{n}") for n in ("wb", "secure", "pl")),
        "create with the pipeline secret")
    assert (NS, p_ext.ELYRA_SECRET_NAME) in snap["Secret"]

    for s in stacks:
        s.create(s.pkg.core.ConfigMap, "runtime-catalog", CTRL_NS, labels={s.C.RUNTIME_IMAGE_LABEL: "true"},
                 data={"Torch 2 on H100": json.dumps({"display_name": "Torch 2 on H100",
                                                      "metadata": {"image_name": "torch:2"}})})
        s.create(s.pkg.core.ConfigMap, "odh-trusted-ca-bundle", CTRL_NS,
                 data={"ca-bundle.crt": "-----BEGIN CERTIFICATE-----\nAAA\n-----END CERTIFICATE-----"})
        s.notebook("rt")
    snap = _settled(stacks, lambda s: _unlocked(s, "rt") and s.client.get(
        s.pkg.core.ConfigMap, NS, p_ext.RUNTIME_IMAGES_CONFIGMAP) and s.client.get(
        s.pkg.core.ConfigMap, NS, "workbench-trusted-ca-bundle"), "create with a runtime-image ConfigMap")
    assert "torch_2_on_h100.json" in snap["ConfigMap"][(NS, p_ext.RUNTIME_IMAGES_CONFIGMAP)]["data"]

    for s in stacks:
        s.client.delete(s.pkg.core.ConfigMap, CTRL_NS, "runtime-catalog")
        s.client.patch(s.pkg.nb.Notebook, NS, "rt", {"metadata": {"annotations": {"poke": "1"}}})
    snap = _settled(stacks, lambda s: _gone(s, s.pkg.core.ConfigMap, NS, p_ext.RUNTIME_IMAGES_CONFIGMAP),
                    "the images' sources removed")

    routes = {}
    for s in stacks:
        routes[s.pkg.name] = [s.pkg.ext.route_name(nb) for nb in s.client.list(s.pkg.nb.Notebook)]
        binding = s.pkg.ext.auth_binding_name(s.client.get(s.pkg.nb.Notebook, NS, "secure"))
        for name in ("wb", "secure", "pl", "rt"):
            s.client.delete(s.pkg.nb.Notebook, NS, name)
    snap = _settled(stacks, lambda s: not s.client.list(s.pkg.nb.Notebook), "delete")
    assert not snap["HTTPRoute"] and not snap["ClusterRoleBinding"] and not snap["ReferenceGrant"]
    assert routes["port"] == routes["jax"] and binding
