"""The port's admission webhook (odh_kubeflow_tpu_torch.controllers.webhook)
against the JAX package's, on the CPU: each case of tests/test_webhook.py,
as one scenario run on both packages' Store and Client with the same
ConfigMaps, Secrets and Notebook dicts, the same NotebookWebhook calls.

Compared, on `to_dict()` JSON: the admitted object, every object the
admission synced (the runtime-image ConfigMap, the Elyra Secret), the
denials (the same error class, the same message outside the slice
planner's own words, which name the device), the update-blocking and its
`update-pending` annotation, the traceparent stamped at CREATE with its
open `notebook.ready` root (dropped again on a denied CREATE), and the
`webhook.mutate` spans' attributes. Uids, timestamps, resourceVersions and
trace ids are left out; `spec.tpu` and the span's accelerator type are
mapped by slice shape (JAX v5e 2x2, one host of 4 chips, against port h100
1x4; an unplannable topology on each side).
"""
import copy
import json
import re
from types import SimpleNamespace

import pytest

import odh_kubeflow_tpu.api.core as j_core
import odh_kubeflow_tpu.api.dspa as j_dspa
import odh_kubeflow_tpu.api.gateway as j_gateway
import odh_kubeflow_tpu.api.notebook as j_notebook
import odh_kubeflow_tpu.apimachinery as j_am
import odh_kubeflow_tpu.cluster as j_cluster
import odh_kubeflow_tpu.controllers as j_ctrl
import odh_kubeflow_tpu.controllers.extension as j_ext
import odh_kubeflow_tpu.controllers.webhook as j_webhook
import odh_kubeflow_tpu.tpu as j_tpu
import odh_kubeflow_tpu.utils.tracing as j_tracing
import odh_kubeflow_tpu_torch.api.core as p_core
import odh_kubeflow_tpu_torch.api.dspa as p_dspa
import odh_kubeflow_tpu_torch.api.gateway as p_gateway
import odh_kubeflow_tpu_torch.api.notebook as p_notebook
import odh_kubeflow_tpu_torch.apimachinery as p_am
import odh_kubeflow_tpu_torch.cluster as p_cluster
import odh_kubeflow_tpu_torch.controllers as p_ctrl
import odh_kubeflow_tpu_torch.controllers.extension as p_ext
import odh_kubeflow_tpu_torch.controllers.webhook as p_webhook
import odh_kubeflow_tpu_torch.gpu as p_gpu
import odh_kubeflow_tpu_torch.utils.tracing as p_tracing

NS, CTRL_NS = "user", "ctrl-ns"
# slice name -> (accelerator, topology) on each side; "unplannable" is a
# topology each side's planner refuses
JAX = SimpleNamespace(
    name="jax", core=j_core, nb=j_notebook, am=j_am, cluster=j_cluster, ctrl=j_ctrl, webhook=j_webhook, ext=j_ext,
    dspa=j_dspa, gateway=j_gateway, tracing=j_tracing, plan=j_tpu.plan_slice,
    slices={"one-host": ("v5e", "2x2"), "unplannable": ("v5p", "3x5")})
PORT = SimpleNamespace(
    name="port", core=p_core, nb=p_notebook, am=p_am, cluster=p_cluster, ctrl=p_ctrl, webhook=p_webhook, ext=p_ext,
    dspa=p_dspa, gateway=p_gateway, tracing=p_tracing, plan=p_gpu.plan_slice,
    slices={"one-host": ("h100", "1x4"), "unplannable": ("h100", "3x5")})
TRACEPARENT = re.compile(r"^00-[0-9a-f]{32}-[0-9a-f]{16}-01$")


class Side:
    """One package's store, client and registered webhook, and what a
    scenario saw there."""

    def __init__(self, pkg, **config):
        self.pkg = pkg
        pkg.tracing.clear()
        self.store = pkg.cluster.Store()
        self.client = pkg.cluster.Client(self.store)
        self.config = pkg.ctrl.Config(**{"controller_namespace": CTRL_NS, **config})
        self.C = pkg.ctrl.constants
        self.seen = []

    def register(self):
        self.pkg.webhook.NotebookWebhook(self.client, self.config).register(self.store)
        return self

    def norm(self, obj):
        """The object's JSON without uids, timestamps, resourceVersions and
        trace ids, `spec.tpu` by slice name."""
        d = copy.deepcopy(obj.to_dict() if hasattr(obj, "to_dict") else obj)
        meta = d.get("metadata", {})
        for key in ("uid", "creationTimestamp", "resourceVersion"):
            meta.pop(key, None)
        for ref in meta.get("ownerReferences", []):
            ref.pop("uid", None)
        annotations = meta.get("annotations") or {}
        if self.C.TRACEPARENT_ANNOTATION in annotations:
            assert TRACEPARENT.match(annotations[self.C.TRACEPARENT_ANNOTATION]), annotations
            annotations[self.C.TRACEPARENT_ANNOTATION] = "<traceparent>"
        tpu = (d.get("spec") or {}).get("tpu")
        if tpu:
            name = next(n for n, (a, t) in self.pkg.slices.items() if (a, t) == (tpu["accelerator"], tpu["topology"]))
            tpu["accelerator"], tpu["topology"] = name, name
        return d

    def notebook(self, name="nb", image="base:1", tpu=None, annotations=None, labels=None, runtime=""):
        nb = self.pkg.nb.Notebook()
        nb.metadata.name, nb.metadata.namespace = name, NS
        nb.metadata.annotations = dict(annotations or {})
        nb.metadata.labels = dict(labels or {})
        nb.spec.template.spec.containers = [self.pkg.core.Container(name=name, image=image)]
        if tpu:
            accelerator, topology = self.pkg.slices[tpu]
            nb.spec.tpu = self.pkg.nb.TPUSpec(accelerator=accelerator, topology=topology, runtime=runtime)
        return nb

    def configmap(self, name, ns, data, labels=None):
        cm = self.pkg.core.ConfigMap()
        cm.metadata.name, cm.metadata.namespace = name, ns
        cm.metadata.labels = dict(labels or {})
        cm.data = dict(data)
        return self.client.create(cm)

    def secret(self, name, ns, string_data):
        s = self.pkg.core.Secret()
        s.metadata.name, s.metadata.namespace = name, ns
        s.string_data = dict(string_data)
        return self.client.create(s)

    def admit(self, write, *args):
        """client.create/update of a Notebook: records the admitted object,
        or the denial's class and message, and the notebook's open readiness
        root (its trace id against the stamped traceparent)."""
        nb = args[0]
        key = f"{nb.metadata.namespace}/{nb.metadata.name}"
        try:
            out = getattr(self.client, write)(*args)
        except Exception as e:
            message = str(e)
            if "spec.tpu invalid: " in message:  # the planner's own words name the device
                head, _, planner = message.partition("spec.tpu invalid: ")
                accelerator, topology = nb.spec.tpu.accelerator, nb.spec.tpu.topology
                with pytest.raises(Exception) as want:
                    self.pkg.plan(accelerator, topology)
                assert planner == str(want.value), (planner, want.value)
                message = head + "spec.tpu invalid: <planner>"
            self.seen.append(("denied", write, type(e).__name__, message,
                              self.pkg.tracing._root_id_by_key.get(key)))
            return None
        root = self.pkg.tracing._root_id_by_key.get(key)
        stamped = out.metadata.annotations.get(self.C.TRACEPARENT_ANNOTATION, "")
        self.seen.append(("admitted", write, self.norm(out), root is not None and stamped.split("-")[1] == root))
        return out

    def get(self, cls_name, ns, name):
        cls = getattr(self.pkg.core, cls_name)
        obj = self.client.get(cls, ns, name)
        self.seen.append(("object", cls_name, self.norm(obj)))
        return obj

    def spans(self):
        """The webhook.mutate spans' attributes, in order, the accelerator
        type by slice shape."""
        out = []
        for span in self.pkg.tracing.recent_spans(name="webhook.mutate"):
            attrs = dict(span["attributes"])
            if "tpu.accelerator_type" in attrs:
                attrs["tpu.accelerator_type"] = "<slice of 4 chips>" if attrs["tpu.accelerator_type"] in (
                    "v5e-4", "h100-4") else attrs["tpu.accelerator_type"]
            out.append((span["name"], attrs, [e["name"] for e in span.get("events", [])]))
        return out


# ---------------------------------------------------------------------------
# scenarios: one per case of tests/test_webhook.py (the same inputs)
# ---------------------------------------------------------------------------


def create_injects_lock(s):
    s.register().admit("create", s.notebook())


def admits_a_planned_slice(s):
    s.register().admit("create", s.notebook(tpu="one-host"))


def invalid_tpu_rejected_at_admission(s):
    s.register()
    s.admit("create", s.notebook(tpu="unplannable"))
    s.admit("create", s.notebook(tpu="one-host", runtime="cuda"))
    s.admit("create", s.notebook(tpu="one-host", runtime="pytorch-xla"))


def image_resolved_from_catalog(s):
    s.register().configmap(s.pkg.webhook.IMAGE_CATALOG_CONFIGMAP, CTRL_NS,
                           {"jax-notebook:2026a": "gcr.io/wb/jax-notebook@sha256:abc"})
    s.admit("create", s.notebook(annotations={s.C.IMAGE_SELECTION_ANNOTATION: "jax-notebook:2026a"}))


def missing_catalog_selection_keeps_image(s):
    s.register().admit("create", s.notebook(annotations={s.C.IMAGE_SELECTION_ANNOTATION: "ghost:1"}))


def ca_bundle_mounted_when_present(s):
    s.register().configmap(s.pkg.webhook.CA_BUNDLE_CONFIGMAP, NS,
                           {"ca-bundle.crt": "-----BEGIN CERTIFICATE-----..."})
    s.admit("create", s.notebook())


def auth_sidecar_injection_and_removal(s):
    s.register().admit("create", s.notebook(annotations={s.C.INJECT_AUTH_ANNOTATION: "true"}))
    nb = s.client.get(s.pkg.nb.Notebook, NS, "nb")
    nb.metadata.annotations.pop(s.C.INJECT_AUTH_ANNOTATION)
    s.admit("update", nb)


def auth_sidecar_resource_annotation_validated(s):
    s.register().admit("create", s.notebook(annotations={s.C.INJECT_AUTH_ANNOTATION: "true",
                                                         s.C.AUTH_SIDECAR_CPU_REQUEST_ANNOTATION: "lots"}))


def auth_sidecar_resource_annotation_applied(s):
    s.register().admit("create", s.notebook(annotations={s.C.INJECT_AUTH_ANNOTATION: "true",
                                                         s.C.AUTH_SIDECAR_CPU_LIMIT_ANNOTATION: "250m",
                                                         s.C.AUTH_SIDECAR_MEMORY_LIMIT_ANNOTATION: "128Mi"}))


def update_blocking_webhook_only_drift(s):
    s.register()
    s.configmap(s.pkg.webhook.IMAGE_CATALOG_CONFIGMAP, CTRL_NS, {"jax:1": "registry/jax:v1"})
    s.admit("create", s.notebook(annotations={s.C.IMAGE_SELECTION_ANNOTATION: "jax:1"}))
    s.client.patch(s.pkg.nb.Notebook, NS, "nb", {"metadata": {"annotations": {s.C.STOP_ANNOTATION: None}}})
    cur = s.client.get(s.pkg.core.ConfigMap, CTRL_NS, s.pkg.webhook.IMAGE_CATALOG_CONFIGMAP)
    cur.data["jax:1"] = "registry/jax:v2"
    s.client.update(cur)
    nb = s.client.get(s.pkg.nb.Notebook, NS, "nb")
    nb.metadata.labels["team"] = "ml"
    s.admit("update", nb)  # reverted, update-pending
    nb = s.client.get(s.pkg.nb.Notebook, NS, "nb")
    nb.spec.template.spec.containers[0].image = "custom/override:3"
    s.admit("update", nb)  # the user's own change: applied
    nb = s.client.get(s.pkg.nb.Notebook, NS, "nb")
    del nb.metadata.annotations[s.C.IMAGE_SELECTION_ANNOTATION]
    nb.spec.template.spec.containers[0].image = "custom/override:3"
    s.admit("update", nb)


def update_applies_when_stopped(s):
    s.register()
    s.configmap(s.pkg.webhook.IMAGE_CATALOG_CONFIGMAP, CTRL_NS, {"jax:1": "registry/jax:v1"})
    s.admit("create", s.notebook(annotations={s.C.IMAGE_SELECTION_ANNOTATION: "jax:1"}))
    cur = s.client.get(s.pkg.core.ConfigMap, CTRL_NS, s.pkg.webhook.IMAGE_CATALOG_CONFIGMAP)
    cur.data["jax:1"] = "registry/jax:v2"
    s.client.update(cur)
    nb = s.client.get(s.pkg.nb.Notebook, NS, "nb")
    nb.metadata.labels["x"] = "y"
    s.admit("update", nb)


def proxy_env_injection(s):
    s.config.inject_cluster_proxy_env = True
    s.register().configmap("cluster-proxy-config", CTRL_NS,
                           {"httpProxy": "http://proxy:3128", "noProxy": ".cluster.local"})
    s.admit("create", s.notebook())


def proxy_env_user_lowercase_wins(s):
    s.config.inject_cluster_proxy_env = True
    s.register().configmap("cluster-proxy-config", CTRL_NS, {"httpProxy": "http://cluster:3128"})
    nb = s.notebook()
    nb.spec.template.spec.containers[0].set_env("http_proxy", "http://corp:8080")
    s.admit("create", nb)


def feast_config_mounted_by_label_and_unmounted_on_removal(s):
    created = s.register().admit("create", s.notebook("feasty", labels={s.C.FEAST_LABEL: "true"}))
    created.metadata.labels.pop(s.C.FEAST_LABEL)
    s.admit("update", created)


def feast_mount_idempotent(s):
    created = s.register().admit("create", s.notebook("feast2", labels={s.C.FEAST_LABEL: "true"}))
    s.admit("update", created)


def feast_legacy_volume_migrated_user_volume_kept(s):
    nb = s.notebook("legacy", labels={s.C.FEAST_LABEL: "true"})
    nb.spec.template.spec.volumes.append(s.pkg.core.Volume(name="feast-config",
                                                           config_map={"name": "legacy-feast-config"}))
    nb.spec.template.spec.containers[0].volume_mounts.append(
        s.pkg.core.VolumeMount(name="feast-config", mount_path="/opt/app-root/src/feast-config"))
    nb.spec.template.spec.volumes.append(s.pkg.core.Volume(name="feast-config-user",
                                                           config_map={"name": "my-own-cm"}))
    s.register().admit("create", nb)


def feast_legacy_volume_not_ours_untouched(s):
    nb = s.notebook("legacy2")
    nb.spec.template.spec.volumes.append(s.pkg.core.Volume(name="feast-config",
                                                           config_map={"name": "users-own-feast"}))
    s.register().admit("create", nb)


def feast_legacy_optional_volume_keeps_optionality(s):
    nb = s.notebook("legacy3", labels={s.C.FEAST_LABEL: "true"})
    nb.spec.template.spec.volumes.append(s.pkg.core.Volume(
        name="feast-config", config_map={"name": "legacy3-feast-config", "optional": True}))
    s.register().admit("create", nb)


def _runtime_source(s, ns):
    s.configmap("runtime-sources", ns, {"Tensorflow 2.x": json.dumps(
        {"display_name": "Tensorflow 2.x", "metadata": {"image_name": "tf:2"}})},
        labels={s.C.RUNTIME_IMAGE_LABEL: "true"})


def webhook_syncs_and_mounts_runtime_images(s):
    _runtime_source(s, CTRL_NS)
    nb = s.register().notebook("pipe")
    nb.spec.template.spec.containers.append(s.pkg.core.Container(name="sidecar", image="s:1"))
    s.admit("create", nb)
    s.get("ConfigMap", NS, s.pkg.ext.RUNTIME_IMAGES_CONFIGMAP)


def webhook_no_catalog_no_mount(s):
    s.register().admit("create", s.notebook("bare"))


def webhook_mounts_elyra_config_from_dspa(s):
    s.config.set_pipeline_secret = True
    s.config.gateway_name, s.config.gateway_namespace = "data-science-gateway", "gw-ns"
    s.secret("minio-creds", NS, {"accesskey": "AKIA", "secretkey": "hunter2"})
    d = s.pkg.dspa
    dspa = d.DataSciencePipelinesApplication()
    dspa.metadata.name, dspa.metadata.namespace = "dspa", NS
    dspa.spec = d.DSPASpec(object_storage=d.ObjectStorage(external_storage=d.ExternalStorage(
        host="minio.user.svc:9000", scheme="http", bucket="pipelines",
        s3_credentials_secret=d.S3CredentialsSecret(secret_name="minio-creds", access_key="accesskey",
                                                    secret_key="secretkey"))))
    s.client.create(dspa)
    gw = s.pkg.gateway.Gateway()
    gw.metadata.name, gw.metadata.namespace = "data-science-gateway", "gw-ns"
    gw.spec = s.pkg.gateway.GatewaySpec(listeners=[s.pkg.gateway.GatewayListener(name="https",
                                                                                 hostname="ds.example.com")])
    s.client.create(gw)
    s.register().admit("create", s.notebook("ds"))
    secret = s.get("Secret", NS, s.pkg.ext.ELYRA_SECRET_NAME)
    s.seen.append(("elyra", json.loads(secret.string_data["odh_dsp.json"])))


def elyra_flat_secret_fallback_still_works(s):
    s.config.set_pipeline_secret = True
    s.secret(s.pkg.ext.PIPELINE_SERVER_SECRET, CTRL_NS, {"api_endpoint": "https://flat:8443", "cos_bucket": "b"})
    s.register().admit("create", s.notebook("flat"))
    secret = s.get("Secret", NS, s.pkg.ext.ELYRA_SECRET_NAME)
    s.seen.append(("elyra", json.loads(secret.string_data["odh_dsp.json"])))


def name_longer_than_dns_label_rejected_at_admission(s):
    s.register()
    s.admit("create", s.notebook("n" * 64))
    s.admit("create", s.notebook("n" * 63))


def retried_create_replaces_the_stranded_root(s):
    """A CREATE denied after its root opened (an invalid sidecar quantity)
    drops that root; the retried, valid CREATE opens the one root its
    traceparent names."""
    s.register()
    s.admit("create", s.notebook(tpu="one-host", annotations={s.C.INJECT_AUTH_ANNOTATION: "true",
                                                              s.C.AUTH_SIDECAR_MEMORY_LIMIT_ANNOTATION: "x"}))
    s.admit("create", s.notebook(tpu="one-host", annotations={s.C.INJECT_AUTH_ANNOTATION: "true"}))


SCENARIOS = [create_injects_lock, admits_a_planned_slice, invalid_tpu_rejected_at_admission,
             image_resolved_from_catalog, missing_catalog_selection_keeps_image, ca_bundle_mounted_when_present,
             auth_sidecar_injection_and_removal, auth_sidecar_resource_annotation_validated,
             auth_sidecar_resource_annotation_applied, update_blocking_webhook_only_drift,
             update_applies_when_stopped, proxy_env_injection, proxy_env_user_lowercase_wins,
             feast_config_mounted_by_label_and_unmounted_on_removal, feast_mount_idempotent,
             feast_legacy_volume_migrated_user_volume_kept, feast_legacy_volume_not_ours_untouched,
             feast_legacy_optional_volume_keeps_optionality, webhook_syncs_and_mounts_runtime_images,
             webhook_no_catalog_no_mount, webhook_mounts_elyra_config_from_dspa,
             elyra_flat_secret_fallback_still_works, name_longer_than_dns_label_rejected_at_admission,
             retried_create_replaces_the_stranded_root]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[f.__name__ for f in SCENARIOS])
def test_webhook_matches_jax(scenario):
    sides = []
    for pkg in (JAX, PORT):
        side = Side(pkg)
        scenario(side)
        side.seen.append(("spans", side.spans()))
        sides.append(side)
    jax_seen, port_seen = (s.seen for s in sides)
    assert len(port_seen) == len(jax_seen)
    for want, got in zip(jax_seen, port_seen):
        assert got == want
    # every admitted CREATE carries a traceparent whose root is open;
    # every denied one left no root behind
    for what in port_seen:
        if what[:2] == ("admitted", "create"):
            assert what[3] is True, what
        if what[:2] == ("denied", "create"):
            assert what[4] is None, what
    assert any(what[0] in ("admitted", "denied") for what in port_seen)
