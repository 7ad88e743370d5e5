"""The port's HTTPS admission path against the JAX package's, on the CPU:
`runtime.webhook_server.WebhookServer` serving `NotebookWebhook` over TLS
with `utils.certs.generate_cert_dir`'s certificates, and
`cluster.webhook_dispatch.WebhookDispatcher` on a Store holding a
MutatingWebhookConfiguration, called directly (`dispatcher(operation, obj,
old)`) and posting through `cluster.remote.HostPool`, and behind `ApiServer`
with a `RemoteStore` writing over the wire. Every case crosses real sockets with real TLS,
and runs the same inputs through both packages.

Compared: the admitted object (the lock, the update-blocking), denials
(class and message), the AdmissionReview response on the wire,
failurePolicy Fail against Ignore when the webhook is down (and the
failures counter by policy), and a serving certificate from another CA
refused; the cases of tests/test_webhook_server.py that go through
`ApiServer`/`RemoteStore`, run on both packages by tests/torch_ported.py.
"""
import base64
import copy
import json
import ssl
import urllib.request
from types import SimpleNamespace

import pytest

import torch_ported
import odh_kubeflow_tpu.api.admission as j_admission
import odh_kubeflow_tpu.apimachinery as j_am
import odh_kubeflow_tpu.cluster as j_cluster
import odh_kubeflow_tpu.controllers as j_ctrl
import odh_kubeflow_tpu.runtime.metrics as j_metrics
import odh_kubeflow_tpu.runtime.webhook_server as j_server
import odh_kubeflow_tpu.utils.certs as j_certs
import odh_kubeflow_tpu_torch.api.admission as p_admission
import odh_kubeflow_tpu_torch.apimachinery as p_am
import odh_kubeflow_tpu_torch.cluster as p_cluster
import odh_kubeflow_tpu_torch.controllers as p_ctrl
import odh_kubeflow_tpu_torch.runtime.metrics as p_metrics
import odh_kubeflow_tpu_torch.runtime.webhook_server as p_server
import odh_kubeflow_tpu_torch.utils.certs as p_certs

JAX = SimpleNamespace(name="jax", admission=j_admission, am=j_am, cluster=j_cluster, ctrl=j_ctrl,
                      metrics=j_metrics, server=j_server, certs=j_certs, bad_slice=("v5e", "not-a-topology"))
PORT = SimpleNamespace(name="port", admission=p_admission, am=p_am, cluster=p_cluster, ctrl=p_ctrl,
                       metrics=p_metrics, server=p_server, certs=p_certs, bad_slice=("h100", "not-a-topology"))
SIDES = (JAX, PORT)


@pytest.fixture(scope="module")
def tls(tmp_path_factory):
    """The port's certificates (a CA and a serving cert for 127.0.0.1), and
    a second CA's, for the rogue webhook."""
    ca, crt, key = p_certs.generate_cert_dir(str(tmp_path_factory.mktemp("pki")))
    rogue = p_certs.generate_cert_dir(str(tmp_path_factory.mktemp("rogue")))
    with open(ca, "rb") as f:
        ca_b64 = base64.b64encode(f.read()).decode()
    return SimpleNamespace(ca=ca, crt=crt, key=key, ca_b64=ca_b64, rogue=rogue)


def nb_dict(name, tpu=None, annotations=None):
    d = {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
         "metadata": {"name": name, "namespace": "user", "annotations": dict(annotations or {})},
         "spec": {"template": {"spec": {"containers": [{"name": name, "image": "img:1"}]}}}}
    if tpu:
        d["spec"]["tpu"] = {"accelerator": tpu[0], "topology": tpu[1]}
    return d


def _config(pkg, url, ca_b64="", policy="Fail", timeout=10):
    a = pkg.admission
    cfg = a.MutatingWebhookConfiguration()
    cfg.metadata.name = "notebook-mutator"
    cfg.webhooks = [a.MutatingWebhook(
        name="notebooks.kubeflow.org",
        client_config=a.WebhookClientConfig(url=url, ca_bundle=ca_b64),
        rules=[a.RuleWithOperations(operations=["CREATE", "UPDATE"], api_groups=["kubeflow.org"],
                                    api_versions=["*"], resources=["notebooks"])],
        failure_policy=policy, timeout_seconds=timeout)]
    return cfg


class Path:
    """One package's webhook server (serving `handler`, or NotebookWebhook
    on its own store) and the dispatcher of a store whose configuration
    points at `url` (the server's by default)."""

    def __init__(self, pkg, tls, certfile=None, keyfile=None, handler=None, url=None, ca_b64=None, policy="Fail"):
        self.pkg = pkg
        self.store = pkg.cluster.Store()
        client = pkg.cluster.Client(self.store)
        self.server = None
        if url is None:
            self.server = pkg.server.WebhookServer(certfile=certfile or tls.crt, keyfile=keyfile or tls.key).start()
            self.server.register("/mutate-notebook-v1",
                                 handler or pkg.ctrl.NotebookWebhook(client, pkg.ctrl.Config()).handle)
            url = f"{self.server.base_url}/mutate-notebook-v1"
        client.create(_config(pkg, url, tls.ca_b64 if ca_b64 is None else ca_b64, policy,
                              timeout=10 if self.server else 1))
        self.dispatch = pkg.cluster.WebhookDispatcher(self.store)

    def stop(self):
        if self.server is not None:
            self.server.stop()


def _each(tls, fn, **kw):
    """fn(path) on each package's path; the results, jax's then the port's."""
    out = []
    for pkg in SIDES:
        path = Path(pkg, tls, **kw)
        try:
            out.append(fn(path))
        finally:
            path.stop()
    return out


def _masked(d):
    """The object without its traceparent's random ids."""
    d = copy.deepcopy(d)
    ann = d["metadata"].get("annotations") or {}
    if j_ctrl.constants.TRACEPARENT_ANNOTATION in ann:
        ann[j_ctrl.constants.TRACEPARENT_ANNOTATION] = "<traceparent>"
    return d


def _denial(pkg, fn):
    with pytest.raises(pkg.am.AdmissionDeniedError) as e:
        fn()
    return str(e.value)


def test_create_through_the_https_webhook_injects_the_lock(tls):
    jax_out, port_out = _each(tls, lambda p: p.dispatch("CREATE", nb_dict("locked"), None))
    C = p_ctrl.constants
    assert port_out["metadata"]["annotations"][C.STOP_ANNOTATION] == C.RECONCILIATION_LOCK_VALUE
    assert C.TRACEPARENT_ANNOTATION in port_out["metadata"]["annotations"]
    assert _masked(port_out) == _masked(jax_out)


def test_a_slice_the_planner_refuses_is_denied_over_https(tls):
    """allowed=false comes back as the dispatcher's denial: the same class
    and message up to the planner's own words, which name the device."""
    jax_msg, port_msg = _each(tls, lambda p: _denial(p.pkg, lambda: p.dispatch(
        "CREATE", nb_dict("badslice", tpu=p.pkg.bad_slice), None)))
    head = 'admission webhook "notebooks.kubeflow.org" denied the request: spec.tpu invalid: '
    assert jax_msg.startswith(head) and port_msg.startswith(head)
    with pytest.raises(p_am.InvalidError) as planner:
        p_ctrl.webhook.plan_slice(*PORT.bad_slice)
    assert port_msg == head + str(planner.value)


def test_update_blocking_over_https(tls):
    """The UPDATE carries oldObject: webhook-only drift on a running notebook
    (the auth sidecar) is reverted and marked update-pending."""
    C = p_ctrl.constants

    def update(p):
        created = p.dispatch("CREATE", nb_dict("running"), None)
        old = copy.deepcopy(created)
        old["metadata"]["annotations"].pop(C.STOP_ANNOTATION)
        old["status"] = {"readyReplicas": 1}
        new = copy.deepcopy(old)
        new["metadata"]["annotations"][C.INJECT_AUTH_ANNOTATION] = "true"
        return p.dispatch("UPDATE", new, old)

    jax_out, port_out = _each(tls, update)
    assert [c["name"] for c in port_out["spec"]["template"]["spec"]["containers"]] == ["running"]
    assert C.UPDATE_PENDING_ANNOTATION in port_out["metadata"]["annotations"]
    assert _masked(port_out) == _masked(jax_out)


@pytest.mark.parametrize("policy", ["Fail", "Ignore"])
def test_failure_policy_when_the_webhook_is_down(tls, policy):
    """Nothing listens at the webhook's URL: Fail rejects the write, Ignore
    lets it through unchanged; either way the failures counter moves under
    its policy."""
    def call(p):
        before = p.pkg.metrics.webhook_dispatch_failures_total.value(policy=policy)
        if policy == "Fail":
            out = _denial(p.pkg, lambda: p.dispatch("CREATE", nb_dict("orphan"), None))
            out = out.split(": ", 1)[0]  # the connection error's repr follows
        else:
            out = p.dispatch("CREATE", nb_dict("orphan"), None)
        return out, p.pkg.metrics.webhook_dispatch_failures_total.value(policy=policy) - before

    (jax_out, jax_n), (port_out, port_n) = _each(tls, call, url="https://127.0.0.1:1/mutate", policy=policy)
    assert port_out == jax_out and port_n == jax_n == 1
    if policy == "Fail":
        assert port_out == 'failed calling webhook "notebooks.kubeflow.org"'
    else:
        assert port_out == nb_dict("orphan")


def test_a_webhook_serving_another_cas_certificate_is_refused(tls):
    """TLS verification is real: the trusted CA did not sign the serving
    certificate, so the callout fails and failurePolicy Fail rejects."""
    _, crt, key = tls.rogue
    jax_msg, port_msg = _each(tls, lambda p: _denial(p.pkg, lambda: p.dispatch("CREATE", nb_dict("mitm"), None)),
                              certfile=crt, keyfile=key, handler=lambda req: None)
    for msg in (jax_msg, port_msg):
        assert msg.startswith('failed calling webhook "notebooks.kubeflow.org"') and "CERTIFICATE_VERIFY" in msg


def test_admission_review_wire_format(tls):
    """The same AdmissionReview posted to each package's server gets the
    same response: the uid echoed, allowed, a base64 JSONPatch."""
    review = {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
              "request": {"uid": "uid-123", "operation": "CREATE",
                          "object": {"apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": "x"}}}}

    def post(p):
        req = urllib.request.Request(f"{p.server.base_url}/mutate-notebook-v1", data=json.dumps(review).encode(),
                                     headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=5, context=ssl.create_default_context(cafile=tls.ca)) as resp:
            return json.loads(resp.read())

    jax_body, port_body = _each(tls, post, handler=lambda req: {
        **req.object, "metadata": {**req.object["metadata"], "labels": {"x": "y"}}})
    assert port_body == jax_body
    r = port_body["response"]
    assert port_body["kind"] == "AdmissionReview" and r["uid"] == "uid-123" and r["allowed"] is True
    assert r["patchType"] == "JSONPatch"
    assert {"op": "add", "path": "/metadata/labels", "value": {"x": "y"}} in json.loads(base64.b64decode(r["patch"]))


WIRE_JAX = torch_ported.load("test_webhook_server", "jax")
WIRE_PORT = torch_ported.load("test_webhook_server", "port")


@pytest.mark.parametrize("case", ["test_create_through_https_webhook_injects_lock",
                                  "test_denial_over_https_rejects_write", "test_update_blocking_via_wire"])
def test_the_wire_cases_against_the_reference(case, tmp_path):
    """tests/test_webhook_server.py's three cases through `ApiServer` and
    `RemoteStore` (a Notebook written over the wire, admitted by the HTTPS
    webhook through the MutatingWebhookConfiguration dispatcher: the lock
    injected, a refused slice denied and never stored, a running notebook's
    webhook-only drift blocked), on both packages, held to the same
    requests and answers."""
    torch_ported.both(WIRE_JAX, WIRE_PORT, case, tmp_path)

