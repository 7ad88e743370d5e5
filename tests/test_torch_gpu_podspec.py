"""The port's GPU StatefulSet fields (odh_kubeflow_tpu_torch/gpu/podspec.py)
against the JAX package's controllers: a Notebook with spec.tpu v5p, 16
chips (4 hosts x 4) through NotebookReconciler.generate_statefulset, and
the same Notebook without spec.tpu through generate_statefulset, as JSON,
then apply_slice for h100 4x8 (4 hosts x 8). The two sets are equal
outside the device fields, and the device fields map one to one
(toleration key, resource and its per-host count, node selector key,
ordinal env field path; the port's list of the env names it rendered). A
second apply with another shape equals one apply to the set without a
slice. validate_spec refuses what NotebookWebhook.validate_tpu refuses."""
import copy

import pytest

import torch_threads
from odh_kubeflow_tpu.api.core import Container, EnvVar
from odh_kubeflow_tpu.api.notebook import Notebook, TPUSpec
from odh_kubeflow_tpu.apimachinery import AdmissionDeniedError
from odh_kubeflow_tpu.cluster import Client, Store
from odh_kubeflow_tpu.controllers import Config, NotebookReconciler, constants as C
from odh_kubeflow_tpu.controllers.webhook import NotebookWebhook
from odh_kubeflow_tpu.runtime import Manager
from odh_kubeflow_tpu.tpu import GKE_TPU_ACCELERATOR_LABEL, GKE_TPU_TOPOLOGY_LABEL, TPU_RESOURCE
from odh_kubeflow_tpu.tpu import ordinal_env as jax_ordinal_env
from odh_kubeflow_tpu.tpu import plan_slice as jax_plan_slice
from odh_kubeflow_tpu.tpu import tpu_env
from odh_kubeflow_tpu_torch.apimachinery import InvalidError
from odh_kubeflow_tpu_torch.gpu import (GKE_GPU_ACCELERATOR_LABEL, GPU_ENV_ANNOTATION, GPU_RESOURCE,
                                        GPU_TOPOLOGY_LABEL, apply_slice)
from odh_kubeflow_tpu_torch.gpu import gpu_env, ordinal_env
from odh_kubeflow_tpu_torch.gpu import plan_slice, validate_spec

torch_threads.cap()

USER_ENV = [EnvVar(name="FOO", value="bar"), EnvVar(name="NB_TPU_HOSTS", value="user-set")]


def _notebook(tpu=None, stopped=False):
    nb = Notebook()
    nb.metadata.name = "nb"
    nb.metadata.namespace = "user"
    if stopped:
        nb.metadata.annotations = {C.STOP_ANNOTATION: "2026-01-01T00:00:00Z"}
    nb.spec.template.spec.containers = [Container(name="nb", image="img", env=list(USER_ENV)),
                                        Container(name="sidecar", image="side")]
    nb.spec.tpu = tpu
    return nb


def _statefulset(nb):
    reconciler = NotebookReconciler(Manager(Store()), Config())
    return reconciler.generate_statefulset(nb, reconciler.plan(nb)).to_dict()


def _pair(stopped=False):
    jax_sts = _statefulset(_notebook(TPUSpec(accelerator="v5p", chips=16), stopped))
    plain = _statefulset(_notebook(None, stopped))
    shape = plan_slice("h100", topology="4x8")
    return jax_sts, apply_slice(copy.deepcopy(plain), shape), plain, shape


def _env(container):
    return {e["name"]: e.get("value", e.get("valueFrom")) for e in container.get("env", [])}


def _strip(sts, resource, selector_keys, device_env):
    """The set without its device fields."""
    sts = copy.deepcopy(sts)
    annotations = sts["metadata"].get("annotations", {})
    annotations.pop(GPU_ENV_ANNOTATION, None)
    if not annotations:
        sts["metadata"].pop("annotations", None)
    pod = sts["spec"]["template"]["spec"]
    for key in selector_keys:
        pod.get("nodeSelector", {}).pop(key, None)
    pod["tolerations"] = [t for t in pod.get("tolerations", []) if t["key"] != resource]
    for c in pod["containers"]:
        for kind in ("requests", "limits"):
            c.get("resources", {}).get(kind, {}).pop(resource, None)
        c["env"] = [e for e in c.get("env", []) if e["name"] not in device_env]
        if not c.get("resources", {}).get("requests") and not c.get("resources", {}).get("limits"):
            c.pop("resources", None)
        if not c["env"]:
            c.pop("env")
    for key in ("nodeSelector", "tolerations"):
        if not pod.get(key):
            pod.pop(key, None)
    return sts


def test_statefulsets_equal_outside_the_device_fields():
    jax_sts, port_sts, _, shape = _pair()
    js, ps = jax_sts["spec"], port_sts["spec"]
    assert ps["replicas"] == js["replicas"] == shape.hosts == 4
    assert ps["serviceName"] == js["serviceName"] == "nb-hosts"
    assert ps["podManagementPolicy"] == js["podManagementPolicy"] == "Parallel"
    jc, pc = js["template"]["spec"]["containers"][0], ps["template"]["spec"]["containers"][0]
    jenv, penv = _env(jc), _env(pc)
    # the user's env is kept, contract names included (not overridden)
    assert jenv["FOO"] == penv["FOO"] == "bar"
    assert jenv["NB_TPU_HOSTS"] == penv["NB_TPU_HOSTS"] == "user-set"
    assert jenv["TPU_WORKER_HOSTNAMES"] == penv["TPU_WORKER_HOSTNAMES"]
    assert len(penv["TPU_WORKER_HOSTNAMES"].split(",")) == 4
    # the sidecar is not the primary container: no device fields there
    assert ps["template"]["spec"]["containers"][1] == js["template"]["spec"]["containers"][1]
    # outside the device fields the sets are equal
    jax_device = {e["name"] for e in tpu_env(jax_plan_slice("v5p", chips=16), "nb", "nb-hosts", "user")} | {
        e["name"] for e in jax_ordinal_env()}
    port_device = {e["name"] for e in gpu_env(shape, "nb", "nb-hosts", "user")} | {
        e["name"] for e in ordinal_env()}
    user = {e.name for e in USER_ENV}
    assert _strip(jax_sts, TPU_RESOURCE, (GKE_TPU_ACCELERATOR_LABEL, GKE_TPU_TOPOLOGY_LABEL),
                  jax_device - user) == _strip(port_sts, GPU_RESOURCE, (GKE_GPU_ACCELERATOR_LABEL, GPU_TOPOLOGY_LABEL),
                                               port_device - user)


def test_device_fields_map_one_to_one():
    jax_sts, port_sts, _, shape = _pair()
    jpod, ppod = jax_sts["spec"]["template"]["spec"], port_sts["spec"]["template"]["spec"]
    # the toleration: one, the same operator and effect, the device's key
    (jt,), (pt,) = jpod["tolerations"], ppod["tolerations"]
    assert (jt["key"], pt["key"]) == (TPU_RESOURCE, GPU_RESOURCE)
    assert {k: v for k, v in jt.items() if k != "key"} == {k: v for k, v in pt.items() if k != "key"}
    # the resource: requests = limits = one host's devices
    jres, pres = jpod["containers"][0]["resources"], ppod["containers"][0]["resources"]
    for kind in ("requests", "limits"):
        assert jres[kind] == {TPU_RESOURCE: "4"} and pres[kind] == {GPU_RESOURCE: str(shape.chips_per_host)}
    # the node selector: the accelerator and the pool's slice shape
    assert jpod["nodeSelector"] == {GKE_TPU_ACCELERATOR_LABEL: "tpu-v5p-slice", GKE_TPU_TOPOLOGY_LABEL: "2x2x4"}
    assert ppod["nodeSelector"] == {GKE_GPU_ACCELERATOR_LABEL: "nvidia-h100-80gb", GPU_TOPOLOGY_LABEL: shape.topology}
    # the ordinal env: the same field path, torchrun's node rank
    jenv, penv = _env(jpod["containers"][0]), _env(ppod["containers"][0])
    assert penv["PET_NODE_RANK"] == jenv["JAX_PROCESS_ID"] == jenv["TPU_WORKER_ID"]
    assert penv["PET_NODE_RANK"]["fieldRef"]["fieldPath"] == "metadata.labels['apps.kubernetes.io/pod-index']"
    assert not [n for n in penv if n.startswith(("JAX_", "PJRT_"))]


def test_apply_slice_is_idempotent_and_keeps_a_stopped_set_stopped():
    _, port_sts, _, shape = _pair()
    assert apply_slice(copy.deepcopy(port_sts), shape) == port_sts
    jax_sts, stopped, _, _ = _pair(stopped=True)
    assert stopped["spec"]["replicas"] == jax_sts["spec"]["replicas"] == 0


@pytest.mark.parametrize("first,second", [("1x8", "2x8"), ("2x8", "1x8"), ("4x8", "1x2")])
def test_apply_slice_again_renders_the_new_shape_alone(first, second):
    """Re-planning a set in place: no name of the first shape's env stays
    (PET_STANDALONE beside a master address would make each pod a world of
    its own), and the user's names stay through both applies."""
    _, _, plain, _ = _pair()
    shape = plan_slice("h100", topology=second)
    again = apply_slice(apply_slice(copy.deepcopy(plain), plan_slice("h100", topology=first)), shape)
    assert again == apply_slice(copy.deepcopy(plain), shape)
    env = _env(again["spec"]["template"]["spec"]["containers"][0])
    assert (env["FOO"], env["NB_TPU_HOSTS"]) == ("bar", "user-set")
    assert (env["PET_NNODES"], env["PET_NPROC_PER_NODE"]) == (str(shape.hosts), str(shape.chips_per_host))
    assert env["NB_TPU_CHIPS_EXPECTED"] == str(shape.chips) and env["TPU_TOPOLOGY"] == second
    if shape.multi_host:
        assert "PET_STANDALONE" not in env and env["PET_NODE_RANK"] == ordinal_env()[0]["valueFrom"]
    else:
        assert env["PET_STANDALONE"] == "1" and not {"PET_MASTER_ADDR", "PET_MASTER_PORT", "PET_NODE_RANK"} & set(env)
    limits = again["spec"]["template"]["spec"]["containers"][0]["resources"]["limits"]
    assert limits == {GPU_RESOURCE: str(shape.chips_per_host)} and again["spec"]["replicas"] == shape.hosts


def test_apply_slice_single_host_has_no_ordinal_env():
    _, _, plain, _ = _pair()
    sts = apply_slice(copy.deepcopy(plain), plan_slice("h100"))
    env = _env(sts["spec"]["template"]["spec"]["containers"][0])
    assert sts["spec"]["replicas"] == 1 and "PET_NODE_RANK" not in env and env["PET_STANDALONE"] == "1"
    assert sts["spec"]["template"]["spec"]["containers"][0]["resources"]["limits"] == {GPU_RESOURCE: "1"}
    with pytest.raises(ValueError, match="serviceName"):
        apply_slice({"metadata": {"name": "x"}, "spec": {}}, plan_slice("h100"))


class _Span:
    def add_event(self, *a, **kw):
        pass

    def set_attribute(self, *a, **kw):
        pass


def _refused_by_reference(**spec):
    webhook = NotebookWebhook(Client(Store()), Config())
    try:
        webhook.validate_tpu(_notebook(TPUSpec(**spec)), _Span())
    except AdmissionDeniedError:
        return True
    return False


def _refused_by_port(**spec):
    try:
        validate_spec(spec)
    except InvalidError:
        return True
    return False


# (reference spec.tpu, port spec.tpu): the same case on each package's accelerator
CASES = {
    "both set": (dict(accelerator="v5p", topology="2x2x2", chips=8), dict(accelerator="h100", topology="1x8", chips=8)),
    "unknown accelerator": (dict(accelerator="b200"), dict(accelerator="b200")),
    "the other's accelerator": (dict(accelerator="h100"), dict(accelerator="v5p")),
    "bad runtime": (dict(accelerator="v5e", topology="2x2", runtime="cuda"),
                    dict(accelerator="h100", topology="1x2", runtime="cuda")),
    "malformed topology": (dict(accelerator="v5p", topology="banana"), dict(accelerator="h100", topology="banana")),
    "too many chips": (dict(accelerator="v5e", chips=100000), dict(accelerator="h100", chips=100000)),
    "default runtime": (dict(accelerator="v5e", topology="2x2"), dict(accelerator="h100", topology="1x2")),
    "chips only": (dict(accelerator="v5p", chips=16), dict(accelerator="h100", chips=16)),
    "no accelerator": (dict(), dict()),
}


@pytest.mark.parametrize("case", CASES)
def test_validate_spec_refuses_what_the_webhook_refuses(case):
    ref_spec, port_spec = CASES[case]
    assert _refused_by_port(**port_spec) == _refused_by_reference(**ref_spec)


def test_validate_spec_runtimes_and_shape():
    assert validate_spec({"accelerator": "h100", "chips": 16, "runtime": "pytorch"}) == plan_slice("h100", chips=16)
    assert validate_spec({}) is None and validate_spec(None) is None
    for runtime in ("jax", "pytorch-xla"):  # the reference's TPU runtimes do not run on a GPU slice
        with pytest.raises(InvalidError, match="runtime"):
            validate_spec({"accelerator": "h100", "runtime": runtime})
