"""The GPU slice's fields of a notebook's StatefulSet, on its Kubernetes JSON
(counterpart of the TPU parts of odh_kubeflow_tpu/controllers/webhook.py's
`validate_tpu` and controllers/notebook.py's `generate_statefulset` and
`_default_container`: replicas, node selector, toleration, resources, env
and ordinal env).

The port imports none of the reference's API models, so these functions
take and give plain dicts, the form the API server stores. The reference's
controllers plan TPU slices and import its `tpu` package directly; the port
supplies the GPU counterparts here for a caller that holds a StatefulSet.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

from ..apimachinery import InvalidError
from .env import gpu_env, ordinal_env
from .topology import GPU_RESOURCE, SliceShape, plan_slice

NOTEBOOK_NAME_LABEL = "notebook-name"  # the reference's controllers/constants.py
# on the StatefulSet: the env names apply_slice rendered into the primary
# container (comma-separated), so a later apply replaces them and keeps the
# user's
GPU_ENV_ANNOTATION = "notebooks.opendatahub.io/gpu-slice-env"
# spec.tpu.runtime values a GPU slice accepts ("" is the default)
RUNTIMES = ("", "pytorch")


def validate_spec(spec: Optional[Mapping[str, Any]]) -> Optional[SliceShape]:
    """A `spec.tpu`-shaped dict (accelerator, topology, chips, runtime) ->
    its SliceShape, None where it names no accelerator (a CPU notebook), or
    InvalidError where the reference's admission would refuse it: both
    topology and chips, an unknown accelerator or shape, or a runtime the
    slice cannot run."""
    if not spec or not spec.get("accelerator"):
        return None
    shape = plan_slice(spec["accelerator"], spec.get("topology") or "", int(spec.get("chips") or 0))
    runtime = spec.get("runtime") or ""
    if runtime not in RUNTIMES:
        raise InvalidError(f"spec.tpu.runtime {runtime!r} not supported on a GPU slice (pytorch)")
    return shape


def _primary_container(pod_spec: Dict[str, Any], name: str) -> Dict[str, Any]:
    """The container named after the notebook, else the first (the
    reference's `_default_container`)."""
    containers = pod_spec.setdefault("containers", [])
    for c in containers:
        if c.get("name") == name:
            return c
    if not containers:
        containers.append({"name": name, "image": ""})
    return containers[0]


def apply_slice(sts: Dict[str, Any], shape: SliceShape, namespace: str = "",
                cluster_domain: str = "cluster.local") -> Dict[str, Any]:
    """Puts a GPU slice into a StatefulSet's JSON, in place, and returns it:
    replicas = hosts (a stopped set's 0 stays 0), the node selector, the
    `nvidia.com/gpu` toleration (once), the primary container's
    `nvidia.com/gpu` requests and limits of one host's cards, `gpu_env`
    without overriding a name the user set, and on a multi-host slice the
    ordinal env. The pod DNS rides the set's name and its headless
    serviceName, which stays as it is; `namespace` defaults to the set's.

    The names it rendered are listed in the set's GPU_ENV_ANNOTATION, and a
    later apply (another shape) drops them before it renders the new shape's:
    the result equals one apply to the set without a slice, as the
    reference's controller renders the set from the notebook every time."""
    meta, spec = sts.setdefault("metadata", {}), sts.setdefault("spec", {})
    service = spec.get("serviceName")
    if not service:
        raise ValueError("the StatefulSet has no serviceName: the slice's pod DNS needs its headless Service")
    if spec.get("replicas") != 0:
        spec["replicas"] = shape.hosts
    pod_spec = spec.setdefault("template", {}).setdefault("spec", {})
    pod_spec.setdefault("nodeSelector", {}).update(shape.node_selector())
    tolerations = pod_spec.setdefault("tolerations", [])
    if not any(t.get("key") == GPU_RESOURCE for t in tolerations):
        tolerations.append({"key": GPU_RESOURCE, "operator": "Exists", "effect": "NoSchedule"})

    name = meta.get("labels", {}).get(NOTEBOOK_NAME_LABEL, meta.get("name", ""))
    container = _primary_container(pod_spec, name)
    resources = container.setdefault("resources", {})
    for kind in ("requests", "limits"):
        resources.setdefault(kind, {})[GPU_RESOURCE] = str(shape.chips_per_host)
    annotations = meta.setdefault("annotations", {})
    rendered = set(filter(None, annotations.get(GPU_ENV_ANNOTATION, "").split(",")))
    env = [e for e in container.get("env", []) if e["name"] not in rendered]
    user = {e["name"] for e in env}
    added = [e for e in gpu_env(shape, meta["name"], service, namespace or meta.get("namespace", ""),
                                cluster_domain) + (ordinal_env() if shape.multi_host else [])
             if e["name"] not in user]
    container["env"] = env + added
    annotations[GPU_ENV_ANNOTATION] = ",".join(e["name"] for e in added)
    return sts
