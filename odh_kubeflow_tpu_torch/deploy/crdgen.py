"""CRD manifest generation from the port's API types (controller-gen analog).

The reference generates its CRD with controller-gen from Go struct tags
(reference ci/generate_code.sh; components/notebook-controller/config/crd/).
Here the same role is played by introspecting the dataclass type hints that
already drive serde (the port's api/ package): every `KubeModel` dataclass
becomes an openAPIV3Schema object node. Because the object model round-trips
unknown keys (serde `_extra`), every object node also carries
`x-kubernetes-preserve-unknown-fields: true`, which is exactly how the
reference's CRD treats the embedded PodSpec.

The wire names stay the reference's: the Notebook's device block is
`spec.tpu` / `status.tpu` (api/notebook/v1beta1.py), so the printer columns
read `.status.tpu.*`, and the batch kind is TPUJob.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, List, get_args, get_origin

from ..apimachinery.serde import snake_to_camel

_SCALARS = {
    str: {"type": "string"},
    int: {"type": "integer"},
    float: {"type": "number"},
    bool: {"type": "boolean"},
}


def _schema_for_hint(hint: Any, seen: tuple) -> Dict[str, Any]:
    if get_origin(hint) is typing.Union:  # Optional[X]
        args = [a for a in get_args(hint) if a is not type(None)]
        if len(args) == 1:
            return _schema_for_hint(args[0], seen)
        return {"x-kubernetes-preserve-unknown-fields": True}
    origin = get_origin(hint)
    if origin in (list, List):
        (item_t,) = get_args(hint) or (Any,)
        return {"type": "array", "items": _schema_for_hint(item_t, seen)}
    if origin is dict:
        args = get_args(hint)
        val_t = args[1] if len(args) == 2 else Any
        return {
            "type": "object",
            "additionalProperties": _schema_for_hint(val_t, seen),
        }
    if hint in _SCALARS:
        return dict(_SCALARS[hint])
    if isinstance(hint, type) and dataclasses.is_dataclass(hint):
        if hint in seen:  # recursive type: stop at an open object
            return {"type": "object", "x-kubernetes-preserve-unknown-fields": True}
        return schema_for_model(hint, seen + (hint,))
    return {"x-kubernetes-preserve-unknown-fields": True}


def schema_for_model(cls: type, _seen: tuple = ()) -> Dict[str, Any]:
    """openAPIV3Schema node for one KubeModel dataclass."""
    hints = typing.get_type_hints(cls)
    props: Dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        jname = f.metadata.get("json", snake_to_camel(f.name))
        props[jname] = _schema_for_hint(hints.get(f.name, Any), _seen or (cls,))
    return {
        "type": "object",
        "properties": props,
        "x-kubernetes-preserve-unknown-fields": True,
    }


def notebook_crd(served_versions=None) -> Dict[str, Any]:
    """The Notebook CustomResourceDefinition, all served versions.

    Mirrors reference components/notebook-controller/config/crd/bases/
    kubeflow.org_notebooks.yaml: v1beta1 is the storage (hub) version; v1 and
    v1alpha1 are served spokes (reference api/v1/notebook_conversion.go:25-69).
    """
    from ..api.notebook import Notebook
    from ..api.notebook.conversion import SERVED_VERSIONS
    from ..api.notebook.v1beta1 import API_VERSION as HUB

    served_versions = served_versions or SERVED_VERSIONS
    spec_schema = schema_for_model(
        typing.get_type_hints(Notebook)["spec"]
    )
    status_schema = schema_for_model(
        typing.get_type_hints(Notebook)["status"]
    )
    versions = []
    for av in served_versions:
        v = av.split("/", 1)[1]
        versions.append(
            {
                "name": v,
                "served": True,
                "storage": av == HUB,
                "schema": {
                    "openAPIV3Schema": {
                        "type": "object",
                        "properties": {
                            "apiVersion": {"type": "string"},
                            "kind": {"type": "string"},
                            "metadata": {"type": "object"},
                            "spec": spec_schema,
                            "status": status_schema,
                        },
                    }
                },
                "subresources": {"status": {}},
                "additionalPrinterColumns": [
                    {
                        "name": "Ready",
                        "type": "integer",
                        "jsonPath": ".status.readyReplicas",
                    },
                    {
                        "name": "Accelerator",
                        "type": "string",
                        "jsonPath": ".status.tpu.accelerator",
                    },
                    {
                        "name": "Chips",
                        "type": "integer",
                        "jsonPath": ".status.tpu.chipsVisible",
                    },
                ],
            }
        )
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": "notebooks.kubeflow.org"},
        "spec": {
            "group": "kubeflow.org",
            "names": {
                "kind": "Notebook",
                "listKind": "NotebookList",
                "plural": "notebooks",
                "singular": "notebook",
            },
            "scope": "Namespaced",
            "versions": versions,
        },
    }


def tpu_job_crd() -> Dict[str, Any]:
    """The TPUJob CustomResourceDefinition. One served version:
    v1beta1 is both hub and storage — the batch surface is new, there are
    no legacy spokes to convert."""
    from ..api.job import TPUJob

    spec_schema = schema_for_model(typing.get_type_hints(TPUJob)["spec"])
    status_schema = schema_for_model(typing.get_type_hints(TPUJob)["status"])
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": "tpujobs.kubeflow.org"},
        "spec": {
            "group": "kubeflow.org",
            "names": {
                "kind": "TPUJob",
                "listKind": "TPUJobList",
                "plural": "tpujobs",
                "singular": "tpujob",
            },
            "scope": "Namespaced",
            "versions": [
                {
                    "name": "v1beta1",
                    "served": True,
                    "storage": True,
                    "schema": {
                        "openAPIV3Schema": {
                            "type": "object",
                            "properties": {
                                "apiVersion": {"type": "string"},
                                "kind": {"type": "string"},
                                "metadata": {"type": "object"},
                                "spec": spec_schema,
                                "status": status_schema,
                            },
                        }
                    },
                    "subresources": {"status": {}},
                    "additionalPrinterColumns": [
                        {
                            "name": "Phase",
                            "type": "string",
                            "jsonPath": ".status.phase",
                        },
                        {
                            "name": "Steps",
                            "type": "integer",
                            "jsonPath": ".status.completedSteps",
                        },
                        {
                            "name": "Preemptions",
                            "type": "integer",
                            "jsonPath": ".status.preemptions",
                        },
                    ],
                }
            ],
        },
    }


def inference_endpoint_crd() -> Dict[str, Any]:
    """The InferenceEndpoint CustomResourceDefinition. One served
    version: v1beta1 is both hub and storage — the serving surface is new,
    there are no legacy spokes to convert."""
    from ..api.inference import InferenceEndpoint

    spec_schema = schema_for_model(
        typing.get_type_hints(InferenceEndpoint)["spec"]
    )
    status_schema = schema_for_model(
        typing.get_type_hints(InferenceEndpoint)["status"]
    )
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": "inferenceendpoints.kubeflow.org"},
        "spec": {
            "group": "kubeflow.org",
            "names": {
                "kind": "InferenceEndpoint",
                "listKind": "InferenceEndpointList",
                "plural": "inferenceendpoints",
                "singular": "inferenceendpoint",
            },
            "scope": "Namespaced",
            "versions": [
                {
                    "name": "v1beta1",
                    "served": True,
                    "storage": True,
                    "schema": {
                        "openAPIV3Schema": {
                            "type": "object",
                            "properties": {
                                "apiVersion": {"type": "string"},
                                "kind": {"type": "string"},
                                "metadata": {"type": "object"},
                                "spec": spec_schema,
                                "status": status_schema,
                            },
                        }
                    },
                    "subresources": {"status": {}},
                    "additionalPrinterColumns": [
                        {
                            "name": "Phase",
                            "type": "string",
                            "jsonPath": ".status.phase",
                        },
                        {
                            "name": "Ready",
                            "type": "integer",
                            "jsonPath": ".status.readyReplicas",
                        },
                        {
                            "name": "URL",
                            "type": "string",
                            "jsonPath": ".status.url",
                        },
                    ],
                }
            ],
        },
    }
