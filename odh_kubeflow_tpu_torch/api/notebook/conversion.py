"""Spoke versions (v1, v1alpha1) and hub conversion (the port's copy of
odh_kubeflow_tpu/api/notebook/conversion.py).

The reference serves three structurally-identical versions with v1beta1 as hub
(reference api/v1/notebook_conversion.go:25-69, api/v1alpha1/...); conversion is
a field-wise copy. Here the spokes share the hub's dataclasses, so conversion
is an apiVersion rewrite with a lossless round-trip through the JSON form.
"""
from __future__ import annotations

from ...apimachinery import default_scheme
from ...cluster.store import register_storage_alias
from .v1beta1 import API_VERSION as HUB_API_VERSION
from .v1beta1 import KIND, Notebook

SERVED_VERSIONS = ("kubeflow.org/v1beta1", "kubeflow.org/v1", "kubeflow.org/v1alpha1")

for _v in SERVED_VERSIONS[1:]:
    default_scheme.register(_v, KIND, Notebook)
    # spoke writes land in the hub bucket so hub watches/reads see them
    # (the conversion-webhook analog; reference serves all three versions
    # through one storage version)
    register_storage_alias(_v, KIND, HUB_API_VERSION)


def convert_to_hub(nb: Notebook) -> Notebook:
    if nb.api_version == HUB_API_VERSION:
        return nb
    out = nb.deepcopy()
    out.api_version = HUB_API_VERSION
    return out


def convert_from_hub(nb: Notebook, api_version: str) -> Notebook:
    if api_version not in SERVED_VERSIONS:
        raise ValueError(f"unserved Notebook version {api_version}")
    out = nb.deepcopy()
    out.api_version = api_version
    return out
