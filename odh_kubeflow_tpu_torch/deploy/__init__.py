"""Deploy/config layer of the port: CRD generation, base manifests, overlays.

The kustomize-equivalent for the GPU build: `crdgen` plays controller-gen,
`manifests` is config/{crd,rbac,manager,webhook,default}, `overlay` is the
params.env + overlays mechanism. The generated tree is committed inside the
package (`tree/`, with its params.env). CLI: ``python -m
odh_kubeflow_tpu_torch.deploy``.
"""
from .crdgen import notebook_crd, schema_for_model
from .overlay import OVERLAYS, build, load_params, load_yaml, merge_patch, render_yaml

__all__ = [
    "notebook_crd",
    "schema_for_model",
    "OVERLAYS",
    "build",
    "load_params",
    "load_yaml",
    "merge_patch",
    "render_yaml",
]
