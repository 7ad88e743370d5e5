"""The device layer of the port (counterpart of odh_kubeflow_tpu/tpu): the
H100 slice planner, the pod env that makes `torchrun` start one process per
card, and the StatefulSet fields of a GPU slice, as functions on the
Kubernetes JSON of a StatefulSet.

    shape = plan_slice("h100", topology="2x8")   # 2 hosts x 8 cards
    apply_slice(sts, shape)                       # replicas, nvidia.com/gpu, env
"""
from .env import COORDINATOR_PORT, gpu_env, ordinal_env, pod_dns
from .podspec import GPU_ENV_ANNOTATION, apply_slice, validate_spec
from .topology import (
    GENERATIONS,
    GKE_GPU_ACCELERATOR_LABEL,
    GKE_NODEPOOL_LABEL,
    GPU_RESOURCE,
    GPU_TOPOLOGY_LABEL,
    GPUGeneration,
    SliceShape,
    parse_topology,
    plan_slice,
    slice_from_env,
)

__all__ = [
    "COORDINATOR_PORT",
    "GENERATIONS",
    "GKE_GPU_ACCELERATOR_LABEL",
    "GKE_NODEPOOL_LABEL",
    "GPU_ENV_ANNOTATION",
    "GPU_RESOURCE",
    "GPU_TOPOLOGY_LABEL",
    "GPUGeneration",
    "SliceShape",
    "apply_slice",
    "gpu_env",
    "ordinal_env",
    "parse_topology",
    "plan_slice",
    "pod_dns",
    "slice_from_env",
    "validate_spec",
]
