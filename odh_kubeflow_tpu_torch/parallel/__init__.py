"""Workbench parallelism for the port (counterpart of odh_kubeflow_tpu/parallel):
the pod's env (torchrun's, from gpu/env.py, or the webhook's) turns into a
torch.distributed world and a mesh of its ranks with a few calls:

    from odh_kubeflow_tpu_torch.gpu import slice_from_env
    from odh_kubeflow_tpu_torch.parallel import initialize_from_env, slice_mesh_axes
    rank, world = initialize_from_env()          # multi-process bring-up
    mesh = slice_mesh_axes(slice_from_env()).build()
"""
from .distributed import initialize_from_env, rank_device, reinitialize_after_repair, slice_mesh_axes
from .interleaved_1f1b import build_schedule as build_interleaved_1f1b_schedule
from .interleaved_1f1b import pipeline_value_and_grad_interleaved_1f1b
from .mesh import AXES, Mesh, MeshPlan, Placement, batch_spec, logical_to_spec, shard_batch
from .pipeline import pipeline_apply, pipeline_value_and_grad_1f1b, pipeline_value_and_grad_gpipe, stack_stages

__all__ = [
    "AXES",
    "Mesh",
    "MeshPlan",
    "Placement",
    "batch_spec",
    "build_interleaved_1f1b_schedule",
    "initialize_from_env",
    "logical_to_spec",
    "pipeline_apply",
    "pipeline_value_and_grad_1f1b",
    "pipeline_value_and_grad_gpipe",
    "pipeline_value_and_grad_interleaved_1f1b",
    "rank_device",
    "reinitialize_after_repair",
    "shard_batch",
    "slice_mesh_axes",
    "stack_stages",
]
