"""GPU pod environment (counterpart of odh_kubeflow_tpu/tpu/env.py).

The reference renders the JAX/PJRT contract into each pod of a TPU slice:
one process per host, brought up by `jax.distributed.initialize()`. torch
with NCCL runs one process per card instead, and torchrun starts them: it
reads each of its arguments from a `PET_<ARG>` variable when the flag is
absent (`torch/distributed/argparse_util.py::env`), so a plain
`torchrun script.py` in the pod starts `PET_NPROC_PER_NODE` processes with
RANK = node_rank x cards + LOCAL_RANK and WORLD_SIZE = hosts x cards, and
`parallel.initialize_from_env()` in each brings the world up.

- A multi-host slice uses torchrun's static rendezvous: the ordinal-0 pod's
  headless-Service DNS on COORDINATOR_PORT (the port the headless Service
  names, as in the reference), and PET_NODE_RANK from the pod ordinal
  through the downward API (`ordinal_env`). The node rank fixes the global
  ranks, so each pod's ranks are consecutive and tp's groups stay on one
  host (`parallel.slice_mesh_axes`).
- A single-host slice needs no address, as the reference's needs no
  coordinator: PET_STANDALONE runs torchrun's own rendezvous on a free
  loopback port.

The contract names the port's probe agent and bring-up read keep the
reference's spelling (NB_TPU_HOSTS, NB_TPU_CHIPS_EXPECTED, the
TPU_WORKER_HOSTNAMES roster; TPU_ACCELERATOR_TYPE and TPU_TOPOLOGY name the
plan, `gpu.topology.slice_from_env`). No JAX_*, PJRT or JAX_PLATFORMS name
is emitted.
"""
from __future__ import annotations

from typing import Dict, List

from .topology import SliceShape

COORDINATOR_PORT = 8476  # the reference's coordinator port, on the headless Service


def pod_dns(name: str, ordinal: int, service: str, namespace: str, domain: str) -> str:
    return f"{name}-{ordinal}.{service}.{namespace}.svc.{domain}"


def gpu_env(
    shape: SliceShape,
    notebook_name: str,
    service_name: str,
    namespace: str,
    cluster_domain: str = "cluster.local",
) -> List[Dict[str, str]]:
    """Env var list (name/value dicts) for the primary container of every
    pod of the slice; the per-pod node rank comes from `ordinal_env`."""
    hostnames = ",".join(
        pod_dns(notebook_name, i, service_name, namespace, cluster_domain) for i in range(shape.hosts)
    )
    env = [
        {"name": "TPU_ACCELERATOR_TYPE", "value": shape.accelerator_type},
        {"name": "TPU_TOPOLOGY", "value": shape.topology},
        {"name": "TPU_WORKER_HOSTNAMES", "value": hostnames},
        {"name": "NB_TPU_HOSTS", "value": str(shape.hosts)},
        {"name": "NB_TPU_CHIPS_EXPECTED", "value": str(shape.chips)},
        {"name": "PET_NNODES", "value": str(shape.hosts)},
        {"name": "PET_NPROC_PER_NODE", "value": str(shape.chips_per_host)},
    ]
    if shape.multi_host:
        env += [
            {"name": "PET_MASTER_ADDR",
             "value": pod_dns(notebook_name, 0, service_name, namespace, cluster_domain)},
            {"name": "PET_MASTER_PORT", "value": str(COORDINATOR_PORT)},
        ]
    else:
        env += [{"name": "PET_STANDALONE", "value": "1"}]
    return env


def ordinal_env() -> List[Dict[str, object]]:
    """Downward-API env: the StatefulSet pod index becomes torchrun's node
    rank (the reference's field path, tpu/env.py's ordinal_env)."""
    field_ref = {"fieldRef": {"fieldPath": "metadata.labels['apps.kubernetes.io/pod-index']"}}
    return [{"name": "PET_NODE_RANK", "valueFrom": field_ref}]
