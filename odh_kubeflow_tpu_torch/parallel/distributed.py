"""Multi-process bring-up from the env the webhook injects (counterpart of
odh_kubeflow_tpu/parallel/distributed.py).

The operator's webhook gives every pod of a slice the same env names
whichever runtime the image holds: JAX_NUM_PROCESSES, JAX_PROCESS_ID (or
TPU_WORKER_ID, from the pod ordinal) and JAX_COORDINATOR_ADDRESS (or the
host roster TPU_WORKER_HOSTNAMES, whose first host is the coordinator on
COORDINATOR_PORT). Here they bring up a `torch.distributed` process group
instead of `jax.distributed`: the coordinator address is the TCP rendezvous
of `init_process_group`.

The backend is the caller's: "nccl" for ranks on CUDA devices of their own,
"gloo" for the CPU, and "gloo" too for several ranks sharing one card,
which NCCL refuses. Nothing switches backends on a failure.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

# the reference's coordinator port (odh_kubeflow_tpu/tpu/env.py:16)
COORDINATOR_PORT = 8476
# the env names the webhook injects (odh_kubeflow_tpu/tpu/env.py:58-78)
ENV_NUM_PROCESSES = "JAX_NUM_PROCESSES"
ENV_PROCESS_ID = "JAX_PROCESS_ID"
ENV_WORKER_ID = "TPU_WORKER_ID"
ENV_COORDINATOR = "JAX_COORDINATOR_ADDRESS"
ENV_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"


def default_backend(device: DeviceLike = "cuda") -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device: DeviceLike = "cuda") -> torch.device:
    """This process's device: the CPU when the caller names it (or a card
    by index), else cuda:(process id mod the visible cards): the card of
    its own where a host holds as many ranks as cards, the one card where
    ranks share it."""
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return dev
    process_id = os.environ.get(ENV_PROCESS_ID, os.environ.get(ENV_WORKER_ID, "0")) or "0"
    return torch.device("cuda", int(process_id) % torch.cuda.device_count())


def initialize_from_env(timeout_s: Optional[float] = None, backend: Optional[str] = None,
                        device: DeviceLike = "cuda") -> Tuple[int, int]:
    """Initialize torch.distributed from the webhook-injected env; a no-op
    returning (0, 1) on one process. Returns (process_id, num_processes).
    Idempotent: a live group is returned as it is. `backend` defaults to
    "nccl" for a CUDA `device` and "gloo" for the CPU; with nccl the
    rank's card (rank_device) becomes the current device."""
    num_processes = int(os.environ.get(ENV_NUM_PROCESSES, "1") or 1)
    if num_processes <= 1:
        return 0, 1
    process_id = int(
        os.environ.get(ENV_PROCESS_ID, os.environ.get(ENV_WORKER_ID, "0")) or 0
    )
    coordinator = os.environ.get(ENV_COORDINATOR, "")
    if not coordinator:
        hosts = os.environ.get(ENV_WORKER_HOSTNAMES, "").split(",")
        if not hosts or not hosts[0]:
            raise RuntimeError(
                "multi-host slice but neither JAX_COORDINATOR_ADDRESS nor "
                "TPU_WORKER_HOSTNAMES set (webhook env injection missing?)"
            )
        coordinator = f"{hosts[0]}:{COORDINATOR_PORT}"

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    backend = backend or default_backend(device)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device))
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id, **kwargs,
    )
    return process_id, num_processes


def reinitialize_after_repair(timeout_s: Optional[float] = None, backend: Optional[str] = None,
                              device: DeviceLike = "cuda") -> Tuple[int, int]:
    """Bring-up again after a slice repair: a live process group (a
    surviving process whose peers were replaced) is destroyed first, then
    initialize_from_env re-reads the env. Pairs with
    models.restore_train_state, as in the reference."""
    if dist.is_initialized():
        dist.destroy_process_group()
    return initialize_from_env(timeout_s=timeout_s, backend=backend, device=device)
