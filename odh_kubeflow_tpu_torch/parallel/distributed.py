"""Multi-process bring-up from the pod's env (counterpart of
odh_kubeflow_tpu/parallel/distributed.py).

Two sets of names bring a world up, and torchrun's win where both are set:

- torchrun's worker env. A GPU pod's env (gpu/env.py) makes a plain
  `torchrun script.py` start one process per card, and torchrun gives each
  WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR and MASTER_PORT: the group
  forms through `init_method="env://"`, and LOCAL_RANK picks the card.
- The reference's names, which the operator's webhook injects into a TPU
  slice's pods whichever runtime the image holds: JAX_NUM_PROCESSES,
  JAX_PROCESS_ID (or TPU_WORKER_ID, from the pod ordinal) and
  JAX_COORDINATOR_ADDRESS (or the host roster TPU_WORKER_HOSTNAMES, whose
  first host is the coordinator on COORDINATOR_PORT): one process per
  host, the coordinator address the TCP rendezvous of `init_process_group`.

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
from ..gpu.env import COORDINATOR_PORT
from ..gpu.topology import SliceShape

# the env names the webhook injects (odh_kubeflow_tpu/tpu/env.py:58-78)
ENV_NUM_PROCESSES = "JAX_NUM_PROCESSES"
ENV_PROCESS_ID = "JAX_PROCESS_ID"
ENV_WORKER_ID = "TPU_WORKER_ID"
ENV_COORDINATOR = "JAX_COORDINATOR_ADDRESS"
ENV_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"


def default_backend(device: DeviceLike = "cuda") -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _coordinator() -> str:
    """host:port of the webhook's coordinator: JAX_COORDINATOR_ADDRESS, else
    the roster's first host on COORDINATOR_PORT."""
    coordinator = os.environ.get(ENV_COORDINATOR, "")
    if coordinator:
        return coordinator
    hosts = os.environ.get(ENV_WORKER_HOSTNAMES, "").split(",")
    if not hosts or not hosts[0]:
        raise RuntimeError(
            "multi-host slice but neither JAX_COORDINATOR_ADDRESS nor "
            "TPU_WORKER_HOSTNAMES set (webhook env injection missing?)"
        )
    return f"{hosts[0]}:{COORDINATOR_PORT}"


def rank_device(device: DeviceLike = "cuda") -> torch.device:
    """This process's device: the CPU when the caller names it (or a card
    by index); under torchrun (LOCAL_RANK set) cuda:(LOCAL_RANK mod the
    visible cards), each local rank its own card; else cuda:(process id mod
    the visible cards), the reference's one process per host. Where ranks
    outnumber the cards they share them."""
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    if local:
        return torch.device("cuda", int(local) % torch.cuda.device_count())
    process_id = os.environ.get(ENV_PROCESS_ID, os.environ.get(ENV_WORKER_ID, "0")) or "0"
    return torch.device("cuda", int(process_id) % torch.cuda.device_count())


def initialize_from_env(timeout_s: Optional[float] = None, backend: Optional[str] = None,
                        device: DeviceLike = "cuda") -> Tuple[int, int]:
    """Initialize torch.distributed from the pod's env (the module
    docstring: torchrun's worker env first, else the webhook's names); a
    no-op returning (0, 1) on one process. Returns (rank, world size).
    Idempotent: a live group is returned as it is. `backend` defaults to
    "nccl" for a CUDA `device` and "gloo" for the CPU; with nccl the
    rank's card (rank_device) becomes the current device."""
    if os.environ.get("WORLD_SIZE"):  # a torchrun worker; env:// reads the rest
        num_processes, init_method = int(os.environ["WORLD_SIZE"]), "env://"
        process_id = int(os.environ.get("RANK", "0") or 0)
    else:
        num_processes = int(os.environ.get(ENV_NUM_PROCESSES, "1") or 1)
        process_id = int(os.environ.get(ENV_PROCESS_ID, os.environ.get(ENV_WORKER_ID, "0")) or 0)
        init_method = ""
    if num_processes <= 1:
        return 0, 1
    init_method = init_method or "tcp://" + _coordinator()
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    backend = backend or default_backend(device)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device))
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend=backend, init_method=init_method,
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


def slice_mesh_axes(shape: SliceShape, want_sp: int = 1, want_tp: int = 0):
    """MeshPlan for a whole slice (the reference's slice_mesh_axes): tp
    defaults to the cards of one host, sp is as asked, and fsdp gets the
    rest. tp is the innermost axis after sp, and torchrun numbers a host's
    ranks consecutively, so at sp 1 each tp group is one host's cards, on
    NVSwitch."""
    from .mesh import MeshPlan

    return MeshPlan.auto(shape.chips, want_sp=want_sp, want_tp=want_tp or shape.chips_per_host)
