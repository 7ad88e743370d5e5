"""Device resolution for the port (the counterpart of tpu/detect.py).

Entry points take ``device=`` and default to the card. Asking for CUDA
where there is none raises: the port never drops to the CPU on its own.
The CPU runs only when the caller names it, as the tests do.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]

# the kernels are compiled for sm_90a only (ops/_build.py)
HOPPER_CAPABILITY = (9, 0)


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but CUDA is not available; pass "
            "device='cpu' to run the port's plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: the port runs on cuda or cpu")
    return dev


def hopper_present(device: DeviceLike = "cuda") -> bool:
    """True iff `device` is a CUDA device of compute capability 9.0 (H100,
    H200): the only cards the port's kernels are built for."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(dev) == HOPPER_CAPABILITY


def require_hopper(device: DeviceLike) -> None:
    if not hopper_present(device):
        raise RuntimeError(
            f"the port's CUDA kernels are built for sm_90a; device {device} "
            "is not a Hopper card (compute capability 9.0)"
        )
