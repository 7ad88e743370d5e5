"""Device resolution and detection for the port (the counterpart of
tpu/detect.py).

Entry points take ``device=`` and default to the card. Asking for CUDA
where there is none raises: the port never drops to the CPU on its own.
The CPU runs only when the caller names it, as the tests do.

Detection is positive evidence, as in the reference: `accelerator_present`
is True only when a CUDA device is visible, never raises, and carries the
reason when it is False, so a caller can record why a hardware section was
skipped. `hopper_present` plays the part of the reference's `tpu_like`: the
test that the port's kernels can run on the card.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

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


def probe_devices() -> Tuple[List[torch.device], Optional[str]]:
    """(CUDA devices, error reason). Never raises: an empty list and the
    reason where there is no card. The CPU is never listed."""
    try:
        if not torch.cuda.is_available():
            return [], f"CUDA is not available (torch {torch.__version__}, built for CUDA {torch.version.cuda})"
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())], None
    except Exception as e:  # a broken CUDA install reads as no device, with its reason
        return [], f"CUDA device query failed: {e!r}"


def accelerator_present() -> Tuple[bool, Optional[str]]:
    """(present, skip_reason): present is True iff a CUDA device is
    visible. Callers record skip_reason where present is False."""
    devices, err = probe_devices()
    if err is not None:
        return False, err
    if not devices:
        return False, "no CUDA device visible"
    return True, None


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
