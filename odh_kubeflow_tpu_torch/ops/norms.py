"""Normalization ops (counterpart of odh_kubeflow_tpu/ops/norms.py).

Plain PyTorch: RMSNorm is a short elementwise+reduce chain. Accumulation is
f32 whatever the activation dtype.
"""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis; returns x's dtype, computes in f32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
