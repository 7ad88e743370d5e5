"""Rotary position embeddings (counterpart of odh_kubeflow_tpu/ops/rotary.py).

Interleaved convention: pairs (x[2i], x[2i+1]) rotate together, not the
half-split pairs (x[i], x[i + d/2]) many PyTorch codebases use. Takes
explicit absolute positions.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device: torch.device | str | None = None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), f32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotate x (..., seq, heads, head_dim) by absolute `positions` (..., seq).

    Pairs (x[2i], x[2i+1]) are rotated by positions * freq_i; computed in f32,
    returned in x's dtype.
    """
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions.float()[..., None] * freqs  # (..., seq, d/2)
    angles = angles[..., None, :]  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack((x1 * cos - x2 * sin, x1 * sin + x2 * cos), dim=-1)
    return out.reshape(x.shape).to(x.dtype)
