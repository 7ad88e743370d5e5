"""Tensor ops of the port: plain PyTorch norms, rotary embeddings and
f32-output products, and flash attention through a hand-written Hopper
kernel."""
from .attention import flash_attention, flash_attention_plain, mha_reference
from .matmul import matmul_f32
from .norms import rms_norm
from .rotary import apply_rope, rope_freqs

__all__ = [
    "apply_rope",
    "flash_attention",
    "flash_attention_plain",
    "matmul_f32",
    "mha_reference",
    "rms_norm",
    "rope_freqs",
]
