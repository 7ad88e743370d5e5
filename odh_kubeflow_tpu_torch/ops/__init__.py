"""Tensor ops of the port: plain PyTorch norms and rotary embeddings, and
flash attention through a hand-written Hopper kernel."""
from .attention import flash_attention, flash_attention_plain, mha_reference
from .norms import rms_norm
from .rotary import apply_rope, rope_freqs

__all__ = [
    "apply_rope",
    "flash_attention",
    "flash_attention_plain",
    "mha_reference",
    "rms_norm",
    "rope_freqs",
]
