"""The flagship transformer, its decode path, and weight conversion from
the JAX package's tree."""
from .convert import params_from_numpy
from .decode import KVCache, decode_step, generate, init_cache, prefill
from .transformer import TransformerConfig, forward, init_params

__all__ = [
    "KVCache",
    "TransformerConfig",
    "decode_step",
    "forward",
    "generate",
    "init_cache",
    "init_params",
    "params_from_numpy",
    "prefill",
]
