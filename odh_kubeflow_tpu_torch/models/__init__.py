"""The flagship transformer, its decode and training paths, and conversion
of weights and optimizer state from the JAX package's trees."""
from .convert import opt_state_from_numpy, params_from_numpy
from .decode import KVCache, decode_step, generate, init_cache, prefill
from .optim import adamw
from .transformer import (
    TransformerConfig,
    causal_ce,
    forward,
    init_params,
    loss_fn,
    make_train_step,
    next_token_ce,
)

__all__ = [
    "KVCache",
    "TransformerConfig",
    "adamw",
    "causal_ce",
    "decode_step",
    "forward",
    "generate",
    "init_cache",
    "init_params",
    "loss_fn",
    "make_train_step",
    "next_token_ce",
    "opt_state_from_numpy",
    "params_from_numpy",
    "prefill",
]
