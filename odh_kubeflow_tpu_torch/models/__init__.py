"""The flagship transformer (dense or Mixture-of-Experts), its decode and
training paths, checkpoint and restore of its train state, and conversion
of weights and optimizer state from the JAX package's trees."""
from .checkpoint import (
    latest_step,
    logit_fingerprint,
    make_checkpoint_hook,
    make_restore_hook,
    restore_train_state,
    save_train_state,
    state_checksum,
)
from .convert import opt_state_from_numpy, params_from_numpy
from .decode import KVCache, decode_step, generate, init_cache, prefill
from .moe import MoEConfig, dispatch_only, moe_ffn, route_indices, routing_stats
from .optim import adamw
from .transformer import (
    TransformerConfig,
    causal_ce,
    forward,
    init_params,
    loss_fn,
    make_train_step,
    make_zigzag_batch,
    next_token_ce,
    value_and_grad,
)

__all__ = [
    "KVCache",
    "MoEConfig",
    "TransformerConfig",
    "adamw",
    "causal_ce",
    "decode_step",
    "dispatch_only",
    "forward",
    "generate",
    "init_cache",
    "init_params",
    "latest_step",
    "logit_fingerprint",
    "loss_fn",
    "make_checkpoint_hook",
    "make_restore_hook",
    "make_train_step",
    "make_zigzag_batch",
    "moe_ffn",
    "next_token_ce",
    "opt_state_from_numpy",
    "params_from_numpy",
    "prefill",
    "restore_train_state",
    "route_indices",
    "routing_stats",
    "save_train_state",
    "state_checksum",
    "value_and_grad",
]
