"""The flagship transformer (dense or Mixture-of-Experts), its decode and
training paths (one process or a mesh), checkpoint and restore of its train
state (whole or per shard), and conversion of weights and optimizer state
from the JAX package's trees and onto a mesh."""
from .checkpoint import (
    latest_step,
    logit_fingerprint,
    make_checkpoint_hook,
    make_restore_hook,
    restore_train_state,
    save_train_state,
    state_checksum,
)
from .convert import gather_params, gather_tree, opt_state_from_numpy, params_from_numpy, shard_params, shard_tree
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
    param_placements,
    param_specs,
    train_state_placements,
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
    "gather_params",
    "gather_tree",
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
    "param_placements",
    "param_specs",
    "params_from_numpy",
    "prefill",
    "restore_train_state",
    "route_indices",
    "routing_stats",
    "save_train_state",
    "shard_params",
    "shard_tree",
    "state_checksum",
    "train_state_placements",
    "value_and_grad",
]
