"""The flagship transformer, its decode and training paths, checkpoint and
restore of its train state, and conversion of weights and optimizer state
from the JAX package's trees."""
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
    "latest_step",
    "logit_fingerprint",
    "loss_fn",
    "make_checkpoint_hook",
    "make_restore_hook",
    "make_train_step",
    "next_token_ce",
    "opt_state_from_numpy",
    "params_from_numpy",
    "prefill",
    "restore_train_state",
    "save_train_state",
    "state_checksum",
]
