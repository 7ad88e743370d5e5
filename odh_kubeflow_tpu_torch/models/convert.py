"""Weights and optimizer state from the JAX package's trees into the port.

The tree is nested dicts of arrays (jax arrays or numpy, as `init_params`
or a checkpoint restore gives them). Every leaf goes through numpy; bf16
leaves (ml_dtypes arrays, which `torch.from_numpy` refuses) go through f32,
which holds every bf16 value exactly.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .transformer import resolve_dtype


def params_from_numpy(tree: Any, dtype: Any, device: DeviceLike = "cuda") -> Any:
    """The same tree with every leaf a tensor on `device`: an f32 leaf
    stays f32 (the MoE router, which the JAX package keeps in f32 inside a
    bf16 model), every other leaf takes `dtype`. A tree made in `dtype`
    thus keeps each leaf's dtype."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)

    def convert(node):
        if isinstance(node, dict):
            return {name: convert(child) for name, child in node.items()}
        arr = np.asarray(node)
        leaf_dt = torch.float32 if arr.dtype == np.float32 else dt
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        # np.array copies: jax hands out read-only views torch would alias
        return torch.from_numpy(np.array(arr)).to(device=dev, dtype=leaf_dt)

    return convert(tree)


def opt_state_from_numpy(adam_state: Any, dtype: Any, device: DeviceLike = "cuda") -> dict:
    """The port's AdamW state (models/optim.py) from optax's
    `ScaleByAdamState` (`count`, `mu`, `nu`; jax or numpy arrays), the first
    element of the reference's `optax.adamw(..., mu_dtype=f32)` state: mu
    in f32, nu in each param's own dtype (`dtype`, f32 for the router), as
    optax keeps them."""
    dev = resolve_device(device)
    return {
        "count": torch.tensor(int(np.asarray(adam_state.count)), dtype=torch.int32, device=dev),
        "mu": params_from_numpy(adam_state.mu, torch.float32, device=dev),
        "nu": params_from_numpy(adam_state.nu, dtype, device=dev),
    }
