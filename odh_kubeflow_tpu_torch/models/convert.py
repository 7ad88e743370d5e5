"""Weights and optimizer state from the JAX package's trees into the port,
and onto a mesh.

The tree is nested dicts of arrays (jax arrays or numpy, as `init_params`
or a checkpoint restore gives them). Every leaf goes through numpy; bf16
leaves (ml_dtypes arrays, which `torch.from_numpy` refuses) go through f32,
which holds every bf16 value exactly.

`shard_params` cuts a global params tree into this rank's blocks, as
`device_put(p, NamedSharding(mesh, param_specs(cfg, mesh)))` places them
(`pp_param_specs` for the pipeline layout of `to_pp_params`)
(`shard_tree` does so for any tree and its placements: AdamW's state goes
as its params, its count replicated); `gather_params` joins the blocks of
every rank back into the global tree, for tests, checksums and the smoke,
never on the train step's path.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from ..parallel import comm
from ..parallel.mesh import Placement
from .transformer import param_placements, pp_chunks, pp_param_placements, resolve_dtype


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


def placement_at(placements: Any, path) -> Placement:
    """The Placement of the leaf at `path` (a tuple of keys) in a
    placements tree; a leaf the tree does not name is replicated."""
    node = placements
    for key in path:
        if not isinstance(node, dict) or key not in node:
            return Placement()
        node = node[key]
    return node if isinstance(node, Placement) else Placement()


def _walk(tree: Any, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, path + (k,)) for k, v in tree.items()}
    return path


def _box(offsets, shape):
    return tuple(slice(o, o + n) for o, n in zip(offsets, shape))


def shard_tree(tree: Any, placements: Any, mesh) -> Any:
    """This rank's block of every leaf of a global tree of tensors, on
    mesh.device (a leaf the placements do not name is copied whole)."""

    def block(path):
        t = _at(tree, path)
        pl = placement_at(placements, path)
        out = torch.empty(pl.local_shape(t.shape, mesh.sizes), dtype=t.dtype, device=mesh.device)
        for local, glob, shape in pl.pieces(t.shape, mesh.coords, mesh.sizes):
            out[_box(local, shape)] = t[_box(glob, shape)]
        return out

    return tree_of(_walk(tree), block)


def gather_tree(tree: Any, placements: Any, mesh) -> Any:
    """The global tree from every rank's blocks (a collective over the
    whole world: every rank calls it, and every rank gets the tree)."""

    def join(path):
        t = _at(tree, path)
        pl = placement_at(placements, path)
        if not pl.axes():
            return t
        blocks = comm.all_gather(t.contiguous().reshape(1, -1), dist.group.WORLD, 0, "gather")
        out = torch.empty(pl.global_shape(t.shape, mesh.sizes), dtype=t.dtype, device=t.device)
        for rank in range(mesh.world):
            local = blocks[rank].view(t.shape)
            for loc, glob, shape in pl.pieces(out.shape, mesh.coords_of(rank), mesh.sizes):
                out[_box(glob, shape)] = local[_box(loc, shape)]
        return out

    return tree_of(_walk(tree), join)


def _at(tree: Any, path):
    for key in path:
        tree = tree[key]
    return tree


def tree_of(paths: Any, fn) -> Any:
    """fn(path) at every leaf of a tree of paths."""
    if isinstance(paths, dict):
        return {k: tree_of(v, fn) for k, v in paths.items()}
    return fn(paths)


def placements_of(params: Any, cfg: Any, mesh) -> Any:
    """The placements of params in their layout: pp_param_placements for
    the pipeline layout (to_pp_params), param_placements otherwise."""
    chunks = pp_chunks(params)
    return pp_param_placements(cfg, mesh, chunks) if chunks else param_placements(cfg, mesh)


def shard_params(params: Any, cfg: Any, mesh) -> Any:
    """This rank's block of every leaf of global params, on mesh.device
    (params in the pipeline layout are cut as pp_param_placements says)."""
    return shard_tree(params, placements_of(params, cfg, mesh), mesh)


def gather_params(params: Any, cfg: Any, mesh) -> Any:
    """The global params from every rank's blocks (collective)."""
    return gather_tree(params, placements_of(params, cfg, mesh), mesh)
