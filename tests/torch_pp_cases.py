"""What each rank of the port's pipeline tests runs (tests/torch_dist.py
spawns the ranks). Imports no jax: inputs arrive as numpy arrays made in the
test process, and results go back as numpy arrays and digests.
"""
import warnings

import numpy as np
import torch

from odh_kubeflow_tpu_torch.models import (adamw, gather_params, gather_tree, generate, make_pp_train_step,
                                           params_from_numpy, pp_1f1b_value_and_grad, pp_loss_fn,
                                           pp_train_state_placements, pp_value_and_grad, restore_train_state,
                                           save_train_state, shard_params, state_checksum, to_pp_params,
                                           transformer, value_and_grad)
from odh_kubeflow_tpu_torch.models.tree import tree_map, tree_unflatten
from odh_kubeflow_tpu_torch.parallel import MeshPlan, comm, pipeline, shard_batch
from odh_kubeflow_tpu_torch.parallel.interleaved_1f1b import pipeline_value_and_grad_interleaved_1f1b
from torch_shard_cases import _replicas
from torch_sp_cases import counting_plain


def _numpy(tree):
    return tree_map(lambda t: t.detach().float().cpu().numpy(), tree)


def _pp_params(params, cfg, mesh, n_chunks):
    """This rank's blocks of the pipeline layout of global numpy params."""
    full = tree_map(lambda t: t.to(cfg.dtype), params_from_numpy(params, cfg.dtype, device=mesh.device))
    return shard_params(to_pp_params(full, mesh.sizes["pp"], cfg, mesh, n_chunks), cfg, mesh)


def model_case(rank, world, params, batch, cfg, plan, runs, train_step=()):
    """Each run (name, schedule, n_chunks, n_micro) of the pipeline over
    MeshPlan(**plan): the loss, the gathered gradients in the pipeline
    layout (rank 0), the plain flash calls, the exchanges by kind and each
    gradient block's digest; for the runs named in train_step one
    make_pp_train_step step: its loss, the gathered params (rank 0) and
    the replica digests of the train state."""
    mesh = MeshPlan(**plan).build("cpu")
    lbatch = shard_batch(mesh, batch)
    out = {"coords": mesh.coords}
    for name, schedule, n_chunks, n_micro in runs:
        local = _pp_params(params, cfg, mesh, n_chunks)
        vg = pp_1f1b_value_and_grad if schedule == "1f1b" else pp_value_and_grad
        comm.reset_exchange_counts()
        with counting_plain() as counts:
            loss, grads = vg(local, lbatch, cfg, mesh, n_micro, n_chunks)
        exchanges = dict(comm.exchange_counts)
        gtree = gather_params(tree_unflatten(local, grads), cfg, mesh)
        res = {"loss": float(loss), "launches": dict(counts), "exchanges": exchanges,
               "grad_replicas": _replicas(tree_unflatten(local, grads),
                                          transformer.pp_param_placements(cfg, mesh, n_chunks), mesh)}
        if schedule == "gpipe":
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res["pp_loss"] = float(pp_loss_fn(local, lbatch, cfg, mesh, n_micro, n_chunks))
            res["sp_warned"] = any("per-shard" in str(w.message) for w in caught)
        if rank == 0:
            res["grads"] = _numpy(gtree)
        if name in train_step:
            step, opt = make_pp_train_step(cfg, mesh, n_micro, schedule=schedule, n_chunks=n_chunks)
            state = opt.init(local)
            local, state, step_loss = step(local, state, lbatch)
            res["step_loss"] = float(step_loss)
            res["replicas"] = _replicas({"params": local, "opt_state": state},
                                        pp_train_state_placements(cfg, mesh, n_chunks), mesh)
            gathered = gather_params(local, cfg, mesh)
            if rank == 0:
                res["params"] = _numpy(gathered)
        out[name] = res
    return out


def _steps(step_fn, state, batch, n):
    loss = None
    for _ in range(n):
        _, _, loss = step_fn(state["params"], state["opt_state"], batch)
    return loss


def checkpoint_case(rank, world, directory, params, batch, cfg, plan, n_micro, schedule):
    """tests/test_checkpoint.py::test_pp_sharded_state_save_restore over
    gloo ranks: the pipeline train state's blocks (params in the stage
    layout, AdamW's state as them) save per shard from every rank after
    two steps; a third step is the reference; a fresh seed-42 state
    restored onto the same mesh takes the same step. Returns the initial
    params' global checksum, the saved state's (the ack's and the gathered
    state's), the losses, and whether the restored blocks and the resumed
    step's blocks are bit-equal to the saved and the uninterrupted ones."""
    mesh = MeshPlan(**plan).build("cpu")
    pl = pp_train_state_placements(cfg, mesh)
    local = _pp_params(params, cfg, mesh, 1)
    state = {"params": local, "opt_state": adamw().init(local)}
    out = {"init": state_checksum({"params": gather_params(local, cfg, mesh)})}
    step_fn, _ = make_pp_train_step(cfg, mesh, n_micro, schedule=schedule)
    lbatch = shard_batch(mesh, batch)
    _steps(step_fn, state, lbatch, 2)
    out["saved"] = save_train_state(directory, 2, state, mesh=mesh, placements=pl)
    out["gathered"] = state_checksum(gather_tree(state, pl, mesh))
    saved_blocks = state_checksum(state)
    out["ref_loss"] = float(_steps(step_fn, state, lbatch, 1))
    fresh_full = transformer.init_params(torch.Generator().manual_seed(42), cfg, device="cpu")
    fresh = shard_params(to_pp_params(fresh_full, mesh.sizes["pp"], cfg, mesh), cfg, mesh)
    restored = restore_train_state(directory, {"params": fresh, "opt_state": adamw().init(fresh)}, step=2,
                                   mesh=mesh, placements=pl)
    out["same_blocks"] = state_checksum(restored) == saved_blocks
    out["count"] = int(restored["opt_state"]["count"])
    out["resumed_loss"] = float(_steps(step_fn, restored, lbatch, 1))
    out["resumed_equal"] = state_checksum(restored) == state_checksum(state)
    return out


def replicated_case(rank, world, params, batch, prompt, cfg, plan, max_new):
    """The non-pipelined entry points over a mesh with a live pp axis
    (params replicated over pp): the loss and gathered gradients of
    value_and_grad (rank 0), generate's tokens."""
    mesh = MeshPlan(**plan).build("cpu")
    full = params_from_numpy(params, cfg.dtype, device="cpu")
    local = shard_params(full, cfg, mesh)
    loss, grads = value_and_grad(local, shard_batch(mesh, batch), cfg, mesh)
    gathered = gather_params(tree_unflatten(local, grads), cfg, mesh)
    out = {"loss": float(loss), "tokens": generate(local, torch.as_tensor(prompt), cfg, max_new, mesh=mesh).numpy()}
    if rank == 0:
        out["grads"] = _numpy(gathered)
    return out


def _tanh_stage(chunk, h):
    for w in chunk["w"]:
        h = torch.tanh(h @ w)
    return h, 0.0


def tanh_case(rank, world, w, x, n_micro, n_chunks):
    """The tanh stack of tests/test_parallel.py:85 and :119 (w (L, d, d))
    over MeshPlan(pp=world): pipeline_apply's output and exchanges, and
    for each schedule the gradients of sum(y**2) by this rank's stage
    (in its storage layout) and by x (the first stage), with the
    exchanges and the most stage inputs held at once."""
    mesh = MeshPlan(pp=world).build("cpu")
    local = {"w": pipeline.stack_stages({"w": torch.as_tensor(w)}, world, n_chunks)["w"][mesh.coords["pp"]][None]}
    xt = torch.as_tensor(x)
    comm.reset_exchange_counts()
    y = pipeline.pipeline_apply(_tanh_stage, local, xt, mesh, n_micro, n_chunks=n_chunks)
    out = {"y": y.numpy(), "exchanges": dict(comm.exchange_counts)}

    def head(y):
        return float((y ** 2).sum()), 2 * y

    def loss_head(i, y):
        return (y ** 2).sum(), [2 * y]

    comm.reset_exchange_counts()
    loss, _, grads, dx = pipeline.pipeline_value_and_grad_gpipe(_tanh_stage, head, local, xt, mesh, n_micro,
                                                                n_chunks=n_chunks)
    out["gpipe"] = {"loss": loss, "grad": grads["w"][0].numpy(), "exchanges": dict(comm.exchange_counts),
                    "dx": None if dx is None else dx.numpy()}
    comm.reset_exchange_counts()
    if n_chunks > 1:
        res = pipeline_value_and_grad_interleaved_1f1b(_tanh_stage, loss_head, local, xt, mesh, n_micro, n_chunks)
    else:
        res = pipeline.pipeline_value_and_grad_1f1b(_tanh_stage, loss_head, local, xt, mesh, n_micro)
    loss, _, grads, _, dx, most = res
    out["1f1b"] = {"loss": float(dist_sum(loss, mesh)), "grad": grads["w"][0].numpy(),
                   "exchanges": dict(comm.exchange_counts), "dx": None if dx is None else dx.numpy(),
                   "most": most}
    return out


def dist_sum(t, mesh):
    return comm.all_reduce_sum([t], mesh.group("pp")[0], "pp_sum")[0]


def pp_shard_case(rank, world, params, cfg, plan, n_chunks):
    """This rank's blocks of the pipeline layout (to_pp_params, then
    shard_params), and the global tree gather_params joins from them
    (rank 0)."""
    mesh = MeshPlan(**plan).build("cpu")
    local = _pp_params(params, cfg, mesh, n_chunks)
    out = {"blocks": _numpy(local)}
    gathered = gather_params(local, cfg, mesh)
    if rank == 0:
        out["gathered"] = _numpy(gathered)
    return out
