"""What each rank of the port's sharded-step and sharded-checkpoint tests runs
(tests/torch_dist.py spawns the ranks). Imports no jax: inputs arrive as
numpy arrays made in the test process, and results go back as numpy
arrays and digests.
"""
import functools
import os

import numpy as np
import torch
import torch.distributed as dist

from odh_kubeflow_tpu_torch.models import (adamw, gather_params, gather_tree, make_checkpoint_hook,
                                           make_restore_hook, make_train_step, param_placements,
                                           params_from_numpy, restore_train_state, save_train_state,
                                           shard_params, state_checksum, train_state_placements, transformer,
                                           value_and_grad)
from odh_kubeflow_tpu_torch.models.convert import placement_at
from odh_kubeflow_tpu_torch.models.tree import tree_leaves, tree_map, tree_unflatten
from odh_kubeflow_tpu_torch.ops import attention
from odh_kubeflow_tpu_torch.parallel import MeshPlan, comm, shard_batch
from torch_sp_cases import counting_plain


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, prefix + (k,))]
    return [prefix]


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _numpy(tree):
    return tree_map(lambda t: t.detach().float().cpu().numpy(), tree)


def _params(params, cfg, mesh):
    """This rank's blocks of global numpy params, in the model's dtype."""
    full = tree_map(lambda t: t.to(cfg.dtype), params_from_numpy(params, cfg.dtype, device=mesh.device))
    return shard_params(full, cfg, mesh)


def shard_case(rank, world, params, cfg, plan):
    """This rank's shard_params blocks, and the global tree gather_params
    joins from them (rank 0)."""
    mesh = MeshPlan(**plan).build("cpu")
    local = _params(params, cfg, mesh)
    out = {"coords": mesh.coords, "blocks": _numpy(local)}
    gathered = gather_params(local, cfg, mesh)
    if rank == 0:
        out["gathered"] = _numpy(gathered)
    return out


def _replicas(tree, placements, mesh):
    """{leaf path: (the rank's coordinates on the axes that cut the leaf,
    the digest of its block)}: ranks with equal coordinates hold one block."""
    out = {}
    for path in _paths(tree):
        cut = placement_at(placements, path).axes()
        out["/".join(path)] = (tuple(mesh.coords[a] for a in cut),
                               state_checksum({"x": _at(tree, path)}))
    return out


def model_case(rank, world, params, batch, cfg, plan, use_kernel, train_step=False, device="cpu"):
    """The sharded loss and gradients (gathered, rank 0) on this rank's
    shard of a global batch over MeshPlan(**plan), the plain forward,
    dq and dk/dv calls, the exchanges by kind, and with train_step one
    make_train_step step: its loss, the gathered params (rank 0) and each
    param block's digest for the replica check."""
    mesh = MeshPlan(**plan).build(device)
    local = _params(params, cfg, mesh)
    lbatch = shard_batch(mesh, batch)
    saved = (transformer.ring_attention, transformer.ring_attention_zigzag)
    if use_kernel is not None:
        transformer.ring_attention = functools.partial(saved[0], use_kernel=use_kernel)
        transformer.ring_attention_zigzag = functools.partial(saved[1], use_kernel=use_kernel)
    try:
        comm.reset_exchange_counts()
        attention.reset_launch_counts()
        with counting_plain() as counts:
            loss, grads = value_and_grad(local, lbatch, cfg, mesh)
        exchanges = dict(comm.exchange_counts)
        gtree = gather_params(tree_unflatten(local, grads), cfg, mesh)
        out = {"loss": float(loss), "launches": dict(counts), "exchanges": exchanges,
               "kernel_launches": dict(attention.launch_counts),
               "grad_replicas": _replicas(tree_unflatten(local, grads), param_placements(cfg, mesh), mesh)}
        if rank == 0:
            out["grads"] = [g.float().cpu().numpy() for g in tree_leaves(gtree)]
        if train_step:
            step, opt = make_train_step(cfg, mesh=mesh)
            state = opt.init(local)
            local, state, step_loss = step(local, state, lbatch)
            out["step_loss"] = float(step_loss)
            out["replicas"] = _replicas({"params": local, "opt_state": state},
                                        train_state_placements(cfg, mesh), mesh)
            gathered = gather_params(local, cfg, mesh)
            if rank == 0:
                out["params"] = _numpy(gathered)
    finally:
        transformer.ring_attention, transformer.ring_attention_zigzag = saved
    return out


def concurrent_hooks_case(rank, world, directory, trials, steps):
    """Queue 3 entry 4: every rank drives make_checkpoint_hook (no mesh:
    each rank holds the one replicated state) at the same step into one
    directory, `trials` times (a barrier before each, so they race), then
    each saves steps 0..steps-1 into another directory with max_to_keep 3
    without a barrier. Returns the acks, the restored state's checksum and
    the latest steps; any exception fails the rank."""
    state = {"w": torch.arange(64.0).reshape(8, 8), "count": torch.tensor(7, dtype=torch.int32),
             "b": {"bias": torch.ones(5, dtype=torch.bfloat16)}}
    acks = []
    for t in range(trials):
        d = os.path.join(directory, f"trial-{t}")
        dist.barrier()
        acks.append(make_checkpoint_hook(d, lambda: (7, state))())
    dist.barrier()
    restored = [state_checksum(restore_train_state(os.path.join(directory, f"trial-{t}"), state))
                for t in range(trials)]
    run = os.path.join(directory, "run")
    for s in range(steps):
        save_train_state(run, s, dict(state, count=torch.tensor(s, dtype=torch.int32)), max_to_keep=3)
    dist.barrier()
    return {"acks": acks, "restored": restored, "want": state_checksum(state),
            "listing": sorted(n for n in os.listdir(run) if not n.startswith(".lock"))}


def _state(params, cfg, mesh, seed=None):
    """This rank's train state: the blocks of global numpy params, or of a
    fresh port init from `seed`, and AdamW's state of them."""
    if seed is not None:
        full = transformer.init_params(torch.Generator().manual_seed(seed), cfg, device=mesh.device)
        local = shard_params(full, cfg, mesh)
    else:
        local = _params(params, cfg, mesh)
    return {"params": local, "opt_state": adamw().init(local)}


def sharded_hooks_case(rank, world, directory, params, batch, cfg, plan):
    """Every rank of a sharded mesh drives its checkpoint hook (its blocks,
    train_state_placements) at one step, together; then its restore hook
    onto a fresh init from another seed. Returns the acks, the global
    checksum of the gathered state, each rank's bytes on disk and the
    restored state's digest of its blocks against the saved blocks'."""
    mesh = MeshPlan(**plan).build("cpu")
    pl = train_state_placements(cfg, mesh)
    state = _state(params, cfg, mesh)
    step, _ = make_train_step(cfg, mesh=mesh)
    step(state["params"], state["opt_state"], shard_batch(mesh, batch))
    gathered = gather_tree(state, pl, mesh)
    dist.barrier()
    ack = make_checkpoint_hook(directory, lambda: (1, state), mesh=mesh, placements=pl)()
    dist.barrier()
    fresh = _state(params, cfg, mesh, seed=42)
    restored_ack = make_restore_hook(directory, lambda: fresh, mesh=mesh, placements=pl)()
    restored = restore_train_state(directory, fresh, mesh=mesh, placements=pl)
    return {"ack": ack, "restored_ack": restored_ack, "global": state_checksum(gathered),
            "same_blocks": state_checksum(restored) == state_checksum(state)}


def resume_case(rank, world, directory, params, batch, cfg, plan, other_plan=None):
    """tests/test_checkpoint.py::test_save_restore_resume_exact over a mesh:
    two steps, save (every rank, sharded), one more step; a fresh seed-42
    init restored with mesh= takes the same step. Returns both losses, and
    the saved global state's checksum. With other_plan, the step is then
    restored onto that mesh of the same world too, and that mesh's gathered
    params' checksum returned."""
    mesh = MeshPlan(**plan).build("cpu")
    pl = train_state_placements(cfg, mesh)
    step_fn, _ = make_train_step(cfg, mesh=mesh)
    lbatch = shard_batch(mesh, batch)
    state = _state(params, cfg, mesh)
    for _ in range(2):
        step_fn(state["params"], state["opt_state"], lbatch)
    checksum = save_train_state(directory, 2, state, mesh=mesh, placements=pl)
    _, _, ref_loss = step_fn(state["params"], state["opt_state"], lbatch)
    fresh = _state(params, cfg, mesh, seed=42)
    restored = restore_train_state(directory, fresh, step=2, mesh=mesh, placements=pl)
    count = int(restored["opt_state"]["count"])
    _, _, resumed = step_fn(restored["params"], restored["opt_state"], lbatch)
    out = {"ref_loss": float(ref_loss), "resumed_loss": float(resumed), "checksum": checksum,
           "count": count}
    if other_plan is not None:
        other = MeshPlan(**other_plan).build("cpu")
        opl = train_state_placements(cfg, other)
        moved = restore_train_state(directory, _state(params, cfg, other, seed=43), step=2, mesh=other,
                                    placements=opl)
        out["other"] = state_checksum(gather_tree(moved, opl, other))
    return out


def replicated_save_case(rank, world, directory, params, cfg, plan):
    """An sp mesh (params replicated) saves its state per shard, every rank
    driving the hook; returns the acks and the state's checksum."""
    mesh = MeshPlan(**plan).build("cpu")
    state = _state(params, cfg, mesh)
    ack = make_checkpoint_hook(directory, lambda: (3, state), mesh=mesh)()
    return {"ack": ack, "checksum": state_checksum(state)}


def restore_case(rank, world, directory, params, cfg, plan):
    """Restores the latest step onto this rank's blocks over a mesh
    (train_state_placements) of a fresh init; the checksum of the gathered
    restored state."""
    mesh = MeshPlan(**plan).build("cpu")
    pl = train_state_placements(cfg, mesh)
    restored = restore_train_state(directory, _state(params, cfg, mesh, seed=5), mesh=mesh, placements=pl)
    return {"checksum": state_checksum(gather_tree(restored, pl, mesh))}


def replicated_restore_case(rank, world, directory, params, cfg, plan):
    """Restores a step onto an sp mesh (params replicated): the checksum
    of the rank's whole restored state."""
    mesh = MeshPlan(**plan).build("cpu")
    like = _state(params, cfg, mesh, seed=5)
    restored = restore_train_state(directory, like, mesh=mesh)
    return {"checksum": state_checksum(restored),
            "device": str(restored["opt_state"]["count"].device)}


def comm_case(rank, world, device):
    """Each collective of parallel.comm over the tp group of a tp=world mesh
    (ranks sharing the card on gloo: staged through pinned host memory),
    on tensors on `device` made from the same seeded numbers, and the
    autograd Functions' forward and backward; returns numpy results and
    the staged transport's host waits."""
    mesh = MeshPlan(tp=world).build(device)
    group = mesh.group("tp")[0]
    rng = np.random.default_rng(rank)

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(mesh.device, dtype)

    comm.reset_exchange_counts()
    out = {"sum": [x.cpu().numpy() for x in comm.all_reduce_sum([t(3, 5), t(7, dtype=torch.bfloat16)], group)],
           "max": comm.all_reduce_max(t(4, 6), group).cpu().numpy(),
           "gather0": comm.all_gather(t(2, 3), group, 0).cpu().numpy(),
           "gather2": comm.all_gather(t(2, 3, 4, dtype=torch.bfloat16), group, 2).float().cpu().numpy(),
           "scatter0": comm.reduce_scatter(t(2 * world, 3), group, 0).cpu().numpy(),
           "scatter1": comm.reduce_scatter(t(3, 2 * world, dtype=torch.bfloat16), group, 1).cpu().numpy()}
    x = t(2, 4).requires_grad_()
    y = comm.tp_enter(x, group)
    (y * t(2, 4)).sum().backward()
    out["enter"] = (y.detach().cpu().numpy(), x.grad.cpu().numpy())
    x = t(2, 4).requires_grad_()
    y = comm.tp_sum(x, group)
    (y * t(2, 4)).sum().backward()
    out["tp_sum"] = (y.detach().cpu().numpy(), x.grad.cpu().numpy())
    x = t(3, 2).requires_grad_()
    y = comm.gather_shards(x, group, 1)
    (y * t(3, 2 * world)).sum().backward()
    out["gather_shards"] = (y.detach().cpu().numpy(), x.grad.cpu().numpy())
    out["host_waits"] = comm.exchange_counts["host_waits"]
    return out


def sharded_step_case(rank, world, params, tokens, cfg, plan, device):
    """value_and_grad and one make_train_step step over MeshPlan(**plan) on
    `device`: the loss, the gathered gradients (rank 0), the step's kernel
    launches and the replica digests of the state after it."""
    mesh = MeshPlan(**plan).build(device)
    local = _params(params, cfg, mesh)
    lbatch = shard_batch(mesh, {"tokens": tokens})
    loss, grads = value_and_grad(local, lbatch, cfg, mesh)
    gtree = gather_params(tree_unflatten(local, grads), cfg, mesh)
    out = {"loss": float(loss)}
    if rank == 0:
        out["grads"] = [g.float().cpu().numpy() for g in tree_leaves(gtree)]
    step, opt = make_train_step(cfg, mesh=mesh)
    state = opt.init(local)
    attention.reset_launch_counts()
    local, state, _ = step(local, state, lbatch)
    out["kernel_launches"] = dict(attention.launch_counts)
    out["replicas"] = _replicas({"params": local, "opt_state": state}, train_state_placements(cfg, mesh), mesh)
    return out
