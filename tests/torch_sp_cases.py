"""What each rank of the port's multi-process tests runs (tests/torch_dist.py
spawns the ranks). Imports no jax: inputs arrive as numpy arrays made in
the test process, and results go back as numpy arrays.

Forward and backward "launches" are counted on the CPU by wrapping the
flash op's plain versions, which the op's CPU kernel and the backward
wrappers call where a CUDA tensor would launch a kernel.
"""
import contextlib
import functools

import numpy as np
import torch

from odh_kubeflow_tpu_torch.models import (TransformerConfig, make_train_step, params_from_numpy,
                                           state_checksum, transformer, value_and_grad)
from odh_kubeflow_tpu_torch.models.tree import tree_map
from odh_kubeflow_tpu_torch.ops import attention, ring_attention as ring_mod
from odh_kubeflow_tpu_torch.parallel import MeshPlan, comm, shard_batch
from odh_kubeflow_tpu_torch.parallel.mesh import GROUP_AXES, REPLICA_AXES


@contextlib.contextmanager
def counting_plain():
    """Counts calls of the flash op's plain forward, dq and dk/dv."""
    counts = {"fwd": 0, "dq": 0, "dkv": 0}
    saved = {name: getattr(attention, name) for name in
             ("flash_attention_plain", "flash_bwd_dq_plain", "flash_bwd_dkv_plain")}

    def wrap(name, key):
        def counted(*args, **kwargs):
            counts[key] += 1
            return saved[name](*args, **kwargs)
        return counted

    attention.flash_attention_plain = wrap("flash_attention_plain", "fwd")
    attention.flash_bwd_dq_plain = wrap("flash_bwd_dq_plain", "dq")
    attention.flash_bwd_dkv_plain = wrap("flash_bwd_dkv_plain", "dkv")
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(attention, name, fn)


def ring_case(rank, world, q, k, v, layout, causal, use_kernel, device="cpu"):
    """This rank's ring output and q/k/v gradients of sum(out**2), from
    global (b, s, heads, d) arrays (zigzag: already in zigzag order), and
    the plain forward/dq/dk-dv calls it made."""
    mesh = MeshPlan(sp=world).build(device)
    shards = shard_batch(mesh, {"q": q, "k": k, "v": v})
    q_, k_, v_ = (shards[n].requires_grad_() for n in "qkv")
    attention.reset_launch_counts()
    with counting_plain() as counts:
        if layout == "zigzag":
            out = ring_mod.ring_attention_zigzag(q_, k_, v_, mesh, use_kernel=use_kernel)
        else:
            out = ring_mod.ring_attention(q_, k_, v_, mesh, causal=causal, use_kernel=use_kernel)
        (out.float() ** 2).sum().backward()
    return {"out": out.detach().cpu().numpy(), "dq": q_.grad.cpu().numpy(), "dk": k_.grad.cpu().numpy(),
            "dv": v_.grad.cpu().numpy(), "launches": dict(counts),
            "kernel_launches": dict(attention.launch_counts)}


def model_case(rank, world, params, batch, cfg, plan, use_kernel, train_step=False, device="cpu"):
    """The port's sp loss and summed gradients (cfg, a TransformerConfig,
    over a MeshPlan(**plan)) on this rank's shard of a global batch (numpy),
    the plain forward/backward calls and kernel launches it made, and, with
    train_step, the digest of the params after one make_train_step step.
    Rank 0 returns the gradients; every rank their digest."""
    mesh = MeshPlan(**plan).build(device)
    # every leaf in the model's dtype (numpy has no bf16: the arrays come as f32)
    tparams = tree_map(lambda t: t.to(cfg.dtype), params_from_numpy(params, cfg.dtype, device=mesh.device))
    local = shard_batch(mesh, batch)
    saved = (transformer.ring_attention, transformer.ring_attention_zigzag)
    transformer.ring_attention = functools.partial(saved[0], use_kernel=use_kernel)
    transformer.ring_attention_zigzag = functools.partial(saved[1], use_kernel=use_kernel)
    try:
        comm.reset_exchange_counts()
        attention.reset_launch_counts()
        with counting_plain() as counts:
            loss, grads = value_and_grad(tparams, local, cfg, mesh)
        out = {"loss": float(loss), "launches": dict(counts), "grads_digest": state_checksum(dict(enumerate(grads))),
               "kernel_launches": dict(attention.launch_counts),
               "exchanges": dict(comm.exchange_counts)}
        if rank == 0:
            out["grads"] = [g.float().cpu().numpy() for g in grads]
        if train_step:
            step, opt = make_train_step(cfg, mesh=mesh)
            state = opt.init(tparams)
            tparams, state, step_loss = step(tparams, state, local)
            out["step_loss"] = float(step_loss)
            out["params_digest"] = state_checksum(tparams)
    finally:
        transformer.ring_attention, transformer.ring_attention_zigzag = saved
    return out


def mesh_case(rank, world, plan, arrays):
    """This rank's mesh coordinates, group ranks and shard_batch blocks."""
    mesh = MeshPlan(**plan).build("cpu")
    blocks = shard_batch(mesh, arrays)
    return {
        "coords": mesh.coords,
        "groups": {axes: mesh.ranks(axes) for axes in ("sp", "dp", "fsdp", ("dp", "fsdp"),
                                                       ("dp", "fsdp", "sp"))},
        "built": {axes: mesh.group(axes)[1] for axes in GROUP_AXES},
        "index_batch": mesh.index(("dp", "fsdp")),
        "blocks": {name: t.numpy() for name, t in blocks.items()},
        "sum": [t.numpy() for t in comm.all_reduce_sum(
            [torch.full((3,), float(rank)), torch.ones(2, dtype=torch.bfloat16)],
            mesh.group(REPLICA_AXES)[0])],
        "shift": [t.numpy() for t in comm.shift(comm.Ring(mesh, "sp" if mesh.sizes["sp"] > 1 else REPLICA_AXES),
                                                [torch.tensor([rank])])],
    }


def bringup_case(rank, world, repaired_port):
    """The live group from the webhook env, bring-up again (idempotent),
    a sum over it, and reinitialize_after_repair against the repaired
    gang's coordinator (a new incarnation: a new port)."""
    import os

    import torch.distributed as dist

    from odh_kubeflow_tpu_torch.parallel import initialize_from_env, reinitialize_after_repair

    first = (dist.get_rank(), dist.get_world_size(), str(dist.get_backend()))
    again = initialize_from_env(timeout_s=60, device="cpu")
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    dist.barrier()
    os.environ["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{repaired_port}"
    repaired = reinitialize_after_repair(timeout_s=60, device="cpu")
    u = torch.tensor([float(rank + 1)])
    dist.all_reduce(u)
    return {"first": first, "again": again, "sum": float(t), "repaired": repaired,
            "sum_after": float(u), "initialized": dist.is_initialized()}


def targets_case(rank, world, tokens):
    """This rank's next-token labels and mask of a contiguous sp shard."""
    cfg = TransformerConfig(seq_axis="sp", dtype="float32")
    mesh = MeshPlan(sp=world).build("cpu")
    local = shard_batch(mesh, {"tokens": tokens})["tokens"]
    targets, mask = transformer._next_token_targets(local, mesh, cfg)
    return {"targets": targets.numpy(), "mask": mask.numpy()}


def ring_case_typed(rank, world, q, k, v, layout, dtype, device):
    """ring_case in `dtype` on `device`, the path chosen by the device."""
    cast = [np.asarray(x) for x in (q, k, v)]
    mesh = MeshPlan(sp=world).build(device)
    shards = shard_batch(mesh, dict(zip("qkv", cast)))
    q_, k_, v_ = (shards[n].to(getattr(torch, dtype)).requires_grad_() for n in "qkv")
    attention.reset_launch_counts()
    if layout == "zigzag":
        out = ring_mod.ring_attention_zigzag(q_, k_, v_, mesh)
    else:
        out = ring_mod.ring_attention(q_, k_, v_, mesh, causal=True)
    (out.float() ** 2).sum().backward()
    return {"out": out.detach().float().cpu().numpy(),
            **{n: t.grad.float().cpu().numpy() for n, t in (("dq", q_), ("dk", k_), ("dv", v_))},
            "kernel_launches": dict(attention.launch_counts)}
