"""What each rank of the port's tp-decode and ep tests runs
(tests/torch_dist.py spawns the ranks). Imports no jax: inputs arrive as
numpy arrays made in the test process, and results go back as numpy
arrays.
"""
import torch

from odh_kubeflow_tpu_torch.models import generate, moe_ffn, params_from_numpy, shard_params, shard_tree
from odh_kubeflow_tpu_torch.models.convert import gather_tree
from odh_kubeflow_tpu_torch.parallel import MeshPlan, Placement, comm, shard_batch
from odh_kubeflow_tpu_torch.parallel.mesh import DATA_SEQ_AXES, REPLICA_AXES, logical_to_spec

# one layer's expert leaves as the transformer stores them (its
# _EXPERT_AXES without the layers dim; the router replicated)
EXPERT_AXES = {"we_gate": ("expert", "embed", "mlp"), "we_up": ("expert", "embed", "mlp"),
               "we_out": ("expert", "mlp", "embed")}


def expert_placements(mesh) -> dict:
    out = {name: Placement(logical_to_spec(axes, mesh)) for name, axes in EXPERT_AXES.items()}
    out["router"] = Placement()
    return out


def moe_case(rank, world, params, x, cfg, plan, aux_weight, device="cpu"):
    """moe_ffn over MeshPlan(**plan) on this rank's data shard of a global
    x and its blocks of one layer's expert params: the rank's output rows,
    the aux loss, and the gathered gradients (rank 0) of sum(out**2) +
    aux_weight * aux: the router's summed over ep and the data axes, each
    expert stack's (reduce-scattered over fsdp by its gather) over the
    data axes besides fsdp, x's rows as they come out of the layer."""
    mesh = MeshPlan(**plan).build(device)
    placements = expert_placements(mesh)
    local = shard_tree(params_from_numpy(params, torch.float32, device=mesh.device), placements, mesh)
    local = {k: v.requires_grad_() for k, v in local.items()}
    xl = shard_batch(mesh, {"x": x})["x"].requires_grad_()
    comm.reset_exchange_counts()
    out, aux = moe_ffn(xl, local, cfg, mesh=mesh)
    loss = (out.float() ** 2).sum() + aux_weight * aux
    names = list(local)
    grads = torch.autograd.grad(loss, [local[n] for n in names] + [xl])
    grads, dx = dict(zip(names, grads[:-1])), grads[-1]
    ep = mesh.group("ep")[0]
    if ep is not None:
        grads["router"] = comm.all_reduce_sum([grads["router"]], ep)[0]
    for name, pl in placements.items():
        group = mesh.group(DATA_SEQ_AXES if "fsdp" in pl.axes() else REPLICA_AXES)[0]
        if group is not None:
            grads[name] = comm.all_reduce_sum([grads[name]], group)[0]
    exchanges = dict(comm.exchange_counts)
    gathered = gather_tree(grads, placements, mesh)
    res = {"out": out.detach().cpu().numpy(), "aux": float(aux.detach()), "dx": dx.cpu().numpy(),
           "coords": mesh.coords, "exchanges": exchanges}
    if rank == 0:
        res["grads"] = {k: v.cpu().numpy() for k, v in gathered.items()}
    return res


def decode_case(rank, world, params, prompt, cfg, plan, max_new, runs, device="cpu"):
    """generate(mesh=) over MeshPlan(**plan) on this rank's blocks of global
    numpy params: for each (temperature, seed) of `runs`, the tokens and
    the exchanges by kind."""
    mesh = MeshPlan(**plan).build(device)
    local = shard_params(params_from_numpy(params, cfg.dtype, device=mesh.device), cfg, mesh)
    out = []
    for temperature, seed in runs:
        comm.reset_exchange_counts()
        gen = torch.Generator(device=mesh.device).manual_seed(seed)
        tokens = generate(local, prompt, cfg, max_new, generator=gen, temperature=temperature, mesh=mesh)
        out.append({"tokens": tokens.cpu().numpy(), "exchanges": dict(comm.exchange_counts)})
    return out


def sampled_reference(params, prompt, cfg, max_new, runs, device="cpu"):
    """The one-process generate() of each (temperature, seed) of `runs`."""
    full = params_from_numpy(params, cfg.dtype, device=device)
    return [generate(full, prompt, cfg, max_new, generator=torch.Generator(device=device).manual_seed(seed),
                     temperature=temperature, device=device).cpu().numpy() for temperature, seed in runs]


def comm_ep_case(rank, world, device="cpu"):
    """The collectives of the ep MoE and of tp decode over the tp group of a
    tp=world mesh, on tensors on `device` made from the rank: the ep pair
    and gather_slices forward and backward, aux_mean, and vocab_argmax on a
    row with ties cut into vocab blocks (the same global row on every rank,
    from one seed)."""
    import numpy as np

    mesh = MeshPlan(tp=world).build(device)
    group = mesh.group("tp")[0]

    def t(*shape):
        return (torch.arange(float(np.prod(shape))).reshape(shape) + 10 * rank).to(mesh.device)

    out = {}
    x = t(2, 3).requires_grad_()
    y = comm.ep_enter(x, group)
    (y * t(2, 3)).sum().backward()
    out["ep_enter"] = (y.detach().cpu().numpy(), x.grad.cpu().numpy())
    x = t(2, 3).requires_grad_()
    y = comm.ep_sum(x, group)
    (y * t(2, 3)).sum().backward()
    out["ep_sum"] = (y.detach().cpu().numpy(), x.grad.cpu().numpy())
    x = t(3, 2).requires_grad_()
    y = comm.gather_slices(x, group, 1)
    (y * torch.arange(float(y.numel()), device=mesh.device).reshape(y.shape)).sum().backward()
    out["gather_slices"] = (y.detach().cpu().numpy(), x.grad.cpu().numpy())
    x = torch.tensor(float(rank + 1), device=mesh.device, requires_grad=True)
    y = comm.aux_mean(x, group, 0.25)
    y.backward()
    out["aux_mean"] = (y.detach().cpu().numpy(), x.grad.cpu().numpy())
    row = np.random.default_rng(99).integers(0, 4, (5, 3 * world)).astype(np.float32)
    block = torch.from_numpy(row[:, 3 * rank:3 * rank + 3]).to(mesh.device)
    comm.reset_exchange_counts()
    out["argmax"] = (comm.vocab_argmax(block, group, 3 * rank).cpu().numpy(), row.argmax(-1))
    out["argmax_bytes"] = comm.exchange_counts["argmax_bytes"]
    return out
