"""Mixture-of-Experts FFN on one device (counterpart of
odh_kubeflow_tpu/models/moe.py).

Routing is Switch/GShard top-k softmax gating with capacity bounds and the
load-balance aux loss, made once in index form (`route_indices`) and
consumed by one of two dispatches:

- **indexed** ("auto" and "indexed"): each kept (token, pick) owns one
  (expert, slot), so dispatch and combine are row gathers through the
  token->slot map and its inverse: O(N·k·d) data movement.
- **dense** ("dense", kept for A/B): the (N, E, C) one-hot dispatch and
  combine products, O(N·E·C·d).

Tokens routed to an expert past `capacity_factor * N * k / E` are dropped
(combine weight 0).

Over a mesh (`moe_ffn(mesh=)`), as the reference's `moe_ffn` picks:

- **a live ep axis** (`_moe_ffn_ep_indexed`, the reference's shard_map):
  tokens are replicated over ep and keep their data shard (dp, fsdp, sp);
  the expert stacks, stored cut over ep, fsdp (embed) and tp (mlp), are
  gathered to their ep block at the boundary (the fsdp gather's gradient
  reduce-scattered, the tp gather's sliced: every tp rank runs the same
  experts on the same tokens); then `_moe_ffn_manual`: each ep rank routes
  all its tokens with the whole router, slot-packs the picks of its own
  experts and runs them, and one sum over ep completes the combine (there
  is no all-to-all). Capacity comes from the shard's token count, and the
  aux loss is averaged over the data axes.
- **no live ep axis**: the reference's GSPMD routes the global batch, so
  the port joins the data shards' tokens (all-gathered, the gradient
  reduce-scattered), runs the one-device path on the whole batch with the
  experts gathered whole, and keeps its own rows: exact, at the cost of
  every data rank running every token's experts.

- **the dense dispatch over a live ep axis** (`_moe_ffn_ep_dense`, the
  reference's GSPMD einsums whose shardings induce the all-to-alls, kept
  for A/B): the global batch routed as on one device, each ep rank's
  one-hot dispatch and combine cut to its own experts, and one f32 sum
  over ep completes the combine.

`replicated_batch=True` (decode, whose ranks hold the whole batch) routes
the whole batch as one, on every path: the reference's decode runs its
layers without the mesh, so GSPMD routes the global batch there too.

Nothing here syncs with the host: capacity comes from the static token
count, and routing uses no `nonzero`, boolean-mask indexing or `.item()`.
Nothing depends on launch order either: the only scatter writes each place
once, and the gathers' backwards are gathers (`_PermutationGather`), so a
step routes and sums the same way every time, in its backward's recompute
too.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..ops import matmul_f32
from ..parallel import comm
from ..parallel.mesh import REPLICA_AXES, data_axes, logical_to_spec


@dataclass(frozen=True)
class MoEConfig:
    """The JAX package's MoEConfig fields and defaults. `d_ff` is the
    per-expert hidden width (0: the dense layer's d_ff). `dispatch` is
    "auto" or "indexed" (the indexed path on one device) or "dense"."""

    n_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    d_ff: int = 0
    router_aux_weight: float = 0.01
    dispatch: str = "auto"


# the expert params of a layer (the transformer stacks them over layers)
MOE_AXES = ("router", "we_gate", "we_up", "we_out")
# an expert stack -> (its embed dim, its mlp dim) in one layer's view
_EXPERT_DIMS = {"we_gate": (1, 2), "we_up": (1, 2), "we_out": (2, 1)}


def _dense_init(generator: torch.Generator, shape, fan_in: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """Truncated normal (+-2 std, std = fan_in**-0.5), drawn in f32 on the
    CPU from `generator`, then moved to `device` in `dtype`."""
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * (1.0 / fan_in) ** 0.5).to(device=device, dtype=dtype)


def init_moe_params(generator: torch.Generator, d_model: int, cfg: MoEConfig, dtype: torch.dtype,
                    device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """One layer's experts: router (d, E) in f32 whatever `dtype` (drawn,
    rounded to `dtype` and widened, as the JAX init does), expert stacks
    (E, d, f) and (E, f, d) in `dtype`."""
    dev = resolve_device(device)
    e, f = cfg.n_experts, cfg.d_ff
    return {
        # router stays f32: tiny, and routing decisions are precision-sensitive
        "router": _dense_init(generator, (d_model, e), d_model, dtype, dev).float(),
        "we_gate": _dense_init(generator, (e, d_model, f), d_model, dtype, dev),
        "we_up": _dense_init(generator, (e, d_model, f), d_model, dtype, dev),
        "we_out": _dense_init(generator, (e, f, d_model), f, dtype, dev),
    }


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(...,) indices -> (..., n) int64 one-hots, by comparison (F.one_hot
    checks its range on the host for some devices)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def route_indices(logits: torch.Tensor, k: int, capacity: int):
    """(N, E) router logits -> choice, gate, pos, keep (N, k) (gate f32)
    and the Switch aux loss (0-d f32). A token's position in its expert's
    buffer is a cumulative sum over token order after the picks of earlier
    rounds; positions past `capacity` are dropped (keep False, pos
    clipped). k > 1 renormalises the gates over the kept picks; k = 1 keeps
    the raw gate, so the router also learns from the LM loss."""
    e = logits.shape[1]
    probs = torch.softmax(logits.float(), dim=-1)
    experts = torch.arange(e, device=logits.device)
    claimed = torch.zeros((e, 1), dtype=torch.long, device=logits.device)
    masked = probs
    choices, gates, poss, keeps = [], [], [], []
    for _ in range(k):
        choice = masked.argmax(dim=-1)
        gate = masked.gather(1, choice[:, None])[:, 0]
        # expert-major (E, N) one-hots: the sum over token order runs along
        # the contiguous axis (a cumsum down the rows of (N, E) one-hots is
        # a kernel ~100x slower on the card at N = 16k)
        onehot = (experts[:, None] == choice[None, :]).long()
        pos = ((onehot.cumsum(dim=1) - 1 + claimed) * onehot).sum(dim=0)
        keep = pos < capacity
        pos = pos.clamp(0, capacity - 1)
        claimed = claimed + (onehot * keep).sum(dim=1, keepdim=True)
        masked = masked * (1.0 - onehot.t().float())  # the next-best expert
        choices.append(choice)
        gates.append(gate)
        poss.append(pos)
        keeps.append(keep)
    choice = torch.stack(choices, dim=1)
    gate = torch.stack(gates, dim=1)
    pos = torch.stack(poss, dim=1)
    keep = torch.stack(keeps, dim=1)

    # E * sum_e fraction of tokens whose top pick is e * mean prob of e
    top1 = (experts[:, None] == choices[0][None, :]).float()
    aux = e * (top1.mean(dim=1) * probs.mean(dim=0)).sum()
    if k > 1:
        live = gate * keep.float()
        gate = gate / live.sum(dim=1, keepdim=True).clamp_min(1e-9)
    return choice, gate, pos, keep, aux


def route_topk(logits: torch.Tensor, k: int, capacity: int):
    """(N, E) router logits -> dispatch (N, E, C) one-hots, combine (N, E,
    C) weights (both f32) and the aux loss: route_indices made dense."""
    n, e = logits.shape
    choice, gate, pos, keep, aux = route_indices(logits, k, capacity)
    dispatch = torch.zeros((n, e, capacity), dtype=torch.float32, device=logits.device)
    combine = torch.zeros_like(dispatch)
    for j in range(k):
        contrib = (_one_hot(choice[:, j], e).float()[:, :, None]
                   * _one_hot(pos[:, j], capacity).float()[:, None, :]
                   * keep[:, j].float()[:, None, None])
        dispatch = dispatch + contrib
        combine = combine + contrib * gate[:, j][:, None, None]
    return dispatch, combine, aux


def _capacity(cfg: MoEConfig, n: int) -> int:
    return max(1, int(cfg.capacity_factor * n * cfg.experts_per_token / cfg.n_experts))


def _expert_mlp(expert_in: torch.Tensor, params, dtype: torch.dtype) -> torch.Tensor:
    """The expert SwiGLU over slot-packed tokens: (E, C, d) -> (E, C, d).
    gate/up keep their f32 products, as the JAX einsums do."""
    gate = matmul_f32(expert_in, params["we_gate"])
    up = matmul_f32(expert_in, params["we_up"])
    hidden = (F.silu(gate) * up).to(dtype)
    return torch.bmm(hidden, params["we_out"])


def _pad_rows(t: torch.Tensor) -> torch.Tensor:
    """(R, d) -> (R + 1, d) with a zero last row, which index R reads."""
    return torch.cat([t, t.new_zeros((1, t.shape[1]))])


class _PermutationGather(torch.autograd.Function):
    """rows[i] = src[idx[i]], where index len(src) reads a zero row, for an
    `idx` under which each row of src is read by at most m outputs, listed
    in `inv` (len(src), m) (index len(idx) where fewer). The backward is
    the cotangent gathered by `inv` and summed over m in order: the
    gather's transpose without a scatter-add, so its sums take one order on
    every device and every run."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        return _pad_rows(src)[idx]

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return _pad_rows(g)[inv].sum(dim=1), None, None


def _indexed_dispatch(flat, choice, pos, keep, e: int, capacity: int):
    """Slot-pack tokens: expert_in (e, capacity, d), where an empty slot
    holds zeros, plus the two maps: dest (N, k), each pick's flat slot
    (e * capacity for a dropped pick), and its inverse slot_pick (e *
    capacity,), each slot's flat pick n * k + j (N * k for an empty slot).
    Every (expert, slot) holds at most one pick (route_indices' cumsum), so
    both maps are permutations of the kept picks."""
    n, d = flat.shape
    k = choice.shape[1]
    slots = e * capacity
    dest = torch.where(keep, choice * capacity + pos, slots)
    picks = torch.arange(n * k, device=flat.device)
    # a dropped pick writes past the slots, to a place of its own: no two
    # writes meet, so the scatter is deterministic
    target = torch.where(keep.reshape(-1), dest.reshape(-1), slots + picks)
    slot_pick = torch.full((slots + n * k,), n * k, dtype=torch.long, device=flat.device)
    slot_pick = slot_pick.index_put_((target,), picks)[:slots]
    expert_in = _PermutationGather.apply(flat, slot_pick // k, dest)
    return expert_in.reshape(e, capacity, d), dest, slot_pick


def _indexed_combine(expert_out, dest, slot_pick, gate, keep, dtype: torch.dtype):
    """out[n] = sum_j gate[n,j]·keep[n,j]·expert_out[slot dest[n,j]], in f32
    and cast to `dtype`: a row gather and a weighted sum."""
    e, c, d = expert_out.shape
    n, k = dest.shape
    gathered = _PermutationGather.apply(expert_out.reshape(e * c, d), dest.reshape(-1),
                                        slot_pick[:, None]).reshape(n, k, d)
    w = (gate * keep.float())[..., None]
    return (gathered.float() * w).sum(dim=1).to(dtype)


def _route(x: torch.Tensor, params, cfg: MoEConfig):
    """(flat (N, d), capacity, router logits (N, E) in f32)."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    return flat, _capacity(cfg, b * s), flat.float() @ params["router"]


def _moe_ffn_indexed(x: torch.Tensor, params, cfg: MoEConfig,
                     experts=_expert_mlp) -> Tuple[torch.Tensor, torch.Tensor]:
    flat, capacity, logits = _route(x, params, cfg)
    choice, gate, pos, keep, aux = route_indices(logits, cfg.experts_per_token, capacity)
    expert_in, dest, slot_pick = _indexed_dispatch(flat, choice, pos, keep, cfg.n_experts, capacity)
    expert_out = experts(expert_in, params, x.dtype)
    out = _indexed_combine(expert_out, dest, slot_pick, gate, keep, x.dtype)
    return out.reshape(x.shape), aux


def _moe_ffn_dense(x: torch.Tensor, params, cfg: MoEConfig,
                   experts=_expert_mlp) -> Tuple[torch.Tensor, torch.Tensor]:
    flat, capacity, logits = _route(x, params, cfg)
    dispatch, combine, aux = route_topk(logits, cfg.experts_per_token, capacity)
    expert_in = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), flat)
    expert_out = experts(expert_in, params, x.dtype)
    out = torch.einsum("nec,ecd->nd", combine.to(x.dtype), expert_out)
    return out.reshape(x.shape), aux


def dispatch_only(x: torch.Tensor, params, cfg: MoEConfig, dense: bool = False) -> torch.Tensor:
    """Routing, dispatch and combine with the expert MLP replaced by the
    identity: the dispatch machinery's cost alone (the dispatch share), and
    with dense=True the one-hot products' for the A/B."""
    ffn = _moe_ffn_dense if dense else _moe_ffn_indexed
    return ffn(x, params, cfg, experts=lambda expert_in, params, dtype: expert_in)[0]


def routing_stats(x: torch.Tensor, params, cfg: MoEConfig) -> Dict[str, Any]:
    """Routing health at activations x: the capacity-drop rate (share of
    (token, pick) assignments dropped, 0-d f32), the capacity, and each
    expert's share of the picks (E,)."""
    flat, capacity, logits = _route(x, params, cfg)
    choice, _gate, _pos, keep, _aux = route_indices(logits, cfg.experts_per_token, capacity)
    load = _one_hot(choice, cfg.n_experts).float().sum(dim=(0, 1))
    return {
        "drop_rate": 1.0 - keep.float().mean(),
        "capacity": capacity,
        "expert_load_frac": load / load.sum().clamp_min(1.0),
    }


def _moe_ffn_manual(x: torch.Tensor, params, cfg: MoEConfig, ep_axis: str,
                    mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ep rank's MoE over tokens replicated on its ep axis (the
    reference's `moe.py:239-277`): the router is whole and the expert
    stacks hold this rank's e_local experts. Every pick is routed as on
    one device; the picks of other ranks' experts are masked, the rank's
    own are slot-packed, run and combined, and the sum over ep completes
    the combine. The aux loss comes from the whole router's logits, the
    same on every ep rank. Capacity comes from this call's token count.
    The rank's combine stays f32 into the sum over ep, which is cast
    once, as one device rounds the combine; the reference casts each
    rank's part before its sum (the same in f32, one more bf16 rounding
    of every output there)."""
    group = mesh.group(ep_axis)[0]
    e_local = params["we_gate"].shape[0]
    rank = mesh.index(ep_axis)
    x = comm.ep_enter(x, group)
    flat, capacity, logits = _route(x, params, cfg)
    choice, gate, pos, keep, aux = route_indices(logits, cfg.experts_per_token, capacity)
    local_choice = choice - rank * e_local
    lkeep = keep & (local_choice >= 0) & (local_choice < e_local)
    expert_in, dest, slot_pick = _indexed_dispatch(flat, local_choice, pos, lkeep, e_local, capacity)
    expert_out = _expert_mlp(expert_in, params, x.dtype)
    out = _indexed_combine(expert_out, dest, slot_pick, gate, lkeep, torch.float32)
    return comm.ep_sum(out, group).to(x.dtype).reshape(x.shape), aux


def _expert_blocks(params, cfg: MoEConfig, mesh):
    """The layer's expert stacks gathered from their stored blocks to the
    rank's ep block: over fsdp on the embed dim (ZeRO's gather: the ranks'
    tokens differ, so the gradient is reduce-scattered) and over tp on the
    mlp dim (every tp rank runs the same experts: the gradient is sliced).
    A dim that is whole already (decode gathers its views once) is kept."""
    fsdp, tp = mesh.group("fsdp")[0], mesh.group("tp")[0]
    d = params["router"].shape[0]
    out = dict(params)
    for name, (embed_dim, mlp_dim) in _EXPERT_DIMS.items():
        w = params[name]
        if w.shape[embed_dim] != d:
            w = comm.gather_shards(w, fsdp, embed_dim)
        if w.shape[mlp_dim] != cfg.d_ff:
            w = comm.gather_slices(w, tp, mlp_dim)
        out[name] = w
    return out


def _data_cut(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's (batch, seq) block of a whole batch, as the reference's
    shard_map cuts its (batch, seq) dims over the data axes."""
    for dim, axes in enumerate(logical_to_spec(("batch", "seq"), mesh)):
        if axes is not None:
            n = mesh.size(axes)
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over {axes} ({n})")
            x = x.narrow(dim, mesh.index(axes) * (x.shape[dim] // n), x.shape[dim] // n)
    return x


def _data_join(x: torch.Tensor, mesh) -> torch.Tensor:
    """The whole batch from the data ranks' (batch, seq) blocks, in the
    global order (the inverse of `_data_cut`), all-gathered over the
    replica group; the gradient is reduce-scattered back to the block."""
    group = mesh.group(REPLICA_AXES)[0]
    if group is None:
        return x
    b, s = x.shape[:2]
    n_b, n_s = mesh.size(("dp", "fsdp")), mesh.size("sp")
    whole = comm.gather_shards(x.unsqueeze(0), group, 0)
    whole = whole.reshape(n_b, n_s, b, s, *x.shape[2:]).transpose(1, 2)
    return whole.reshape(n_b * b, n_s * s, *x.shape[2:])


def _moe_ffn_ep_indexed(x: torch.Tensor, params, cfg: MoEConfig, mesh,
                        replicated_batch: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The live-ep path (the reference's `moe.py:339-393`): the expert
    stacks gathered to their ep block, `_moe_ffn_manual` on this rank's
    data shard (the whole batch with replicated_batch), the aux loss
    averaged over the data axes. Its gradient
    counts the aux once: every ep rank holds the same aux and sums its
    tokens' and the router's gradients over ep, and every data rank
    differentiates its own share (the sums over the data axes follow)."""
    axes = () if replicated_batch else data_axes(mesh)
    out, aux = _moe_ffn_manual(x, _expert_blocks(params, cfg, mesh), cfg, "ep", mesh)
    n_data = mesh.size(axes) if axes else 1
    aux = comm.aux_mean(aux, mesh.group(REPLICA_AXES)[0] if axes else None,
                        1.0 / (n_data * mesh.size("ep")))
    return out, aux


def _moe_ffn_ep_dense(x: torch.Tensor, params, cfg: MoEConfig, mesh,
                      replicated_batch: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense dispatch over a live ep axis (the reference's GSPMD
    einsums, `moe.py:423-468`): the global batch joined from the data
    ranks and routed as on one device (capacity, drops and the aux loss
    from the whole batch's count, as `_moe_ffn_dense`'s), the (N, E, C)
    one-hot dispatch and combine cut to this rank's ep block of experts,
    those experts run with the expert stacks gathered to the block, the
    combine kept in f32 into the sum over ep and cast once, and the rank's
    own rows kept. Every ep and data rank holds the same aux, so its
    gradient is scaled to count it once over both."""
    group = mesh.group("ep")[0]
    blocks = _expert_blocks(params, cfg, mesh)
    e_local = blocks["we_gate"].shape[0]
    first = mesh.index("ep") * e_local
    whole = comm.ep_enter(x if replicated_batch else _data_join(x, mesh), group)
    flat, capacity, logits = _route(whole, blocks, cfg)
    dispatch, combine, aux = route_topk(logits, cfg.experts_per_token, capacity)
    dispatch, combine = (t.narrow(1, first, e_local) for t in (dispatch, combine))
    expert_in = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), flat)
    expert_out = _expert_mlp(expert_in, blocks, x.dtype)
    out = torch.einsum("nec,ecd->nd", combine, expert_out.float())
    out = comm.ep_sum(out, group).to(x.dtype).reshape(whole.shape)
    axes = () if replicated_batch else data_axes(mesh)
    n_data = mesh.size(axes) if axes else 1
    aux = comm.aux_mean(aux, None, 1.0 / (n_data * mesh.size("ep")))
    return (out if replicated_batch else _data_cut(out, mesh)), aux


def _moe_ffn_global(x: torch.Tensor, params, cfg: MoEConfig, mesh,
                    replicated_batch: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """No live ep axis: the global batch routed as on one device (the
    reference's GSPMD path), on every data rank, which keeps its own rows.
    The aux loss is the global batch's on every rank; its gradient counts
    it once over the data ranks."""
    axes = data_axes(mesh)
    whole = x if replicated_batch else _data_join(x, mesh)
    ffn = _moe_ffn_dense if cfg.dispatch == "dense" else _moe_ffn_indexed
    out, aux = ffn(whole, _expert_blocks(params, cfg, mesh), cfg)
    n_data = 1 if replicated_batch or not axes else mesh.size(axes)
    aux = comm.aux_mean(aux, None, 1.0 / n_data)
    return (out if replicated_batch else _data_cut(out, mesh)), aux


def moe_ffn(x: torch.Tensor, params, cfg: MoEConfig, mesh=None, ep_axis: str = "",
            replicated_batch: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(batch, seq, d) -> (batch, seq, d) in x's dtype, and the router aux
    loss (0-d f32). `params` holds the MOE_AXES names (a layer's view may
    hold more). The path is picked as the reference's `moe_ffn` picks it:
    `ep_axis` (a caller whose tokens are replicated over that axis and
    whose expert stacks are the rank's ep block) runs `_moe_ffn_manual`;
    a mesh (x this rank's data shard, or with replicated_batch the whole
    batch; the stacks this rank's stored blocks) runs the ep path where ep
    is live, else the global batch's routing; no mesh runs on one
    device."""
    if cfg.dispatch not in ("auto", "indexed", "dense"):
        raise ValueError(f"unknown MoE dispatch {cfg.dispatch!r}: use auto, indexed or dense")
    if ep_axis:
        return _moe_ffn_manual(x, params, cfg, ep_axis, mesh)
    if mesh is not None:
        if mesh.sizes["ep"] > 1:
            if cfg.dispatch == "dense":
                return _moe_ffn_ep_dense(x, params, cfg, mesh, replicated_batch)
            return _moe_ffn_ep_indexed(x, params, cfg, mesh, replicated_batch)
        return _moe_ffn_global(x, params, cfg, mesh, replicated_batch)
    if cfg.dispatch == "dense":
        return _moe_ffn_dense(x, params, cfg)
    return _moe_ffn_indexed(x, params, cfg)
