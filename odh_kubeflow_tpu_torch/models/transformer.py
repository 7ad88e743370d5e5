"""Flagship decoder-only transformer (counterpart of
odh_kubeflow_tpu/models/transformer.py), dense or MoE.

On one device, or with a `mesh` (parallel.MeshPlan.build) of data (dp,
fsdp), expert (ep), tensor (tp) and sequence (sp) axes: each rank then runs its local
(batch, seq) shard (parallel.shard_batch) with global positions on its
shard of the params (`param_specs`; models.shard_params cuts them), and
the loss and gradients are the global ones. fsdp: every leaf is cut on its
"embed" dim, and each layer gathers its weights before use (ZeRO-3; the
layer checkpoint gathers them again in the backward), the embedding table
and the unembedding whole before the lookup and the logits; the gathers'
gradients are reduce-scattered back to the blocks. tp: `wqkv`, `wi_gate`,
`wi_up` and the unembedding are column-parallel over heads, mlp and vocab,
`wo` and `wo_mlp` row-parallel, their partial products summed over tp in
f32 and then cast (the reference's rounding point), and the residual
stream stays replicated over tp; attention, flash or the ring over sp, runs
on the rank's own h/tp query and kv_heads/tp kv heads, so a rank's `wqkv`
block holds its own [q | k | v] heads (on disk and in the checksum the leaf
keeps the reference's global layout). Where tp does not divide kv_heads
(a rank's q heads read a kv head another rank's read too), `wqkv` is
stored replicated over tp, and each rank slices its q heads and the kv
heads they read from it, its gradient summed over tp; the reference
replicates the fused axis only where tp does not divide it and reshards
it otherwise (GSPMD), so the storage differs there and the result does
not. The loss is taken over the vocab shards (max, sum of exponentials
and the target logit over tp). An MoE config runs `moe_ffn(mesh=)`: its
input stays replicated over tp (every tp rank runs the same experts on
the same tokens, as the reference's GSPMD does) and over ep (models/moe.py);
the loss adds router_aux_weight times the aux loss over n_layers. A mesh
with a live pp axis runs these entry points replicated over pp (the
reference's param_specs name no stage axis): the pp ranks compute alike.

Pipeline parallelism (pp) has its own entry points (`pp_forward`,
`pp_loss_fn`, `pp_value_and_grad`, `pp_1f1b_value_and_grad`,
`make_pp_train_step`), on params in the stage-stacked layout of
`to_pp_params` cut as `pp_param_placements` says; `_pp_manual_layout`
says how tp, fsdp (ZeRO stage storage) and sp compose inside the stages.

Parameters are plain dicts of tensors in the JAX package's layout, stacked
over layers: ``layers[name]`` is ``(L, ...)`` and the QKV projection is one
fused ``wqkv (L, d_model, n_heads + 2*kv_heads, head_dim)``, so weights
converted from the JAX tree (models/convert.py) drop in unchanged. An MoE
config (`moe`, a models/moe.py MoEConfig) has ``router (L, d, E)`` (f32)
and ``we_gate``/``we_up (L, E, d, f)``, ``we_out (L, E, f, d)`` in place of
the dense ``wi_gate``/``wi_up``/``wo_mlp``. Layers run in a Python loop
over per-layer views of the stack.

Rounding points follow the JAX package's ``preferred_element_type=f32``
contractions: a projection whose JAX result is cast to the model dtype is a
matmul in that dtype (f32 accumulate, one rounding at the output); one whose
JAX result stays f32 (SwiGLU gate/up, logits) goes through `matmul_f32`.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from ..device import DeviceLike, resolve_device
from ..ops import apply_rope, flash_attention, matmul_f32, mha_reference, rms_norm
from ..ops.ring_attention import ring_attention, ring_attention_zigzag, zigzag_permutation
from ..parallel import comm
from ..parallel.mesh import AXES, DATA_SEQ_AXES, REPLICA_AXES, Placement, axes_index, logical_to_spec
from ..parallel.pipeline import pipeline_apply, pipeline_value_and_grad_1f1b, pipeline_value_and_grad_gpipe, stack_stages
from ..parallel.interleaved_1f1b import pipeline_value_and_grad_interleaved_1f1b
from .moe import MOE_AXES, MoEConfig, _dense_init, init_moe_params, moe_ffn
from .optim import adamw
from .tree import tree_leaves, tree_map, tree_unflatten

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch dtype or its JSON name."""
    if isinstance(dtype, torch.dtype) and dtype in _DTYPES.values():
        return dtype
    if isinstance(dtype, str) and dtype in _DTYPES:
        return _DTYPES[dtype]
    raise ValueError(f"unsupported model dtype {dtype!r}: use one of {sorted(_DTYPES)}")


@dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's config fields, so one JSON config serves both.
    `remat` and `remat_policy` apply to `forward` under grad mode (the
    train step); inference ignores them."""

    vocab: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_ff: int = 2048
    max_seq: int = 2048
    dtype: Any = torch.bfloat16
    rope_theta: float = 10000.0
    remat: bool = True
    remat_policy: str = ""
    use_flash: bool = True
    seq_axis: str = ""
    seq_axis_bound: bool = False
    seq_layout: str = "contiguous"
    moe: Optional[MoEConfig] = None
    n_kv_heads: int = 0
    head_dim_override: int = 0

    def __post_init__(self):
        object.__setattr__(self, "dtype", resolve_dtype(self.dtype))

    @property
    def head_dim(self) -> int:
        if self.head_dim_override:
            return self.head_dim_override
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be a multiple of n_heads")
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        kv = self.n_kv_heads or self.n_heads
        if self.n_heads % kv:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        return kv

    @property
    def moe_resolved(self) -> Optional[MoEConfig]:
        """`moe` with its per-expert d_ff filled in (0 means the dense
        layer's d_ff)."""
        if self.moe is None or self.moe.d_ff:
            return self.moe
        return replace(self.moe, d_ff=self.d_ff)


def check_supported(cfg: TransformerConfig) -> None:
    if cfg.moe is not None and not isinstance(cfg.moe, MoEConfig):
        raise TypeError(
            f"cfg.moe must be a models.moe.MoEConfig, not {type(cfg.moe).__name__}"
        )


def init_params(generator: Optional[torch.Generator], cfg: TransformerConfig,
                device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Truncated-normal init (+-2 std, std = fan_in**-0.5), stacked over
    layers. Drawn in f32 on the CPU from `generator` (a CPU
    torch.Generator; seed 0 when None), so a seed gives the same weights on
    every device, then moved to `device` in cfg.dtype."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    d, h, hd, f, L = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.n_layers

    def norm_init(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    def dense_init(shape, fan_in):
        return _dense_init(gen, shape, fan_in, cfg.dtype, dev)

    layers = {
        "attn_norm": norm_init((L, d)),
        "wqkv": dense_init((L, d, h + 2 * cfg.kv_heads, hd), d),
        "wo": dense_init((L, h, hd, d), d),
        "mlp_norm": norm_init((L, d)),
    }
    moe_cfg = cfg.moe_resolved
    if moe_cfg is not None:
        per_layer = [init_moe_params(gen, d, moe_cfg, cfg.dtype, dev) for _ in range(L)]
        layers.update({name: torch.stack([p[name] for p in per_layer]) for name in MOE_AXES})
    else:
        layers.update({
            "wi_gate": dense_init((L, d, f), d),
            "wi_up": dense_init((L, d, f), d),
            "wo_mlp": dense_init((L, f, d), f),
        })
    return {
        "embed": dense_init((cfg.vocab, d), d),
        "final_norm": norm_init((d,)),
        "unembed": dense_init((d, cfg.vocab), d),
        "layers": layers,
    }


def layer_view(params, layer: int) -> Dict[str, torch.Tensor]:
    """One layer's weights as views into the (L, ...) stack (no copy)."""
    return {name: t[layer] for name, t in params["layers"].items()}


# param name -> logical axes, the reference's (leading "layers" axis on the
# stacked per-layer params)
_LAYER_AXES: Dict[str, tuple] = {
    "attn_norm": ("layers", "norm"),
    "wqkv": ("layers", "embed", "heads", "head_dim"),
    "wo": ("layers", "heads", "head_dim", "embed"),
    "mlp_norm": ("layers", "norm"),
    "wi_gate": ("layers", "embed", "mlp"),
    "wi_up": ("layers", "embed", "mlp"),
    "wo_mlp": ("layers", "mlp", "embed"),
}
_TOP_AXES: Dict[str, tuple] = {
    # the input table's vocab dim is never cut: the forward gathers the
    # table whole before the lookup
    "embed": (None, "embed"),
    "final_norm": ("norm",),
    "unembed": ("embed", "vocab"),
}
# an MoE config's expert weights (the reference's models/moe.py MOE_AXES;
# its router is replicated)
_EXPERT_AXES: Dict[str, tuple] = {
    "we_gate": ("expert", "embed", "mlp"),
    "we_up": ("expert", "embed", "mlp"),
    "we_out": ("expert", "mlp", "embed"),
}
# per-layer weight -> its "embed" dim in one layer's view, which fsdp cuts
# and a layer gathers
_FSDP_DIM = {name: axes.index("embed") - 1 for name, axes in _LAYER_AXES.items() if "embed" in axes}


def _layer_axes(cfg: TransformerConfig) -> Dict[str, tuple]:
    axes = dict(_LAYER_AXES)
    if cfg.moe is not None:
        for name in ("wi_gate", "wi_up", "wo_mlp"):
            del axes[name]
        axes["router"] = ("layers", None, None)
        axes.update({name: ("layers",) + ax for name, ax in _EXPERT_AXES.items()})
    return axes


def param_specs(cfg: TransformerConfig, mesh=None) -> Dict[str, Any]:
    """The tree of specs (one entry per dim: None, a mesh axis or a tuple
    of them, trailing Nones dropped) matching init_params' structure: the
    reference's `param_specs` as tuples. Under GQA the fused QKV head axis
    (n_heads + 2*kv_heads) is replicated where tp does not divide it, as
    the reference does."""
    layers = {k: logical_to_spec(ax, mesh) for k, ax in _layer_axes(cfg).items()}
    if mesh is not None and cfg.kv_heads != cfg.n_heads:
        if (cfg.n_heads + 2 * cfg.kv_heads) % max(1, mesh.sizes["tp"]):
            spec = list(layers["wqkv"])
            spec[2] = None
            layers["wqkv"] = tuple(spec)
    top = {k: logical_to_spec(ax, mesh) for k, ax in _TOP_AXES.items()}
    return {**top, "layers": layers}


def _shared_kv(cfg: TransformerConfig, mesh) -> bool:
    """Whether a tp rank's q heads read kv heads that another rank's read
    too (kv_heads % tp != 0)."""
    return mesh is not None and cfg.kv_heads % mesh.sizes["tp"] != 0


def _rank_kv_heads(n_heads: int, kv_heads: int, tp: int, rank: int) -> list:
    """The kv heads tp rank `rank`'s q heads read, where tp does not divide
    kv_heads: one head when the rank's q heads all fall in one group (the
    group size a multiple of h/tp), else one per q head (repeated where
    two of them share it), so every rank has the same count."""
    group, local = n_heads // kv_heads, n_heads // tp
    heads = [(rank * local + i) // group for i in range(local)]
    return heads[:1] if group % local == 0 else heads


def param_placements(cfg: TransformerConfig, mesh) -> Dict[str, Any]:
    """`param_specs` as parallel.Placements: where tp cuts the fused QKV
    head axis, a rank's block is its own q, k and v heads (the segments
    n_heads, kv_heads, kv_heads, each cut over tp); where tp does not
    divide kv_heads, the fused axis is replicated over tp (each rank
    slices the heads it reads: `_rank_qkv`)."""
    specs = param_specs(cfg, mesh)
    out = {k: Placement(v) for k, v in specs.items() if k != "layers"}
    out["layers"] = {k: Placement(v) for k, v in specs["layers"].items()}
    wqkv = specs["layers"]["wqkv"]
    if len(wqkv) > 2 and wqkv[2] is not None:
        if _shared_kv(cfg, mesh):
            spec = wqkv[:2]
            while spec and spec[-1] is None:
                spec = spec[:-1]
            out["layers"]["wqkv"] = Placement(spec)
        else:
            out["layers"]["wqkv"] = Placement(wqkv, ((2, (cfg.n_heads, cfg.kv_heads, cfg.kv_heads)),))
    return out


def train_state_placements(cfg: TransformerConfig, mesh) -> Dict[str, Any]:
    """The placements of a train state {"params", "opt_state"} (AdamW's mu
    and nu as the params; its count replicated), for the sharded checkpoint
    (models.save_train_state, restore_train_state)."""
    params = param_placements(cfg, mesh)
    return {"params": params, "opt_state": {"count": Placement(), "mu": params, "nu": params}}


def check_mesh(mesh, cfg: TransformerConfig, what: str) -> None:
    """Raise for what the mesh path does not run: a width that its axis
    does not divide, or a live sp axis without cfg.seq_axis = "sp". A pp
    axis replicates the non-pipelined entry points over its ranks."""
    if mesh is None:
        return
    tp, fsdp, ep = mesh.sizes["tp"], mesh.sizes["fsdp"], mesh.sizes["ep"]
    widths = [("n_heads", cfg.n_heads, "tp", tp), ("vocab", cfg.vocab, "tp", tp),
              ("d_model", cfg.d_model, "fsdp", fsdp)]
    moe = cfg.moe_resolved
    if moe is None:
        widths.append(("d_ff", cfg.d_ff, "tp", tp))
    else:
        widths += [("the experts' d_ff", moe.d_ff, "tp", tp), ("n_experts", moe.n_experts, "ep", ep)]
    for name, n, axis, size in widths:
        if n % size:
            raise ValueError(f"{name}={n} does not split over {axis}={size}")
    if cfg.seq_axis not in ("", "sp"):
        raise ValueError(f"cfg.seq_axis {cfg.seq_axis!r}: the sequence shards over the mesh's sp axis")
    if mesh.sizes["sp"] > 1 and not cfg.seq_axis:
        raise ValueError('a mesh with sp > 1 shards the sequence: set cfg.seq_axis="sp" for ring attention')


def _groups(mesh):
    """(fsdp group, tp group) of a mesh; None for a dead axis or no mesh."""
    if mesh is None:
        return None, None
    return mesh.group("fsdp")[0], mesh.group("tp")[0]


def _local_cfg(cfg: TransformerConfig, mesh) -> TransformerConfig:
    """cfg with the widths of one tp rank's shard (its heads, the kv heads
    they read: kv_heads/tp, or `_rank_kv_heads`' count where tp does not
    divide kv_heads; d_ff; head_dim pinned), as the layer functions consume
    them. An MoE config keeps its experts' width (they run whole)."""
    tp = mesh.sizes["tp"] if mesh is not None else 1
    if tp == 1:
        return cfg
    kv = (len(_rank_kv_heads(cfg.n_heads, cfg.kv_heads, tp, 0)) if _shared_kv(cfg, mesh)
          else cfg.kv_heads // tp)
    return replace(cfg, n_heads=cfg.n_heads // tp, n_kv_heads=kv, d_ff=cfg.d_ff // tp,
                   head_dim_override=cfg.head_dim, moe=cfg.moe_resolved)


def _gathered(layer_params, names, cfg: TransformerConfig, mesh):
    """The layer's weights `names` gathered whole over fsdp (ZeRO-3: before
    use; the gradient is reduce-scattered back to the block). A weight
    whose embed dim is whole already (decode gathers its views once) is
    kept."""
    fsdp = _groups(mesh)[0]
    if fsdp is None:
        return layer_params
    out = dict(layer_params)
    for name in names:
        if layer_params[name].shape[_FSDP_DIM[name]] != cfg.d_model:
            out[name] = comm.gather_shards(layer_params[name], fsdp, _FSDP_DIM[name])
    return out


def _rank_qkv(w, cfg: TransformerConfig, mesh):
    """A layer's whole fused QKV weight (d, h + 2*kv, head_dim), replicated
    over tp where tp does not divide kv_heads, cut to the columns this tp
    rank reads: its q heads, then the kv heads they read (`_rank_kv_heads`)
    of k and of v. cfg has the rank's widths (`_local_cfg`). A slice's
    gradient is the rank's part of the leaf's, summed over tp later."""
    tp = mesh.sizes["tp"]
    local, h = cfg.n_heads, cfg.n_heads * tp
    kv = (w.shape[1] - h) // 2
    rank = mesh.index("tp")
    heads = _rank_kv_heads(h, kv, tp, rank)
    return torch.cat([w[:, rank * local:(rank + 1) * local]]
                     + [w[:, h + j:h + j + 1] for j in heads]
                     + [w[:, h + kv + j:h + kv + j + 1] for j in heads], dim=1)


def _row_parallel(a, w, cfg: TransformerConfig, tp):
    """a (..., k) @ w (k, n) for a row-parallel product over tp: each rank's
    partial product in f32, summed over tp, then cast to cfg.dtype."""
    return comm.tp_sum(matmul_f32(a, w), tp).to(cfg.dtype)


def _global_shapes(cfg: TransformerConfig) -> Dict[str, Any]:
    d, h, hd, f, L = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.n_layers
    layers = {"attn_norm": (L, d), "wqkv": (L, d, h + 2 * cfg.kv_heads, hd), "wo": (L, h, hd, d),
              "mlp_norm": (L, d)}
    moe = cfg.moe_resolved
    if moe is None:
        layers.update({"wi_gate": (L, d, f), "wi_up": (L, d, f), "wo_mlp": (L, f, d)})
    else:
        e, fe = moe.n_experts, moe.d_ff
        layers.update({"router": (L, d, e), "we_gate": (L, e, d, fe), "we_up": (L, e, d, fe),
                       "we_out": (L, e, fe, d)})
    return {"embed": (cfg.vocab, d), "final_norm": (d,), "unembed": (d, cfg.vocab), "layers": layers}


def check_shards(params, cfg: TransformerConfig, mesh) -> None:
    """Raise unless every leaf has the shape of this rank's block (params
    from models.shard_params)."""
    want = tree_map(lambda shape, pl: pl.local_shape(shape, mesh.sizes), _global_shapes(cfg),
                    param_placements(cfg, mesh))
    got = tree_map(lambda _, t: tuple(t.shape), want, params)
    if got != want:
        raise ValueError(f"params are not this rank's blocks over the mesh {mesh.sizes} "
                         f"(models.shard_params cuts them): shapes {got}, want {want}")


def _attention(q, k, v, cfg: TransformerConfig, mesh=None):
    """Causal attention; GQA k/v are consumed natively. With cfg.seq_axis
    and a mesh, ring attention over the sp ranks in cfg.seq_layout,
    whatever use_flash says (its kernel path on CUDA tensors)."""
    if cfg.seq_axis and cfg.seq_axis_bound and mesh is None:
        # a pipeline stage's config (_pp_manual_layout): its ring runs on the
        # stage's mesh, on the sequence shards the stage was handed
        raise ValueError("cfg.seq_axis_bound: the stage's ring needs the stage's mesh")
    if cfg.seq_axis and mesh is not None:
        if cfg.seq_layout == "zigzag":
            return ring_attention_zigzag(q, k, v, mesh, axis_name=cfg.seq_axis)
        return ring_attention(q, k, v, mesh, axis_name=cfg.seq_axis, causal=True)
    if cfg.seq_layout == "zigzag":
        raise ValueError(
            'seq_layout="zigzag" requires a live ring (cfg.seq_axis set and '
            "a mesh passed to forward/loss_fn)"
        )
    if cfg.use_flash:
        return flash_attention(q, k, v, causal=True, device=q.device)
    return mha_reference(q, k, v, causal=True)


def layer_qkv(x, layer_params, positions, cfg: TransformerConfig, mesh=None):
    """Pre-norm, fused QKV projection, rope. Returns q (batch, seq, n_heads,
    head_dim) and k/v (batch, seq, kv_heads, head_dim). With a mesh, cfg
    has one tp rank's widths (_local_cfg) and the weights are its blocks:
    wqkv is gathered over fsdp and its input enters the tp shard."""
    tp = _groups(mesh)[1]
    layer_params = _gathered(layer_params, ("wqkv",), cfg, mesh)
    y = comm.tp_enter(rms_norm(x, layer_params["attn_norm"]), tp)
    w = layer_params["wqkv"]
    if w.shape[1] != cfg.n_heads + 2 * cfg.kv_heads:
        w = _rank_qkv(w, cfg, mesh)
    qkv = torch.einsum("bsd,dnh->bsnh", y, w)
    h, kv = cfg.n_heads, cfg.kv_heads
    q, k, v = qkv.split([h, kv, kv], dim=2)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def layer_post_attention(x, attn, layer_params, cfg: TransformerConfig, mesh=None,
                         replicated_batch: bool = False, ep_axis: str = ""):
    """Output projection + MLP (routed experts or dense SwiGLU). Returns
    (x, aux): aux is the layer's router aux loss (0-d f32) for MoE, and the
    Python float 0.0 for a dense layer (no device op). The dense SwiGLU
    uses the pre-concatenated `wi_fused` (d, 2f) when the view carries one
    (the decode fast path). With a mesh, as layer_qkv: the weights are
    gathered over fsdp, under tp wo and wo_mlp are row-parallel, and an
    MoE layer runs `moe_ffn(mesh=)` on its input replicated over tp
    (replicated_batch: x is the whole batch on every rank, as in decode),
    or with `ep_axis` (a pipeline stage: its tokens replicated over that
    axis, its expert stacks the rank's ep block) `_moe_ffn_manual`."""
    tp = _groups(mesh)[1]
    dense = ("wi_gate", "wi_up", "wo_mlp") if cfg.moe is None else ()
    layer_params = _gathered(layer_params, ("wo",) + dense, cfg, mesh)
    if tp is None:
        x = x + torch.einsum("bsnh,nhd->bsd", attn, layer_params["wo"])
    else:
        x = x + _row_parallel(attn.flatten(2), layer_params["wo"].flatten(0, 1), cfg, tp)
    if cfg.moe is not None:
        y = rms_norm(x, layer_params["mlp_norm"])
        if mesh is None:
            mlp_out, aux = moe_ffn(y, layer_params, cfg.moe_resolved)
        else:
            mlp_out, aux = moe_ffn(y, layer_params, cfg.moe_resolved, mesh, ep_axis, replicated_batch)
        return x + mlp_out, aux
    y = comm.tp_enter(rms_norm(x, layer_params["mlp_norm"]), tp)
    wi_fused = layer_params.get("wi_fused")
    if wi_fused is not None:
        gate, up = matmul_f32(y, wi_fused).chunk(2, dim=-1)
    else:
        gate = matmul_f32(y, layer_params["wi_gate"])
        up = matmul_f32(y, layer_params["wi_up"])
    act = (F.silu(gate) * up).to(cfg.dtype)
    if tp is None:
        return x + act @ layer_params["wo_mlp"], 0.0
    return x + _row_parallel(act, layer_params["wo_mlp"], cfg, tp), 0.0


def _layer(x, layer_params, positions, cfg: TransformerConfig, mesh=None, ep_axis: str = ""):
    """One pre-norm block. x: (batch, seq, d_model). Returns (x, aux), as
    layer_post_attention does."""
    q, k, v = layer_qkv(x, layer_params, positions, cfg, mesh)
    attn = _attention(q, k, v, cfg, mesh)
    return layer_post_attention(x, attn, layer_params, cfg, mesh, ep_axis=ep_axis)


_FLASH_OP = torch.ops.odh_kubeflow_tpu_torch.flash_fwd
# remat_policy -> the ops (overload packets) whose outputs the layer
# checkpoint saves; every other op of the layer is recomputed in the backward
_REMAT_SAVES = {
    # the flash op's (out, lse): the backward launches no forward kernel again
    "flash": frozenset({_FLASH_OP}),
    # "flash" plus the reference's "attn_out", which in the port is the flash
    # op's out itself: the same save set
    "attn": frozenset({_FLASH_OP}),
    # the counterpart of dots_with_no_batch_dims_saveable: the outputs of the
    # layer's matrix products (aten mm, bmm and addmm in every overload: the
    # einsum projections, the f32-output SwiGLU products, wo_mlp; for MoE the
    # router logits and the expert products); the flash op is not a product
    # and is recomputed
    "dots": frozenset({torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm}),
}


def _remat_context(cfg: TransformerConfig):
    """cfg.remat_policy as a `context_fn` for torch.utils.checkpoint (the
    counterpart of `_remat_policy`); "" saves nothing, so the backward
    recomputes the whole layer, the flash forward included.

    Under a ring (cfg.seq_axis with a mesh), `forward` checkpoints the two
    halves of the layer around the ring and leaves the ring out, under
    every policy: the ring's Function saves its inputs and (out, lse), so
    the backward runs neither the ring's forward kernels nor its
    exchanges again. (The reference's policies name the flash op's
    residuals, which its ring does not carry, so there the ring recomputes
    under every policy.)"""
    if cfg.remat_policy == "":
        return noop_context_fn
    saves = _REMAT_SAVES.get(cfg.remat_policy)
    if saves is None:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")

    def policy_fn(ctx, op, *args, **kwargs):
        if op.overloadpacket in saves:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return partial(create_selective_checkpoint_contexts, policy_fn)


def forward(params, tokens, cfg: TransformerConfig, mesh=None, positions=None,
            with_aux=False):
    """f32 logits (batch, seq, vocab) for next-token prediction. tokens:
    (batch, seq) integer tensor on the parameters' device; with a mesh,
    this rank's shard, whose positions default to the contiguous shard's
    global ones, params are this rank's blocks (models.shard_params), and
    under tp the logits are the rank's vocab block (batch, seq, vocab/tp).
    with_aux=True also returns the router aux loss summed over layers (0-d
    f32; zero for a dense config). Under grad mode with cfg.remat, each
    layer runs under torch.utils.checkpoint with the save set of
    cfg.remat_policy."""
    check_supported(cfg)
    check_mesh(mesh, cfg, "forward")
    if mesh is not None:
        check_shards(params, cfg, mesh)
    fsdp, tp = _groups(mesh)
    lcfg = _local_cfg(cfg, mesh)
    b, s = tokens.shape
    if positions is None:
        # a contiguous sequence shard starts at its global position
        offset = mesh.index("sp") * s if mesh is not None else 0
        positions = (offset + torch.arange(s, device=tokens.device)).expand(b, s)
    ring = bool(cfg.seq_axis) and mesh is not None
    body = partial(_layer, mesh=mesh)
    if cfg.remat and torch.is_grad_enabled():
        context_fn = _remat_context(cfg)
        # the layer draws no random numbers: no RNG state to restore
        remat = partial(checkpoint, use_reentrant=False, context_fn=context_fn,
                        preserve_rng_state=False)

        def body(x, layer_params, positions, cfg):
            if not ring:
                return remat(partial(_layer, mesh=mesh), x, layer_params, positions, cfg)
            q, k, v = remat(partial(layer_qkv, mesh=mesh), x, layer_params, positions, cfg)
            attn = _attention(q, k, v, cfg, mesh)
            return remat(partial(layer_post_attention, mesh=mesh), x, attn, layer_params, cfg)

    x = comm.gather_shards(params["embed"], fsdp, 1).to(cfg.dtype)[tokens]
    aux = 0.0
    for layer in range(cfg.n_layers):
        x, layer_aux = body(x, layer_view(params, layer), positions, lcfg)
        aux = aux + layer_aux
    x = comm.tp_enter(rms_norm(x, params["final_norm"]), tp)
    logits = matmul_f32(x, comm.gather_shards(params["unembed"], fsdp, 0))
    if with_aux:
        # a dense config's aux is the float 0.0: made on the device, since a
        # Python scalar copied to the card would sync the host
        return logits, aux if torch.is_tensor(aux) else logits.new_zeros(())
    return logits


def causal_ce(logits, targets, mask=None):
    """Cross-entropy -E[log p(target)] in lse form: logsumexp over the f32
    logits and a gather of the target logit, no log_softmax tensor. mask
    None means every position counts; otherwise the masked mean over
    max(sum(mask), 1)."""
    lse = torch.logsumexp(logits, dim=-1)
    tl = logits.gather(-1, targets[..., None].long())[..., 0]
    if mask is None:
        return -(tl - lse).mean()
    return -((tl - lse) * mask).sum() / mask.sum().clamp_min(1.0)


def next_token_ce(logits, tokens):
    """Next-token CE over full-shape logits by roll and mask: position i's
    target is token i+1, and the last position (whose rolled target is token
    0, a fabricated label) is masked, so the mean runs over b*(s-1) terms
    without slicing the (b, s, vocab) logits."""
    b, s = tokens.shape
    targets = torch.roll(tokens, -1, dims=1)
    mask = (torch.arange(s, device=tokens.device) < s - 1).to(logits.dtype)
    return causal_ce(logits, targets, mask.expand(b, s))


def loss_fn(params, batch, cfg: TransformerConfig, mesh=None):
    """Causal LM cross-entropy, plus router_aux_weight times the mean
    per-layer router aux loss for an MoE config. batch: {"tokens": (b, s)}
    with optional "positions", and optional "targets" with an optional
    "loss_mask". With a mesh, batch is this rank's shard and the loss is
    the global batch's on every rank (see `_sharded_loss`)."""
    if mesh is not None:
        return _sharded_loss(params, batch, cfg, mesh)
    _check_targets(batch, cfg)
    tokens, targets = batch["tokens"], batch.get("targets")
    logits, aux = forward(params, tokens, cfg, positions=batch.get("positions"), with_aux=True)
    if targets is None:
        loss = next_token_ce(logits, tokens)
    else:
        loss = causal_ce(logits, targets, batch.get("loss_mask"))
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux / cfg.n_layers
    return loss


class _GlobalValue(torch.autograd.Function):
    """Returns `value` (the same bits on every rank) while the gradient
    flows to `local`, the rank's differentiable share of it."""

    @staticmethod
    def forward(ctx, local, value):
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _next_token_targets(tokens, mesh, cfg: TransformerConfig):
    """(targets, mask) of a contiguous sequence shard, as the reference's
    global roll gives them: position i's label is token i+1, so the last
    column's labels are the first tokens of the next sp shard, which each
    rank receives from it over the sp ring (one reversed shift of a (b, 1)
    column). The last shard receives the first shard's, the roll's
    wrap-around, and masks them as the reference masks its last position."""
    b, s = tokens.shape
    ring = comm.Ring(mesh, cfg.seq_axis or "sp")
    nxt = comm.shift(ring, [tokens[:, :1]], reverse=True)[0]
    targets = torch.cat([tokens[:, 1:], nxt], dim=1)
    last = ring.index == ring.size - 1
    mask = (torch.arange(s, device=tokens.device) < s - int(last)).float()
    return targets, mask.expand(b, s)


def _vocab_parallel_terms(logits, targets, tp, tp_index: int):
    """(lse, target logit) of each position from this tp rank's vocab block
    of the logits (batch, seq, vocab/tp), without gathering them: the max
    over tp (no gradient), then the sums of exponentials and the target
    logit (from the rank whose block holds it) summed over tp in f32."""
    width = logits.shape[-1]
    m = comm.all_reduce_max(logits.detach().amax(-1), tp)
    local = targets.long() - tp_index * width
    inside = (local >= 0) & (local < width)
    tl = logits.gather(-1, local.clamp(0, width - 1)[..., None])[..., 0]
    sums = comm.tp_sum(torch.stack([(logits - m[..., None]).exp().sum(-1),
                                    torch.where(inside, tl, torch.zeros_like(tl))]), tp, "vocab")
    return sums[0].log() + m, sums[1]


def _check_targets(batch, cfg: TransformerConfig) -> None:
    if batch.get("targets") is None and cfg.seq_layout == "zigzag":
        # rolling zigzag-ordered tokens gives storage-order successors: wrong
        # labels at every chunk boundary
        raise ValueError(
            'seq_layout="zigzag" needs explicit batch targets/loss_mask '
            "(models.make_zigzag_batch)"
        )


def _ce_terms(logits, targets, mask, mesh):
    """The rank's masked sum of log p(target) over its positions (the
    vocab shards' under tp), differentiable."""
    tp = _groups(mesh)[1]
    if tp is None:
        lse = torch.logsumexp(logits, dim=-1)
        tl = logits.gather(-1, targets[..., None].long())[..., 0]
    else:
        lse, tl = _vocab_parallel_terms(logits, targets, tp, mesh.index("tp"))
    return ((tl - lse) * mask).sum()


def _global_ce(logits, batch, cfg: TransformerConfig, mesh):
    """The global batch's masked-mean cross-entropy from this rank's
    logits (its vocab block under tp) of its shard of `batch`, as
    `_sharded_loss` takes it."""
    tokens, targets = batch["tokens"], batch.get("targets")
    if targets is None:
        targets, mask = _next_token_targets(tokens, mesh, cfg)
    else:
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(tokens.shape, device=logits.device)
    num = _ce_terms(logits, targets, mask, mesh)
    num_all, den_all = comm.all_reduce_sum([num.detach(), mask.sum()],
                                           mesh.group(REPLICA_AXES)[0])
    den = den_all.clamp_min(1.0)
    return _GlobalValue.apply(-num / den, -num_all / den)


def _sharded_loss(params, batch, cfg: TransformerConfig, mesh):
    """The global batch's masked-mean cross-entropy on this rank's shard:
    the masked sums of the rank's terms and its mask are summed over the
    data and sp ranks; the rank differentiates its own terms over the
    global count, so the gradients summed over those ranks are the global
    loss's, and every rank returns the global value. Under tp the terms
    come from the vocab shards (_vocab_parallel_terms), the same on every
    tp rank."""
    check_mesh(mesh, cfg, "loss_fn")
    _check_targets(batch, cfg)
    logits, aux = forward(params, batch["tokens"], cfg, mesh, positions=batch.get("positions"), with_aux=True)
    loss = _global_ce(logits, batch, cfg, mesh)
    if cfg.moe is not None:
        # the aux loss is the same on every rank; its gradient counts it
        # once over the ranks (models/moe.py)
        loss = loss + cfg.moe.router_aux_weight * aux / cfg.n_layers
    return loss


def make_zigzag_batch(tokens, sp: int):
    """The zigzag-ordered batch for cfg.seq_layout="zigzag": tokens
    permuted into zigzag storage order, next-token targets taken in natural
    order first (so chunk boundaries are right), per-token global
    positions, and a loss_mask zeroing the one fabricated label (natural
    position s-1's rolled target is token 0). With the mask, loss_fn
    equals the contiguous path's. tokens: (b, s) numpy array or tensor."""
    tokens = torch.as_tensor(tokens)
    b, s = tokens.shape
    perm = torch.as_tensor(zigzag_permutation(s, sp), device=tokens.device)
    targets = torch.roll(tokens, -1, dims=1)
    positions = perm[None, :].expand(b, s)
    return {
        "tokens": tokens[:, perm],
        "targets": targets[:, perm],
        "positions": positions,
        "loss_mask": (positions != s - 1).float(),
    }


def _leaf_names(tree) -> list:
    """The last key of each leaf's path, in tree_leaves order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in (_leaf_names(v) if isinstance(v, dict) else [k])]
    return [None]


def _sum_grads(grads, params, cfg: TransformerConfig, mesh, placements=None):
    """The global gradients of this rank's blocks: a leaf that fsdp cuts,
    already reduce-scattered over fsdp by its gather, is summed over dp and
    sp; every other leaf over dp, fsdp and sp (each group in f32 in one
    buffer; the leaf's dtype at the end). Before those: the router's, a
    partial sum on each ep rank (its own experts' gates; the aux loss's
    part counted 1/ep a rank), is summed over ep, and where tp does not
    divide kv_heads the replicated `wqkv`'s, a partial sum on each tp rank
    (its q heads and the kv heads they read), over tp. No other leaf is
    summed over tp or ep: a leaf cut over them has its own gradient on
    each rank (an expert stack gathered over tp has the same one on every
    tp rank, sliced), and a leaf replicated over them the same bits on
    each (its input's gradient was summed over tp and ep where it
    entered). `placements` (the pipeline's, `pp_param_placements`) replaces
    param_placements; there no leaf is summed over tp."""
    shared_kv = placements is None and _shared_kv(cfg, mesh)
    placements = tree_leaves(tree_map(lambda _, pl: pl, params, placements or param_placements(cfg, mesh)))
    names = _leaf_names(params)
    out = list(grads)

    def add(idx, group):
        if group is None or not idx:
            return
        for i, summed in zip(idx, comm.all_reduce_sum([out[i] for i in idx], group)):
            out[i] = summed

    if shared_kv:
        add([i for i, n in enumerate(names) if n == "wqkv"], mesh.group("tp")[0])
    add([i for i, n in enumerate(names) if n == "router"], mesh.group("ep")[0])
    for sharded, axes in ((True, DATA_SEQ_AXES), (False, REPLICA_AXES)):
        add([i for i, pl in enumerate(placements) if ("fsdp" in pl.axes()) == sharded], mesh.group(axes)[0])
    return [o.to(g.dtype) for o, g in zip(out, grads)]


def value_and_grad(params, batch, cfg: TransformerConfig, mesh=None):
    """(loss, gradients as a list in tree_leaves order), taken with
    respect to detached aliases of the params. With a mesh, the gradients
    are those of this rank's blocks of the global loss, summed as
    `_sum_grads` says: every rank that holds a block holds the same bits."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = loss_fn(live, batch, cfg, mesh)
        grads = torch.autograd.grad(loss, tree_leaves(live))
    if mesh is not None:
        grads = _sum_grads(grads, params, cfg, mesh)
    return loss.detach(), grads


def make_train_step(cfg: TransformerConfig, optimizer=None, mesh=None):
    """(step, optimizer) with step(params, opt_state, batch) -> (params,
    opt_state, loss). The default optimizer is `adamw()`, which matches the
    reference's optax.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1,
    mu_dtype=f32). Params and optimizer state are updated in place (the
    counterpart of the reference's buffer donation) and returned; loss is a
    0-d tensor on the params' device, not copied to the host. Gradients are
    taken with respect to detached aliases of the params, so the caller's
    tensors never require grad. With a mesh, params and optimizer state
    are this rank's blocks (models.shard_params; `opt.init` of them), batch
    is this rank's shard (parallel.shard_batch), and each rank updates its
    blocks with their global gradients (AdamW is elementwise: no exchange;
    its count is replicated)."""
    check_supported(cfg)
    check_mesh(mesh, cfg, "make_train_step")
    optimizer = optimizer or adamw()

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(params, batch, cfg, mesh)
        optimizer.update_(tree_unflatten(params, grads), opt_state, params)
        return params, opt_state, loss

    return step, optimizer


# ---------------------------------------------------------------------------
# Pipeline parallelism (the pp axis)
# ---------------------------------------------------------------------------


class _StageMesh:
    """The mesh as a pipeline stage's layers see it: fsdp dead (the
    stage's weights were gathered once for the step, `_pp_prepare`), tp
    live only where the stages run tensor parallelism (`_pp_manual_layout`),
    every other axis as the mesh has it (sp's ring, ep's experts)."""

    def __init__(self, mesh, tp_live: bool):
        # a mesh of sizes alone (as the spec functions take) has no rank
        self.mesh, self.rank = mesh, getattr(mesh, "rank", None)
        self.device, self.coords = getattr(mesh, "device", None), getattr(mesh, "coords", None)
        self.sizes = dict(mesh.sizes, fsdp=1, tp=mesh.sizes["tp"] if tp_live else 1)

    def live(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in AXES if a in axes and self.sizes[a] > 1)

    def group(self, axes):
        live = self.live(axes)
        return self.mesh.group(live) if live else (None, [self.rank])

    def index(self, axes) -> int:
        return axes_index(axes, self.coords, self.sizes)

    def size(self, axes) -> int:
        out = 1
        for a in self.live(axes):
            out *= self.sizes[a]
        return out


def _pp_manual_layout(cfg: TransformerConfig, mesh):
    """How tp, fsdp and sp compose inside the pipeline stages (the one
    source of truth for the pp functions, pp_param_specs and to_pp_params,
    as the reference's). Returns (tp_axis, gather_axes, cfg_stage):

    - tp_axis "tp" when the stages run tensor parallelism: tp divides
      n_heads, kv_heads and (dense) d_ff; cfg_stage then carries one tp
      rank's widths (`_local_cfg`), its wo and wo_mlp row-parallel. Else
      the stage compute is replicated over tp.
    - gather_axes: leaf -> its embed dim (after the stage dims) where the
      weight is stored fsdp-cut and gathered once per step (ZeRO: its
      gradient reduce-scattered once); the MoE experts are not (they keep
      their ep block).
    - cfg_stage.seq_axis_bound under a live sp axis: the stages get
      sequence shards and run the ring themselves."""
    sizes = mesh.sizes
    tp, fsdp, pp = sizes["tp"], sizes["fsdp"], sizes["pp"]
    tp_axis = ""
    if (pp > 1 and tp > 1 and cfg.n_heads % tp == 0 and cfg.kv_heads % tp == 0
            and (cfg.moe is not None or cfg.d_ff % tp == 0)):
        tp_axis = "tp"
    gather_axes = {}
    if pp > 1 and fsdp > 1 and cfg.d_model % fsdp == 0:
        gather_axes = {"wqkv": 1, "wo": 3}
        if cfg.moe is None:
            gather_axes.update({"wi_gate": 1, "wi_up": 1, "wo_mlp": 2})
    cfg_stage = _local_cfg(cfg, _StageMesh(mesh, bool(tp_axis)))
    if pp > 1 and cfg.seq_axis and sizes.get(cfg.seq_axis, 1) > 1:
        cfg_stage = replace(cfg_stage, seq_axis_bound=True)
    return tp_axis, gather_axes, cfg_stage


def _interleave_wqkv(wqkv, h: int, kv: int, tp: int):
    """Reorder the fused [q heads | k heads | v heads] axis (second-to-last)
    so each contiguous 1/tp slab is [q_r | k_r | v_r]: a tp block of the
    result holds its own heads of all three projections (the reference's
    layout for the pipeline stages)."""
    q, k, v = wqkv.split([h, kv, kv], dim=-2)
    parts = [torch.cat([q.chunk(tp, -2)[r], k.chunk(tp, -2)[r], v.chunk(tp, -2)[r]], dim=-2)
             for r in range(tp)]
    return torch.cat(parts, dim=-2)


def to_pp_params(params, n_stages: int, cfg: TransformerConfig = None, mesh=None, n_chunks: int = 1):
    """(L, ...)-stacked params -> the pipeline storage layout: layers (S,
    L/S, ...) (or (S, v, L/(S*v), ...) for n_chunks = v), everything else
    unchanged. With cfg and mesh, also the wqkv head interleave that
    stages running tp need (`_pp_manual_layout`): pass them whenever the
    mesh has a live tp axis."""
    layers = params["layers"]
    if cfg is not None and mesh is not None and _pp_manual_layout(cfg, mesh)[0]:
        layers = {**layers, "wqkv": _interleave_wqkv(layers["wqkv"], cfg.n_heads, cfg.kv_heads,
                                                     mesh.sizes["tp"])}
    return {**{k: v for k, v in params.items() if k != "layers"},
            "layers": stack_stages(layers, n_stages, n_chunks=n_chunks)}


def pp_param_specs(cfg: TransformerConfig, mesh, n_stages: int, n_chunks: int = 1):
    """param_specs for the pipeline layout, the reference's tuples: the
    per-layer leaves' leading stage dim cut over pp; inside a stage, dense
    weights cut their heads/mlp dim over tp (the stage's tensor-parallel
    block) and their embed dim over fsdp (gathered once per step), MoE
    expert stacks their expert dim over ep, norms and the router
    replicated; the interleaved layout has its chunk dim after pp.
    n_stages is the reference's argument (mesh's pp size)."""
    del n_stages
    base = param_specs(cfg, mesh)
    tp_axis, gather_axes, _ = _pp_manual_layout(cfg, mesh)
    tp = "tp" if tp_axis else None

    def fs(name):
        return "fsdp" if name in gather_axes else None

    manual = {
        "wqkv": ("pp", None, fs("wqkv"), tp, None),
        "wo": ("pp", None, tp, None, fs("wo")),
        "wi_gate": ("pp", None, fs("wi_gate"), tp),
        "wi_up": ("pp", None, fs("wi_up"), tp),
        "wo_mlp": ("pp", None, tp, fs("wo_mlp")),
    }

    def add_stage(name):
        if cfg.moe is not None and name in _EXPERT_AXES:
            out = ("pp", None, "ep")
        else:
            out = manual.get(name, ("pp",))
        return (out[0], None, *out[1:]) if n_chunks > 1 else out

    return {**{k: v for k, v in base.items() if k != "layers"},
            "layers": {k: add_stage(k) for k in base["layers"]}}


def pp_param_placements(cfg: TransformerConfig, mesh, n_chunks: int = 1) -> Dict[str, Any]:
    """pp_param_specs as parallel.Placements (the wqkv of a tp stage is
    interleaved already, so its blocks are plain cuts)."""
    specs = pp_param_specs(cfg, mesh, mesh.sizes["pp"], n_chunks)
    out = {k: Placement(v) for k, v in specs.items() if k != "layers"}
    out["layers"] = {k: Placement(v) for k, v in specs["layers"].items()}
    return out


def pp_train_state_placements(cfg: TransformerConfig, mesh, n_chunks: int = 1) -> Dict[str, Any]:
    """The placements of a pipeline train state {"params", "opt_state"}
    (AdamW's mu and nu as the params, its count replicated), for the
    sharded checkpoint."""
    params = pp_param_placements(cfg, mesh, n_chunks)
    return {"params": params, "opt_state": {"count": Placement(), "mu": params, "nu": params}}


def pp_chunks(params) -> int:
    """The layout of `params` (global or a rank's blocks): 0 for the plain
    (L, ...) stack, else the chunk count v of the pipeline layout ((S, L/S,
    ...) is v = 1, (S, v, Lg, ...) is v)."""
    ndim = params["layers"]["attn_norm"].dim()
    return 0 if ndim == 2 else 1 if ndim == 3 else params["layers"]["attn_norm"].shape[1]


def _check_pp_shards(params, cfg: TransformerConfig, mesh, n_chunks: int) -> None:
    S = mesh.sizes["pp"]
    shapes = _global_shapes(cfg)
    lead = (S,) if n_chunks == 1 else (S, n_chunks)
    shapes["layers"] = {n: lead + (sh[0] // (S * n_chunks),) + sh[1:] for n, sh in shapes["layers"].items()}
    want = tree_map(lambda shape, pl: pl.local_shape(shape, mesh.sizes), shapes,
                    pp_param_placements(cfg, mesh, n_chunks))
    got = tree_map(lambda _, t: tuple(t.shape), want, params)
    if got != want:
        raise ValueError(f"params are not this rank's pipeline blocks over the mesh {mesh.sizes} "
                         f"(to_pp_params, then models.shard_params): shapes {got}, want {want}")


def _pp_check(params, cfg: TransformerConfig, mesh, n_chunks: int) -> None:
    check_supported(cfg)
    check_mesh(mesh, cfg, "the pipeline")
    if mesh.sizes["pp"] < 2:
        # the reference runs its one stage inline there: the port's
        # non-pipelined entry points are that path
        raise ValueError("the pipeline needs pp > 1: run forward, loss_fn or make_train_step at pp == 1")
    if cfg.n_layers % (mesh.sizes["pp"] * n_chunks):
        raise ValueError(f"{cfg.n_layers} layers not divisible into {mesh.sizes['pp']} stages"
                         + (f" x {n_chunks} chunks" if n_chunks > 1 else ""))
    _check_pp_shards(params, cfg, mesh, n_chunks)


def _pp_positions(cfg: TransformerConfig, mesh, s: int, device) -> torch.Tensor:
    """(1, s) positions of a stage's sequence shard: the whole sequence,
    or under sp the shard's global positions from its sp index in either
    layout (zigzag: chunks r and 2*sp-1-r, back to back)."""
    ar = torch.arange(s, device=device)
    if not (cfg.seq_axis and mesh.sizes.get(cfg.seq_axis, 1) > 1):
        return ar[None]
    r, n = mesh.index(cfg.seq_axis), mesh.sizes[cfg.seq_axis]
    if cfg.seq_layout == "zigzag":
        c = s // 2
        return torch.cat([r * c + ar[:c], (2 * n - 1 - r) * c + ar[:c]])[None]
    return (r * s + ar)[None]


class _PPStep:
    """What one pipeline call needs on this rank: the stage layout, the
    stage function, the stage's weights gathered once over fsdp, and the
    transposes of those gathers for the gradients."""

    def __init__(self, params, cfg: TransformerConfig, mesh, n_chunks: int, s_local: int,
                 head_once: bool = False):
        # head_once: the head runs on the last stage only (1F1B), so its
        # gradients are summed over pp with the embedding's
        self.cfg, self.mesh, self.n_chunks, self.head_once = cfg, mesh, n_chunks, head_once
        self.tp_axis, gather_axes, self.cfg_stage = _pp_manual_layout(cfg, mesh)
        self.stage_mesh = _StageMesh(mesh, bool(self.tp_axis))
        self.fsdp, self.tp = _groups(mesh)
        lead = 2 if n_chunks > 1 else 1
        self.dims = {n: ax + lead for n, ax in gather_axes.items()}
        # the ZeRO gather, once per step (per pipeline call)
        self.stage = {n: comm.all_gather(t.detach(), self.fsdp, self.dims[n]) if n in self.dims else t.detach()
                      for n, t in params["layers"].items()}
        self.ep_axis = "ep" if cfg.moe is not None else ""
        self.positions = _pp_positions(cfg, mesh, s_local, mesh.device)
        self.stage_index = mesh.coords["pp"]
        self.first, self.last = self.stage_index == 0, self.stage_index == mesh.sizes["pp"] - 1

    def stage_fn(self, chunk, h):
        aux = 0.0
        for layer in range(next(iter(chunk.values())).shape[0]):
            h, a = _layer(h, {n: t[layer] for n, t in chunk.items()}, self.positions, self.cfg_stage,
                          self.stage_mesh, ep_axis=self.ep_axis)
            aux = aux + a
        return h, aux

    def embed(self, params, tokens):
        """(the gathered table as a leaf, the first stage's input x) on the
        first stage; (None, an empty tensor of x's shape) elsewhere."""
        b, s = tokens.shape
        if not self.first:
            return None, torch.empty((b, s, self.cfg.d_model), dtype=self.cfg.dtype, device=tokens.device)
        table = comm.all_gather(params["embed"].detach(), self.fsdp, 1).requires_grad_()
        with torch.enable_grad():
            return table, table.to(self.cfg.dtype)[tokens]

    def head_leaves(self, params):
        return [params["final_norm"].detach().requires_grad_(),
                comm.all_gather(params["unembed"].detach(), self.fsdp, 0).requires_grad_()]

    def logits(self, head, y):
        x = comm.tp_enter(rms_norm(y, head[0]), self.tp)
        return matmul_f32(x, head[1])

    def stage_grads(self, d_stage):
        """The stage's f32 gradients reduce-scattered over fsdp where the
        weights were gathered (the gather's transpose)."""
        return {n: comm.reduce_scatter(g, self.fsdp, self.dims[n]) if n in self.dims else g
                for n, g in d_stage.items()}

    def aux_seed(self, n_micro: int) -> float:
        """d loss / d (one visit's aux): router_aux_weight / n_layers over the
        microbatches and the data shards (the reference's mean over them),
        over ep too: every ep rank holds the same aux, and its gradients
        to the router and the tokens are summed over ep."""
        if self.cfg.moe is None:
            return 0.0
        return (self.cfg.moe.router_aux_weight / self.cfg.n_layers
                / (n_micro * self.mesh.size(REPLICA_AXES) * self.mesh.size("ep")))


def pp_forward(params, tokens, cfg: TransformerConfig, mesh, n_micro: int = 4, with_aux=False,
               n_chunks: int = 1):
    """Pipeline-parallel forward: f32 logits (batch, seq, vocab/tp) of this
    rank's shard of the batch (`shard_batch`), on every stage. params are
    this rank's blocks of the pipeline layout (`to_pp_params`, then
    `shard_params`). The embedding runs on the first stage, the
    microbatches stream through the stages (parallel/pipeline.py), and the
    final norm and unembedding run on every stage from the last stage's
    broadcast output, as the reference's replicate them over pp.

    Inside the stages (_pp_manual_layout): tp's column- and row-parallel
    products, the ZeRO gather of the stage's weights once per call, ep's
    experts (`_moe_ffn_manual` on the tokens of one microbatch: capacity
    from its token count, so at one capacity factor a pipelined MoE drops
    tokens at a tighter threshold than one process on the whole batch),
    and sp's ring. with_aux also returns the aux loss averaged over the
    microbatches (0-d f32). Runs without a graph."""
    _pp_check(params, cfg, mesh, n_chunks)
    run = _PPStep(params, cfg, mesh, n_chunks, tokens.shape[1])
    with torch.no_grad():
        _, x = run.embed(params, tokens)
        y, aux = pipeline_apply(run.stage_fn, run.stage, x, mesh, n_micro, with_aux=True, n_chunks=n_chunks,
                                seq_axis=cfg.seq_axis if run.cfg_stage.seq_axis_bound else "")
        logits = run.logits(run.head_leaves(params), y)
    if with_aux:
        return logits, aux / n_micro
    return logits


def pp_loss_fn(params, batch, cfg: TransformerConfig, mesh, n_micro: int = 4, n_chunks: int = 1):
    """The pipeline's loss (the reference's pp_loss_fn): the global batch's
    cross-entropy (explicit targets and loss_mask honoured; zigzag without
    targets raises), plus router_aux_weight times the aux over n_layers
    for MoE. The same value on every rank; no graph (its gradients:
    pp_value_and_grad)."""
    _check_targets(batch, cfg)
    logits, aux = pp_forward(params, batch["tokens"], cfg, mesh, n_micro, with_aux=True, n_chunks=n_chunks)
    loss = _global_ce(logits, batch, cfg, mesh)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux / cfg.n_layers
    return loss


def _pp_finish(params, cfg: TransformerConfig, mesh, run: _PPStep, table, x, dx, d_stage, pp_parts, d_head):
    """Every leaf's global gradient from this rank's parts: the embedding's
    from x's cotangent (first stage), reduce-scattered over fsdp; the
    stage's reduce-scattered where it was gathered; what one stage
    computed (the embedding's, in 1F1B the head's, and `pp_parts`, the
    loss and aux scalars) summed over pp in one exchange; then the sums
    over the data axes (`_sum_grads` on the pipeline's placements).
    Returns (the pp-summed scalars, the gradients in tree_leaves order)."""
    fsdp = run.fsdp
    if run.first:
        d_embed = comm.reduce_scatter(torch.autograd.grad(x, table, dx)[0], fsdp, 1)
    else:
        d_embed = torch.zeros(params["embed"].shape, device=params["embed"].device)
    d_final, d_unembed = d_head
    if d_unembed.shape != params["unembed"].shape:
        d_unembed = comm.reduce_scatter(d_unembed, fsdp, 0)
    summed = comm.all_reduce_sum([*pp_parts, d_embed, *([d_final, d_unembed] if run.head_once else [])],
                                 mesh.group("pp")[0], "pp_sum")
    scalars = summed[:len(pp_parts)]
    d_embed = summed[len(pp_parts)]
    if run.head_once:
        d_final, d_unembed = summed[len(pp_parts) + 1:]
    grads = {"embed": d_embed, "final_norm": d_final.float(), "unembed": d_unembed.float(),
             "layers": run.stage_grads(d_stage)}
    leaves = tree_leaves(tree_map(lambda _, g: g, params, grads))
    leaves = _sum_grads(leaves, params, cfg, mesh, pp_param_placements(cfg, mesh, run.n_chunks))
    return scalars, [g.to(p.dtype) for g, p in zip(leaves, tree_leaves(params))]


def pp_value_and_grad(params, batch, cfg: TransformerConfig, mesh, n_micro: int = 4, n_chunks: int = 1):
    """GPipe's (loss, gradients in tree_leaves order): the counterpart of
    the reference's jax.value_and_grad(pp_loss_fn). Every microbatch's
    stage graph is kept (O(n_micro) activations); the head runs on every
    stage from the broadcast output (as pp_loss_fn), the last stage seeds
    the backward, which runs microbatch by microbatch in reverse with
    explicit cotangent hops. The gradients are the global ones of this
    rank's blocks; the loss is the same on every rank."""
    _check_targets(batch, cfg)
    _pp_check(params, cfg, mesh, n_chunks)
    tokens = batch["tokens"]
    run = _PPStep(params, cfg, mesh, n_chunks, tokens.shape[1])
    table, x = run.embed(params, tokens)
    head = run.head_leaves(params)

    def head_fn(y):
        y = y.detach().requires_grad_()
        with torch.enable_grad():
            ce = _global_ce(run.logits(head, y), batch, cfg, mesh)
            grads = torch.autograd.grad(ce, head + [y])
        return (ce.detach(), grads[:2]), grads[2]

    (ce, d_head), aux, d_stage, dx = pipeline_value_and_grad_gpipe(
        run.stage_fn, head_fn, run.stage, x.detach(), mesh, n_micro, n_chunks=n_chunks,
        aux_seed=run.aux_seed(n_micro))
    (aux,), grads = _pp_finish(params, cfg, mesh, run, table, x, dx, d_stage, [aux], d_head)
    loss = ce
    if cfg.moe is not None:
        group = mesh.group(REPLICA_AXES)[0]
        aux = comm.all_reduce_sum([aux], group, "aux")[0] if group is not None else aux
        loss = loss + cfg.moe.router_aux_weight * aux / (cfg.n_layers * n_micro * mesh.size(REPLICA_AXES))
    return loss, grads


def pp_1f1b_value_and_grad(params, batch, cfg: TransformerConfig, mesh, n_micro: int = 4,
                           n_chunks: int = 1):
    """1F1B counterpart of pp_value_and_grad (the reference's
    pp_1f1b_value_and_grad): the same stage layout and loss, but each
    microbatch's backward runs right behind the last stage's forward, so a
    rank holds O(stages) stage inputs instead of O(n_micro) activations.
    The loss head (final norm, unembedding, next-token cross-entropy)
    runs on the last stage per microbatch; the embedding's gradient closes
    over the input's cotangent. n_chunks = v > 1 runs interleaved 1F1B
    (parallel/interleaved_1f1b.py) on the (S, v, L/(S*v), ...) layout.
    MoE: the aux loss's cotangent is the constant seed. A live sp axis and
    explicit targets raise NotImplementedError, as the reference's."""
    if cfg.seq_axis and mesh.sizes.get(cfg.seq_axis, 1) > 1:
        raise NotImplementedError(
            "sp inside pipeline stages is composed with the GPipe schedule "
            "only (pp_loss_fn); the 1F1B engines do not thread sequence "
            "shards through their backward buffers"
        )
    if "targets" in batch:
        raise NotImplementedError(
            "explicit batch targets/loss_mask are supported by the GPipe "
            "schedule only (pp_loss_fn); the 1F1B loss head computes "
            "next-token CE from tokens"
        )
    _pp_check(params, cfg, mesh, n_chunks)
    tokens = batch["tokens"]
    b, s = tokens.shape
    if b % n_micro:
        raise ValueError(f"per-data-shard batch {b} not divisible by n_micro {n_micro}")
    run = _PPStep(params, cfg, mesh, n_chunks, s, head_once=True)
    table, x = run.embed(params, tokens)
    head = run.head_leaves(params) if run.last else None
    mb = b // n_micro
    scale = 1.0 / (n_micro * mesh.size(REPLICA_AXES))
    mask = (torch.arange(s, device=tokens.device) < s - 1).float().expand(mb, s)

    def loss_head(i, y):
        tok = tokens[i * mb:(i + 1) * mb]
        y = y.detach().requires_grad_()
        with torch.enable_grad():
            num = _ce_terms(run.logits(head, y), torch.roll(tok, -1, dims=1), mask, mesh)
            loss = -num / mask.sum()
            grads = torch.autograd.grad(loss * scale, head + [y])
        return loss.detach(), grads

    engine = (pipeline_value_and_grad_interleaved_1f1b if n_chunks > 1 else pipeline_value_and_grad_1f1b)
    extra = (n_chunks,) if n_chunks > 1 else ()
    loss, aux, d_stage, d_head, dx, _ = engine(
        run.stage_fn, loss_head, run.stage, x.detach(), mesh, n_micro, *extra, aux_seed=run.aux_seed(n_micro))
    if d_head is None:
        d_head = [torch.zeros(params["final_norm"].shape, device=x.device),
                  torch.zeros(params["unembed"].shape, device=x.device)]
    (loss, aux), grads = _pp_finish(params, cfg, mesh, run, table, x, dx, d_stage, [loss, aux], d_head)
    group = mesh.group(REPLICA_AXES)[0]
    if group is not None:
        loss, aux = comm.all_reduce_sum([loss, aux], group)
    total = loss * scale
    if cfg.moe is not None:
        total = total + cfg.moe.router_aux_weight / cfg.n_layers * aux * scale
    return total, grads


def make_pp_train_step(cfg: TransformerConfig, mesh, n_micro: int = 4, optimizer=None,
                       schedule: str = "gpipe", n_chunks: int = 1):
    """Pipeline-parallel train step (step, optimizer), step(params,
    opt_state, batch) -> (params, opt_state, loss) on this rank's pipeline
    blocks and batch shard, updated in place as make_train_step's.
    schedule "gpipe" (pp_value_and_grad: O(n_micro) activations) or "1f1b"
    (pp_1f1b_value_and_grad: O(stages)); both take n_chunks = v > 1
    virtual stages (1f1b with chunks is Megatron's interleaved 1F1B). The
    default optimizer is `adamw()`."""
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    check_supported(cfg)
    check_mesh(mesh, cfg, "make_pp_train_step")
    optimizer = optimizer or adamw()
    vg = pp_1f1b_value_and_grad if schedule == "1f1b" else pp_value_and_grad

    def step(params, opt_state, batch):
        loss, grads = vg(params, batch, cfg, mesh, n_micro, n_chunks)
        optimizer.update_(tree_unflatten(params, grads), opt_state, params)
        return params, opt_state, loss

    return step, optimizer
