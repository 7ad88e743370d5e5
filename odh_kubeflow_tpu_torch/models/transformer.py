"""Flagship decoder-only transformer (counterpart of
odh_kubeflow_tpu/models/transformer.py), dense and single-device.

Parameters are plain dicts of tensors in the JAX package's layout, stacked
over layers: ``layers[name]`` is ``(L, ...)`` and the QKV projection is one
fused ``wqkv (L, d_model, n_heads + 2*kv_heads, head_dim)``, so weights
converted from the JAX tree (models/convert.py) drop in unchanged. Layers run
in a Python loop over per-layer views of the stack.

Rounding points follow the JAX package's ``preferred_element_type=f32``
contractions: a projection whose JAX result is cast to the model dtype is a
matmul in that dtype (f32 accumulate, one rounding at the output); one whose
JAX result stays f32 (SwiGLU gate/up, logits) goes through `_matmul_f32`.
"""
from __future__ import annotations

from dataclasses import dataclass
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
from ..ops import apply_rope, flash_attention, mha_reference, rms_norm
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
    moe: Optional[Any] = None
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


def check_supported(cfg: TransformerConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError("MoE layers (models/moe.py) are not ported yet")


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
        t = torch.empty(shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (t * (1.0 / fan_in) ** 0.5).to(device=dev, dtype=cfg.dtype)

    layers = {
        "attn_norm": norm_init((L, d)),
        "wqkv": dense_init((L, d, h + 2 * cfg.kv_heads, hd), d),
        "wo": dense_init((L, h, hd, d), d),
        "mlp_norm": norm_init((L, d)),
        "wi_gate": dense_init((L, d, f), d),
        "wi_up": dense_init((L, d, f), d),
        "wo_mlp": dense_init((L, f, d), f),
    }
    return {
        "embed": dense_init((cfg.vocab, d), d),
        "final_norm": norm_init((d,)),
        "unembed": dense_init((d, cfg.vocab), d),
        "layers": layers,
    }


def layer_view(params, layer: int) -> Dict[str, torch.Tensor]:
    """One layer's weights as views into the (L, ...) stack (no copy)."""
    return {name: t[layer] for name, t in params["layers"].items()}


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32:
        return x @ w.float()
    if x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


class _MatmulF32(torch.autograd.Function):
    """The gradient of `_mm_f32`. On a CUDA bf16 tensor the product is
    torch.mm(out_dtype=f32), whose aten op has no derivative; this Function
    gives both device branches the one backward, JAX's transpose of
    einsum(..., preferred_element_type=f32): the f32 cotangent contracts in
    f32 against the other operand and the result is cast to the operand's
    dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = (gy @ w.float().t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            x2 = x.reshape(-1, x.shape[-1]).float()
            gw = (x2.t() @ gy.reshape(-1, gy.shape[-1])).to(w.dtype)
        return gx, gw


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., k) @ w (k, n) accumulated in f32 and returned in f32, without
    the rounding to x's dtype a bf16 matmul makes at its output: the
    counterpart of einsum(..., preferred_element_type=f32)."""
    return _MatmulF32.apply(x, w)


def _attention(q, k, v, cfg: TransformerConfig):
    """Single-device causal attention; GQA k/v are consumed natively."""
    if cfg.seq_axis:
        raise NotImplementedError("ring attention over a sequence axis is not ported yet")
    if cfg.seq_layout == "zigzag":
        raise ValueError(
            'seq_layout="zigzag" requires a live ring (cfg.seq_axis set and '
            "a mesh passed to forward/loss_fn)"
        )
    if cfg.use_flash:
        return flash_attention(q, k, v, causal=True, device=q.device)
    return mha_reference(q, k, v, causal=True)


def layer_qkv(x, layer_params, positions, cfg: TransformerConfig):
    """Pre-norm, fused QKV projection, rope. Returns q (batch, seq, n_heads,
    head_dim) and k/v (batch, seq, kv_heads, head_dim)."""
    y = rms_norm(x, layer_params["attn_norm"])
    qkv = torch.einsum("bsd,dnh->bsnh", y, layer_params["wqkv"])
    h, kv = cfg.n_heads, cfg.kv_heads
    q, k, v = qkv.split([h, kv, kv], dim=2)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def layer_post_attention(x, attn, layer_params, cfg: TransformerConfig):
    """Output projection + dense SwiGLU. Uses the pre-concatenated
    `wi_fused` (d, 2f) when the view carries one (the decode fast path)."""
    x = x + torch.einsum("bsnh,nhd->bsd", attn, layer_params["wo"])
    y = rms_norm(x, layer_params["mlp_norm"])
    wi_fused = layer_params.get("wi_fused")
    if wi_fused is not None:
        gate, up = _matmul_f32(y, wi_fused).chunk(2, dim=-1)
    else:
        gate = _matmul_f32(y, layer_params["wi_gate"])
        up = _matmul_f32(y, layer_params["wi_up"])
    act = (F.silu(gate) * up).to(cfg.dtype)
    return x + act @ layer_params["wo_mlp"]


def _layer(x, layer_params, positions, cfg: TransformerConfig):
    """One pre-norm block. x: (batch, seq, d_model)."""
    q, k, v = layer_qkv(x, layer_params, positions, cfg)
    attn = _attention(q, k, v, cfg)
    return layer_post_attention(x, attn, layer_params, cfg)


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
    # einsum projections, the f32-output SwiGLU products, wo_mlp); the flash
    # op is not a product and is recomputed
    "dots": frozenset({torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm}),
}


def _remat_context(cfg: TransformerConfig):
    """cfg.remat_policy as a `context_fn` for torch.utils.checkpoint (the
    counterpart of `_remat_policy`); "" saves nothing, so the backward
    recomputes the whole layer, the flash forward included."""
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


def forward(params, tokens, cfg: TransformerConfig, mesh=None, positions=None):
    """f32 logits (batch, seq, vocab) for next-token prediction. tokens:
    (batch, seq) integer tensor on the parameters' device. Under grad mode
    with cfg.remat, each layer runs under torch.utils.checkpoint with the
    save set of cfg.remat_policy."""
    if mesh is not None:
        raise NotImplementedError("sharded forward over a mesh is not ported yet")
    check_supported(cfg)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    body = _layer
    if cfg.remat and torch.is_grad_enabled():
        context_fn = _remat_context(cfg)

        def body(x, layer_params, positions, cfg):
            # the layer draws no random numbers: no RNG state to restore
            return checkpoint(_layer, x, layer_params, positions, cfg, use_reentrant=False,
                              context_fn=context_fn, preserve_rng_state=False)

    x = params["embed"].to(cfg.dtype)[tokens]
    for layer in range(cfg.n_layers):
        x = body(x, layer_view(params, layer), positions, cfg)
    x = rms_norm(x, params["final_norm"])
    return _matmul_f32(x, params["unembed"])


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
    """Causal LM cross-entropy. batch: {"tokens": (b, s)} with optional
    "positions", and optional "targets" with an optional "loss_mask"."""
    if mesh is not None:
        raise NotImplementedError("sharded loss over a mesh is not ported yet")
    tokens = batch["tokens"]
    targets = batch.get("targets")
    if targets is None and cfg.seq_layout == "zigzag":
        # rolling zigzag-ordered tokens gives storage-order successors: wrong
        # labels at every chunk boundary
        raise ValueError(
            'seq_layout="zigzag" needs explicit batch targets/loss_mask '
            "(models.make_zigzag_batch)"
        )
    logits = forward(params, tokens, cfg, positions=batch.get("positions"))
    if targets is None:
        return next_token_ce(logits, tokens)
    return causal_ce(logits, targets, batch.get("loss_mask"))


def make_train_step(cfg: TransformerConfig, optimizer=None, mesh=None):
    """(step, optimizer) with step(params, opt_state, batch) -> (params,
    opt_state, loss). The default optimizer is `adamw()`, which matches the
    reference's optax.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1,
    mu_dtype=f32). Params and optimizer state are updated in place (the
    counterpart of the reference's buffer donation) and returned; loss is a
    0-d tensor on the params' device, not copied to the host. Gradients are
    taken with respect to detached aliases of the params, so the caller's
    tensors never require grad."""
    if mesh is not None:
        raise NotImplementedError("sharded train step over a mesh is not ported yet")
    check_supported(cfg)
    optimizer = optimizer or adamw()

    def step(params, opt_state, batch):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss = loss_fn(live, batch, cfg)
            grads = torch.autograd.grad(loss, tree_leaves(live))
        optimizer.update_(tree_unflatten(params, grads), opt_state, params)
        return params, opt_state, loss.detach()

    return step, optimizer
