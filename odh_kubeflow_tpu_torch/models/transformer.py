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
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..ops import apply_rope, flash_attention, mha_reference, rms_norm

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
    Training-only fields (remat, remat_policy) are carried for that reason
    and read by nothing in the port yet."""

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


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., k) @ w (k, n) accumulated in f32 and returned in f32, without
    the rounding to x's dtype a bf16 matmul makes at its output."""
    if x.dtype == torch.float32:
        return x @ w.float()
    if x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


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


def forward(params, tokens, cfg: TransformerConfig, mesh=None, positions=None):
    """f32 logits (batch, seq, vocab) for next-token prediction. tokens:
    (batch, seq) integer tensor on the parameters' device."""
    if mesh is not None:
        raise NotImplementedError("sharded forward over a mesh is not ported yet")
    check_supported(cfg)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = params["embed"].to(cfg.dtype)[tokens]
    for layer in range(cfg.n_layers):
        x = _layer(x, layer_view(params, layer), positions, cfg)
    x = rms_norm(x, params["final_norm"])
    return _matmul_f32(x, params["unembed"])
