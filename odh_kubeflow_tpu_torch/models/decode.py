"""Autoregressive decoding with a KV cache (counterpart of
odh_kubeflow_tpu/models/decode.py).

`prefill` runs the prompt once through flash attention while recording
per-layer K/V; `decode_step` then attends one query token against the cache.
The cache is allocated at `max_seq` up front. Unlike the JAX package's
immutable arrays, caches here are updated in place: a token's K/V is written
into its position, which saves a cache copy per token. `decode_step`
therefore mutates and returns the cache it was given.

Decode attention is a plain contraction, not a kernel: a one-token query
reads the cache once and has no O(s^2) score matrix to avoid. It multiplies
f32 probabilities by the cache cast to f32, as the JAX package's mixed-dtype
einsum does (bf16 probabilities could flip greedy argmax on near-ties).

`generate` keeps the JAX package's loop layout: per-layer weight views taken
once with a dense layer's FFN halves concatenated into `wi_fused`, and
per-layer FLAT (kv_heads*batch, max_seq, head_dim) caches, kv-head-major.

An MoE layer routes the batch's tokens of each call together, as the JAX
package does: capacity comes from the call's token count, so a prompt, a
batch-1 `generate` step and an 8-slot engine burst each drop (or keep)
picks by their own count. The router's aux loss is dropped here.

`generate` runs inside the `models.generate` hot region (transfer budget
0): its tokens stay on the device, and under TORCHGUARD=1 a host sync
inside it raises (`utils/torchguard.py`).

`generate(mesh=)` runs tensor-parallel, as the reference's `generate` with
its `_cache_constrainer`: the params are this rank's blocks
(models.shard_params); each layer's fsdp blocks (and an MoE layer's expert
stacks, to their ep block) are gathered once before the token loop; q/k/v,
`wo` and the MLP are tp-parallel, the row-parallel sums in f32; the flat
cache holds the rank's kv heads only (kv_heads/tp * batch, kv-head-major),
so attention stays local (where tp does not divide kv_heads, each rank
caches the kv heads its q heads read, shared with the ranks that read them
too, as the reference leaves that cache unconstrained). The logits stay a
vocab block per rank: greedy picks take the vocab-parallel argmax, and
sampling draws the Gumbel noise over the whole vocab from the caller's
generator on every rank, each adding its own slice, so a seed gives the
one-process run's tokens. The prompt is not sharded: the ranks of dp,
fsdp, sp and ep repeat the same tokens, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..ops import matmul_f32, rms_norm
from ..parallel import comm
from ..utils import torchguard
from .moe import _expert_blocks
from .transformer import (
    _FSDP_DIM,
    TransformerConfig,
    _attention,
    _gathered,
    _groups,
    _local_cfg,
    _rank_qkv,
    _shared_kv,
    check_mesh,
    check_shards,
    check_supported,
    layer_post_attention,
    layer_qkv,
    layer_view,
)

NEG_INF = -1e30


@dataclass
class KVCache:
    """Per-layer stacked cache: k/v are (L, batch, max_seq, kv_heads,
    head_dim); `length` is the number of valid positions."""

    k: torch.Tensor
    v: torch.Tensor
    length: int


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               device: DeviceLike = "cuda") -> KVCache:
    # kv_heads, not n_heads: the GQA cache-size win lives here
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        length=0,
    )


def _layer_views(params, cfg: TransformerConfig, mesh=None) -> List[Dict[str, torch.Tensor]]:
    """Per-layer weight views, taken once; a dense layer's gate|up are
    concatenated into one (d, 2f) `wi_fused` so each token does one FFN-in
    matmul. With a mesh, the views hold what the rank's token step reads:
    the fsdp blocks gathered whole, the expert stacks gathered to the
    rank's ep block, and where tp does not divide kv_heads the rank's
    columns of the replicated `wqkv`."""
    lcfg = _local_cfg(cfg, mesh)
    views = []
    for layer in range(cfg.n_layers):
        lp = layer_view(params, layer)
        if mesh is not None:
            lp = _gathered(lp, [n for n in _FSDP_DIM if n in lp], cfg, mesh)
            if cfg.moe is not None:
                lp = _expert_blocks(lp, cfg.moe_resolved, mesh)
            if _shared_kv(cfg, mesh):
                lp["wqkv"] = _rank_qkv(lp["wqkv"], lcfg, mesh)
        if cfg.moe is None:
            lp["wi_fused"] = torch.cat([lp["wi_gate"], lp["wi_up"]], dim=-1)
        views.append(lp)
    return views


def _cached_attention(q, k_cache, v_cache, valid, cfg: TransformerConfig):
    """One query token against the cache. q: (b, 1, n_heads, head_dim);
    k/v_cache: (b, n, kv_heads, head_dim); valid: (n,) shared or (b, n) per
    row (the serving engine's slots sit at different lengths). Grouped
    attention directly against the kv_heads cache: no repeat."""
    b = q.shape[0]
    groups = cfg.n_heads // cfg.kv_heads
    qg = q.reshape(b, 1, cfg.kv_heads, groups, cfg.head_dim).float()
    scores = torch.einsum("bqcgd,bkcd->bcgqk", qg, k_cache.float()) * cfg.head_dim**-0.5
    scores = scores.masked_fill(~valid.reshape(-1, 1, 1, 1, valid.shape[-1]), NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    attn = torch.einsum("bcgqk,bkcd->bqcgd", probs, v_cache.float()).to(cfg.dtype)
    return attn.reshape(b, 1, cfg.n_heads, cfg.head_dim)


def _cached_attention_flat(q, k_cache, v_cache, valid, cfg: TransformerConfig):
    """_cached_attention against FLAT (kv_heads*batch, max_seq, head_dim)
    caches, kv-head-major: each (head, batch) slab is contiguous."""
    b = q.shape[0]
    c, groups = cfg.kv_heads, cfg.n_heads // cfg.kv_heads
    # (b, 1, h, hd) -> (c*b, g, hd); head j groups with kv head j//g
    qf = (
        q.reshape(b, c, groups, cfg.head_dim)
        .transpose(0, 1)
        .reshape(c * b, groups, cfg.head_dim)
    )
    scores = torch.bmm(qf.float(), k_cache.float().transpose(1, 2)) * cfg.head_dim**-0.5
    scores = scores.masked_fill(~valid[None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    attn = torch.bmm(probs, v_cache.float()).to(cfg.dtype)  # (c*b, g, hd)
    return (
        attn.reshape(c, b, groups, cfg.head_dim)
        .transpose(0, 1)
        .reshape(b, 1, cfg.n_heads, cfg.head_dim)
    )


def _decode_layer(h, layer_params, k_cache, v_cache, positions, valid, pos: int,
                  cfg: TransformerConfig, seq_major: bool = False, mesh=None):
    """One layer of single-token decode: QKV for the new token, in-place
    cache write at `pos`, grouped attention against the cache, projection +
    MLP. `seq_major` selects the flat generate() cache layout. With a mesh,
    cfg has the rank's widths and the views are `_layer_views`'."""
    q, k, v = layer_qkv(h, layer_params, positions, cfg, mesh)  # q: (b,1,h,hd)
    if seq_major:
        b = k.shape[0]
        # (b, 1, c, hd) -> kv-head-major (c*b, 1, hd)
        k_cache[:, pos:pos + 1] = k.permute(2, 0, 1, 3).reshape(cfg.kv_heads * b, 1, cfg.head_dim)
        v_cache[:, pos:pos + 1] = v.permute(2, 0, 1, 3).reshape(cfg.kv_heads * b, 1, cfg.head_dim)
        attn = _cached_attention_flat(q, k_cache, v_cache, valid, cfg)
    else:
        k_cache[:, pos:pos + 1] = k
        v_cache[:, pos:pos + 1] = v
        attn = _cached_attention(q, k_cache, v_cache, valid, cfg)
    x, _ = layer_post_attention(h, attn, layer_params, cfg, mesh, replicated_batch=True)
    return x, k_cache, v_cache


def _whole_tables(params, mesh):
    """(embedding table, unembedding) gathered whole over fsdp (the
    unembedding stays the rank's vocab block under tp)."""
    fsdp = _groups(mesh)[0]
    return (comm.gather_shards(params["embed"], fsdp, 1),
            comm.gather_shards(params["unembed"], fsdp, 0))


def _prompt_scan(params, tokens: torch.Tensor, cfg: TransformerConfig, mesh=None):
    """Shared prompt forward: last-position f32 logits (b, vocab) plus each
    layer's K/V, (b, s, kv_heads, head_dim). Flash attention does the
    O(s^2) work. With a mesh: the rank's vocab block of the logits and its
    kv heads (cfg's widths stay global; the layers run the rank's)."""
    check_supported(cfg)
    # inference prompts are natural-order on one device: plain contiguous
    # causal attention is right even for models trained sequence-sharded
    cfg = _local_cfg(replace(cfg, seq_axis="", seq_layout="contiguous"), mesh)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    embed, unembed = _whole_tables(params, mesh)
    x = embed.to(cfg.dtype)[tokens]
    ks, vs = [], []
    for layer in range(cfg.n_layers):
        lp = layer_view(params, layer)
        q, k, v = layer_qkv(x, lp, positions, cfg, mesh)
        x = layer_post_attention(x, _attention(q, k, v, cfg), lp, cfg, mesh, replicated_batch=True)[0]
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["final_norm"])
    return matmul_f32(x[:, -1], unembed), ks, vs


def prefill(params, tokens: torch.Tensor, cfg: TransformerConfig,
            max_seq: int) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt, returning last-position logits and the primed cache.
    tokens: (batch, prompt_len) on the parameters' device; prompt_len <=
    max_seq."""
    b, s = tokens.shape
    if s > max_seq:
        raise ValueError(f"prompt ({s}) exceeds cache max_seq ({max_seq})")
    logits, ks, vs = _prompt_scan(params, tokens, cfg)
    cache = init_cache(cfg, b, max_seq, device=tokens.device)
    for layer in range(cfg.n_layers):
        cache.k[layer, :, :s] = ks[layer]
        cache.v[layer, :, :s] = vs[layer]
    cache.length = s
    return logits, cache


def decode_step(params, cache: KVCache, token: torch.Tensor,
                cfg: TransformerConfig) -> Tuple[torch.Tensor, KVCache]:
    """One token for the whole batch: token (batch,) at position
    cache.length. Returns next-token logits (batch, vocab) and the cache,
    updated in place."""
    b = token.shape[0]
    pos = cache.length
    max_seq = cache.k.shape[2]
    if pos >= max_seq:
        raise ValueError(f"cache full: position {pos} is past max_seq ({max_seq})")
    positions = torch.full((b, 1), pos, dtype=torch.long, device=token.device)
    x = params["embed"].to(cfg.dtype)[token][:, None, :]  # (b, 1, d)
    valid = torch.arange(max_seq, device=token.device) <= pos
    for layer in range(cfg.n_layers):
        x, _, _ = _decode_layer(
            x, layer_view(params, layer), cache.k[layer], cache.v[layer],
            positions, valid, pos, cfg,
        )
    cache.length = pos + 1
    x = rms_norm(x, params["final_norm"])
    return matmul_f32(x[:, 0], params["unembed"]), cache


def _prefill_parts(params, tokens, cfg: TransformerConfig, max_seq: int, mesh=None):
    """Prompt forward returning last-position logits and per-layer FLAT
    (kv_heads*batch, max_seq, head_dim) cache buffers: the generate-loop
    layout (with a mesh, the rank's kv heads)."""
    b, s = tokens.shape
    logits, ks, vs = _prompt_scan(params, tokens, cfg, mesh)
    kv = ks[0].shape[2]
    shape = (kv * b, max_seq, cfg.head_dim)

    def flat(x):  # (b, s, c, d) -> (c*b, s, d)
        return x.permute(2, 0, 1, 3).reshape(kv * b, s, cfg.head_dim)

    caches = []
    for layer in range(cfg.n_layers):
        kc = torch.zeros(shape, dtype=cfg.dtype, device=tokens.device)
        vc = torch.zeros(shape, dtype=cfg.dtype, device=tokens.device)
        kc[:, :s] = flat(ks[layer])
        vc[:, :s] = flat(vs[layer])
        caches.append((kc, vc))
    return logits, caches


def generate(
    params,
    prompt,
    cfg: TransformerConfig,
    max_new: int,
    max_seq: int = 0,
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    mesh=None,
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """Greedy (temperature 0) or sampled generation: (batch, prompt_len) ->
    (batch, max_new) new tokens on `device`, where the parameters must lie.
    Sampling draws from `generator` (a torch.Generator on `device`; seed 0
    when None), so a seed repeats its tokens; it cannot reproduce
    jax.random's draws. It takes the Gumbel-max trick of
    jax.random.categorical: argmax of logits / temperature plus Gumbel
    noise. torch.multinomial would check its input on the host, a sync
    inside the models.generate region. With a mesh (this rank's device;
    params this rank's blocks), every rank of it calls generate with the
    same prompt and generator seed and returns the same tokens (the module
    docstring); a pp axis raises."""
    if mesh is not None:
        check_mesh(mesh, cfg, "generate")
        check_shards(params, cfg, mesh)
        device = mesh.device
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    b, s = prompt.shape
    if max_new <= 0:
        return torch.zeros((b, 0), dtype=torch.long, device=dev)
    max_seq = max_seq or (s + max_new)
    if s + max_new > max_seq:
        raise ValueError(
            f"prompt ({s}) + max_new ({max_new}) exceeds cache max_seq ({max_seq})"
        )
    sample = temperature > 0.0
    if sample and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    tp = _groups(mesh)[1]
    width = cfg.vocab // mesh.sizes["tp"] if mesh is not None else cfg.vocab
    offset = mesh.index("tp") * width if mesh is not None else 0

    def pick(step_logits):
        # step_logits: this rank's vocab block (the whole vocab off a mesh)
        if sample:
            u = torch.rand((b, cfg.vocab), generator=generator, device=dev)
            gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
            step_logits = step_logits / temperature + gumbel[:, offset:offset + width]
        return comm.vocab_argmax(step_logits, tp, offset)

    lcfg = _local_cfg(cfg, mesh)
    with torchguard.region("models.generate", dev):
        logits, caches = _prefill_parts(params, prompt, cfg, max_seq, mesh)
        layers = _layer_views(params, cfg, mesh)
        embed, unembed = _whole_tables(params, mesh)
        token = pick(logits)
        out = [token]
        for pos in range(s, s + max_new - 1):
            positions = torch.full((b, 1), pos, dtype=torch.long, device=dev)
            x = embed.to(cfg.dtype)[token][:, None, :]
            valid = torch.arange(max_seq, device=dev) <= pos
            for lp, (k_cache, v_cache) in zip(layers, caches):
                x, _, _ = _decode_layer(
                    x, lp, k_cache, v_cache, positions, valid, pos, lcfg, seq_major=True, mesh=mesh
                )
            x = rms_norm(x, params["final_norm"])
            token = pick(matmul_f32(x[:, 0], unembed))
            out.append(token)
        return torch.stack(out, dim=1)
