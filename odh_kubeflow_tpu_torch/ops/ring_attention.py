"""Ring attention: exact attention over sequences sharded on a mesh axis
(counterpart of odh_kubeflow_tpu/ops/ring_attention.py).

Each rank holds a (batch, seq/sp) shard of Q and a GQA-width (batch, seq/sp,
kv_heads, head_dim) shard of K/V. K/V blocks travel around the ring of the
axis's ranks (parallel/comm.py; the reference's `lax.ppermute`) while every
rank folds each visiting block into a normalised (out, lse) carry.

The kernel path composes the port's flash kernels and adds none: the visit
from the rank's own shard is the causal kernel (the diagonal block), visits
from earlier shards the full kernel, and visits from later shards are
skipped (no launch, no merge: merging a fully masked block is the
identity). Blocks merge by log-sum-exp. The backward is a second ring
pass: with the global lse and delta = rowsum(dO * O), each visit's dq and
dk/dv come from the flash backward kernels directly (exact under
partitioned K); dq accumulates locally in f32 while the f32 dk/dv
accumulators ride the ring with their K/V shard and are home after the
full cycle. Delta and the dO layout copy are made once per ring backward.
Each exchange is posted before the block that does not need it, so the
transfer overlaps the kernel (`comm.shift_start`).

The reference path (`_ring_reference`, `_zz_pair` without the kernel) is
the reference's einsum math, differentiated by autograd through the
differentiable shift `comm.RingShift`. `use_kernel=None` takes the kernel
path on CUDA tensors and the reference path on CPU tensors; on the CPU the
kernel path runs the flash op's plain versions through the same code.

The zigzag layout balances the causal ring: with 2*sp equal chunks, rank r
holds [chunk r | chunk 2*sp-1-r], and every rank computes two chunk-units
per visit (`ring_balance_report`).

lse stays in the port's (batch, heads, seq) layout throughout.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..parallel.comm import Ring, RingShift, shift, shift_start
from .attention import NEG_INF, _tma_readable_dout, flash_attention, flash_bwd_dkv, flash_bwd_dq


# ---------------------------------------------------------------------------
# The causal schedule: which (q part, k part) pairs each visit computes
# ---------------------------------------------------------------------------


def _zz_pairs(src: int, my: int) -> List[Tuple[int, int, bool]]:
    """The live (q half, k half, causal) pairs when rank `my`'s zigzag
    shard [chunk my | chunk 2S-1-my] meets the K/V of rank `src`:
    qa-ka diagonal if src == my, full if src < my; qb-ka always full;
    qb-kb diagonal if src == my, full if src > my; qa-kb never."""
    pairs = []
    if src <= my:
        pairs.append((0, 0, src == my))
    pairs.append((1, 0, False))
    if src >= my:
        pairs.append((1, 1, src == my))
    return pairs


def ring_schedule(sp: int, layout: str = "contiguous") -> List[List[List[str]]]:
    """[rank][step] -> the kinds ("diag", "full") of the flash blocks the
    causal ring computes at that visit: one entry per kernel launch of the
    forward (and per dq and dk/dv launch of the backward). Step t brings
    rank my the K/V of rank (my - t) mod sp."""
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown layout {layout!r}")
    out = []
    for my in range(sp):
        row = []
        for step in range(sp):
            src = (my - step) % sp
            if layout == "contiguous":
                row.append(["diag"] if src == my else ["full"] if src < my else [])
            else:
                row.append(["diag" if causal else "full" for _, _, causal in _zz_pairs(src, my)])
        out.append(row)
    return out


def ring_launches(sp: int, layout: str = "contiguous") -> List[int]:
    """Flash forward launches per rank of one causal ring (and dq and dk/dv
    launches each of its backward): rank r + 1 for contiguous, 2*sp + 1 on
    every rank for zigzag."""
    return [sum(len(kinds) for kinds in row) for row in ring_schedule(sp, layout)]


def ring_balance_report(sp: int, layout: str = "contiguous") -> dict:
    """Static per-rank block-unit accounting of the causal ring, equal to
    the reference's. Unit = one full (chunk x chunk) block at chunk =
    seq/(2*sp); a diagonal block counts half. A contiguous shard pair is 2 x
    2 chunks (full 4, diagonal 2). Lockstep makes each step cost the
    busiest rank's units, so wall = sum over steps of the max, and
    balance_ratio = wall / (total / sp): ~2 contiguous, 1 zigzag."""
    units = {"contiguous": {"full": 4.0, "diag": 2.0}, "zigzag": {"full": 1.0, "diag": 0.5}}
    schedule = ring_schedule(sp, layout)
    per_rank = [[sum(units[layout][kind] for kind in kinds) for kinds in row] for row in schedule]
    totals = [sum(row) for row in per_rank]
    wall = sum(max(per_rank[r][t] for r in range(sp)) for t in range(sp))
    ideal = sum(totals) / sp
    return {
        "layout": layout,
        "sp": sp,
        "per_rank_units_per_step": per_rank,
        "per_rank_total_units": totals,
        "lockstep_wall_units": wall,
        "ideal_wall_units": ideal,
        "balance_ratio": wall / ideal,
    }


def zigzag_permutation(seq_len: int, sp: int) -> np.ndarray:
    """Natural-order positions in zigzag storage order: over ranks r, chunk
    r then chunk 2*sp-1-r (chunk = seq_len/(2*sp))."""
    chunk = seq_len // (2 * sp)
    if chunk * 2 * sp != seq_len:
        raise ValueError(f"seq_len {seq_len} not divisible by 2*sp={2*sp}")
    order = []
    for r in range(sp):
        order += list(range(r * chunk, (r + 1) * chunk))
        g = 2 * sp - 1 - r
        order += list(range(g * chunk, (g + 1) * chunk))
    return np.asarray(order)


# ---------------------------------------------------------------------------
# Reference path: GQA-native online-softmax einsums under autograd
# ---------------------------------------------------------------------------


def _local_block(q, k, v, q_off, k_off, causal, sm_scale):
    """One (local Q) x (visiting K/V) block: (m, l, acc) in f32, grouped
    (b, hk, g, sq, ...) layout; offsets are global positions."""
    b, sq, h, d = q.shape
    hk = k.shape[2]
    qg = q.reshape(b, sq, hk, h // hk, d).float()
    s = torch.einsum("bqkgd,bnkd->bkgqn", qg, k.float()) * sm_scale
    if causal:
        qpos = q_off + torch.arange(sq, device=q.device)
        kpos = k_off + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(~(qpos[:, None] >= kpos[None, :]), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgqn,bnkd->bkgqd", p, v.float())
    return m, l, acc


def _ring_reference(q, k, v, ring: Ring, causal: bool):
    size, my = ring.size, ring.index
    b, sq, h, d = q.shape
    hk = k.shape[2]
    g = h // hk
    sm_scale = d**-0.5
    m = torch.full((b, hk, g, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, hk, g, sq, 1), device=q.device)
    acc = torch.zeros((b, hk, g, sq, d), device=q.device)
    kc, vc = k, v
    for i in range(size):
        src = (my - i) % size
        bm, bl, bacc = _local_block(q, kc, vc, my * sq, src * kc.shape[1], causal, sm_scale)
        m_new = torch.maximum(m, bm)
        alpha, balpha = torch.exp(m - m_new), torch.exp(bm - m_new)
        m, l, acc = m_new, l * alpha + bl * balpha, acc * alpha + bacc * balpha
        # the last visiting block never moves again: sp - 1 transfers
        if i < size - 1:
            kc, vc = RingShift.apply(ring, kc, vc)
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel path: flash blocks + (out, lse) merge, a second ring pass backward
# ---------------------------------------------------------------------------


def _merge(out, lse, out_b, lse_b):
    """Fold a visiting block's normalised (out_b f32, lse_b (b, h, sq))
    into the carry."""
    m = torch.maximum(lse, lse_b)
    w = torch.exp(lse - m)
    wb = torch.exp(lse_b - m)
    denom = w + wb

    def rows(x):  # (b, h, sq) -> (b, sq, h, 1)
        return x.transpose(1, 2)[..., None]

    out = (out * rows(w) + out_b * rows(wb)) / rows(denom)
    return out, m + torch.log(denom)


def flash_block_with_lse(q, k, v, causal: bool):
    """Differentiable (out, lse) flash block, the building unit of ring
    compositions: out in q's dtype, lse (b, h, sq) f32. The flash op's
    backward folds the lse cotangent into delta, so merges of (out, lse)
    pairs differentiate exactly."""
    return flash_attention(q, k, v, causal=causal, with_lse=True, device=q.device)


def _block(q, k, v, causal):
    out, lse = flash_block_with_lse(q, k, v, causal)
    return out.float(), lse


def _backward_inputs(q, out, grad):
    """dO as the backward kernels read it (one layout copy at most, made
    here once rather than at every visit) and delta = rowsum(dO * O) in
    f32 (b, h, sq), from the global out."""
    dout = grad.to(q.dtype)
    if dout.is_cuda:
        dout = _tma_readable_dout(dout)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return dout, delta


def _ring_kernel_fwd_impl(q, k, v, ring: Ring, causal: bool):
    size, my = ring.size, ring.index
    # visit 0, the rank's own shard: the causal diagonal (or a full block)
    out, lse = _block(q, k, v, causal)
    pending = shift_start(ring, [k, v]) if size > 1 else None
    for i in range(1, size):
        kc, vc = pending.wait()
        if i < size - 1:
            pending = shift_start(ring, [kc, vc])
        src = (my - i) % size
        # earlier shard: the full block; later shard (causal): skipped
        if not causal or src < my:
            out, lse = _merge(out, lse, *_block(q, kc, vc, False))
    return out.to(q.dtype), lse


class _RingKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring, causal):
        out, lse = _ring_kernel_fwd_impl(q, k, v, ring, causal)
        ctx.ring, ctx.causal = ring, causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        ring, causal = ctx.ring, ctx.causal
        size, my = ring.size, ring.index
        dout, delta = _backward_inputs(q, out, grad)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        kc, vc = k, v
        for i in range(size):
            src = (my - i) % size
            pending = shift_start(ring, [kc, vc]) if i < size - 1 else None
            if not causal or src <= my:
                blk_causal = causal and src == my
                dq += flash_bwd_dq(q, kc, vc, dout, lse, delta, blk_causal).float()
                dk_b, dv_b = flash_bwd_dkv(q, kc, vc, dout, lse, delta, blk_causal)
                dk += dk_b.float()
                dv += dv_b.float()
            # the accumulators ride with their K/V shard: after sp shifts
            # each is home
            dk, dv = shift(ring, [dk, dv])
            if pending is not None:
                kc, vc = pending.wait()
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def _check_ring(q, k, v, zigzag: bool):
    if q.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] or q.shape[2] % k.shape[2]:
        raise ValueError(
            f"the ring takes local shards q (b, s, h, d) and k/v (b, s, hk, d) of one "
            f"length, h a multiple of hk; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if zigzag and q.shape[1] % 2:
        raise ValueError(f"a zigzag shard holds two equal chunks; local length {q.shape[1]} is odd")


def ring_attention(q, k, v, mesh, axis_name: str = "sp", causal: bool = True, use_kernel=None):
    """Attention over sequence shards on `mesh`'s `axis_name` ring. q is
    this rank's (batch, local_seq, heads, head_dim) shard and k/v its
    (batch, local_seq, kv_heads, head_dim) shards, in sequence order (rank
    i of the axis holds positions [i*local_seq, ...)). GQA runs natively.
    use_kernel None: the kernel path on CUDA tensors, the reference path
    on CPU tensors. The kernel path raises on a shape its kernels refuse."""
    use_kernel = q.is_cuda if use_kernel is None else use_kernel
    _check_ring(q, k, v, zigzag=False)
    ring = Ring(mesh, axis_name)
    if use_kernel:
        return _RingKernel.apply(q, k, v, ring, causal)
    return _ring_reference(q, k, v, ring, causal)


# ---------------------------------------------------------------------------
# Zigzag layout
# ---------------------------------------------------------------------------


def _zz_pair(q_half, k_half, v_half, blk_causal, use_kernel, q_off, k_off):
    """One (q chunk) x (k chunk) pair -> (out f32, lse (b, h, chunk)).
    Chunks are of one length, so a diagonal pair is the causal kernel;
    the offsets matter only on the reference path."""
    if use_kernel:
        return _block(q_half, k_half, v_half, blk_causal)
    b, sq, h, d = q_half.shape
    m, l, acc = _local_block(q_half, k_half, v_half, q_off, k_off, blk_causal, d**-0.5)
    l = l.clamp_min(1e-30)
    out = (acc / l).permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
    lse = (m + torch.log(l))[..., 0].reshape(b, h, sq)
    return out, lse


def _ring_zigzag_impl(q, k, v, ring: Ring, use_kernel: bool):
    """(out in q's dtype, lse_a, lse_b): the forward of both paths. The
    reference path shifts through RingShift (autograd); the kernel path
    runs under the Function's no-grad forward and overlaps each shift with
    the visit's blocks."""
    size, my = ring.size, ring.index
    b, sl, h, d = q.shape
    chunk = sl // 2
    qh = (q[:, :chunk], q[:, chunk:])
    q_ids = (my, 2 * size - 1 - my)
    carry = [(torch.zeros((b, chunk, h, d), device=q.device),
              torch.full((b, h, chunk), NEG_INF, device=q.device)) for _ in range(2)]
    kc, vc = k, v
    for i in range(size):
        src = (my - i) % size
        pending = shift_start(ring, [kc, vc]) if use_kernel and i < size - 1 else None
        k_ids = (src, 2 * size - 1 - src)
        for qi, kj, blk_causal in _zz_pairs(src, my):
            sl_k = slice(kj * chunk, (kj + 1) * chunk)
            pair = _zz_pair(qh[qi], kc[:, sl_k], vc[:, sl_k], blk_causal, use_kernel,
                            q_ids[qi] * chunk, k_ids[kj] * chunk)
            carry[qi] = _merge(*carry[qi], *pair)
        if i < size - 1:
            kc, vc = pending.wait() if pending is not None else RingShift.apply(ring, kc, vc)
    out = torch.cat([carry[0][0], carry[1][0]], dim=1).to(q.dtype)
    return out, carry[0][1], carry[1][1]


class _RingZigzagKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring):
        out, lse_a, lse_b = _ring_zigzag_impl(q, k, v, ring, True)
        ctx.ring = ring
        ctx.save_for_backward(q, k, v, out, torch.cat([lse_a, lse_b], dim=2))
        return out

    @staticmethod
    def backward(ctx, grad):
        """Second ring pass: per visit the forward's pairs, each running the
        flash backward kernels with the global per-half lse and delta."""
        q, k, v, out, lse = ctx.saved_tensors
        ring = ctx.ring
        size, my = ring.size, ring.index
        chunk = q.shape[1] // 2
        dout, delta = _backward_inputs(q, out, grad)
        halves = [slice(0, chunk), slice(chunk, 2 * chunk)]
        qh = [q[:, s] for s in halves]
        gh = [dout[:, s] for s in halves]
        lh = [lse[..., s].contiguous() for s in halves]
        dh = [delta[..., s].contiguous() for s in halves]
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        kc, vc = k, v
        for i in range(size):
            src = (my - i) % size
            pending = shift_start(ring, [kc, vc]) if i < size - 1 else None
            for qi, kj, blk_causal in _zz_pairs(src, my):
                ks = halves[kj]
                args = (qh[qi], kc[:, ks], vc[:, ks], gh[qi], lh[qi], dh[qi], blk_causal)
                dq[:, halves[qi]] += flash_bwd_dq(*args).float()
                dk_b, dv_b = flash_bwd_dkv(*args)
                dk[:, ks] += dk_b.float()
                dv[:, ks] += dv_b.float()
            dk, dv = shift(ring, [dk, dv])
            if pending is not None:
                kc, vc = pending.wait()
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def ring_attention_zigzag(q, k, v, mesh, axis_name: str = "sp", use_kernel=None):
    """Causal ring attention over zigzag-sharded sequences: the local shard
    is [chunk my | chunk 2S-1-my] (zigzag_permutation order). Exact and
    load-balanced. use_kernel as in ring_attention."""
    use_kernel = q.is_cuda if use_kernel is None else use_kernel
    _check_ring(q, k, v, zigzag=True)
    ring = Ring(mesh, axis_name)
    if use_kernel:
        return _RingZigzagKernel.apply(q, k, v, ring)
    return _ring_zigzag_impl(q, k, v, ring, False)[0]
