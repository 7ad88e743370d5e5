"""The exchanges of the port's multi-process paths, over `torch.distributed`
process groups: a shift around a ring of ranks (the counterpart of
`lax.ppermute` over one mesh axis), a sum or max over a group (`lax.psum`,
`lax.pmax`), and the collectives of sharded params: an all-gather over fsdp
(ZeRO-3: a layer's weights gathered before use) whose gradient is a
reduce-scatter, and the tensor-parallel pair of autograd Functions, the
identity whose gradient is summed over tp (`tp_enter`, at each
column-parallel input) and the sum over tp whose gradient is the identity
(`tp_sum`, at each row-parallel output).

Each exchange packs its tensors into one byte payload (every tensor at a
16-byte aligned offset, so the unpacked views keep their alignment) and
posts the send and the receive together (`dist.batch_isend_irecv`): with
two ranks the next and the previous rank are one peer, and a send posted
alone would wait for a receive that is never posted.

The transport follows the group's backend and the tensor's device, never a
failure: NCCL moves CUDA tensors and gloo CPU tensors directly; gloo's
point-to-point ops read a tensor through its host pointer, so a CUDA
payload on a gloo group (ranks sharing one card, which NCCL refuses) is
copied to pinned host memory, sent, and copied back; every collective on a
CUDA tensor over gloo is staged so. That copy is explicit and counted: the
host waits for each staged payload before it sends it
(`exchange_counts["host_waits"]`).

The expert-parallel pair (`ep_enter`, `ep_sum`) is the tp pair over ep:
tokens are replicated over ep, each ep rank's experts give a partial
output, summed over ep (the reference's `lax.psum` inside its shard_map);
the output's cotangent is the same on every ep rank, so the sum's
gradient is the identity, and the tokens' gradient, partial on each ep
rank, is summed over ep where they enter. `gather_slices` joins blocks
that every rank then uses alike (the experts over tp): its gradient is
this rank's block of the gradient, sliced, not summed. `aux_mean` is the
mean of a per-rank scalar over a group whose gradient is scaled by the
caller (the MoE aux loss). `vocab_argmax` is the argmax over a
vocab-parallel row without gathering it.

`exchange_counts` counts each kind of exchange and its bytes: "ring" (the
payload this rank sends), "sum" (sums over the data axes: gradients and
the loss), "gather" (the gathered tensor), "scatter" (the f32 tensor
reduce-scattered), "tp_sum" (the tensor-parallel sums, forward and
backward), "vocab" (the vocab-parallel loss's max and sums over tp), "ep"
(the expert-parallel sums, forward and backward), "aux" (the aux loss's
mean), "argmax" (the vocab-parallel argmax's max and index), and the
pipeline's: "pp" (the stage hops: each activation this rank sends to the
next stage and each cotangent it sends back to the previous one),
"pp_bcast" (the last stage's output broadcast to every stage) and "pp_sum"
(sums over the stages: the loss, the aux loss and the gradients of the
leaves that one stage computes).

The stage hops (`pp_exchange`) carry only real payloads down the chain
(and across its wrap only where an interleaved chunk continues on the
first stage): the reference's `ppermute` moves a masked payload on every
link at every step. Every send and receive of one step of a schedule is
posted in one `batch_isend_irecv`, forward-direction ops before
backward-direction ones and each direction under its own tag, so two
neighbours in opposite phases (one sending an activation, the other a
cotangent) never wait on each other.
"""
from __future__ import annotations

import time
from typing import List, Sequence, Union

import torch
import torch.distributed as dist

from .mesh import Mesh

ALIGN = 16
STAGED = "gloo, staged through pinned host memory"
# the tensor collectives under their newer names where torch has them (the
# older names warn from torch 2.13 on); the same semantics
_all_gather_tensor = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_reduce_scatter_tensor = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)

KINDS = ("ring", "sum", "gather", "scatter", "tp_sum", "vocab", "ep", "aux", "argmax", "pp", "pp_bcast",
         "pp_sum")
# the tags of the stage hops: activations down the chain, cotangents back
FWD_TAG, BWD_TAG = 0, 1
# counts since the last reset_exchange_counts(): the exchanges of each kind
# and their bytes (`<kind>_bytes`), the host waits of staged transfers, and
# the host's seconds blocked in them: waiting for the device to hand over a
# staged payload (its queued work and the copy), and in the transfers
# themselves; and the host's seconds in the stage hops and the broadcast
# from the call to the return (a stage waiting there for its neighbour is
# in the pipeline's bubble)
exchange_counts = {**{k: 0 for kind in KINDS for k in (kind, kind + "_bytes")},
                   "host_waits": 0, "device_wait_s": 0.0, "transfer_s": 0.0, "pp_s": 0.0}


def reset_exchange_counts() -> None:
    for name in exchange_counts:
        exchange_counts[name] = type(exchange_counts[name])()


def transport(group, device: torch.device) -> str:
    """How a payload on `device` crosses `group`: "nccl", "gloo", or
    STAGED for a CUDA payload on a gloo group."""
    backend = str(dist.get_backend(group))
    if backend == "gloo" and torch.device(device).type == "cuda":
        return STAGED
    return backend


class Ring:
    """The ranks of a mesh axis (or of axes with a group) as a ring: this
    rank's index, and the global ranks of the next (index + 1) and
    previous (index - 1) one."""

    def __init__(self, mesh: Mesh, axis: Union[str, Sequence[str]]):
        self.group, self.ranks = mesh.group(axis)
        self.size = len(self.ranks)
        self.index = self.ranks.index(mesh.rank)
        self.next = self.ranks[(self.index + 1) % self.size]
        self.prev = self.ranks[(self.index - 1) % self.size]
        self.device = mesh.device

    def transport(self) -> str:
        return "none" if self.group is None else transport(self.group, self.device)


def _pack(tensors: Sequence[torch.Tensor]):
    """One uint8 payload of `tensors` and the (offset, dtype, shape) of each."""
    meta, offset = [], 0
    for t in tensors:
        meta.append((offset, t.dtype, tuple(t.shape)))
        offset += -(-t.numel() * t.element_size() // ALIGN) * ALIGN
    payload = torch.empty(offset, dtype=torch.uint8, device=tensors[0].device)
    for (start, _, _), t in zip(meta, tensors):
        n = t.numel() * t.element_size()
        payload[start:start + n].copy_(t.contiguous().view(-1).view(torch.uint8))
    return payload, meta


def _unpack(payload: torch.Tensor, meta) -> List[torch.Tensor]:
    out = []
    for start, dtype, shape in meta:
        n = int(torch.Size(shape).numel()) * torch.empty((), dtype=dtype).element_size()
        out.append(payload[start:start + n].view(dtype).view(shape))
    return out


class _Exchange:
    """A posted shift; wait() returns the received tensors."""

    def __init__(self, ring: Ring, tensors: Sequence[torch.Tensor], reverse: bool):
        self.ring, self.reverse = ring, reverse
        self.payload, self.meta = _pack(tensors)
        self.staged = transport(ring.group, self.payload.device) == STAGED
        self.event = None
        if self.staged:
            host = torch.empty(self.payload.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(self.payload, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
            self.payload = host
        _count("ring", self.payload.numel())
        self.works = None if self.staged else self._post()

    def _post(self):
        dst, src = ((self.ring.prev, self.ring.next) if self.reverse
                    else (self.ring.next, self.ring.prev))
        self.recv = torch.empty(self.payload.shape, dtype=torch.uint8, device=self.payload.device,
                                pin_memory=self.staged)
        return dist.batch_isend_irecv([
            dist.P2POp(dist.isend, self.payload, dst, self.ring.group),
            dist.P2POp(dist.irecv, self.recv, src, self.ring.group),
        ])

    def wait(self) -> List[torch.Tensor]:
        if self.staged:
            # the host waits for the device-to-host copy of the payload,
            # then sends it: the staged transport's one host wait
            _host_wait(self.event)
            self.works = self._post()
        t0 = time.perf_counter()
        for work in self.works:
            work.wait()
        exchange_counts["transfer_s"] += time.perf_counter() - t0
        recv = self.recv
        if self.staged:
            recv = torch.empty(recv.shape, dtype=torch.uint8, device=self.ring.device)
            recv.copy_(self.recv, non_blocking=True)
        return _unpack(recv, self.meta)


def _count(kind: str, nbytes: int) -> None:
    exchange_counts[kind] += 1
    exchange_counts[kind + "_bytes"] += int(nbytes)


def _host_wait(event) -> None:
    """The host waits for `event` (a staged payload's copy to host memory,
    queued behind the device's earlier work), counted."""
    t0 = time.perf_counter()
    event.synchronize()
    exchange_counts["host_waits"] += 1
    exchange_counts["device_wait_s"] += time.perf_counter() - t0


def shift_start(ring: Ring, tensors: Sequence[torch.Tensor], reverse: bool = False) -> _Exchange:
    """Post a shift of `tensors` one step around the ring: each rank sends
    to the next rank and receives from the previous one (reverse: the
    other way). The payload is taken now; the caller may compute while it
    travels and call wait() for the received tensors."""
    return _Exchange(ring, tensors, reverse)


def shift(ring: Ring, tensors: Sequence[torch.Tensor], reverse: bool = False) -> List[torch.Tensor]:
    if ring.size == 1:
        return list(tensors)
    return shift_start(ring, tensors, reverse).wait()


class RingShift(torch.autograd.Function):
    """A differentiable shift: the forward sends to the next rank and
    receives from the previous one; the backward shifts the gradients the
    other way, as `ppermute`'s transpose does."""

    @staticmethod
    def forward(ctx, ring, *tensors):
        ctx.ring = ring
        return tuple(shift(ring, tensors))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *shift(ctx.ring, grads, reverse=True))


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor, which the host waits for
    (counted): the staged transport's hand-over."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    _host_wait(event)
    return host


def _timed(fn, *args, **kwargs) -> None:
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    exchange_counts["transfer_s"] += time.perf_counter() - t0


def _reduce(t: torch.Tensor, group, op, kind: str) -> torch.Tensor:
    """All-reduce over `group` of a contiguous tensor the caller owns (it is
    reduced in place, or staged through pinned host memory for CUDA on
    gloo and returned anew)."""
    _count(kind, t.numel() * t.element_size())
    if transport(group, t.device) != STAGED:
        _timed(dist.all_reduce, t, op=op, group=group)
        return t
    host = _to_host(t)
    _timed(dist.all_reduce, host, op=op, group=group)
    return torch.empty_like(t).copy_(host, non_blocking=True)


def all_reduce_sum(tensors: Sequence[torch.Tensor], group, kind: str = "sum") -> List[torch.Tensor]:
    """The sum over `group` of each tensor, in f32, packed into one buffer
    (staged through pinned host memory for CUDA tensors on a gloo group).
    Every rank of the group receives the same bits. `group` None (a dead
    axis) returns the tensors as f32."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    if group is not None:
        flat = _reduce(flat, group, dist.ReduceOp.SUM, kind)
    parts = torch.split(flat, [t.numel() for t in tensors])
    return [p.view(t.shape) for p, t in zip(parts, tensors)]


def all_reduce_max(t: torch.Tensor, group, kind: str = "vocab") -> torch.Tensor:
    """The elementwise max over `group` (no gradient); `group` None returns
    `t`."""
    if group is None:
        return t
    return _reduce(t.detach().clone(memory_format=torch.contiguous_format), group,
                   dist.ReduceOp.MAX, kind)


def all_gather(t: torch.Tensor, group, dim: int = 0, kind: str = "gather") -> torch.Tensor:
    """The blocks of `group`'s ranks joined along `dim`, in their index
    order (the inverse of cutting `dim` into equal blocks); `group` None
    returns `t`."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    _count(kind, out.numel() * out.element_size())
    if transport(group, x.device) != STAGED:
        _timed(_all_gather_tensor, out, x, group=group)
    else:
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        _timed(_all_gather_tensor, host, _to_host(x), group=group)
        out.copy_(host, non_blocking=True)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0, kind: str = "scatter") -> torch.Tensor:
    """This rank's block along `dim` of the sum of `t` over `group`, summed
    in f32 and returned in f32 (the transpose of `all_gather`); `group`
    None returns `t` in f32."""
    if group is None:
        return t.float()
    n = dist.get_world_size(group)
    x = t.movedim(dim, 0).float().contiguous()
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=torch.float32, device=x.device)
    _count(kind, x.numel() * 4)
    if transport(group, x.device) != STAGED:
        _timed(_reduce_scatter_tensor, out, x, op=dist.ReduceOp.SUM, group=group)
    else:
        host = torch.empty(out.shape, dtype=torch.float32, pin_memory=True)
        _timed(_reduce_scatter_tensor, host, _to_host(x), op=dist.ReduceOp.SUM, group=group)
        out.copy_(host, non_blocking=True)
    return out.movedim(0, dim)


class GatherShards(torch.autograd.Function):
    """ZeRO-3's gather: the forward joins the group's blocks along `dim`
    (`all_gather`), the backward reduce-scatters the gradient of the whole
    tensor back to this rank's block (summed in f32, then cast to the
    block's dtype)."""

    @staticmethod
    def forward(ctx, block, group, dim):
        ctx.group, ctx.dim, ctx.dtype = group, dim, block.dtype
        return all_gather(block, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.group, ctx.dim).to(ctx.dtype), None, None


class TpEnter(torch.autograd.Function):
    """The identity at a column-parallel input (replicated over tp, or over
    ep at the experts' input); its gradient, a partial sum on each rank, is
    summed over the group in f32 and cast to the input's dtype (Megatron's
    f)."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum([grad], ctx.group, ctx.kind)[0].to(grad.dtype), None, None


class TpSum(torch.autograd.Function):
    """The sum over tp of partial results (a row-parallel product's, in
    f32; the vocab-parallel loss's sums); its gradient is the identity, as
    the sum's consumers are replicated over tp (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group, kind):
        return all_reduce_sum([x], group, kind)[0]

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def tp_enter(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else TpEnter.apply(x, group, "tp_sum")


def tp_sum(x: torch.Tensor, group, kind: str = "tp_sum") -> torch.Tensor:
    return x if group is None else TpSum.apply(x, group, kind)


def gather_shards(block: torch.Tensor, group, dim: int) -> torch.Tensor:
    return block if group is None else GatherShards.apply(block, group, dim)


def ep_enter(x: torch.Tensor, group) -> torch.Tensor:
    """The tokens entering the experts of an ep rank: the identity, whose
    gradient is summed over ep."""
    return x if group is None else TpEnter.apply(x, group, "ep")


def ep_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ep of the experts' partial outputs, in f32; its
    gradient is the identity."""
    return x.float() if group is None else TpSum.apply(x, group, "ep")


class GatherSlices(torch.autograd.Function):
    """The blocks of a group joined along `dim`, for ranks that then compute
    the same thing from the whole (the experts over tp): the gradient is
    the same on every rank of the group, and a rank's block of it is
    sliced out, with no exchange."""

    @staticmethod
    def forward(ctx, block, group, dim):
        ctx.dim, ctx.width = dim, block.shape[dim]
        ctx.index = dist.get_rank(group)
        return all_gather(block, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.width, ctx.width), None, None


def gather_slices(block: torch.Tensor, group, dim: int) -> torch.Tensor:
    return block if group is None else GatherSlices.apply(block, group, dim)


class AuxMean(torch.autograd.Function):
    """The mean over `group` of a 0-d f32 value (a sum in f32 over the
    group, then divided by its size); the gradient is `grad_scale` times
    the incoming one, with no exchange: the caller says how many ranks
    count the same term (each rank differentiates its own share)."""

    @staticmethod
    def forward(ctx, x, group, grad_scale):
        ctx.grad_scale = grad_scale
        if group is None:
            return x.float().clone()
        return all_reduce_sum([x], group, "aux")[0] / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.grad_scale, None, None


def aux_mean(x: torch.Tensor, group, grad_scale: float) -> torch.Tensor:
    return AuxMean.apply(x, group, grad_scale)


def vocab_argmax(logits: torch.Tensor, group, offset: int) -> torch.Tensor:
    """argmax over the last dim of a row cut into vocab blocks over `group`
    (this rank's block starts at global index `offset`), without gathering
    it: each rank's block maximum, the max over the group
    (`all_reduce_max`), then the lowest global index among the ranks that
    hold it, so ties go to the lowest index as `argmax`'s do. Returns int64
    global indices; `group` None is the plain argmax."""
    if group is None:
        return logits.argmax(dim=-1)
    value, index = logits.max(dim=-1)
    top = all_reduce_max(value, group, "argmax")
    lowest = torch.iinfo(torch.int64).min
    cand = torch.where(value == top, -(index + offset), torch.full_like(index, lowest))
    return -all_reduce_max(cand, group, "argmax")


def pp_exchange(group, device, sends, recvs) -> List[torch.Tensor]:
    """One step of a pipeline schedule's stage hops: `sends` is a list of
    (global rank, tag, tensor), `recvs` of (global rank, tag, shape,
    dtype); returns the received tensors on `device`, in `recvs` order.
    All of them are posted at once (forward tag first), so neighbours
    that send to each other in the same step cannot deadlock. CUDA
    tensors on a gloo group are staged through pinned host memory: the
    host waits once for the sends' copies (counted). Each send counts
    as one "pp" exchange of its bytes."""
    if not sends and not recvs:
        return []
    t_call = time.perf_counter()
    staged = transport(group, device) == STAGED
    payloads = []
    for peer, tag, t in sends:
        t = t.contiguous()
        _count("pp", t.numel() * t.element_size())
        if staged:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            t = host
        payloads.append((peer, tag, t))
    if staged and payloads:
        event = torch.cuda.Event()
        event.record()
        _host_wait(event)
    bufs = [(peer, tag, torch.empty(shape, dtype=dtype, device="cpu" if staged else device,
                                    pin_memory=staged))
            for peer, tag, shape, dtype in recvs]
    ops = []
    for tag in sorted({tag for _, tag, _ in payloads} | {tag for _, tag, _ in bufs}):
        ops += [dist.P2POp(dist.isend, t, peer, group, tag) for peer, tg, t in payloads if tg == tag]
        ops += [dist.P2POp(dist.irecv, t, peer, group, tag) for peer, tg, t in bufs if tg == tag]
    t0 = time.perf_counter()
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    exchange_counts["transfer_s"] += time.perf_counter() - t0
    if staged:
        bufs = [(peer, tag, torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t, non_blocking=True))
                for peer, tag, t in bufs]
    exchange_counts["pp_s"] += time.perf_counter() - t_call
    return [t for _, _, t in bufs]


def broadcast(t: torch.Tensor, group, src: int, kind: str = "pp_bcast") -> torch.Tensor:
    """`t` of global rank `src` on every rank of `group` (the other ranks
    pass a tensor of its shape and dtype to receive into, which they must
    not read before). Returns the tensor on `t`'s device; counted once of
    its bytes on every rank."""
    t_call = time.perf_counter()
    t = t.contiguous()
    _count(kind, t.numel() * t.element_size())
    if transport(group, t.device) != STAGED:
        _timed(dist.broadcast, t, src, group=group)
    else:
        host = _to_host(t) if dist.get_rank() == src else torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        _timed(dist.broadcast, host, src, group=group)
        t = torch.empty_like(t).copy_(host, non_blocking=True)
    exchange_counts["pp_s"] += time.perf_counter() - t_call
    return t

