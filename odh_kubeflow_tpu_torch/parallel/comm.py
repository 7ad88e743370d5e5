"""The exchanges of the port's multi-process paths: a shift around a ring of
ranks (the counterpart of `lax.ppermute` over one mesh axis) and a sum over
a group (`lax.psum`), over `torch.distributed` process groups.

Each exchange packs its tensors into one byte payload (every tensor at a
16-byte aligned offset, so the unpacked views keep their alignment) and
posts the send and the receive together (`dist.batch_isend_irecv`): with
two ranks the next and the previous rank are one peer, and a send posted
alone would wait for a receive that is never posted.

The transport follows the group's backend and the tensor's device, never a
failure: NCCL moves CUDA tensors and gloo CPU tensors directly; gloo's
point-to-point ops read a tensor through its host pointer, so a CUDA
payload on a gloo group (ranks sharing one card, which NCCL refuses) is
copied to pinned host memory, sent, and copied back. That copy is explicit
and counted: the host waits for each staged payload before it sends it
(`exchange_counts["host_waits"]`).
"""
from __future__ import annotations

import time
from typing import List, Sequence, Union

import torch
import torch.distributed as dist

from .mesh import Mesh

ALIGN = 16
STAGED = "gloo, staged through pinned host memory"

# counts since the last reset_exchange_counts(): ring exchanges and their
# payload bytes sent by this rank, sums and their bytes, the host waits of
# staged transfers, and the host's seconds blocked in them: waiting for the
# device to hand over a staged payload (its queued work and the copy), and
# in the transfers themselves
exchange_counts = {"exchanges": 0, "bytes": 0, "sums": 0, "sum_bytes": 0, "host_waits": 0,
                   "device_wait_s": 0.0, "transfer_s": 0.0}


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
        exchange_counts["exchanges"] += 1
        exchange_counts["bytes"] += self.payload.numel()
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


def all_reduce_sum(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The sum over `group` of each tensor, in f32, packed into one buffer
    (staged through pinned host memory for CUDA tensors on a gloo group).
    Every rank of the group receives the same bits. `group` None (a dead
    axis) returns the tensors as f32."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    if group is not None:
        exchange_counts["sums"] += 1
        exchange_counts["sum_bytes"] += flat.numel() * 4
        staged = transport(group, flat.device) == STAGED
        if staged:
            host = torch.empty(flat.shape, dtype=torch.float32, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            _host_wait(event)
        t0 = time.perf_counter()
        dist.all_reduce(host if staged else flat, group=group)
        exchange_counts["transfer_s"] += time.perf_counter() - t0
        if staged:
            flat = torch.empty_like(flat).copy_(host, non_blocking=True)
    parts = torch.split(flat, [t.numel() for t in tensors])
    return [p.view(t.shape) for p, t in zip(parts, tensors)]
