"""Pipeline parallelism over the `pp` mesh axis (counterpart of
odh_kubeflow_tpu/parallel/pipeline.py): GPipe, 1F1B and, with the
schedule tables of parallel/interleaved_1f1b.py, interleaved 1F1B.

The layer stack splits into S = mesh.sizes["pp"] stages (`stack_stages`):
each pp rank holds one stage's parameters, as the reference stores them
(the leading stage dim cut over pp; the interleaved layout holds v
non-adjacent chunks per rank, chunk c of rank r being layer group c*S + r).
Microbatches stream through the stages; stage r computes them in the
reference's order.

The reference runs every schedule as lockstep SPMD: every rank computes at
every step, fill and drain steps on masked garbage, and one `ppermute` per
direction moves a payload around the closed ring each step. Here each rank
runs only the (microbatch, chunk) visits that are real, in the reference's
order (the aux sums and the gradient accumulation follow it), and the
hops (`comm.pp_exchange`) carry only real payloads: down the open chain
r -> r+1, cotangents r+1 -> r, and across the wrap S-1 -> 0 only where an
interleaved chunk continues on the first stage. All sends and receives of
one step are posted together, so neighbours in opposite phases cannot
deadlock. The masked bubble compute of the reference changes no result.

- `pipeline_apply`: the forward (GPipe, or the interleaved GPipe order for
  n_chunks > 1): the last stage's output broadcast to every stage (the
  reference's psum of the masked value), and the aux summed over the
  stages and real microbatches.
- `pipeline_value_and_grad_gpipe`: GPipe for training. Every visit keeps
  its graph (O(n_micro) activations); the caller's head runs on the
  broadcast output on every stage and hands back the output's cotangent;
  the backward then runs visit by visit in the reverse of the forward
  order, with explicit cotangent hops: one `loss.backward()` through
  differentiable hops is not used, since ranks of different stages would
  reach their exchanges in different autograd orders.
- `pipeline_value_and_grad_1f1b`: 1F1B. The forward visits run without a
  graph and save only the stage input; a microbatch's backward follows as
  soon as the last stage has its loss (the loss head seeds its own
  backward in the same step), and recomputes the stage from the saved
  input: at most 2(S-1)+1 saved inputs per rank, whatever n_micro.
  `interleaved_1f1b.pipeline_value_and_grad_interleaved_1f1b` runs the same
  engine on Megatron's interleaved tables.

The engines return this rank's parts (its stage's gradients in f32 in the
storage layout, the loss and aux it accumulated, the head's gradients on
the stage that ran the head, the input's cotangent on the first stage):
the caller sums what one stage computed over the stages in one exchange
(the reference's psums over pp), with the data axes' sums. No correction
for the tensor- or expert-parallel axes is needed inside a stage: the
port's tp and ep collectives are Megatron's f/g pairs, whose gradients are
right as they stand (the reference divides or averages its vjp's
gradients over those axes because its local vjp transposes a psum into a
psum).
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from . import comm


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_stages(layer_params: Any, n_stages: int, n_chunks: int = 1) -> Any:
    """(L, ...)-stacked per-layer params -> the pipeline storage layout.
    n_chunks == 1: (S, L/S, ...), stage r holding the consecutive layer
    block r. n_chunks == v > 1 (interleaved, virtual stages): (S, v,
    L/(S*v), ...), where [r, c] is layer group c*S + r."""

    def reshape(p):
        L = p.shape[0]
        if L % (n_stages * n_chunks):
            raise ValueError(
                f"{L} layers not divisible into {n_stages} stages"
                + (f" x {n_chunks} chunks" if n_chunks > 1 else "")
            )
        if n_chunks == 1:
            return p.reshape(n_stages, L // n_stages, *p.shape[1:])
        lg = L // (n_stages * n_chunks)
        groups = p.reshape(n_stages * n_chunks, lg, *p.shape[1:])
        order = [c * n_stages + r for r in range(n_stages) for c in range(n_chunks)]
        return groups[order].reshape(n_stages, n_chunks, lg, *p.shape[1:])

    return _map(reshape, layer_params)


def _chunks_of(stage_params: Dict[str, torch.Tensor], n_chunks: int) -> List[Dict[str, torch.Tensor]]:
    """This rank's stage block (leaves (1, L/S, ...) or (1, v, Lg, ...))
    as a list of per-chunk views {name: (layers, ...)}."""
    if n_chunks == 1:
        return [{n: p[0] for n, p in stage_params.items()}]
    return [{n: p[0][c] for n, p in stage_params.items()} for c in range(n_chunks)]


def _storage(chunk_grads: List[Dict[str, torch.Tensor]], n_chunks: int) -> Dict[str, torch.Tensor]:
    """Per-chunk gradients back in the storage layout (leading 1, and the
    chunk dim when interleaved)."""
    if n_chunks == 1:
        return {n: g[None] for n, g in chunk_grads[0].items()}
    return {n: torch.stack([c[n] for c in chunk_grads])[None] for n in chunk_grads[0]}


def _check_batch(x: torch.Tensor, n_micro: int) -> None:
    if x.shape[0] % n_micro:
        raise ValueError(f"per-data-shard batch {x.shape[0]} not divisible by n_micro {n_micro}")


def _check_interleaved(n_stages: int, n_micro: int, n_chunks: int) -> None:
    if n_chunks > 1 and n_micro % n_stages:
        raise ValueError(
            f"interleaved schedule needs n_micro ({n_micro}) divisible by "
            f"the stage count ({n_stages})"
        )


class _Stages:
    """One rank's place in the pipeline: its stage r of S along the axis,
    the chunk count v and microbatch count m, where each visit's input
    comes from and its output goes, and the step exchanges."""

    def __init__(self, mesh, axis: str, n_micro: int, n_chunks: int):
        self.ranks = mesh.ranks(axis)
        self.S, self.r = len(self.ranks), mesh.coords[axis]
        self.group = mesh.group(axis)[0]
        self.device = mesh.device
        self.m, self.v = n_micro, n_chunks

    def injected(self, c: int) -> bool:
        """Whether this rank's visit of chunk c reads the input itself."""
        return self.r == 0 and c == 0

    def last(self, c: int) -> bool:
        """Whether chunk c of this rank is the last virtual stage."""
        return self.r == self.S - 1 and c == self.v - 1

    def consumer(self, r: int, c: int) -> Optional[Tuple[int, int]]:
        """(stage, chunk) that takes the output of chunk c on stage r."""
        if r < self.S - 1:
            return r + 1, c
        return (0, c + 1) if c < self.v - 1 else None

    def producer(self, r: int, c: int) -> Optional[Tuple[int, int]]:
        if r > 0:
            return r - 1, c
        return (self.S - 1, c - 1) if c > 0 else None

    def exchange(self, fwd_ops, bwd_ops, y, dx, shape, dtype):
        """The hops after one step. fwd_ops / bwd_ops: the (i, c) visit of
        every stage this step (None where it runs none); y and dx: this
        rank's output and input cotangent of its visits. Returns the
        arrivals {(i, c): tensor} for this rank's forward and backward
        visits to come."""
        sends, recvs, keys = [], [], []
        mine = fwd_ops[self.r]
        if mine is not None and not self.last(mine[1]):
            cons = self.consumer(self.r, mine[1])
            sends.append((self.ranks[cons[0]], comm.FWD_TAG, y))
        mine = bwd_ops[self.r]
        if mine is not None and not self.injected(mine[1]):
            prod = self.producer(self.r, mine[1])
            sends.append((self.ranks[prod[0]], comm.BWD_TAG, dx))
        for q in range(self.S):
            if q == self.r:
                continue
            if fwd_ops[q] is not None:
                i, c = fwd_ops[q]
                cons = self.consumer(q, c)
                if cons is not None and cons[0] == self.r:
                    recvs.append((self.ranks[q], comm.FWD_TAG, shape, dtype))
                    keys.append(("f", (i, cons[1])))
            if bwd_ops[q] is not None:
                i, c = bwd_ops[q]
                prod = self.producer(q, c)
                if prod is not None and prod[0] == self.r:
                    recvs.append((self.ranks[q], comm.BWD_TAG, shape, dtype))
                    keys.append(("b", (i, prod[1])))
        got = comm.pp_exchange(self.group, self.device, sends, recvs)
        fwd_in, bwd_in = {}, {}
        for (kind, key), t in zip(keys, got):
            (fwd_in if kind == "f" else bwd_in)[key] = t
        return fwd_in, bwd_in


def _fwd_order(k: int, S: int, v: int) -> Tuple[int, int]:
    """k-th forward visit of a rank -> (microbatch, chunk): Megatron's
    group-of-S sweep (S microbatches through a chunk, then the next chunk);
    (k, 0) when v == 1."""
    grp, p = divmod(k, S * v)
    return grp * S + p % S, p // S


def _gpipe_steps(S: int, v: int, m: int) -> List[List[Optional[Tuple[int, int]]]]:
    """The GPipe forward tables: at step t stage r runs its (t - r)-th
    visit (the reference's static unroll; the interleaved order for v >
    1)."""
    total = m * v
    return [[_fwd_order(t - r, S, v) if 0 <= t - r < total else None for r in range(S)]
            for t in range(total + S - 1)]


def _add(acc, aux):
    """acc + aux in f32 (aux a 0-d tensor, or the float 0.0 of a dense
    stage, which adds nothing and makes no device op)."""
    if not torch.is_tensor(aux):
        return acc
    return aux.detach().float() if acc is None else acc + aux.detach().float()


def _zero(acc, device) -> torch.Tensor:
    return acc if acc is not None else torch.zeros((), device=device)


def _live(chunks):
    return [{n: t.detach().requires_grad_() for n, t in ch.items()} for ch in chunks]


def _visit_grads(out, aux, leaves: Dict[str, torch.Tensor], inp, dy, aux_seed: float):
    """(parameter gradients {name: tensor or None}, input cotangent or None)
    of one visit's graph, seeded with the output's cotangent and the
    constant aux cotangent."""
    outputs, seeds = [out], [dy.to(out.dtype)]
    if aux_seed and torch.is_tensor(aux) and aux.requires_grad:
        outputs.append(aux)
        seeds.append(torch.full_like(aux, aux_seed))
    names = list(leaves)
    inputs = [leaves[n] for n in names] + ([inp] if inp.requires_grad else [])
    grads = torch.autograd.grad(outputs, inputs, seeds, allow_unused=True)
    dx = grads[len(names)] if inp.requires_grad else None
    return dict(zip(names, grads[:len(names)])), dx


def _accumulate(acc: Dict[str, Optional[torch.Tensor]], grads) -> None:
    for n, g in grads.items():
        if g is not None:
            acc[n] = g.float() if acc[n] is None else acc[n] + g.float()


def _finish(acc_chunks, chunks, n_chunks):
    out = [{n: (g if g is not None else torch.zeros(chunks[c][n].shape, device=chunks[c][n].device))
            for n, g in acc.items()} for c, acc in enumerate(acc_chunks)]
    return _storage(out, n_chunks)


def _gpipe_forward(st: _Stages, stage_fn, chunks, x, keep_graph: bool):
    """The GPipe forward visits of this rank (the reference's order), with
    their graphs when keep_graph. Returns (the last stage's outputs by
    microbatch (the last stage only), this rank's aux sum (f32 0-d), the
    visits' records {(i, c): (input, output, aux)})."""
    mb = x.shape[0] // st.m
    micros = x.split(mb)
    shape, dtype = (mb, *x.shape[1:]), x.dtype
    outputs, records, aux_acc, arrivals = {}, {}, None, {}
    for ops in _gpipe_steps(st.S, st.v, st.m):
        y = None
        if ops[st.r] is not None:
            i, c = ops[st.r]
            inp = micros[i] if st.injected(c) else arrivals.pop((i, c))
            if keep_graph:
                inp = inp.detach().requires_grad_()
            with torch.set_grad_enabled(keep_graph):
                out, aux = stage_fn(chunks[c], inp)
            aux_acc = _add(aux_acc, aux)
            if keep_graph:
                records[(i, c)] = (inp, out, aux)
            y = out.detach()
            if st.last(c):
                outputs[i] = y
        arrivals.update(st.exchange(ops, [None] * st.S, y, None, shape, dtype)[0])
    return outputs, _zero(aux_acc, x.device), records


def _broadcast_output(st: _Stages, outputs, x) -> torch.Tensor:
    """The last stage's output (its microbatches joined) on every stage."""
    y = torch.cat([outputs[i] for i in range(st.m)]) if st.r == st.S - 1 else torch.empty_like(x)
    return comm.broadcast(y, st.group, st.ranks[-1]) if st.S > 1 else y


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], Any],
    stage_params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    mesh,
    n_micro: int,
    axis: str = "pp",
    with_aux: bool = False,
    n_chunks: int = 1,
    seq_axis: str = "",
):
    """Run this rank's stage of the stage-stacked parameters as a
    microbatched pipeline (no graph: the forward, as the reference's
    pipeline_apply). stage_fn(chunk params {name: (layers, ...)}, x_micro)
    -> (y_micro, aux); stage_params: this rank's block, leaves (1, L/S,
    ...) or (1, v, Lg, ...); x: the first stage's input (batch, ...), this
    rank's data shard (sequence shard under sp); the other stages pass a
    tensor of its shape and dtype, which they do not read.

    n_chunks > 1 runs the interleaved (virtual-stage) order and needs
    n_micro divisible by the stage count. seq_axis (a live sp axis inside
    the stages: the stage runs the ring itself) composes with the GPipe
    order only. Returns the last stage's output on every stage (plus,
    with with_aux, the aux summed over stages and microbatches, averaged
    over the data axes and seq_axis)."""
    sizes = mesh.sizes
    _check_batch(x, n_micro)
    if seq_axis and sizes.get(seq_axis, 1) > 1 and n_chunks > 1:
        raise NotImplementedError(
            "sp inside pipeline stages is composed with the GPipe schedule "
            "only; the interleaved engine does not thread sequence shards"
        )
    if with_aux and seq_axis and sizes.get(seq_axis, 1) > 1:
        warnings.warn(
            "pipeline_apply(with_aux=True) under seq_axis sums per-shard "
            "router aux values (the per-shard routing approximation), not "
            "the full-sequence statistic; exact only for dense stacks "
            "(aux == 0). See parallel/pipeline.py aux notes.",
            stacklevel=2,
        )
    _check_interleaved(mesh.sizes[axis], n_micro, n_chunks)
    st = _Stages(mesh, axis, n_micro, n_chunks)
    with torch.no_grad():
        outputs, aux, _ = _gpipe_forward(st, stage_fn, _chunks_of(stage_params, n_chunks), x, False)
        y = _broadcast_output(st, outputs, x)
        if not with_aux:
            return y
        aux = comm.all_reduce_sum([aux], st.group, "pp_sum")[0]
        data = ("dp", "fsdp") + ((seq_axis,) if seq_axis else ())
        group = mesh.group(data)[0] if mesh.live(data) else None
        if group is not None:
            aux = comm.all_reduce_sum([aux], group, "aux")[0] / mesh.size(data)
    return y, aux


def pipeline_value_and_grad_gpipe(
    stage_fn: Callable[[Any, torch.Tensor], Any],
    head: Callable[[torch.Tensor], Tuple[Any, Optional[torch.Tensor]]],
    stage_params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    mesh,
    n_micro: int,
    axis: str = "pp",
    n_chunks: int = 1,
    aux_seed: float = 0.0,
):
    """GPipe for training: the forward visits with their graphs, the last
    stage's output broadcast to every stage, `head(y)` on every stage
    (the caller's: it takes its own gradients and returns (result, the
    cotangent of y), which only the last stage reads), then the backward
    visits in the reverse of the forward order, each seeded with its
    output's cotangent (the head's, or the next stage's hop) and the
    constant aux cotangent `aux_seed`.

    x: as in pipeline_apply; the first stage differentiates it. Returns
    (head's result, this rank's aux sum (f32 0-d), this rank's stage
    gradients in f32 in the storage layout, x's cotangent on the first
    stage (None elsewhere))."""
    _check_batch(x, n_micro)
    _check_interleaved(mesh.sizes[axis], n_micro, n_chunks)
    st = _Stages(mesh, axis, n_micro, n_chunks)
    chunks = _live(_chunks_of(stage_params, n_chunks))
    outputs, aux_acc, records = _gpipe_forward(st, stage_fn, chunks, x, True)
    result, dy = head(_broadcast_output(st, outputs, x))
    mb = x.shape[0] // st.m
    dy_micro = dy.split(mb) if st.r == st.S - 1 else None
    acc = [{n: None for n in ch} for ch in chunks]
    dx = [None] * st.m
    arrivals = {}
    for ops in reversed(_gpipe_steps(st.S, st.v, st.m)):
        g_in = None
        if ops[st.r] is not None:
            i, c = ops[st.r]
            inp, out, aux = records.pop((i, c))
            seed = dy_micro[i] if st.last(c) else arrivals.pop((i, c))
            grads, g_in = _visit_grads(out, aux, chunks[c], inp, seed, aux_seed)
            del out, aux
            _accumulate(acc[c], grads)
            if st.injected(c):
                dx[i] = g_in
        arrivals.update(st.exchange([None] * st.S, ops, None, g_in, (mb, *x.shape[1:]), x.dtype)[1])
    dx = torch.cat(dx) if st.r == 0 else None
    return result, aux_acc, _finish(acc, chunks, n_chunks), dx


def run_1f1b(
    st: _Stages,
    fwd_ops: List[List[Optional[Tuple[int, int]]]],
    bwd_ops: List[List[Optional[Tuple[int, int]]]],
    stage_fn,
    loss_head,
    stage_params,
    x: torch.Tensor,
    aux_seed: float,
):
    """The 1F1B engine over per-step tables (every stage's forward and
    backward visit at each step): the forward half (no graph; the input
    saved), the loss head on the last virtual stage (its loss, its
    parameters' gradients and the output's cotangent, for the backward
    visit of the same microbatch), the backward half (the stage recomputed
    from the saved input and differentiated), then the step's hops.
    loss_head(i, y) -> (loss, head gradients) takes its own gradients
    and returns y's cotangent as the last entry of its gradients.
    Returns (loss sum, aux sum, stage gradients (storage layout, f32),
    head gradient sums (the head's stage) or None, x's cotangent (first
    stage) or None, the most stage inputs held at once)."""
    chunks = _live(_chunks_of(stage_params, st.v))
    mb = x.shape[0] // st.m
    micros = x.split(mb)
    shape = (mb, *x.shape[1:])
    saved, dy_head, fwd_in, bwd_in = {}, {}, {}, {}
    acc = [{n: None for n in ch} for ch in chunks]
    dx = [None] * st.m
    loss_acc = aux_acc = d_head = None
    most = 0
    for f_ops, b_ops in zip(fwd_ops, bwd_ops):
        y = g_in = None
        if f_ops[st.r] is not None:
            i, c = f_ops[st.r]
            inp = micros[i].detach() if st.injected(c) else fwd_in.pop((i, c))
            with torch.no_grad():
                y, aux = stage_fn(chunks[c], inp)
            aux_acc = _add(aux_acc, aux)
            saved[(i, c)] = inp
            most = max(most, len(saved))
            if st.last(c):
                loss, grads = loss_head(i, y)
                loss_acc = loss if loss_acc is None else loss_acc + loss
                dy_head[i] = grads[-1]
                d_head = [g.float() for g in grads[:-1]] if d_head is None else [
                    a + g.float() for a, g in zip(d_head, grads[:-1])]
        if b_ops[st.r] is not None:
            i, c = b_ops[st.r]
            inp = saved.pop((i, c)).detach().requires_grad_()
            with torch.enable_grad():
                out, aux = stage_fn(chunks[c], inp)
                seed = dy_head.pop(i) if st.last(c) else bwd_in.pop((i, c))
                grads, g_in = _visit_grads(out, aux, chunks[c], inp, seed, aux_seed)
            del out, aux
            _accumulate(acc[c], grads)
            if st.injected(c):
                dx[i] = g_in
        f_in, b_in = st.exchange(f_ops, b_ops, y, g_in, shape, x.dtype)
        fwd_in.update(f_in)
        bwd_in.update(b_in)
    dx = torch.cat(dx) if st.r == 0 else None
    return (_zero(loss_acc, x.device), _zero(aux_acc, x.device), _finish(acc, chunks, st.v), d_head, dx,
            most)


def pipeline_value_and_grad_1f1b(
    stage_fn: Callable[[Any, torch.Tensor], Any],
    loss_head: Callable[[int, torch.Tensor], Tuple[torch.Tensor, List[torch.Tensor]]],
    stage_params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    mesh,
    n_micro: int,
    axis: str = "pp",
    aux_seed: float = 0.0,
):
    """1F1B: loss and gradients in one interleaved pass. Forward of
    microbatch i at step t = i + r on stage r, its backward at t = i +
    2(S-1) - r (on the last stage the same step as its forward: the head
    seeds it); the stage backward recomputes the stage from its saved
    input (activation checkpointing at stage boundaries), so at most
    2(S-1)+1 stage inputs are held per rank, independent of n_micro.
    GPipe holds every microbatch's activations until its backward wave.

    loss_head(i, y) runs on the last stage for microbatch i's output y:
    (loss, [head gradients..., y's cotangent]), seeded as the caller
    normalizes. Returns run_1f1b's tuple. pp must be > 1."""
    _check_batch(x, n_micro)
    st = _Stages(mesh, axis, n_micro, 1)
    if st.S == 1:
        raise ValueError("1F1B needs pp > 1; run the unpipelined path at pp == 1")
    S, m = st.S, n_micro
    T = m + 2 * (S - 1)
    fwd = [[(t - r, 0) if 0 <= t - r < m else None for r in range(S)] for t in range(T)]
    bwd = [[(t - 2 * (S - 1) + r, 0) if 0 <= t - 2 * (S - 1) + r < m else None for r in range(S)]
           for t in range(T)]
    return run_1f1b(st, fwd, bwd, stage_fn, loss_head, stage_params, x, aux_seed)
