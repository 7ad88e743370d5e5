"""Interleaved 1F1B: Megatron's production pipeline schedule (counterpart
of odh_kubeflow_tpu/parallel/interleaved_1f1b.py).

Combines the virtual-stage layout (rank r holds v non-adjacent layer
chunks, chunk c = layer group c*S + r; the chain wraps from the last stage
to the first where a chunk continues) with the 1F1B property (a
microbatch's backward runs as soon as its last-virtual-stage forward lands,
bounding in-flight stage inputs at O(S*v), independent of n_micro).

The schedule is built in pure Python (`build_schedule`) as static tables,
per (step, rank): the (microbatch, chunk) of each half-step, and buffer
slots from a linear-scan allocator. The code of `Schedule`, `_bwd_order`,
`_SlotAlloc`, `build_schedule` and `validate_schedule` is the reference's
(`_fwd_order`, the interleaved GPipe order too, is parallel/pipeline.py's
copy of it), so the tables are equal field by field; dependencies, op
coverage and buffer bounds are asserted at build time. The engine
(`pipeline_value_and_grad_interleaved_1f1b`) is parallel/pipeline.py's
1F1B engine driven by the tables' forward and backward visits: each rank
runs only its real visits, in the tables' order, and keys what arrives by
(microbatch, chunk) instead of the slots (the slot tables size the
reference's lockstep buffers; here they bound the same counts).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .pipeline import _check_batch, _fwd_order, _Stages, run_1f1b

@dataclass
class Schedule:
    """Static interleaved-1F1B schedule over T paired steps for (S ranks,
    v chunks, m microbatches). All tables are (T, S) lists-of-lists of ints;
    each step holds at most one forward op and one backward op per rank.
    Slot tables are stored +1 with 0 meaning "none" (the engine maps 0 to
    the buffer's scratch slot)."""

    S: int
    v: int
    m: int
    T: int
    f_on: List[List[int]]      # 1 when this (step, rank) runs a forward op
    f_mb: List[List[int]]      # its microbatch (0 when off)
    f_chunk: List[List[int]]   # its chunk (0 when off)
    b_on: List[List[int]]      # 1 when this (step, rank) runs a backward op
    b_mb: List[List[int]]
    b_chunk: List[List[int]]
    in_w: List[List[int]]      # F: save stage input at this in_buf slot (+1)
    in_r: List[List[int]]      # B: read saved input from this in_buf slot (+1)
    recvf_w: List[List[int]]   # arrival store slot for the fwd carry (+1)
    recvf_r: List[List[int]]   # F: read activation from this recv slot (+1)
    recvb_w: List[List[int]]   # arrival store slot for the bwd carry (+1)
    recvb_r: List[List[int]]   # B: read cotangent from this recv slot (+1)
    dyh_w: List[List[int]]     # head F: store dy_head at this slot (+1)
    dyh_r: List[List[int]]     # last-vstage B: read dy_head from there (+1)
    in_width: int = 0
    recvf_width: int = 0
    recvb_width: int = 0
    dyh_width: int = 0
    # schedule quality, for reporting: fraction of per-rank half-slots idle
    bubble_fraction: float = 0.0


def _bwd_order(k: int, S: int, v: int) -> Tuple[int, int]:
    """k-th backward chunk-op: same sweep, chunks mirrored (last chunk
    drains first)."""
    grp, p = divmod(k, S * v)
    return grp * S + p % S, v - 1 - p // S


class _SlotAlloc:
    """Linear-scan buffer slot allocator; freed slots become reusable the
    NEXT step (a same-step write of a just-read slot would clobber under the
    engine's fixed store-then-compute order)."""

    def __init__(self):
        self.free: List[int] = []
        self.freed_at: Dict[int, int] = {}
        self.width = 0

    def alloc(self, step: int) -> int:
        for s in list(self.free):
            if self.freed_at.get(s, -1) < step:
                self.free.remove(s)
                return s
        s = self.width
        self.width += 1
        return s

    def release(self, slot: int, step: int) -> None:
        self.free.append(slot)
        self.freed_at[slot] = step


def build_schedule(S: int, v: int, m: int) -> Schedule:
    """Greedy in-order assignment of Megatron's interleaved-1F1B op lists to
    lockstep steps (one chunk-op per rank per step; an op waits until its
    dependency's result has crossed the ring: dep step + 1)."""
    if m % S:
        raise ValueError(
            f"interleaved 1F1B needs n_micro ({m}) divisible by the stage "
            f"count ({S})"
        )
    total = m * v
    # Megatron-LM warmup: 2*(S - r - 1) + (v - 1) * S forward chunk-ops
    # before the first backward, capped at the total
    ops: Dict[int, List[Tuple[str, int, int]]] = {}
    for r in range(S):
        warm = min(2 * (S - r - 1) + (v - 1) * S, total)
        seq: List[Tuple[str, int, int]] = []
        for k in range(warm):
            seq.append(("F", *_fwd_order(k, S, v)))
        for k in range(warm, total):
            seq.append(("F", *_fwd_order(k, S, v)))
            seq.append(("B", *_bwd_order(k - warm, S, v)))
        for k in range(total - warm, total):
            seq.append(("B", *_bwd_order(k, S, v)))
        ops[r] = seq

    def fdep(i: int, c: int, r: int) -> Optional[Tuple[str, int, int, int]]:
        if r > 0:
            return ("F", i, c, r - 1)
        if c > 0:
            return ("F", i, c - 1, S - 1)
        return None  # injection

    def bdep(i: int, c: int, r: int) -> Tuple[str, int, int, int]:
        if c == v - 1 and r == S - 1:
            return ("F", i, c, r)  # dy_head from its own forward
        if r < S - 1:
            return ("B", i, c, r + 1)
        return ("B", i, c + 1, 0)

    # Greedy paired assignment: the engine executes one (masked) forward
    # half-step AND one (masked) backward half-step per step — the same
    # lockstep shape as the v=1 1F1B engine, so a step's cost is constant
    # and the ring permutes stay one-per-direction-per-step. Each rank
    # places its next op when the op's dependency result has crossed the
    # ring (dep step <= t-1), and may place the FOLLOWING op in the same
    # step when it is of the other kind (the fwd half runs first, so a
    # last-virtual-stage backward may consume its own same-step forward's
    # dy_head — the v=1 engine's head pairing).
    done: Dict[Tuple[str, int, int, int], int] = {}  # op -> step
    ptr = [0] * S
    placed_f: List[List[Optional[Tuple[int, int]]]] = []  # (i, c) per rank
    placed_b: List[List[Optional[Tuple[int, int]]]] = []
    step = 0
    guard = 4 * total * S + 8 * S * v + 64
    while any(ptr[r] < len(ops[r]) for r in range(S)):
        if step > guard:
            raise AssertionError("interleaved 1F1B schedule did not converge")
        row_f: List[Optional[Tuple[int, int]]] = [None] * S
        row_b: List[Optional[Tuple[int, int]]] = [None] * S
        for r in range(S):
            for _try in range(2):  # at most one op of each kind per step
                if ptr[r] >= len(ops[r]):
                    break
                kind, i, c = ops[r][ptr[r]]
                if kind == "F":
                    if row_f[r] is not None:
                        break
                    dep = fdep(i, c, r)
                    if dep is not None and done.get(dep, step) >= step:
                        break
                    row_f[r] = (i, c)
                    done[("F", i, c, r)] = step
                else:
                    if row_b[r] is not None:
                        break
                    dep = bdep(i, c, r)
                    # same-step allowed only for the head pair (fwd half
                    # runs before the bwd half)
                    limit = step if dep[0] == "F" and dep[1:] == (i, c, r) \
                        else step - 1
                    if done.get(dep, limit + 1) > limit:
                        break
                    row_b[r] = (i, c)
                    done[("B", i, c, r)] = step
                ptr[r] += 1
        placed_f.append(row_f)
        placed_b.append(row_b)
        step += 1
    T = step

    z = [[0] * S for _ in range(T)]
    sched = Schedule(
        S=S, v=v, m=m, T=T,
        f_on=[r[:] for r in z], f_mb=[r[:] for r in z],
        f_chunk=[r[:] for r in z],
        b_on=[r[:] for r in z], b_mb=[r[:] for r in z],
        b_chunk=[r[:] for r in z],
        in_w=[r[:] for r in z], in_r=[r[:] for r in z],
        recvf_w=[r[:] for r in z], recvf_r=[r[:] for r in z],
        recvb_w=[r[:] for r in z], recvb_r=[r[:] for r in z],
        dyh_w=[r[:] for r in z], dyh_r=[r[:] for r in z],
    )
    for t in range(T):
        for r in range(S):
            if placed_f[t][r] is not None:
                sched.f_on[t][r] = 1
                sched.f_mb[t][r], sched.f_chunk[t][r] = placed_f[t][r]
            if placed_b[t][r] is not None:
                sched.b_on[t][r] = 1
                sched.b_mb[t][r], sched.b_chunk[t][r] = placed_b[t][r]

    # ---- chronological slot assignment: at each step, first store the
    # arrivals (payloads computed at t-1, keyed by the CONSUMER's (i, c):
    # the ring wrap advances the fwd chunk by +1 and the bwd chunk by -1),
    # then the forward op (engine runs the fwd half first), then the
    # backward op ----
    in_alloc = [_SlotAlloc() for _ in range(S)]
    recvf_alloc = [_SlotAlloc() for _ in range(S)]
    recvb_alloc = [_SlotAlloc() for _ in range(S)]
    dyh_alloc = [_SlotAlloc() for _ in range(S)]
    in_slot: Dict[Tuple[int, int, int], int] = {}
    recvf_slot: Dict[Tuple[int, int, int], int] = {}
    recvb_slot: Dict[Tuple[int, int, int], int] = {}
    dyh_slot: Dict[Tuple[int, int], int] = {}

    for t in range(T):
        if t > 0:
            for r in range(S):
                if placed_f[t - 1][r] is not None:
                    i, c = placed_f[t - 1][r]
                    if not (c == v - 1 and r == S - 1):
                        rr = (r + 1) % S
                        cc = c if r < S - 1 else c + 1
                        s = recvf_alloc[rr].alloc(t)
                        recvf_slot[(i, cc, rr)] = s
                        sched.recvf_w[t][rr] = s + 1  # 0 = no arrival
                if placed_b[t - 1][r] is not None:
                    i, c = placed_b[t - 1][r]
                    if not (c == 0 and r == 0):
                        rr = (r - 1) % S
                        cc = c if r > 0 else c - 1
                        s = recvb_alloc[rr].alloc(t)
                        recvb_slot[(i, cc, rr)] = s
                        sched.recvb_w[t][rr] = s + 1
        for r in range(S):
            if placed_f[t][r] is not None:
                i, c = placed_f[t][r]
                s = in_alloc[r].alloc(t)
                in_slot[(i, c, r)] = s
                sched.in_w[t][r] = s + 1
                if c == 0 and r == 0:
                    pass  # injection: engine reads micros[i] instead
                else:
                    s2 = recvf_slot.pop((i, c, r))
                    sched.recvf_r[t][r] = s2 + 1
                    recvf_alloc[r].release(s2, t)
                if c == v - 1 and r == S - 1:
                    sd = dyh_alloc[r].alloc(t)
                    dyh_slot[(i, r)] = sd
                    sched.dyh_w[t][r] = sd + 1
        for r in range(S):
            if placed_b[t][r] is not None:
                i, c = placed_b[t][r]
                s = in_slot.pop((i, c, r))
                sched.in_r[t][r] = s + 1
                in_alloc[r].release(s, t)
                if c == v - 1 and r == S - 1:
                    sd = dyh_slot.pop((i, r))
                    sched.dyh_r[t][r] = sd + 1
                    dyh_alloc[r].release(sd, t)
                else:
                    s2 = recvb_slot.pop((i, c, r))
                    sched.recvb_r[t][r] = s2 + 1
                    recvb_alloc[r].release(s2, t)

    sched.in_width = max(a.width for a in in_alloc) + 1  # +scratch
    sched.recvf_width = max([a.width for a in recvf_alloc] or [0]) + 1
    sched.recvb_width = max([a.width for a in recvb_alloc] or [0]) + 1
    sched.dyh_width = max([a.width for a in dyh_alloc] or [0]) + 1
    # per rank per step the engine runs one fwd and one bwd half-slot;
    # useful half-slots are the m*v ops of each kind
    sched.bubble_fraction = 1.0 - total / float(T)
    return sched


def validate_schedule(sched: Schedule) -> None:
    """Assert coverage, dependency and buffer-consistency invariants (used
    by tests and the build)."""
    S, v, m, T = sched.S, sched.v, sched.m, sched.T
    seen_f: Dict[Tuple[int, int, int], int] = {}
    seen_b: Dict[Tuple[int, int, int], int] = {}
    for t in range(T):
        for r in range(S):
            if sched.f_on[t][r]:
                key = (sched.f_mb[t][r], sched.f_chunk[t][r], r)
                assert key not in seen_f, f"duplicate F {key}"
                seen_f[key] = t
            if sched.b_on[t][r]:
                key = (sched.b_mb[t][r], sched.b_chunk[t][r], r)
                assert key not in seen_b, f"duplicate B {key}"
                seen_b[key] = t
    assert len(seen_f) == m * v * S, "missing forward ops"
    assert len(seen_b) == m * v * S, "missing backward ops"
    for (i, c, r), t in seen_f.items():
        if r > 0:
            assert seen_f[(i, c, r - 1)] < t, f"F dep violated at {(i, c, r)}"
        elif c > 0:
            assert seen_f[(i, c - 1, S - 1)] < t, f"F wrap dep at {(i, c, r)}"
    for (i, c, r), t in seen_b.items():
        if c == v - 1 and r == S - 1:
            # seeds from its own forward's dy_head; same step is legal
            # (the engine's fwd half runs first)
            assert seen_f[(i, c, r)] <= t, f"head pair order at {(i, c, r)}"
            continue
        assert seen_f[(i, c, r)] < t, f"B before its own F at {(i, c, r)}"
        succ = (i, c, r + 1) if r < S - 1 else (i, c + 1, 0)
        assert seen_b[succ] < t, f"B dep violated at {(i, c, r)}"



def pipeline_value_and_grad_interleaved_1f1b(
    stage_fn: Callable[[Any, torch.Tensor], Any],
    loss_head: Callable[[int, torch.Tensor], Tuple[torch.Tensor, List[torch.Tensor]]],
    stage_params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    mesh,
    n_micro: int,
    n_chunks: int,
    axis: str = "pp",
    aux_seed: float = 0.0,
):
    """Interleaved 1F1B: loss and gradients in one pass over the virtual-
    stage layout. stage_params: this rank's block, leaves (1, v, Lg, ...)
    (`to_pp_params` with n_chunks=v); stage_fn consumes ONE chunk's params
    {name: (Lg, ...)}. Everything else (the loss_head contract, aux_seed,
    the returned tuple) is pipeline_value_and_grad_1f1b's."""
    _check_batch(x, n_micro)
    st = _Stages(mesh, axis, n_micro, n_chunks)
    if st.S == 1:
        raise ValueError("interleaved 1F1B needs pp > 1")
    sched = build_schedule(st.S, n_chunks, n_micro)

    def visits(on, mb, chunk):
        return [[(mb[t][r], chunk[t][r]) if on[t][r] else None for r in range(st.S)]
                for t in range(sched.T)]

    return run_1f1b(st, visits(sched.f_on, sched.f_mb, sched.f_chunk),
                    visits(sched.b_on, sched.b_mb, sched.b_chunk), stage_fn, loss_head, stage_params, x,
                    aux_seed)
