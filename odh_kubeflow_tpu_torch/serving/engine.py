"""Continuous-batching decode engine (counterpart of
odh_kubeflow_tpu/serving/engine.py) over models/decode.py.

- **Slot-based KV cache.** Per-layer (S, max_seq, kv_heads, head_dim) cache
  pairs; each of the S slots holds one live sequence at its own length.
  Slots recycle the moment a sequence hits EOS/max-tokens; the cache is
  reused in place, never reallocated.
- **Prefill/decode scheduling.** Between bursts the engine admits queued
  requests into free slots: a batch-1 prefill (flash attention, the Hopper
  kernel on the card) whose K/V replace the slot's whole cache extent. The
  first token is taken from the prefill logits, so TTFT does not wait for
  the decode batch.
- **Decode bursts.** One `step()` advances every slot `decode_burst` tokens
  with per-slot positions and validity masks. The burst's state (lengths,
  tokens, remaining, emitted tokens, active masks) stays on the device for
  the whole burst and reaches the host in ONE batched copy after it: the
  burst makes exactly one host sync (`stats()["host_syncs_last_burst"]`).
- **Bounded admission queue.** `submit()` past `max_queue_depth` raises
  `QueueFull`: backpressure is explicit.
- **Observability, as in the JAX engine.** Under PROFILE=1 each `step()`
  is one `serving.decode_burst` profiler region decomposed into admit ->
  prefill -> scan -> batched_drain -> emit phases (`utils/profiler.py`);
  the burst runs under the `serving.decode_burst` guard (0 host copies
  inside) and each prefill under `serving.prefill` (exactly 1), which
  TORCHGUARD=1 enforces (`utils/torchguard.py`); each completed request
  records an `inference.request` span under the caller's `traceparent`.

Greedy decoding only, as in the JAX engine. All device work runs on the
thread that calls `step()` (the engine's daemon thread once `start()`ed);
`submit`, `cancel` and `stats` touch only host state.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import telemetry
from ..device import DeviceLike, resolve_device
from ..models.decode import _cached_attention, _layer_views, _prompt_scan
from ..models.transformer import TransformerConfig, check_supported, layer_post_attention, layer_qkv
from ..ops import matmul_f32, rms_norm
from ..utils import profiler, racecheck, torchguard
from ..utils.tracing import record_span
from . import metrics as M

log = logging.getLogger(__name__)

# per-slot validity masks make the shared-mask decode attention the slot
# attention: row b of the batch attends its own slot's prefix
_slot_attention = _cached_attention


class QueueFull(RuntimeError):
    """Admission queue at max_queue_depth: the caller sheds load (HTTP 429)
    instead of the engine buffering unbounded latency."""


@dataclass
class RequestHandle:
    """One in-flight generation request. `wait()` blocks until completion;
    `tokens` is the generated sequence (never includes the prompt)."""

    id: int
    prompt: List[int]
    max_new: int
    submitted: float
    traceparent: Optional[str] = None  # the caller's W3C trace context, as given
    tokens: List[int] = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)
    result: str = ""  # ok | canceled | error
    ttft_s: Optional[float] = None
    _last_token_t: Optional[float] = None
    # a hedge duplicate whose twin already completed (a router sets it
    # before canceling): its cancellation is bookkeeping, not an outcome a
    # user saw, so it is not counted
    superseded: bool = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)


def _decode_burst(params, caches, layers, lengths, tokens, remaining, eos,
                  cfg: TransformerConfig, burst: int, extent: int):
    """`burst` decode steps for every slot without leaving the device.

    lengths (S,) per-slot positions; tokens (S,) the tokens being consumed;
    remaining (S,) tokens still owed per slot (0 = inactive: a free slot
    computes masked garbage, and the next admission replaces its whole cache
    extent). An MoE layer routes all S slots together, free ones included,
    in slot order, as the JAX burst does: a free slot's row takes expert
    capacity as it does there. `eos` (-1 = disabled) ends a sequence early on the device.
    Attention reads cache positions [0, extent), an upper bound on every
    slot's length over the burst computed on the host. Caches are written
    in place. Returns the new lengths/tokens/remaining and the per-step
    emitted tokens and active masks, (burst, S) each."""
    n_slots = lengths.shape[0]
    slots = torch.arange(n_slots, device=lengths.device)
    grid = torch.arange(extent, device=lengths.device)
    last = caches[0][0].shape[1] - 1
    toks, actives = [], []
    for _ in range(burst):
        active = remaining > 0
        x = params["embed"].to(cfg.dtype)[tokens][:, None, :]
        # a finished slot still writes garbage; clamp it into the cache
        pos = lengths.clamp(max=last)
        valid = grid[None, :] <= lengths[:, None]
        for lp, (k_cache, v_cache) in zip(layers, caches):
            q, k, v = layer_qkv(x, lp, lengths[:, None], cfg)
            k_cache[slots, pos] = k[:, 0]
            v_cache[slots, pos] = v[:, 0]
            attn = _slot_attention(q, k_cache[:, :extent], v_cache[:, :extent], valid, cfg)
            x = layer_post_attention(x, attn, lp, cfg)[0]
        x = rms_norm(x, params["final_norm"])
        nxt = matmul_f32(x[:, 0], params["unembed"]).argmax(dim=-1)
        emitted = torch.where(active, nxt, tokens)
        done = active & ((emitted == eos) | (remaining <= 1))
        remaining = torch.where(active, remaining - 1, remaining)
        remaining = torch.where(done, 0, remaining)
        lengths = lengths + active.long()
        tokens = emitted
        toks.append(emitted)
        actives.append(active)
    return lengths, tokens, remaining, torch.stack(toks), torch.stack(actives)


def _prefill(params, tokens, cfg: TransformerConfig):
    """Batch-1 prompt forward: f32 logits and each layer's K/V."""
    return _prompt_scan(params, tokens, cfg)


def _insert_slot(caches, ks, vs, slot: int) -> None:
    """Land a prefilled sequence's K/V ((1, s, kv, hd) per layer) in cache
    slot `slot`. The whole slot extent is replaced (zeros past the prompt),
    so a recycled slot's stale K/V never survives into the next sequence."""
    for (k_cache, v_cache), k, v in zip(caches, ks, vs):
        s = k.shape[1]
        k_cache[slot, :s] = k[0]
        v_cache[slot, :s] = v[0]
        k_cache[slot, s:] = 0
        v_cache[slot, s:] = 0


class ServingEngine:
    """The in-pod serving loop. Thread-safe submit; `step()` is the
    deterministic unit (admit free slots, decode the active batch one
    burst) the tests drive directly; `start()` runs it on a daemon thread.

    `params` must lie on `device`. `check_syncs` (CUDA only) runs each
    burst under torch's sync debug mode "error" (through the burst guard,
    which keeps that process-wide switch right with several engines on
    threads), so a host sync hidden in the burst raises instead of passing
    unnoticed."""

    def __init__(
        self,
        params: Any,
        cfg: TransformerConfig,
        *,
        max_slots: int = 8,
        max_seq: int = 512,
        max_queue_depth: int = 64,
        eos_id: Optional[int] = None,
        decode_burst: int = 8,
        clock: Callable[[], float] = time.perf_counter,
        device: DeviceLike = "cuda",
        check_syncs: bool = False,
    ):
        if max_slots <= 0 or max_seq <= 0:
            raise ValueError("max_slots and max_seq must be positive")
        check_supported(cfg)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, engine device is {self.device}")
        self.params = params
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.max_queue_depth = max_queue_depth
        self.eos_id = eos_id
        # decode steps per burst: 1 admits every token; higher amortizes the
        # per-burst host round trip while bounding admission delay
        self.decode_burst = max(1, decode_burst)
        self.clock = clock
        slot_shape = (max_slots, max_seq, cfg.kv_heads, cfg.head_dim)
        self._caches = tuple(
            (torch.zeros(slot_shape, dtype=cfg.dtype, device=self.device),
             torch.zeros(slot_shape, dtype=cfg.dtype, device=self.device))
            for _ in range(cfg.n_layers)
        )
        self._layers = tuple(_layer_views(params, cfg))
        # a fill, not a copy from the host: building an engine makes no sync
        # that could land in a running engine's "error" window
        self._eos = torch.full((), -1 if eos_id is None else eos_id, dtype=torch.long,
                               device=self.device)
        self._lengths = np.zeros((max_slots,), np.int64)
        self._tokens = np.zeros((max_slots,), np.int64)
        self._remaining = np.zeros((max_slots,), np.int64)
        self._slots: List[Optional[RequestHandle]] = [None] * max_slots
        self._queue: Deque[RequestHandle] = deque()
        self._lock = racecheck.make_lock("ServingEngine._lock")
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._next_id = 0
        self._generated_total = 0
        self._decode_steps = 0
        self._busy_s = 0.0
        self._host_syncs_last_burst = 0
        # per-engine guarded regions: the compile budget is judged per
        # consumer; the burst guard is also the check_syncs window
        self._burst_guard = torchguard.region("serving.decode_burst", self.device,
                                              check_syncs=check_syncs)
        self._prefill_guard = torchguard.region("serving.prefill", self.device)
        # compile counts are process-wide and monotonic: stats() reports
        # those since this engine was built
        self._compile_base = {name: torchguard.compile_count(name)
                              for name in ("serving.decode_burst", "serving.prefill")}

    # ---------- submission ----------

    def submit(self, prompt: Sequence[int], max_new: int,
               traceparent: Optional[str] = None) -> RequestHandle:
        """Queue one request; `traceparent` (a router passes it third,
        positionally) is kept on the handle."""
        if max_new <= 0:
            raise ValueError("max_new must be positive")
        if not prompt:
            raise ValueError("prompt must hold at least one token")
        if len(prompt) + max_new > self.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new}) exceeds the "
                f"slot cache extent ({self.max_seq})"
            )
        if any(not 0 <= t < self.cfg.vocab for t in prompt):
            raise ValueError(f"prompt tokens must lie in [0, {self.cfg.vocab})")
        with self._lock:
            if len(self._queue) >= self.max_queue_depth:
                M.inference_requests_total.inc(result="rejected")
                raise QueueFull(
                    f"admission queue at max_queue_depth ({self.max_queue_depth})"
                )
            self._next_id += 1
            handle = RequestHandle(
                id=self._next_id, prompt=list(prompt), max_new=max_new,
                submitted=self.clock(), traceparent=traceparent,
            )
            self._queue.append(handle)
            M.inference_queue_depth.set(float(len(self._queue)))
        self._work.set()
        return handle

    def cancel(self, handle: RequestHandle) -> bool:
        """Cancel one in-flight request. Queued requests leave the queue; an
        active slot is recycled. Returns False when it already completed."""
        if handle.done.is_set():
            return False
        with self._lock:
            if handle.done.is_set():
                return False
            try:
                self._queue.remove(handle)
                M.inference_queue_depth.set(float(len(self._queue)))
            except ValueError:
                for j, active in enumerate(self._slots):
                    if active is handle:
                        self._slots[j] = None  # recycled like EOS
                        break
                else:
                    return False  # completed in the race window
        self._complete(handle, "canceled", self.clock())
        self._publish_gauges()
        return True

    # ---------- the engine iteration ----------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            # pinned + non_blocking: the upload queues on the stream without
            # waiting for the device
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def step(self) -> bool:
        """Admit queued requests into free slots, then run one decode burst
        (`decode_burst` tokens per active slot). Returns False when there
        was nothing to do.

        Under PROFILE=1 the whole iteration is one serving.decode_burst
        profiler region decomposed into admit -> prefill -> scan ->
        batched_drain -> emit phases (the burst guard inside re-enters the
        region name and does not count twice)."""
        with profiler.region("serving.decode_burst", consumer="engine"):
            return self._step()

    def _step(self) -> bool:
        with profiler.phase("admit"):
            admitted = self._admit()
        n_active = sum(h is not None for h in self._slots)
        if n_active == 0:
            self._publish_gauges()
            return bool(admitted)
        burst, n = self.decode_burst, self.max_slots
        t0 = self.clock()
        transfers_before = torchguard.thread_transfer_count()
        extent = min(self.max_seq, int(self._lengths.max()) + burst)
        with profiler.phase("scan"), self._burst_guard, torch.inference_mode():
            state = self._upload(np.concatenate([self._lengths, self._tokens, self._remaining]))
            lengths, tokens, remaining, toks, actives = _decode_burst(
                self.params, self._caches, self._layers,
                state[:n], state[n:2 * n], state[2 * n:], self._eos,
                self.cfg, burst, extent,
            )
            packed = torch.cat([
                lengths, tokens, remaining, toks.reshape(-1), actives.reshape(-1).long(),
            ])
        # the burst's one host sync: every per-slot output in one copy,
        # outside the guarded region by design (its transfer budget is 0)
        with profiler.phase("batched_drain"):
            host = torchguard.to_host(packed)  # lint: disable=host-transfer
        self._host_syncs_last_burst = torchguard.thread_transfer_count() - transfers_before
        self._lengths = host[:n].copy()
        self._tokens = host[n:2 * n].copy()
        self._remaining = host[2 * n:3 * n].copy()
        toks_h = host[3 * n:3 * n + burst * n].reshape(burst, n)
        actives_h = host[3 * n + burst * n:].reshape(burst, n).astype(bool)
        now = self.clock()
        burst_dt = now - t0
        self._busy_s += burst_dt
        self._decode_steps += burst
        per_step = burst_dt / burst
        telemetry.observe_decode_step(per_step, tokens=n_active)
        with profiler.phase("emit"):
            for t in range(burst):
                step_t = t0 + (t + 1) * per_step
                for j, handle in enumerate(self._slots):
                    if handle is None or not actives_h[t, j]:
                        continue
                    self._emit(j, handle, int(toks_h[t, j]), step_t)
        self._publish_gauges()
        return True

    def _admit(self) -> int:
        """Prefill queued requests into free KV-cache slots, between bursts."""
        admitted = 0
        while True:
            free = next((j for j, h in enumerate(self._slots) if h is None), None)
            if free is None:
                return admitted
            with self._lock:
                if not self._queue:
                    return admitted
                handle = self._queue.popleft()
                M.inference_queue_depth.set(float(len(self._queue)))
            # nested inside the step's "admit" phase: admit's self time is
            # the scheduling, "prefill" the model work
            with profiler.phase("prefill"), self._prefill_guard, torch.inference_mode():
                # pinned and non-blocking: no sync beside the counted copy
                prompt = self._upload(np.asarray([handle.prompt], np.int64))
                logits, ks, vs = _prefill(self.params, prompt, self.cfg)
                _insert_slot(self._caches, ks, vs, free)
                # the ONE budgeted copy per admission (hotregions.py:
                # serving.prefill transfer_budget=1): TTFT needs the first
                # token now, not at the next burst
                first = int(torchguard.to_host(logits.argmax(dim=-1))[0])  # lint: disable=host-transfer
            now = self.clock()
            handle.ttft_s = now - handle.submitted
            M.inference_ttft_seconds.observe(handle.ttft_s)
            self._slots[free] = handle
            self._lengths[free] = len(handle.prompt)
            # the first token came from the prefill logits: the decode
            # bursts owe max_new - 1 more
            self._remaining[free] = handle.max_new - 1
            self._emit(free, handle, first, now)
            if self._slots[free] is None:
                # finished at admission (max_new == 1, or an immediate EOS):
                # the device must not decode into the freed slot
                self._remaining[free] = 0
            admitted += 1

    def _emit(self, slot: int, handle: RequestHandle, token: int, now: float) -> None:
        """One generated token for `handle`: record it, observe the
        inter-token gap, recycle the slot on EOS/max-tokens."""
        handle.tokens.append(token)
        if handle._last_token_t is not None:
            M.inference_token_latency_seconds.observe(max(0.0, now - handle._last_token_t))
        handle._last_token_t = now
        self._generated_total += 1
        finished = len(handle.tokens) >= handle.max_new or (
            self.eos_id is not None and token == self.eos_id
        )
        if finished:
            self._slots[slot] = None  # recycled; the next prefill replaces the cache
            self._complete(handle, "ok", now)
        else:
            self._tokens[slot] = token

    def _complete(self, handle: RequestHandle, result: str, now: float) -> None:
        handle.result = result
        # a superseded hedge duplicate was counted by its twin; counting its
        # cancellation would make every hedge burn the serving-availability
        # budget (drain and stop cancellations still count)
        if not handle.superseded:
            M.inference_requests_total.inc(result=result)
        record_span(
            "inference.request",
            traceparent=handle.traceparent,
            start_time=handle.submitted,
            end_time=now,
            request_id=handle.id,
            tokens=len(handle.tokens),
            ttft_s=round(handle.ttft_s, 6) if handle.ttft_s is not None else None,
            result=result,
            # a hedge loser stays in the routed request's trace, marked: the
            # winner's span is the one that counted
            superseded=handle.superseded,
        )
        handle.done.set()

    def _publish_gauges(self) -> None:
        occupied = sum(h is not None for h in self._slots)
        M.inference_slot_occupancy_ratio.set(occupied / self.max_slots)
        if self._busy_s > 0:
            M.inference_goodput_tokens_per_s.set(self._generated_total / self._busy_s)

    # ---------- lifecycle ----------

    def idle(self) -> bool:
        with self._lock:
            queued = bool(self._queue)
        return not queued and all(h is None for h in self._slots)

    def run_until_idle(self, timeout: float = 60.0) -> bool:
        """Drive steps on the CALLING thread until queue and slots drain
        (the deterministic test loop; don't mix with start())."""
        deadline = time.monotonic() + timeout
        while not self.idle():
            if time.monotonic() > deadline:
                return False
            self.step()
        return True

    def start(self) -> "ServingEngine":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True, name="serving-engine")
        self._thread.start()
        return self

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                did_work = self.step()
                if not did_work and self.idle():
                    self._work.wait(timeout=0.01)
                    self._work.clear()
        except Exception:
            # the loop is the serving boundary: record the fault and fail
            # every waiting request fast instead of leaving it to time out
            log.exception("serving engine loop failed")
            self._fail_leftovers("error")
            raise

    def _fail_leftovers(self, result: str) -> None:
        now = self.clock()
        with self._lock:
            leftovers = list(self._queue)
            self._queue.clear()
            M.inference_queue_depth.set(0.0)
        for j, handle in enumerate(self._slots):
            if handle is not None:
                self._slots[j] = None
                leftovers.append(handle)
        for handle in leftovers:
            self._complete(handle, result, now)
        self._publish_gauges()

    def stop(self, drain_timeout_s: float = 0.0) -> None:
        """Stop the loop. With a drain timeout the engine keeps stepping
        until in-flight work completes; whatever remains is completed as
        `canceled`: requests fail fast, never hang."""
        thread = self._thread
        if thread is not None:
            self._stop.set()
            self._work.set()
            thread.join(timeout=5.0)
            self._thread = None
        if drain_timeout_s > 0:
            self.run_until_idle(timeout=drain_timeout_s)
        self._fail_leftovers("canceled")

    # ---------- introspection ----------

    def stats(self) -> Dict[str, Any]:
        """The engine's live counters, under the reference engine's keys
        and the port's own. The recompile counts are the guard's compile
        counts since this engine was built: 0, as the eager engine compiles
        nothing (once the burst or the prefill is captured as a CUDA graph,
        its captures count there). host_transfers_last_burst is
        host_syncs_last_burst under the reference's name."""
        with self._lock:
            queued = len(self._queue)
        return {
            "queued": queued,
            "active_slots": sum(h is not None for h in self._slots),
            "max_slots": self.max_slots,
            "generated_tokens": self._generated_total,
            "decode_steps": self._decode_steps,
            "busy_s": round(self._busy_s, 6),
            "decode_burst_recompiles": (torchguard.compile_count("serving.decode_burst")
                                        - self._compile_base["serving.decode_burst"]),
            "prefill_recompiles": (torchguard.compile_count("serving.prefill")
                                   - self._compile_base["serving.prefill"]),
            # device->host syncs made by the last decode burst: exactly 1,
            # the batched copy of the burst's per-slot outputs
            "host_syncs_last_burst": self._host_syncs_last_burst,
            "host_transfers_last_burst": self._host_syncs_last_burst,
            "metrics": M.snapshot(),
        }
