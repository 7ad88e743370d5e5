"""Health-aware token router in front of a fleet of serving engines (the
port's counterpart of odh_kubeflow_tpu/serving/router.py, over the port's
`ServingEngine`, its `QueueFull` and its `RequestHandle`).

- **Signal-driven picking.** `pick()` scores live replicas by the engine's
  own signals (admission-queue depth, KV-slot occupancy) and the recent
  TTFT tail the router observed through each replica, and routes to the
  cheapest.
- **Ejection with bounded re-admission.** Submit errors and probe failures
  feed a per-replica CircuitBreaker (runtime/breaker.py): a breaching
  replica leaves rotation, and the breaker's half-open state re-admits one
  trial request per cooldown.
- **Retries.** Generation is idempotent, so a failed, canceled or shed
  request retries on a different replica with budgeted, jittered, capped
  backoff.
- **Hedging for the tail.** Optionally, a request whose first token has not
  arrived after `hedge_after_s` is resubmitted to the next-best replica;
  the first completion wins and the loser is marked `superseded` and
  canceled, so a hedge costs bounded duplicate decode, not a duplicate
  answer or a counted cancellation.
- **Admission and fairness.** With every replica shedding (or the router
  at its own inflight bound) the router raises QueueFull (the server's
  429), and each request holds a seat in the flow controller's "serving"
  priority level (kind InferenceRequest).
- **Cold wake.** A request that finds no live replica fires the
  `cold_wake` callback under the "token-router" flow, rate-limited, then
  sheds.
- **Traces.** Each admitted request is one `router.request` envelope span
  whose context the pick, retry and hedge spans and the engines'
  `inference.request` spans take as their parent: one trace per request.

The router is duck-typed over engine-like backends (submit/stats/cancel),
so tests drive it against the port's ServingEngine or a scripted fake
alike.
"""
from __future__ import annotations

import logging
import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..apimachinery import TooManyRequestsError
from ..cluster.flowcontrol import FlowController, flow_context
from ..runtime.breaker import CircuitBreaker
from ..utils import racecheck
from ..utils.tracing import (
    format_traceparent,
    new_span_id,
    new_trace_id,
    parse_traceparent,
    record_span,
)
from . import metrics as M
from .engine import QueueFull, RequestHandle

log = logging.getLogger(__name__)

# retry budget mirrors the API client's 429 idiom: bounded attempts,
# jittered exponential backoff, capped per-sleep so a retry storm cannot
# stack unbounded latency behind one request
MAX_ROUTE_RETRIES = 3
RETRY_BASE_DELAY_S = 0.01
RETRY_MAX_DELAY_S = 0.25
TTFT_WINDOW = 64  # per-replica TTFT samples kept for the tail estimate
COLD_WAKE_COOLDOWN_S = 1.0  # at most one wake trigger per window


@dataclass
class RouteResult:
    """Outcome of one routed generation."""

    handle: RequestHandle
    replica: int
    retries: int = 0
    hedged: bool = False
    hedge_won: bool = False


@dataclass
class _Replica:
    index: int
    engine: Any  # engine-like: submit()/stats()/cancel()
    draining: bool = False
    ttft_samples: List[float] = field(default_factory=list)

    def ttft_tail_s(self) -> float:
        """p99-ish of the recent TTFTs observed THROUGH this replica (the
        router's own view — global histograms can't attribute tail latency
        to a replica)."""
        if not self.ttft_samples:
            return 0.0
        ordered = sorted(self.ttft_samples)
        return ordered[min(len(ordered) - 1, int(len(ordered) * 0.99))]


class TokenRouter:
    def __init__(
        self,
        endpoint: str = "",
        flow_controller: Optional[FlowController] = None,
        breaker_failure_threshold: int = 3,
        breaker_cooldown_s: float = 5.0,
        max_retries: int = MAX_ROUTE_RETRIES,
        hedge_after_s: float = 0.0,  # 0 disables hedging
        max_inflight: int = 0,  # 0 = no router-level admission bound
        cold_wake: Optional[Callable[[], None]] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        rng: Optional[random.Random] = None,
    ):
        self.endpoint = endpoint
        self.flow_controller = flow_controller
        self.max_retries = max_retries
        self.hedge_after_s = hedge_after_s
        self.max_inflight = max_inflight
        self.cold_wake = cold_wake
        self.clock = clock
        self.sleep = sleep
        self.rng = rng or random.Random()
        self.breaker = CircuitBreaker(
            failure_threshold=breaker_failure_threshold,
            cooldown_s=breaker_cooldown_s,
            clock=clock,
        )
        self._lock = racecheck.make_lock("TokenRouter._lock")
        self._replicas: Dict[int, _Replica] = {}
        self._ejected: set = set()  # observability mirror of open breakers
        self._inflight = 0
        self._last_wake = -COLD_WAKE_COOLDOWN_S

    # ---------- fleet membership (the controller's status feeds this) ----------

    def add_replica(self, index: int, engine: Any) -> None:
        with self._lock:
            self._replicas[index] = _Replica(index=index, engine=engine)
        self.breaker.forget(self._key(index))

    def remove_replica(self, index: int) -> None:
        with self._lock:
            self._replicas.pop(index, None)
            self._ejected.discard(index)
        self.breaker.forget(self._key(index))

    def set_draining(self, index: int, draining: bool = True) -> None:
        """Route-first drain: a draining replica finishes its in-flight
        work but takes no new picks (status.drainingReplicas mirrors this)."""
        with self._lock:
            rep = self._replicas.get(index)
            if rep is not None:
                rep.draining = draining

    def replicas(self) -> List[int]:
        with self._lock:
            return sorted(self._replicas)

    def ejected(self) -> List[int]:
        with self._lock:
            return sorted(self._ejected)

    # ---------- health signals ----------

    def note_probe_failure(self, index: int) -> None:
        """A failed health probe counts exactly like a failed request — the
        breaker decides when the replica leaves rotation."""
        self._record_failure(index)

    def note_probe_success(self, index: int) -> None:
        self._record_success(index)

    def _key(self, index: int) -> str:
        return f"{self.endpoint}/replica-{index}"

    def _record_failure(self, index: int) -> None:
        if self.breaker.record_failure(self._key(index)):
            with self._lock:
                self._ejected.add(index)
            M.inference_router_ejections_total.inc(action="eject")
            log.warning("router %s ejected replica %d (breaker open)",
                        self.endpoint or "-", index)

    def _record_success(self, index: int) -> None:
        self.breaker.record_success(self._key(index))
        with self._lock:
            was_ejected = index in self._ejected
            self._ejected.discard(index)
        if was_ejected:
            M.inference_router_ejections_total.inc(action="readmit")
            log.info("router %s re-admitted replica %d",
                     self.endpoint or "-", index)

    # ---------- picking ----------

    def _score(self, rep: _Replica) -> float:
        """Lower is better: queue depth (each waiter is a whole burst of
        latency) dominates, slot occupancy breaks ties between idle-queued
        replicas, the observed TTFT tail penalizes chronically slow ones."""
        try:
            stats = rep.engine.stats()
        except Exception:
            return float("inf")
        queued = float(stats.get("queued", 0))
        slots = float(stats.get("max_slots", 1)) or 1.0
        occupancy = float(stats.get("active_slots", 0)) / slots
        return queued + occupancy + rep.ttft_tail_s()

    def pick(self, exclude: Sequence[int] = (),
             traceparent: Optional[str] = None) -> Optional[int]:
        """Best routable replica index, or None (all ejected / draining /
        excluded / absent). Breaker half-open trials ride the same path:
        `allow()` admits one probe request per cooldown. `traceparent`
        parents the pick span under the routed
        request's span, so router->replica->first-token is ONE trace."""
        with self._lock:
            candidates = [
                rep for rep in self._replicas.values()
                if not rep.draining and rep.index not in exclude
            ]
        routable = [
            rep for rep in candidates if self.breaker.allow(self._key(rep.index))
        ]
        if not routable:
            return None
        best = min(routable, key=self._score)
        record_span(
            "router.pick",
            traceparent=traceparent,
            endpoint=self.endpoint,
            replica=best.index,
            candidates=len(routable),
            ejected=len(candidates) - len(routable),
        )
        return best.index

    # ---------- the routed request ----------

    def generate(
        self,
        prompt: Sequence[int],
        max_new: int,
        traceparent: Optional[str] = None,
        wait_timeout_s: float = 120.0,
    ) -> RouteResult:
        """Route one generation through the fleet: admission (flow seat +
        inflight bound) -> pick -> submit -> wait, with cross-replica
        retries and optional hedging. Raises QueueFull when the request
        should shed (wire 429)."""
        t0 = self.clock()
        ticket = None
        if self.flow_controller is not None:
            try:
                ticket = self.flow_controller.admit(
                    f"serving:{self.endpoint or 'endpoint'}",
                    verb="create", kind="InferenceRequest",
                )
            except TooManyRequestsError as e:
                M.inference_router_picks_total.inc(result="shed")
                raise QueueFull(
                    f"serving priority level shed the request: {e}"
                ) from e
        try:
            with self._lock:
                if self.max_inflight and self._inflight >= self.max_inflight:
                    M.inference_router_picks_total.inc(result="shed")
                    raise QueueFull(
                        f"router inflight bound reached ({self.max_inflight})"
                    )
                self._inflight += 1
            # one routed-request envelope span per admitted request: its
            # context is what pick/retry/hedge spans AND the
            # replica engines see as traceparent, so the engine-side
            # inference.request joins this trace instead of starting its own
            ctx = parse_traceparent(traceparent)
            trace_id = ctx[0] if ctx else new_trace_id()
            span_id = new_span_id()
            route_ctx = format_traceparent(trace_id, span_id)
            result_tag = "ok"
            try:
                return self._generate_routed(
                    prompt, max_new, route_ctx, wait_timeout_s, t0
                )
            except BaseException as e:
                result_tag = type(e).__name__
                raise
            finally:
                with self._lock:
                    self._inflight -= 1
                record_span(
                    "router.request",
                    traceparent=traceparent,
                    trace_id=trace_id,
                    span_id=span_id,
                    start_time=t0,
                    end_time=self.clock(),
                    endpoint=self.endpoint,
                    result=result_tag,
                )
        finally:
            if ticket is not None:
                ticket.release()

    def _generate_routed(
        self,
        prompt: Sequence[int],
        max_new: int,
        traceparent: Optional[str],
        wait_timeout_s: float,
        t0: float,
    ) -> RouteResult:
        tried: set = set()
        retries = 0
        while True:
            index = self.pick(exclude=tuple(tried), traceparent=traceparent)
            if index is None and tried:
                # every untried replica is out; the budget allows revisiting
                # the full rotation once more rather than shedding early
                tried.clear()
                index = self.pick(traceparent=traceparent)
            if index is None:
                self._maybe_cold_wake()
                M.inference_router_picks_total.inc(result="no_replica")
                raise QueueFull(
                    f"no routable replica for endpoint "
                    f"{self.endpoint or '-'} (fleet parked, draining, or "
                    "ejected); retry shortly"
                )
            with self._lock:
                rep = self._replicas.get(index)
            if rep is None:
                tried.add(index)
                continue
            try:
                handle = rep.engine.submit(prompt, max_new, traceparent)
            except QueueFull:
                self._record_success(index)  # full, not broken
                M.inference_router_retries_total.inc(reason="queue_full")
                if retries >= self.max_retries:
                    M.inference_router_picks_total.inc(result="shed")
                    raise
                record_span(
                    "router.retry", traceparent=traceparent,
                    reason="queue_full", replica=index, attempt=retries + 1,
                )
                tried.add(index)
                retries += 1
                self._backoff(retries)
                continue
            except Exception:
                self._record_failure(index)
                M.inference_router_retries_total.inc(reason="error")
                if retries >= self.max_retries:
                    M.inference_router_picks_total.inc(result="error")
                    raise
                record_span(
                    "router.retry", traceparent=traceparent,
                    reason="error", replica=index, attempt=retries + 1,
                )
                tried.add(index)
                retries += 1
                self._backoff(retries)
                continue
            # routed: the router's own added latency ends at engine handoff
            M.inference_router_added_latency_seconds.observe(
                max(0.0, self.clock() - t0)
            )
            result = self._await(
                rep, handle, prompt, max_new, traceparent, wait_timeout_s,
                tried,
            )
            if result is not None:
                result.retries = retries
                return result
            # completed "canceled" (engine stopped / replica torn down
            # mid-request): idempotent, retry elsewhere
            self._record_failure(index)
            M.inference_router_retries_total.inc(reason="canceled")
            if retries >= self.max_retries:
                M.inference_router_picks_total.inc(result="error")
                raise ConnectionError(
                    f"request canceled on replica {index} and retry budget "
                    f"exhausted ({self.max_retries})"
                )
            record_span(
                "router.retry", traceparent=traceparent,
                reason="canceled", replica=index, attempt=retries + 1,
            )
            tried.add(index)
            retries += 1
            self._backoff(retries)

    def _await(
        self,
        rep: _Replica,
        handle: RequestHandle,
        prompt: Sequence[int],
        max_new: int,
        traceparent: Optional[str],
        wait_timeout_s: float,
        tried: set,
    ) -> Optional[RouteResult]:
        """Wait for one submitted request, optionally hedging the tail.
        Returns None when the request came back `canceled` (retryable)."""
        deadline = self.clock() + wait_timeout_s
        hedged = False
        if self.hedge_after_s > 0:
            budget = min(self.hedge_after_s, max(0.0, deadline - self.clock()))
            if not handle.wait(budget) and not handle.tokens:
                # slowest-tail hedge: nothing generated yet, try the
                # next-best replica in parallel; first completion wins
                hedge_idx = self.pick(
                    exclude=tuple(tried | {rep.index}), traceparent=traceparent
                )
                if hedge_idx is not None:
                    with self._lock:
                        hedge_rep = self._replicas.get(hedge_idx)
                    if hedge_rep is not None:
                        try:
                            hedge_handle = hedge_rep.engine.submit(
                                prompt, max_new, traceparent
                            )
                            hedged = True
                            M.inference_router_hedges_total.inc(
                                outcome="launched"
                            )
                            record_span(
                                "router.hedge", traceparent=traceparent,
                                primary=rep.index, hedge=hedge_idx,
                            )
                        except Exception:
                            hedge_rep = None
                    if hedged and hedge_rep is not None:
                        return self._await_hedged(
                            rep, handle, hedge_rep, hedge_handle, deadline
                        )
        ok = self._wait_result(handle, deadline)
        if ok is None:
            return None
        self._finish(rep, handle)
        return RouteResult(handle=handle, replica=rep.index, hedged=hedged)

    def _await_hedged(
        self,
        primary_rep: _Replica,
        primary: RequestHandle,
        hedge_rep: _Replica,
        hedge: RequestHandle,
        deadline: float,
    ) -> Optional[RouteResult]:
        """First completion wins; the loser is CANCELED so a hedge never
        costs a full duplicate generation."""
        while True:
            if primary.done.is_set() and primary.result == "ok":
                winner, win_rep = primary, primary_rep
                loser, lose_rep = hedge, hedge_rep
                outcome, hedge_won = "primary_won", False
                break
            if hedge.done.is_set() and hedge.result == "ok":
                winner, win_rep = hedge, hedge_rep
                loser, lose_rep = primary, primary_rep
                outcome, hedge_won = "hedge_won", True
                break
            if primary.done.is_set() and hedge.done.is_set():
                # both canceled: retryable
                return None
            if self.clock() >= deadline:
                for r, h in ((primary_rep, primary), (hedge_rep, hedge)):
                    try:
                        r.engine.cancel(h)
                    except Exception:
                        pass
                raise TimeoutError(
                    f"hedged request timed out on replicas "
                    f"{primary_rep.index}/{hedge_rep.index}"
                )
            self.sleep(0.0005)
        try:
            # the winner already counted this request; the loser is a
            # duplicate whose cancellation must not burn availability SLO
            loser.superseded = True
            lose_rep.engine.cancel(loser)
        except Exception:
            pass
        M.inference_router_hedges_total.inc(outcome=outcome)
        self._finish(win_rep, winner)
        return RouteResult(
            handle=winner, replica=win_rep.index, hedged=True,
            hedge_won=hedge_won,
        )

    def _wait_result(
        self, handle: RequestHandle, deadline: float
    ) -> Optional[bool]:
        """True = ok, None = canceled (retryable); raises on timeout."""
        if not handle.wait(max(0.0, deadline - self.clock())):
            raise TimeoutError("request timed out in the engine")
        if handle.result == "ok":
            return True
        return None

    def _finish(self, rep: _Replica, handle: RequestHandle) -> None:
        if handle.ttft_s is not None:
            with self._lock:
                rep.ttft_samples.append(handle.ttft_s)
                if len(rep.ttft_samples) > TTFT_WINDOW:
                    del rep.ttft_samples[: len(rep.ttft_samples) - TTFT_WINDOW]
        self._record_success(rep.index)
        M.inference_router_picks_total.inc(result="ok")

    def _backoff(self, attempt: int) -> None:
        """Budgeted jittered backoff between cross-replica retries (the
        API client's 429 idiom: exponential, jittered, hard-capped)."""
        delay = min(
            RETRY_MAX_DELAY_S,
            RETRY_BASE_DELAY_S * (2 ** (attempt - 1)),
        )
        self.sleep(delay * (0.5 + self.rng.random() / 2))

    def _maybe_cold_wake(self) -> None:
        """Zero live replicas + a real request = the scale-to-zero wake
        signal. Rate-limited; runs under the token-router flow so the
        annotation patch contends in the router's declared budget."""
        if self.cold_wake is None:
            return
        now = self.clock()
        with self._lock:
            if now - self._last_wake < COLD_WAKE_COOLDOWN_S:
                return
            self._last_wake = now
        try:
            with flow_context("token-router"):
                self.cold_wake()
            log.info("router %s fired cold-wake (no live replicas)",
                     self.endpoint or "-")
        except Exception as e:
            log.warning("router %s cold-wake failed: %s",
                        self.endpoint or "-", e)


__all__ = [
    "MAX_ROUTE_RETRIES",
    "RouteResult",
    "TokenRouter",
]
