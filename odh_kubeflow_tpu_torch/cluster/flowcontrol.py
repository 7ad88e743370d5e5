"""API Priority & Fairness analog (the port's copy of
odh_kubeflow_tpu/cluster/flowcontrol.py).

A FlowSchema matches a request (by flow, verb, kind) onto a priority level,
which owns a bounded number of concurrency seats and per-flow FIFO queues;
past the queue bound a request sheds with `TooManyRequestsError` (429 with
Retry-After), and an exempt level keeps leader-election traffic out of the
contention entirely. Identity travels as a `flow` string in a thread-local
(`flow_context`). The port's router holds a seat in the "serving" level for
each routed generation (kind InferenceRequest), and runs its cold-wake
callback under the "token-router" flow.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, Iterator, List, Optional, Tuple

from ..apimachinery import TooManyRequestsError
from ..utils import racecheck
from ..utils.metrics import global_registry

flowcontrol_inflight = global_registry.gauge(
    "flowcontrol_inflight",
    "Requests currently executing (holding a seat), by priority level",
    labels=("level",),
)
flowcontrol_queue_depth = global_registry.gauge(
    "flowcontrol_queue_depth",
    "Requests queued waiting for a seat, by priority level",
    labels=("level",),
)
flowcontrol_requests_total = global_registry.counter(
    "flowcontrol_requests_total",
    "Flowcontrol admission outcomes (dispatched | rejected | timeout), by "
    "priority level",
    labels=("level", "outcome"),
)
flowcontrol_wait_seconds = global_registry.histogram(
    "flowcontrol_wait_seconds",
    "Time a request waited in its flow queue before dispatch, by priority level",
    labels=("level",),
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 30, 60),
)


# thread-local flow identity: the controller worker loop (runtime/controller)
# enters flow_context(controller_name); everything the reconciler does below
# that frame — including RemoteStore requests — inherits it.
_flow_local = threading.local()

# the flow name leader-election clients declare; always routed to the exempt
# level regardless of schema configuration (failover must never queue)
LEADER_ELECTION_FLOW = "leader-election"


def current_flow() -> str:
    return getattr(_flow_local, "flow", "") or ""


@contextmanager
def flow_context(flow: str) -> Iterator[None]:
    prev = getattr(_flow_local, "flow", "")
    _flow_local.flow = flow
    try:
        yield
    finally:
        _flow_local.flow = prev


@dataclass
class PriorityLevel:
    """A concurrency budget: `seats` simultaneous requests, and per-flow FIFO
    queues holding at most `queue_length` waiters each. exempt levels bypass
    seats entirely (counted, never queued, never shed)."""

    name: str
    seats: int = 4
    queue_length: int = 16
    queue_timeout_s: float = 5.0
    exempt: bool = False


@dataclass
class FlowSchema:
    """Match a request onto a priority level. First match wins in list order
    (precedence = position, like APF's matchingPrecedence). Empty criteria
    match everything — put the catch-all last."""

    name: str
    level: str
    flows: Tuple[str, ...] = ()
    kinds: Tuple[str, ...] = ()
    verbs: Tuple[str, ...] = ()

    def matches(self, flow: str, verb: str, kind: str) -> bool:
        if self.flows and flow not in self.flows:
            return False
        if self.kinds and kind not in self.kinds:
            return False
        if self.verbs and verb not in self.verbs:
            return False
        return True


def default_levels() -> List[PriorityLevel]:
    return [
        # failover traffic: never queued, never shed
        PriorityLevel("exempt", exempt=True),
        # node-level machinery (kubelet/scheduler/statefulset): wide budget
        PriorityLevel("system", seats=16, queue_length=64, queue_timeout_s=10.0),
        # interactive + serving reconcilers: the protected class
        PriorityLevel("workload-high", seats=12, queue_length=64, queue_timeout_s=10.0),
        # data-plane inference requests (serving/router.py holds a seat per
        # routed generation): a hot endpoint contends HERE — its shed is a
        # wire 429 from the router — and can never starve the API levels
        PriorityLevel("serving", seats=8, queue_length=32, queue_timeout_s=5.0),
        # batch admission (TPUJob storms land here): narrow seats, short
        # queue — overload sheds HERE instead of starving the levels above
        PriorityLevel("batch", seats=4, queue_length=8, queue_timeout_s=2.0),
        PriorityLevel("default", seats=8, queue_length=32, queue_timeout_s=5.0),
    ]


def default_flow_schemas() -> List[FlowSchema]:
    return [
        FlowSchema(
            "exempt-leases",
            "exempt",
            flows=(LEADER_ELECTION_FLOW,),
        ),
        FlowSchema("exempt-lease-kind", "exempt", kinds=("Lease",)),
        FlowSchema(
            "system-nodes",
            "system",
            flows=("kubelet", "scheduler", "statefulset", "node-lifecycle"),
        ),
        FlowSchema(
            "workload-controllers",
            "workload-high",
            flows=(
                "notebook",
                "probe-status",
                "culling",
                "suspend-resume",
                "tpu-workbench",
                "event-mirror",
                "slice-repair",
                "inference-endpoint",
                "canary",
                # the control plane: the autoscaler's list/patch sweep
                # and the router's cold-wake patch ride the protected class
                # — a parked endpoint must wake even under admission storms
                "endpoint-autoscaler",
                "token-router",
            ),
        ),
        # the data plane: routed generations (whatever their dynamic
        # per-endpoint flow name) land in the serving budget by KIND
        FlowSchema(
            "serving-requests", "serving", kinds=("InferenceRequest",)
        ),
        FlowSchema("batch-controllers", "batch", flows=("tpu-job",)),
        # unclassified callers creating/deleting TPUJobs (the loadtest client,
        # an admission storm) contend in the batch budget, not the default one
        FlowSchema("batch-kind", "batch", kinds=("TPUJob",)),
        FlowSchema("catch-all", "default"),
    ]


class _Ticket:
    """Context manager releasing a seat on exit."""

    __slots__ = ("_ctrl", "_level")

    def __init__(self, ctrl: "FlowController", level: PriorityLevel):
        self._ctrl = ctrl
        self._level = level

    def __enter__(self) -> "_Ticket":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def release(self) -> None:
        ctrl, self._ctrl = self._ctrl, None
        if ctrl is not None:
            ctrl._release(self._level)


@dataclass
class _LevelState:
    level: PriorityLevel
    inflight: int = 0
    # flow name -> FIFO of waiter events; round-robin order across flows
    queues: Dict[str, Deque[threading.Event]] = field(default_factory=dict)
    rr: Deque[str] = field(default_factory=deque)
    dispatched: int = 0
    rejected: int = 0
    timed_out: int = 0
    queued_total: int = 0
    waits: List[float] = field(default_factory=list)


class FlowController:
    """Classify + admit requests. Thread-safe; one instance per admission
    point (an apiserver, a router)."""

    def __init__(
        self,
        schemas: Optional[List[FlowSchema]] = None,
        levels: Optional[List[PriorityLevel]] = None,
    ):
        self.schemas = list(schemas) if schemas is not None else default_flow_schemas()
        lvls = list(levels) if levels is not None else default_levels()
        if not any(lv.exempt for lv in lvls):
            # the exempt level is an INVARIANT, not a configuration: whatever
            # levels a caller scripts, leader-election/Lease traffic must
            # always have somewhere shed-proof to land (classify() routes it
            # here first), or an admission storm could starve failover
            lvls.append(PriorityLevel("exempt", exempt=True))
        self._levels: Dict[str, _LevelState] = {
            lv.name: _LevelState(level=lv) for lv in lvls
        }
        for s in self.schemas:
            if s.level not in self._levels:
                raise ValueError(f"flow schema {s.name!r} names unknown level {s.level!r}")
        self._lock = racecheck.make_lock("FlowController._lock")

    # -- classification --

    def classify(self, flow: str, verb: str = "", kind: str = "") -> PriorityLevel:
        if flow == LEADER_ELECTION_FLOW or kind == "Lease":
            for st in self._levels.values():
                if st.level.exempt:
                    return st.level
        for s in self.schemas:
            if s.matches(flow, verb, kind):
                return self._levels[s.level].level
        return self._levels["default"].level

    # -- admission --

    def admit(self, flow: str, verb: str = "", kind: str = "") -> _Ticket:
        """Take a seat at the matched priority level, queueing FIFO-per-flow
        behind a full level. Raises TooManyRequestsError on queue-full or
        queue-timeout (the shed path)."""
        level = self.classify(flow, verb, kind)
        st = self._levels[level.name]
        flow = flow or "anonymous"
        t0 = time.monotonic()
        with self._lock:
            if level.exempt or st.inflight < level.seats and not st.rr:
                st.inflight += 1
                st.dispatched += 1
                flowcontrol_inflight.set(st.inflight, level=level.name)
                flowcontrol_requests_total.inc(level=level.name, outcome="dispatched")
                flowcontrol_wait_seconds.observe(0.0, level=level.name)
                return _Ticket(self, level)
            q = st.queues.get(flow)
            if q is None:
                q = st.queues[flow] = deque()
            if len(q) >= level.queue_length:
                st.rejected += 1
                flowcontrol_requests_total.inc(level=level.name, outcome="rejected")
                raise TooManyRequestsError(
                    f"flow {flow!r} queue full at priority level {level.name!r}",
                    retry_after=min(level.queue_timeout_s, 1.0),
                )
            ev = threading.Event()
            q.append(ev)
            if flow not in st.rr:
                st.rr.append(flow)
            st.queued_total += 1
            flowcontrol_queue_depth.set(self._depth_locked(st), level=level.name)
        if not ev.wait(level.queue_timeout_s):
            with self._lock:
                # either we timed out, or the dispatcher set the event in the
                # race window — the set() path already granted us the seat
                if not ev.is_set():
                    try:
                        st.queues[flow].remove(ev)
                    except (KeyError, ValueError):
                        pass
                    st.timed_out += 1
                    flowcontrol_queue_depth.set(self._depth_locked(st), level=level.name)
                    flowcontrol_requests_total.inc(level=level.name, outcome="timeout")
                    raise TooManyRequestsError(
                        f"flow {flow!r} timed out queued at level {level.name!r}",
                        retry_after=min(level.queue_timeout_s, 1.0),
                    )
        wait = time.monotonic() - t0
        with self._lock:
            st.dispatched += 1
            st.waits.append(wait)
            if len(st.waits) > 4096:
                del st.waits[:2048]
        flowcontrol_requests_total.inc(level=level.name, outcome="dispatched")
        flowcontrol_wait_seconds.observe(wait, level=level.name)
        return _Ticket(self, level)

    def _depth_locked(self, st: _LevelState) -> int:
        return sum(len(q) for q in st.queues.values())

    def _release(self, level: PriorityLevel) -> None:
        st = self._levels[level.name]
        with self._lock:
            st.inflight -= 1
            if not level.exempt:
                # hand the freed seat to the next waiter, round-robin across
                # flows so one hot flow can't monopolize the level
                while st.rr:
                    f = st.rr[0]
                    q = st.queues.get(f)
                    if not q:
                        st.rr.popleft()
                        st.queues.pop(f, None)
                        continue
                    ev = q.popleft()
                    st.rr.rotate(-1)
                    if not q:
                        try:
                            st.rr.remove(f)
                        except ValueError:
                            pass
                        st.queues.pop(f, None)
                    st.inflight += 1
                    ev.set()
                    break
            flowcontrol_inflight.set(st.inflight, level=level.name)
            flowcontrol_queue_depth.set(self._depth_locked(st), level=level.name)

    # -- observability --

    def summary(self) -> Dict[str, Dict[str, Any]]:
        """Per-level dispatch/shed/wait stats for bench + /debug."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for name, st in self._levels.items():
                waits = sorted(st.waits)
                p99 = waits[min(len(waits) - 1, int(len(waits) * 0.99))] if waits else 0.0
                out[name] = {
                    "exempt": st.level.exempt,
                    "seats": st.level.seats,
                    "inflight": st.inflight,
                    "queue_depth": self._depth_locked(st),
                    "dispatched": st.dispatched,
                    "rejected": st.rejected,
                    "timed_out": st.timed_out,
                    "queued": st.queued_total,
                    "p99_wait_s": round(p99, 6),
                }
        return out
