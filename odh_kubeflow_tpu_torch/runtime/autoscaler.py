"""SLO-burn replica autoscaler for InferenceEndpoint fleets (the port's copy
of odh_kubeflow_tpu/runtime/autoscaler.py).

Scales on what the user experiences, never on CPU: the signal is the
serving-category SLOs' fast-window burn rate (runtime/slo.py — token-latency
and serving-availability) plus the engine's own queue pressure. The
autoscaler's ONLY write is the desired-replicas annotation; the endpoint
controller (controllers/inference.py) owns every actual transition, so
scale-up rides its warm-bind path, scale-down rides the route-first bounded
per-replica drain, and desired 0 (with `autoscaling.scaleToZero`) rides the
Suspended park. That split mirrors HPA vs workload controller: the policy
brain and the state machine never share a write surface.

Decision policy (`decide()` is a pure function — tests drive it with a fake
clock and scripted signals):

- **Up** when the fast-window burn crosses `autoscaling.targetBurnRate` or
  the admission queue is backing up: one replica per tick (each replica is
  a whole GPU slice — doubling on a burn spike would strip the warm pool).
- **Down** one replica only after the burn has stayed below HALF the target
  for the full scale-down stabilization window — the flap damper; any hot
  tick resets the window.
- **Park to zero** only when `scaleToZero` is set and the endpoint has been
  genuinely idle (empty queue, zero occupancy, no burn) for the idle
  window. The wake path is the router's cold-wake (or any desired bump),
  not this loop.
- `minReplicas` floors every decision except the explicit park.

The control loop lists endpoints and patches annotations under the
`endpoint-autoscaler` flow, so its API traffic is classified and budgeted
like every other manager controller.

The default signals read the operator's own registry: the serving SLOs'
burn and the engine gauges `inference_queue_depth` and
`inference_slot_occupancy_ratio`. Those gauges move only where the engine
runs in the operator's process; an endpoint whose engine serves in a pod's
own process reads idle there whatever it serves, so such a deployment
passes `signals_fn=PodStatsSignals(...)`, which reads the replicas' own
/stats.
"""
from __future__ import annotations

import http.client
import json
import logging
import threading
import time
import urllib.request
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..apimachinery import NotFoundError, TooManyRequestsError
from ..cluster.flowcontrol import flow_context
from .flightrecorder import recorder
from .metrics import (
    autoscaler_decisions_total,
    endpoint_desired_replicas_gauge,
)

log = logging.getLogger(__name__)

# burn below target/DOWN_FACTOR counts toward the scale-down window; between
# the two thresholds the fleet holds (hysteresis band)
DOWN_FACTOR = 2.0
DEFAULT_TARGET_BURN_RATE = 2.0
DEFAULT_QUEUE_PRESSURE = 8.0  # queued requests that count as "backing up"
IDLE_BURN_EPSILON = 0.01


@dataclass
class EndpointScaleState:
    """Per-endpoint damping memory: when the signal dropped below the
    scale-down threshold, and when the endpoint went fully idle."""

    below_since: Optional[float] = None
    idle_since: Optional[float] = None


def decide(
    current: int,
    auto: Any,  # api.inference AutoscalingSpec (duck-typed for tests)
    signals: Dict[str, float],
    now: float,
    state: EndpointScaleState,
    default_stabilization_s: float = 30.0,
    default_idle_s: float = 120.0,
    queue_pressure: float = DEFAULT_QUEUE_PRESSURE,
) -> Tuple[int, str]:
    """One scaling decision: (desired, action) where action is
    up | down | park | hold. Mutates `state` (the damping windows)."""
    hi = max(1, int(auto.max_replicas))
    lo = max(1, min(int(auto.min_replicas), hi))
    target = float(auto.target_burn_rate) or DEFAULT_TARGET_BURN_RATE
    stabilization = float(auto.scale_down_stabilization_s) or \
        default_stabilization_s
    idle_window = float(auto.scale_to_zero_idle_s) or default_idle_s

    burn = float(signals.get("burn_rate", 0.0))
    queued = float(signals.get("queue_depth", 0.0))
    occupancy = float(signals.get("slot_occupancy", 0.0))

    hot = burn >= target or queued >= queue_pressure
    idle = (
        queued <= 0.0 and occupancy <= 0.0 and burn <= IDLE_BURN_EPSILON
    )

    if hot:
        state.below_since = None
        state.idle_since = None
        desired = min(hi, max(current + 1, lo))
        return (desired, "up") if desired > current else (current, "hold")

    if idle and bool(auto.scale_to_zero):
        if state.idle_since is None:
            state.idle_since = now
        if current > 0 and now - state.idle_since >= idle_window:
            state.below_since = None
            return 0, "park"
    else:
        state.idle_since = None

    if burn < target / DOWN_FACTOR:
        if state.below_since is None:
            state.below_since = now
        if current > lo and now - state.below_since >= stabilization:
            state.below_since = now  # one step per stabilization window
            return current - 1, "down"
    else:
        state.below_since = None
    return max(current, lo) if current > 0 else current, "hold"


class ReplicaAutoscaler:
    """Manager service (start/stop contract) driving `decide()` over every
    autoscaling-enabled InferenceEndpoint on a fixed cadence."""

    def __init__(
        self,
        manager: Any,
        period_s: float = 5.0,
        stabilization_s: float = 30.0,
        idle_s: float = 120.0,
        queue_pressure: float = DEFAULT_QUEUE_PRESSURE,
        signals_fn: Optional[Callable[[Any], Dict[str, float]]] = None,
        clock: Callable[[], float] = time.time,
    ):
        self.manager = manager
        self.client = manager.client
        self.period_s = period_s
        self.stabilization_s = stabilization_s
        self.idle_s = idle_s
        self.queue_pressure = queue_pressure
        self.signals_fn = signals_fn or self._default_signals
        self.clock = clock
        self._states: Dict[str, EndpointScaleState] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ticks = 0

    # -- lifecycle (manager add_service contract) --

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="replica-autoscaler"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
        self._thread = None

    def _run(self) -> None:
        if self._stop.wait(min(1.0, self.period_s)):
            return
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:
                log.exception("autoscaler tick crashed")
            if self._stop.wait(self.period_s):
                return

    # -- one sweep --

    def tick(self) -> None:
        from ..api.inference import InferenceEndpoint

        self.ticks += 1
        with flow_context("endpoint-autoscaler"):
            endpoints = list(self.client.list(InferenceEndpoint))
            live_keys = set()
            for ep in endpoints:
                key = f"{ep.metadata.namespace}/{ep.metadata.name}"
                live_keys.add(key)
                try:
                    self._scale_one(ep, key)
                except NotFoundError:
                    pass  # deleted mid-sweep
                except TooManyRequestsError:
                    # apiserver throttling is routine under overload; the
                    # decision is re-derived from live state next period,
                    # so a dropped write costs one tick, never correctness
                    log.info("autoscaler throttled on %s; retrying next "
                             "tick", key)
                except Exception:
                    log.exception("autoscaler failed on endpoint %s", key)
            for key in list(self._states):
                if key not in live_keys:
                    del self._states[key]

    def _scale_one(self, ep: Any, key: str) -> None:
        from ..controllers import constants as C
        from ..controllers.inference import endpoint_desired_replicas

        auto = ep.spec.serving.autoscaling
        if auto is None:
            return  # static fleet: spec.serving.replicas is the contract
        if C.STOP_ANNOTATION in ep.metadata.annotations:
            self._states.pop(key, None)
            return  # draining/terminated: the stop flow owns the fleet
        current = endpoint_desired_replicas(ep)
        state = self._states.setdefault(key, EndpointScaleState())
        signals = self.signals_fn(ep)
        desired, action = decide(
            current, auto, signals, self.clock(), state,
            default_stabilization_s=self.stabilization_s,
            default_idle_s=self.idle_s,
            queue_pressure=self.queue_pressure,
        )
        autoscaler_decisions_total.inc(action=action)
        endpoint_desired_replicas_gauge.set(float(desired), endpoint=key)
        if desired == current:
            return
        self.client.patch(
            type(ep), ep.metadata.namespace, ep.metadata.name,
            {"metadata": {"annotations": {
                C.INFERENCE_DESIRED_REPLICAS_ANNOTATION: str(desired)
            }}},
        )
        recorder.record(
            "autoscale", endpoint=key, action=action,
            from_replicas=current, to_replicas=desired,
            burn_rate=signals.get("burn_rate", 0.0),
            queue_depth=signals.get("queue_depth", 0.0),
        )
        log.info(
            "autoscaler %s: %s %d->%d (burn %.2f, queue %.0f)",
            key, action, current, desired,
            signals.get("burn_rate", 0.0), signals.get("queue_depth", 0.0),
        )

    # -- default signal source: SLO engine + engine gauges --

    def _default_signals(self, ep: Any) -> Dict[str, float]:
        """Serving-category burn from the SLO engine's FASTEST window (the
        reactive one; the slow windows are for paging humans), queue/slot
        pressure from the engine gauges."""
        signals = {"burn_rate": serving_burn(self.manager), "queue_depth": 0.0,
                   "slot_occupancy": 0.0}
        registry = getattr(self.manager, "metrics", None)
        if registry is not None:
            for field, name in (
                ("queue_depth", "inference_queue_depth"),
                ("slot_occupancy", "inference_slot_occupancy_ratio"),
            ):
                metric = registry.get(name)
                if metric is not None:
                    try:
                        signals[field] = float(metric.value())
                    except Exception:
                        pass
        return signals


def serving_burn(manager: Any) -> float:
    """The serving-category SLOs' burn in the manager's SLO engine's
    FASTEST window (the reactive one; the slow windows are for paging
    humans); 0 without an engine."""
    burn = 0.0
    slo_engine = getattr(manager, "slo_engine", None)
    if slo_engine is not None:
        fast = min(slo_engine.windows, key=slo_engine.windows.get)
        for status in slo_engine.status().get("slos", {}).values():
            if status.get("category") != "serving":
                continue
            burn = max(
                burn,
                float(
                    status.get("windows", {})
                    .get(fast, {})
                    .get("burn_rate", 0.0)
                ),
            )
    return burn


SERVING_PORT_NAME = "http-serving"  # the endpoint pod's serving container port


def serving_address(pod: Any) -> Optional[str]:
    """A serving replica's base URL from its pod object, as a cluster
    routes to it: the pod's IP and the port its serving container declares
    (`http-serving`, which the endpoint reconciler renders). None while the
    pod has no IP or declares no such port."""
    if not pod.status.pod_ip:
        return None
    for container in pod.spec.containers:
        for port in container.ports:
            if port.name == SERVING_PORT_NAME and port.container_port:
                return f"http://{pod.status.pod_ip}:{port.container_port}"
    return None


def read_replica_stats(url: str, timeout_s: float = 2.0) -> Dict[str, Any]:
    """One serving replica's engine counters: GET {url}/stats."""
    with urllib.request.urlopen(f"{url}/stats", timeout=timeout_s) as r:
        return json.loads(r.read())


class PodStatsSignals:
    """The autoscaler's `signals_fn` for endpoints whose engine serves in
    its pod's own process (`python -m odh_kubeflow_tpu_torch.serving`),
    where the operator's registry never sees it: the serving burn as the
    default source reads it (`serving_burn`), with the queue and slot
    pressure read from each bound replica's /stats (`queued` summed;
    `active_slots` over `max_slots`, summed over the replicas).

    `address_of(pod)` is a replica's base URL, None while it has none. An
    endpoint not Serving, or with a replica that cannot be read (not
    listening yet, gone mid-read), counts busy (empty queue, full slots):
    it is never parked blind."""

    def __init__(
        self,
        manager: Any,
        address_of: Callable[[Any], Optional[str]],
        timeout_s: float = 2.0,
    ):
        self.manager = manager
        self.address_of = address_of
        self.timeout_s = timeout_s

    def replica_stats(self, pod: Any) -> Optional[Dict[str, Any]]:
        url = self.address_of(pod)
        if not url:
            return None
        try:
            return read_replica_stats(url, self.timeout_s)
        except (OSError, ValueError, http.client.HTTPException):
            return None

    def replicas(self, ep: Any) -> List[Any]:
        """The endpoint's bound pods that are not being deleted, read from
        the store (an informer cache may still list a deleted one)."""
        from ..api.core import Pod
        from ..controllers import constants as C

        pods = self.manager.api_reader.list(
            Pod, namespace=ep.metadata.namespace,
            labels={C.INFERENCE_NAME_LABEL: ep.metadata.name},
        )
        return [p for p in pods
                if p.spec.node_name and not p.metadata.deletion_timestamp]

    def __call__(self, ep: Any) -> Dict[str, float]:
        from ..controllers import constants as C

        signals = {"burn_rate": serving_burn(self.manager), "queue_depth": 0.0,
                   "slot_occupancy": 1.0}
        if ep.metadata.annotations.get(C.INFERENCE_STATE_ANNOTATION, "") != "serving":
            return signals
        stats = [self.replica_stats(p) for p in self.replicas(ep)]
        if stats and all(st is not None for st in stats):
            signals["queue_depth"] = float(sum(st["queued"] for st in stats))
            signals["slot_occupancy"] = (
                sum(st["active_slots"] for st in stats)
                / max(1, sum(st["max_slots"] for st in stats))
            )
        return signals


__all__ = [
    "DEFAULT_QUEUE_PRESSURE",
    "EndpointScaleState",
    "PodStatsSignals",
    "ReplicaAutoscaler",
    "decide",
    "read_replica_stats",
    "serving_burn",
]
