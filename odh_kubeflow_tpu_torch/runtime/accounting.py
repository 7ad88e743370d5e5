"""Fleet-wide chip-time accounting (the port's copy of
odh_kubeflow_tpu/runtime/accounting.py, counting `nvidia.com/gpu` cards).

The ChipAccountant answers "where did every card-second go?" with one
level-triggered ledger:

- every tick it CLASSIFIES every GPU node into exactly one
  `(workload_class, object, phase)` bucket, reading only sources of truth
  that already exist (slicepool node annotations, the annotation-durable
  machines declared in analysis/machines.py, scheduler pod bindings,
  probe-gate readiness mirrored into CR status),
- it banks `cards x dt` into that bucket, so summed phase chip-seconds
  equal physical cards x wall-clock BY CONSTRUCTION — and an INVCHECK-armed
  check independently re-verifies the construction every tick (a doctored
  double- or zero-attribution raises `invcheck.InvariantViolation`),
- the two goodput integrators (tpu_job_goodput_ratio,
  tpu_slice_goodput_ratio) are thin VIEWS over `GoodputLedger` instances
  owned here — one accounting source of truth, with one `reset_for_test()`.

Phases (each node is in exactly one):

  ready           bound to an owner whose machine says productive
                  (mesh-ready notebook with recent activity, Serving
                  endpoint, Running/Checkpointing job)
  starting        bound, owner still coming up (Loading, Resuming,
                  Admitted, pod not ready)
  idle-bound      bound + ready but the activity signal has gone stale —
                  the NotebookOS number: cards held by an idle kernel
  suspended-warm  warm pool slice held on behalf of a suspended/parked
                  owner (counted owner-side: one warm slice per suspended
                  object, highest-priority warm entries first)
  repairing       owner inside the repair machine, or the host itself
                  NotReady — the hardware is not doing user work
  draining        winding down: suspend checkpointing, endpoint/replica
                  Draining, stop requested, preempt requested
  pool-free       free capacity: prewarmed warm slices beyond the
                  suspended-owner debt, and unpooled idle GPU nodes
  reclaim-churn   claimed in the pool but no GPU pod bound yet — the
                  claim->bind window, and reclaim round-trip transitions

The families keep the reference's `tpu_` names, so one set of dashboards
and SLO rules reads both packages. The families register at import, and
the heavy imports of `classify` are lazy.
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils import invcheck, racecheck
from .metrics import Gauge, global_registry

log = logging.getLogger(__name__)

PHASES = (
    "ready",
    "starting",
    "idle-bound",
    "suspended-warm",
    "repairing",
    "draining",
    "pool-free",
    "reclaim-churn",
)
# chip-seconds in these phases count toward fleet utilization: the chips are
# doing (or finishing) attributable user work
PRODUCTIVE_PHASES = ("ready", "draining")
CLASSES = ("notebook", "inference", "job", "pool")

tpu_chip_seconds_total = global_registry.counter(
    "tpu_chip_seconds_total",
    "Chip-seconds (GPU card-seconds) attributed per (workload class, phase) "
    "by the fleet accountant — conservation contract: summed across all "
    "phases this equals physical cards x accounted wall-clock within 1%",
    labels=("workload_class", "phase"),
)
tpu_fleet_utilization_ratio = global_registry.gauge(
    "tpu_fleet_utilization_ratio",
    "Cumulative fraction of accounted chip-seconds spent in productive "
    "phases (ready | draining) — the fleet-utilization SLO's gauge",
)
tpu_fleet_chips = global_registry.gauge(
    "tpu_fleet_chips",
    "Current physical cards per (workload class, phase) as of the last "
    "accountant tick — the instantaneous slice of the ledger",
    labels=("workload_class", "phase"),
)
tpu_object_chip_seconds = global_registry.gauge(
    "tpu_object_chip_seconds",
    "Cumulative chip-seconds attributed per object (ns/name, or pool name "
    "for unowned capacity) — per-object detail behind /debug/accounting",
    labels=("workload_class", "object"),
)
tpu_accounting_ticks_total = global_registry.counter(
    "tpu_accounting_ticks_total",
    "Accountant classification passes, by result (ok | error)",
    labels=("result",),
)


# ---------------------------------------------------------------------------
# goodput ledger views (the migrated integrators)
# ---------------------------------------------------------------------------


class GoodputLedger:
    """good/total second accumulators behind a 0..1 ratio gauge.

    Job goodput is productive_s/wall_s, slice goodput is
    (lifetime-downtime)/lifetime — each a cumulative good/total ratio fed
    incrementally from concurrent reconcile workers. The gauge is bound by
    the module that registered it (jobmetrics / telemetry keep their public
    families); the accumulators live HERE so a harness gets one
    `reset_for_test()`."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = racecheck.make_lock(f"GoodputLedger.{name}")
        self._good_s = 0.0
        self._total_s = 0.0
        self._gauge: Optional[Gauge] = None

    def bind_gauge(self, gauge: Gauge) -> None:
        self._gauge = gauge

    def record(self, good_s: float, total_s: float) -> None:
        with self._lock:
            self._good_s += max(0.0, good_s)
            self._total_s += max(0.0, total_s)
            ratio = (
                min(1.0, max(0.0, self._good_s / self._total_s))
                if self._total_s > 0
                else None
            )
        if ratio is not None and self._gauge is not None:
            self._gauge.set(ratio)

    def totals(self) -> Tuple[float, float]:
        with self._lock:
            return self._good_s, self._total_s

    def ratio(self) -> Optional[float]:
        good, total = self.totals()
        return min(1.0, good / total) if total > 0 else None

    def reset_for_test(self) -> None:
        """Zero the accumulators AND the bound gauge's series, so a fresh
        run starts from the never-set state (a series-less gauge reads as
        no data, not as 0% goodput)."""
        with self._lock:
            self._good_s = 0.0
            self._total_s = 0.0
        if self._gauge is not None:
            self._gauge.clear()


# process-wide views: jobmetrics.record_job_outcome and
# telemetry.GoodputAccounting.observe delegate here
job_goodput = GoodputLedger("job")
slice_goodput = GoodputLedger("slice")


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------


@dataclass
class Attribution:
    """One node's chip-seconds destination for the current tick."""

    node: str
    chips: int
    workload_class: str  # notebook | inference | job | pool
    obj: str  # ns/name, or the node-pool name for unowned capacity
    phase: str


def _node_ready(node: Any) -> bool:
    for c in node.status.conditions:
        if c.type == "Ready":
            return c.status != "False"
    return True  # sim nodes default healthy (no conditions written)


def _parse_ts(value: str) -> Optional[float]:
    from ..apimachinery import parse_time

    try:
        return parse_time(value).timestamp() if value else None
    except Exception:
        return None


class ChipAccountant:
    """Level-triggered manager service: every `period_s` it classifies the
    fleet and banks the elapsed chip-seconds. `tick()` is also directly
    drivable on an injected clock (tests)."""

    def __init__(
        self,
        client: Any,
        period_s: float = 1.0,
        idle_after_s: float = 300.0,
        tolerance: float = 0.01,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.client = client
        self.period_s = max(0.05, period_s)
        self.idle_after_s = max(0.0, idle_after_s)
        self.tolerance = max(0.0, tolerance)
        self.clock = clock
        self._lock = racecheck.make_lock("ChipAccountant._lock")
        self._last_tick: Optional[float] = None
        # (class, phase) -> chip-seconds; (class, obj) -> chip-seconds
        self._ledger: Dict[Tuple[str, str], float] = {}
        self._objects: Dict[Tuple[str, str], float] = {}
        self._physical_chip_seconds = 0.0
        self._started_at: Optional[float] = None
        self._ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- classification (pure read of cluster state) --

    def classify(self, now: Optional[float] = None) -> List[Attribution]:
        """One Attribution per GPU node (a node with `nvidia.com/gpu`
        capacity): exhaustive and exclusive."""
        from ..api.core import Node, Pod
        from ..cluster.scheduler import pod_tpu_request
        from ..cluster.slicepool import (
            POOL_CLAIMED_BY_ANNOTATION,
            POOL_PRIORITY_ANNOTATION,
            POOL_STATE_ANNOTATION,
            POOL_STATE_WARM,
        )
        from ..gpu import GKE_NODEPOOL_LABEL, GPU_RESOURCE

        if now is None:
            now = self.clock()

        nodes = [
            n
            for n in self.client.list(Node)
            if int(n.status.capacity.get(GPU_RESOURCE, "0") or 0) > 0
        ]
        if not nodes:
            return []

        # node -> bound GPU pod (the scheduler's exclusivity contract: at
        # most one GPU pod per node)
        bound: Dict[str, Any] = {}
        for pod in self.client.list(Pod):
            if pod.spec.node_name and pod_tpu_request(pod) > 0:
                if pod.metadata.deletion_timestamp:
                    continue
                bound.setdefault(pod.spec.node_name, pod)

        owners = self._owner_states()
        suspended_debt = self._suspended_owners(owners)

        # warm entries are anonymous once released (claimed_by cleared), so
        # the suspended-warm / pool-free split is counted OWNER-side: each
        # suspended object is owed one warm slice, settled against the
        # highest-priority warm entries first (the claim path's own order).
        warm_nodes: List[Tuple[int, str, List[Any]]] = []
        by_pool: Dict[str, List[Any]] = {}
        for n in nodes:
            pool = n.metadata.labels.get(GKE_NODEPOOL_LABEL, n.metadata.name)
            by_pool.setdefault(pool, []).append(n)
        for pool, members in sorted(by_pool.items()):
            lead = members[0]
            ann = lead.metadata.annotations
            if ann.get(POOL_STATE_ANNOTATION) == POOL_STATE_WARM and not any(
                m.metadata.name in bound for m in members
            ):
                prio = int(ann.get(POOL_PRIORITY_ANNOTATION, "0") or 0)
                warm_nodes.append((prio, pool, members))
        warm_nodes.sort(key=lambda t: (-t[0], t[1]))
        held_warm = {
            m.metadata.name
            for _, _, members in warm_nodes[: len(suspended_debt)]
            for m in members
        }

        out: List[Attribution] = []
        for node in nodes:
            name = node.metadata.name
            chips = int(node.status.capacity.get(GPU_RESOURCE, "0") or 0)
            pool = node.metadata.labels.get(GKE_NODEPOOL_LABEL, name)
            pod = bound.get(name)
            cls, obj = "pool", pool
            if pod is not None:
                cls, obj = self._pod_owner(pod)
            if not _node_ready(node):
                out.append(Attribution(name, chips, cls, obj, "repairing"))
                continue
            if pod is None:
                phase = self._free_phase(node, held_warm)
                if phase == "reclaim-churn":
                    # the bind window belongs to the object that asked for
                    # the chips, when the claim names one
                    claimer = node.metadata.annotations.get(
                        POOL_CLAIMED_BY_ANNOTATION, ""
                    )
                    if claimer:
                        obj = claimer
                out.append(Attribution(name, chips, cls, obj, phase))
                continue
            out.append(
                Attribution(
                    name, chips, cls, obj, self._bound_phase(cls, obj, owners, now)
                )
            )
        return out

    def _free_phase(self, node: Any, held_warm: set) -> str:
        from ..cluster.slicepool import (
            POOL_STATE_ANNOTATION,
            POOL_STATE_CLAIMED,
            POOL_STATE_WARM,
        )

        state = node.metadata.annotations.get(POOL_STATE_ANNOTATION)
        if state == POOL_STATE_CLAIMED:
            # claimed but nothing bound yet: the claim->bind window
            return "reclaim-churn"
        if state == POOL_STATE_WARM and node.metadata.name in held_warm:
            return "suspended-warm"
        return "pool-free"

    @staticmethod
    def _pod_owner(pod: Any) -> Tuple[str, str]:
        from ..controllers import constants as C

        labels = pod.metadata.labels
        ns = pod.metadata.namespace
        for cls, label in (
            ("notebook", C.NOTEBOOK_NAME_LABEL),
            ("inference", C.INFERENCE_NAME_LABEL),
            ("job", C.JOB_NAME_LABEL),
        ):
            owner = labels.get(label)
            if owner:
                return cls, f"{ns}/{owner}" if ns else owner
        return "pool", pod.metadata.name

    def _owner_states(self) -> Dict[Tuple[str, str], Dict[str, Any]]:
        """(class, ns/name) -> the annotation-durable state the machines in
        analysis/machines.py declare, plus the readiness/activity signals
        the bound-phase mapping needs."""
        from ..controllers import constants as C

        out: Dict[Tuple[str, str], Dict[str, Any]] = {}
        try:
            from ..api.notebook import Notebook

            for nb in self.client.list(Notebook):
                ann = nb.metadata.annotations
                key = f"{nb.metadata.namespace}/{nb.metadata.name}"
                tpu_status = getattr(nb.status, "tpu", None)
                out[("notebook", key)] = {
                    "suspend": ann.get(C.TPU_SUSPEND_STATE_ANNOTATION, ""),
                    "repair": ann.get(C.TPU_REPAIR_STATE_ANNOTATION, ""),
                    "stopped": C.STOP_ANNOTATION in ann,
                    "ready": bool(tpu_status and tpu_status.mesh_ready),
                    "last_activity": _parse_ts(
                        ann.get(C.LAST_ACTIVITY_ANNOTATION, "")
                    ),
                }
        except Exception:
            pass
        try:
            from ..api.inference import InferenceEndpoint

            for ep in self.client.list(InferenceEndpoint):
                ann = ep.metadata.annotations
                key = f"{ep.metadata.namespace}/{ep.metadata.name}"
                out[("inference", key)] = {
                    "state": ann.get(C.INFERENCE_STATE_ANNOTATION, ""),
                    "repair": ann.get(C.TPU_REPAIR_STATE_ANNOTATION, ""),
                    "stopped": C.STOP_ANNOTATION in ann,
                }
        except Exception:
            pass
        try:
            from ..api.job import TPUJob

            for job in self.client.list(TPUJob):
                ann = job.metadata.annotations
                key = f"{job.metadata.namespace}/{job.metadata.name}"
                out[("job", key)] = {
                    "state": ann.get(C.JOB_STATE_ANNOTATION, ""),
                    "repair": ann.get(C.TPU_REPAIR_STATE_ANNOTATION, ""),
                    "preempt": bool(ann.get(C.JOB_PREEMPT_ANNOTATION)),
                }
        except Exception:
            pass
        return out

    @staticmethod
    def _suspended_owners(
        owners: Dict[Tuple[str, str], Dict[str, Any]]
    ) -> List[Tuple[str, str]]:
        """Objects currently owed a warm slice: suspended notebooks, parked
        endpoints, preempted (requeue-pending) jobs."""
        out = []
        for (cls, key), st in owners.items():
            if cls == "notebook" and st.get("suspend") == "suspended":
                out.append((cls, key))
            elif cls == "inference" and st.get("state") == "suspended":
                out.append((cls, key))
            elif cls == "job" and st.get("state") == "preempted":
                out.append((cls, key))
        return out

    def _bound_phase(
        self,
        cls: str,
        obj: str,
        owners: Dict[Tuple[str, str], Dict[str, Any]],
        now: float,
    ) -> str:
        st = owners.get((cls, obj))
        if st is None:
            # pod bound but owner CR gone (delete in flight): winding down
            return "draining"
        if st.get("repair"):
            return "repairing"
        if cls == "notebook":
            if st["suspend"] in ("checkpointing",) or st["stopped"]:
                return "draining"
            if st["suspend"] in ("resuming",):
                return "starting"
            if not st["ready"]:
                return "starting"
            last = st.get("last_activity")
            if (
                self.idle_after_s > 0
                and last is not None
                and now - last > self.idle_after_s
            ):
                return "idle-bound"
            return "ready"
        if cls == "inference":
            state = st["state"]
            if state == "serving":
                return "ready"
            if state == "draining" or st["stopped"]:
                return "draining"
            return "starting"  # pending/loading/resuming shapes
        if cls == "job":
            state = st["state"]
            if st.get("preempt"):
                return "draining"
            if state in ("running", "checkpointing"):
                return "ready"
            return "starting"  # admitted / pending-bind
        return "starting"

    # -- the ledger --

    def tick(self, now: Optional[float] = None) -> float:
        """Classify + bank the elapsed interval; returns the chip-seconds
        attributed this tick (0.0 on the baseline-setting first call)."""
        if now is None:
            now = self.clock()
        try:
            # CPPROFILE=1 scan accounting: the tick thread has neither a
            # reconcile context nor a flow identity — name the sweep so its
            # list walks attribute to the accountant, not "unattributed"
            from . import cpprofile

            with cpprofile.sweep("chip-accountant"):
                attrs = self.classify(now)
        except Exception:
            tpu_accounting_ticks_total.inc(result="error")
            log.exception("accounting tick failed (classification)")
            return 0.0
        with self._lock:
            if self._started_at is None:
                self._started_at = now
            last = self._last_tick
            self._last_tick = now
            if last is None or now <= last:
                tpu_accounting_ticks_total.inc(result="ok")
                self._publish_current(attrs)
                return 0.0
            dt = now - last
            physical = sum(a.chips for a in attrs)
            self._verify_conservation(attrs, physical, dt)
            banked = 0.0
            for a in attrs:
                amount = a.chips * dt
                banked += amount
                k = (a.workload_class, a.phase)
                self._ledger[k] = self._ledger.get(k, 0.0) + amount
                ko = (a.workload_class, a.obj)
                self._objects[ko] = self._objects.get(ko, 0.0) + amount
                tpu_chip_seconds_total.inc(
                    amount, workload_class=a.workload_class, phase=a.phase
                )
                tpu_object_chip_seconds.set(
                    self._objects[ko], workload_class=a.workload_class, object=a.obj
                )
            self._physical_chip_seconds += physical * dt
            self._ticks += 1
            self._publish_current(attrs)
            self._publish_utilization_locked()
        tpu_accounting_ticks_total.inc(result="ok")
        return banked

    def _verify_conservation(
        self, attrs: List[Attribution], physical: int, dt: float
    ) -> None:
        """INVCHECK=1: re-verify the exhaustive/exclusive classification
        independently of the banking loop. Disarmed, this is one flag
        check — the calm path pays nothing."""
        if not invcheck.enabled():
            return
        seen: Dict[str, int] = {}
        for a in attrs:
            seen[a.node] = seen.get(a.node, 0) + 1
            if a.phase not in PHASES:
                raise invcheck.InvariantViolation(
                    "chip-conservation",
                    f"node {a.node} attributed to unknown phase {a.phase!r}",
                )
        doubled = [n for n, c in seen.items() if c > 1]
        if doubled:
            raise invcheck.InvariantViolation(
                "chip-conservation",
                f"nodes attributed more than once this tick: {doubled} — "
                f"chip-seconds would be double-counted",
            )
        attributed = sum(a.chips for a in attrs) * dt
        expected = physical * dt
        if expected > 0 and abs(attributed - expected) > self.tolerance * expected:
            raise invcheck.InvariantViolation(
                "chip-conservation",
                f"attributed {attributed:.3f} chip-s != physical "
                f"{expected:.3f} chip-s over dt={dt:.3f}s "
                f"(tolerance {self.tolerance:.0%})",
            )

    def _publish_current(self, attrs: List[Attribution]) -> None:
        current: Dict[Tuple[str, str], int] = {}
        for a in attrs:
            k = (a.workload_class, a.phase)
            current[k] = current.get(k, 0) + a.chips
        # publish the full (seen-class x phase) grid so a bucket emptying is
        # visible as 0, not as a stale last value
        classes = {c for c, _ in current} | {c for c, _ in self._ledger}
        for cls in classes:
            for phase in PHASES:
                tpu_fleet_chips.set(
                    float(current.get((cls, phase), 0)),
                    workload_class=cls,
                    phase=phase,
                )

    def _publish_utilization_locked(self) -> None:
        total = sum(self._ledger.values())
        if total <= 0:
            return
        productive = sum(
            v for (_, phase), v in self._ledger.items()
            if phase in PRODUCTIVE_PHASES
        )
        tpu_fleet_utilization_ratio.set(
            min(1.0, max(0.0, productive / total))
        )

    # -- read surfaces --

    def snapshot(
        self,
        workload_class: Optional[str] = None,
        obj: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> Dict[str, Any]:
        """The /debug/accounting + flight-recorder payload: the full ledger,
        the conservation arithmetic, and the per-object detail (largest
        consumers first, optionally filtered/capped)."""
        with self._lock:
            ledger = dict(self._ledger)
            objects = dict(self._objects)
            physical = self._physical_chip_seconds
            started = self._started_at
            last = self._last_tick
            ticks = self._ticks
        total = sum(ledger.values())
        productive = sum(
            v for (_, p), v in ledger.items() if p in PRODUCTIVE_PHASES
        )
        by_phase: Dict[str, float] = {}
        by_class: Dict[str, float] = {}
        for (cls, phase), v in ledger.items():
            by_phase[phase] = by_phase.get(phase, 0.0) + v
            by_class[cls] = by_class.get(cls, 0.0) + v
        rows = [
            {
                "workload_class": cls,
                "object": o,
                "chip_seconds": round(v, 3),
            }
            for (cls, o), v in sorted(
                objects.items(), key=lambda kv: -kv[1]
            )
            if (workload_class is None or cls == workload_class)
            and (obj is None or o == obj)
        ]
        if limit is not None:
            rows = rows[: max(0, limit)]
        residual = total - physical
        return {
            "started_at": started,
            "last_tick": last,
            "ticks": ticks,
            "chip_seconds": {
                "total_attributed": round(total, 3),
                "physical": round(physical, 3),
                "residual": round(residual, 3),
                "residual_ratio": (
                    round(residual / physical, 6) if physical > 0 else 0.0
                ),
                "by_phase": {p: round(v, 3) for p, v in sorted(by_phase.items())},
                "by_class": {c: round(v, 3) for c, v in sorted(by_class.items())},
            },
            "fleet_utilization": (
                round(min(1.0, productive / total), 6) if total > 0 else None
            ),
            "goodput_views": {
                "job": {
                    "productive_s": round(job_goodput.totals()[0], 3),
                    "wall_s": round(job_goodput.totals()[1], 3),
                    "ratio": job_goodput.ratio(),
                },
                "slice": {
                    "good_s": round(slice_goodput.totals()[0], 3),
                    "observed_s": round(slice_goodput.totals()[1], 3),
                    "ratio": slice_goodput.ratio(),
                },
            },
            "objects": rows,
        }

    def conservation(self) -> Dict[str, float]:
        """The invariant's arithmetic as numbers: attributed vs physical
        chip-seconds and their residual."""
        with self._lock:
            total = sum(self._ledger.values())
            physical = self._physical_chip_seconds
        return {
            "attributed_chip_seconds": total,
            "physical_chip_seconds": physical,
            "residual_ratio": (
                abs(total - physical) / physical if physical > 0 else 0.0
            ),
        }

    def chip_seconds(self, workload_class: Optional[str] = None,
                     phase: Optional[str] = None) -> float:
        with self._lock:
            return sum(
                v
                for (c, p), v in self._ledger.items()
                if (workload_class is None or c == workload_class)
                and (phase is None or p == phase)
            )

    def reset_for_test(self) -> None:
        with self._lock:
            self._ledger.clear()
            self._objects.clear()
            self._physical_chip_seconds = 0.0
            self._last_tick = None
            self._started_at = None
            self._ticks = 0

    # -- manager-service lifecycle (the PoolPrewarmer idiom) --

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="chip-accountant"
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.tick()
            except invcheck.InvariantViolation:
                raise  # an armed soak must fail loudly, not log-and-continue
            except Exception:
                log.exception("chip accountant tick failed")

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
        self._thread = None


# process-wide handle: the flight recorder freezes the active accountant's
# snapshot into incident bundles without plumbing a reference through every
# snapshot() caller (the profiler's module-handle idiom)
_current: Optional[ChipAccountant] = None


def set_current(accountant: Optional[ChipAccountant]) -> None:
    global _current
    _current = accountant


def current() -> Optional[ChipAccountant]:
    return _current
