"""InferenceEndpoint reconciler: notebook -> serving promotion (the port's
copy of odh_kubeflow_tpu/controllers/inference.py, on GPU slices).

The second workload class: a notebook's model and checkpoint promoted into a
long-lived serving deployment that contends for the same cards as the
interactive fleet. The reconciler reuses the notebook stack end to end —
StatefulSet + headless per-host Service for gang DNS, the GPU scheduler's
gang placement and claimed-pool reservations, the warm slice pool, the probe
agent's /tpu/* surface, the gateway HTTPRoute shape — rather than growing a
parallel serving stack. The slice's pod fields (replicas, the node selector,
the `nvidia.com/gpu` toleration, requests and limits, the torchrun env) come
from `gpu.apply_slice`, the notebook path's one rendering rule; an endpoint
pod on a one-card slice is one serving process (`PET_STANDALONE`).

State machine (annotation-durable like suspend/repair; declared as data in
analysis/machines.py, which INVCHECK's transition invariant judges):

    Pending ("") ──gang ready──> Loading ──verified──> Serving ⇄ Suspended
         │                          │  window expired /        │ stop
         │ stop                     │  checksum mismatch       v
         └────> Draining <──────────┴──> LoadFailed       Draining
                   │ drained/deadline     (terminal, self-healing,
                   v                       incident bundle)
               Terminated (replicas 0; slice released warm)

Serving is FLEET management: `spec.serving.replicas` /
`spec.serving.autoscaling` (or the autoscaler's desired-replicas
annotation) sets how many independent replica GANGS to run — each its own
StatefulSet + gang-DNS headless Service + slicepool claim. Scale-up is a
warm bind from the pool; scale-down is a route-first bounded per-replica
drain back to the pool (the router stops picking `status.drainingReplicas`
before the slice releases); desired 0 with `scaleToZero` parks the whole
endpoint Suspended-with-a-route that cold-wakes when anything bumps
desired replicas back up. The endpoint stays Serving while >= 1 gang is
healthy, carrying a DegradedServing condition below full strength; only a
FULL outage re-enters Loading.

- **Promotion is a warm bind.** With ``spec.notebookRef`` naming a
  just-suspended notebook, Pending claims the source's released slice from
  the warm pool under the endpoint's own key (the scheduler's claimed-pool
  check admits only the claimant's pods) and inherits the slice shape and
  checkpoint lineage (saved step + checksum annotations).
- **Loading verifies the restore.** Every host must report /tpu/readiness
  green AND ordinal 0's /tpu/restore checksum must match the checksum the
  suspend-side checkpoint acked. A mismatch or an expired window is an
  explicit LoadFailed with an incident bundle, never a silent wedge. A pod
  whose agent runs beside a serving process (`probe.behavior`) reports
  ready only once that process has restored and listens, and its
  /tpu/restore forwards to it, so the verdict reads what is served.
- **Draining fails fast, never hangs.** A stop tears the route down FIRST,
  gives in-flight requests a bounded window, then scales the gang away and
  releases the slice warm (general capacity when reclaim-forced). A
  Draining endpoint is never a reclaim victim.
- **No repair-machine fight by construction:** slice-repair watches
  Notebooks only; a preempted serving host surfaces as lost readiness here
  (Serving -> Loading re-verify) while the drain/terminate path stays
  exclusively this machine's.
"""
from __future__ import annotations

import json
import logging
import time
from typing import Dict, List, Optional, Tuple

from ..api.apps import StatefulSet
from ..api.core import (
    Container,
    ContainerPort,
    Node,
    Pod,
    Service,
    ServicePort,
    emit_deduped_event,
)
from ..api.gateway import (
    HTTPBackendRef,
    HTTPPathMatch,
    HTTPRoute,
    HTTPRouteMatch,
    HTTPRouteRule,
    ParentReference,
)
from ..api.inference import InferenceEndpoint
from ..api.notebook import Notebook, TPUSpec, TPUStatus
from ..apimachinery import (
    AlreadyExistsError,
    Condition,
    NotFoundError,
    parse_time,
    rfc3339_precise,
    sanitize_name,
)
from ..cluster.client import retry_on_conflict
from ..cluster.slicepool import SlicePool
from ..runtime.controller import Request, Result
from ..runtime.flightrecorder import recorder
from ..runtime.manager import Manager
from ..serving import metrics as serving_metrics
from ..gpu import GKE_NODEPOOL_LABEL, SliceShape, apply_slice, plan_slice
from ..utils import tracing
from ..utils.tracing import record_span
from . import constants as C
from .config import Config
from .culling import HTTPGet, _default_http_get

log = logging.getLogger(__name__)

# annotation values of the inference endpoint machine ("" = Pending)
STATE_LOADING = "loading"
STATE_SERVING = "serving"
STATE_DRAINING = "draining"
STATE_TERMINATED = "terminated"
STATE_LOAD_FAILED = "load-failed"
STATE_SUSPENDED = "suspended"  # scale-to-zero park

INFERENCE_PORT = 8000  # in-pod serving engine HTTP port


def endpoint_priority(ep: InferenceEndpoint) -> int:
    """Reclaim ordering for endpoints: spec.tpu.priority, with the unset
    default ABOVE interactive notebooks — live traffic
    outranks an idle notebook unless the operator says otherwise."""
    if ep.spec.tpu is not None:
        try:
            explicit = int(ep.spec.tpu.priority)
        except (TypeError, ValueError):
            explicit = 0
        if explicit:
            return explicit
    return C.ENDPOINT_DEFAULT_PRIORITY


def probe_restore_ack(http_get, url: str, timeout: float = 2.0) -> Optional[dict]:
    """GET an agent's /tpu/restore and parse the ack; None = unreachable.
    The ONE copy of the probe protocol both restore-verification consumers
    (the resume path in suspend.py and the endpoint Loading gate here)
    share — ack parsing and timeout handling must never drift apart."""
    try:
        try:
            status, body = http_get(url, timeout=timeout)
        except TypeError:  # custom http_get without timeout kwarg
            status, body = http_get(url)
        if status != 200:
            raise ConnectionError(f"GET {url} -> {status}")
        return json.loads(body.decode() or "null") or {}
    except Exception as e:
        log.debug("restore probe %s failed: %s", url, e)
        return None


def classify_restore(ack: Optional[dict], expected: str) -> Tuple[str, str]:
    """Shared verdict over a /tpu/restore ack vs the saved digest:
    (ok | mismatch | unverified, detail)."""
    if not expected:
        return "unverified", "no saved-checkpoint checksum to verify against"
    if ack is None:
        return "unverified", "restore probe unreachable"
    if not ack.get("restored"):
        return "unverified", ack.get("reason") or "restore not performed"
    got = str(ack.get("checksum") or "")
    if not got:
        return "unverified", "restore ack carried no checksum"
    if got == expected:
        return "ok", f"checksum {got} matches (step {ack.get('step')})"
    return "mismatch", f"saved {expected} != restored {got}"


def source_notebook(client, ep: InferenceEndpoint) -> Optional[Notebook]:
    """The promotion source named by spec.notebookRef (None when absent or
    deleted)."""
    ref = ep.spec.notebook_ref
    if ref is None or not ref.name:
        return None
    ns = ref.namespace or ep.metadata.namespace
    try:
        return client.get(Notebook, ns, ref.name)
    except NotFoundError:
        return None


def resolve_endpoint_tpu(client, ep: InferenceEndpoint) -> Optional[TPUSpec]:
    """The endpoint's slice shape: its own spec.tpu, else inherited from the
    promotion source (shared with the oversubscription reclaimer, which must
    shape-match endpoint victims exactly like notebook victims)."""
    if ep.spec.tpu is not None and ep.spec.tpu.accelerator:
        return ep.spec.tpu
    src = source_notebook(client, ep)
    if src is not None and src.spec.tpu is not None and \
            src.spec.tpu.accelerator:
        return src.spec.tpu
    return None


def endpoint_statefulset_name(name: str, replica: int = 0) -> str:
    """`-serve` suffix keeps a promoted endpoint's workload disjoint from a
    same-named notebook's STS/pods in the same namespace. Replica 0 keeps
    the pre-fleet name (upgrades roll nothing); replica i >= 1 appends
    `-r{i}` — each replica gang is its OWN StatefulSet."""
    suffix = "-serve" if replica <= 0 else f"-serve-r{replica}"
    return sanitize_name(f"{name}{suffix}", max_len=52)


def endpoint_service_name(name: str) -> str:
    return sanitize_name(f"{name}-serve", max_len=63)


def endpoint_hosts_service_name(name: str, replica: int = 0) -> str:
    suffix = "-serve-hosts" if replica <= 0 else f"-serve-r{replica}-hosts"
    return sanitize_name(f"{name}{suffix}", max_len=63)


def endpoint_desired_replicas(ep: InferenceEndpoint) -> int:
    """The fleet size the controller converges toward: the autoscaler's
    desired-replicas annotation when present (the HPA analog — the
    autoscaler owns that annotation, this controller owns the state
    machine), else `spec.serving.replicas`, clamped into
    `spec.serving.autoscaling.{min,max}`. 0 is only reachable with
    `autoscaling.scaleToZero` — anything else floors at minReplicas."""
    serving = ep.spec.serving
    try:
        static = max(1, int(serving.replicas or 1))
    except (TypeError, ValueError):
        static = 1
    desired = static
    raw = ep.metadata.annotations.get(C.INFERENCE_DESIRED_REPLICAS_ANNOTATION)
    if raw is not None:
        try:
            desired = int(raw)
        except (TypeError, ValueError):
            desired = static
    auto = serving.autoscaling
    if auto is None:
        return max(1, desired)
    hi = max(1, int(auto.max_replicas))
    lo = max(1, min(int(auto.min_replicas), hi))
    if desired <= 0:
        return 0 if auto.scale_to_zero else lo
    return min(hi, max(lo, desired))


def endpoint_route_name(ep: InferenceEndpoint) -> str:
    return sanitize_name(
        f"{ep.metadata.namespace}-{ep.metadata.name}-serve", max_len=63
    )


class InferenceEndpointReconciler:
    def __init__(
        self,
        manager: Manager,
        config: Optional[Config] = None,
        http_get: Optional[HTTPGet] = None,
    ):
        self.manager = manager
        self.client = manager.client
        self.api_reader = manager.api_reader
        self.config = config or Config()
        self.http_get = http_get or _default_http_get
        self.pool = SlicePool(manager.client, reader=manager.api_reader)

    def setup(self) -> None:
        def pod_is_endpoint(ev: str, obj: dict, old: Optional[dict]) -> bool:
            return C.INFERENCE_NAME_LABEL in obj.get("metadata", {}).get(
                "labels", {}
            )

        def map_pod(obj: dict) -> List[tuple]:
            meta = obj.get("metadata", {})
            name = meta.get("labels", {}).get(C.INFERENCE_NAME_LABEL)
            return [(meta.get("namespace", ""), name)] if name else []

        (
            self.manager.builder("inference-endpoint")
            .for_(InferenceEndpoint)
            .owns(StatefulSet)
            .owns(Service)
            .watches(Pod, map_pod, predicate=pod_is_endpoint)
            .with_workers(self.config.max_concurrent_reconciles)
            .complete(self.reconcile)
        )

    # ---------- spec resolution ----------

    def _source_notebook(self, ep: InferenceEndpoint) -> Optional[Notebook]:
        # read from the store, not the cache: a suspend that finished before
        # the endpoint was created is then seen as finished, and the bind
        # is not deferred while the workload is placed cold
        return source_notebook(self.api_reader, ep)

    def _resolve_tpu(self, ep: InferenceEndpoint) -> Optional[TPUSpec]:
        return resolve_endpoint_tpu(self.client, ep)

    # ---------- reconcile ----------

    def reconcile(self, req: Request) -> Optional[Result]:
        try:
            ep = self.api_reader.get(InferenceEndpoint, req.namespace, req.name)
        except NotFoundError:
            self._release_claims(req.key, back_to_warm=True)
            tracing.discard_root_for(f"endpoint:{req.key}")
            return None
        if ep.metadata.deletion_timestamp:
            self._release_claims(req.key, back_to_warm=True)
            tracing.discard_root_for(f"endpoint:{req.key}")
            return None

        tpu = self._resolve_tpu(ep)
        if tpu is None:
            self._emit_event(
                ep, "EndpointInvalid",
                "no TPU spec: set spec.tpu or point spec.notebookRef at a "
                "TPU notebook to inherit its slice shape",
            )
            return None
        shape = plan_slice(tpu.accelerator, tpu.topology, tpu.chips)

        self._ensure_trace_root(ep)
        ann = ep.metadata.annotations
        state = ann.get(C.INFERENCE_STATE_ANNOTATION, "")
        stopped = C.STOP_ANNOTATION in ann
        now = time.time()

        if stopped:
            if state in (
                "", STATE_LOADING, STATE_SERVING, STATE_LOAD_FAILED,
                STATE_SUSPENDED,
            ):
                # route down FIRST: no new traffic lands while the drain
                # window runs; the in-pod engine fails leftovers fast
                self._delete_route(ep)
                drain_s = ep.spec.serving.drain_timeout_s or \
                    self.config.serving_drain_timeout_s
                self._patch_annotations(
                    ep,
                    {
                        C.INFERENCE_STATE_ANNOTATION: STATE_DRAINING,
                        C.INFERENCE_DRAIN_DEADLINE_ANNOTATION: (
                            rfc3339_precise(now + drain_s)
                        ),
                        C.INFERENCE_LOADING_DEADLINE_ANNOTATION: None,
                        C.INFERENCE_REPLICA_DRAIN_ANNOTATION: None,
                        C.INFERENCE_SUSPENDED_AT_ANNOTATION: None,
                    },
                )
                self._emit_event(
                    ep, "EndpointDraining",
                    f"stop requested: route removed, in-flight requests get "
                    f"{drain_s:.0f}s to drain before the slice scales away",
                    etype="Normal",
                )
                recorder.record(
                    "transition", machine="inference", endpoint=req.key,
                    state=STATE_DRAINING,
                    reclaim=bool(ann.get(C.TPU_RECLAIM_ANNOTATION)),
                )
                return Result(requeue_after=0.02)
            if state == STATE_DRAINING:
                return self._run_drain(ep, shape, now, req)
            if state == STATE_TERMINATED:
                # parked: keep replicas at 0, nothing else to converge
                self._reconcile_workload(ep, shape, replicas=0)
                self._mirror_status(ep, shape, phase="Terminated")
                return None
            log.warning("unknown inference state %r on %s; clearing",
                        state, req.key)
            self._patch_annotations(
                ep, {C.INFERENCE_STATE_ANNOTATION: None}
            )
            return Result(requeue_after=0.05)

        # -- not stopped --
        if state in (STATE_TERMINATED, STATE_LOAD_FAILED, STATE_DRAINING):
            # unstop (Terminated), self-heal (LoadFailed: pods came back or
            # the spec changed), or a stop withdrawn mid-drain: a fresh
            # Pending episode re-converges everything level-triggered.
            # (draining->"" rides the defensive-clear edge: the stop was
            # withdrawn before the drain finished, nothing was torn down)
            self._patch_annotations(
                ep,
                {
                    C.INFERENCE_STATE_ANNOTATION: None,
                    C.INFERENCE_DRAIN_DEADLINE_ANNOTATION: None,
                    C.INFERENCE_LOADING_DEADLINE_ANNOTATION: None,
                },
            )
            recorder.record(
                "transition", machine="inference", endpoint=req.key,
                state="pending", from_state=state,
            )
            return Result(requeue_after=0.02)
        if state == STATE_SUSPENDED:
            if endpoint_desired_replicas(ep) > 0:
                # cold-wake: the router's first request (or the autoscaler,
                # or an operator) bumped desired replicas — a fresh Pending
                # episode warm-binds from the pool, route already up
                self._patch_annotations(
                    ep,
                    {
                        C.INFERENCE_STATE_ANNOTATION: None,
                        C.INFERENCE_SUSPENDED_AT_ANNOTATION: None,
                    },
                )
                self._emit_event(
                    ep, "EndpointWaking",
                    "cold-wake from scale-to-zero: desired replicas > 0, "
                    "re-placing the fleet (warm bind when the pool has the "
                    "shape)",
                    etype="Normal",
                )
                recorder.record(
                    "transition", machine="inference", endpoint=req.key,
                    state="pending", from_state=STATE_SUSPENDED,
                    reason="cold-wake",
                )
                return Result(requeue_after=0.02)
            return self._hold_suspended(ep, shape)
        if state == "":
            return self._run_pending(ep, shape, now, req)
        if state == STATE_LOADING:
            return self._run_loading(ep, shape, now, req)
        if state == STATE_SERVING:
            return self._run_serving(ep, shape, now, req)
        log.warning("unknown inference state %r on %s; clearing", state, req.key)
        self._patch_annotations(ep, {C.INFERENCE_STATE_ANNOTATION: None})
        return Result(requeue_after=0.05)

    # ---------- Pending ----------

    def _run_pending(
        self, ep: InferenceEndpoint, shape: SliceShape, now: float, req: Request
    ) -> Result:
        fleet = max(1, endpoint_desired_replicas(ep))
        self._ensure_promotion(ep, shape, req)
        self._reconcile_workload(ep, shape, replicas=shape.hosts, fleet=fleet)
        self._mirror_status(ep, shape, phase="Pending", desired=fleet)
        if self._hosts_ready(ep, shape):
            window = self.config.serving_loading_window_s
            self._patch_annotations(
                ep,
                {
                    C.INFERENCE_STATE_ANNOTATION: STATE_LOADING,
                    C.INFERENCE_LOADING_DEADLINE_ANNOTATION: (
                        rfc3339_precise(now + window)
                    ),
                },
            )
            recorder.record(
                "transition", machine="inference", endpoint=req.key,
                state=STATE_LOADING,
            )
            return Result(requeue_after=0.02)
        # pressure valve for cold promotions: a gang sitting unschedulable
        # past the grace takes the lowest-priority matching IDLE warm slice
        # (active-victim reclaim stays the suspend controller's monopoly —
        # one writer per policy)
        self._maybe_reclaim_idle_for(ep, shape, now)
        return Result(
            requeue_after=max(0.05, self.config.readiness_probe_period_s / 2)
        )

    def _ensure_promotion(
        self, ep: InferenceEndpoint, shape: SliceShape, req: Request
    ) -> None:
        """One-shot promotion bind: inherit the source notebook's checkpoint
        lineage and claim its warm slice when it just suspended. Idempotent
        — an existing claim under our key (or the stamped promoted-from
        annotation) means the bind already happened."""
        ann = ep.metadata.annotations
        if C.INFERENCE_PROMOTED_FROM_ANNOTATION in ann:
            return
        src = self._source_notebook(ep)
        if src is None:
            return
        src_ann = src.metadata.annotations
        src_state = src_ann.get(C.TPU_SUSPEND_STATE_ANNOTATION, "")
        src_stopped = (
            C.STOP_ANNOTATION in src_ann
            and src_ann[C.STOP_ANNOTATION] != C.RECONCILIATION_LOCK_VALUE
        )
        if src_state == "checkpointing" or (src_stopped and not src_state):
            # the source's suspend is IN FLIGHT: its warm release and
            # checkpoint lineage are one window away. Stamping now would
            # make the one-shot bind permanent-cold and inherit nothing —
            # defer, the next reconcile retries (the advertised flow is
            # "stop the notebook, create the endpoint" back to back)
            return
        src_key = f"{src.metadata.namespace}/{src.metadata.name}"
        updates: Dict[str, Optional[str]] = {
            C.INFERENCE_PROMOTED_FROM_ANNOTATION: src_key,
        }
        for key in (
            C.TPU_CHECKPOINT_SAVED_ANNOTATION,
            C.TPU_CHECKPOINT_CHECKSUM_ANNOTATION,
        ):
            value = src.metadata.annotations.get(key)
            if value and key not in ann:
                updates[key] = value
        warm = False
        if any(p.spec.node_name for p in self._pods(ep)):
            pass  # pods already placed: a claim now would strand a reservation
        elif not any(
            e.claimed_by == req.key
            for e in self.pool.entries(include_unhealthy=True)
        ):
            if src_state == "suspended":
                entry = self.pool.claim(
                    shape.gke_accelerator, shape.topology, req.key
                )
                warm = entry is not None
        serving_metrics.inference_endpoint_promotions_total.inc(
            bind="warm" if warm else "cold"
        )
        self._patch_annotations(ep, updates)
        self._emit_event(
            ep, "EndpointPromoted",
            f"promoted from notebook {src_key}: "
            + ("claimed its warm slice from the pool (warm bind)" if warm
               else "no warm slice to claim; cold placement"),
            etype="Normal",
        )
        record_span(
            "endpoint.promotion",
            traceparent=ep.metadata.annotations.get(C.TRACEPARENT_ANNOTATION),
            endpoint=ep.metadata.name,
            namespace=ep.metadata.namespace,
            source=src_key,
            warm_bind=warm,
        )
        log.info("promotion %s <- %s (%s bind)", req.key, src_key,
                 "warm" if warm else "cold")

    def _maybe_reclaim_idle_for(
        self, ep: InferenceEndpoint, shape: SliceShape, now: float
    ) -> None:
        pending = [
            p for p in self._pods(ep)
            if not p.spec.node_name and not p.metadata.deletion_timestamp
        ]
        if not pending:
            return
        oldest = now
        for p in pending:
            try:
                oldest = min(
                    oldest, parse_time(p.metadata.creation_timestamp).timestamp()
                )
            except (ValueError, TypeError):
                pass
        if now - oldest < self.config.reclaim_pending_grace_s:
            return
        victim = self.pool.reclaim_idle(shape.gke_accelerator, shape.topology)
        if victim is not None:
            self._emit_event(
                ep, "SliceReclaimed",
                f"reclaimed idle warm slice {victim.pool} (priority "
                f"{victim.priority}) to place this endpoint", etype="Normal",
            )

    # ---------- Loading ----------

    def _run_loading(
        self, ep: InferenceEndpoint, shape: SliceShape, now: float, req: Request
    ) -> Optional[Result]:
        fleet = max(1, endpoint_desired_replicas(ep))
        self._reconcile_workload(ep, shape, replicas=shape.hosts, fleet=fleet)
        self._mirror_status(ep, shape, phase="Loading", desired=fleet)
        deadline_s = ep.metadata.annotations.get(
            C.INFERENCE_LOADING_DEADLINE_ANNOTATION, ""
        )
        try:
            deadline = parse_time(deadline_s).timestamp()
        except ValueError:
            deadline = now + self.config.serving_loading_window_s

        gang = self._first_ready_gang(ep, shape)
        if gang is not None and self._mesh_ready(ep, shape, replica=gang):
            verdict, detail = self._verify_restore(ep, shape, replica=gang)
            if verdict == "mismatch":
                return self._fail_loading(
                    ep, now, req,
                    f"restore verification FAILED: {detail} — the restored "
                    "kernel does not equal the saved one",
                )
            return self._complete_loading(ep, shape, now, req, verdict)
        if now >= deadline:
            return self._fail_loading(
                ep, now, req,
                f"loading window expired before any replica gang reached "
                f"mesh-ready ({self._ready_count(ep)}/{shape.hosts} hosts "
                f"ready)",
            )
        return Result(requeue_after=max(
            0.02, min(self.config.readiness_probe_period_s / 2, deadline - now)
        ))

    def _verify_restore(
        self, ep: InferenceEndpoint, shape: SliceShape, replica: int = 0
    ) -> Tuple[str, str]:
        """Ordinal 0's /tpu/restore checksum vs the saved-checkpoint digest
        inherited at promotion (the digest is ordinal 0's own — per-shard
        saves make cross-ordinal comparison meaningless). Returns
        (ok|mismatch|unverified, detail) via the shared protocol."""
        expected = ep.metadata.annotations.get(
            C.TPU_CHECKPOINT_CHECKSUM_ANNOTATION, ""
        )
        urls = self._probe_urls(ep, shape, "/tpu/restore", replica=replica)
        ack = probe_restore_ack(self.http_get, urls[0]) if (
            expected and urls
        ) else None
        verdict, detail = classify_restore(ack, expected)
        serving_metrics.inference_restore_verifications_total.inc(
            result=verdict
        )
        return verdict, detail

    def _complete_loading(
        self, ep: InferenceEndpoint, shape: SliceShape, now: float,
        req: Request, verify_verdict: str,
    ) -> Optional[Result]:
        # bind window over: the slice is plainly owned by its pods — pool
        # marks off so a later drain re-releases it cleanly (suspend idiom)
        self._release_claims(req.key, back_to_warm=False)
        self._patch_annotations(
            ep,
            {
                C.INFERENCE_STATE_ANNOTATION: STATE_SERVING,
                C.INFERENCE_LOADING_DEADLINE_ANNOTATION: None,
            },
        )
        self._ensure_route(ep)
        self._mirror_status(
            ep, shape, phase="Serving",
            desired=max(1, endpoint_desired_replicas(ep)),
        )
        self._emit_event(
            ep, "EndpointServing",
            "serving: every host mesh-ready, restore "
            + ("verified" if verify_verdict == "ok" else verify_verdict)
            + ", route live",
            etype="Normal",
        )
        recorder.record(
            "transition", machine="inference", endpoint=req.key,
            state=STATE_SERVING, restore=verify_verdict,
        )
        self._close_ready_root(ep, now)
        log.info("endpoint %s serving (restore %s)", req.key, verify_verdict)
        return Result(requeue_after=max(
            1.0, self.config.readiness_probe_period_s * 6
        ))

    def _fail_loading(
        self, ep: InferenceEndpoint, now: float, req: Request, message: str
    ) -> None:
        self._patch_annotations(
            ep,
            {
                C.INFERENCE_STATE_ANNOTATION: STATE_LOAD_FAILED,
                C.INFERENCE_LOADING_DEADLINE_ANNOTATION: None,
            },
        )
        self._emit_event(ep, "LoadFailed", message)
        recorder.record(
            "transition", machine="inference", endpoint=req.key,
            state=STATE_LOAD_FAILED,
        )
        recorder.snapshot(
            "endpoint-load-failed", subject=req.key, client=self.client,
            extra={"message": message},
        )
        log.error("endpoint %s LoadFailed: %s", req.key, message)
        return None

    # ---------- Serving ----------

    def _run_serving(
        self, ep: InferenceEndpoint, shape: SliceShape, now: float, req: Request
    ) -> Optional[Result]:
        """Serving is fleet management: converge the replica-gang
        count toward `endpoint_desired_replicas`, where scale-up is a warm
        bind from the pool, scale-down is a route-first bounded per-replica
        drain back to the pool, and desired 0 (scaleToZero) parks the whole
        endpoint Suspended-with-a-route. The endpoint stays Serving while
        >= 1 gang is healthy (DegradedServing condition below full
        strength); only a FULL outage re-enters Loading to re-form."""
        desired = endpoint_desired_replicas(ep)
        auto = ep.spec.serving.autoscaling
        if desired == 0 and auto is not None and auto.scale_to_zero:
            return self._park_suspended(ep, shape, now, req)
        desired = max(1, desired)

        drain = self._replica_drain(ep)
        observed = self._observed_fleet(ep)
        if drain is not None:
            victim, deadline = drain
            if desired > victim:
                # scale-down withdrawn (burn came back): keep the victim
                self._patch_annotations(
                    ep, {C.INFERENCE_REPLICA_DRAIN_ANNOTATION: None}
                )
                return Result(requeue_after=0.02)
            # victim stays up (its STS untouched) but OUT of rotation: the
            # router reads status.draining_replicas and stops picking it
            self._reconcile_workload(
                ep, shape, replicas=shape.hosts, fleet=victim + 1
            )
            self._ensure_route(ep)
            self._mirror_status(
                ep, shape, phase="Serving", desired=desired, draining=victim
            )
            if now >= deadline:
                self._retire_replica(ep, shape, victim, now, req, desired)
                return Result(requeue_after=0.02)
            return Result(requeue_after=max(0.02, min(deadline - now, 1.0)))

        if observed > desired:
            # route-first: pick the highest gang as victim, open its bounded
            # drain window; the slice releases warm at retire
            victim = observed - 1
            drain_s = ep.spec.serving.drain_timeout_s or \
                self.config.serving_drain_timeout_s
            self._patch_annotations(
                ep,
                {
                    C.INFERENCE_REPLICA_DRAIN_ANNOTATION: json.dumps(
                        {"replica": victim,
                         "deadline": rfc3339_precise(now + drain_s)}
                    ),
                },
            )
            self._emit_event(
                ep, "ReplicaDraining",
                f"scale-down {observed}->{desired}: replica {victim} out of "
                f"rotation, in-flight requests get {drain_s:.0f}s before its "
                "slice releases warm",
                etype="Normal",
            )
            recorder.record(
                "scale", machine="inference", endpoint=req.key,
                direction="down", replica=victim, fleet=observed,
                desired=desired,
            )
            return Result(requeue_after=0.02)

        if observed < desired:
            # scale-up: one warm-bind attempt per missing gang before the
            # STSs materialize — a pool hit skips the cold placement path
            warm = 0
            for _ in range(observed, desired):
                entry = self.pool.claim(
                    shape.gke_accelerator, shape.topology, req.key
                )
                if entry is not None:
                    warm += 1
            self._reconcile_workload(
                ep, shape, replicas=shape.hosts, fleet=desired
            )
            self._ensure_route(ep)
            self._mirror_status(ep, shape, phase="Serving", desired=desired)
            self._emit_event(
                ep, "ReplicaScalingUp",
                f"scale-up {observed}->{desired}: {warm} warm bind(s), "
                f"{desired - observed - warm} cold placement(s)",
                etype="Normal",
            )
            recorder.record(
                "scale", machine="inference", endpoint=req.key,
                direction="up", fleet=observed, desired=desired, warm=warm,
            )
            record_span(
                "endpoint.scale_up",
                traceparent=ep.metadata.annotations.get(
                    C.TRACEPARENT_ANNOTATION
                ),
                endpoint=ep.metadata.name,
                namespace=ep.metadata.namespace,
                from_replicas=observed,
                to_replicas=desired,
                warm_binds=warm,
            )
            return Result(requeue_after=0.05)

        self._reconcile_workload(ep, shape, replicas=shape.hosts, fleet=desired)
        self._ensure_route(ep)
        self._mirror_status(ep, shape, phase="Serving", desired=desired)
        ready_gangs = self._ready_gangs(ep, shape)
        if len(ready_gangs) >= desired:
            # full strength: any leftover scale-up claims have served their
            # bind window (the suspend idiom — pods plainly own the slices)
            self._release_claims(req.key, back_to_warm=False)
        if not ready_gangs:
            # EVERY gang lost readiness (preemption, crash): back to Loading
            # to re-form and re-verify — the repair controller never touches
            # endpoints, so this edge is the whole recovery story. A partial
            # loss stays Serving (DegradedServing condition) and the gang
            # re-places through the same level-triggered workload reconcile.
            window = self.config.serving_loading_window_s
            self._patch_annotations(
                ep,
                {
                    C.INFERENCE_STATE_ANNOTATION: STATE_LOADING,
                    C.INFERENCE_LOADING_DEADLINE_ANNOTATION: (
                        rfc3339_precise(now + window)
                    ),
                },
            )
            self._emit_event(
                ep, "EndpointDegraded",
                f"lost ALL replica readiness while Serving "
                f"({self._ready_count(ep)} hosts ready across the fleet): "
                "re-entering Loading to re-form and re-verify",
            )
            recorder.record(
                "transition", machine="inference", endpoint=req.key,
                state=STATE_LOADING, reason="readiness-lost",
            )
            return Result(requeue_after=0.05)
        return Result(requeue_after=max(
            1.0, self.config.readiness_probe_period_s * 6
        ))

    # ---------- fleet scale-down / scale-to-zero ----------

    def _replica_drain(
        self, ep: InferenceEndpoint
    ) -> Optional[Tuple[int, float]]:
        """(victim index, deadline) of an in-progress per-replica drain."""
        raw = ep.metadata.annotations.get(
            C.INFERENCE_REPLICA_DRAIN_ANNOTATION, ""
        )
        if not raw:
            return None
        try:
            data = json.loads(raw)
            return int(data["replica"]), parse_time(data["deadline"]).timestamp()
        except (ValueError, KeyError, TypeError):
            return None

    def _retire_replica(
        self, ep: InferenceEndpoint, shape: SliceShape, victim: int,
        now: float, req: Request, desired: int,
    ) -> None:
        """Drain window over: scale the victim gang away and release its
        slice back to the warm pool (the suspend idiom — released while the
        pods terminate, so the next scale-up/promotion is a pool hit).
        Reconciles to fleet=victim (NOT desired): when several replicas must
        go, each gets its own drain window — the next reconcile opens the
        next victim's."""
        pool_name = self._slice_pool_of(ep, replica=victim)
        self._reconcile_workload(
            ep, shape, replicas=shape.hosts, fleet=max(victim, 1)
        )
        released = False
        if pool_name and not ep.metadata.annotations.get(
            C.TPU_RECLAIM_ANNOTATION
        ):
            released = self.pool.release(
                pool_name, self._pool_nodes(pool_name),
                priority=endpoint_priority(ep),
            )
        self._patch_annotations(
            ep, {C.INFERENCE_REPLICA_DRAIN_ANNOTATION: None}
        )
        self._emit_event(
            ep, "ReplicaRetired",
            f"replica {victim} drained and retired"
            + ("; slice released to the warm pool" if released
               else "; slice returned to general capacity"),
            etype="Normal",
        )
        recorder.record(
            "scale", machine="inference", endpoint=req.key,
            direction="down", replica=victim, released_warm=released,
            retired=True,
        )
        record_span(
            "endpoint.scale_down",
            traceparent=ep.metadata.annotations.get(C.TRACEPARENT_ANNOTATION),
            endpoint=ep.metadata.name,
            namespace=ep.metadata.namespace,
            replica=victim,
            to_replicas=desired,
            released_warm=released,
        )
        log.info("endpoint %s retired replica %d (%s)", req.key, victim,
                 "released warm" if released else "general capacity")

    def _park_suspended(
        self, ep: InferenceEndpoint, shape: SliceShape, now: float,
        req: Request,
    ) -> Optional[Result]:
        """Scale-to-zero: every gang scales away, every slice releases warm,
        the route stays UP — the router's cold-wake (first request bumps
        desired replicas) pops the endpoint back through Pending without an
        operator in the loop."""
        pools = self._fleet_pools(ep)
        self._reconcile_workload(ep, shape, replicas=0, fleet=0)
        released = 0
        if not ep.metadata.annotations.get(C.TPU_RECLAIM_ANNOTATION):
            for pool_name in pools:
                if self.pool.release(
                    pool_name, self._pool_nodes(pool_name),
                    priority=endpoint_priority(ep),
                ):
                    released += 1
        self._patch_annotations(
            ep,
            {
                C.INFERENCE_STATE_ANNOTATION: STATE_SUSPENDED,
                C.INFERENCE_SUSPENDED_AT_ANNOTATION: rfc3339_precise(now),
                C.INFERENCE_REPLICA_DRAIN_ANNOTATION: None,
            },
        )
        self._mirror_status(ep, shape, phase="Suspended", desired=0)
        self._emit_event(
            ep, "EndpointSuspended",
            f"scale-to-zero: fleet parked, {released} slice(s) released "
            "warm; route stays up for the cold-wake",
            etype="Normal",
        )
        recorder.record(
            "transition", machine="inference", endpoint=req.key,
            state=STATE_SUSPENDED, released_warm=released,
        )
        record_span(
            "endpoint.scale_down",
            traceparent=ep.metadata.annotations.get(C.TRACEPARENT_ANNOTATION),
            endpoint=ep.metadata.name,
            namespace=ep.metadata.namespace,
            to_replicas=0,
            parked=True,
            released_warm=released,
        )
        log.info("endpoint %s suspended (scale-to-zero, %d slices warm)",
                 req.key, released)
        return Result(requeue_after=0.05)

    def _hold_suspended(
        self, ep: InferenceEndpoint, shape: SliceShape
    ) -> Result:
        """Suspended steady state: replicas 0 everywhere, route up, nothing
        to converge until something bumps desired replicas."""
        self._reconcile_workload(ep, shape, replicas=0, fleet=0)
        self._ensure_route(ep)
        self._mirror_status(ep, shape, phase="Suspended", desired=0)
        return Result(requeue_after=max(
            1.0, self.config.readiness_probe_period_s * 6
        ))

    def _fleet_pools(self, ep: InferenceEndpoint) -> List[str]:
        """Distinct slice nodepools the fleet's placed pods occupy (one per
        replica gang — a slice fits exactly one gang)."""
        pools: List[str] = []
        for p in self._pods(ep):
            if not p.spec.node_name:
                continue
            try:
                node = self.client.get(Node, "", p.spec.node_name)
            except NotFoundError:
                continue
            name = node.metadata.labels.get(GKE_NODEPOOL_LABEL, "")
            if name and name not in pools:
                pools.append(name)
        return pools

    # ---------- Draining / Terminated ----------

    def _run_drain(
        self, ep: InferenceEndpoint, shape: SliceShape, now: float, req: Request
    ) -> Optional[Result]:
        self._delete_route(ep)  # level-triggered: re-assert no traffic
        deadline_s = ep.metadata.annotations.get(
            C.INFERENCE_DRAIN_DEADLINE_ANNOTATION, ""
        )
        try:
            deadline = parse_time(deadline_s).timestamp()
        except ValueError:
            deadline = now
        if now < deadline:
            self._mirror_status(ep, shape, phase="Draining")
            return Result(requeue_after=max(0.02, min(deadline - now, 1.0)))
        return self._complete_drain(ep, shape, now, req)

    def _complete_drain(
        self, ep: InferenceEndpoint, shape: SliceShape, now: float, req: Request
    ) -> Optional[Result]:
        ann = ep.metadata.annotations
        reclaimed = ann.get(C.TPU_RECLAIM_ANNOTATION, "")
        pools = self._fleet_pools(ep)  # gather BEFORE the fleet scales away
        self._reconcile_workload(ep, shape, replicas=0)
        released = False
        if pools and not reclaimed:
            # drained endpoints release WARM like suspended notebooks: the
            # next promotion (or resume) of this shape is a pool hit — every
            # replica gang's slice, not just the first. A reclaim-forced
            # drain skips this — the requester needs the chips.
            for pool_name in pools:
                if self.pool.release(
                    pool_name, self._pool_nodes(pool_name),
                    priority=endpoint_priority(ep),
                ):
                    released = True
        else:
            self._release_claims(req.key, back_to_warm=False)
        self._patch_annotations(
            ep,
            {
                C.INFERENCE_STATE_ANNOTATION: STATE_TERMINATED,
                C.INFERENCE_DRAIN_DEADLINE_ANNOTATION: None,
            },
        )
        self._mirror_status(ep, shape, phase="Terminated")
        self._emit_event(
            ep, "EndpointTerminated",
            "drained and terminated"
            + ("; slice released to the warm pool" if released
               else "; slice returned to general capacity"),
            etype="Normal",
        )
        recorder.record(
            "transition", machine="inference", endpoint=req.key,
            state=STATE_TERMINATED, released_warm=released,
            reclaimed=bool(reclaimed),
        )
        record_span(
            "endpoint.drain",
            traceparent=ann.get(C.TRACEPARENT_ANNOTATION),
            endpoint=ep.metadata.name,
            namespace=ep.metadata.namespace,
            released_warm=released,
        )
        log.info("endpoint %s terminated (%s)", req.key,
                 "released warm" if released else "general capacity")
        return None

    # ---------- workload generation ----------

    def generate_statefulset(
        self, ep: InferenceEndpoint, shape: SliceShape, replicas: int,
        replica: int = 0,
    ) -> StatefulSet:
        """One replica GANG = one StatefulSet (its own gang-DNS headless
        service, its own slice): the fleet is N of these, not one STS with
        N*hosts pods — gang scheduling and per-replica drain both need the
        gang boundary to be a real object boundary."""
        sts = StatefulSet()
        sts.metadata.name = endpoint_statefulset_name(
            ep.metadata.name, replica
        )
        sts.metadata.namespace = ep.metadata.namespace
        sts.metadata.labels = {
            C.INFERENCE_NAME_LABEL: ep.metadata.name,
            C.INFERENCE_REPLICA_LABEL: str(replica),
        }
        sts.spec.replicas = replicas
        sts.spec.selector.match_labels = {
            C.INFERENCE_NAME_LABEL: ep.metadata.name,
            C.INFERENCE_REPLICA_LABEL: str(replica),
        }
        sts.spec.service_name = endpoint_hosts_service_name(
            ep.metadata.name, replica
        )
        sts.spec.pod_management_policy = "Parallel"

        template = sts.spec.template
        template.metadata.labels = {
            C.INFERENCE_NAME_LABEL: ep.metadata.name,
            C.INFERENCE_REPLICA_LABEL: str(replica),
        }
        template.metadata.annotations = {}
        traceparent = ep.metadata.annotations.get(C.TRACEPARENT_ANNOTATION)
        if traceparent:
            template.metadata.annotations[C.TRACEPARENT_ANNOTATION] = traceparent
        template.spec = ep.spec.template.spec.deepcopy()
        self._default_container(ep, template.spec)
        sts.set_owner(ep)
        # the slice's pod fields: the notebook path's rendering rule
        return StatefulSet.from_dict(apply_slice(
            sts.to_dict(), shape, ep.metadata.namespace,
            self.config.cluster_domain, container=ep.metadata.name,
        ))

    def _default_container(self, ep: InferenceEndpoint, podspec) -> None:
        """The serving port and the engine's shape on the primary container
        (the one named after the endpoint, else the first); the GPU
        resources and the torchrun env are apply_slice's."""
        container: Optional[Container] = None
        for c in podspec.containers:
            if c.name == ep.metadata.name:
                container = c
                break
        if container is None:
            if not podspec.containers:
                podspec.containers.append(
                    Container(name=ep.metadata.name, image="")
                )
            container = podspec.containers[0]
        if not container.ports:
            container.ports = [
                ContainerPort(name="http-serving",
                              container_port=INFERENCE_PORT, protocol="TCP")
            ]
        # engine shape (serving/engine.py reads these in the pod)
        serving = ep.spec.serving
        container.set_env("SERVING_MAX_SLOTS", str(serving.max_batch_slots))
        container.set_env("SERVING_MAX_QUEUE", str(serving.max_queue_depth))
        container.set_env("SERVING_MAX_SEQ", str(serving.max_seq))
        container.set_env("SERVING_MAX_NEW", str(serving.max_new_tokens))
        container.set_env("SERVING_DECODE_BURST", str(serving.decode_burst))
        if serving.checkpoint_path:
            container.set_env("SERVING_CHECKPOINT", serving.checkpoint_path)

    def generate_service(self, ep: InferenceEndpoint) -> Service:
        svc = Service()
        svc.metadata.name = endpoint_service_name(ep.metadata.name)
        svc.metadata.namespace = ep.metadata.namespace
        svc.metadata.labels = {C.INFERENCE_NAME_LABEL: ep.metadata.name}
        svc.spec.type = "ClusterIP"
        svc.spec.selector = {C.INFERENCE_NAME_LABEL: ep.metadata.name}
        svc.spec.ports = [
            ServicePort(name="http-serving", port=80,
                        target_port=INFERENCE_PORT, protocol="TCP")
        ]
        svc.set_owner(ep)
        return svc

    def generate_hosts_service(
        self, ep: InferenceEndpoint, replica: int = 0
    ) -> Service:
        svc = Service()
        svc.metadata.name = endpoint_hosts_service_name(
            ep.metadata.name, replica
        )
        svc.metadata.namespace = ep.metadata.namespace
        svc.metadata.labels = {
            C.INFERENCE_NAME_LABEL: ep.metadata.name,
            C.INFERENCE_REPLICA_LABEL: str(replica),
        }
        svc.spec.cluster_ip = "None"
        svc.spec.selector = {
            C.INFERENCE_NAME_LABEL: ep.metadata.name,
            C.INFERENCE_REPLICA_LABEL: str(replica),
        }
        svc.spec.ports = [
            ServicePort(name="jax-coordinator", port=8476, target_port=8476),
            ServicePort(name="probe", port=self.config.probe_port,
                        target_port=self.config.probe_port),
        ]
        svc.set_owner(ep)
        return svc

    def _replica_statefulsets(
        self, ep: InferenceEndpoint
    ) -> Dict[int, StatefulSet]:
        """Index -> STS over the fleet's StatefulSets (pre-fleet objects
        without a replica label read as replica 0). A fresh read, not the
        cache: right after a retire scaled a gang to 0, a cached list that
        still shows it up reads as a fleet too large, opens a second drain
        of the retired gang and scales it back up to drain it (the
        reference reads the cache here)."""
        out: Dict[int, StatefulSet] = {}
        for sts in self.api_reader.list(
            StatefulSet,
            namespace=ep.metadata.namespace,
            labels={C.INFERENCE_NAME_LABEL: ep.metadata.name},
        ):
            try:
                idx = int(
                    sts.metadata.labels.get(C.INFERENCE_REPLICA_LABEL, "0")
                )
            except (TypeError, ValueError):
                idx = 0
            out[idx] = sts
        return out

    def _observed_fleet(self, ep: InferenceEndpoint) -> int:
        """The fleet size the cluster currently expresses: highest replica
        index with a scaled-up STS, plus one (0 = everything parked)."""
        active = [
            i for i, sts in self._replica_statefulsets(ep).items()
            if (sts.spec.replicas or 0) > 0
        ]
        return max(active) + 1 if active else 0

    def _reconcile_workload(
        self, ep: InferenceEndpoint, shape: SliceShape, replicas: int,
        fleet: int = 1,
    ) -> None:
        """Converge the whole fleet: ensure STS + gang-DNS service for each
        replica index < fleet (each at `replicas` pods — 0 parks the gang),
        and GC indexes >= fleet (scale to 0 first, delete once their pods
        are gone). Replica 0's objects always exist — they hold the
        pre-fleet names, so a parked endpoint still reads as 'this workload,
        scaled to zero' rather than vanishing."""
        fleet = max(1, fleet)
        existing = self._replica_statefulsets(ep)
        for idx in range(fleet):
            desired = self.generate_statefulset(ep, shape, replicas, idx)

            def attempt(desired=desired):
                try:
                    current = self.api_reader.get(
                        StatefulSet, ep.metadata.namespace,
                        desired.metadata.name,
                    )
                except NotFoundError:
                    try:
                        self.client.create(desired)
                    except AlreadyExistsError:
                        pass  # racing reconcile won; level-triggered
                    return
                changed = False
                if current.spec.replicas != desired.spec.replicas:
                    current.spec.replicas = desired.spec.replicas
                    changed = True
                if current.spec.template.to_dict() != \
                        desired.spec.template.to_dict():
                    current.spec.template = desired.spec.template
                    changed = True
                if changed:
                    self.client.update(current)

            retry_on_conflict(attempt)
        # GC retired replica gangs: scale away first (pods drain through
        # normal termination), delete the shells once empty
        for idx, sts in sorted(existing.items()):
            if idx < fleet:
                continue
            if (sts.spec.replicas or 0) > 0:
                def scale_down(sts=sts):
                    try:
                        current = self.api_reader.get(
                            StatefulSet, ep.metadata.namespace,
                            sts.metadata.name,
                        )
                    except NotFoundError:
                        return
                    if (current.spec.replicas or 0) != 0:
                        current.spec.replicas = 0
                        self.client.update(current)

                retry_on_conflict(scale_down)
            elif not self._pods(ep, replica=idx):
                for kind, name in (
                    (StatefulSet, sts.metadata.name),
                    (Service,
                     endpoint_hosts_service_name(ep.metadata.name, idx)),
                ):
                    try:
                        self.client.delete(kind, ep.metadata.namespace, name)
                    except NotFoundError:
                        pass
        services = [self.generate_service(ep)]
        services.extend(
            self.generate_hosts_service(ep, idx) for idx in range(fleet)
        )
        for svc in services:
            try:
                self.client.get(Service, ep.metadata.namespace,
                                svc.metadata.name)
            except NotFoundError:
                try:
                    self.client.create(svc)
                except AlreadyExistsError:
                    pass

    # ---------- route ----------

    def _ensure_route(self, ep: InferenceEndpoint) -> None:
        route = HTTPRoute()
        route.metadata.name = endpoint_route_name(ep)
        route.metadata.namespace = self.config.controller_namespace
        route.metadata.labels = {C.INFERENCE_NAME_LABEL: ep.metadata.name}
        route.spec.parent_refs = [
            ParentReference(
                group="gateway.networking.k8s.io",
                kind="Gateway",
                name=self.config.gateway_name,
                namespace=self.config.gateway_namespace,
            )
        ]
        route.spec.rules = [
            HTTPRouteRule(
                matches=[HTTPRouteMatch(path=HTTPPathMatch(
                    type="PathPrefix", value=self._route_path(ep),
                ))],
                backend_refs=[HTTPBackendRef(
                    kind="Service",
                    name=endpoint_service_name(ep.metadata.name),
                    namespace=ep.metadata.namespace,
                    port=80,
                )],
            )
        ]
        try:
            self.client.create(route)
        except AlreadyExistsError:
            pass  # route exists; spec is deterministic from the CR

    def _delete_route(self, ep: InferenceEndpoint) -> None:
        try:
            self.client.delete(
                HTTPRoute, self.config.controller_namespace,
                endpoint_route_name(ep),
            )
        except NotFoundError:
            pass

    @staticmethod
    def _route_path(ep: InferenceEndpoint) -> str:
        return f"/serving/{ep.metadata.namespace}/{ep.metadata.name}"

    # ---------- readiness ----------

    def _pods(
        self, ep: InferenceEndpoint, replica: Optional[int] = None
    ) -> List[Pod]:
        pods = [
            p
            for p in self.client.list(
                Pod,
                namespace=ep.metadata.namespace,
                labels={C.INFERENCE_NAME_LABEL: ep.metadata.name},
            )
            if not p.metadata.deletion_timestamp
        ]
        if replica is None:
            return pods
        return [
            p for p in pods
            if p.metadata.labels.get(C.INFERENCE_REPLICA_LABEL, "0")
            == str(replica)
        ]

    def _ready_count(self, ep: InferenceEndpoint) -> int:
        return sum(1 for p in self._pods(ep) if p.is_ready())

    def _gang_ready_counts(self, ep: InferenceEndpoint) -> Dict[int, int]:
        """Ready-pod count per replica gang (missing label = replica 0)."""
        counts: Dict[int, int] = {}
        for p in self._pods(ep):
            if not p.is_ready():
                continue
            try:
                idx = int(p.metadata.labels.get(C.INFERENCE_REPLICA_LABEL, "0"))
            except (TypeError, ValueError):
                idx = 0
            counts[idx] = counts.get(idx, 0) + 1
        return counts

    def _ready_gangs(
        self, ep: InferenceEndpoint, shape: SliceShape
    ) -> List[int]:
        """Replica indexes whose FULL gang is pod-ready — the fleet's unit
        of health (a gang missing one host serves nothing)."""
        return sorted(
            idx
            for idx, count in self._gang_ready_counts(ep).items()
            if count >= shape.hosts
        )

    def _first_ready_gang(
        self, ep: InferenceEndpoint, shape: SliceShape
    ) -> Optional[int]:
        gangs = self._ready_gangs(ep, shape)
        return gangs[0] if gangs else None

    def _hosts_ready(self, ep: InferenceEndpoint, shape: SliceShape) -> bool:
        return bool(self._ready_gangs(ep, shape))

    def _probe_urls(
        self, ep: InferenceEndpoint, shape: SliceShape, path: str,
        replica: int = 0,
    ) -> List[str]:
        sts_name = endpoint_statefulset_name(ep.metadata.name, replica)
        svc = endpoint_hosts_service_name(ep.metadata.name, replica)
        return [
            f"http://{sts_name}-{i}.{svc}.{ep.metadata.namespace}.svc."
            f"{self.config.cluster_domain}:{self.config.probe_port}{path}"
            for i in range(shape.hosts)
        ]

    def _mesh_ready(
        self, ep: InferenceEndpoint, shape: SliceShape, replica: int = 0
    ) -> bool:
        """Every host's agent reports the full device view (the notebook
        probe gate's contract, driven inline — pod-Ready alone must not
        flip an endpoint to Serving)."""
        for url in self._probe_urls(ep, shape, "/tpu/readiness",
                                    replica=replica):
            try:
                try:
                    status, body = self.http_get(url, timeout=2.0)
                except TypeError:
                    status, body = self.http_get(url)
                if status != 200:
                    return False
                report = json.loads(body.decode() or "null") or {}
                if not report.get("ready"):
                    return False
            except Exception as e:
                log.debug("readiness probe %s failed: %s", url, e)
                return False
        return True

    # ---------- status / helpers ----------

    def _mirror_status(
        self, ep: InferenceEndpoint, shape: SliceShape, phase: str,
        desired: Optional[int] = None, draining: Optional[int] = None,
    ) -> None:
        ready = self._ready_count(ep)
        gangs = self._ready_gangs(ep, shape)
        before = ep.status.to_dict()
        status = ep.status
        status.phase = phase
        status.ready_replicas = ready
        # fleet view: the router reads these — servingReplicas is
        # how many full gangs can take traffic, drainingReplicas which gangs
        # it must stop picking (route-first drain)
        status.replicas = desired if desired is not None else 0
        status.serving_replicas = len(gangs)
        status.draining_replicas = [draining] if draining is not None else []
        status.tpu = status.tpu or TPUStatus()
        status.tpu.accelerator = shape.accelerator
        status.tpu.topology = shape.topology
        status.tpu.hosts = shape.hosts
        status.tpu.hosts_ready = ready
        status.tpu.chips_per_host = shape.chips_per_host
        status.tpu.chips_expected = shape.chips
        status.tpu.mesh_ready = phase == "Serving"
        # Suspended keeps the url: the route IS up, it just cold-wakes
        status.url = self._route_path(ep) if phase in (
            "Serving", "Suspended"
        ) else ""
        self._upsert_degraded_condition(status, phase, len(gangs), desired)
        if status.to_dict() == before:
            return
        spatch = status.to_dict()
        # to_dict() leaves out zero and empty fields, and a merge patch
        # keeps what it leaves out: the fleet view the router and the
        # autoscaler read must be written as it is, 0 and [] included (a
        # parked endpoint's replicas, a retired gang's drainingReplicas)
        spatch["readyReplicas"] = status.ready_replicas
        spatch["replicas"] = status.replicas
        spatch["servingReplicas"] = status.serving_replicas
        spatch["drainingReplicas"] = list(status.draining_replicas)
        try:
            # coalesced when available (runtime/coalesce.py): one PATCH per
            # endpoint per sync wave instead of one per watch event
            coalescer = getattr(self.manager, "status_coalescer", None)
            if coalescer is not None:
                coalescer.patch_status(
                    InferenceEndpoint, ep.metadata.namespace, ep.metadata.name,
                    spatch,
                )
            else:
                self.client.patch_status(
                    InferenceEndpoint, ep.metadata.namespace, ep.metadata.name,
                    spatch,
                )
        except NotFoundError:
            pass  # deleted mid-reconcile

    def _upsert_degraded_condition(
        self, status, phase: str, gangs_ready: int, desired: Optional[int],
    ) -> None:
        """DegradedServing = Serving below full fleet strength but above
        zero (a full outage re-enters Loading instead). Upsert preserves
        lastTransitionTime across unchanged statuses so alert/debug tooling
        sees when degradation STARTED, not the latest probe."""
        want = max(1, desired or 1)
        degraded = phase == "Serving" and 0 < gangs_ready < want
        now_s = rfc3339_precise(time.time())
        new_status = "True" if degraded else "False"
        reason = "ReplicaGangsDown" if degraded else "FleetAtStrength"
        message = (
            f"{gangs_ready}/{want} replica gangs healthy: serving degraded "
            "until the lost gangs re-place" if degraded
            else f"{gangs_ready}/{want} replica gangs healthy"
        )
        for cond in status.conditions:
            if cond.type == C.DEGRADED_SERVING_CONDITION:
                if (cond.status, cond.reason, cond.message) == (
                    new_status, reason, message
                ):
                    return  # unchanged: keep timestamps so status no-ops
                if cond.status != new_status:
                    cond.last_transition_time = now_s
                cond.status = new_status
                cond.reason = reason
                cond.message = message
                cond.last_probe_time = now_s
                return
        status.conditions.append(
            Condition(
                type=C.DEGRADED_SERVING_CONDITION,
                status=new_status,
                reason=reason,
                message=message,
                last_probe_time=now_s,
                last_transition_time=now_s,
            )
        )

    def _slice_pool_of(
        self, ep: InferenceEndpoint, replica: Optional[int] = None
    ) -> str:
        for p in self._pods(ep, replica=replica):
            if not p.spec.node_name:
                continue
            try:
                node = self.client.get(Node, "", p.spec.node_name)
            except NotFoundError:
                continue
            return node.metadata.labels.get(GKE_NODEPOOL_LABEL, "")
        return ""

    def _pool_nodes(self, pool: str) -> List[str]:
        return [
            n.metadata.name
            for n in self.client.list(Node)
            if n.metadata.labels.get(GKE_NODEPOOL_LABEL) == pool
        ]

    def _release_claims(self, key: str, back_to_warm: bool) -> None:
        for entry in self.pool.entries(include_unhealthy=True):
            if entry.claimed_by != key:
                continue
            if back_to_warm:
                self.pool.release(entry.pool, entry.nodes,
                                  priority=entry.priority)
            else:
                self.pool.unclaim(entry.pool)

    def _ensure_trace_root(self, ep: InferenceEndpoint) -> None:
        """First reconcile opens the `endpoint.ready` root (closed at
        Serving) and stamps its traceparent, so promotion/loading/serving
        spans — and the engine's per-request spans — join one trace."""
        if C.TRACEPARENT_ANNOTATION in ep.metadata.annotations:
            return
        root = tracing.begin_root(
            "endpoint.ready",
            key=f"endpoint:{ep.key()}",
            endpoint=ep.metadata.name,
            namespace=ep.metadata.namespace,
        )
        if root is None:
            return
        ep.metadata.annotations[C.TRACEPARENT_ANNOTATION] = root.traceparent
        self._patch_annotations(
            ep, {C.TRACEPARENT_ANNOTATION: root.traceparent}
        )

    def _close_ready_root(self, ep: InferenceEndpoint, now: float) -> None:
        traceparent = ep.metadata.annotations.get(C.TRACEPARENT_ANNOTATION)
        ctx = tracing.parse_traceparent(traceparent)
        if ctx is None:
            return
        trace_id, root_span_id = ctx
        if tracing.finish_root(trace_id, end_time=now) is None:
            # root opened in another process / lost to a restart: synthesize
            # with the annotation's own ids so the children still connect
            start = now
            try:
                start = parse_time(ep.metadata.creation_timestamp).timestamp()
            except (ValueError, TypeError):
                pass
            tracing.record_span(
                "endpoint.ready",
                trace_id=trace_id,
                span_id=root_span_id,
                start_time=start,
                end_time=now,
                endpoint=ep.metadata.name,
            )

    def _patch_annotations(self, ep: InferenceEndpoint, updates: dict) -> None:
        def attempt():
            return self.client.patch(
                InferenceEndpoint,
                ep.metadata.namespace,
                ep.metadata.name,
                {"metadata": {"annotations": updates}},
            )

        try:
            retry_on_conflict(attempt)
        except NotFoundError:
            pass  # deleted mid-transition; the delete path releases claims

    def _emit_event(
        self, ep: InferenceEndpoint, reason: str, message: str,
        etype: str = "Warning",
    ) -> None:
        emit_deduped_event(
            self.client, ep, f"{ep.metadata.name}.{reason.lower()}",
            reason=reason, message=message, etype=etype,
            api_version=ep.api_version or "kubeflow.org/v1beta1",
            kind="InferenceEndpoint",
        )


__all__ = [
    "InferenceEndpointReconciler",
    "endpoint_desired_replicas",
    "endpoint_hosts_service_name",
    "endpoint_priority",
    "endpoint_route_name",
    "endpoint_service_name",
    "endpoint_statefulset_name",
]
