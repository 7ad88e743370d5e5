"""Probe-status controller: device-visibility-gated slice readiness.

SURVEY §7 hard part (a), made real: "when is a slice ready?" is answered by
the in-pod probe contract, not by pod phase. Every ordinal's agent serves
GET /tpu/readiness -> {"chips_visible", "chips_expected", "ready"}
(probe/agent.py:181-189); this controller polls all hosts and owns the
device-level slice of NotebookStatus.tpu:

- chips_visible  = SUM of per-host reported chips (a host whose libtpu sees
  2 of 4 chips contributes 2 — pod-Ready alone never inflates this),
- mesh_ready     = every host reports ready (visible >= expected) AND every
  pod is Ready,
- first_ready_time + the notebook_slice_ready_seconds histogram fire at THAT
  moment — so the north-star metric (Notebook CR -> jax.devices() ready)
  measures device visibility, not kubelet bookkeeping.

The reconciler is requeue-driven at a fixed cadence like the culler
(reference culling_controller.go:86-203's RequeueAfter pattern); the pod-fact
fields (hosts_ready, chips_expected, ...) stay owned by the core reconciler
(controllers/notebook.py) and both writers preserve each other's fields.
"""
from __future__ import annotations

import json
import logging
import time
from typing import List, Optional, Tuple

from ..api.core import Pod
from ..api.notebook import Notebook, TPUStatus
from ..apimachinery import NotFoundError, now_rfc3339, parse_time
from ..cluster.client import retry_on_conflict
from ..runtime.controller import Request, Result
from ..runtime.flightrecorder import recorder
from ..runtime.manager import Manager
from ..gpu import plan_slice
from ..utils import tracing
from . import constants as C
from .conditions import get_condition, write_condition
from .config import Config
from .culling import HTTPGet, _default_http_get
from .metrics import NotebookMetrics
from .notebook import per_ordinal_probe_urls

log = logging.getLogger(__name__)


class ProbeStatusController:
    def __init__(
        self,
        manager: Manager,
        config: Optional[Config] = None,
        http_get: Optional[HTTPGet] = None,
        metrics: Optional[NotebookMetrics] = None,
    ):
        self.manager = manager
        self.client = manager.client
        # fresh reads for read-modify-write (manager.client may serve a
        # just-stale informer cache)
        self.api_reader = manager.api_reader
        self.config = config or Config()
        self.http_get = http_get or _default_http_get
        self.metrics = metrics or NotebookMetrics(manager.metrics)

    def setup(self) -> None:
        self.manager.builder("probe-status").for_(Notebook).with_workers(
            self.config.max_concurrent_reconciles
        ).complete(self.reconcile)

    # ---------- probing ----------

    def readiness_urls(self, nb: Notebook, hosts: int) -> List[str]:
        """One /tpu/readiness endpoint per ordinal (shared addressing with
        the culler's utilization probe: per_ordinal_probe_urls)."""
        return per_ordinal_probe_urls(
            self.client, self.config, nb, hosts, "/tpu/readiness"
        )

    PROBE_TIMEOUT_S = 2.0

    def collect_reports(self, nb: Notebook, hosts: int) -> List[Optional[dict]]:
        """Per-ordinal readiness reports; None for unreachable hosts.

        Probes run concurrently with a short timeout: the controller has one
        worker shared across all notebooks, and bring-up is exactly when DNS
        blackholes — N sequential 10s timeouts would starve every other
        slice's readiness detection."""
        from concurrent.futures import ThreadPoolExecutor

        def probe(url: str) -> Optional[dict]:
            try:
                try:
                    status, body = self.http_get(url, timeout=self.PROBE_TIMEOUT_S)
                except TypeError:  # custom http_get without timeout kwarg
                    status, body = self.http_get(url)
                if status != 200:
                    raise ConnectionError(f"GET {url} -> {status}")
                return json.loads(body.decode() or "null")
            except Exception:
                return None

        urls = self.readiness_urls(nb, hosts)
        if not urls:
            return []
        with ThreadPoolExecutor(max_workers=min(16, len(urls))) as pool:
            reports = list(pool.map(probe, urls))
        unreachable = sum(1 for r in reports if r is None)
        if unreachable:
            self.metrics.probe_unreachable_total.inc(unreachable)
        return reports

    # ---------- reconcile ----------

    def reconcile(self, req: Request) -> Optional[Result]:
        period_s = self.config.readiness_probe_period_s
        try:
            nb = self.client.get(Notebook, req.namespace, req.name)
        except NotFoundError:
            return None
        if nb.metadata.deletion_timestamp:
            return None
        if nb.spec.tpu is None or not nb.spec.tpu.accelerator:
            return None  # CPU notebook: no device gate
        if C.STOP_ANNOTATION in nb.metadata.annotations:
            # stopped slices have no devices; clear the gate but keep
            # first_ready_time (it anchors the FIRST bring-up latency). The
            # health verdict goes Unknown — a stale False must not read as a
            # live fault when the notebook is unstopped (the slice-repair
            # controller only acts on an affirmative False)
            if get_condition(nb, C.TPU_HEALTHY_CONDITION) is not None:
                write_condition(
                    self.client, self.api_reader, nb,
                    C.TPU_HEALTHY_CONDITION, "Unknown", "Stopped",
                    "notebook stopped; no devices to probe",
                )
            self._write(nb, chips_visible=0, mesh_ready=False, newly_ready=False)
            return None

        shape = plan_slice(
            nb.spec.tpu.accelerator, nb.spec.tpu.topology, nb.spec.tpu.chips
        )
        pods = [
            p
            for p in self.client.list(
                Pod,
                namespace=nb.metadata.namespace,
                labels={C.NOTEBOOK_NAME_LABEL: nb.metadata.name},
            )
            if not p.metadata.deletion_timestamp
        ]
        ready_pods = sum(1 for p in pods if p.is_ready())

        tpu_pub = nb.status.tpu
        if ready_pods < shape.hosts and not (
            tpu_pub and (tpu_pub.mesh_ready or tpu_pub.chips_visible)
        ):
            # Pods still coming up AND nothing is published as up: probing
            # every ordinal now mostly hits unreachable agents, and under a
            # create storm those wasted probe cycles are real contention
            # (every notebook event during bring-up re-triggered a full
            # probe sweep). Wait for the pod facts — the pod-Ready event
            # chain re-enqueues this notebook — with the periodic requeue
            # as the backstop. A DEGRADED slice (mesh_ready or chips
            # currently published) deliberately falls through: the probe
            # sweep is what downgrades the gate and the chip count after a
            # host loss or restart.
            return Result(requeue_after=period_s)

        # one timing source for BOTH consumers of the sweep window: the
        # sweep-duration histogram and the probe.first_healthy trace span
        probe_t0 = time.time()
        reports = self.collect_reports(nb, shape.hosts)
        probe_t1 = time.time()
        if reports:
            self.metrics.probe_sweep_seconds.observe(probe_t1 - probe_t0)
        chips_visible = sum(int(r.get("chips_visible", 0)) for r in reports if r)
        hosts_reporting_ready = sum(1 for r in reports if r and r.get("ready"))
        mesh_ready = (
            shape.hosts > 0
            and hosts_reporting_ready == shape.hosts
            and ready_pods == shape.hosts
            # gate on the PUBLISHED pod facts too: the core reconciler's
            # ready_replicas mirror must land before the device gate flips,
            # so observers never see mesh_ready=True with a stale
            # ready_replicas (the mirror's write re-enqueues this notebook,
            # so waiting costs one event hop, not a poll period)
            and nb.status.ready_replicas >= shape.hosts
        )

        # device-health aggregation -> the TPUHealthy condition (the slice-
        # repair controller's detection signal). Judged only once the slice
        # has been ready at least once (or is ready right now): during FIRST
        # bring-up an unreachable agent is normal, not a fault — the mesh
        # gate owns bring-up, TPUHealthy owns degradation-after-ready.
        if mesh_ready or (nb.status.tpu and nb.status.tpu.first_ready_time):
            healthy, reason, message = self._device_health(
                reports, shape, ready_pods
            )
            write_condition(
                self.client,
                self.api_reader,
                nb,
                C.TPU_HEALTHY_CONDITION,
                "True" if healthy else "False",
                reason,
                message,
            )

        newly_ready = mesh_ready and not (
            nb.status.tpu and nb.status.tpu.first_ready_time
        )
        # flight-recorder sample on gate FLIPS only (a steady-state sweep is
        # not evidence): the mesh going un-ready after first-ready is the
        # leading edge of every degradation incident
        was_ready = bool(nb.status.tpu and nb.status.tpu.mesh_ready)
        if mesh_ready != was_ready:
            recorder.record(
                "mesh", notebook=req.key, ready=mesh_ready,
                chips_visible=chips_visible, hosts_ready=ready_pods,
            )
        # the gate's decision, taken before its write: a watcher that sees
        # the write never sees it before the root's end
        decided = time.time()
        newly_ready = self._write(nb, chips_visible, mesh_ready, newly_ready)
        if newly_ready:
            # observe only after the write persisted (double-count guard)
            try:
                created = parse_time(nb.metadata.creation_timestamp).timestamp()
                self.metrics.slice_ready_seconds.observe(time.time() - created)
            except (ValueError, TypeError):
                pass
            self._record_ready_trace(nb, shape, chips_visible, probe_t0, probe_t1, decided)
            log.info(
                "slice ready: %s (%d chips over %d hosts)",
                req.key,
                chips_visible,
                shape.hosts,
            )
        # keep polling until the mesh gate is green; afterwards stay on a slow
        # heartbeat so chip loss (e.g. a host losing devices) is re-detected
        return Result(requeue_after=period_s if not mesh_ready else period_s * 6)

    # ---------- device health (the TPUHealthy verdict) ----------

    @staticmethod
    def _device_health(
        reports: List[Optional[dict]], shape, ready_pods: int
    ) -> Tuple[bool, str, str]:
        """(healthy, reason, message) from one probe sweep. Precedence:
        unreachable hosts (preempted/crashed — the most urgent) > degraded
        ICI links > missing chips; healthy only when every host reported and
        every device checked out."""
        unreachable = sum(1 for r in reports if r is None)
        if unreachable or ready_pods < shape.hosts or len(reports) < shape.hosts:
            down = max(unreachable, shape.hosts - ready_pods)
            return (
                False,
                "HostUnreachable",
                f"{down}/{shape.hosts} hosts unreachable or not ready",
            )
        ici_hosts = [i for i, r in enumerate(reports) if r.get("ici_degraded")]
        if ici_hosts:
            return (
                False,
                "ICIDegraded",
                f"hosts {ici_hosts} report degraded ICI links",
            )
        missing = 0
        dead: List[str] = []  # "ordinal/device" ids from per-device health
        for i, r in enumerate(reports):
            failed = r.get("chips_failed")
            if failed is None:
                failed = max(
                    0,
                    int(r.get("chips_expected", 0)) - int(r.get("chips_visible", 0)),
                )
            missing += int(failed)
            for d in r.get("device_health") or []:
                if not d.get("healthy", True):
                    dead.append(f"{i}/{d.get('id')}")
        if missing:
            message = f"{missing} expected chips not visible"
            if dead:
                message += f" (dead devices host/id: {', '.join(dead[:8])})"
            return False, "ChipFailure", message
        return True, "AllDevicesHealthy", ""

    # ---------- readiness trace (terminal spans + root closure) ----------

    def _record_ready_trace(
        self, nb: Notebook, shape, chips_visible: int, probe_t0: float, probe_t1: float,
        now: float,
    ) -> None:
        """First mesh-ready at `now`: record `probe.first_healthy` (the sweep
        that saw every host ready) and the terminal `jax.devices.ready`
        marker, then close the `notebook.ready` root the webhook opened —
        synthesizing it from creationTimestamp when the root lives in
        another process."""
        traceparent = nb.metadata.annotations.get(C.TRACEPARENT_ANNOTATION)
        ctx = tracing.parse_traceparent(traceparent)
        if ctx is None:
            return
        trace_id, root_span_id = ctx
        tracing.record_span(
            "probe.first_healthy",
            traceparent=traceparent,
            start_time=probe_t0,
            end_time=probe_t1,
            notebook=nb.metadata.name,
            hosts=shape.hosts,
        )
        tracing.record_span(
            "jax.devices.ready",
            traceparent=traceparent,
            start_time=now,
            end_time=now,
            notebook=nb.metadata.name,
            chips_visible=chips_visible,
        )
        if tracing.finish_root(trace_id, end_time=now, chips=chips_visible) is None:
            # root opened elsewhere (remote-mode webhook) or lost to a
            # restart: synthesize it with the annotation's OWN span id so the
            # children recorded against it still connect
            start = now
            try:
                start = parse_time(nb.metadata.creation_timestamp).timestamp()
            except (ValueError, TypeError):
                pass
            tracing.record_span(
                "notebook.ready",
                trace_id=trace_id,
                span_id=root_span_id,
                start_time=start,
                end_time=now,
                notebook=nb.metadata.name,
                namespace=nb.metadata.namespace,
                chips=chips_visible,
            )

    # ---------- status write (owns ONLY the device-gate fields) ----------

    def _write(
        self, nb: Notebook, chips_visible: int, mesh_ready: bool, newly_ready: bool
    ) -> bool:
        """Publish the device-gate fields; returns whether first_ready_time
        was set by THIS call (the metric-observe gate)."""
        # no-op pre-check against the (cache-served) object in hand: steady-
        # state heartbeat cycles then cost only the probe HTTP GETs, not an
        # API write per notebook per cycle. A stale cache that hides a
        # needed write self-heals: the event that updates the cache
        # re-enqueues this notebook (level-triggered).
        tpu = nb.status.tpu
        if (
            tpu is not None
            and tpu.chips_visible == chips_visible
            and tpu.mesh_ready == mesh_ready
            and not (newly_ready and not tpu.first_ready_time)
        ):
            return False

        if not newly_ready:
            # common path: merge-PATCH of the device-gate fields only
            # (disjoint ownership with the core reconciler's mirror — see
            # notebook.py _update_status): one request, no RMW loop
            try:
                self.client.patch_status(
                    Notebook, nb.metadata.namespace, nb.metadata.name,
                    {"tpu": {"chipsVisible": int(chips_visible),
                             "meshReady": bool(mesh_ready)}},
                )
            except NotFoundError:
                pass  # deleted mid-reconcile
            return False

        # first-ready transition (once per notebook lifetime): the anchor
        # field is SET-ONCE, and the cached nb may lag our own earlier
        # write — decide on a FRESH read under conflict retry so a racing
        # reconcile can neither move the anchor nor double-observe the
        # slice-ready metric
        def attempt() -> bool:
            cur = self.api_reader.get(
                Notebook, nb.metadata.namespace, nb.metadata.name
            )
            tpu = cur.status.tpu or TPUStatus()
            first = not tpu.first_ready_time
            changed = (
                first
                or tpu.chips_visible != chips_visible
                or tpu.mesh_ready != mesh_ready
            )
            tpu.chips_visible = chips_visible
            tpu.mesh_ready = mesh_ready
            if first:
                tpu.first_ready_time = now_rfc3339()
            if changed:
                cur.status.tpu = tpu
                self.client.update_status(cur)
            return first

        try:
            return retry_on_conflict(attempt)
        except NotFoundError:
            return False  # deleted mid-reconcile
