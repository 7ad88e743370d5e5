"""Culling controller: idle notebooks release their TPU slice.

Faithful to the reference's state machine (reference
culling_controller.go: Reconcile :86-203, notebookIsIdle :220-241,
getNotebookResourceResponse :243-273, updateTimestampFromKernelsActivity
:371-402, setStopAnnotation :475-492, env parsing :525-558) with one
TPU-native extension: a notebook is only idle when the Jupyter signal AND the
TPU duty-cycle signal agree. Kernels can sit "idle" while an async JAX job
hammers the slice, and a busy-looking kernel can hold zero chips — on TPU
hardware the slice is the money, so both must be quiet before the stop
annotation fires and replicas -> 0 frees the whole slice.

Annotations (same keys as the reference):
- notebooks.kubeflow.org/last-activity
- notebooks.kubeflow.org/last_activity_check_timestamp
- kubeflow-resource-stopped  (set with the cull timestamp when idle)
"""
from __future__ import annotations

import json
import logging
import time
from typing import Callable, List, Optional, Tuple

from ..api.core import Pod
from ..api.notebook import Notebook
from ..apimachinery import NotFoundError, now_rfc3339, parse_time, rfc3339
from ..cluster.client import retry_on_conflict
from ..runtime.breaker import CircuitBreaker
from ..runtime.controller import Request, Result
from ..runtime.flightrecorder import recorder
from ..runtime.manager import Manager
from ..gpu import plan_slice
from . import constants as C
from .conditions import condition_is
from .config import Config
from .metrics import NotebookMetrics
from .notebook import per_ordinal_probe_urls, statefulset_name

log = logging.getLogger(__name__)

HTTPGet = Callable[[str], Tuple[int, bytes]]


def _default_http_get(url: str, timeout: float = 10.0) -> Tuple[int, bytes]:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:  # noqa: S310
        return resp.status, resp.read()


class CullingReconciler:
    def __init__(
        self,
        manager: Manager,
        config: Optional[Config] = None,
        http_get: Optional[HTTPGet] = None,
        metrics: Optional[NotebookMetrics] = None,
    ):
        self.manager = manager
        self.client = manager.client
        # culling is DESTRUCTIVE (replicas -> 0 frees the slice): every read
        # feeding the idle decision must be fresh, not informer-cache stale —
        # a lagging cache after un-stop briefly looks idle and would re-cull
        self.api_reader = manager.api_reader
        self.config = config or Config()
        self.http_get = http_get or _default_http_get
        self.metrics = metrics or NotebookMetrics(manager.metrics)
        # per-notebook probe circuit breaker: repeated probe failures open
        # it, and the reconcile then skips + requeues with backoff instead
        # of paying a connect timeout against a dead agent every cycle
        self.breaker = CircuitBreaker(
            failure_threshold=self.config.probe_breaker_threshold,
            cooldown_s=self.config.probe_breaker_cooldown_s,
        )

    def setup(self) -> None:
        """Gated on ENABLE_CULLING exactly like the reference's main()
        (notebook-controller/main.go:111-119): disabled -> no controller."""
        if not self.config.enable_culling:
            log.info("culling disabled (ENABLE_CULLING not set)")
            return
        self.manager.builder("culling").for_(Notebook).with_workers(
            self.config.max_concurrent_reconciles
        ).complete(self.reconcile)

    # ---------- URLs ----------

    def jupyter_url(self, nb: Notebook, resource: str) -> str:
        """Reference URL shape (culling_controller.go:252-259); DEV mode goes
        through a local proxy the way the reference uses kubectl proxy."""
        if self.config.dev_mode:
            return (
                f"http://localhost:8001/api/v1/namespaces/{nb.metadata.namespace}"
                f"/services/{nb.metadata.name}:http-notebook/proxy"
                f"/notebook/{nb.metadata.namespace}/{nb.metadata.name}/api/{resource}"
            )
        return (
            f"http://{nb.metadata.name}.{nb.metadata.namespace}.svc."
            f"{self.config.cluster_domain}"
            f"/notebook/{nb.metadata.namespace}/{nb.metadata.name}/api/{resource}"
        )

    def probe_urls(self, nb: Notebook) -> List[str]:
        """Per-host TPU utilization endpoints (multi-host slices: every host)."""
        if nb.spec.tpu is None or not nb.spec.tpu.accelerator:
            return []
        shape = plan_slice(
            nb.spec.tpu.accelerator, nb.spec.tpu.topology, nb.spec.tpu.chips
        )
        return per_ordinal_probe_urls(
            self.api_reader, self.config, nb, shape.hosts, "/tpu/utilization"
        )

    # ---------- probes ----------

    def _get_json(self, url: str):
        status, body = self.http_get(url)
        if status != 200:
            raise ConnectionError(f"GET {url} -> {status}")
        return json.loads(body.decode() or "null")

    def probe_jupyter(self, nb: Notebook) -> Tuple[bool, float]:
        """(busy, last_activity_ts). Raises on probe failure."""
        kernels = self._get_json(self.jupyter_url(nb, "kernels")) or []
        try:
            terminals = self._get_json(self.jupyter_url(nb, "terminals")) or []
        except Exception:
            terminals = []  # terminals API can be disabled (reference tolerates)
        busy = any(k.get("execution_state") == "busy" for k in kernels)
        last = 0.0
        for item in list(kernels) + list(terminals):
            ts = item.get("last_activity", "")
            if ts:
                try:
                    last = max(last, parse_time(ts).timestamp())
                except ValueError:
                    pass
        return busy, last

    def probe_tpu(self, nb: Notebook) -> Optional[Tuple[bool, float]]:
        """(busy, last_busy_ts) aggregated over hosts; None when there is no
        TPU or no host could be probed (fall back to the Jupyter signal so a
        probe-less image can still be culled)."""
        urls = self.probe_urls(nb)
        if not urls:
            return None
        busy = False
        last = 0.0
        reached = 0
        for url in urls:
            try:
                data = self._get_json(url)
            except Exception as e:
                # per-host degradation is expected (multi-host slices probe
                # every ordinal; a rebooting host must not veto the verdict)
                # but it must be visible when someone goes looking
                log.debug("culling: tpu probe %s unreachable: %s", url, e)
                continue
            reached += 1
            if float(data.get("duty_cycle", 0.0)) > self.config.tpu_idle_threshold:
                busy = True
            if data.get("warming"):
                # the monitor does not yet have a full observation window:
                # no idleness verdict — treat as busy rather than cull a
                # notebook during probe bring-up
                busy = True
            ts = data.get("last_busy", "")
            if ts:
                try:
                    last = max(last, parse_time(ts).timestamp())
                except ValueError:
                    pass
        if reached == 0:
            return None
        return busy, last

    # ---------- reconcile ----------

    def reconcile(self, req: Request) -> Optional[Result]:
        period_s = self.config.idleness_check_period_min * 60.0
        try:
            nb = self.api_reader.get(Notebook, req.namespace, req.name)
        except NotFoundError:
            self.breaker.forget(req.key)  # no monotonic growth across churn
            return None
        if nb.metadata.deletion_timestamp:
            return None

        annotations = nb.metadata.annotations

        # stopped (incl. reconciliation lock): drop activity annotations and
        # wait for the unstop watch event (reference :104-117)
        if C.STOP_ANNOTATION in annotations:
            self._remove_activity_annotations(nb)
            return None

        # mid-repair (Degraded or the repair-state machine active): the
        # notebook is DOWN, not idle — its pods are evicted/rescheduling and
        # every probe would fail. Suspend the idleness clock entirely: no
        # probe, no cull, no annotation advance. The slice-repair controller
        # resets last-activity at repair completion, so recovery time never
        # counts as idleness (a preempted notebook must not be culled for
        # "idling" during its own repair).
        if (
            C.TPU_REPAIR_STATE_ANNOTATION in annotations
            or condition_is(nb, C.TPU_DEGRADED_CONDITION, "True")
        ):
            return Result(requeue_after=period_s)

        # mid-resume (suspend controller driving Resuming/ResumeFailed, stop
        # annotation already gone): same contract as repair — the notebook is
        # coming back, not idling. No probe, no cull, no annotation advance;
        # the suspend controller re-arms last-activity at resume completion,
        # so a just-resumed notebook starts a FRESH idle clock instead of
        # being re-culled off its preserved pre-suspend last-activity.
        if annotations.get(C.TPU_SUSPEND_STATE_ANNOTATION):
            return Result(requeue_after=period_s)

        # pod 0 gone, going, or not yet Ready: nothing to probe (reference
        # :120-135, strengthened). Idleness is only measurable on a READY
        # pod: a terminating pod's server answers probes for seconds after
        # deletion, and a Pending replacement can be probed THROUGH stale
        # Service endpoints still pointing at the previous incarnation —
        # either way the culler would judge a notebook idle while its real
        # pod hasn't started, re-cull it, and the stop annotation then
        # blocks the recreate forever (a level-triggering deadlock observed
        # under CPU starvation with sub-second cull thresholds; unreachable
        # at the reference's minute-scale thresholds, but the state machine
        # should not depend on that).
        try:
            pod0 = self.api_reader.get(
                Pod, nb.metadata.namespace, f"{statefulset_name(nb.metadata.name)}-0"
            )
            if pod0.metadata.deletion_timestamp:
                raise NotFoundError("pod terminating")
        except NotFoundError:
            self._remove_activity_annotations(nb)
            return Result(requeue_after=period_s)
        if not pod0.is_ready():
            # exists but not Ready (starting, or a readiness flap): skip the
            # probe — KEEPING the annotations, so a flapping-but-idle
            # notebook's idle clock is not reset — and come back. Probing
            # here can hit stale Service endpoints still pointing at the
            # previous incarnation's server and judge a pod idle before it
            # has started.
            return Result(requeue_after=period_s)

        # first sight: initialize the annotation state machine (reference :141-153)
        if C.LAST_ACTIVITY_ANNOTATION not in annotations:
            self._patch_annotations(
                nb,
                {
                    C.LAST_ACTIVITY_ANNOTATION: now_rfc3339(),
                    C.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION: now_rfc3339(),
                },
            )
            return Result(requeue_after=period_s)

        # respect the check cadence (reference :156-159, 205-217)
        check_ts = annotations.get(C.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION, "")
        if check_ts:
            try:
                elapsed = time.time() - parse_time(check_ts).timestamp()
                if elapsed < period_s:
                    return Result(requeue_after=period_s - elapsed)
            except ValueError:
                pass

        # probe circuit breaker: a notebook whose agent keeps failing is
        # skipped (requeue with the breaker's cooldown) instead of hammered —
        # one dead agent must not absorb this controller's worker time
        if not self.breaker.allow(req.key):
            return Result(
                requeue_after=max(0.05, min(self.breaker.retry_after(req.key), period_s))
            )

        # probe (reference :165-167; TPU extension)
        try:
            jupyter_busy, jupyter_last = self.probe_jupyter(nb)
        except Exception as e:
            log.warning("culling: jupyter probe failed for %s: %s", req.key, e)
            if self.breaker.record_failure(req.key):
                log.warning(
                    "culling: probe breaker OPEN for %s (%d consecutive failures)",
                    req.key,
                    self.config.probe_breaker_threshold,
                )
            self._patch_annotations(
                nb, {C.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION: now_rfc3339()}
            )
            return Result(requeue_after=period_s)
        self.breaker.record_success(req.key)
        tpu = self.probe_tpu(nb)

        busy = jupyter_busy or (tpu is not None and tpu[0])
        prev_last = 0.0
        try:
            prev_last = parse_time(annotations[C.LAST_ACTIVITY_ANNOTATION]).timestamp()
        except (KeyError, ValueError):
            pass
        if busy:
            last_activity = time.time()
        else:
            candidates = [prev_last, jupyter_last] + ([tpu[1]] if tpu else [])
            last_activity = max(candidates)  # monotonic guard (reference :371-402)

        updates = {
            C.LAST_ACTIVITY_ANNOTATION: rfc3339(last_activity),
            C.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION: now_rfc3339(),
        }

        idle_s = time.time() - last_activity
        if idle_s > self.config.cull_idle_time_min * 60.0:
            # cull: stop annotation scales the slice away (reference :475-492)
            updates[C.STOP_ANNOTATION] = now_rfc3339()
            if self.config.suspend_enabled and nb.spec.tpu is not None \
                    and nb.spec.tpu.accelerator:
                # suspend, don't tear down: the checkpointing stamp rides the
                # SAME patch as the stop annotation, so the core reconciler
                # can never scale the slice away before the suspend
                # controller's checkpoint window ran (controllers/suspend.py)
                updates[C.TPU_SUSPEND_STATE_ANNOTATION] = "checkpointing"
            self._patch_annotations(nb, updates)
            self.metrics.notebook_culling_total.inc()
            self.metrics.last_culling_timestamp.set(time.time())
            # flight recorder: a cull is a state-machine transition a later
            # incident bundle must explain ("who scaled this slice away?")
            recorder.record(
                "transition", machine="culling", notebook=req.key,
                state="culled", idle_s=round(idle_s, 1),
            )
            log.info("culled %s after %.0fs idle", req.key, idle_s)
            return None
        self._patch_annotations(nb, updates)
        return Result(requeue_after=period_s)

    # ---------- annotation writes (always with conflict retry) ----------

    def _patch_annotations(self, nb: Notebook, updates: dict) -> None:
        def attempt():
            return self.client.patch(
                Notebook,
                nb.metadata.namespace,
                nb.metadata.name,
                {"metadata": {"annotations": updates}},
            )

        retry_on_conflict(attempt)

    def _remove_activity_annotations(self, nb: Notebook) -> None:
        if (
            C.LAST_ACTIVITY_ANNOTATION not in nb.metadata.annotations
            and C.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION not in nb.metadata.annotations
        ):
            return
        self._patch_annotations(
            nb,
            {
                C.LAST_ACTIVITY_ANNOTATION: None,
                C.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION: None,
            },
        )

