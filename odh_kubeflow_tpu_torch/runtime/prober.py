"""Black-box canary prober: alert on what users experience (the port's copy
of odh_kubeflow_tpu/runtime/prober.py).

Every other series the operator exports is a component telling on itself; a
component that is wedged in a way it cannot see reports nothing wrong. The
prober closes that gap the way uptime checkers do — by BEING a user: on a
fixed cadence it drives a tiny Notebook CR through the full
admission -> schedule -> kubelet-start -> probe -> ready path, measures the
end-to-end wall-clock, and deletes the CR again. Results feed:

- `canary_probe_latency_seconds` (histogram of the round trip),
- `canary_probes_total{result="ok" | "timeout" | "error"}`, which backs the
  `canary-readiness` SLO (runtime/slo.py) — so a silent control-plane wedge
  burns a budget and pages even with every self-reported metric green.

The canary is a CPU notebook by default (tiny, schedulable anywhere); give
it an accelerator/topology that `gpu.plan_slice` plans (h100 1x1, say) to
exercise the device-visibility gate end to end, in which case readiness
means `status.tpu.mesh_ready`.
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Optional, Tuple

import time

from .flightrecorder import recorder as default_recorder
from .metrics import global_registry

log = logging.getLogger(__name__)

canary_probe_latency_seconds = global_registry.histogram(
    "canary_probe_latency_seconds",
    "End-to-end CR-create -> ready latency measured by the black-box canary",
    buckets=(0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120, 300),
)
canary_probes_total = global_registry.counter(
    "canary_probes_total",
    "Black-box canary probes, by result (ok | timeout | error)",
    labels=("result",),
)


class CanaryProber:
    def __init__(
        self,
        manager: Any,
        period_s: float = 60.0,
        timeout_s: float = 120.0,
        namespace: str = "slo-canary",
        accelerator: str = "",
        topology: str = "",
        clock: Callable[[], float] = time.time,
        recorder: Any = None,
    ):
        self.manager = manager
        self.period_s = period_s
        self.timeout_s = timeout_s
        self.namespace = namespace
        self.accelerator = accelerator
        self.topology = topology
        self.clock = clock
        self.recorder = default_recorder if recorder is None else recorder
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seq = 0
        self.probes_run = 0

    # -- lifecycle (manager add_service contract) --

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="canary-prober"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
        self._thread = None

    def _run(self) -> None:
        # first probe after a short grace (let the informers sync), then on
        # the configured cadence
        if self._stop.wait(min(1.0, self.period_s)):
            return
        while not self._stop.is_set():
            try:
                self.probe_once()
            except Exception:
                log.exception("canary probe crashed")
                canary_probes_total.inc(result="error")
            if self._stop.wait(self.period_s):
                return

    # -- one probe --

    def _make_canary(self, name: str):
        from ..api.core import Container
        from ..api.notebook import Notebook, TPUSpec
        from ..controllers import constants as C

        nb = Notebook()
        nb.metadata.name = name
        nb.metadata.namespace = self.namespace
        # never a reclaim victim (controllers/suspend.py): suspending the
        # canary under capacity pressure would blind the very probe that
        # detects the pressure incident
        nb.metadata.labels[C.TPU_RECLAIM_EXEMPT_LABEL] = "true"
        nb.spec.template.spec.containers = [
            Container(name=name, image="jupyter:canary")
        ]
        if self.accelerator:
            nb.spec.tpu = TPUSpec(
                accelerator=self.accelerator, topology=self.topology
            )
        return nb

    def _ready(self, nb) -> bool:
        if self.accelerator:
            return nb.status.tpu is not None and nb.status.tpu.mesh_ready
        return nb.status.ready_replicas >= 1

    def probe_once(self) -> Tuple[str, float]:
        """(result, latency_s) of one canary round trip; always deletes the
        CR, even on timeout/interruption — a leaked canary would distort
        the very availability it measures."""
        from ..api.notebook import Notebook
        from ..apimachinery import NotFoundError
        from ..cluster.flowcontrol import flow_context

        client = self.manager.client
        self._seq += 1
        name = f"canary-{self._seq}"
        t0 = self.clock()
        result = "error"
        latency = 0.0
        # the prober runs outside any controller worker loop, so it must
        # claim its flow identity itself — without this the canary's
        # create/get/delete would classify onto the default PriorityLevel
        # and an overload could shed the very probe measuring it
        # (found by the flow-schema-coverage checker)
        with flow_context("canary"):
            try:
                client.create(self._make_canary(name))
                deadline = t0 + self.timeout_s
                result = "timeout"
                while self.clock() < deadline and not self._stop.is_set():
                    try:
                        nb = client.get(Notebook, self.namespace, name)
                    except NotFoundError:
                        nb = None
                    if nb is not None and self._ready(nb):
                        latency = self.clock() - t0
                        result = "ok"
                        break
                    time.sleep(0.02)
            finally:
                try:
                    client.delete(Notebook, self.namespace, name)
                except NotFoundError:
                    pass
                except Exception:
                    log.exception("canary cleanup for %s failed", name)
        if (
            result == "timeout"
            and self._stop.is_set()
            and self.clock() < t0 + self.timeout_s
        ):
            # manager shutdown interrupted the wait: the probe neither
            # succeeded nor failed — it must not burn the canary SLO
            return "aborted", latency
        self.probes_run += 1
        canary_probes_total.inc(result=result)
        if result == "ok":
            canary_probe_latency_seconds.observe(latency)
        else:
            log.warning("canary probe %s: %s after %.1fs", name, result,
                        self.clock() - t0)
        self.recorder.record(
            "canary", name=name, result=result,
            latency_ms=round(latency * 1e3, 3),
        )
        return result, latency
