"""Notebook controller metrics.

Same five series as the reference collector (reference
pkg/metrics/metrics.go:22-99) plus the TPU-native ones the north star demands:
chips bound and the Notebook-CR->slice-ready latency histogram (the self-
measured headline metric). In the port a chip is a card: the chip series
count `nvidia.com/gpu`, by the GKE accelerator label of GPU nodes."""
from __future__ import annotations

from typing import Optional

from ..api.apps import StatefulSet
from ..api.core import Node
from ..api.notebook import Notebook
from ..cluster.client import Client
from ..runtime.metrics import Registry
from ..gpu import GKE_GPU_ACCELERATOR_LABEL, GPU_RESOURCE
from . import constants as C


class NotebookMetrics:
    def __init__(self, registry: Registry, client: Optional[Client] = None):
        self.registry = registry
        self.client = client
        self.notebook_create_total = registry.counter(
            "notebook_create_total", "Total times of creating notebook"
        )
        self.notebook_create_failed_total = registry.counter(
            "notebook_create_failed_total", "Total failure times of creating notebook"
        )
        self.notebook_culling_total = registry.counter(
            "notebook_culling_total", "Total times of culling notebook"
        )
        self.last_culling_timestamp = registry.gauge(
            "last_notebook_culling_timestamp_seconds",
            "Timestamp of the last notebook culling in seconds",
        )
        self.notebook_running = registry.gauge(
            "notebook_running_total", "Current running notebooks in the cluster"
        )
        # TPU-native series
        self.tpu_chips_bound = registry.gauge(
            "notebook_tpu_chips_bound", "TPU chips currently bound to notebooks"
        )
        self.probe_unreachable_total = registry.counter(
            "notebook_probe_unreachable_total",
            "Per-host readiness probes that found the agent unreachable "
            "(partitions, crashed probe processes, bring-up races)",
        )
        self.slice_ready_seconds = registry.histogram(
            "notebook_slice_ready_seconds",
            "Notebook CR to slice-ready latency (the north-star metric)",
            buckets=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120, 300),
        )
        self.probe_sweep_seconds = registry.histogram(
            "notebook_probe_sweep_seconds",
            "Wall-clock of one all-ordinals readiness probe sweep",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 2.5, 5, 10),
        )
        # fleet capacity, per accelerator type (from Node allocatable — the
        # TPU analog of cluster GPU-capacity dashboards)
        self.tpu_chips_allocatable = registry.gauge(
            "tpu_chips_allocatable",
            "TPU chips allocatable in the cluster, by accelerator",
            labels=("accelerator",),
        )
        # availability SLI (runtime/slo.py notebook-availability objective):
        # of the non-stopped TPU notebooks that have EVER been mesh-ready,
        # the fraction mesh-ready right now. Previously-ready only, so fleet
        # bring-up doesn't read as an availability incident — bring-up is
        # the readiness-latency SLO's jurisdiction
        self.notebook_available_ratio = registry.gauge(
            "notebook_available_ratio",
            "Fraction of previously-ready, non-stopped TPU notebooks "
            "currently mesh-ready (1.0 when none qualify)",
        )
        self._seen_accelerators: set = set()
        if client is not None:
            registry.add_collector(self._scrape)

    def _scrape(self) -> None:
        """Pull-style collector: list StatefulSets at scrape time (reference
        Metrics.scrape :82-99) and aggregate running notebooks + bound chips,
        plus fleet chip capacity from Node allocatable."""
        assert self.client is not None
        # deferred import (notebook.py imports this module at load time),
        # once per scrape
        from .notebook import statefulset_name

        running = 0
        chips = 0
        for sts in self.client.list(StatefulSet):
            if C.NOTEBOOK_NAME_LABEL not in sts.spec.template.metadata.labels:
                continue
            owner_nb = sts.metadata.labels.get(C.NOTEBOOK_NAME_LABEL, "")
            # STS names are the CLAMPED form of the notebook name
            if statefulset_name(owner_nb) != sts.metadata.name:
                continue
            ready = sts.status.ready_replicas
            if ready > 0:
                running += 1
            for c in sts.spec.template.spec.containers:
                if c.resources and c.resources.requests.get(GPU_RESOURCE):
                    chips += ready * int(float(c.resources.requests[GPU_RESOURCE]))
        self.notebook_running.set(running)
        self.tpu_chips_bound.set(chips)

        qualifying = available = 0
        try:
            for nb in self.client.list(Notebook):
                if (
                    nb.spec.tpu is None
                    or not nb.spec.tpu.accelerator
                    or nb.metadata.deletion_timestamp
                    or C.STOP_ANNOTATION in nb.metadata.annotations
                    # mid-suspend/resume (controllers/suspend.py) is a
                    # PLANNED transition, not downtime: a fleet-wide morning
                    # rush of resumes must not burn the availability budget
                    # (resume slowness is the resume-latency SLO's
                    # jurisdiction, exactly as bring-up belongs to
                    # readiness-latency). Terminal resume-failed is NOT
                    # planned — a user locked out of a dead resume is
                    # exactly what availability must page on, so it stays
                    # counted (and, never mesh-ready, counts unavailable).
                    or nb.metadata.annotations.get(
                        C.TPU_SUSPEND_STATE_ANNOTATION
                    ) in ("checkpointing", "suspended", "resuming")
                    or nb.status.tpu is None
                    or not nb.status.tpu.first_ready_time
                ):
                    continue
                qualifying += 1
                if nb.status.tpu.mesh_ready:
                    available += 1
        except Exception as e:
            import logging

            logging.getLogger(__name__).warning(
                "availability scrape: Notebook list failed: %r", e
            )
        else:
            self.notebook_available_ratio.set(
                available / qualifying if qualifying else 1.0
            )

        capacity: dict = {}
        try:
            nodes = self.client.list(Node)
        except Exception as e:
            import logging

            logging.getLogger(__name__).warning("capacity scrape: Node list failed: %r", e)
            return  # keep last values rather than zeroing on a transient error
        for node in nodes:
            alloc = (node.status.allocatable or {}).get(GPU_RESOURCE)
            if not alloc:
                continue
            accel = node.metadata.labels.get(GKE_GPU_ACCELERATOR_LABEL, "unknown")
            capacity[accel] = capacity.get(accel, 0) + int(float(alloc))
        for accel, total in sorted(capacity.items()):
            self.tpu_chips_allocatable.set(total, accelerator=accel)
        # zero series for accelerator types that left the cluster — stale
        # phantom capacity must not outlive its nodes
        for accel in self._seen_accelerators - set(capacity):
            self.tpu_chips_allocatable.set(0, accelerator=accel)
        self._seen_accelerators |= set(capacity)
