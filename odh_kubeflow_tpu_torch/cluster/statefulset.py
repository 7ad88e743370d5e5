"""StatefulSet controller for the in-process cluster.

Gives our control plane the STS semantics the reference's notebooks depend on
(reference relies on real Kubernetes for this; envtest can't run it at all —
suite comment at notebook_controller_bdd_test.go:73-77 — so this build's test
cluster is strictly more capable):

- ordinal pod identity {name}-{i} with stable hostname/subdomain,
- `apps.kubernetes.io/pod-index` + `statefulset.kubernetes.io/pod-name` labels
  (the pod-index label feeds TPU_WORKER_ID via the downward API),
- scale up/down to spec.replicas (stop-annotation culling scales to 0),
- template-hash-based recreate on template change,
- status.replicas / readyReplicas aggregation.
"""
from __future__ import annotations

import hashlib
import json
from typing import Optional

from ..api.apps import StatefulSet
from ..api.core import Pod
from ..apimachinery import AlreadyExistsError, NotFoundError, ignore_not_found
from .client import retry_on_conflict
from ..runtime.controller import Request, Result
from ..runtime.manager import Manager

POD_INDEX_LABEL = "apps.kubernetes.io/pod-index"
POD_NAME_LABEL = "statefulset.kubernetes.io/pod-name"
REVISION_LABEL = "controller-revision-hash"


def template_hash(sts: StatefulSet) -> str:
    blob = json.dumps(sts.spec.template.to_dict(), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:10]


class StatefulSetController:
    def __init__(self, manager: Manager):
        self.manager = manager
        self.client = manager.client
        self.api_reader = manager.api_reader

    def setup(self) -> None:
        (
            self.manager.builder("statefulset")
            .for_(StatefulSet)
            .owns(Pod)
            .complete(self.reconcile)
        )

    def reconcile(self, req: Request) -> Optional[Result]:
        try:
            sts = self.client.get(StatefulSet, req.namespace, req.name)
        except NotFoundError:
            return None
        if sts.metadata.deletion_timestamp:
            return None
        desired = sts.spec.replicas if sts.spec.replicas is not None else 1
        rev = template_hash(sts)

        pods = [
            p
            for p in self.client.list(Pod, namespace=req.namespace)
            if p.owned_by(sts)
        ]
        by_name = {p.metadata.name: p for p in pods}

        ready = 0
        running = 0
        for i in range(desired):
            pod_name = f"{sts.metadata.name}-{i}"
            pod = by_name.pop(pod_name, None)
            if pod is None:
                self._create_pod(sts, i, rev)
                continue
            if pod.metadata.deletion_timestamp:
                continue
            if pod.metadata.labels.get(REVISION_LABEL) != rev:
                # template changed: recreate (rolling, highest ordinal first is
                # not modeled; recreate-on-sight is sufficient for notebooks)
                ignore_not_found(
                    self._try(lambda: self.client.delete(Pod, req.namespace, pod_name))
                )
                continue
            running += 1
            if pod.is_ready():
                ready += 1

        # scale down: delete pods with ordinal >= desired (and strays)
        for pod in by_name.values():
            ignore_not_found(
                self._try(lambda name=pod.metadata.name: self.client.delete(Pod, req.namespace, name))
            )

        def write_status():
            # re-GET inside the retry: concurrent reconcilers racing the
            # notebook controller's status mirror made a blind
            # read-modify-write conflict-crash here (retry.RetryOnConflict
            # at every multi-writer site — SURVEY §5)
            try:
                cur = self.api_reader.get(StatefulSet, req.namespace, req.name)
            except NotFoundError:
                return
            if (
                cur.status.replicas != running
                or cur.status.ready_replicas != ready
                or cur.status.observed_generation != cur.metadata.generation
            ):
                cur.status.replicas = running
                cur.status.ready_replicas = ready
                cur.status.current_replicas = running
                cur.status.updated_replicas = running
                cur.status.observed_generation = cur.metadata.generation
                self.client.update_status(cur)

        retry_on_conflict(write_status)
        return None

    def _try(self, fn):
        try:
            fn()
            return None
        except Exception as e:  # noqa: BLE001 - converted to return-value
            return e

    def _create_pod(self, sts: StatefulSet, ordinal: int, rev: str) -> None:
        pod = Pod()
        pod.metadata.name = f"{sts.metadata.name}-{ordinal}"
        pod.metadata.namespace = sts.metadata.namespace
        pod.metadata.labels = dict(sts.spec.template.metadata.labels)
        pod.metadata.labels[POD_INDEX_LABEL] = str(ordinal)
        pod.metadata.labels[POD_NAME_LABEL] = pod.metadata.name
        pod.metadata.labels[REVISION_LABEL] = rev
        pod.metadata.annotations = dict(sts.spec.template.metadata.annotations)
        pod.spec = sts.spec.template.spec.deepcopy()
        pod.spec.hostname = pod.metadata.name
        if sts.spec.service_name:
            pod.spec.subdomain = sts.spec.service_name
        pod.set_owner(sts)
        try:
            self.client.create(pod)
        except AlreadyExistsError:
            pass  # race with a concurrent reconcile; next pass adopts it
