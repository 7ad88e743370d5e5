"""One side's cluster for the suspend/resume parity tests
(tests/test_torch_suspend.py, tests/test_torch_suspend_soak.py): the
reference's tests/test_suspend.py `build_env` on the JAX package or the
port, with what a scenario compares read off it.

`Env(side, ...)` starts a SimCluster with `slices` pools of the side's
one-host slice (JAX v5e 2x2 ~ port h100 1x4, tests/torch_sides.py), sim
agents, and a Manager with the notebook reconciler, the readiness gate, the
culler (unless `culling=False`) and the SuspendResumeController (its
transport `suspend_http_get(env)` when given), plus the endpoint reconciler
with `serving`; every pod takes `cold_start_s` from its bind to ready.
`sequences` keeps each notebook's suspend-state values in
order. Identities and times are never compared: events are compared with
their seconds masked, spans without their times.
"""
import re
import time

from torch_sides import Sequences, wait_for

NS = "multiplex"
TIMEOUT = 40.0
# the reference test's Config
FAST = dict(enable_culling=True, suspend_enabled=True, cull_idle_time_min=1.0 / 60.0,
            idleness_check_period_min=0.1 / 60.0, readiness_probe_period_s=0.15, suspend_checkpoint_window_s=1.5,
            suspend_checkpoint_retries=2, suspend_checkpoint_backoff_s=0.05, resume_timeout_s=20.0,
            resume_max_attempts=4, reclaim_pending_grace_s=0.3)
SPANS = ("notebook.suspend", "notebook.resume")
TIMED = ("latency_s",)  # span attributes that are times
RECLAIM_REASONS = ("suspend", "job-preempt", "endpoint-drain", "pool-idle", "poisoned")


class Env:
    def __init__(self, side, cfg=FAST, slices=2, duty=0.9, kernels_busy=True, culling=True, serving=False,
                 suspend_http_get=None, webhook=False, cold_start_s=0.0):
        self.side, self.C = side, side.C
        self.started = time.time()
        self.accelerator, self.topology = side.slices["one-host"]
        self.shape = side.plan_slice(self.accelerator, self.topology)
        self.cluster = side.cluster.SimCluster().start()
        side.add_pool(self.cluster, "pool", self.accelerator, self.topology, slices=slices)
        self.client = self.cluster.client
        self.config = side.ctrl.Config(**cfg)
        self.mgr = side.runtime.Manager(self.cluster.store)
        self.before = self.counters()
        http_get = self.cluster.http_get
        if webhook:
            side.ctrl.NotebookWebhook(self.mgr.client, self.config).register(self.cluster.store)
        side.ctrl.NotebookReconciler(self.mgr, self.config).setup()
        if webhook:
            side.ctrl.TPUWorkbenchReconciler(self.mgr, self.config).setup()
        side.ctrl.ProbeStatusController(self.mgr, self.config, http_get=http_get).setup()
        if culling:
            side.ctrl.CullingReconciler(self.mgr, self.config, http_get=http_get).setup()
        side.ctrl.SuspendResumeController(
            self.mgr, self.config, http_get=http_get if suspend_http_get is None else suspend_http_get(self)).setup()
        if serving:
            side.ctrl.InferenceEndpointReconciler(self.mgr, self.config, http_get=http_get).setup()
        self.agents = {}
        self.cluster.add_pod_behavior(side.behavior(self.agents, duty=duty, kernels_busy=kernels_busy,
                                                    cold_start_s=cold_start_s))
        self.sequences = Sequences(self.cluster.store, self.C.TPU_SUSPEND_STATE_ANNOTATION,
                                   self.C.TPU_DEGRADED_CONDITION)
        self.mgr.start()

    def stop(self):
        try:
            self.sequences.stop()
            self.mgr.stop()
        finally:
            self.cluster.stop()
            self.cluster.faults.clear()

    # -- objects --
    def notebook(self, name, priority=0, labels=None):
        nb = self.side.nb.Notebook()
        nb.metadata.name, nb.metadata.namespace = name, NS
        if labels:
            nb.metadata.labels.update(labels)
        nb.spec.template.spec.containers = [self.side.core.Container(name=name, image="jax:1")]
        nb.spec.tpu = self.side.nb.TPUSpec(accelerator=self.accelerator, topology=self.topology, priority=priority)
        return self.client.create(nb)

    def endpoint(self, name, priority=0, drain_s=30.0):
        inf = self.side.inference
        ep = inf.InferenceEndpoint()
        ep.metadata.name, ep.metadata.namespace = name, NS
        ep.spec.template.spec.containers = [self.side.core.Container(name=name, image="serve:1")]
        ep.spec.tpu = self.side.nb.TPUSpec(accelerator=self.accelerator, topology=self.topology, priority=priority)
        ep.spec.serving = inf.ServingSpec(drain_timeout_s=drain_s)
        return self.client.create(ep)

    def get(self, name):
        return self.client.get(self.side.nb.Notebook, NS, name)

    def state(self, name):
        return self.get(name).metadata.annotations.get(self.C.TPU_SUSPEND_STATE_ANNOTATION, "")

    def mesh_ready(self, name):
        nb = self.get(name)
        return nb.status.tpu is not None and nb.status.tpu.mesh_ready

    def active(self, name):
        ann = self.get(name).metadata.annotations
        return (self.C.STOP_ANNOTATION not in ann and not ann.get(self.C.TPU_SUSPEND_STATE_ANNOTATION)
                and self.mesh_ready(name))

    def pods(self, name):
        return [p for p in self.client.list(self.side.core.Pod, namespace=NS,
                                            labels={self.C.NOTEBOOK_NAME_LABEL: name})
                if not p.metadata.deletion_timestamp]

    def suspended(self, name):
        return self.state(name) == "suspended" and not self.pods(name)

    def warm_pools(self):
        sp = self.side.slicepool
        return sorted({n.metadata.labels.get(self.side.pool_label) for n in self.client.list(self.side.core.Node)
                       if n.metadata.annotations.get(sp.POOL_STATE_ANNOTATION) == sp.POOL_STATE_WARM})

    def pool_marks(self):
        sp = self.side.slicepool
        return sorted((n.metadata.labels.get(self.side.pool_label), n.metadata.annotations.get(sp.POOL_STATE_ANNOTATION))
                      for n in self.client.list(self.side.core.Node)
                      if n.metadata.annotations.get(sp.POOL_STATE_ANNOTATION))

    def reclaim_idle(self):
        return self.side.slicepool.SlicePool(self.client).reclaim_idle(self.shape.gke_accelerator,
                                                                       self.shape.topology)

    def patch(self, name, annotations, attempts=40, kind=None):
        """Scenario-driver writes land even while a seeded bad day throws
        409/429 at everything (the reference's patch_persistent)."""
        am = self.side.am
        for i in range(attempts):
            try:
                return self.client.patch(kind or self.side.nb.Notebook, NS, name,
                                         {"metadata": {"annotations": annotations}})
            except (am.ConflictError, am.TooManyRequestsError):
                if i == attempts - 1:
                    raise
                time.sleep(0.02)

    def stop_nb(self, name):
        """The culler's atomic stamp: the stop and checkpointing in one patch."""
        self.patch(name, {self.C.STOP_ANNOTATION: "2026-01-01T00:00:00Z",
                          self.C.TPU_SUSPEND_STATE_ANNOTATION: "checkpointing"})

    def unstop(self, name):
        self.patch(name, {self.C.STOP_ANNOTATION: None})

    def events(self, name=None):
        out = set()
        for e in self.client.list(self.side.core.Event, namespace=NS):
            if name is not None and e.involved_object.name != name:
                continue
            out.add((e.involved_object.name, e.reason, re.sub(r"\d+\.\d+s", "<s>", e.message)))
        return sorted(out)

    def has_event(self, reason, name=None):
        return any(r == reason for _, r, _ in self.events(name))

    # -- what is compared --
    def counters(self):
        sp, telemetry = self.side.slicepool, self.side.telemetry
        out = {"hits": sp.slice_pool_hits_total.value(), "misses": sp.slice_pool_misses_total.value(),
               "resumes": sp.notebook_resume_seconds._totals.get((), 0),
               "checkpoint saves": telemetry.slice_checkpoint_saves_total.value()}
        out.update({f"reclaims {r}": sp.notebook_reclaims_total.value(reason=r) for r in RECLAIM_REASONS})
        out.update({f"verifications {r}": sp.notebook_restore_verifications_total.value(result=r)
                    for r in ("ok", "mismatch", "unverified")})
        return out

    def deltas(self):
        after = self.counters()
        return {k: after[k] - self.before[k] for k in after}

    def spans(self, name):
        out = []
        for s in self.side.tracing.recent_spans():
            attrs = s["attributes"]
            if s["name"] not in SPANS or attrs.get("notebook") != name or s["start_time"] < self.started:
                continue
            out.append((s["start_time"], s["name"], tuple(sorted((k, v) for k, v in attrs.items() if k not in TIMED))))
        return [(n, a) for _, n, a in sorted(out)]

    def incidents(self, name):
        return sorted({i["reason"] for i in self.side.recorder.incidents() if i["subject"] == f"{NS}/{name}"})

    def annotations(self, name):
        """The suspend machine's annotations that are not times."""
        C = self.C
        ann = self.get(name).metadata.annotations
        keys = {"state": C.TPU_SUSPEND_STATE_ANNOTATION, "checkpoint-saved": C.TPU_CHECKPOINT_SAVED_ANNOTATION,
                "checksum": C.TPU_CHECKPOINT_CHECKSUM_ANNOTATION, "reclaim": C.TPU_RECLAIM_ANNOTATION,
                "attempts": C.TPU_RESUME_ATTEMPTS_ANNOTATION}
        out = {name: ann.get(key) for name, key in keys.items()}
        out["stopped"] = C.STOP_ANNOTATION in ann
        return out

    def settled(self, *names, events=()):
        """What is compared once a scenario is done: each notebook's
        suspend states in order, events, spans, incident reasons and
        annotations, the counters' deltas and the pool's marks."""
        for name in names:
            wait_for(lambda: self.sequences.caught_up(name, self.state(name), None),
                     msg=f"the watch to see {name} as it is")
        for name, reason in events:
            wait_for(lambda: self.has_event(reason, name), msg=f"{name}'s {reason} event")
        return {"sequences": {n: self.sequences.of(n)["annotation"] for n in names},
                "events": {n: self.events(n) for n in names}, "spans": {n: self.spans(n) for n in names},
                "incidents": {n: self.incidents(n) for n in names},
                "annotations": {n: self.annotations(n) for n in names},
                "counters": self.deltas(), "pool": self.pool_marks(), "healthy": self.mgr.healthz()}


def assert_same(got):
    jax, port = got["jax"], got["port"]
    assert jax.keys() == port.keys()
    for key in jax:
        assert jax[key] == port[key], (key, jax[key], port[key])
