"""The port's InferenceEndpoint reconciler (controllers/inference.py), the
warm slice pool (cluster/slicepool.py) and the API type against the JAX
package's, on the CPU: each scenario of the controller half of
tests/test_serving.py, and the serving fleet's scale-down and
scale-to-zero, run with one script through both SimClusters at once
(tests/torch_sides.py: JAX v5e 2x2 ~ port h100 1x4, one host of 4 chips).

As in the reference test, the source notebook is suspended through
SuspendResumeController (the stop and checkpointing in one patch, its slice
released warm). For each scenario both sides give the same endpoint-state values
and DegradedServing values in the same order, the same events (reason and
message), the same StatefulSets, Services and HTTPRoute outside the device
fields (the `nvidia.com/gpu` / `google.com/tpu` resource, toleration,
node selector and torchrun/JAX env), the same status outside the
accelerator's name and topology, the same counter deltas, spans and
incident reasons. Identities (uids, resourceVersions, timestamps, trace
ids) are not compared. The JAX reconciler runs with two of the port's
repairs applied from this side (`fresh_fleet_reads`): it reads its fleet's
StatefulSets fresh, not from the cache, and its status mirror writes the
fleet view's zero and empty fields (`replicas`, `servingReplicas`,
`drainingReplicas`), which its merge patch of `to_dict()` left out.
"""
import time

import torch_threads
from torch_sides import Sequences, both, wait_for

torch_threads.cap()

NS = "serving"
# the reference test's config, but a gang waits 5 s unschedulable (not 0.3 s)
# before Pending reclaims an idle warm slice for it: under a loaded test
# machine a plain placement can take longer than 0.3 s on one side only.
# The scale-to-zero scenario, which is about that reclaim, keeps 0.3 s.
FAST = dict(suspend_enabled=True, readiness_probe_period_s=0.15, suspend_checkpoint_window_s=1.5,
            resume_timeout_s=20.0, resume_max_attempts=4, reclaim_pending_grace_s=5.0,
            serving_loading_window_s=8.0, serving_drain_timeout_s=0.3)
RECLAIMING = dict(FAST, reclaim_pending_grace_s=0.3)
TIMEOUT = 40.0
# metadata that names an identity or a time, not what was rendered
IDENTITY = ("uid", "resourceVersion", "creationTimestamp", "generation", "managedFields", "deletionTimestamp")


FLEET_VIEW = {"replicas": 0, "servingReplicas": 0, "drainingReplicas": []}


class _FleetViewWritten:
    """A client whose patch_status of an InferenceEndpoint writes the fleet
    view's fields that the patch leaves out as 0 and []: the status
    mirror's patch is `status.to_dict()`, which leaves a field out exactly
    when it is 0 or empty, so this writes what the port's mirror writes."""

    def __init__(self, client, endpoint_cls):
        self._client, self._endpoint_cls = client, endpoint_cls

    def __getattr__(self, name):
        return getattr(self._client, name)

    def patch_status(self, cls, namespace, name, patch):
        if cls is self._endpoint_cls:
            patch = {**FLEET_VIEW, **patch}
        return self._client.patch_status(cls, namespace, name, patch)


def fresh_fleet_reads(side):
    """The side's InferenceEndpointReconciler with the port's two repairs:
    it reads its fleet's StatefulSets fresh as the port's does (the JAX one
    reads them from the cache, which right after a retire can still show
    the retired gang up and drain it again:
    test_a_retired_gang_is_not_drained_again_from_a_stale_cache), and its
    status mirror writes `replicas`, `servingReplicas` and
    `drainingReplicas` at 0 and [] (the JAX one leaves them as they were:
    test_the_fleet_view_goes_back_to_zero_after_a_retire_and_a_park). Both
    sides are compared with the port's repairs in place, so that neither
    the race nor the stale fields decide the comparison."""
    if side.name == "port":
        return side.ctrl.InferenceEndpointReconciler
    C, StatefulSet = side.C, side.apps.StatefulSet

    class FreshFleet(side.ctrl.InferenceEndpointReconciler):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.client = _FleetViewWritten(self.client, side.inference.InferenceEndpoint)

        def _replica_statefulsets(self, ep):
            out = {}
            for sts in self.api_reader.list(StatefulSet, namespace=ep.metadata.namespace,
                                            labels={C.INFERENCE_NAME_LABEL: ep.metadata.name}):
                try:
                    idx = int(sts.metadata.labels.get(C.INFERENCE_REPLICA_LABEL, "0"))
                except (TypeError, ValueError):
                    idx = 0
                out[idx] = sts
            return out

    return FreshFleet


class Env:
    """One side's cluster with the reference test's controllers: the
    notebook reconciler, the readiness gate, the suspend controller and the
    endpoint reconciler (and, with `repair`, the slice-repair controller), `slices` pools of
    the one-host slice, sim agents, and /tpu/restore answers registered by
    pod-name substring at the transport (the reference test's
    `restore_acks`)."""

    def __init__(self, side, slices=2, repair=False, cfg=FAST):
        self.side, self.C = side, side.C
        # the tracing buffers are the process's: the JAX package's own
        # tests/test_serving.py, run before in the same process, names its
        # endpoints alike, so a scenario reads only spans that started after
        self.started = time.time()
        self.accelerator, self.topology = side.slices["one-host"]
        self.shape = side.plan_slice(self.accelerator, self.topology)
        self.cluster = side.cluster.SimCluster().start()
        side.add_pool(self.cluster, "pool", self.accelerator, self.topology, slices=slices)
        self.client = self.cluster.client
        self.restore_acks = {}

        def http_get(url, timeout=10.0):
            if "/tpu/restore" in url:
                for key, ack in self.restore_acks.items():
                    if key in url:
                        return 200, __import__("json").dumps(ack).encode()
            return self.cluster.http_get(url, timeout=timeout)

        self.mgr = side.runtime.Manager(self.cluster.store)
        self.config = side.ctrl.Config(**cfg)
        side.ctrl.NotebookReconciler(self.mgr, self.config).setup()
        side.ctrl.ProbeStatusController(self.mgr, self.config, http_get=self.cluster.http_get).setup()
        side.ctrl.SuspendResumeController(self.mgr, self.config, http_get=http_get).setup()
        fresh_fleet_reads(side)(self.mgr, self.config, http_get=http_get).setup()
        if repair:
            side.ctrl.SliceRepairController(self.mgr, self.config, http_get=self.cluster.http_get).setup()
        self.agents = {}
        self.cluster.add_pod_behavior(side.behavior(self.agents, duty=0.9))
        self.sequences = Sequences(self.cluster.store, self.C.INFERENCE_STATE_ANNOTATION,
                                   self.C.DEGRADED_SERVING_CONDITION, kind="InferenceEndpoint")
        self.mgr.start()
        self.before = self.counters()

    def stop(self):
        try:
            self.sequences.stop()
            self.mgr.stop()
        finally:
            self.cluster.stop()
            self.cluster.faults.clear()

    # -- objects --
    def notebook(self, name, priority=0):
        nb = self.side.nb.Notebook()
        nb.metadata.name, nb.metadata.namespace = name, NS
        nb.spec.template.spec.containers = [self.side.core.Container(name=name, image="img:1")]
        nb.spec.tpu = self.side.nb.TPUSpec(accelerator=self.accelerator, topology=self.topology, priority=priority)
        return self.client.create(nb)

    def endpoint(self, name, source=None, drain_s=0.0, replicas=1, autoscaling=None):
        inf = self.side.inference
        ep = inf.InferenceEndpoint()
        ep.metadata.name, ep.metadata.namespace = name, NS
        ep.spec.template.spec.containers = [self.side.core.Container(name=name, image="serve:1")]
        if source:
            ep.spec.notebook_ref = inf.NotebookRef(name=source)
        else:
            ep.spec.tpu = self.side.nb.TPUSpec(accelerator=self.accelerator, topology=self.topology)
        ep.spec.serving = inf.ServingSpec(max_batch_slots=2, max_queue_depth=8, max_seq=64, max_new_tokens=8,
                                          drain_timeout_s=drain_s, replicas=replicas,
                                          autoscaling=None if autoscaling is None
                                          else inf.AutoscalingSpec(**autoscaling))
        return self.client.create(ep)

    def get(self, name):
        return self.client.get(self.side.inference.InferenceEndpoint, NS, name)

    def state(self, name):
        return self.get(name).metadata.annotations.get(self.C.INFERENCE_STATE_ANNOTATION, "")

    def patch(self, name, annotations, attempts=40):
        am = self.side.am
        for i in range(attempts):
            try:
                return self.client.patch(self.side.inference.InferenceEndpoint, NS, name,
                                         {"metadata": {"annotations": annotations}})
            except (am.ConflictError, am.TooManyRequestsError):
                if i == attempts - 1:
                    raise
                time.sleep(0.02)

    def mesh_ready(self, name):
        nb = self.client.get(self.side.nb.Notebook, NS, name)
        return nb.status.tpu is not None and nb.status.tpu.mesh_ready

    def pods(self, label, name):
        return [p for p in self.client.list(self.side.core.Pod, namespace=NS, labels={label: name})
                if not p.metadata.deletion_timestamp]

    def ep_pods(self, name):
        return self.pods(self.C.INFERENCE_NAME_LABEL, name)

    def pool_of(self, node):
        return self.client.get(self.side.core.Node, "", node).metadata.labels[self.side.pool_label]

    def pool_states(self):
        """pool -> (state, priority, claimed-by) of its nodes' marks."""
        sp = self.side.slicepool
        out = {}
        for n in self.client.list(self.side.core.Node):
            ann = n.metadata.annotations
            out[n.metadata.labels[self.side.pool_label]] = (
                ann.get(sp.POOL_STATE_ANNOTATION, ""), ann.get(sp.POOL_PRIORITY_ANNOTATION, ""),
                ann.get(sp.POOL_CLAIMED_BY_ANNOTATION, ""))
        return out

    def events(self, name):
        return sorted({(e.reason, e.message) for e in self.client.list(self.side.core.Event, namespace=NS)
                       if e.involved_object.kind == "InferenceEndpoint" and e.involved_object.name == name})

    def has_event(self, name, reason):
        return any(r == reason for r, _ in self.events(name))

    def route(self, name):
        ep = self.get(name)
        route_name = self.side.ctrl.inference.endpoint_route_name(ep)
        try:
            return self.client.get(self.side.gateway.HTTPRoute, self.config.controller_namespace, route_name)
        except self.side.am.NotFoundError:
            return None

    # -- what is compared --
    def counters(self):
        sm, sp = self.side.sm, self.side.slicepool
        out = {f"promotions {b}": sm.inference_endpoint_promotions_total.value(bind=b) for b in ("warm", "cold")}
        out.update({f"verifications {r}": sm.inference_restore_verifications_total.value(result=r)
                    for r in ("ok", "mismatch", "unverified")})
        out.update({f"reclaims {r}": sp.notebook_reclaims_total.value(reason=r) for r in ("pool-idle", "poisoned")})
        out["prewarmed"] = sp.slice_pool_prewarmed_total.value()
        return out

    def _plain(self, obj):
        """An object's JSON without its identity, times and trace ids."""
        d = obj.to_dict()
        meta = d["metadata"]
        for key in IDENTITY:
            meta.pop(key, None)
        for ref in meta.get("ownerReferences", []):
            ref.pop("uid", None)
        annotations = meta.get("annotations", {})
        annotations.pop(self.C.TRACEPARENT_ANNOTATION, None)
        if not annotations:
            meta.pop("annotations", None)
        return d

    def _without_device(self, sts):
        """A StatefulSet's JSON without its device fields (the resource, its
        toleration, the node selector's slice keys, the device env and the
        port's GPU_ENV_ANNOTATION); only the engine's SERVING_* env stays."""
        d = self._plain(sts)
        d.pop("status", None)
        (d["metadata"].get("annotations") or {}).pop("notebooks.opendatahub.io/gpu-slice-env", None)
        if not d["metadata"].get("annotations"):
            d["metadata"].pop("annotations", None)
        template = d["spec"]["template"]
        (template["metadata"].get("annotations") or {}).pop(self.C.TRACEPARENT_ANNOTATION, None)
        pod = template["spec"]
        for key in self.side.selector_keys:
            pod.get("nodeSelector", {}).pop(key, None)
        pod["tolerations"] = [t for t in pod.get("tolerations", []) if t["key"] != self.side.device_resource]
        for c in pod["containers"]:
            for kind in ("requests", "limits"):
                c.get("resources", {}).get(kind, {}).pop(self.side.device_resource, None)
            c["env"] = [e for e in c.get("env", []) if e["name"].startswith("SERVING_")]
        return d

    def objects(self, name):
        """The endpoint's sets, Services and route, sorted by name."""
        label = {self.C.INFERENCE_NAME_LABEL: name}
        sets = [self._without_device(s)
                for s in self.client.list(self.side.apps.StatefulSet, namespace=NS, labels=label)]
        services = [self._plain(s) for s in self.client.list(self.side.core.Service, namespace=NS, labels=label)]
        for s in services:
            s.pop("status", None)
        route = self.route(name)
        return {"sets": sorted(sets, key=lambda d: d["metadata"]["name"]),
                "services": sorted(services, key=lambda d: d["metadata"]["name"]),
                "route": None if route is None else self._plain(route)}

    def status(self, name):
        st = self.get(name).status.to_dict()
        for c in st.get("conditions", []):
            c.pop("lastProbeTime", None)
            c.pop("lastTransitionTime", None)
        for key in ("accelerator", "topology"):
            (st.get("tpu") or {}).pop(key, None)
        return st

    def spans(self, name, span_name):
        return [s["attributes"] for s in self.side.tracing.recent_spans(name=span_name)
                if s["attributes"].get("endpoint") == name and s["start_time"] >= self.started]

    def incidents(self, name):
        return sorted({i["reason"] for i in self.side.recorder.incidents() if i["subject"] == f"{NS}/{name}"})

    def caught_up(self, name):
        ep = self.get(name)
        c = next((c for c in ep.status.conditions if c.type == self.C.DEGRADED_SERVING_CONDITION), None)
        return self.sequences.caught_up(name, ep.metadata.annotations.get(self.C.INFERENCE_STATE_ANNOTATION, ""),
                                        None if c is None else (c.status, c.reason))

    def settled(self, name, want_events=(), phase=None):
        """What is compared of an endpoint once a scenario is done (with
        `phase`, once its status mirror shows it: the mirror follows the
        state's write)."""
        if phase is not None:
            wait_for(lambda: self.get(name).status.phase == phase, msg=f"{name}'s status in {phase}")
        wait_for(lambda: self.caught_up(name), msg=f"the watch to see {name} as it is")
        for reason in want_events:
            wait_for(lambda: self.has_event(name, reason), msg=f"{name}'s {reason} event")
        after = self.counters()
        return {"sequences": self.sequences.of(name), "events": self.events(name), "objects": self.objects(name),
                "status": self.status(name), "counters": {k: after[k] - self.before[k] for k in after},
                "incidents": self.incidents(name), "healthy": self.mgr.healthz()}


def run_both(scenario, **kw):
    return both(scenario, lambda side: Env(side, **kw), lambda env: env.stop())


def assert_same(got):
    jax, port = got["jax"], got["port"]
    assert jax.keys() == port.keys()
    for key in jax:
        assert jax[key] == port[key], (key, jax[key], port[key])


def promote(env, source, endpoint, saved, restored):
    """The reference's promotion episode up to the endpoint's create: the
    source notebook comes up, is stopped with the checkpointing stamp, acks
    a checkpoint of `saved` through its agent and is suspended, its slice
    released warm, and `restored` is what the endpoint's /tpu/restore will
    answer. Returns the source's pool."""
    env.notebook(source)
    wait_for(lambda: env.mesh_ready(source), timeout=TIMEOUT, msg=f"{source}'s bring-up")
    env.agents[f"{source}-0"].checkpoint_hook = lambda: dict(saved)
    C, Pod, Node = env.C, env.side.core.Pod, env.side.core.Node
    (node,) = {p.spec.node_name for p in env.client.list(Pod, namespace=NS, labels={C.NOTEBOOK_NAME_LABEL: source})}
    pool = env.client.get(Node, "", node).metadata.labels[env.side.pool_label]
    env.client.patch(env.side.nb.Notebook, NS, source, {"metadata": {"annotations": {
        C.STOP_ANNOTATION: "2026-01-01T00:00:00Z", C.TPU_SUSPEND_STATE_ANNOTATION: "checkpointing"}}})
    wait_for(lambda: env.client.get(env.side.nb.Notebook, NS, source).metadata.annotations.get(
        C.TPU_SUSPEND_STATE_ANNOTATION) == "suspended" and not [
        p for p in env.client.list(Pod, namespace=NS, labels={C.NOTEBOOK_NAME_LABEL: source})
        if not p.metadata.deletion_timestamp], timeout=TIMEOUT, msg=f"{source} suspended, its slice released warm")
    env.restore_acks[f"{endpoint}-serve"] = dict(restored, restored=True)
    env.endpoint(endpoint, source=source)
    return pool


# ---------------------------------------------------------------------------
# promotion: warm bind, verified restore, route, one trace
# ---------------------------------------------------------------------------


def test_promotion_warm_bind_and_verified_restore():
    def scenario(env):
        pool = promote(env, "trainer", "gemma", {"step": 42, "checksum": "c0ffee"},
                       {"step": 42, "checksum": "c0ffee"})
        assert env.pool_states()[pool][0] in ("warm", "claimed")
        wait_for(lambda: env.state("gemma") == "serving", timeout=TIMEOUT, msg="endpoint Serving")
        ep = env.get("gemma")
        ann = ep.metadata.annotations
        trace_id = env.side.tracing.parse_traceparent(ann[env.C.TRACEPARENT_ANNOTATION])[0]

        def on_trace():
            return {s["name"] for s in env.side.tracing.recent_spans(trace_id=trace_id)}

        # the root closes just after the state's write
        wait_for(lambda: "endpoint.ready" in on_trace(), msg="the endpoint.ready root closed")
        out = env.settled("gemma", ("EndpointPromoted", "EndpointServing"), phase="Serving")
        out.update(
            lineage={k: ann.get(k) for k in (env.C.INFERENCE_PROMOTED_FROM_ANNOTATION,
                                             env.C.TPU_CHECKPOINT_SAVED_ANNOTATION,
                                             env.C.TPU_CHECKPOINT_CHECKSUM_ANNOTATION)},
            on_source_pool={env.pool_of(p.spec.node_name) for p in env.ep_pods("gemma")} == {pool},
            pools=sorted(env.pool_states().values()),
            promotion=env.spans("gemma", "endpoint.promotion"),
            on_trace=sorted(on_trace() & {"endpoint.ready", "endpoint.promotion"}))
        return out

    got = run_both(scenario)
    assert_same(got)
    port = got["port"]
    assert port["sequences"]["annotation"] == ["", "loading", "serving"]
    assert port["lineage"] == {"inference.tpu.kubeflow.org/promoted-from": f"{NS}/trainer",
                               "notebooks.tpu.kubeflow.org/checkpoint-saved": "42",
                               "notebooks.tpu.kubeflow.org/checkpoint-checksum": "c0ffee"}
    assert port["on_source_pool"], "the warm bind missed the source notebook's released pool"
    assert port["counters"]["promotions warm"] == 1 and port["counters"]["verifications ok"] == 1
    assert port["counters"]["verifications mismatch"] == port["counters"]["verifications unverified"] == 0
    assert ("EndpointServing", "serving: every host mesh-ready, restore verified, route live") in port["events"]
    assert port["status"]["phase"] == "Serving" and port["status"]["url"] == f"/serving/{NS}/gemma"
    assert port["objects"]["route"] is not None
    assert all(state == "" for state, _, _ in port["pools"]), "pool marks left after the bind window"
    assert port["promotion"] == [{"endpoint": "gemma", "namespace": NS, "source": f"{NS}/trainer",
                                  "warm_bind": True}]
    assert port["on_trace"] == ["endpoint.promotion", "endpoint.ready"] and port["healthy"]


def test_restore_mismatch_is_load_failed_with_its_incident():
    def scenario(env):
        promote(env, "src", "corrupt", {"step": 5, "checksum": "aaaa"}, {"step": 5, "checksum": "bbbb"})
        # LoadFailed self-heals into a fresh Pending while the pods stand, and
        # fails again within milliseconds: the watch sees it, a poll may not.
        # How many rounds a side made is timing, so what is compared is the
        # states in their order of first appearance, the events, the objects,
        # the incident and that at least one mismatch was counted
        wait_for(lambda: "load-failed" in env.sequences.of("corrupt")["annotation"], timeout=TIMEOUT,
                 msg="LoadFailed on the mismatch")
        wait_for(lambda: env.incidents("corrupt"), msg="the load-failed incident bundle")
        wait_for(lambda: env.has_event("corrupt", "LoadFailed"), msg="the LoadFailed event")
        after = env.counters()
        out = {"sequences": list(dict.fromkeys(env.sequences.of("corrupt")["annotation"])),
               "events": env.events("corrupt"), "objects": env.objects("corrupt"),
               "counters": {k: after[k] - env.before[k] for k in after}, "incidents": env.incidents("corrupt"),
               "healthy": env.mgr.healthz()}
        assert out["counters"]["verifications mismatch"] >= 1, out["counters"]
        out["counters"]["verifications mismatch"] = 1
        return out

    got = run_both(scenario)
    assert_same(got)
    port = got["port"]
    assert port["sequences"] == ["", "loading", "load-failed"]
    assert port["counters"]["verifications mismatch"] == 1 and port["counters"]["verifications ok"] == 0
    assert port["incidents"] == ["endpoint-load-failed"]
    assert any(r == "LoadFailed" and "saved aaaa != restored bbbb" in m for r, m in port["events"])


# ---------------------------------------------------------------------------
# drain -> terminate -> unstop
# ---------------------------------------------------------------------------


def test_drain_terminate_and_unstop():
    def scenario(env):
        env.endpoint("draino")
        wait_for(lambda: env.state("draino") == "serving", timeout=TIMEOUT, msg="cold endpoint Serving")
        served_on = env.pool_of(env.ep_pods("draino")[0].spec.node_name)
        env.patch("draino", {env.C.STOP_ANNOTATION: "2026-01-01T00:00:00Z"})
        wait_for(lambda: env.state("draino") == "terminated", timeout=TIMEOUT, msg="drained to Terminated")
        route_at_terminated = env.route("draino")
        wait_for(lambda: not env.ep_pods("draino"), msg="pods gone")
        wait_for(lambda: env.pool_states()[served_on][0] == "warm", msg="the drained slice released warm")
        # the parked endpoint's status follows its pods' going (a later write)
        wait_for(lambda: env.get("draino").status.ready_replicas == 0, msg="the Terminated status with no pod ready")
        stopped = env.settled("draino", ("EndpointDraining", "EndpointTerminated"), phase="Terminated")
        env.patch("draino", {env.C.STOP_ANNOTATION: None})
        wait_for(lambda: env.state("draino") == "serving", timeout=TIMEOUT, msg="unstopped back to Serving")
        out = env.settled("draino", phase="Serving")
        out.update(stopped=stopped, route_at_terminated=route_at_terminated is not None,
                   pools=sorted(env.pool_states().values()))
        return out

    got = run_both(scenario)
    assert_same(got)
    port = got["port"]
    assert port["stopped"]["sequences"]["annotation"] == ["", "loading", "serving", "draining", "terminated"]
    assert port["sequences"]["annotation"][-3:] == ["", "loading", "serving"]
    assert not port["route_at_terminated"] and port["stopped"]["objects"]["route"] is None
    assert port["stopped"]["status"]["phase"] == "Terminated"
    assert port["objects"]["route"] is not None and port["healthy"]


# ---------------------------------------------------------------------------
# the serving slice preempted: the endpoint machine recovers alone
# ---------------------------------------------------------------------------


def test_serving_slice_preemption_recovers_without_a_repair_fight():
    def scenario(env):
        env.endpoint("survivor")
        wait_for(lambda: env.state("survivor") == "serving", timeout=TIMEOUT, msg="endpoint Serving")
        nodes = sorted(p.spec.node_name for p in env.ep_pods("survivor") if p.spec.node_name)
        for node in nodes:
            env.cluster.preempt_node(node, grace_s=0.05)
        wait_for(lambda: env.state("survivor") != "serving", timeout=30, msg="Serving left after the preemption")
        for node in nodes:
            env.cluster.restore_node(node)
        wait_for(lambda: env.state("survivor") == "serving", timeout=60, msg="recovered to Serving")
        out = env.settled("survivor", ("EndpointDegraded",), phase="Serving")
        repair_states = [o.metadata.name for cls in (env.side.nb.Notebook, env.side.inference.InferenceEndpoint)
                         for o in env.client.list(cls, namespace=NS)
                         if env.C.TPU_REPAIR_STATE_ANNOTATION in o.metadata.annotations]
        repair_failed = [e.reason for e in env.client.list(env.side.core.Event, namespace=NS)
                         if e.reason == "RepairFailed"]
        out.update(repair_states=repair_states, repair_failed=repair_failed)
        return out

    got = run_both(scenario, repair=True)
    assert_same(got)
    port = got["port"]
    assert port["sequences"]["annotation"] == ["", "loading", "serving", "loading", "serving"]
    assert port["repair_states"] == [] and port["repair_failed"] == [] and port["healthy"]


# ---------------------------------------------------------------------------
# prewarm and claim
# ---------------------------------------------------------------------------


def test_prewarm_keeps_a_warm_slice_ahead_of_demand_and_a_claim_takes_it():
    def scenario(env):
        sp = env.side.slicepool
        warmer = sp.PoolPrewarmer(env.client, env.shape.gke_accelerator, env.shape.topology, target=1,
                                  period_s=0.2)
        first = warmer.tick()
        warm = sorted(env.pool_states().items())
        again = warmer.tick()
        entry = sp.SlicePool(env.client).claim(env.shape.gke_accelerator, env.shape.topology, f"{NS}/warm-claimer")
        claimed = sorted(env.pool_states().items())
        sp.SlicePool(env.client).unclaim(entry.pool)
        after = env.counters()
        return {"ticks": (first, again), "warm": warm, "claimed": claimed,
                "entry": (entry.pool, entry.state, entry.priority, entry.claimed_by, entry.nodes),
                "unclaimed": sorted(env.pool_states().items()),
                "counters": {k: after[k] - env.before[k] for k in after}}

    got = run_both(scenario)
    assert_same(got)
    port = got["port"]
    assert port["ticks"] == (1, 0) and port["counters"]["prewarmed"] == 1
    assert [state for _, (state, _, _) in port["warm"]] == ["warm", ""]
    assert port["entry"][:4] == ("pool-0", "warm", 0, "")
    assert port["claimed"][0][1] == ("claimed", "0", f"{NS}/warm-claimer")
    assert all(marks == ("", "", "") for _, marks in port["unclaimed"])


# ---------------------------------------------------------------------------
# the serving fleet: scale-down by the desired-replicas annotation
# ---------------------------------------------------------------------------


def test_fleet_of_two_scales_down_route_first_and_retires_to_the_pool():
    def scenario(env):
        env.endpoint("fleet", replicas=2, drain_s=1.0)
        # at strength: both gangs Serving, the status mirror at 2 ready
        # hosts, and the Serving event out, on either side alike
        wait_for(lambda: env.state("fleet") == "serving" and (st := env.get("fleet").status).serving_replicas == 2
                 and st.ready_replicas == 2 and st.tpu is not None and st.tpu.hosts_ready == 2,
                 timeout=TIMEOUT, msg="a fleet of 2 Serving")
        at_strength = env.settled("fleet", ("EndpointServing",), phase="Serving")
        victim_pool = env.pool_of(env.pods(env.C.INFERENCE_REPLICA_LABEL, "1")[0].spec.node_name)
        env.patch("fleet", {env.C.INFERENCE_DESIRED_REPLICAS_ANNOTATION: "1"})
        draining = wait_for(lambda: (st := env.get("fleet").status).draining_replicas and st.to_dict(),
                            timeout=TIMEOUT, msg="status.drainingReplicas")
        wait_for(lambda: env.has_event("fleet", "ReplicaRetired"), timeout=TIMEOUT, msg="the replica retired")
        wait_for(lambda: not env.pods(env.C.INFERENCE_REPLICA_LABEL, "1"), msg="the retired gang's pods gone")
        wait_for(lambda: len(env.objects("fleet")["sets"]) == 1, msg="the retired gang's set deleted")
        wait_for(lambda: env.get("fleet").status.serving_replicas == 1 and env.get("fleet").status.replicas == 1,
                 msg="the fleet at 1")
        out = env.settled("fleet", ("ReplicaDraining",), phase="Serving")
        for c in draining.get("conditions", []):
            c.pop("lastProbeTime", None)
            c.pop("lastTransitionTime", None)
        draining.get("tpu", {}).pop("accelerator", None)
        draining.get("tpu", {}).pop("topology", None)
        out.update(at_strength=at_strength, draining=draining, victim_pool=env.pool_states()[victim_pool])
        return out

    got = run_both(scenario)
    assert_same(got)
    port = got["port"]
    assert port["at_strength"]["status"]["servingReplicas"] == 2
    assert [s["metadata"]["name"] for s in port["at_strength"]["objects"]["sets"]] == ["fleet-serve", "fleet-serve-r1"]
    assert port["draining"]["drainingReplicas"] == [1] and port["draining"]["phase"] == "Serving"
    assert port["victim_pool"][0] == "warm", port["victim_pool"]
    assert [s["metadata"]["name"] for s in port["objects"]["sets"]] == ["fleet-serve"]
    assert {"ReplicaDraining", "ReplicaRetired"} <= {r for r, _ in port["events"]}


# ---------------------------------------------------------------------------
# scale-to-zero: the fleet parks with its route up, then cold-wakes
# ---------------------------------------------------------------------------


def test_scale_to_zero_parks_with_the_route_up_and_cold_wakes():
    def scenario(env):
        env.endpoint("nightly", autoscaling=dict(min_replicas=1, max_replicas=2, scale_to_zero=True))
        wait_for(lambda: env.state("nightly") == "serving", timeout=TIMEOUT, msg="endpoint Serving")
        env.patch("nightly", {env.C.INFERENCE_DESIRED_REPLICAS_ANNOTATION: "0"})
        wait_for(lambda: env.state("nightly") == "suspended", timeout=TIMEOUT, msg="parked Suspended")
        wait_for(lambda: not env.ep_pods("nightly"), msg="the parked fleet's pods gone")
        wait_for(lambda: env.get("nightly").status.ready_replicas == 0, msg="the parked status with no pod ready")
        parked = env.settled("nightly", ("EndpointSuspended",), phase="Suspended")
        parked["pools"] = sorted(env.pool_states().values())
        env.patch("nightly", {env.C.INFERENCE_DESIRED_REPLICAS_ANNOTATION: "1"})
        wait_for(lambda: env.state("nightly") == "serving", timeout=TIMEOUT, msg="cold-woken to Serving")
        out = env.settled("nightly", ("EndpointWaking", "SliceReclaimed"), phase="Serving")
        out.update(parked=parked, pools=sorted(env.pool_states().values()))
        return out

    got = run_both(scenario, slices=1, cfg=RECLAIMING)
    assert_same(got)
    port, parked = got["port"], got["port"]["parked"]
    assert parked["sequences"]["annotation"] == ["", "loading", "serving", "suspended"]
    assert parked["status"]["phase"] == "Suspended" and parked["status"]["url"] == f"/serving/{NS}/nightly"
    assert parked["objects"]["route"] is not None, "the parked endpoint's route went down"
    assert parked["pools"] == [("warm", "10", "")]
    # one slice: the woken gang waits past the grace, then takes the idle warm slice
    assert port["sequences"]["annotation"] == ["", "loading", "serving", "suspended", "", "loading", "serving"]
    assert port["counters"]["reclaims pool-idle"] == 1 and port["pools"] == [("", "", "")]


def test_the_fleet_view_goes_back_to_zero_after_a_retire_and_a_park():
    """The status mirror writes the fleet view as it is, 0 and [] included:
    after the retire of replica 1, drainingReplicas is [] again; after the
    park, replicas and servingReplicas are 0 (the router and the
    autoscaler read these). A merge patch of `status.to_dict()` alone
    leaves them at [1], 1 and 1: to_dict() leaves out zero and empty
    fields, and the store keeps what a merge patch leaves out."""
    def scenario(env):
        env.endpoint("fleet", replicas=2, drain_s=0.5,
                     autoscaling=dict(min_replicas=1, max_replicas=2, scale_to_zero=True))
        wait_for(lambda: env.state("fleet") == "serving" and env.get("fleet").status.serving_replicas == 2,
                 timeout=TIMEOUT, msg="a fleet of 2 Serving")
        env.patch("fleet", {env.C.INFERENCE_DESIRED_REPLICAS_ANNOTATION: "1"})
        wait_for(lambda: env.get("fleet").status.draining_replicas == [1], timeout=TIMEOUT,
                 msg="status.drainingReplicas [1]")
        wait_for(lambda: env.has_event("fleet", "ReplicaRetired"), timeout=TIMEOUT, msg="the replica retired")
        retired = wait_for(lambda: (st := env.get("fleet").status).draining_replicas == [] and st.replicas == 1
                           and st.serving_replicas == 1 and st, timeout=TIMEOUT,
                           msg="drainingReplicas [] after the retire")
        env.patch("fleet", {env.C.INFERENCE_DESIRED_REPLICAS_ANNOTATION: "0"})
        wait_for(lambda: env.state("fleet") == "suspended", timeout=TIMEOUT, msg="parked Suspended")
        parked = wait_for(lambda: (st := env.get("fleet").status).replicas == 0 and st.serving_replicas == 0
                          and st.ready_replicas == 0 and st, timeout=TIMEOUT,
                          msg="replicas and servingReplicas 0 after the park")
        out = env.settled("fleet", ("EndpointSuspended",), phase="Suspended")
        out.update(retired=(retired.replicas, retired.serving_replicas, retired.draining_replicas),
                   parked=(parked.replicas, parked.serving_replicas, parked.draining_replicas, parked.phase))
        return out

    got = run_both(scenario)
    assert_same(got)
    port = got["port"]
    assert port["retired"] == (1, 1, []) and port["parked"] == (0, 0, [], "Suspended"), port
    assert port["sequences"]["annotation"] == ["", "loading", "serving", "suspended"], port["sequences"]


def test_a_retired_gang_is_not_drained_again_from_a_stale_cache():
    """Right after a retire scaled replica 1's set to 0, the cache may still
    show it at 1: the JAX reconciler then counts a fleet of 2 against a
    desired 1 and drains replica 1 again (scaling it back up to do so); the
    port reads the sets fresh and counts 1."""
    from torch_sides import JAX, PORT

    got = {}
    for side in (JAX, PORT):
        store = side.cluster.Store()
        mgr = side.runtime.Manager(store)
        rec = side.ctrl.InferenceEndpointReconciler(mgr, side.ctrl.Config())
        ep = side.inference.InferenceEndpoint()
        ep.metadata.name, ep.metadata.namespace = "fleet", NS
        stale = []
        for replica, now in ((0, 1), (1, 0)):
            sts = side.apps.StatefulSet()
            sts.metadata.name, sts.metadata.namespace = f"fleet-serve-r{replica}", NS
            sts.metadata.labels = {side.C.INFERENCE_NAME_LABEL: "fleet", side.C.INFERENCE_REPLICA_LABEL: str(replica)}
            sts.spec.replicas = now
            mgr.api_reader.create(sts)
            old = side.apps.StatefulSet.from_dict(sts.to_dict())
            old.spec.replicas = 1  # as the cache still has it
            stale.append(old)
        cached_list = rec.client.list
        rec.client.list = lambda cls, **kw: stale if cls is side.apps.StatefulSet else cached_list(cls, **kw)
        got[side.name] = rec._observed_fleet(ep)
    assert got == {"jax": 2, "port": 1}, got
