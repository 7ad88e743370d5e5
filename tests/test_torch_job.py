"""The port's TPUJob reconciler (controllers/job.py), its API type and its
metric families against the JAX package's, on the CPU: every non-slow case
of tests/test_job.py run with one script through both SimClusters at once
(tests/torch_sides.py: JAX v5e 2x2 ~ port h100 1x4, one host of 4 chips),
the reclaimer's three among them.

As in the reference test, the workload's step counter lives at the
transport: every learner-gang /tpu/checkpoint ack advances it by
STEP_PER_CKPT and is remembered, and the notebooks are suspended through
SuspendResumeController (the culler's stamp: the stop and checkpointing in
one patch). For each scenario both sides give the same job-state values and
QueuedOverBudget values in the same order, the same events (reason and
message, with seconds masked), the same StatefulSets and headless Services
outside the device fields (the `nvidia.com/gpu` / `google.com/tpu`
resource, toleration, node selector and torchrun/JAX env), the same status
outside the accelerator's name and topology (and hostsReady, which the
mirror never writes back to 0), the same `tpu_job_*` counter
deltas, spans and incident reasons. Where a scenario's timing decides how
many cadence checkpoints land (a host lost mid-run, a runtime cap), the
states are compared in their order of first appearance and the steps are
masked. Identities (uids, resourceVersions, timestamps, trace ids) are not
compared.

Port-only: the cadence re-arms from the save's ack, not from the start of
the reconcile that waited for it (ROADMAP Queue 3 entry 15).
"""
import json
import re
import time

import torch_threads
from torch_sides import JAX, PORT, Sequences, both, wait_for

torch_threads.cap()

NS = "batch"
STEP_PER_CKPT = 30
# the reference test's Config
FAST = dict(enable_culling=False, suspend_enabled=True, readiness_probe_period_s=0.15,
            suspend_checkpoint_window_s=1.0, resume_timeout_s=20.0, reclaim_pending_grace_s=0.3,
            job_checkpoint_window_s=2.0, job_requeue_backoff_s=0.1)
TIMEOUT = 40.0
# metadata that names an identity or a time, not what was rendered
IDENTITY = ("uid", "resourceVersion", "creationTimestamp", "generation", "managedFields", "deletionTimestamp")
# span attributes that are times
TIMED = ("queue_wait_s", "productive_s")


class Env:
    """One side's cluster with the reference test's controllers: the
    notebook reconciler, the readiness gate, the suspend controller and the
    job reconciler, `slices` pools of the one-host slice and sim agents;
    `acked` is the transport's record of each job's acked steps."""

    def __init__(self, side, slices=2, cfg=FAST, start=True):
        self.side, self.C = side, side.C
        self.started = time.time()
        self.accelerator, self.topology = side.slices["one-host"]
        self.cluster = side.cluster.SimCluster().start()
        side.add_pool(self.cluster, "pool", self.accelerator, self.topology, slices=slices)
        self.client = self.cluster.client
        self.config = side.ctrl.Config(**cfg)
        self.steps, self.acked = {}, {}
        self.mgr = side.runtime.Manager(self.cluster.store)
        self.sequences = None
        self.before = self.counters()
        if not start:
            return
        side.ctrl.NotebookReconciler(self.mgr, self.config).setup()
        side.ctrl.ProbeStatusController(self.mgr, self.config, http_get=self.http_get).setup()
        side.ctrl.SuspendResumeController(self.mgr, self.config, http_get=self.http_get).setup()
        job_reconciler(side)(self.mgr, self.config, http_get=self.http_get).setup()
        self.agents = {}
        self.cluster.add_pod_behavior(side.behavior(self.agents, duty=0.9))
        self.sequences = Sequences(self.cluster.store, self.C.JOB_STATE_ANNOTATION, self.C.JOB_QUEUED_CONDITION,
                                   kind="TPUJob")
        self.mgr.start()

    def http_get(self, url, timeout=10.0):
        """The reference test's transport: a learner gang's checkpoint acks
        the job's next step, a notebook's (a churn notebook's suspend) acks
        step 1 at once."""
        if "/tpu/checkpoint" in url and "-learner-" in url:
            name = url.split("//", 1)[1].split("-learner-", 1)[0]
            self.steps[name] = self.steps.get(name, 0) + STEP_PER_CKPT
            self.acked.setdefault(name, []).append(self.steps[name])
            return 200, json.dumps({"saved": True, "step": self.steps[name]}).encode()
        if "/tpu/checkpoint" in url:
            return 200, json.dumps({"saved": True, "step": 1}).encode()
        return self.cluster.http_get(url, timeout=timeout)

    def stop(self):
        try:
            if self.sequences is not None:
                self.sequences.stop()
            self.mgr.stop()
        finally:
            self.cluster.stop()
            self.cluster.faults.clear()

    # -- objects --
    def job(self, name, steps=90, period=0.2, priority=0, layout=None, actors=False, backoff_limit=3,
            max_runtime_s=0.0):
        job = self.side.job.TPUJob()
        job.metadata.name, job.metadata.namespace = name, NS
        job.spec.template.spec.containers = [self.side.core.Container(name=name, image="jax:1")]
        job.spec.tpu = self.tpu(priority)
        job.spec.steps, job.spec.checkpoint_period_s = steps, period
        job.spec.backoff_limit, job.spec.max_runtime_s = backoff_limit, max_runtime_s
        if layout:
            job.spec.layout = layout
        if actors:
            job.spec.actors = self.tpu()
        return job

    def tpu(self, priority=0):
        return self.side.nb.TPUSpec(accelerator=self.accelerator, topology=self.topology, priority=priority)

    def notebook(self, name):
        nb = self.side.nb.Notebook()
        nb.metadata.name, nb.metadata.namespace = name, NS
        nb.spec.template.spec.containers = [self.side.core.Container(name=name, image="jax:1")]
        nb.spec.tpu = self.tpu()
        return self.client.create(nb)

    def patch(self, kind, name, annotations, attempts=40):
        """Scenario-driver writes land even while a seeded bad day throws
        409/429 at everything (the reference's patch_persistent)."""
        am = self.side.am
        for i in range(attempts):
            try:
                return self.client.patch(kind, NS, name, {"metadata": {"annotations": annotations}})
            except (am.ConflictError, am.TooManyRequestsError):
                if i == attempts - 1:
                    raise
                time.sleep(0.02)

    def stop_nb(self, name):
        """The culler's atomic stamp: the stop and checkpointing in one patch."""
        self.patch(self.side.nb.Notebook, name, {self.C.STOP_ANNOTATION: "2026-01-01T00:00:00Z",
                                                 self.C.TPU_SUSPEND_STATE_ANNOTATION: "checkpointing"})

    def nb(self, name):
        return self.client.get(self.side.nb.Notebook, NS, name)

    def nb_events(self, name):
        return sorted({(e.reason, re.sub(r"\d+\.\d+s", "<s>", e.message))
                       for e in self.client.list(self.side.core.Event, namespace=NS)
                       if e.involved_object.kind == "Notebook" and e.involved_object.name == name})

    def get(self, name):
        return self.client.get(self.side.job.TPUJob, NS, name)

    def state(self, name):
        return self.get(name).metadata.annotations.get(self.C.JOB_STATE_ANNOTATION, "")

    def ann(self, name, key):
        return int(self.get(name).metadata.annotations.get(key, "0") or 0)

    def pods(self, name):
        return [p for p in self.client.list(self.side.core.Pod, namespace=NS, labels={self.C.JOB_NAME_LABEL: name})
                if not p.metadata.deletion_timestamp]

    def ready_pods(self):
        return sum(1 for p in self.client.list(self.side.core.Pod, namespace=NS) if p.is_ready())

    def pool_entries(self):
        return [(e.state, e.priority, e.claimed_by) for e in self.side.slicepool.SlicePool(self.client).entries()]

    def events(self, name, mask_steps=False):
        out = set()
        for e in self.client.list(self.side.core.Event, namespace=NS):
            if e.involved_object.kind != "TPUJob" or e.involved_object.name != name:
                continue
            message = re.sub(r"\d+\.\d+s", "<s>", e.message)
            if mask_steps:
                message = re.sub(r"step \d+", "step <n>", message)
            out.add((e.reason, message))
        return sorted(out)

    def has_event(self, name, reason):
        return any(r == reason for r, _ in self.events(name))

    # -- what is compared --
    def counters(self):
        jm = self.side.jm
        out = {f"jobs {r}": jm.tpu_jobs_total.value(result=r) for r in ("succeeded", "failed")}
        out.update({f"preemptions {c}": jm.tpu_job_preemptions_total.value(cause=c)
                    for c in ("reclaim", "host-loss", "user", "bind-timeout")})
        out["requeues"] = jm.tpu_job_requeues_total.value()
        out.update({f"reclaims {r}": self.side.slicepool.notebook_reclaims_total.value(reason=r)
                    for r in ("suspend", "job-preempt", "endpoint-drain", "pool-idle")})
        return out

    def _plain(self, obj):
        d = obj.to_dict()
        meta = d["metadata"]
        for key in IDENTITY:
            meta.pop(key, None)
        for ref in meta.get("ownerReferences", []):
            ref.pop("uid", None)
        annotations = meta.get("annotations", {})
        annotations.pop(self.C.TRACEPARENT_ANNOTATION, None)
        annotations.pop("notebooks.opendatahub.io/gpu-slice-env", None)
        if not annotations:
            meta.pop("annotations", None)
        d.pop("status", None)
        return d

    def _without_device(self, sts, mask_steps):
        """A StatefulSet's JSON without its device fields (the resource, its
        toleration, the node selector's slice keys, the device env); only
        the workload contract's TPU_JOB_* env stays."""
        d = self._plain(sts)
        template = d["spec"]["template"]
        (template["metadata"].get("annotations") or {}).pop(self.C.TRACEPARENT_ANNOTATION, None)
        pod = template["spec"]
        for key in self.side.selector_keys:
            pod.get("nodeSelector", {}).pop(key, None)
        pod["tolerations"] = [t for t in pod.get("tolerations", []) if t["key"] != self.side.device_resource]
        for c in pod["containers"]:
            for kind in ("requests", "limits"):
                c.get("resources", {}).get(kind, {}).pop(self.side.device_resource, None)
            c["env"] = [e for e in c.get("env", []) if e["name"].startswith("TPU_JOB_")]
            if mask_steps:
                c["env"] = [dict(e, value="<n>") if e["name"] == "TPU_JOB_RESUME_STEP" else e for e in c["env"]]
        return d

    def objects(self, name, mask_steps=False):
        label = {self.C.JOB_NAME_LABEL: name}
        sets = [self._without_device(s, mask_steps)
                for s in self.client.list(self.side.apps.StatefulSet, namespace=NS, labels=label)]
        services = [self._plain(s) for s in self.client.list(self.side.core.Service, namespace=NS, labels=label)]
        return {"sets": sorted(sets, key=lambda d: d["metadata"]["name"]),
                "services": sorted(services, key=lambda d: d["metadata"]["name"])}

    def status(self, name, mask_steps=False):
        st = self.get(name).status.to_dict()
        for c in st.get("conditions", []):
            c.pop("lastProbeTime", None)
            c.pop("lastTransitionTime", None)
        for key in ("accelerator", "topology"):
            (st.get("tpu") or {}).pop(key, None)
        # the mirror is a merge patch of status.to_dict(), which omits zero
        # fields, so hostsReady never goes back to 0: after a teardown it
        # keeps whichever count the last mirror saw (the reference's too,
        # ROADMAP Queue 3 entry 13)
        (st.get("tpu") or {}).pop("hostsReady", None)
        if mask_steps:
            st.pop("completedSteps", None)
        return st

    def spans(self, name, mask_steps=False):
        out = []
        for s in self.side.tracing.recent_spans():
            attrs = s["attributes"]
            if not s["name"].startswith("job.") or attrs.get("job") != name or s["start_time"] < self.started:
                continue
            attrs = {k: v for k, v in attrs.items() if k not in TIMED}
            if mask_steps:
                attrs = {k: v for k, v in attrs.items() if k not in ("step", "resume_step")}
            out.append((s["start_time"], s["name"], tuple(sorted(attrs.items()))))
        out = [(n, a) for _, n, a in sorted(out)]
        return list(dict.fromkeys(out)) if mask_steps else out

    def incidents(self, name):
        return sorted({i["reason"] for i in self.side.recorder.incidents() if i["subject"] == f"{NS}/{name}"})

    def caught_up(self, name):
        job = self.get(name)
        c = next((c for c in job.status.conditions if c.type == self.C.JOB_QUEUED_CONDITION), None)
        return self.sequences.caught_up(name, job.metadata.annotations.get(self.C.JOB_STATE_ANNOTATION, ""),
                                        None if c is None else (c.status, c.reason))

    def settled(self, name, want_events=(), phase=None, mask_steps=False):
        """What is compared of a job once a scenario is done (with `phase`,
        once its status mirror shows it: the mirror follows the state's
        write). With `mask_steps`, the states in their order of first
        appearance, and no step numbers."""
        if phase is not None:
            wait_for(lambda: self.get(name).status.phase == phase, msg=f"{name}'s status in {phase}")
        if phase in ("Succeeded", "Failed"):
            # the mirror follows the pods' going (a later write)
            wait_for(lambda: not self.pods(name), msg=f"{name}'s pods gone")
            wait_for(lambda: self.get(name).status.ready_replicas == 0, msg=f"{name}'s status with no pod ready")
        wait_for(lambda: self.caught_up(name), msg=f"the watch to see {name} as it is")
        for reason in want_events:
            wait_for(lambda: self.has_event(name, reason), msg=f"{name}'s {reason} event")
        sequences = self.sequences.of(name)
        if mask_steps:
            sequences = {k: list(dict.fromkeys(v)) for k, v in sequences.items()}
        after = self.counters()
        return {"sequences": sequences, "events": self.events(name, mask_steps),
                "objects": self.objects(name, mask_steps), "status": self.status(name, mask_steps),
                "counters": {k: after[k] - self.before[k] for k in after}, "spans": self.spans(name, mask_steps),
                "incidents": self.incidents(name), "healthy": self.mgr.healthz()}


def job_reconciler(side):
    """The side's TPUJobReconciler, reading the pool and finding free
    slices from the store as the port's does. The JAX one reads its cache,
    which under load can still miss a notebook's bound pod (it parked and
    claimed that slice, and lost the claim to the notebook's suspend:
    test_a_jobs_free_slice_search_reads_the_store_not_a_stale_cache), or
    miss the warm mark of a slice it had just parked (the claim found
    nothing, the slice stayed warm, and a pending notebook had to reclaim
    it idle: ROADMAP Queue 3 entry 14), and runs its requeue backoff from
    the requeue, so a requeued job can take back the slice it was reclaimed
    from before the requester's pod binds (entry 19), which the JAX
    scheduler's cached nodes then let the requester's pod take as well. Both
    sides are compared with the port's repairs in place, so that the races
    do not decide the comparison."""
    if side.name == "port":
        return side.ctrl.TPUJobReconciler
    accelerator_label, topology_label = side.selector_keys
    marked = side.slicepool.POOL_STATE_ANNOTATION
    C = side.C

    class FreshFreePools(side.ctrl.TPUJobReconciler):
        def __init__(self, manager, *args, **kwargs):
            super().__init__(manager, *args, **kwargs)
            self.pool = side.slicepool.SlicePool(manager.api_reader)
            self._gang_gone_at = {}

        def _run_pending(self, job, gangs, now, req):
            backoff = self.config.job_requeue_backoff_s
            if backoff > 0 and int(job.metadata.annotations.get(C.JOB_PREEMPTIONS_ANNOTATION, "0") or 0):
                self._mirror_status(job, gangs, phase="Pending")
                if self.api_reader.list(side.core.Pod, namespace=job.metadata.namespace,
                                        labels={C.JOB_NAME_LABEL: job.metadata.name}):
                    self._gang_gone_at.pop(req.key, None)
                    return side.runtime.Result(requeue_after=0.05)
                gone = self._gang_gone_at.setdefault(req.key, now)
                if now - gone < backoff:
                    return side.runtime.Result(requeue_after=max(0.02, backoff - (now - gone)))
            return super()._run_pending(job, gangs, now, req)

        def _free_pools(self, gke_accelerator, topology):
            occupied = {p.spec.node_name for p in self.api_reader.list(side.core.Pod)
                        if p.spec.node_name and not p.metadata.deletion_timestamp}
            pools = {}
            for node in self.api_reader.list(side.core.Node):
                labels = node.metadata.labels
                if labels.get(accelerator_label) == gke_accelerator and labels.get(topology_label) == topology:
                    pools.setdefault(labels.get(side.pool_label, node.metadata.name), []).append(node)
            return {pool: [n.metadata.name for n in nodes] for pool, nodes in sorted(pools.items())
                    if all(n.metadata.name not in occupied and not n.metadata.annotations.get(marked)
                           and self.pool.node_healthy(n) for n in nodes)}

    return FreshFreePools


def run_both(scenario, **kw):
    return both(scenario, lambda side: Env(side, **kw), lambda env: env.stop())


def assert_same(got):
    jax, port = got["jax"], got["port"]
    assert jax.keys() == port.keys()
    for key in jax:
        assert jax[key] == port[key], (key, jax[key], port[key])


# ---------------------------------------------------------------------------
# admission + completion
# ---------------------------------------------------------------------------


def test_anakin_job_runs_to_succeeded():
    def scenario(env):
        env.client.create(env.job("rl-a", steps=90))
        wait_for(lambda: env.state("rl-a") == "running", timeout=TIMEOUT, msg="running")
        wait_for(lambda: env.get("rl-a").status.phase == "Succeeded", timeout=TIMEOUT, msg="succeeded")
        wait_for(lambda: not env.pods("rl-a"), msg="pods torn down")
        out = env.settled("rl-a", ("JobAdmitted", "JobRunning", "JobSucceeded"), phase="Succeeded")
        out.update(completed_acked=env.get("rl-a").status.completed_steps in env.acked["rl-a"],
                   replicas=env.client.get(env.side.apps.StatefulSet, NS, "rl-a-learner").spec.replicas)
        return out

    got = run_both(scenario)
    assert_same(got)
    port = got["port"]
    assert port["sequences"]["annotation"] == ["", "admitted", "running", "checkpointing", "running",
                                               "checkpointing", "running", "checkpointing", "succeeded"]
    assert port["status"]["phase"] == "Succeeded" and port["status"]["completedSteps"] == 90
    assert port["completed_acked"] and port["replicas"] == 0
    assert port["counters"]["jobs succeeded"] == 1 and port["counters"]["requeues"] == 0
    assert sorted(n for n, _ in port["spans"]) == ["job.admit", "job.checkpoint", "job.checkpoint",
                                                   "job.checkpoint", "job.ready", "job.run"]
    assert port["healthy"]


def test_sebulba_admission_is_atomic():
    def scenario(env):
        # nb1 occupies slice 1; its suspend releases slice 1 warm — ONE warm
        # slice in a 2-slice cluster whose other slice nb2 keeps occupied
        env.notebook("nb1")
        env.notebook("nb2")
        wait_for(lambda: env.ready_pods() >= 2, timeout=TIMEOUT, msg="notebooks up")
        env.stop_nb("nb1")
        wait_for(lambda: any(s == "warm" for s, _, _ in env.pool_entries()), timeout=TIMEOUT, msg="warm slice")
        env.client.create(env.job("sebulba", steps=60, layout=env.side.job.LAYOUT_SEBULBA, actors=True))
        # the actor gang has nowhere to go: admission must keep unwinding
        wait_for(lambda: env.caught_up("sebulba") and env.sequences.of("sebulba")["condition"],
                 msg="the job queued")
        time.sleep(1.5)
        # each admission pass claims the warm slice for a moment and gives
        # it back: read the pool between two passes (a leaked claim never
        # goes back, and the wait fails)
        pool = wait_for(lambda: (entries := env.pool_entries()) == [("warm", 0, "")] and entries,
                        msg="the warm slice unclaimed between admission passes")
        queued = {"state": env.state("sebulba"), "pods": len(env.pods("sebulba")), "pool": pool,
                  "status": env.status("sebulba")}
        env.client.delete(env.side.nb.Notebook, NS, "nb2")
        wait_for(lambda: env.state("sebulba") == "running", timeout=TIMEOUT, msg="sebulba running")
        gangs = sorted({p.metadata.labels.get(env.C.JOB_GANG_LABEL) for p in env.pods("sebulba")})
        wait_for(lambda: env.state("sebulba") == "succeeded", timeout=TIMEOUT, msg="sebulba succeeded")
        out = env.settled("sebulba", ("JobSucceeded",), phase="Succeeded")
        out.update(queued=queued, gangs=gangs)
        return out

    got = run_both(scenario)
    assert_same(got)
    port = got["port"]
    assert port["queued"]["state"] == "" and port["queued"]["pods"] == 0
    assert port["queued"]["pool"] == [("warm", 0, "")], "partial sebulba admission leaked a claim"
    assert port["sequences"]["condition"] == [("True", "WaitingForCapacity"), ("False", "Admitted")]
    assert port["gangs"] == ["actors", "learner"]
    assert [s["metadata"]["name"] for s in port["objects"]["sets"]] == ["sebulba-actors", "sebulba-learner"]


def test_warm_claim_fast_start():
    def scenario(env):
        env.notebook("nb")
        wait_for(lambda: env.ready_pods() >= 1, timeout=TIMEOUT, msg="notebook up")
        env.stop_nb("nb")
        wait_for(lambda: any(s == "warm" for s, _, _ in env.pool_entries()), msg="warm slice")
        env.client.create(env.job("rl-w", steps=60))
        wait_for(lambda: env.state("rl-w") == "running", timeout=TIMEOUT, msg="running off the warm claim")
        wait_for(lambda: env.state("rl-w") == "succeeded", timeout=TIMEOUT, msg="succeeded")
        return env.settled("rl-w", ("JobAdmitted", "JobSucceeded"), phase="Succeeded")

    got = run_both(scenario, slices=1)
    assert_same(got)
    port = got["port"]
    assert ("JobAdmitted", "admitted: 1 gang(s) secured (warm claim: learner); resuming from step 0") \
        in port["events"]
    assert port["sequences"]["annotation"][-1] == "succeeded"


def test_over_budget_job_queues_with_condition():
    def scenario(env):
        env.notebook("nb")
        wait_for(lambda: env.ready_pods() >= 1, timeout=TIMEOUT, msg="notebook up")
        env.client.create(env.job("rl-q", steps=60))
        wait_for(lambda: env.has_event("rl-q", "JobQueuedOverBudget"), timeout=TIMEOUT, msg="queued event")
        out = env.settled("rl-q", ("JobQueuedOverBudget",))
        nb = env.client.get(env.side.nb.Notebook, NS, "nb")
        out.update(state=env.state("rl-q"), pods=len(env.pods("rl-q")),
                   nb_suspend=nb.metadata.annotations.get(env.C.TPU_SUSPEND_STATE_ANNOTATION))
        return out

    got = run_both(scenario, cfg=dict(FAST, chip_budget=4))
    assert_same(got)
    port = got["port"]
    assert port["state"] == "" and port["pods"] == 0 and port["nb_suspend"] is None
    assert port["sequences"]["condition"] == [("True", "ChipBudget")]
    assert port["objects"] == {"sets": [], "services": []}


def test_free_slice_admission_reserves_through_the_pool():
    def scenario(env):
        ctrl = job_reconciler(env.side)(env.mgr, env.config)
        job_gangs = env.side.ctrl.job.job_gangs
        a, b = env.job("race-a"), env.job("race-b")
        ok_a, claims_a = ctrl._secure_gangs(a, job_gangs(a), f"{NS}/race-a")
        first = env.pool_entries()
        ok_b, claims_b = ctrl._secure_gangs(b, job_gangs(b), f"{NS}/race-b")
        second = env.pool_entries()
        ok_a2, claims_a2 = ctrl._secure_gangs(a, job_gangs(a), f"{NS}/race-a")
        return {"a": (ok_a, claims_a), "first": first, "b": (ok_b, claims_b), "second": second,
                "again": (ok_a2, claims_a2 == claims_a)}

    got = both(scenario, lambda side: Env(side, slices=1, start=False), lambda env: env.stop())
    assert_same(got)
    port = got["port"]
    assert port["a"] == (True, {"learner": "pool"})
    assert port["first"] == [("claimed", 0, f"{NS}/race-a")]
    assert port["b"] == (False, {}) and port["second"] == port["first"]
    assert port["again"] == (True, True)


# ---------------------------------------------------------------------------
# checkpoint-preempt-requeue
# ---------------------------------------------------------------------------


def test_host_preemption_mid_running_survival():
    def scenario(env):
        env.client.create(env.job("rl-h", steps=300))
        wait_for(lambda: env.state("rl-h") == "running", timeout=TIMEOUT, msg="running")
        wait_for(lambda: env.acked.get("rl-h"), timeout=TIMEOUT, msg="first checkpoint banked")
        victim = env.pods("rl-h")[0].spec.node_name
        env.cluster.preempt_node(victim, grace_s=0.1)
        wait_for(lambda: env.ann("rl-h", env.C.JOB_PREEMPTIONS_ANNOTATION) >= 1, timeout=TIMEOUT,
                 msg="preempted + requeued")
        wait_for(lambda: env.state("rl-h") == "succeeded", timeout=60, msg="job survived host preemption")
        out = env.settled("rl-h", ("JobPreempted", "JobRequeued", "JobSucceeded"), phase="Succeeded",
                          mask_steps=True)
        job = env.get("rl-h")
        resume = int(job.metadata.annotations.get(env.C.JOB_RESUME_STEP_ANNOTATION, "0") or 0)
        out.update(resume_acked=resume in env.acked["rl-h"], completed=job.status.completed_steps)
        env.cluster.restore_node(victim)
        return out

    got = run_both(scenario)
    assert_same(got)
    port = got["port"]
    assert port["resume_acked"] and port["completed"] == 300
    assert port["status"]["preemptions"] == 1 and port["status"]["failures"] >= 1
    assert port["counters"]["preemptions host-loss"] == 1 and port["counters"]["requeues"] == 1
    assert port["sequences"]["annotation"] == ["", "admitted", "running", "checkpointing", "preempted",
                                               "succeeded"]


def test_preempted_slice_parks_warm_at_job_priority():
    def scenario(env):
        env.client.create(env.job("rl-park", steps=300, priority=-5))
        wait_for(lambda: env.state("rl-park") == "running", timeout=TIMEOUT, msg="running")
        env.client.patch(env.side.job.TPUJob, NS, "rl-park",
                         {"metadata": {"annotations": {env.C.JOB_PREEMPT_ANNOTATION: "user"}}})
        # the long requeue backoff holds the requeued job in Pending, its
        # slice parked warm, until the scenario has read it
        wait_for(lambda: env.state("rl-park") == "" and env.ann("rl-park", env.C.JOB_PREEMPTIONS_ANNOTATION) == 1,
                 timeout=TIMEOUT, msg="parked and requeued")
        wait_for(lambda: any(s == "warm" for s, _, _ in env.pool_entries()), msg="slice released warm")
        wait_for(lambda: not env.pods("rl-park"), msg="the preempted gang's pods gone")
        wait_for(lambda: env.get("rl-park").status.phase == "Pending", msg="the requeued status")
        for reason in ("JobPreempted", "JobRequeued"):
            wait_for(lambda: env.has_event("rl-park", reason), msg=f"the {reason} event")
        wait_for(lambda: env.caught_up("rl-park"), msg="the watch to see rl-park as it is")
        after = env.counters()
        return {"pool": env.pool_entries(), "events": env.events("rl-park", mask_steps=True),
                "sequences": {k: list(dict.fromkeys(v)) for k, v in env.sequences.of("rl-park").items()},
                "counters": {k: after[k] - env.before[k] for k in after}, "pods": len(env.pods("rl-park"))}

    got = run_both(scenario, slices=1, cfg=dict(FAST, job_requeue_backoff_s=30.0))
    assert_same(got)
    port = got["port"]
    assert port["pool"] == [("warm", -5, "")], "the preempted job's slice parked at another priority"
    assert port["counters"]["preemptions user"] == 1 and port["counters"]["requeues"] == 1
    assert port["sequences"]["annotation"] == ["", "admitted", "running", "checkpointing", "preempted"]
    assert port["pods"] == 0


def test_reclaim_preempts_job_and_it_survives():
    """The three-class contention story on one slice: a default-priority
    batch job loses its slice to an arriving interactive notebook through
    checkpoint-before-preempt, requeues, warm-claims the slice back when the
    notebook suspends, resumes from a step its workload acked, and
    completes."""
    def scenario(env):
        env.client.create(env.job("rl-p", steps=300))
        wait_for(lambda: env.state("rl-p") == "running", timeout=TIMEOUT, msg="running")
        # 4 + 4 cards inside budget 8, no free capacity: the reclaimer takes the batch slice
        env.notebook("user")
        wait_for(lambda: env.ann("rl-p", env.C.JOB_PREEMPTIONS_ANNOTATION) >= 1, timeout=TIMEOUT,
                 msg="job preempted and requeued")
        wait_for(lambda: (nb := env.nb("user")).status.tpu is not None and nb.status.tpu.mesh_ready,
                 timeout=TIMEOUT, msg="notebook on the reclaimed slice")
        env.stop_nb("user")
        wait_for(lambda: env.state("rl-p") == "succeeded", timeout=60, msg="job survived the preemption")
        out = env.settled("rl-p", ("JobPreempted", "JobRequeued", "JobSucceeded"), phase="Succeeded",
                          mask_steps=True)
        for reason in ("SliceReclaimed", "NotebookSuspended"):
            wait_for(lambda: any(r == reason for r, _ in env.nb_events("user")), msg=f"user's {reason} event")
        job = env.get("rl-p")
        resume = int(job.metadata.annotations.get(env.C.JOB_RESUME_STEP_ANNOTATION, "0") or 0)
        out.update(resume_acked=resume in env.acked["rl-p"], nb_events=env.nb_events("user"),
                   nb_state=env.nb("user").metadata.annotations.get(env.C.TPU_SUSPEND_STATE_ANNOTATION))
        return out

    got = run_both(scenario, slices=1, cfg=dict(FAST, chip_budget=8))
    assert_same(got)
    port = got["port"]
    assert port["resume_acked"], "resumed from a step the workload never acked"
    assert port["status"]["preemptions"] >= 1 and port["status"].get("failures", 0) == 0, \
        "a reclaim-driven preemption must not charge backoffLimit"
    assert port["counters"]["preemptions reclaim"] == 1 and port["counters"]["reclaims job-preempt"] == 1
    assert port["counters"]["preemptions user"] == 0 and port["nb_state"] == "suspended"
    assert ("SliceReclaimed", f"preempting batch job {NS}/rl-p (priority -10) to free capacity for {NS}/user "
            "(priority 0); the job checkpoints before its slice moves and requeues to resume from the saved step") \
        in port["nb_events"]


def test_checkpointing_job_never_victimized():
    """The reclaimer never stamps a preempt onto a job mid-Checkpointing:
    its save is what makes the preemption survivable."""
    def scenario(env):
        suspend = env.side.ctrl.SuspendResumeController(env.mgr, env.config)

        def park(name, *states):
            # walk the machine legally: Pending -> Admitted -> Running (-> Checkpointing)
            env.client.create(env.job(name))
            for state in states:
                env.client.patch(env.side.job.TPUJob, NS, name,
                                 {"metadata": {"annotations": {env.C.JOB_STATE_ANNOTATION: state}}})

        def victim():
            nb = env.side.nb.Notebook()
            nb.metadata.name, nb.metadata.namespace = "user", NS
            nb.spec.tpu = env.tpu()
            got = suspend._pick_job_victim(nb, env.side.plan_slice(env.accelerator, env.topology))
            return None if got is None else got.metadata.name

        park("mid-window", "admitted", "running", "checkpointing")
        alone = victim()
        park("fair-game", "admitted", "running")
        return {"mid-window alone": alone, "with a running one": victim()}

    got = both(scenario, lambda side: Env(side, slices=1, start=False), lambda env: env.stop())
    assert_same(got)
    assert got["port"] == {"mid-window alone": None, "with a running one": "fair-game"}


# ---------------------------------------------------------------------------
# port-only: a requeued job's backoff runs from its gang's last pod gone
# ---------------------------------------------------------------------------


def slow_stops(behavior, stop_s):
    """`behavior` with a job pod's stop taking `stop_s` before its object
    goes (the kubelet's graceful deletion of a pod of processes)."""
    from odh_kubeflow_tpu_torch.cluster.kubelet import PodDecision

    def wrapped(pod):
        decision = behavior(pod)
        if decision is None or PORT.C.JOB_NAME_LABEL not in pod.metadata.labels:
            return decision

        def serve(p):
            host, port, close = decision.serve(p)

            def slow():
                time.sleep(stop_s)
                close()

            return host, port, slow

        return PodDecision(ready_after=decision.ready_after, serve=serve, graceful=True)

    return wrapped


def test_a_job_reclaimed_for_a_notebook_does_not_take_its_slice_back_while_its_pod_stops():
    """The reclaim story with the job's pod taking 2 s to stop, as a pod of
    processes does: the requeued job holds its backoff until that pod is
    gone, so the notebook's pending pod binds on the freed slice first and
    the reclaimer preempts the job once. With the backoff run from the
    requeue (the reference's), the job parked the slice it was still
    leaving and claimed it back, the notebook stayed pending, and the
    reclaimer preempted the job again."""
    env = Env(PORT, slices=1, cfg=dict(FAST, chip_budget=8), start=False)
    try:
        side = env.side
        side.ctrl.NotebookReconciler(env.mgr, env.config).setup()
        side.ctrl.ProbeStatusController(env.mgr, env.config, http_get=env.http_get).setup()
        side.ctrl.SuspendResumeController(env.mgr, env.config, http_get=env.http_get).setup()
        job_reconciler(side)(env.mgr, env.config, http_get=env.http_get).setup()
        env.cluster.add_pod_behavior(slow_stops(side.behavior({}, duty=0.9), 2.0))
        env.mgr.start()
        env.client.create(env.job("rl-s", steps=3000))
        wait_for(lambda: env.state("rl-s") == "running", timeout=TIMEOUT, msg="running")
        env.notebook("user")
        wait_for(lambda: (nb := env.nb("user")).status.tpu is not None and nb.status.tpu.mesh_ready,
                 timeout=TIMEOUT, msg="the notebook on the reclaimed slice")
        time.sleep(1.0)
        after = env.counters()
    finally:
        env.stop()
    assert after["reclaims job-preempt"] - env.before["reclaims job-preempt"] == 1, (env.before, after)
    assert after["preemptions reclaim"] - env.before["preemptions reclaim"] == 1, (env.before, after)


# ---------------------------------------------------------------------------
# port-only: the cadence re-arms from the ack (ROADMAP Queue 3 entry 15)
# ---------------------------------------------------------------------------


HELD_S, PERIOD_S = 1.0, 1.5


def test_the_cadence_rearms_one_period_after_a_held_ack():
    """A learner whose save takes HELD_S (the transport holds each
    checkpoint ack, as a card's 2-3.5 s save does): the next cadence window
    opens one period after the ack, not one period after the start of the
    reconcile that waited for it. With the re-arm at that reconcile's `now`
    (the reference's), the next save was asked for PERIOD_S - HELD_S after
    the ack."""
    asked, acked = [], []

    class Held(Env):
        def http_get(self, url, timeout=10.0):
            if "/tpu/checkpoint" in url and "-learner-" in url:
                asked.append(time.time())
                time.sleep(HELD_S)
                out = super().http_get(url, timeout)
                acked.append(time.time())
                return out
            return super().http_get(url, timeout)

    env = Held(PORT)
    try:
        env.client.create(env.job("rl-held", steps=150, period=PERIOD_S))
        wait_for(lambda: len(asked) >= 3, timeout=TIMEOUT, msg="three cadence saves asked")
    finally:
        env.stop()
    gaps = [nxt - ack for ack, nxt in zip(acked, asked[1:])]
    assert all(g >= PERIOD_S - 0.05 for g in gaps[:2]), gaps


# ---------------------------------------------------------------------------
# failure semantics
# ---------------------------------------------------------------------------


def test_max_runtime_fails_with_incident():
    def scenario(env):
        env.client.create(env.job("rl-f", steps=100000, max_runtime_s=2.0))
        wait_for(lambda: env.get("rl-f").status.phase == "Failed", timeout=TIMEOUT, msg="failed on maxRuntime")
        wait_for(lambda: env.incidents("rl-f"), msg="Failed must leave an incident bundle")
        wait_for(lambda: not env.pods("rl-f"), msg="pods torn down")
        return env.settled("rl-f", ("JobFailed",), phase="Failed", mask_steps=True)

    got = run_both(scenario)
    assert_same(got)
    port = got["port"]
    assert port["sequences"]["annotation"][-1] == "failed"
    assert port["counters"]["jobs failed"] == 1 and port["incidents"] == ["job-failed"]
    assert ("JobFailed", "maxRuntime (2s since first admission) exceeded") in port["events"]


# ---------------------------------------------------------------------------
# the shared claim-owner table
# ---------------------------------------------------------------------------


def test_pod_claim_owner_table():
    got = {}
    for side in (JAX, PORT):
        C, sched = side.C, side.scheduler
        owners = []
        for label, owner in ((C.NOTEBOOK_NAME_LABEL, "nb"), (C.INFERENCE_NAME_LABEL, "ep"),
                             (C.JOB_NAME_LABEL, "rl")):
            pod = side.core.Pod()
            pod.metadata.namespace = "ns"
            pod.metadata.labels[label] = owner
            owners.append((sched.pod_claim_owner(pod), sched.Scheduler._pod_owner(pod)))
        bare = side.core.Pod()
        bare.metadata.namespace = "ns"
        got[side.name] = {"labels": sched.claim_owner_labels(), "owners": owners, "bare": sched.pod_claim_owner(bare)}
    assert got["jax"] == got["port"]
    assert got["port"]["owners"] == [("ns/nb", "ns/nb"), ("ns/ep", "ns/ep"), ("ns/rl", "ns/rl")]
    assert got["port"]["bare"] == ""


# ---------------------------------------------------------------------------
# the rendered gang on a GPU slice
# ---------------------------------------------------------------------------


def test_the_gangs_pod_carries_the_gpu_resource_toleration_and_slice_shape():
    """The port renders the gang's GPU fields through `gpu.apply_slice`: the
    card resource in requests and limits, its toleration, and the pool's
    slice shape in the node selector (a one-host gang never lands on a
    multi-host pool's node); the workload contract's env is the reference's."""
    from odh_kubeflow_tpu_torch.gpu import GKE_GPU_ACCELERATOR_LABEL, GPU_RESOURCE, GPU_TOPOLOGY_LABEL

    env = Env(PORT, start=False)
    try:
        rec = PORT.ctrl.TPUJobReconciler(env.mgr, env.config)
        job = env.job("rl-r", steps=64)
        job.metadata.annotations[PORT.C.JOB_RESUME_STEP_ANNOTATION] = "30"
        (gang, shape), = PORT.ctrl.job.job_gangs(job)
        pod = rec.generate_statefulset(job, gang, shape, shape.hosts).spec.template.spec
    finally:
        env.stop()
    (c,) = pod.containers
    assert c.resources.requests[GPU_RESOURCE] == c.resources.limits[GPU_RESOURCE] == "4"
    assert any(t.key == GPU_RESOURCE and t.effect == "NoSchedule" for t in pod.tolerations)
    assert pod.node_selector == {GKE_GPU_ACCELERATOR_LABEL: shape.gke_accelerator, GPU_TOPOLOGY_LABEL: "1x4"}
    env_vars = {e.name: e.value for e in c.env}
    assert {k: env_vars[k] for k in ("TPU_JOB_GANG", "TPU_JOB_STEPS", "TPU_JOB_RESUME_STEP")} == {
        "TPU_JOB_GANG": "learner", "TPU_JOB_STEPS": "64", "TPU_JOB_RESUME_STEP": "30"}
    assert env_vars["PET_NPROC_PER_NODE"] == "4"


# ---------------------------------------------------------------------------
# the seeded mixed bad day: nothing silently stuck
# ---------------------------------------------------------------------------


def test_job_mixed_bad_day_soak():
    """Jobs, notebook churn, a control-plane bad day (the same seeded
    schedule on each side) and a host preemption mid-Running in one 3-slice
    cluster: every job ends Succeeded, none stuck in Admitted or Preempted,
    and every survived preemption resumed from an acked step (or from
    scratch, before any save was banked). The injected faults land on each
    side's own timing, so what is compared is that end state."""
    def scenario(env):
        C, jobs = env.C, ["soak-0", "soak-1"]
        for name in jobs:
            env.client.create(env.job(name, steps=240))
        env.notebook("churn")
        wait_for(lambda: all(env.state(n) == "running" for n in jobs), timeout=TIMEOUT, msg="jobs running")
        env.side.faults.seeded_bad_day(env.cluster.faults, seed=1007)
        wait_for(lambda: env.acked.get(jobs[0]), timeout=TIMEOUT, msg="first checkpoint banked before the preemption")
        victim = env.pods(jobs[0])[0].spec.node_name
        env.cluster.preempt_node(victim, grace_s=0.1)
        wait_for(lambda: env.ann(jobs[0], C.JOB_PREEMPTIONS_ANNOTATION) >= 1, timeout=TIMEOUT,
                 msg="soak victim preempted", retry=(env.side.am.TooManyRequestsError,))
        env.cluster.restore_node(victim)
        suspends = 0
        for _ in range(2):
            wait_for(lambda: (nb := env.nb("churn")).status.tpu is not None and nb.status.tpu.mesh_ready
                     and not nb.metadata.annotations.get(C.TPU_SUSPEND_STATE_ANNOTATION), timeout=TIMEOUT,
                     msg="churn notebook ready", retry=(env.side.am.TooManyRequestsError,))
            env.stop_nb("churn")
            wait_for(lambda: env.nb("churn").metadata.annotations.get(C.TPU_SUSPEND_STATE_ANNOTATION) == "suspended",
                     timeout=TIMEOUT, msg="churn notebook suspended", retry=(env.side.am.TooManyRequestsError,))
            suspends += 1
            env.patch(env.side.nb.Notebook, "churn", {C.STOP_ANNOTATION: None})
        wait_for(lambda: all(env.state(n) == "succeeded" for n in jobs), timeout=90,
                 msg="all jobs succeeded through the bad day", retry=(env.side.am.TooManyRequestsError,))
        resumed = {}
        for name in jobs:
            ann = env.get(name).metadata.annotations
            if int(ann.get(C.JOB_PREEMPTIONS_ANNOTATION, "0") or 0):
                step = int(ann.get(C.JOB_RESUME_STEP_ANNOTATION, "0") or 0)
                resumed[name] = step == 0 or step in env.acked.get(name, [])
        env.cluster.faults.clear()
        return {"states": {n: env.state(n) for n in jobs}, "resumed from an acked step": resumed,
                "churn suspends": suspends, "healthy": env.mgr.healthz()}

    got = run_both(scenario, slices=3)
    assert got["jax"]["states"] == got["port"]["states"] == {"soak-0": "succeeded", "soak-1": "succeeded"}
    port = got["port"]
    assert port["resumed from an acked step"].get("soak-0") is True and all(port["resumed from an acked step"].values())
    assert port["churn suspends"] == 2 and port["healthy"]


def test_a_jobs_free_slice_search_reads_the_store_not_a_stale_cache():
    """The port's free-slice search (`TPUJobReconciler._free_pools`) reads
    pods and nodes from the store: with a cache that has not yet seen a
    notebook's pod bound on the one slice, the slice is not free (the
    reference, reading its cache, parked and claimed it under the pod)."""
    import copy
    from types import SimpleNamespace

    env = Env(PORT, slices=2, start=False)
    try:
        core, shape = PORT.core, PORT.plan_slice(env.accelerator, env.topology)
        stale = {p.metadata.name: copy.deepcopy(p) for p in env.client.list(core.Pod)}

        class StalePods:
            """A client whose Pod reads predate the pod's bind."""

            def list(self, cls, **kw):
                return list(stale.values()) if cls is core.Pod else env.client.list(cls, **kw)

            def __getattr__(self, name):
                return getattr(env.client, name)

        pod = core.Pod()
        pod.metadata.name, pod.metadata.namespace = "user-0", NS
        pod.metadata.labels[PORT.C.NOTEBOOK_NAME_LABEL] = "user"
        pod.spec.node_name = sorted(n.metadata.name for n in env.client.list(core.Node))[0]
        pod.spec.containers = [core.Container(name="user", image="jax:1")]
        env.client.create(pod)
        rec = PORT.ctrl.TPUJobReconciler(SimpleNamespace(client=StalePods(), api_reader=env.client), env.config)
        free = rec._free_pools(shape.gke_accelerator, shape.topology)
    finally:
        env.stop()
    assert sorted(free) == ["pool-1"], free
