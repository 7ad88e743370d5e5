"""The port's TPUJob reconciler (controllers/job.py), its API type and its
metric families against the JAX package's, on the CPU: every non-slow case
of tests/test_job.py run with one script through both SimClusters at once
(tests/torch_sides.py: JAX v5e 2x2 ~ port h100 1x4, one host of 4 chips),
but the three that need the oversubscription reclaimer
(`test_reclaim_preempts_job_and_it_survives`,
`test_checkpointing_job_never_victimized`, `test_job_mixed_bad_day_soak`),
which the port has not got yet.

As in the reference test, the workload's step counter lives at the
transport: every learner-gang /tpu/checkpoint ack advances it by
STEP_PER_CKPT and is remembered. The reference test suspends its
notebooks through SuspendResumeController; both sides here run
tests/torch_standin.py instead, which writes what a successful suspend
writes. For each scenario both sides give the same job-state values and
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
"""
import json
import re
import time

import torch_standin
import torch_threads
from torch_sides import JAX, PORT, Sequences, both, wait_for

torch_threads.cap()

NS = "batch"
STEP_PER_CKPT = 30
# the reference test's Config, without the suspend controller's knobs
FAST = dict(enable_culling=False, readiness_probe_period_s=0.15, reclaim_pending_grace_s=0.3,
            job_checkpoint_window_s=2.0, job_requeue_backoff_s=0.1)
TIMEOUT = 40.0
# metadata that names an identity or a time, not what was rendered
IDENTITY = ("uid", "resourceVersion", "creationTimestamp", "generation", "managedFields", "deletionTimestamp")
# span attributes that are times
TIMED = ("queue_wait_s", "productive_s")


class Env:
    """One side's cluster with the reference test's controllers but the
    suspend controller: the notebook reconciler, the readiness gate and the
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
        side.ctrl.TPUJobReconciler(self.mgr, self.config, http_get=self.http_get).setup()
        self.agents = {}
        self.cluster.add_pod_behavior(side.behavior(self.agents, duty=0.9))
        self.sequences = Sequences(self.cluster.store, self.C.JOB_STATE_ANNOTATION, self.C.JOB_QUEUED_CONDITION,
                                   kind="TPUJob")
        self.mgr.start()

    def http_get(self, url, timeout=10.0):
        """The reference test's transport: a learner gang's checkpoint acks
        the job's next step, a notebook's acks step 1 at once."""
        if "/tpu/checkpoint" in url and "-learner-" in url:
            name = url.split("//", 1)[1].split("-learner-", 1)[0]
            self.steps[name] = self.steps.get(name, 0) + STEP_PER_CKPT
            self.acked.setdefault(name, []).append(self.steps[name])
            return 200, json.dumps({"saved": True, "step": self.steps[name]}).encode()
        if "/tpu/checkpoint" in url:
            return 200, json.dumps({"saved": True, "step": 1, "checksum": "nb"}).encode()
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

    def stop_nb(self, name):
        """The reference's stop_nb through the stand-in suspend: the save's
        ack, the stop, the pods gone, the pool released warm, suspended."""
        ack = torch_standin.checkpoint(self.side, self.http_get, NS, name)
        torch_standin.suspend(self.side, self.client, NS, name, ack)

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
        wait_for(lambda: any(s == "warm" for s, _, _ in env.pool_entries()), msg="warm slice")
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
        ctrl = env.side.ctrl.TPUJobReconciler(env.mgr, env.config)
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
