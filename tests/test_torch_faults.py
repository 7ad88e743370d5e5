"""The port's fault injector (cluster/faults.py) against the JAX package's,
on the CPU.

First the plans: the same seed gives the same draws, the same rule firings
and the same seeded schedules (seeded_bad_day, seeded_slice_bad_day,
seeded_pool_bad_day, seeded_router_bad_day, apiserver_overload) on both
sides. Then every case of tests/test_faults.py whose controllers the port
has, each run through both SimClusters at once (tests/torch_sides.py: the
JAX side on v5e 2x2 slices, the port on h100 1x4) and compared on its end
state: watch drops, the 410 relist, a conflict storm, 429 throttling, a
webhook outage under both failure policies, a kubelet crash-restart, the
closed agent's port-0 sentinel, a probe partition tripping the culler's
breaker, the fenced ex-leader and the seeded bad day.
"""
import threading
import time
from types import SimpleNamespace

import pytest

import torch_threads
from torch_sides import JAX, PORT, both, wait_for

torch_threads.cap()

NS = "chaos"
FAST = dict(enable_culling=True, cull_idle_time_min=1.5 / 60.0, idleness_check_period_min=0.1 / 60.0,
            readiness_probe_period_s=0.15, probe_breaker_threshold=2, probe_breaker_cooldown_s=0.3)
PROBES = ({"verb": "create"}, {"verb": "update"}, {"verb": "get"}, {"method": "POST"}, {"method": "GET"})


# ---------------------------------------------------------------------------
# the plans: same seed, same faults
# ---------------------------------------------------------------------------


def describe(rule):
    """A rule as data: its fields, the error it raises and what its
    predicate says of a few contexts."""
    err = rule.error() if rule.error is not None else None
    return {"site": rule.site, "kind": rule.kind, "name": rule.name, "times": rule.times, "action": rule.action,
            "param": rule.param, "fired": rule.fired,
            "error": None if err is None else (type(err).__name__, str(err), getattr(err, "retry_after", None)),
            "match": None if rule.match is None else [rule.match(ctx) for ctx in PROBES]}


class FakeCluster:
    """What the seeded schedules call on a cluster, recorded."""

    def __init__(self, side):
        self.faults = side.faults.FaultInjector()
        self.calls = []

    def preempt_node(self, name, grace_s=0.5):
        self.calls.append(("preempt", name, grace_s))

    def fail_node(self, name):
        self.calls.append(("fail", name))


def test_same_seed_same_draws_and_firings():
    def run(side):
        inj = side.faults.FaultInjector(seed=7)
        inj.crash_pod("a-0", restarts=2)
        inj.add(side.faults.FaultRule(site="apiserver.request", action="delay", param=0.01, times=3))
        inj.conflict_storm("Notebook", times=2)
        inj.partition_probe(host="dark", times=1)
        decided = [getattr(inj.decide(site, **ctx), "action", None) for site, ctx in (
            ("kubelet.pod", {"name": "a-0"}), ("kubelet.pod", {"name": "b-0"}), ("kubelet.pod", {"name": "a-0"}),
            ("kubelet.pod", {"name": "a-0"}), ("apiserver.request", {"method": "GET"}))]
        raised = []
        for site, ctx in (("store.write", {"kind": "Notebook", "verb": "update"}),
                          ("store.write", {"kind": "Notebook", "verb": "create"}),
                          ("store.write", {"kind": "Notebook", "verb": "update"}),
                          ("store.write", {"kind": "Notebook", "verb": "update"}),
                          ("probe.http", {"host": "dark-0.dark", "url": "http://dark-0.dark/x"}),
                          ("probe.http", {"host": "dark-0.dark", "url": "http://dark-0.dark/x"})):
            try:
                inj.check(site, **ctx)
                raised.append(None)
            except Exception as e:  # the injected error is the result
                raised.append(type(e).__name__)
        return {"draws": [inj.rng.random() for _ in range(5)], "decided": decided, "raised": raised,
                "rules": [describe(r) for r in inj.rules()], "exhausted": [r.exhausted for r in inj.rules()]}

    jax, port = run(JAX), run(PORT)
    assert jax == port
    assert port["decided"] == ["crash", None, "crash", None, "delay"]
    assert port["raised"] == ["ConflictError", None, "ConflictError", None, "ConnectionError", None]


@pytest.mark.parametrize("seed", [0, 1, 0xBAD_DA4, 101, 202, 303])
def test_seeded_schedules_are_the_same_plans(seed):
    pods = {f"nb-{i}-{h}": f"node-{i}-{h}" for i in range(3) for h in range(2)}
    replicas = {0: ["r0-w0", "r0-w1"], 1: ["r1-w0", "r1-w1"], 2: ["r2-w0"]}

    def run(side):
        out = {}
        inj = side.faults.FaultInjector()
        out["bad day"] = [describe(r) for r in side.faults.seeded_bad_day(inj, seed=seed)]
        inj = side.faults.FaultInjector()
        out["overload"] = [describe(r) for r in side.faults.apiserver_overload(inj, seed=seed, scale=2.0)]
        cluster = FakeCluster(side)
        agents = {p: SimpleNamespace(monitor=SimpleNamespace(chips=4, ici_fault=False)) for p in pods}
        plan = side.faults.seeded_slice_bad_day(cluster, seed=seed, pod_nodes=pods, agents=agents, grace_s=0.4)
        out["slice bad day"] = (plan, cluster.calls, {p: (a.monitor.chips, a.monitor.ici_fault)
                                                      for p, a in agents.items()},
                                [describe(r) for r in cluster.faults.rules()])
        cluster = FakeCluster(side)
        plan = side.faults.seeded_pool_bad_day(cluster, seed=seed, warm_nodes=sorted(pods.values()))
        out["pool bad day"] = (plan, cluster.calls, [describe(r) for r in cluster.faults.rules()])
        cluster = FakeCluster(side)
        plan = side.faults.seeded_router_bad_day(cluster, seed=seed, replica_nodes=replicas)
        out["router bad day"] = (plan, cluster.calls, [describe(r) for r in cluster.faults.rules()])
        return out

    jax, port = run(JAX), run(PORT)
    for key in jax:
        assert jax[key] == port[key], key
    assert port["slice bad day"][0]["preempted"]


# ---------------------------------------------------------------------------
# the cases of tests/test_faults.py, on both sides
# ---------------------------------------------------------------------------


class Env:
    """One side's cluster as tests/test_faults.py builds it: eight one-host
    slices, a CPU node, the reconciler, the culler and the readiness gate,
    agents with idle devices and busy kernels."""

    def __init__(self, side):
        self.side, self.C = side, side.C
        self.cluster = side.cluster.SimCluster().start()
        accelerator, topology = side.slices["one-host"]
        side.add_pool(self.cluster, "pool", accelerator, topology, slices=8)
        self.cluster.add_cpu_pool("cpu", nodes=1)
        self.mgr = side.runtime.Manager(self.cluster.store)
        config = side.ctrl.Config(**FAST)
        side.ctrl.NotebookReconciler(self.mgr, config).setup()
        self.culler = side.ctrl.CullingReconciler(self.mgr, config, http_get=self.cluster.http_get)
        self.culler.setup()
        side.ctrl.ProbeStatusController(self.mgr, config, http_get=self.cluster.http_get).setup()
        self.agents = {}
        self.cluster.add_pod_behavior(side.behavior(self.agents, duty=0.0, kernels_busy=True, chips=4))
        self.mgr.start()
        self.client = self.cluster.client
        self.retry = (side.am.NotFoundError, side.am.TooManyRequestsError, side.am.ConflictError)
        self.series = {
            "watch_restarts": lambda: side.rm.watch_restarts_total.value(kind="Notebook"),
            "relists": lambda: side.rm.relists_total.value(kind="Notebook"),
            "retries": lambda: side.rm.client_retries_total.value(cause="throttle"),
            "webhook_ignore": lambda: side.rm.webhook_dispatch_failures_total.value(policy="Ignore"),
            "webhook_fail": lambda: side.rm.webhook_dispatch_failures_total.value(policy="Fail"),
            "breaker_trips": lambda: side.breaker.breaker_trips_total.value(),
            "fenced_writes": lambda: side.rm.fenced_writes_total.value(),
        }
        self.start = {k: fn() for k, fn in self.series.items()}

    def stop(self):
        try:
            self.mgr.stop()
        finally:
            self.cluster.stop()
            self.cluster.faults.clear()

    def moved(self, key):
        return self.series[key]() - self.start[key] > 0

    def notebook(self, name, tpu=False):
        nb = self.side.nb.Notebook()
        nb.metadata.name, nb.metadata.namespace = name, NS
        nb.spec.template.spec.containers = [self.side.core.Container(name=name, image="img:1")]
        if tpu:
            accelerator, topology = self.side.slices["one-host"]
            nb.spec.tpu = self.side.nb.TPUSpec(accelerator=accelerator, topology=topology)
        return self.client.create(nb)

    def get(self, name):
        return self.client.get(self.side.nb.Notebook, NS, name)

    def wait(self, fn, msg, timeout=20):
        return wait_for(fn, timeout=timeout, msg=msg, retry=self.retry)

    def ready(self, name):
        return self.wait(lambda: self.get(name).status.ready_replicas >= 1, f"{name} ready")

    def mesh_ready(self, name):
        return self.wait(lambda: self.get(name).status.tpu is not None and self.get(name).status.tpu.mesh_ready,
                         f"{name} mesh ready")

    def culled(self, name, timeout=20):
        return self.wait(lambda: self.C.STOP_ANNOTATION in self.get(name).metadata.annotations,
                         f"{name} culled", timeout=timeout)

    def set_idle(self, pod):
        self.wait(lambda: pod in self.agents, f"{pod}'s agent")
        self.agents[pod].kernels.set_idle(time.time() - 3600)


def run_both(scenario):
    return both(scenario, Env, lambda env: env.stop())


def assert_same(got, want):
    assert got["jax"] == got["port"] == want, got


def test_fault_free_path_keeps_counters_flat():
    def scenario(env):
        env.notebook("calm", tpu=True)
        env.mesh_ready("calm")
        return {"moved": sorted(k for k in env.series if env.moved(k)), "healthy": env.mgr.healthz()}

    assert_same(run_both(scenario), {"moved": [], "healthy": True})


def test_watch_drops_recover_and_converge():
    def scenario(env):
        env.notebook("dropper", tpu=True)
        for _ in range(4):
            env.cluster.faults.drop_watches()
            time.sleep(0.15)
        out = {"ready": env.ready("dropper"), "mesh ready": env.mesh_ready("dropper"),
               "restarts logged": env.moved("watch_restarts")}
        env.notebook("after-drop")
        out.update({"post-drop create": env.ready("after-drop"), "healthy": env.mgr.healthz()})
        return out

    assert_same(run_both(scenario), {"ready": True, "mesh ready": True, "restarts logged": True,
                                     "post-drop create": True, "healthy": True})


def test_410_relist_diffs_cache_and_converges():
    def scenario(env):
        env.notebook("keeper")
        env.notebook("goner")
        env.ready("keeper")
        env.ready("goner")
        env.cluster.faults.expire_watch(kind="Notebook", times=1)
        env.cluster.faults.drop_watches(kind="Notebook")
        env.client.delete(env.side.nb.Notebook, NS, "goner")
        inf = env.mgr.informers.peek("kubeflow.org/v1beta1", "Notebook")
        env.wait(lambda: inf.get(NS, "goner") is None, "cache drops goner")
        out = {"keeper cached": inf.get(NS, "keeper") is not None, "relisted": env.moved("relists"),
               "synced": inf.synced.is_set()}
        env.notebook("reborn")
        out.update({"post-relist create": env.ready("reborn"), "healthy": env.mgr.healthz()})
        return out

    assert_same(run_both(scenario), {"keeper cached": True, "relisted": True, "synced": True,
                                     "post-relist create": True, "healthy": True})


def test_conflict_storm_converges_and_culls():
    def scenario(env):
        rule = env.cluster.faults.conflict_storm("Notebook", times=8)
        env.notebook("stormy")
        out = {"ready": env.ready("stormy"), "storm hit": rule.fired > 0}
        env.set_idle("stormy-0")
        out.update({"culled": env.culled("stormy"), "healthy": env.mgr.healthz()})
        return out

    assert_same(run_both(scenario), {"ready": True, "storm hit": True, "culled": True, "healthy": True})


def test_429_throttle_is_honored_and_converges():
    def scenario(env):
        env.cluster.faults.throttle(times=6, retry_after=0.02, match=lambda ctx: ctx.get("verb") != "create")
        env.notebook("throttled", tpu=True)
        return {"ready": env.ready("throttled"), "mesh ready": env.mesh_ready("throttled"),
                "retried": env.moved("retries"), "healthy": env.mgr.healthz()}

    assert_same(run_both(scenario), {"ready": True, "mesh ready": True, "retried": True, "healthy": True})


def test_webhook_outage_respects_failure_policy():
    def webhook_config(store, name, policy):
        store.create_raw({
            "apiVersion": "admissionregistration.k8s.io/v1", "kind": "MutatingWebhookConfiguration",
            "metadata": {"name": name},
            "webhooks": [{"name": f"{name}.kubeflow.org", "failurePolicy": policy,
                          "clientConfig": {"url": "http://127.0.0.1:9/mutate"},  # a dead port
                          "rules": [{"operations": ["CREATE", "UPDATE"], "apiGroups": ["kubeflow.org"],
                                     "apiVersions": ["*"], "resources": ["notebooks"]}]}],
        })

    def run(side):
        from importlib import import_module

        store_mod = import_module(side.cluster.__name__ + ".store")
        dispatch_mod = import_module(side.cluster.__name__ + ".webhook_dispatch")
        ignore0 = side.rm.webhook_dispatch_failures_total.value(policy="Ignore")
        fail0 = side.rm.webhook_dispatch_failures_total.value(policy="Fail")
        inj = side.faults.FaultInjector()
        store = store_mod.Store(faults=inj)
        disp = dispatch_mod.WebhookDispatcher(store)
        nb = {"apiVersion": "kubeflow.org/v1", "kind": "Notebook", "metadata": {"name": "n", "namespace": NS}}
        out = {}
        webhook_config(store, "ignore-hook", "Ignore")
        inj.webhook_outage(times=1, mode="timeout")
        out["ignore passes"] = disp("CREATE", dict(nb), None)["metadata"]["name"]
        out["ignore counted"] = side.rm.webhook_dispatch_failures_total.value(policy="Ignore") - ignore0
        store.delete_raw("admissionregistration.k8s.io/v1", "MutatingWebhookConfiguration", "", "ignore-hook")
        webhook_config(store, "fail-hook", "Fail")
        inj.webhook_outage(times=1, mode="error")
        for what in ("injected", "real"):
            try:
                disp("CREATE", dict(nb), None)
                out[f"fail on {what}"] = "admitted"
            except side.am.AdmissionDeniedError:
                out[f"fail on {what}"] = "denied"
        out["fail counted"] = side.rm.webhook_dispatch_failures_total.value(policy="Fail") - fail0
        return out

    jax, port = run(JAX), run(PORT)
    assert jax == port == {"ignore passes": "n", "ignore counted": 1, "fail on injected": "denied",
                           "fail on real": "denied", "fail counted": 2}, (jax, port)


def test_kubelet_crash_restart_recovers():
    def scenario(env):
        Pod = env.side.core.Pod
        env.notebook("phoenix", tpu=True)
        env.ready("phoenix")
        old_agent = env.agents.get("phoenix-0")
        env.cluster.faults.crash_pod("phoenix-0", restarts=2)
        env.client.patch(Pod, NS, "phoenix-0", {"metadata": {"annotations": {"chaos": "1"}}})
        return {
            "restart counted": env.wait(lambda: any(s.restart_count >= 1 for s in env.client.get(
                Pod, NS, "phoenix-0").status.container_statuses), "restartCount bumped"),
            "pod recovered": env.wait(lambda: env.client.get(Pod, NS, "phoenix-0").is_ready(), "pod recovered"),
            "fresh agent": env.wait(lambda: env.agents.get("phoenix-0") is not old_agent, "fresh agent"),
            "ready": env.ready("phoenix"), "mesh ready": env.mesh_ready("phoenix"), "healthy": env.mgr.healthz()}

    assert_same(run_both(scenario), {"restart counted": True, "pod recovered": True, "fresh agent": True,
                                     "ready": True, "mesh ready": True, "healthy": True})


def test_closed_agent_serves_port_zero_sentinel():
    from odh_kubeflow_tpu.probe.agent import NotebookAgent as JaxAgent, SimTPUMonitor as JaxMonitor
    from odh_kubeflow_tpu_torch.probe.agent import NotebookAgent, SimTPUMonitor

    ports = {}
    for name, agent in (("jax", JaxAgent(monitor=JaxMonitor())), ("port", NotebookAgent(monitor=SimTPUMonitor()))):
        _, port, _ = agent.serve()
        agent.close()
        ports[name] = (port > 0, agent.serve()[1])
    assert ports["jax"] == ports["port"] == (True, 0)


def test_probe_partition_trips_breaker_then_culling_resumes():
    def scenario(env):
        env.notebook("dark")
        env.ready("dark")
        env.wait(lambda: "dark-0" in env.agents, "agent up")
        rule = env.cluster.faults.partition_probe(host="dark")
        env.set_idle("dark-0")
        out = {"breaker open": env.wait(lambda: env.culler.breaker.is_open(f"{NS}/dark"), "breaker opens"),
               "tripped": env.moved("breaker_trips"),
               "culled while dark": env.C.STOP_ANNOTATION in env.get("dark").metadata.annotations}
        env.cluster.faults.remove(rule)
        out.update({"culled after heal": env.culled("dark", timeout=30), "healthy": env.mgr.healthz()})
        return out

    assert_same(run_both(scenario), {"breaker open": True, "tripped": True, "culled while dark": False,
                                     "culled after heal": True, "healthy": True})


def test_partitioned_ex_leader_is_fenced():
    def scenario(env):
        side, store = env.side, env.cluster.store
        managers = [side.runtime.Manager(store, leader_election=True, leader_election_id="fence-test")
                    for _ in range(2)]
        for m in managers:
            m.elector.lease_duration = 1.0
            m.elector.renew_period = 0.15
        a, b = managers
        out = {}
        try:
            a.start(wait_for_leadership_timeout=5)
            out["a leads"] = a.elector.is_leader.is_set()
            starting = threading.Thread(target=lambda: b.start(wait_for_leadership_timeout=30), daemon=True)
            starting.start()
            time.sleep(0.3)
            out["b waits"] = not b.elector.is_leader.is_set()
            a_id = a.elector.identity
            env.cluster.faults.add(side.faults.FaultRule(
                site="store.write", kind="Lease", error=lambda: ConnectionError("injected apiserver partition"),
                match=lambda ctx: (ctx.get("obj") or {}).get("spec", {}).get("holderIdentity") == a_id))
            out["a stands down"] = env.wait(lambda: not a.elector.is_leader.is_set(), "A stands down")
            try:
                nb = side.nb.Notebook()
                nb.metadata.name, nb.metadata.namespace = "from-the-dead", NS
                nb.spec.template.spec.containers = [side.core.Container(name="x", image="img:1")]
                a.client.create(nb)
                out["fenced"] = "written"
            except side.am.ForbiddenError:
                out["fenced"] = "forbidden"
            out["fence counted"] = env.moved("fenced_writes")
            try:
                env.get("from-the-dead")
                out["stored"] = True
            except side.am.NotFoundError:
                out["stored"] = False
            out["b takes over"] = env.wait(lambda: b.elector.is_leader.is_set(), "B leads")
            starting.join(timeout=10)
        finally:
            env.cluster.faults.clear()
            a.stop()
            b.stop()
        return out

    assert_same(run_both(scenario), {"a leads": True, "b waits": True, "a stands down": True, "fenced": "forbidden",
                                     "fence counted": True, "stored": False, "b takes over": True})


def test_seeded_bad_day_converges():
    def scenario(env):
        notebooks = (("bd-0", False), ("bd-1", True), ("bd-2", False))
        rules = env.side.faults.seeded_bad_day(env.cluster.faults, seed=0xBAD_DA4)
        for name, tpu in notebooks:
            env.notebook(name, tpu=tpu)
        for _ in range(3):
            env.cluster.faults.drop_watches()
            time.sleep(0.2)
        out = {}
        for name, tpu in notebooks:
            out[f"{name} ready"] = wait_for(lambda n=name: env.get(n).status.ready_replicas >= 1, timeout=30,
                                            retry=env.retry, msg=f"{name} ready through the bad day")
            if tpu:
                out[f"{name} mesh ready"] = wait_for(
                    lambda n=name: env.get(n).status.tpu is not None and env.get(n).status.tpu.mesh_ready,
                    timeout=30, retry=env.retry, msg=f"{name} mesh ready")
        env.set_idle("bd-0-0")
        out.update({"culled": env.culled("bd-0", timeout=30), "restarts logged": env.moved("watch_restarts"),
                    "storm fired": any(r.site == "store.write" and r.fired > 0 for r in env.cluster.faults.rules()),
                    "plan": [describe(r)["site"] for r in rules], "healthy": env.mgr.healthz()})
        return out

    got = run_both(scenario)
    assert got["jax"] == got["port"], got
    assert all(v for k, v in got["port"].items() if k != "plan"), got["port"]


@pytest.mark.parametrize("seed", [0, 5, 303])
def test_the_overload_rules_fire_at_the_apiserver_request_site(seed):
    """`apiserver_overload`'s two HTTP rules fire at `ApiServer`'s
    `apiserver.request` site on both packages: its POST 429 bursts answer
    creates sent raw over the wire (no client retry) until their budget is
    spent, and its delay rule slows the first requests, by the same counts
    on both sides."""
    import json
    import urllib.request

    def run(side):
        store = side.cluster.Store()
        server = side.cluster.ApiServer(store).start()
        try:
            store.faults = side.faults.FaultInjector()
            rules = side.faults.apiserver_overload(store.faults, seed=seed)
            codes = []
            for i in range(20):
                body = json.dumps({"apiVersion": "v1", "kind": "ConfigMap",
                                   "metadata": {"name": f"cm-{i}", "namespace": NS}}).encode()
                req = urllib.request.Request(f"{server.base_url}/api/v1/namespaces/{NS}/configmaps", data=body,
                                             method="POST", headers={"Content-Type": "application/json"})
                try:
                    with urllib.request.urlopen(req, timeout=10) as r:
                        codes.append(r.status)
                except urllib.error.HTTPError as e:
                    codes.append((e.code, json.loads(e.read())["reason"]))
            stored = sorted(o["metadata"]["name"] for o in store.peek_raw("v1", "ConfigMap"))
            return codes, [(r.site, r.action, r.fired) for r in rules if r.site == "apiserver.request"], stored
        finally:
            server.stop()

    jax, port = run(JAX), run(PORT)
    assert port == jax
    codes, fired, stored = port
    bursts = sum(1 for c in codes if c == (429, "TooManyRequests"))
    assert bursts and codes[:bursts] == [(429, "TooManyRequests")] * bursts and set(codes[bursts:]) == {201}
    assert all(n > 0 for _, _, n in fired) and len(stored) == 20 - bursts
