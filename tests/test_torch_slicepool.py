"""The port's warm slice pool (cluster/slicepool.py) against the JAX
package's, operation by operation, on the CPU: each side's store holds the
same pools (an unstarted SimCluster's nodes: tests/torch_sides.py's slice
pairs, JAX v5e 2x2 ~ port h100 1x4 and v5p 2x2x2 ~ h100 2x4), the same
verbs run on both, and every verb's return value and every node's pool
annotations are compared (the pool-since time only as present or absent;
an entry's accelerator and topology as its side's own shape). Also
`endpoint_desired_replicas` over tests/test_autoscaler.py's input cases.
"""
import copy
import threading
from types import SimpleNamespace

import pytest

import torch_threads
from torch_sides import JAX, PORT, SIDES

torch_threads.cap()

NS = "pools"


class Pools:
    """One side's store: `slices` one-host pools `one-<i>` and two two-host
    pools `multi-<i>`, nothing running."""

    def __init__(self, side, slices=3):
        self.side, self.sp = side, side.slicepool
        self.cluster = side.cluster.SimCluster()
        self.one = side.plan_slice(*side.slices["one-host"])
        self.multi = side.plan_slice(*side.slices["multi-host"])
        side.add_pool(self.cluster, "one", *side.slices["one-host"], slices=slices)
        side.add_pool(self.cluster, "multi", *side.slices["multi-host"], slices=2)
        self.client = self.cluster.client
        self.pool = self.sp.SlicePool(self.client)

    def nodes(self, pool):
        return sorted(n.metadata.name for n in self.client.list(self.side.core.Node)
                      if n.metadata.labels[self.side.pool_label] == pool)

    def marks(self):
        """node -> its pool annotations, the since time as present or not."""
        sp, out = self.sp, {}
        for n in self.client.list(self.side.core.Node):
            ann = n.metadata.annotations
            out[n.metadata.name] = (ann.get(sp.POOL_STATE_ANNOTATION), ann.get(sp.POOL_PRIORITY_ANNOTATION),
                                    ann.get(sp.POOL_CLAIMED_BY_ANNOTATION), sp.POOL_SINCE_ANNOTATION in ann)
        return out

    def entry(self, e):
        """An entry without its time; its shape checked against this side's."""
        if e is None:
            return None
        shape = self.multi if e.pool.startswith("multi") else self.one
        assert (e.accelerator, e.topology) == (shape.gke_accelerator, shape.topology), e
        assert e.since, e
        return (e.pool, e.state, e.priority, e.claimed_by, e.nodes)

    def entries(self, include_unhealthy=False):
        return [self.entry(e) for e in self.pool.entries(include_unhealthy=include_unhealthy)]

    def counters(self):
        sp = self.sp
        return {"hits": sp.slice_pool_hits_total.value(), "misses": sp.slice_pool_misses_total.value(),
                "pool-idle": sp.notebook_reclaims_total.value(reason="pool-idle"),
                "poisoned": sp.notebook_reclaims_total.value(reason="poisoned"),
                "prewarmed": sp.slice_pool_prewarmed_total.value()}

    def taint(self, node):
        n = self.client.get(self.side.core.Node, "", node)
        n.spec.setdefault("taints", []).append(
            {"key": self.side.faults.PREEMPTION_TAINT_KEY, "value": "preempt", "effect": "NoSchedule"})
        self.client.update(n)


def on_both(script):
    """Runs script(pools) on each side's store, one after the other (no
    controller runs, so nothing races), and returns {side: its steps}."""
    out = {}
    for side in SIDES:
        pools = Pools(side)
        before = pools.counters()
        steps = script(pools)
        after = pools.counters()
        out[side.name] = {"steps": steps, "counters": {k: after[k] - before[k] for k in after}}
    return out


def assert_same(got):
    jax, port = got["jax"], got["port"]
    assert len(jax["steps"]) == len(port["steps"])
    for i, (j, p) in enumerate(zip(jax["steps"], port["steps"])):
        assert j == p, (i, j, p)
    assert jax["counters"] == port["counters"]


def test_release_claim_unclaim():
    def script(p):
        steps = [("entries", p.entries())]
        steps.append(("release", p.pool.release("one-0", p.nodes("one-0"), priority=3), p.marks(), p.entries()))
        steps.append(("claim a miss of another shape",
                      p.entry(p.pool.claim(p.multi.gke_accelerator, p.multi.topology, f"{NS}/a"))))
        steps.append(("claim", p.entry(p.pool.claim(p.one.gke_accelerator, p.one.topology, f"{NS}/a")), p.marks()))
        steps.append(("claim again: nothing warm",
                      p.entry(p.pool.claim(p.one.gke_accelerator, p.one.topology, f"{NS}/b"))))
        steps.append(("entries", p.entries()))
        p.pool.unclaim("one-0")
        steps.append(("unclaimed", p.marks(), p.entries()))
        steps.append(("release a gone node", p.pool.release("ghost", ["ghost-w0"], priority=1), p.marks()))
        steps.append(("release a two-host pool", p.pool.release("multi-1", p.nodes("multi-1"), priority=2),
                      p.marks(), p.entries()))
        steps.append(("claim it", p.entry(p.pool.claim(p.multi.gke_accelerator, p.multi.topology, f"{NS}/m")),
                      p.marks()))
        return steps

    got = on_both(script)
    assert_same(got)
    steps = got["port"]["steps"]
    assert steps[0][1] == [] and steps[1][1] is True
    assert steps[3][1] == ("one-0", "warm", 3, "", ["one-0-w0"])
    assert steps[3][2]["one-0-w0"] == ("claimed", "3", f"{NS}/a", True)
    assert steps[4][1] is None and steps[7][1] is False
    assert steps[9][1] == ("multi-1", "warm", 2, "", ["multi-1-w0", "multi-1-w1"])


def test_claim_race_has_one_winner():
    """Two claimants at once for the one warm slice: one wins, the other
    gets None. Then the CAS itself: a claimant whose read of the lead node
    is stale (another claim lands between its read and its write) gets
    Conflict, re-reads a non-warm node and moves on (None)."""
    def script(p):
        p.pool.release("one-1", p.nodes("one-1"), priority=0)
        barrier, results = threading.Barrier(2), {}

        def claim(key):
            barrier.wait()
            results[key] = p.entry(p.pool.claim(p.one.gke_accelerator, p.one.topology, key))

        threads = [threading.Thread(target=claim, args=(f"{NS}/{k}",)) for k in ("x", "y")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        winners = sorted(k for k, e in results.items() if e is not None)
        (lead,) = p.nodes("one-1")
        owner = p.marks()[lead][2]
        steps = [("race", len(winners), owner in winners, sorted(e is None for e in results.values()))]

        p.pool.unclaim("one-1")
        p.pool.release("one-1", p.nodes("one-1"), priority=0)
        real, conflicts = p.client, []

        class Interleaved:
            """The client, but the first update of the lead node lands after
            a rival's claim."""

            def __getattr__(self, name):
                return getattr(real, name)

            def update(self, obj):
                if not conflicts:
                    conflicts.append(p.entry(p.sp.SlicePool(real).claim(
                        p.one.gke_accelerator, p.one.topology, f"{NS}/rival")))
                    try:
                        return real.update(obj)
                    except p.side.am.ConflictError as e:
                        conflicts.append(type(e).__name__)
                        raise
                return real.update(obj)

        loser = p.sp.SlicePool(Interleaved()).claim(p.one.gke_accelerator, p.one.topology, f"{NS}/loser")
        steps.append(("stale read", p.entry(loser), conflicts, p.marks()[lead]))
        return steps

    got = on_both(script)
    assert_same(got)
    race, stale = got["port"]["steps"]
    assert race == ("race", 1, True, [False, True])
    assert stale[1] is None and stale[2] == [("one-1", "warm", 0, "", ["one-1-w0"]), "ConflictError"]
    assert stale[3][:3] == ("claimed", "0", f"{NS}/rival")


def test_reclaim_idle_takes_the_lowest_priority_then_the_oldest():
    def script(p):
        for pool, priority in (("one-1", 1), ("one-0", 5), ("one-2", 1)):
            p.pool.release(pool, p.nodes(pool), priority=priority)
        steps = []
        for _ in range(4):
            victim = p.pool.reclaim_idle(p.one.gke_accelerator, p.one.topology)
            steps.append(("reclaim", p.entry(victim), p.marks()))
        steps.append(("other shape", p.entry(p.pool.reclaim_idle(p.multi.gke_accelerator, p.multi.topology))))
        return steps

    got = on_both(script)
    assert_same(got)
    steps = got["port"]["steps"]
    assert [s[1] and s[1][0] for s in steps[:4]] == ["one-1", "one-2", "one-0", None]
    assert got["port"]["counters"]["pool-idle"] == 3


def test_sweep_drops_a_preempted_slice_and_a_half_marked_pool():
    def script(p):
        p.pool.release("multi-0", p.nodes("multi-0"), priority=2)
        p.pool.release("one-0", p.nodes("one-0"), priority=0)
        steps = [("entries", p.entries())]
        p.taint(p.nodes("multi-0")[1])
        steps.append(("poisoned", p.entries(), p.entries(include_unhealthy=True)))
        steps.append(("sweep", p.pool.sweep(), p.marks(), p.entries()))
        # a half-marked pool: one node of multi-1 carries a mark
        lead = p.nodes("multi-1")[0]
        p.pool._stamp(lead, {p.sp.POOL_STATE_ANNOTATION: p.sp.POOL_STATE_WARM})
        steps.append(("half-marked", p.entries(), p.pool.sweep(), p.marks()))
        steps.append(("nothing left to sweep", p.pool.sweep()))
        return steps

    got = on_both(script)
    assert_same(got)
    steps = got["port"]["steps"]
    assert [e[0] for e in steps[0][1]] == ["multi-0", "one-0"]
    assert [e[0] for e in steps[1][1]] == ["one-0"] and len(steps[1][2]) == 2
    assert steps[2][1] == 1 and [e[0] for e in steps[2][3]] == ["one-0"]
    assert steps[3][1] == [e for e in steps[2][3]] and steps[3][2] == 1 and steps[4][1] == 0
    assert got["port"]["counters"]["poisoned"] == 1


def test_prewarm_parks_free_healthy_slices_and_the_prewarmer_holds_its_target():
    def script(p):
        pod = p.side.core.Pod()
        pod.metadata.name, pod.metadata.namespace = "busy-0", NS
        pod.spec.node_name = p.nodes("one-0")[0]
        pod.spec.containers = [p.side.core.Container(name="busy", image="img")]
        p.client.create(pod)
        p.taint(p.nodes("one-2")[0])
        steps = [("prewarm", p.pool.prewarm(p.one.gke_accelerator, p.one.topology, 2), p.marks())]
        steps.append(("at target", p.pool.prewarm(p.one.gke_accelerator, p.one.topology, 1)))
        warmer = p.sp.PoolPrewarmer(p.client, p.multi.gke_accelerator, p.multi.topology, target=1, period_s=0.2)
        steps.append(("tick", warmer.tick(), warmer.tick(), p.marks(), p.entries()))
        p.pool.refresh_gauges()
        # by accelerator: both port shapes are H100 cards, the JAX ones v5e
        # and v5p, so the warm slices' total is compared
        size = {labels.get("accelerator"): v for labels, v in p.sp.slice_pool_size.series()}
        accelerators = {p.one.gke_accelerator, p.multi.gke_accelerator}
        steps.append(("gauge", sum(size.get(a, 0) for a in accelerators)))
        return steps

    got = on_both(script)
    assert_same(got)
    steps = got["port"]["steps"]
    assert steps[0][1] == 1 and steps[0][2]["one-1-w0"][0] == "warm" and steps[0][2]["one-0-w0"][0] is None
    assert steps[0][2]["one-2-w0"][0] is None, "a tainted slice was parked warm"
    assert steps[1][1] == 0 and steps[2][1:3] == (1, 0)
    assert steps[3][1] == 2 and got["port"]["counters"]["prewarmed"] == 2


@pytest.mark.parametrize("case", [
    dict(),
    dict(replicas=3),
    dict(replicas=0),
    dict(annotation="2"),
    dict(annotation="junk", replicas=2),
    dict(annotation="0"),
    dict(annotation="7", autoscaling=dict(min_replicas=1, max_replicas=3)),
    dict(annotation="0", autoscaling=dict(min_replicas=2, max_replicas=4)),
    dict(annotation="0", autoscaling=dict(min_replicas=1, max_replicas=4, scale_to_zero=True)),
    dict(annotation="-3", autoscaling=dict(min_replicas=1, max_replicas=4, scale_to_zero=True)),
    dict(annotation="3", autoscaling=dict(min_replicas=1, max_replicas=3)),
    dict(replicas=5, autoscaling=dict(min_replicas=1, max_replicas=3)),
    dict(autoscaling=dict(min_replicas=5, max_replicas=3)),
    dict(autoscaling=dict(min_replicas=0, max_replicas=0)),
])
def test_endpoint_desired_replicas_equals_the_reference(case):
    """`endpoint_desired_replicas` over tests/test_autoscaler.py's inputs: the
    static count, the autoscaler's annotation (written, junk, 0, past the
    cap), the min/max clamp and scale-to-zero."""
    got = {}
    for side in (JAX, PORT):
        inf = side.inference
        ep = inf.InferenceEndpoint()
        ep.metadata.name, ep.metadata.namespace = "ep", NS
        auto = case.get("autoscaling")
        ep.spec.serving = inf.ServingSpec(replicas=case.get("replicas", 1),
                                          autoscaling=None if auto is None else inf.AutoscalingSpec(**auto))
        if "annotation" in case:
            ep.metadata.annotations[side.C.INFERENCE_DESIRED_REPLICAS_ANNOTATION] = case["annotation"]
        got[side.name] = side.ctrl.inference.endpoint_desired_replicas(ep)
    assert got["port"] == got["jax"], (case, got)


def test_a_pod_on_a_warm_pool_node_skips_the_cold_start():
    """sim_agent_behavior's `cold_start_s` on both packages: a pod landing
    on a node whose pool is warm (or claimed) is ready at once, any other
    pays the cold start, and the verdict sticks to the pod's incarnation
    once taken."""
    got = {}
    for side in (JAX, PORT):
        pools = Pools(side, slices=2)
        pools.pool.release("one-0", pools.nodes("one-0"), priority=0)
        nodes = {n.metadata.name: n for n in pools.client.list(side.core.Node)}
        behavior = side.behavior({}, cold_start_s=2.5, node_lookup=lambda name: nodes[name])
        out = []
        for i, node in enumerate(("one-0-w0", "one-1-w0", "one-0-w0")):
            pod = side.core.Pod()
            pod.metadata.name, pod.metadata.namespace, pod.metadata.uid = f"ep-{i}", NS, f"uid-{i % 2}"
            pod.metadata.labels = {side.C.INFERENCE_NAME_LABEL: "ep"}
            pod.spec.node_name = node
            out.append(behavior(pod).ready_after)
        # the same incarnation keeps its verdict after its node's pool changes
        nodes["one-1-w0"].metadata.annotations[pools.sp.POOL_STATE_ANNOTATION] = "warm"
        pod.metadata.uid, pod.spec.node_name = "uid-1", "one-1-w0"
        out.append(behavior(pod).ready_after)
        got[side.name] = out
    assert got["port"] == got["jax"] == [0.0, 2.5, 0.0, 2.5], got


class StaleNodes:
    """A client whose Node reads come from a snapshot taken at its making
    (an informer cache that has not yet applied the later writes); every
    other call goes to `client`."""

    def __init__(self, client, node_cls):
        self.client, self.node_cls = client, node_cls
        self.snapshot = {n.metadata.name: n for n in client.list(node_cls)}

    def list(self, cls, **kw):
        if cls is self.node_cls:
            return [copy.deepcopy(n) for n in self.snapshot.values()]
        return self.client.list(cls, **kw)

    def get(self, cls, namespace, name):
        if cls is self.node_cls:
            return copy.deepcopy(self.snapshot[name])
        return self.client.get(cls, namespace, name)

    def __getattr__(self, name):
        return getattr(self.client, name)


def test_a_claim_reads_the_pool_from_the_store_not_a_stale_cache():
    """The port's pool verbs judge by `reader` where one is given (the
    controllers pass the store's direct reader): a claim whose client's
    Node reads predate the release finds nothing warm, and with the store
    as its reader it claims the released slice."""
    p = Pools(PORT)
    stale = StaleNodes(p.client, PORT.core.Node)
    assert p.pool.release("one-0", p.nodes("one-0"), priority=0)
    assert p.sp.SlicePool(stale).claim(p.one.gke_accelerator, p.one.topology, f"{NS}/cached") is None
    entry = p.sp.SlicePool(stale, reader=p.client).claim(p.one.gke_accelerator, p.one.topology, f"{NS}/fresh")
    assert p.entry(entry) == ("one-0", "warm", 0, "", ["one-0-w0"])
    assert p.marks()["one-0-w0"][:3] == ("claimed", "0", f"{NS}/fresh")


def test_the_scheduler_binds_a_claimants_pod_on_its_claimed_pool_whatever_its_cache_shows():
    """A slice released warm and claimed for an endpoint before the
    endpoint's pod exists: the port's scheduler reads the nodes from the
    store, so the pod binds on the claimed pool even while the scheduler's
    cache still shows that pool warm (which takes nobody) and the next
    pool free."""
    from odh_kubeflow_tpu_torch.cluster.scheduler import Scheduler
    from odh_kubeflow_tpu_torch.gpu import GPU_RESOURCE
    from odh_kubeflow_tpu_torch.runtime.controller import Request

    p, core = Pools(PORT), PORT.core
    assert p.pool.release("one-0", p.nodes("one-0"), priority=0)
    stale = StaleNodes(p.client, core.Node)  # the cache: one-0 warm, not yet claimed
    assert p.entry(p.pool.claim(p.one.gke_accelerator, p.one.topology, f"{NS}/ep"))[0] == "one-0"
    pod = core.Pod()
    pod.metadata.name, pod.metadata.namespace = "ep-serve-0", NS
    pod.metadata.labels = {PORT.C.INFERENCE_NAME_LABEL: "ep"}
    pod.spec.node_selector = p.one.node_selector()
    pod.spec.containers = [core.Container(name="ep", image="serve:1", resources=core.ResourceRequirements(
        requests={GPU_RESOURCE: str(p.one.chips_per_host)}))]
    p.client.create(pod)
    Scheduler(SimpleNamespace(client=stale, api_reader=p.client)).reconcile(Request(NS, "ep-serve-0"))
    assert p.client.get(core.Pod, NS, "ep-serve-0").spec.node_name == "one-0-w0"


SUSPEND_FIELDS = ("suspend_enabled", "suspend_checkpoint_window_s", "suspend_checkpoint_retries",
                  "suspend_checkpoint_backoff_s", "resume_timeout_s", "resume_max_attempts", "pool_prewarm")


@pytest.mark.parametrize("env", [
    {},
    {"ENABLE_SUSPEND": "true", "SUSPEND_CHECKPOINT_WINDOW_S": "7.5", "RESUME_TIMEOUT_S": "12",
     "RESUME_MAX_ATTEMPTS": "3", "POOL_PREWARM": "2"},
    {"ENABLE_SUSPEND": "0", "RESUME_TIMEOUT_S": "0", "RESUME_MAX_ATTEMPTS": "0", "POOL_PREWARM": "-1"},
])
def test_the_suspend_and_prewarm_knobs_read_the_reference_env(monkeypatch, env):
    """The suspend, resume and prewarm fields of Config: the reference's
    defaults, env names and clamps; the prewarm shape defaults to one that
    `gpu.plan_slice` plans (h100 1x4, as the reference's v5e 2x2 is one host
    of 4 chips) and reads POOL_PREWARM_ACCELERATOR / _TOPOLOGY."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    got = {side.name: side.ctrl.Config.from_env() for side in SIDES}
    assert {k: getattr(got["jax"], k) for k in SUSPEND_FIELDS} == {k: getattr(got["port"], k) for k in SUSPEND_FIELDS}
    port = got["port"]
    assert PORT.plan_slice(port.pool_prewarm_accelerator, port.pool_prewarm_topology).topology == "1x4"
    monkeypatch.setenv("POOL_PREWARM_ACCELERATOR", "h100")
    monkeypatch.setenv("POOL_PREWARM_TOPOLOGY", "2x8")
    moved = PORT.ctrl.Config.from_env()
    assert (moved.pool_prewarm_accelerator, moved.pool_prewarm_topology) == ("h100", "2x8")


def test_the_managers_prewarmer_is_built_from_config():
    """`slicepool.add_prewarmer(manager, config)`: the reference's
    `build_manager` wiring. With pool_prewarm 0 it adds nothing; with 1 a
    PoolPrewarmer of Config's shape rides the manager's lifecycle and parks
    one free slice of that shape warm, none of another."""
    cluster = PORT.cluster.SimCluster().start()
    try:
        cluster.add_gpu_pool("four", "h100", "1x4", slices=2)
        cluster.add_gpu_pool("eight", "h100", "1x8", slices=1)
        mgr = PORT.runtime.Manager(cluster.store)
        assert PORT.slicepool.add_prewarmer(mgr, PORT.ctrl.Config()) is None
        warmer = PORT.slicepool.add_prewarmer(mgr, PORT.ctrl.Config(pool_prewarm=1, readiness_probe_period_s=0.2))
        assert (warmer.gke_accelerator, warmer.topology, warmer.target, warmer.period_s) == \
            ("nvidia-h100-80gb", "1x4", 1, 0.5)
        mgr.start()
        try:
            import time

            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and not PORT.slicepool.SlicePool(cluster.client).entries():
                time.sleep(0.05)
            entries = [(e.state, e.topology) for e in PORT.slicepool.SlicePool(cluster.client).entries()]
        finally:
            mgr.stop()
        assert entries == [("warm", "1x4")], entries
        assert warmer._thread is None, "the manager's stop did not stop the prewarmer"
    finally:
        cluster.stop()
