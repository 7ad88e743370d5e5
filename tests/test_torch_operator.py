"""The port's operator (odh_kubeflow_tpu_torch's store, manager, SimCluster,
NotebookReconciler, EventMirrorController, the readiness gate and the
culler) against the JAX package's, on the CPU, each scenario through both
SimClusters at once.

The slices are paired by hosts and chips: JAX v5e 2x2 (one host x 4 chips)
against port h100 1x4, and JAX v5p 2x2x4 (4 hosts x 4) against port h100
2x8 (2 hosts x 8, the same 16 chips). The StatefulSet, both Services, the
events' reasons and the status and conditions JSON are equal outside the
device fields, and the device fields map one to one through
tests/test_torch_gpu_podspec.py's `_strip` (resource, toleration, node
selector keys, device env) and each side's slice shape (replicas = hosts,
status.tpu). Every comparison is on JSON (`to_dict()`): each package has its
own scheme, store and tracing buffer. Each side's cluster and manager stop
in a `finally`.
"""
import copy
import time
from types import SimpleNamespace

import pytest

import torch_sides
import torch_threads
from test_torch_gpu_podspec import _strip

import odh_kubeflow_tpu.api.apps as j_apps
import odh_kubeflow_tpu.api.core as j_core
import odh_kubeflow_tpu.api.notebook as j_notebook
import odh_kubeflow_tpu.apimachinery as j_am
import odh_kubeflow_tpu.cluster as j_cluster
import odh_kubeflow_tpu.controllers as j_ctrl
import odh_kubeflow_tpu.probe as j_probe
import odh_kubeflow_tpu.runtime as j_runtime
import odh_kubeflow_tpu.tpu as j_tpu
import odh_kubeflow_tpu_torch.api.apps as p_apps
import odh_kubeflow_tpu_torch.api.core as p_core
import odh_kubeflow_tpu_torch.api.notebook as p_notebook
import odh_kubeflow_tpu_torch.apimachinery as p_am
import odh_kubeflow_tpu_torch.cluster as p_cluster
import odh_kubeflow_tpu_torch.controllers as p_ctrl
import odh_kubeflow_tpu_torch.gpu as p_gpu
import odh_kubeflow_tpu_torch.probe.behavior as p_probe
import odh_kubeflow_tpu_torch.runtime as p_runtime

torch_threads.cap()

NS = "user"
PROBE = 0.1  # the readiness gate's period, s
CULL = dict(enable_culling=True, cull_idle_time_min=1.0 / 60.0,  # 1 s idle threshold
            idleness_check_period_min=0.1 / 60.0)  # 0.1 s cadence

JAX = SimpleNamespace(
    name="jax", apps=j_apps, core=j_core, nb=j_notebook, am=j_am, cluster=j_cluster, ctrl=j_ctrl,
    C=j_ctrl.constants, runtime=j_runtime, behavior=j_probe.sim_agent_behavior,
    resource=j_tpu.TPU_RESOURCE, selector_keys=(j_tpu.GKE_TPU_ACCELERATOR_LABEL, j_tpu.GKE_TPU_TOPOLOGY_LABEL),
    plan=j_tpu.plan_slice,
    slices={"one-host": ("v5e", "2x2"), "multi-host": ("v5p", "2x2x4")},
    add_pool=lambda cluster, *a: cluster.add_tpu_pool(*a),
    device_env=lambda shape: {e["name"] for e in j_tpu.tpu_env(shape, "nb", "nb-hosts", NS)}
    | {e["name"] for e in j_tpu.ordinal_env()},
)
PORT = SimpleNamespace(
    name="port", apps=p_apps, core=p_core, nb=p_notebook, am=p_am, cluster=p_cluster, ctrl=p_ctrl,
    C=p_ctrl.constants, runtime=p_runtime, behavior=p_probe.sim_agent_behavior,
    resource=p_gpu.GPU_RESOURCE, selector_keys=(p_gpu.GKE_GPU_ACCELERATOR_LABEL, p_gpu.GPU_TOPOLOGY_LABEL),
    plan=p_gpu.plan_slice,
    slices={"one-host": ("h100", "1x4"), "multi-host": ("h100", "2x8")},
    add_pool=lambda cluster, *a: cluster.add_gpu_pool(*a),
    device_env=lambda shape: {e["name"] for e in p_gpu.gpu_env(shape, "nb", "nb-hosts", NS)}
    | {e["name"] for e in p_gpu.ordinal_env()},
)
SIDES = (JAX, PORT)


class Env:
    """One side's SimCluster and product manager."""

    def __init__(self, side, *, culling=False, **behavior):
        self.side = side
        self.cluster = side.cluster.SimCluster().start()
        self.agents = {}
        self.cluster.add_pod_behavior(side.behavior(self.agents, **behavior))
        cfg = side.ctrl.Config(readiness_probe_period_s=PROBE, **(CULL if culling else {}))
        self.mgr = side.runtime.Manager(self.cluster.store)
        side.ctrl.NotebookReconciler(self.mgr, cfg).setup()
        side.ctrl.EventMirrorController(self.mgr).setup()
        side.ctrl.ProbeStatusController(self.mgr, cfg, http_get=self.cluster.http_get).setup()
        if culling:
            side.ctrl.CullingReconciler(self.mgr, cfg, http_get=self.cluster.http_get).setup()
        self.mgr.start()
        self.client = self.cluster.client

    def stop(self):
        try:
            self.mgr.stop()
        finally:
            self.cluster.stop()

    def shape(self, which):
        return self.side.plan(*self.side.slices[which]) if which else None

    def add_pool(self, which, name="pool"):
        if which:
            self.side.add_pool(self.cluster, name, *self.side.slices[which])
        else:
            self.cluster.add_cpu_pool("cpu", nodes=1)

    def notebook(self, name, which=None, image="img:1"):
        nb = self.side.nb.Notebook()
        nb.metadata.name = name
        nb.metadata.namespace = NS
        nb.spec.template.spec.containers = [self.side.core.Container(name=name, image=image)]
        if which:
            accelerator, topology = self.side.slices[which]
            nb.spec.tpu = self.side.nb.TPUSpec(accelerator=accelerator, topology=topology)
        return self.client.create(nb)

    def get(self, kind, name):
        cls = {"Notebook": self.side.nb.Notebook, "StatefulSet": self.side.apps.StatefulSet,
               "Service": self.side.core.Service, "Pod": self.side.core.Pod}[kind]
        return self.client.get(cls, NS, name)

    def pods(self, nb):
        return self.client.list(self.side.core.Pod, namespace=NS, labels={self.side.C.NOTEBOOK_NAME_LABEL: nb})

    def annotations(self, nb):
        return self.get("Notebook", nb).metadata.annotations

    def events(self):
        return self.client.list(self.side.core.Event, namespace=NS)

    def patch_annotations(self, nb, annotations):
        self.client.patch(self.side.nb.Notebook, NS, nb, {"metadata": {"annotations": annotations}})


def wait_for(fn, timeout=20.0, msg="condition"):
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            out = fn()
            if out:
                return out
            last = out
        except Exception as e:  # NotFound of either package, a failed assert
            last = e
        time.sleep(0.02)
    raise AssertionError(f"timeout waiting for {msg}: last={last!r}")


def both(scenario, **env_kw):
    """Runs scenario(env) on the JAX side and the port side at once, each in
    its own cluster; returns {"jax": result, "port": result}."""
    return torch_sides.both(scenario, lambda side: Env(side, **env_kw), lambda env: env.stop(), sides=SIDES)


# ---------------------------------------------------------------------------
# the device map: JSON of either side with its device fields taken out
# ---------------------------------------------------------------------------

VOLATILE = ("uid", "resourceVersion", "creationTimestamp", "generation", "deletionTimestamp")


def canon_meta(meta):
    for k in VOLATILE:
        meta.pop(k, None)
    for ref in meta.get("ownerReferences", []):
        ref.pop("uid", None)
    return meta


def canon_sts(side, d, shape):
    d = copy.deepcopy(d)
    canon_meta(d["metadata"])
    d.pop("status", None)
    if shape is not None:
        assert d["spec"]["replicas"] in (0, shape.hosts)
        d["spec"]["replicas"] = "hosts" if d["spec"]["replicas"] else 0
        d = _strip(d, side.resource, side.selector_keys, side.device_env(shape))
    return d


def canon_service(d):
    d = copy.deepcopy(d)
    canon_meta(d["metadata"])
    d.pop("status", None)
    return d


def canon_status(side, d, shape):
    """status without timestamps; status.tpu checked against the side's
    shape and taken out."""
    d = copy.deepcopy(d)
    for c in d.get("conditions", []):
        for k in ("lastTransitionTime", "lastProbeTime"):
            c.pop(k, None)
    running = (d.get("containerState") or {}).get("running")
    if running:
        running["startedAt"] = "t"
    tpu = d.pop("tpu", None)
    if shape is None:
        assert tpu is None
    else:
        want = {"accelerator": shape.accelerator, "topology": shape.topology, "hosts": shape.hosts,
                "chipsPerHost": shape.chips_per_host, "chipsExpected": shape.chips}
        assert {k: tpu.get(k) for k in want} == want, (side.name, tpu)
        d["tpu"] = {k: v for k, v in tpu.items() if k not in want}
        if d["tpu"].get("hostsReady") == shape.hosts:
            d["tpu"]["hostsReady"] = "hosts"
        if d["tpu"].get("chipsVisible") == shape.chips:
            d["tpu"]["chipsVisible"] = "chips"
        if d["tpu"].get("firstReadyTime"):
            d["tpu"]["firstReadyTime"] = "t"
    if d.get("readyReplicas") and shape is not None and d["readyReplicas"] == shape.hosts:
        d["readyReplicas"] = "hosts"
    return d


def canon_message(side, message, shape):
    if shape is not None:
        message = message.replace(f"{shape.chips_per_host} {side.resource}", "CHIPS RESOURCE")
    return message


def snapshot(env, nb, which):
    """The notebook's objects, status and events as canonical JSON."""
    side, shape = env.side, env.shape(which)
    sts = env.get("StatefulSet", nb).to_dict()
    return {
        "statefulset": canon_sts(side, sts, shape),
        "service": canon_service(env.get("Service", nb).to_dict()),
        "hosts service": canon_service(env.get("Service", f"{nb}-hosts").to_dict()),
        "status": canon_status(side, env.get("Notebook", nb).status.to_dict(), shape),
        "events": sorted({(e.involved_object.kind, e.reason) for e in env.events()}),
    }


def assert_parity(got):
    assert got["jax"] == got["port"]


def mesh_ready(env, nb):
    n = env.get("Notebook", nb)
    return n if n.status.tpu and n.status.tpu.mesh_ready else None


def ready(env, nb, replicas=1):
    return env.get("StatefulSet", nb).status.ready_replicas == replicas


# ---------------------------------------------------------------------------
# the reconciler, the gate and the event mirror
# ---------------------------------------------------------------------------


def cpu_end_to_end(env):
    env.add_pool(None)
    env.notebook("mini")
    wait_for(lambda: env.get("Notebook", "mini").status.ready_replicas == 1, msg="ready")
    wait_for(lambda: env.get("Service", "mini") and env.get("Service", "mini-hosts"), msg="services")
    wait_for(lambda: env.get("Notebook", "mini").status.container_state, msg="container state")
    return snapshot(env, "mini", None)


def one_host_mesh_ready(env):
    env.add_pool("one-host")
    env.notebook("lab", "one-host")
    nb = wait_for(lambda: mesh_ready(env, "lab"), msg="mesh ready")
    assert nb.status.tpu.chips_visible == nb.status.tpu.chips_expected == 4
    wait_for(lambda: any(c.type == "TPUHealthy" for c in env.get("Notebook", "lab").status.conditions),
             msg="TPUHealthy")
    return snapshot(env, "lab", "one-host")


def multi_host_gang(env):
    """A slice whose pool has one failed host binds nothing (all or
    nothing); the host restored, the whole gang binds in the one pool."""
    env.add_pool("multi-host")
    shape = env.shape("multi-host")
    env.cluster.fail_node("pool-w0")
    env.notebook("train", "multi-host")
    wait_for(lambda: len(env.pods("train")) == shape.hosts, msg="pods created")
    time.sleep(0.5)
    bound_while_failed = [p.spec.node_name for p in env.pods("train") if p.spec.node_name]
    env.cluster.restore_node("pool-w0")
    nb = wait_for(lambda: mesh_ready(env, "train"), msg="mesh ready", timeout=30)
    pods = env.pods("train")
    nodes = {p.spec.node_name for p in pods}
    assert len(nodes) == shape.hosts and all(n.startswith("pool-w") for n in nodes)
    assert nb.status.tpu.hosts_ready == shape.hosts and nb.status.tpu.chips_visible == shape.chips
    # the ordinal env: every pod's rank from the downward API (JAX names it
    # twice, TPU_WORKER_ID and JAX_PROCESS_ID; the port once, PET_NODE_RANK)
    c = env.get("StatefulSet", "train").spec.template.spec.containers[0]
    ordinal = sorted({e.value_from.to_dict()["fieldRef"]["fieldPath"] for e in c.env if e.value_from})
    return {"bound while a host failed": bound_while_failed, "ordinal field paths": ordinal,
            **snapshot(env, "train", "multi-host")}


def stop_scales_to_zero(env):
    env.add_pool("one-host")
    env.notebook("s1", "one-host")
    wait_for(lambda: mesh_ready(env, "s1"), msg="mesh ready")
    env.patch_annotations("s1", {env.side.C.STOP_ANNOTATION: "2026-01-01T00:00:00Z"})
    wait_for(lambda: env.get("StatefulSet", "s1").spec.replicas == 0, msg="scaled to 0")
    wait_for(lambda: not env.pods("s1"), msg="pods gone")
    wait_for(lambda: env.get("Notebook", "s1").status.ready_replicas == 0
             and env.get("Notebook", "s1").status.tpu.hosts_ready == 0, msg="status drained")
    wait_for(lambda: not env.get("Notebook", "s1").status.tpu.mesh_ready and any(
        c.type == "TPUHealthy" and c.reason == "Stopped" for c in env.get("Notebook", "s1").status.conditions),
        msg="the gate closed on the stop")
    stopped = snapshot(env, "s1", "one-host")
    env.patch_annotations("s1", {env.side.C.STOP_ANNOTATION: None})
    wait_for(lambda: ready(env, "s1"), msg="restarted")
    return {"stopped": stopped, "replicas after unstop": env.get("StatefulSet", "s1").spec.replicas > 0}


def restart_recreates_every_ordinal(env):
    env.add_pool("multi-host")
    shape = env.shape("multi-host")
    env.notebook("r1", "multi-host")
    wait_for(lambda: mesh_ready(env, "r1"), msg="mesh ready", timeout=30)
    uids = {p.metadata.name: p.metadata.uid for p in env.pods("r1")}
    assert len(uids) == shape.hosts
    env.patch_annotations("r1", {env.side.C.NOTEBOOK_RESTART_ANNOTATION: "true"})

    def recreated():
        if env.side.C.NOTEBOOK_RESTART_ANNOTATION in env.annotations("r1"):
            return False
        now = {p.metadata.name: p.metadata.uid for p in env.pods("r1")}
        return set(now) == set(uids) and all(now[n] != uids[n] for n in uids)

    wait_for(recreated, msg="every ordinal pod recreated", timeout=30)
    return {"ordinals": "all recreated", "annotations": sorted(env.annotations("r1"))}


def spec_change_rolls_template(env):
    env.add_pool(None)
    env.notebook("u1", image="img:1")
    wait_for(lambda: ready(env, "u1"), msg="ready")
    nb = env.get("Notebook", "u1")
    nb.spec.template.spec.containers[0].image = "img:2"
    env.client.update(nb)
    wait_for(lambda: env.get("StatefulSet", "u1").spec.template.spec.containers[0].image == "img:2",
             msg="template rolled")
    wait_for(lambda: env.get("Pod", "u1-0").spec.containers[0].image == "img:2", msg="pod recreated")
    return snapshot(env, "u1", None)["statefulset"]


def scheduling_failure_mirrored(env):
    """No pool of the accelerator: FailedScheduling names the device
    resource and is mirrored onto the Notebook."""
    env.notebook("starved", "multi-host")

    def mirrored():
        return [e for e in env.events() if e.involved_object.kind == "Notebook"
                and e.involved_object.name == "starved" and e.reason == "FailedScheduling"]

    (event,) = wait_for(mirrored, msg="mirrored FailedScheduling event")[:1]
    assert env.side.resource in event.message
    return {"message": canon_message(env.side, event.message, env.shape("multi-host")),
            "type": event.type, "reasons": sorted({(e.involved_object.kind, e.reason) for e in env.events()})}


def partial_visibility_keeps_gate_closed(env):
    env.add_pool("one-host")
    env.notebook("dim", "one-host")
    wait_for(lambda: env.get("Notebook", "dim").status.ready_replicas == 1, msg="pod ready")
    time.sleep(6 * PROBE)  # several gate sweeps
    nb = env.get("Notebook", "dim")
    assert not nb.status.tpu.mesh_ready and not nb.status.tpu.first_ready_time
    wait_for(lambda: env.get("Notebook", "dim").status.tpu.chips_visible == 2, msg="chips visible 2")
    return canon_status(env.side, env.get("Notebook", "dim").status.to_dict(), env.shape("one-host"))


SCENARIOS = {
    "cpu notebook end to end": (cpu_end_to_end, {}),
    "one-host slice to mesh-ready": (one_host_mesh_ready, {}),
    "multi-host slice: ordinal env, all-or-nothing gang": (multi_host_gang, {}),
    "stop scales to 0 replicas": (stop_scales_to_zero, {}),
    "restart recreates every ordinal pod": (restart_recreates_every_ordinal, {}),
    "a spec change rolls the template": (spec_change_rolls_template, {}),
    "a scheduling failure is mirrored to the notebook": (scheduling_failure_mirrored, {}),
    "partial chip visibility keeps the gate closed": (partial_visibility_keeps_gate_closed,
                                                       {"visible_chips": {"dim-0": 2}}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_operator_parity(name):
    scenario, behavior = SCENARIOS[name]
    assert_parity(both(scenario, **behavior))


def test_reconciler_statefulset_equals_apply_slice():
    """The port's reconciler renders the GPU fields through apply_slice:
    its set equals apply_slice on the set it renders without a slice."""
    mgr = p_runtime.Manager(p_cluster.Store())
    rec = p_ctrl.NotebookReconciler(mgr, p_ctrl.Config())
    for topology in ("1x1", "1x4", "2x8"):
        for stopped in (False, True):
            nb = p_notebook.Notebook()
            nb.metadata.name, nb.metadata.namespace = "nb", NS
            if stopped:
                nb.metadata.annotations = {p_ctrl.constants.STOP_ANNOTATION: "2026-01-01T00:00:00Z"}
            nb.spec.template.spec.containers = [p_core.Container(name="nb", image="img")]
            plain = rec.generate_statefulset(nb, None).to_dict()
            nb.spec.tpu = p_notebook.TPUSpec(accelerator="h100", topology=topology)
            shape = rec.plan(nb)
            got = rec.generate_statefulset(nb, shape).to_dict()
            assert got == p_gpu.apply_slice(plain, shape, NS)
            assert got["spec"]["replicas"] == (0 if stopped else shape.hosts)


# ---------------------------------------------------------------------------
# the culler
# ---------------------------------------------------------------------------

CULL_ANNOTATIONS = ("STOP_ANNOTATION", "LAST_ACTIVITY_ANNOTATION", "LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION")


def annotation_keys(env, nb):
    C = env.side.C
    return sorted(n for n in CULL_ANNOTATIONS if getattr(C, n) in env.annotations(nb))


def wait_culled(env, nb, msg):
    """The stop annotation is set, and the culler has dropped its activity
    annotations once stopped."""
    C = env.side.C
    wait_for(lambda: C.STOP_ANNOTATION in env.annotations(nb), msg=msg)
    wait_for(lambda: C.LAST_ACTIVITY_ANNOTATION not in env.annotations(nb), msg="activity annotations dropped")


def idle_is_culled(env):
    env.add_pool("one-host")
    env.notebook("sleepy", "one-host")
    wait_for(lambda: env.side.C.LAST_ACTIVITY_ANNOTATION in env.annotations("sleepy")
             or env.side.C.STOP_ANNOTATION in env.annotations("sleepy"), msg="activity annotation")
    wait_culled(env, "sleepy", "culled")
    wait_for(lambda: env.get("StatefulSet", "sleepy").spec.replicas == 0, msg="scaled to 0")
    wait_for(lambda: not env.pods("sleepy"), msg="slice freed")
    return annotation_keys(env, "sleepy")


def busy_blocks_cull(signal):
    def scenario(env):
        env.add_pool("one-host")
        env.notebook("worker", "one-host")
        wait_for(lambda: "worker-0" in env.agents, msg="pod up")
        agent = env.agents["worker-0"]
        if signal == "kernel":
            agent.kernels.set_busy()
        else:  # the device is hot while the kernels idle
            agent.kernels.set_idle(time.time() - 3600)
            agent.monitor.duty = 0.9
            agent.monitor.last_busy_ts = time.time()
        time.sleep(2.5)  # past the idle threshold, many checks
        blocked = env.side.C.STOP_ANNOTATION not in env.annotations("worker")
        if signal == "kernel":
            agent.kernels.set_idle(time.time())
        agent.monitor.duty = 0.0
        wait_culled(env, "worker", "culled once idle")
        return {"blocked while busy": blocked, "annotations": annotation_keys(env, "worker")}

    return scenario


def unstop_rearms_idle_clock(env):
    C = env.side.C
    env.add_pool("one-host")
    env.notebook("cycle", "one-host")
    wait_for(lambda: C.STOP_ANNOTATION in env.annotations("cycle"), msg="culled once")
    wait_for(lambda: not env.pods("cycle"), msg="slice freed")
    t_unstop = time.time()
    env.patch_annotations("cycle", {C.STOP_ANNOTATION: None})
    wait_for(lambda: C.LAST_ACTIVITY_ANNOTATION in env.annotations("cycle"), msg="idle clock re-armed")
    rearmed = env.side.am.parse_time(env.annotations("cycle")[C.LAST_ACTIVITY_ANNOTATION]).timestamp()
    wait_culled(env, "cycle", "culled again")
    return {"re-armed after unstop": rearmed >= int(t_unstop), "annotations": annotation_keys(env, "cycle")}


CULL_SCENARIOS = {
    "an idle notebook is culled": (idle_is_culled, {}),
    "a busy kernel blocks the cull": (busy_blocks_cull("kernel"), {}),
    "a busy duty cycle blocks the cull": (busy_blocks_cull("duty"), {}),
    "an unstopped notebook re-arms the idle clock": (unstop_rearms_idle_clock, {}),
}


@pytest.mark.parametrize("name", list(CULL_SCENARIOS))
def test_culling_parity(name):
    scenario, behavior = CULL_SCENARIOS[name]
    got = both(scenario, culling=True, duty=0.0, kernels_busy=False, **behavior)
    assert_parity(got)
    if isinstance(got["port"], dict):
        assert all(v for k, v in got["port"].items() if k != "annotations")


# ---------------------------------------------------------------------------
# the store, the client and the informer
# ---------------------------------------------------------------------------

def _cm(side, name, labels):
    nb = side.nb.Notebook()
    nb.metadata.name, nb.metadata.namespace, nb.metadata.labels = name, NS, dict(labels)
    nb.spec.template.spec.containers = [side.core.Container(name=name, image="img")]
    return nb


def _store(side):
    # the JAX store's pure-Python backend, the only one the port has
    return side.cluster.Store(backend="python") if side is JAX else side.cluster.Store()


def store_create(side):
    client = side.cluster.Client(_store(side))
    out = client.create(_cm(side, "a", {"team": "x"})).to_dict()
    try:
        client.create(_cm(side, "a", {}))
        dup = None
    except side.am.ApiError as e:
        dup = (type(e).__name__, e.code)
    return {"created": canon_meta(out["metadata"]), "duplicate": dup}


def store_conflict(side):
    client = side.cluster.Client(_store(side))
    first = client.create(_cm(side, "a", {}))
    stale = client.get(side.nb.Notebook, NS, "a")
    first.metadata.labels = {"v": "1"}
    client.update(first)
    stale.metadata.labels = {"v": "2"}
    try:
        client.update(stale)
        err = None
    except side.am.ApiError as e:
        err = (type(e).__name__, e.code)
    return {"error": err, "labels": client.get(side.nb.Notebook, NS, "a").metadata.labels}


def store_merge_patch(side):
    client = side.cluster.Client(_store(side))
    client.create(_cm(side, "a", {"keep": "1", "drop": "2"}))
    out = client.patch(side.nb.Notebook, NS, "a", {"metadata": {"labels": {"drop": None, "add": "3"},
                                                                "annotations": {"k": "v"}}}).to_dict()
    return canon_meta(out["metadata"])


def store_selector_list(side):
    client = side.cluster.Client(_store(side))
    for name, labels in (("a", {"team": "x", "tier": "1"}), ("b", {"team": "y"}), ("c", {"team": "x"})):
        client.create(_cm(side, name, labels))
    return {str(sel): [n.metadata.name for n in client.list(side.nb.Notebook, namespace=NS, labels=sel)]
            for sel in ({"team": "x"}, {"team": "x", "tier": "1"}, {"team": "z"}, {})}


def store_watch_order(side):
    store = _store(side)
    client = side.cluster.Client(store)
    client.create(_cm(side, "pre", {}))
    watch = store.watch("kubeflow.org/v1beta1", "Notebook", namespace=NS)
    inf = side.runtime.Informer(store, "kubeflow.org/v1beta1", "Notebook")
    seen = []
    inf.add_handler(lambda ev, obj, old: seen.append((ev, obj["metadata"]["name"])))
    inf.start()
    try:
        client.create(_cm(side, "a", {}))
        client.patch(side.nb.Notebook, NS, "a", {"metadata": {"labels": {"x": "1"}}})
        client.delete(side.nb.Notebook, NS, "a")
        events = [(ev.type, ev.object["metadata"]["name"]) for ev in watch.pending]
        while len(events) < 4:
            ev = watch.get(timeout=5)
            events.append((ev.type, ev.object["metadata"]["name"]))
        wait_for(lambda: len(seen) >= 4, msg="informer events")
        return {"watch": events, "informer": seen, "cache": [o["metadata"]["name"] for o in inf.list()]}
    finally:
        inf.stop()
        watch.stop()


STORE_CASES = {"create": store_create, "update on a stale resourceVersion": store_conflict,
               "merge patch": store_merge_patch, "label-selector list": store_selector_list,
               "watch and informer event order": store_watch_order}


@pytest.mark.parametrize("name", list(STORE_CASES))
def test_store_client_informer_parity(name):
    got = {side.name: STORE_CASES[name](side) for side in SIDES}
    assert got["jax"] == got["port"]
    if name == "update on a stale resourceVersion":
        assert got["port"]["error"] == ("ConflictError", 409)


def test_port_store_loads_no_native_library():
    """The port's store keeps only the pure-Python path: it takes no
    backend and loads nothing of the JAX package's _native."""
    import inspect
    import sys

    assert "backend" not in inspect.signature(p_cluster.Store).parameters
    p_cluster.Store()
    assert not [m for m in sys.modules if m.startswith("odh_kubeflow_tpu_torch._native")]


def test_port_errors_are_one_class_each():
    """The router's 429 and the planner's 422 are the classes errors.py
    defines, re-exported by the package."""
    from odh_kubeflow_tpu_torch.apimachinery import errors
    from odh_kubeflow_tpu_torch.cluster import flowcontrol
    from odh_kubeflow_tpu_torch.gpu import podspec, topology
    from odh_kubeflow_tpu_torch.serving import router

    assert p_am.InvalidError is errors.InvalidError is topology.InvalidError is podspec.InvalidError
    assert p_am.TooManyRequestsError is errors.TooManyRequestsError is flowcontrol.TooManyRequestsError
    assert router.TooManyRequestsError is errors.TooManyRequestsError


def test_chips_bound_gauge_counts_gpus():
    """controllers/metrics.py's collector: bound chips and allocatable
    cards by accelerator, from nvidia.com/gpu."""
    env = Env(PORT)
    try:
        env.add_pool("multi-host")
        env.notebook("g", "multi-host")
        wait_for(lambda: ready(env, "g", 2), msg="ready")
        registry = p_runtime.Registry()
        metrics = p_ctrl.NotebookMetrics(registry, env.client)
        registry.run_collectors()
        assert metrics.tpu_chips_bound.value() == 16
        assert metrics.tpu_chips_allocatable.value(accelerator="nvidia-h100-80gb") == 16
    finally:
        env.stop()
