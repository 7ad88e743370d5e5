"""The port's chip accountant (runtime/accounting.py: `ChipAccountant`, its
phases, conservation check, snapshot and goodput views), its job metric
families (runtime/jobmetrics.py) and the incident bundle's `accounting`
block against the JAX package's, on the CPU: each controller-free case of
tests/test_accounting.py, run with one annotation script on a manual clock
through both SimClusters (tests/torch_sides.py: JAX v5e 2x2 ~ port h100
1x4, one host of 4 chips), comparing the attributions, the chip-seconds by
class and by phase, the per-object rows and the conservation arithmetic.
The port counts `nvidia.com/gpu` capacity and requests where the JAX one
counts `google.com/tpu`.

The four `/debug/accounting` cases (the ledger served with its filters,
the module handle's fallback, the 400s and the 404 with no accountant, the
index's link) run on both packages in one test (tests/torch_ported.py),
through each package's manager debug mux (`runtime/serving.py`). Not
here: the armed check's wall-clock overhead case, which load on the test
machine breaks.
"""
import os
import random
from datetime import datetime, timezone

import pytest

import torch_ported
import odh_kubeflow_tpu.runtime.accounting as j_accounting
import odh_kubeflow_tpu.runtime.flightrecorder as j_flightrecorder
import odh_kubeflow_tpu.utils.invcheck as j_invcheck
import odh_kubeflow_tpu_torch.runtime.accounting as p_accounting
import odh_kubeflow_tpu_torch.runtime.flightrecorder as p_flightrecorder
import odh_kubeflow_tpu_torch.utils.invcheck as p_invcheck
from torch_sides import JAX, PORT

CHIPS_PER_SLICE = 4  # v5e 2x2 and h100 1x4: one host, four chips
ACCOUNTING = {"jax": j_accounting, "port": p_accounting}
RECORDER = {"jax": j_flightrecorder, "port": p_flightrecorder}
INVCHECK = {"jax": j_invcheck, "port": p_invcheck}


def iso(t):
    return datetime.fromtimestamp(t, tz=timezone.utc).isoformat().replace("+00:00", "Z")


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


class World:
    """One side's SimCluster with `slices` pools of the one-host slice, a
    sim-clocked accountant, and the annotation levers the classifier reads
    (the reference test's World)."""

    def __init__(self, side, slices=3, idle_after_s=100.0):
        self.side, self.C = side, side.C
        self.accounting = ACCOUNTING[side.name]
        self.cluster = side.cluster.SimCluster().start()
        side.add_pool(self.cluster, "acct", *side.slices["one-host"], slices=slices)
        self.clock = Clock()
        self.client = self.cluster.client
        self.acct = self.accounting.ChipAccountant(self.client, idle_after_s=idle_after_s, clock=self.clock)

    def stop(self):
        self.cluster.stop()

    def tick_to(self, t_end, step=5.0):
        while self.clock.t < t_end:
            self.clock.advance(min(step, t_end - self.clock.t))
            self.acct.tick()

    def add_notebook(self, name, mesh_ready=True, activity_at=0.0):
        nb = self.side.nb.Notebook()
        nb.metadata.name, nb.metadata.namespace = name, "t"
        nb.metadata.annotations[self.C.LAST_ACTIVITY_ANNOTATION] = iso(activity_at)
        nb.status.tpu = self.side.nb.TPUStatus(mesh_ready=mesh_ready)
        self.client.create(nb)

    def add_owner(self, kind, name, key, state):
        obj = kind()
        obj.metadata.name, obj.metadata.namespace = name, "t"
        obj.metadata.annotations[key] = state
        self.client.create(obj)

    def annotate(self, kind, name, key, value):
        obj = self.client.get(kind, "t", name)
        if value is None:
            obj.metadata.annotations.pop(key, None)
        else:
            obj.metadata.annotations[key] = value
        self.client.update(obj)

    def annotate_node(self, pool, updates):
        node = self.client.get(self.side.core.Node, "", f"{pool}-w0")
        for k, v in updates.items():
            if v is None:
                node.metadata.annotations.pop(k, None)
            else:
                node.metadata.annotations[k] = v
        self.client.update(node)

    def bind_pod(self, name, pool, owner_label, owner):
        core = self.side.core
        pod = core.Pod()
        pod.metadata.name, pod.metadata.namespace = name, "t"
        pod.metadata.labels = {owner_label: owner}
        pod.spec.node_name = f"{pool}-w0"
        pod.spec.containers = [core.Container(name="work", image="work:1", resources=core.ResourceRequirements(
            requests={self.side.device_resource: str(CHIPS_PER_SLICE)}))]
        self.client.create(pod)

    def ledger(self):
        """What is compared: the attributions of now, the chip-seconds by
        (class, phase), the snapshot's sums and rows, the conservation."""
        snap = self.acct.snapshot()
        by = {}
        for cls in self.accounting.CLASSES:
            for phase in self.accounting.PHASES:
                v = self.acct.chip_seconds(workload_class=cls, phase=phase)
                if v:
                    by[f"{cls} {phase}"] = v
        return {"attributions": sorted((a.node, a.chips, a.workload_class, a.obj, a.phase)
                                       for a in self.acct.classify()),
                "chip_seconds": by, "totals": snap["chip_seconds"], "objects": snap["objects"],
                "utilization": snap["fleet_utilization"], "ticks": snap["ticks"],
                "conservation": self.acct.conservation()}


def on_both(scenario, **kw):
    """scenario(world) on each side in turn, each in its own World;
    asserts the results equal and returns the port's."""
    got = {}
    for side in (JAX, PORT):
        world = World(side, **kw)
        try:
            got[side.name] = scenario(world)
        finally:
            world.stop()
    assert got["jax"] == got["port"]
    return got["port"]


# ---------------------------------------------------------------------------
# phase-transition attribution on the sim clock
# ---------------------------------------------------------------------------


def test_suspend_episode_attributes_drain_then_warm_hold():
    def scenario(w):
        C, sp = w.C, w.side.slicepool
        w.add_notebook("nb-a")
        w.bind_pod("nb-a-pod", "acct-0", C.NOTEBOOK_NAME_LABEL, "nb-a")
        w.acct.tick()
        w.tick_to(20)
        w.annotate(w.side.nb.Notebook, "nb-a", C.TPU_SUSPEND_STATE_ANNOTATION, "checkpointing")
        w.tick_to(30)
        w.client.delete(w.side.core.Pod, "t", "nb-a-pod")
        w.annotate(w.side.nb.Notebook, "nb-a", C.TPU_SUSPEND_STATE_ANNOTATION, "suspended")
        w.annotate_node("acct-0", {sp.POOL_STATE_ANNOTATION: sp.POOL_STATE_WARM, sp.POOL_PRIORITY_ANNOTATION: "10"})
        w.annotate_node("acct-1", {sp.POOL_STATE_ANNOTATION: sp.POOL_STATE_WARM})
        w.tick_to(50)
        return w.ledger()

    port = on_both(scenario)
    assert port["chip_seconds"] == {"notebook ready": 20 * CHIPS_PER_SLICE,
                                    "notebook draining": 10 * CHIPS_PER_SLICE,
                                    "pool suspended-warm": 20 * CHIPS_PER_SLICE,
                                    "pool pool-free": (50 + 30 + 20) * CHIPS_PER_SLICE}
    assert port["conservation"]["residual_ratio"] == 0.0
    assert port["conservation"]["physical_chip_seconds"] == 50 * 3 * CHIPS_PER_SLICE


def test_repair_episode_attributes_to_owner_not_pool():
    def scenario(w):
        w.add_notebook("nb-r")
        w.bind_pod("nb-r-pod", "acct-0", w.C.NOTEBOOK_NAME_LABEL, "nb-r")
        w.acct.tick()
        w.tick_to(10)
        w.cluster.fail_node("acct-0-w0")
        w.tick_to(40)
        w.cluster.restore_node("acct-0-w0")
        w.tick_to(50)
        out = w.ledger()
        out["notebooks"] = w.acct.snapshot(workload_class="notebook")["objects"]
        return out

    port = on_both(scenario)
    assert port["chip_seconds"]["notebook repairing"] == 30 * CHIPS_PER_SLICE
    assert port["chip_seconds"]["notebook ready"] == 20 * CHIPS_PER_SLICE
    assert port["notebooks"] == [{"workload_class": "notebook", "object": "t/nb-r",
                                  "chip_seconds": 50 * CHIPS_PER_SLICE}]


def test_reclaim_episode_claim_window_then_job_phases():
    def scenario(w):
        C, sp, TPUJob = w.C, w.side.slicepool, w.side.job.TPUJob
        w.acct.tick()
        w.annotate_node("acct-0", {sp.POOL_STATE_ANNOTATION: sp.POOL_STATE_CLAIMED,
                                   sp.POOL_CLAIMED_BY_ANNOTATION: "t/train-z"})
        w.tick_to(15)
        w.add_owner(TPUJob, "train-z", C.JOB_STATE_ANNOTATION, "admitted")
        w.annotate_node("acct-0", {sp.POOL_STATE_ANNOTATION: None, sp.POOL_CLAIMED_BY_ANNOTATION: None})
        w.bind_pod("train-z-pod", "acct-0", C.JOB_NAME_LABEL, "train-z")
        w.tick_to(25)
        w.annotate(TPUJob, "train-z", C.JOB_STATE_ANNOTATION, "running")
        w.tick_to(55)
        return w.ledger()

    port = on_both(scenario)
    by = port["chip_seconds"]
    assert by["pool reclaim-churn"] == 15 * CHIPS_PER_SLICE
    assert by["job starting"] == 10 * CHIPS_PER_SLICE and by["job ready"] == 30 * CHIPS_PER_SLICE
    claimer = [r for r in port["objects"] if r["object"] == "t/train-z"]
    assert sum(r["chip_seconds"] for r in claimer) == 55 * CHIPS_PER_SLICE
    assert {"workload_class": "pool", "object": "t/train-z", "chip_seconds": 15 * CHIPS_PER_SLICE} in claimer


def test_stale_activity_turns_ready_into_idle_bound():
    def scenario(w):
        w.add_notebook("nb-i", activity_at=0.0)
        w.bind_pod("nb-i-pod", "acct-0", w.C.NOTEBOOK_NAME_LABEL, "nb-i")
        w.acct.tick()
        w.tick_to(100)
        w.tick_to(160)
        at_160 = w.ledger()
        w.annotate(w.side.nb.Notebook, "nb-i", w.C.LAST_ACTIVITY_ANNOTATION, iso(160))
        w.tick_to(180)
        return {"at_160": at_160, "at_180": w.ledger()}

    port = on_both(scenario)
    assert port["at_160"]["chip_seconds"]["notebook ready"] == 100 * CHIPS_PER_SLICE
    assert port["at_160"]["chip_seconds"]["notebook idle-bound"] == 60 * CHIPS_PER_SLICE
    assert port["at_180"]["chip_seconds"]["notebook ready"] == 120 * CHIPS_PER_SLICE


# ---------------------------------------------------------------------------
# conservation under a seeded mixed bad-day soak
# ---------------------------------------------------------------------------


def test_conservation_holds_under_seeded_mixed_soak(monkeypatch):
    """The reference's seeded churn (seed 1734) across notebook, inference
    and job owners, INVCHECK armed around every tick: the same attribution
    on both sides at every tick, and zero residual at the end."""
    monkeypatch.delenv("INVCHECK", raising=False)

    def armed_tick(acct):
        os.environ["INVCHECK"] = "1"
        try:
            return acct.tick()
        finally:
            os.environ.pop("INVCHECK", None)

    def scenario(w):
        C, sp = w.C, w.side.slicepool
        Notebook, Endpoint, TPUJob = w.side.nb.Notebook, w.side.inference.InferenceEndpoint, w.side.job.TPUJob
        rng = random.Random(1734)
        for i in range(3):
            w.add_notebook(f"nb-{i}")
            w.bind_pod(f"nb-{i}-pod", f"acct-{i}", C.NOTEBOOK_NAME_LABEL, f"nb-{i}")
        w.add_owner(Endpoint, "ep-0", C.INFERENCE_STATE_ANNOTATION, "serving")
        w.bind_pod("ep-0-pod", "acct-3", C.INFERENCE_NAME_LABEL, "ep-0")
        w.add_owner(TPUJob, "job-0", C.JOB_STATE_ANNOTATION, "running")
        w.bind_pod("job-0-pod", "acct-4", C.JOB_NAME_LABEL, "job-0")
        armed_tick(w.acct)
        failed, banked = set(), []
        for _ in range(120):
            op = rng.randrange(8)
            if op == 0:
                w.annotate(Notebook, f"nb-{rng.randrange(3)}", C.TPU_SUSPEND_STATE_ANNOTATION,
                           rng.choice(["checkpointing", "suspended", "resuming", None]))
            elif op == 1:
                node = f"acct-{rng.randrange(6)}-w0"
                if node in failed:
                    failed.discard(node)
                    w.cluster.restore_node(node)
                else:
                    failed.add(node)
                    w.cluster.fail_node(node)
            elif op == 2:
                w.annotate_node("acct-5", {
                    sp.POOL_STATE_ANNOTATION: rng.choice([sp.POOL_STATE_WARM, sp.POOL_STATE_CLAIMED, None]),
                    sp.POOL_CLAIMED_BY_ANNOTATION: rng.choice(["t/job-0", None])})
            elif op == 3:
                w.annotate(Endpoint, "ep-0", C.INFERENCE_STATE_ANNOTATION,
                           rng.choice(["serving", "draining", "loading", "suspended"]))
            elif op == 4:
                w.annotate(TPUJob, "job-0", C.JOB_STATE_ANNOTATION,
                           rng.choice(["admitted", "running", "checkpointing", "preempted"]))
            elif op == 5:
                w.annotate(Notebook, f"nb-{rng.randrange(3)}", C.LAST_ACTIVITY_ANNOTATION,
                           iso(max(0.0, w.clock.t - rng.randrange(300))))
            w.clock.advance(rng.choice([1.0, 3.0, 7.0]))
            banked.append(armed_tick(w.acct))
        out = w.ledger()
        out.update(banked=banked, wall=w.clock.t,
                   gpu_nodes=sorted(n.metadata.name for n in w.client.list(w.side.core.Node)
                                    if int(n.status.capacity.get(w.side.device_resource, "0") or 0) > 0))
        return out

    port = on_both(scenario, slices=6)
    cons = port["conservation"]
    assert cons["physical_chip_seconds"] == pytest.approx(6 * CHIPS_PER_SLICE * port["wall"])
    assert cons["residual_ratio"] < 1e-6
    assert sorted(a[0] for a in port["attributions"]) == port["gpu_nodes"]


# ---------------------------------------------------------------------------
# the armed conservation check: doctored books caught red; disarmed inert
# ---------------------------------------------------------------------------


def _doctor_double_count(acct):
    real = acct.classify

    def doctored(now=None):
        attrs = real(now)
        return attrs + [attrs[0]]  # first node banked twice

    acct.classify = doctored


def _raised(w, tick):
    """tick() under INVCHECK: the violation's invariant and message, or
    None when it ticked through."""
    try:
        tick()
    except INVCHECK[w.side.name].InvariantViolation as e:
        return str(e)
    return None


def test_armed_check_catches_doctored_double_count(monkeypatch):
    monkeypatch.setenv("INVCHECK", "1")

    def scenario(w):
        w.acct.tick()
        w.clock.advance(5.0)
        honest = _raised(w, w.acct.tick)
        _doctor_double_count(w.acct)
        w.clock.advance(5.0)
        return {"honest": honest, "doctored": _raised(w, w.acct.tick)}

    port = on_both(scenario)
    assert port["honest"] is None
    assert "chip-conservation" in port["doctored"] and "double-counted" in port["doctored"]


def test_armed_check_catches_unknown_phase(monkeypatch):
    monkeypatch.setenv("INVCHECK", "1")

    def scenario(w):
        real, Attribution = w.acct.classify, w.accounting.Attribution
        w.acct.classify = lambda now=None: [Attribution(a.node, a.chips, a.workload_class, a.obj, "vibing")
                                            for a in real(now)]
        w.acct.tick()
        w.clock.advance(5.0)
        return _raised(w, w.acct.tick)

    port = on_both(scenario)
    assert "chip-conservation" in port and "unknown phase 'vibing'" in port


def test_disarmed_check_is_inert(monkeypatch):
    monkeypatch.delenv("INVCHECK", raising=False)

    def scenario(w):
        w.acct.tick()
        _doctor_double_count(w.acct)
        w.clock.advance(5.0)
        return w.acct.tick()

    assert on_both(scenario) == 4 * 5.0 * CHIPS_PER_SLICE  # 3 slices, one banked twice


# ---------------------------------------------------------------------------
# the incident bundle's accounting block
# ---------------------------------------------------------------------------


def test_incident_bundle_freezes_accounting_snapshot():
    def scenario(w):
        w.add_notebook("nb-f")
        w.bind_pod("nb-f-pod", "acct-0", w.C.NOTEBOOK_NAME_LABEL, "nb-f")
        w.acct.tick()
        w.tick_to(10)
        rec = RECORDER[w.side.name].FlightRecorder()
        rec.record("slice.degraded", notebook="t/nb-f", cause="test")
        # the handle is the process's: a test run before in this process may
        # have left its accountant installed
        installed = w.accounting.current()
        w.accounting.set_current(None)
        try:
            before = rec.get(rec.snapshot("no-accountant", subject="fleet"))
            w.accounting.set_current(w.acct)
            bundle = rec.get(rec.snapshot("fleet-utilization", subject="fleet"))
        finally:
            w.accounting.set_current(installed)
        frozen = dict(bundle["accounting"])
        # the goodput views are the process's ledgers, fed by whatever ran
        # before in this process: the keys are compared, not the totals
        views = frozen.pop("goodput_views")
        return {"before": "accounting" in before, "accounting": frozen,
                "views": {k: sorted(v) for k, v in views.items()}}

    port = on_both(scenario)
    assert port["before"] is False
    assert port["accounting"]["ticks"] == 2
    assert port["accounting"]["chip_seconds"]["residual_ratio"] == 0.0
    assert port["accounting"]["chip_seconds"]["by_class"] == {"notebook": 10 * CHIPS_PER_SLICE,
                                                              "pool": 20 * CHIPS_PER_SLICE}


# ---------------------------------------------------------------------------
# goodput views over the shared ledgers
# ---------------------------------------------------------------------------


def test_job_goodput_reset_between_runs():
    got = {}
    for side in (JAX, PORT):
        jm = side.jm
        jm.reset_for_test()
        try:
            jm.record_job_outcome(50.0, 100.0)
            half = jm.tpu_job_goodput_ratio.value()
            jm.reset_for_test()
            cleared = jm.tpu_job_goodput_ratio.series()
            jm.record_job_outcome(100.0, 100.0)
            got[side.name] = (half, cleared, jm.tpu_job_goodput_ratio.value(),
                              ACCOUNTING[side.name].job_goodput.totals())
        finally:
            jm.reset_for_test()
    assert got["jax"] == got["port"] == (0.5, [], 1.0, (100.0, 100.0))


def test_slice_goodput_view_over_shared_ledger():
    def scenario(w):
        telemetry = w.side.telemetry
        telemetry.goodput.reset_for_test()
        try:
            telemetry.goodput.observe(100.0, downtime_s=20.0)
            views = w.acct.snapshot()["goodput_views"]["slice"]  # the job view is the process's
            ratio = telemetry.slice_goodput_ratio.value()
            telemetry.goodput.reset_for_test()
            return {"ratio": ratio, "views": views, "cleared": telemetry.slice_goodput_ratio.series()}
        finally:
            telemetry.goodput.reset_for_test()

    port = on_both(scenario, slices=1)
    assert port["ratio"] == pytest.approx(0.8) and port["cleared"] == []
    assert port["views"]["ratio"] == pytest.approx(0.8)
    assert port["views"]["observed_s"] == pytest.approx(100.0)


DEBUG_RENAMES = (
    ('add_tpu_pool("acct", "v5e", "2x2", slices=slices)', 'add_gpu_pool("acct", "h100", "1x4", slices=slices)'),
    ("from odh_kubeflow_tpu_torch.tpu import TPU_RESOURCE", "from odh_kubeflow_tpu_torch.gpu import GPU_RESOURCE as TPU_RESOURCE"),
)
DEBUG_JAX = torch_ported.load("test_accounting", "jax")
DEBUG_PORT = torch_ported.load("test_accounting", "port", renames=DEBUG_RENAMES)


@pytest.mark.parametrize("case", ["test_debug_accounting_serves_ledger",
                                  "test_debug_accounting_falls_back_to_module_handle",
                                  "test_debug_accounting_bad_args_and_disabled", "test_debug_index_links_accounting"])
def test_debug_accounting_case_against_the_reference(case, tmp_path):
    torch_ported.both(DEBUG_JAX, DEBUG_PORT, case, tmp_path)
