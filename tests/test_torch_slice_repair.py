"""The port's slice repair (controllers/slice_repair.py, the fault injector,
the flight recorder's incident bundles, the repair telemetry) against the
JAX package's, on the CPU: every scenario of tests/test_slice_repair.py,
each run through both SimClusters at once (tests/torch_sides.py).

The slices are paired by hosts: JAX v5p 2x2x2 (2 hosts x 4 chips, two pools
of it for the fallback) against port h100 2x4 (2 hosts x 4 cards, two
pools), JAX v5e 2x2 against port h100 1x4, each pod pinned to its pool's
slice shape (tests/torch_sides.py). For each scenario both sides
give the same repair-state annotation values and `Degraded` (status, reason)
values in the same order of first appearance, the same events' reasons,
the same `checkpoint-saved`, the same slice.checkpoint / slice.repair /
slice.reschedule spans (names, cause, hosts acked, attempts, result), the
same deltas of the tpu_slice_* counters and the same incident bundles'
reasons. Timestamps and durations are not compared; each side's MTTR must
be positive and no longer than the episode's wall time.

Where a scenario compares the repair's `attempts`, its config holds the
first retry window far past the re-placement (STEADY), so the count does
not depend on how fast a loaded test machine brings the new gang up; the
exhaustion scenario keeps the reference's short backoff, where every window
counts by construction. The scenarios compared event for event park the
HostUnreachable dwell (30 s), as the reference test does for its
preemption case: a stale status mirror can re-write an old unreachable
verdict after the repair, which would open a second episode on one side
only. The seeded bad day keeps the reference's 0.6 s dwell and is compared
on its end state.
"""
import time

import pytest

import torch_threads
from torch_sides import Sequences, both, wait_for

torch_threads.cap()

NS = "repair"

FAST = dict(readiness_probe_period_s=0.15, checkpoint_window_s=1.0, repair_max_attempts=4,
            repair_backoff_s=0.3, repair_backoff_max_s=1.0)
STEADY = dict(FAST, repair_backoff_s=30.0, repair_backoff_max_s=30.0)
SPAN_KEYS = {"slice.checkpoint": ("notebook", "hosts_acked"),
             "slice.repair": ("notebook", "namespace", "cause", "attempts", "result"),
             "slice.reschedule": ("notebook",)}


class Env:
    """One side's cluster, the reference test's controllers and pools: two
    pools of the multi-host slice, three of the one-host slice."""

    def __init__(self, side, cfg, dwell_s):
        self.side, self.C = side, side.C
        # the tracing buffers are the process's: another test file run before
        # this one in the same process (the JAX package's own
        # tests/test_slice_repair.py names its notebooks alike) leaves spans
        # there, so a scenario reads only the spans that started after this
        self.started = time.time()
        self.cluster = side.cluster.SimCluster().start()
        for which, slices in (("multi-host", 2), ("one-host", 3)):
            accelerator, topology = side.slices[which]
            side.add_pool(self.cluster, f"{which}", accelerator, topology, slices=slices)
        self.mgr = side.runtime.Manager(self.cluster.store)
        config = side.ctrl.Config(**cfg)
        side.ctrl.NotebookReconciler(self.mgr, config).setup()
        side.ctrl.ProbeStatusController(self.mgr, config, http_get=self.cluster.http_get).setup()
        self.repair = side.ctrl.SliceRepairController(self.mgr, config, http_get=self.cluster.http_get)
        self.repair.unreachable_dwell_s = dwell_s
        self.repair.setup()
        self.agents = {}
        self.cluster.add_pod_behavior(side.behavior(self.agents, duty=0.9, kernels_busy=True))
        self.sequences = Sequences(self.cluster.store, self.C.TPU_REPAIR_STATE_ANNOTATION,
                                   self.C.TPU_DEGRADED_CONDITION)
        self.mgr.start()
        self.client = self.cluster.client

    def stop(self):
        try:
            self.sequences.stop()
            self.mgr.stop()
        finally:
            self.cluster.stop()
            self.cluster.faults.clear()

    # -- the reference test's helpers, on this side's types --
    def notebook(self, name, which="multi-host"):
        nb = self.side.nb.Notebook()
        nb.metadata.name, nb.metadata.namespace = name, NS
        nb.spec.template.spec.containers = [self.side.core.Container(name=name, image="img:1")]
        if which:
            accelerator, topology = self.side.slices[which]
            nb.spec.tpu = self.side.nb.TPUSpec(accelerator=accelerator, topology=topology)
        return self.client.create(nb)

    def get(self, name):
        return self.client.get(self.side.nb.Notebook, NS, name)

    def mesh_ready(self, name):
        nb = self.get(name)
        return nb.status.tpu is not None and nb.status.tpu.mesh_ready

    def condition(self, name, ctype):
        return next((c for c in self.get(name).status.conditions if c.type == ctype), None)

    def repaired(self, name):
        if self.C.TPU_REPAIR_STATE_ANNOTATION in self.get(name).metadata.annotations:
            return False
        c = self.condition(name, self.C.TPU_DEGRADED_CONDITION)
        return c is not None and c.status == "False" and self.mesh_ready(name)

    def degraded_is(self, name, status, reason=None):
        c = self.condition(name, self.C.TPU_DEGRADED_CONDITION)
        return c is not None and c.status == status and (reason is None or c.reason == reason)

    def pod_node(self, pod):
        return self.client.get(self.side.core.Pod, NS, pod).spec.node_name

    def node_pool(self, node):
        return self.client.get(self.side.core.Node, "", node).metadata.labels[self.side.pool_label]

    def nodes_of(self, which):
        return sorted(n.metadata.name for n in self.client.list(self.side.core.Node)
                      if n.metadata.labels.get(self.side.pool_label, "").startswith(which))

    def events(self, name):
        return sorted({e.reason for e in self.client.list(self.side.core.Event, namespace=NS)
                       if e.involved_object.kind == "Notebook" and e.involved_object.name == name})

    def counters(self):
        t = self.side.telemetry
        out = {f"interruptions {c}": t.slice_interruptions_total.value(cause=c)
               for c in ("HostPreempted", "ChipFailure", "ICIDegraded", "HostUnreachable")}
        out.update({f"repairs {r}": t.slice_repairs_total.value(result=r) for r in ("repaired", "failed")})
        out["checkpoint saves"] = t.slice_checkpoint_saves_total.value()
        out["mttr observations"] = t.slice_repair_duration_seconds._totals.get((), 0)  # both packages keep it there
        return out

    def spans(self, name):
        out = []
        for span_name, keys in SPAN_KEYS.items():
            for s in self.side.tracing.recent_spans(name=span_name):
                if s["attributes"].get("notebook") == name and s["start_time"] >= self.started:
                    out.append((span_name, tuple((k, s["attributes"].get(k)) for k in keys)))
        return sorted(out, key=repr)

    def mttrs(self, name):
        return [float(s["attributes"]["mttr_s"]) for s in self.side.tracing.recent_spans(name="slice.repair")
                if s["attributes"].get("notebook") == name and "mttr_s" in s["attributes"]
                and s["start_time"] >= self.started]

    def incidents(self, name):
        return sorted({i["reason"] for i in self.side.recorder.incidents() if i["subject"] == f"{NS}/{name}"})

    def caught_up(self, name):
        """The watch behind `sequences` has seen the notebook as it is now."""
        nb = self.get(name)
        c = next((c for c in nb.status.conditions if c.type == self.C.TPU_DEGRADED_CONDITION), None)
        return self.sequences.caught_up(name, nb.metadata.annotations.get(self.C.TPU_REPAIR_STATE_ANNOTATION, ""),
                                        None if c is None else (c.status, c.reason))

    def episode(self, name, before, t0):
        """What is compared of one notebook's repair episode."""
        wait_for(lambda: self.caught_up(name), msg=f"the watch to see {name} as it is")
        # the controller writes its terminal condition, then emits the event
        c = self.condition(name, self.C.TPU_DEGRADED_CONDITION)
        terminal = {("False", "Repaired"): "SliceRepaired", ("True", "RepairFailed"): "RepairFailed"}
        want = terminal.get((c.status, c.reason)) if c is not None else None
        if want:
            wait_for(lambda: want in self.events(name), msg=f"{name}'s {want} event")
        after = self.counters()
        wall = time.time() - t0
        mttrs = self.mttrs(name)
        assert mttrs and all(0 < m <= wall for m in mttrs), (self.side.name, mttrs, wall)
        return {"sequences": self.sequences.of(name), "events": self.events(name),
                "checkpoint-saved": self.get(name).metadata.annotations.get(self.C.TPU_CHECKPOINT_SAVED_ANNOTATION),
                "spans": self.spans(name), "counters": {k: after[k] - before[k] for k in after},
                "incidents": self.incidents(name), "healthy": self.mgr.healthz()}


def run_both(scenario, cfg=STEADY, dwell_s=30.0):
    return both(scenario, lambda side: Env(side, cfg, dwell_s), lambda env: env.stop())


def assert_same(got):
    assert got["jax"] == got["port"], got


# ---------------------------------------------------------------------------
# host preemption: taint + maintenance notice -> checkpoint -> gang moves pool
# ---------------------------------------------------------------------------


def test_host_preemption_checkpoints_and_reschedules_to_ready():
    def scenario(env):
        before = env.counters()
        env.notebook("trainer")
        wait_for(lambda: env.mesh_ready("trainer"), msg="first bring-up")
        hook_calls = []
        for i in range(2):
            env.agents[f"trainer-{i}"].checkpoint_hook = lambda: hook_calls.append(1) or {"step": 42}
        victim = env.pod_node("trainer-0")
        old_pool = env.node_pool(victim)
        t0 = time.time()
        env.cluster.preempt_node(victim, grace_s=10.0)
        wait_for(lambda: env.degraded_is("trainer", "True"), msg="Degraded raised")
        wait_for(lambda: env.repaired("trainer"), msg="repaired to Ready")
        wait_for(lambda: env.degraded_is("trainer", "False", "Repaired"), msg="Degraded settled at Repaired")
        pools = {env.node_pool(env.pod_node(f"trainer-{i}")) for i in range(2)}
        ann = env.get("trainer").metadata.annotations
        out = env.episode("trainer", before, t0)
        out.update(hooks_driven=bool(hook_calls), moved=old_pool not in pools, one_pool=len(pools) == 1,
                   wound_down=[k for k in (env.C.TPU_REPAIR_STATE_ANNOTATION, env.C.TPU_REPAIR_STARTED_ANNOTATION,
                                           env.C.TPU_CHECKPOINT_REQUEST_ANNOTATION) if k in ann])
        return out

    got = run_both(scenario)
    assert_same(got)
    port = got["port"]
    assert port["hooks_driven"] and port["moved"] and port["one_pool"] and port["wound_down"] == []
    assert port["checkpoint-saved"] == "42"
    assert port["sequences"]["annotation"] == ["", "degraded", "repairing", ""]
    assert port["sequences"]["condition"][0] == ("True", "HostPreempted")
    assert port["sequences"]["condition"][-1] == ("False", "Repaired")
    assert {"SliceDegraded", "SliceRepairing", "SliceRepaired"} <= set(port["events"])
    assert port["counters"]["interruptions HostPreempted"] == 1 and port["counters"]["repairs repaired"] == 1
    assert port["counters"]["checkpoint saves"] == 2 and port["incidents"] == ["slice-degraded"]
    assert ("slice.repair", (("notebook", "trainer"), ("namespace", NS), ("cause", "HostPreempted"),
                             ("attempts", "1"), ("result", "repaired"))) in port["spans"]


def test_drain_without_repair_controller_still_detected_via_node_signal():
    """The grace window lapses before the evict (tiny grace): the drain and
    the node-level detection still converge to Ready."""
    def scenario(env):
        before = env.counters()
        env.notebook("rushed")
        wait_for(lambda: env.mesh_ready("rushed"), msg="bring-up")
        t0 = time.time()
        env.cluster.preempt_node(env.pod_node("rushed-0"), grace_s=0.05)
        wait_for(lambda: env.repaired("rushed"), msg="repaired after drain")
        out = env.episode("rushed", before, t0)
        # which hosts were still up when the window closed races the drain
        out["spans"] = [s for s in out["spans"] if s[0] != "slice.checkpoint"]
        return out

    got = run_both(scenario)
    assert_same(got)
    assert got["port"]["counters"]["repairs repaired"] == 1 and got["port"]["healthy"]


# ---------------------------------------------------------------------------
# device faults: card loss and link degradation through the probe agent
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fault", ["chip failure", "link degradation"])
def test_device_fault_flags_unhealthy_and_repairs(fault):
    name = {"chip failure": "chippy", "link degradation": "icy"}[fault]
    reason = {"chip failure": "ChipFailure", "link degradation": "ICIDegraded"}[fault]

    def scenario(env):
        before = env.counters()
        env.notebook(name, "one-host")
        wait_for(lambda: env.mesh_ready(name), msg="bring-up")
        t0 = time.time()
        if fault == "chip failure":
            env.agents[f"{name}-0"].monitor.chips = 2  # the host stops seeing half its cards
        else:
            env.agents[f"{name}-0"].monitor.ici_fault = True
        wait_for(lambda: (c := env.condition(name, env.C.TPU_HEALTHY_CONDITION)) is not None
                 and c.status == "False" and c.reason == reason, msg=f"TPUHealthy False ({reason})")
        wait_for(lambda: env.repaired(name), msg="repaired")
        healthy = env.condition(name, env.C.TPU_HEALTHY_CONDITION)
        out = env.episode(name, before, t0)
        out["healthy after"] = (healthy.status, healthy.reason)
        return out

    got = run_both(scenario)
    assert_same(got)
    port = got["port"]
    assert port["healthy after"][0] == "True" and port["counters"][f"interruptions {reason}"] == 1
    assert port["sequences"]["condition"][0] == ("True", reason)
    assert port["incidents"] == ["slice-degraded"]


# ---------------------------------------------------------------------------
# exhaustion: no capacity anywhere -> explicit terminal RepairFailed
# ---------------------------------------------------------------------------


def test_repair_exhaustion_emits_terminal_repair_failed():
    def scenario(env):
        before = env.counters()
        env.notebook("doomed")
        wait_for(lambda: env.mesh_ready("doomed"), msg="bring-up")
        nodes = env.nodes_of("multi-host")
        assert len(nodes) == 4
        t0 = time.time()
        for node in nodes:
            env.cluster.preempt_node(node, grace_s=0.1)
        wait_for(lambda: "RepairFailed" in env.events("doomed"), msg="RepairFailed event")
        state = env.get("doomed").metadata.annotations.get(env.C.TPU_REPAIR_STATE_ANNOTATION)
        wait_for(lambda: env.degraded_is("doomed", "True", "RepairFailed"), msg="Degraded at RepairFailed")
        for node in nodes:
            env.cluster.restore_node(node)
        wait_for(lambda: env.repaired("doomed"), timeout=40, msg="recovered after capacity returned")
        out = env.episode("doomed", before, t0)
        out["state when failed"] = state
        return out

    got = run_both(scenario, cfg=FAST)
    assert_same(got)
    port = got["port"]
    assert port["state when failed"] == "failed"
    assert port["sequences"]["annotation"] == ["", "degraded", "repairing", "failed", ""]
    assert port["counters"]["repairs failed"] == 1 and port["counters"]["repairs repaired"] == 1
    assert port["incidents"] == ["repair-failed", "slice-degraded"]
    assert {("slice.repair", (("notebook", "doomed"), ("namespace", NS), ("cause", "HostPreempted"),
                              ("attempts", None), ("result", "failed"))),
            ("slice.repair", (("notebook", "doomed"), ("namespace", NS), ("cause", "HostPreempted"),
                              ("attempts", "4"), ("result", "repaired-after-failure")))} <= set(port["spans"])


# ---------------------------------------------------------------------------
# goodput integrator: the downtime integral matches the episode's clock
# ---------------------------------------------------------------------------


def test_goodput_integrator_matches_episode_downtime():
    def scenario(env):
        before = env.counters()
        ledger = env.side.telemetry.goodput._ledger
        env.notebook("gp")
        wait_for(lambda: env.mesh_ready("gp"), msg="bring-up")
        time.sleep(0.5)  # settle: the healthy pre-fault interval is observed uptime
        good0, observed0 = ledger.totals()
        t0 = time.time()
        env.cluster.preempt_node(env.pod_node("gp-0"), grace_s=5.0)
        wait_for(lambda: env.repaired("gp"), msg="repaired")
        time.sleep(0.5)  # one more calm reconcile closes out the last interval
        good1, observed1 = ledger.totals()
        mttr = env.mttrs("gp")[-1]
        downtime = (observed1 - good1) - (observed0 - good0)
        ratio = env.side.telemetry.slice_goodput_ratio.value()
        out = env.episode("gp", before, t0)
        out["goodput"] = {"tracks the episode": mttr * 0.5 - 0.5 <= downtime <= mttr * 1.5 + 1.0,
                          "healthy time is uptime": observed1 - observed0 > downtime,
                          "ratio in [0, 1]": 0.0 <= ratio <= 1.0}
        return out

    got = run_both(scenario)
    assert_same(got)
    assert all(got["port"]["goodput"].values()), got["port"]["goodput"]


# ---------------------------------------------------------------------------
# notebooks without a slice are never touched
# ---------------------------------------------------------------------------


def test_cpu_notebook_untouched_by_repair():
    def scenario(env):
        env.cluster.add_cpu_pool("cpu", nodes=1)
        env.notebook("plain", which=None)
        wait_for(lambda: env.get("plain").status.ready_replicas == 1, msg="cpu notebook ready")
        time.sleep(0.5)
        return {"annotated": env.C.TPU_REPAIR_STATE_ANNOTATION in env.get("plain").metadata.annotations,
                "degraded": env.condition("plain", env.C.TPU_DEGRADED_CONDITION),
                "sequences": env.sequences.of("plain")}

    got = run_both(scenario)
    assert_same(got)
    assert got["port"] == {"annotated": False, "degraded": None,
                           "sequences": {"annotation": [""], "condition": []}}


# ---------------------------------------------------------------------------
# the seeded slice bad day: zero silently stuck notebooks
# ---------------------------------------------------------------------------

SOAK = (("s-pod-0", "multi-host"), ("s-pod-1", "multi-host"), ("s-nb-0", "one-host"), ("s-nb-1", "one-host"))


def _slice_soak(seed):
    def scenario(env):
        before = env.counters()
        for name, which in SOAK:
            env.notebook(name, which)
        for name, _ in SOAK:
            wait_for(lambda n=name: env.mesh_ready(n), msg=f"{name} up")
        pod_nodes = {p.metadata.name: p.spec.node_name for p in env.client.list(env.side.core.Pod, namespace=NS)
                     if p.spec.node_name and p.metadata.labels.get(env.C.NOTEBOOK_NAME_LABEL)}
        t0 = time.time()
        plan = env.side.cluster.seeded_slice_bad_day(env.cluster, seed=seed, pod_nodes=pod_nodes,
                                                     agents=env.agents, grace_s=0.4)
        assert plan["preempted"], "the seeded schedule must preempt something"
        time.sleep(1.5)  # maintenance ends: repairs can land without a free fallback pool
        for node in plan["preempted"]:
            env.cluster.restore_node(node)

        def settled(name):
            state = env.get(name).metadata.annotations.get(env.C.TPU_REPAIR_STATE_ANNOTATION, "")
            if state == "failed":
                return "RepairFailed" in env.events(name)
            if state:
                return False
            c = env.condition(name, env.C.TPU_DEGRADED_CONDITION)
            return env.mesh_ready(name) and (c is None or c.status == "False")

        retry = (env.side.am.ConflictError, env.side.am.TooManyRequestsError)
        for name, _ in SOAK:
            wait_for(lambda n=name: settled(n), timeout=60, retry=retry,
                     msg=f"{name} neither repaired nor explicitly RepairFailed")
        preempted_pods = sorted(p for p, node in pod_nodes.items() if node in plan["preempted"])
        touched = set(plan["chip_loss"] + plan["ici"]) | set(preempted_pods)
        healed = [n for n, _ in SOAK if any(p.startswith(n + "-") for p in touched)
                  and wait_for(lambda n=n: env.repaired(n), retry=retry, msg=f"{n} repaired")]
        spans = {s["attributes"].get("notebook") for s in env.side.tracing.recent_spans(name="slice.repair")}
        after = env.counters()
        return {"plan": {"preempted pods": preempted_pods, "chip_loss": plan["chip_loss"], "ici": plan["ici"]},
                "healed": healed, "healed without a trace": [n for n in healed if n not in spans],
                "mttr observations cover the healed": after["mttr observations"] - before["mttr observations"]
                >= len(healed),
                "goodput in [0, 1]": 0.0 <= env.side.telemetry.slice_goodput_ratio.value() <= 1.0,
                "slice-degraded bundle": any("slice-degraded" in env.incidents(n) for n, _ in SOAK),
                "healthy": env.mgr.healthz(), "wall": time.time() - t0}

    got = run_both(scenario, cfg=FAST, dwell_s=0.6)
    for side in got.values():
        side.pop("wall")
    assert_same(got)
    port = got["port"]
    assert port["plan"]["preempted pods"] and port["healed"] and port["healed without a trace"] == []
    assert port["mttr observations cover the healed"] and port["goodput in [0, 1]"]
    assert port["slice-degraded bundle"] and port["healthy"]


def test_seeded_slice_bad_day_no_silent_stuck():
    _slice_soak(seed=0x51CE)


@pytest.mark.slow
def test_slice_chaos_soak_second_seed():
    _slice_soak(seed=0xBAD51CE)
