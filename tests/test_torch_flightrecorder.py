"""The port's flight recorder (runtime/flightrecorder.py), its state
machines as data (analysis/machines.py) and the INVCHECK machine-transition
invariant (utils/invcheck.py), against the JAX package's, on the CPU.

- One script of records, spans and snapshots gives, on both sides, bundles
  with the same keys, reasons and subjects, the same records, the same
  dedup within the window and the same cap on bundles.
- The port's MACHINES and ALL_MACHINES equal the reference's field for
  field. The prose of two docs differs: the reference's names the tracker entry
  that grew the inference machine, which the port's copy leaves out.
- With INVCHECK armed, the port's store raises at an undeclared
  repair-state write (the monitor judges each write as it lands) and
  accepts the repair controller's own transitions, through a whole
  preemption episode.
"""
import dataclasses
import re

import pytest

import torch_threads
from torch_sides import JAX, PORT, wait_for

import odh_kubeflow_tpu.analysis.machines as j_machines
import odh_kubeflow_tpu.runtime.flightrecorder as j_fr
import odh_kubeflow_tpu_torch.analysis.machines as p_machines
import odh_kubeflow_tpu_torch.runtime.flightrecorder as p_fr

torch_threads.cap()

NS = "fr"


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _script(fr_module, side):
    """The same sequence on one side: records, two notebooks' bundles with
    their CR/pod state, a repeat inside the dedup window, one after it, and
    more bundles than the cap holds."""
    clock = Clock()
    rec = fr_module.FlightRecorder(capacity=8, max_incidents=3, snapshot_records=4, dedup_window_s=10.0,
                                   clock=clock)
    store = side.cluster.Store()
    client = side.cluster.Client(store)
    nb = side.nb.Notebook()
    nb.metadata.name, nb.metadata.namespace = "nb", NS
    nb.spec.template.spec.containers = [side.core.Container(name="nb", image="img:1")]
    client.create(nb)
    pod = side.core.Pod()
    pod.metadata.name, pod.metadata.namespace = "nb-0", NS
    pod.metadata.labels = {side.C.NOTEBOOK_NAME_LABEL: "nb"}
    pod.spec.containers = [side.core.Container(name="nb", image="img:1")]
    client.create(pod)
    for i in range(10):
        clock.t += 1
        rec.record("transition", machine="slice-repair", notebook=f"{NS}/nb", step=i)
    rec.record("reconcile", controller="notebook", key=f"{NS}/nb", outcome="ok")
    out = {"ring": [(r["t"], r["kind"], r.get("step")) for r in rec.records()], "len": len(rec),
           "transitions": len(rec.records("transition"))}
    ids = [rec.snapshot("slice-degraded", subject=f"{NS}/nb", client=client, notebooks=[(NS, "nb")],
                        extra={"cause": "HostPreempted"})]
    clock.t += 5
    ids.append(rec.snapshot("slice-degraded", subject=f"{NS}/nb"))  # inside the window: the same bundle
    clock.t += 6
    ids.append(rec.snapshot("slice-degraded", subject=f"{NS}/nb"))  # past it: a new one
    ids += [rec.snapshot("repair-failed", subject=f"{NS}/nb-{i}") for i in range(3)]
    out.update({
        "ids": ids, "incidents": rec.incidents(), "evicted": rec.get(ids[0]) is None,
        "last bundle keys": sorted(rec.get(ids[-1])),
    })
    rec2 = fr_module.FlightRecorder(clock=clock)
    for i in range(3):
        rec2.record("transition", step=i)
    bundle = rec2.get(rec2.snapshot("slice-degraded", subject=f"{NS}/nb", client=client, notebooks=[(NS, "nb")],
                                    extra={"cause": "HostPreempted"}))
    state = bundle["state"][f"{NS}/nb"]
    out["bundle"] = {"keys": sorted(bundle), "reason": bundle["reason"], "subject": bundle["subject"],
                     "records": [(r["kind"], r["step"]) for r in bundle["records"]], "extra": bundle["extra"],
                     "state keys": sorted(state), "notebook": state["notebook"]["metadata"]["name"],
                     "pods": [p["metadata"]["name"] for p in state["pods"]]}
    rec2.set_enabled(False)
    rec2.record("transition", step=99)
    out["disabled"] = (rec2.snapshot("x"), len(rec2.records()))
    rec2.clear()
    out["cleared"] = (len(rec2), rec2.incidents())
    return out


def test_same_script_same_bundles(monkeypatch):
    # each recorder adds an `accounting` block when its package's chip
    # accountant is installed process-wide (runtime/accounting.set_current,
    # which build_manager calls), and the port's a `cpprofile` block when
    # CPPROFILE is armed and its profiler holds data; a test run before this
    # one in the same process may have left either behind. The script runs
    # with no accountant installed on either side and CPPROFILE unset
    import odh_kubeflow_tpu.runtime.accounting as j_accounting
    import odh_kubeflow_tpu_torch.runtime.accounting as p_accounting

    monkeypatch.setattr(j_accounting, "_current", None)
    monkeypatch.setattr(p_accounting, "_current", None)
    monkeypatch.delenv("CPPROFILE", raising=False)
    jax, port = _script(j_fr, JAX), _script(p_fr, PORT)
    assert jax == port
    assert port["ids"][:2] == ["inc-0001", "inc-0001"] and port["ids"][2] == "inc-0002"
    assert [i["reason"] for i in port["incidents"]] == ["repair-failed"] * 3 and port["evicted"]
    assert port["bundle"]["pods"] == ["nb-0"] and port["bundle"]["records"] == [("transition", i) for i in range(3)]
    assert port["len"] == 8 and port["disabled"] == (None, 3) and port["cleared"] == (0, [])


def test_spans_and_log_records_reach_the_ring():
    """Every span either side records lands in that side's global ring with
    its name, duration and attributes; a log handler mirrors records."""
    import logging

    out = {}
    for side, fr_module in ((JAX, j_fr), (PORT, p_fr)):
        side.tracing.record_span("fr.test", start_time=10.0, end_time=10.25, notebook="nb", step=3)
        span = [r for r in fr_module.recorder.records("span") if r["name"] == "fr.test"][-1]
        log = logging.getLogger(f"fr-test-{side.name}")
        handler = fr_module.recorder.log_handler()
        log.addHandler(handler)
        try:
            log.warning("slice %s degraded", "nb")
        finally:
            log.removeHandler(handler)
        logged = [r for r in fr_module.recorder.records("log") if r.get("logger") == log.name][-1]
        out[side.name] = {"span": {k: span[k] for k in ("kind", "name", "duration_ms", "attributes")},
                          "span keys": sorted(span), "log": (logged["message"], logged["level"]),
                          "log keys": sorted(logged)}
    assert out["jax"] == out["port"], out
    assert out["port"]["span"]["attributes"] == {"notebook": "nb", "step": 3}


def _prose(text):
    """The reference's docs, without the tracker number the port's copy leaves out."""
    return re.sub(r" \([A-Z]+ \d+\)", "", re.sub(r"[A-Z]+ \d+ grows the machine", "The machine has", text))


def _fields(spec, prose=lambda t: t):
    d = dataclasses.asdict(spec)
    d["doc"] = prose(d["doc"])
    for s in d["states"]:
        s["doc"] = prose(s["doc"])
    return d


def test_machines_equal_the_reference_field_for_field():
    assert len(p_machines.ALL_MACHINES) == len(j_machines.ALL_MACHINES) == 6
    for theirs, ours in zip(j_machines.ALL_MACHINES, p_machines.ALL_MACHINES):
        assert _fields(ours) == _fields(theirs, _prose), theirs.name
    assert [m.name for m in p_machines.MACHINES] == [m.name for m in j_machines.MACHINES]
    assert all(p_machines.spec_errors(m) == () for m in p_machines.ALL_MACHINES)
    for spec in p_machines.ALL_MACHINES:
        assert p_machines.machine_for_annotation(spec.annotation) is (spec if spec in p_machines.MACHINES else None)
    assert p_machines.render_markdown().count("####") == 6


@pytest.fixture()
def armed(monkeypatch):
    monkeypatch.setenv("INVCHECK", "1")


def test_invcheck_rejects_an_undeclared_repair_state_write(armed):
    from odh_kubeflow_tpu_torch.api.core import Container
    from odh_kubeflow_tpu_torch.api.notebook import Notebook
    from odh_kubeflow_tpu_torch.cluster import Client, Store
    from odh_kubeflow_tpu_torch.controllers import constants as C
    from odh_kubeflow_tpu_torch.utils.invcheck import InvariantViolation

    store = Store()
    assert store.invariants is not None and "machine-transition" in store.invariants.checks
    client = Client(store)
    nb = Notebook()
    nb.metadata.name, nb.metadata.namespace = "nb", NS
    nb.spec.template.spec.containers = [Container(name="nb", image="img:1")]
    client.create(nb)

    def write(value):
        client.patch(Notebook, NS, "nb", {"metadata": {"annotations": {C.TPU_REPAIR_STATE_ANNOTATION: value}}})

    with pytest.raises(InvariantViolation, match="slice-repair machine: .* 'rest' -> 'failed'"):
        write("failed")  # no edge from rest to failed
    with pytest.raises(InvariantViolation, match="undeclared state value 'bogus'"):
        write("bogus")
    for value in ("degraded", "repairing", "failed", None):  # the controller's own path, and the self-heal
        write(value)
    with pytest.raises(InvariantViolation, match="'rest' -> 'repairing'"):
        write("repairing")


def test_invcheck_accepts_the_repair_controllers_episode(armed):
    """A whole preemption episode (degraded -> repairing -> rest) under an
    armed store: no write of the controller is refused."""
    from odh_kubeflow_tpu_torch.api.core import Container, Pod
    from odh_kubeflow_tpu_torch.api.notebook import Notebook, TPUSpec
    from odh_kubeflow_tpu_torch.cluster import SimCluster
    from odh_kubeflow_tpu_torch.controllers import (
        Config, NotebookReconciler, ProbeStatusController, SliceRepairController, constants as C)
    from odh_kubeflow_tpu_torch.probe.behavior import sim_agent_behavior
    from odh_kubeflow_tpu_torch.runtime import Manager

    cluster = SimCluster().start()
    mgr = Manager(cluster.store)
    try:
        assert cluster.store.invariants is not None
        cluster.add_gpu_pool("h100", "h100", "1x4", slices=2)
        cfg = Config(readiness_probe_period_s=0.15, checkpoint_window_s=1.0, repair_backoff_s=30.0,
                     repair_backoff_max_s=30.0)
        NotebookReconciler(mgr, cfg).setup()
        ProbeStatusController(mgr, cfg, http_get=cluster.http_get).setup()
        repair = SliceRepairController(mgr, cfg, http_get=cluster.http_get)
        repair.unreachable_dwell_s = 30.0
        repair.setup()
        agents = {}
        cluster.add_pod_behavior(sim_agent_behavior(agents, duty=0.9, kernels_busy=True))
        mgr.start()
        nb = Notebook()
        nb.metadata.name, nb.metadata.namespace = "armed", NS
        nb.spec.template.spec.containers = [Container(name="armed", image="img:1")]
        nb.spec.tpu = TPUSpec(accelerator="h100", topology="1x4")
        cluster.client.create(nb)

        def get():
            return cluster.client.get(Notebook, NS, "armed")

        wait_for(lambda: get().status.tpu is not None and get().status.tpu.mesh_ready, msg="bring-up")
        agents["armed-0"].checkpoint_hook = lambda: {"step": 7}
        cluster.preempt_node(cluster.client.get(Pod, NS, "armed-0").spec.node_name, grace_s=10.0)
        wait_for(lambda: get().metadata.annotations.get(C.TPU_CHECKPOINT_SAVED_ANNOTATION) == "7"
                 and C.TPU_REPAIR_STATE_ANNOTATION not in get().metadata.annotations
                 and get().status.tpu.mesh_ready, msg="repaired under INVCHECK")
        assert mgr.healthz()
    finally:
        mgr.stop()
        cluster.stop()
