"""The JAX package and the port side by side, for parity tests that run one
scenario through both SimClusters at once (tests/test_torch_slice_repair.py,
tests/test_torch_faults.py, tests/test_torch_inference.py,
tests/test_torch_slicepool.py, tests/test_torch_job.py).

Each side is a namespace of its package's modules under the same names, its
slice shapes paired by hosts: JAX v5p 2x2x2 (2 hosts x 4 chips) against
port h100 2x4 (2 hosts x 4 cards), JAX v5e 2x2 (1 host x 4 chips) against
port h100 1x4 (1 host x 4 cards). A one-host pod of 4 cards fits a node of
the 2x4 pools by its cards alone; it selects its pool's slice shape
(`gpu.GPU_TOPOLOGY_LABEL`, as the JAX side's select the TPU topology), so
it never takes the node a preempted gang falls back to. Every package has its own store, scheme, metric
registry, tracing buffer and flight recorder, so a scenario's deltas and
spans on one side are its own.
"""
import threading
import time
from types import SimpleNamespace

import odh_kubeflow_tpu.api.apps as j_apps
import odh_kubeflow_tpu.api.core as j_core
import odh_kubeflow_tpu.api.gateway as j_gateway
import odh_kubeflow_tpu.api.inference as j_inference
import odh_kubeflow_tpu.api.job as j_job
import odh_kubeflow_tpu.api.notebook as j_notebook
import odh_kubeflow_tpu.apimachinery as j_am
import odh_kubeflow_tpu.cluster as j_cluster
import odh_kubeflow_tpu.cluster.faults as j_faults
import odh_kubeflow_tpu.cluster.scheduler as j_scheduler
import odh_kubeflow_tpu.cluster.slicepool as j_slicepool
import odh_kubeflow_tpu.controllers as j_ctrl
import odh_kubeflow_tpu.probe as j_probe
import odh_kubeflow_tpu.runtime as j_runtime
import odh_kubeflow_tpu.runtime.breaker as j_breaker
import odh_kubeflow_tpu.runtime.flightrecorder as j_fr
import odh_kubeflow_tpu.runtime.jobmetrics as j_jm
import odh_kubeflow_tpu.runtime.metrics as j_rm
import odh_kubeflow_tpu.serving.metrics as j_sm
import odh_kubeflow_tpu.tpu as j_tpu
import odh_kubeflow_tpu.utils.tracing as j_tracing
import odh_kubeflow_tpu_torch.api.apps as p_apps
import odh_kubeflow_tpu_torch.api.core as p_core
import odh_kubeflow_tpu_torch.api.gateway as p_gateway
import odh_kubeflow_tpu_torch.api.inference as p_inference
import odh_kubeflow_tpu_torch.api.job as p_job
import odh_kubeflow_tpu_torch.api.notebook as p_notebook
import odh_kubeflow_tpu_torch.apimachinery as p_am
import odh_kubeflow_tpu_torch.cluster as p_cluster
import odh_kubeflow_tpu_torch.cluster.faults as p_faults
import odh_kubeflow_tpu_torch.cluster.scheduler as p_scheduler
import odh_kubeflow_tpu_torch.cluster.slicepool as p_slicepool
import odh_kubeflow_tpu_torch.controllers as p_ctrl
import odh_kubeflow_tpu_torch.gpu as p_gpu
import odh_kubeflow_tpu_torch.probe.behavior as p_probe
import odh_kubeflow_tpu_torch.runtime as p_runtime
import odh_kubeflow_tpu_torch.runtime.breaker as p_breaker
import odh_kubeflow_tpu_torch.runtime.flightrecorder as p_fr
import odh_kubeflow_tpu_torch.runtime.jobmetrics as p_jm
import odh_kubeflow_tpu_torch.runtime.metrics as p_rm
import odh_kubeflow_tpu_torch.serving.metrics as p_sm
import odh_kubeflow_tpu_torch.telemetry as p_telemetry
import odh_kubeflow_tpu_torch.utils.tracing as p_tracing

JAX = SimpleNamespace(
    name="jax", apps=j_apps, core=j_core, nb=j_notebook, inference=j_inference, gateway=j_gateway, slicepool=j_slicepool,
    job=j_job, jm=j_jm, scheduler=j_scheduler, sm=j_sm, am=j_am, cluster=j_cluster, faults=j_faults, ctrl=j_ctrl,
    C=j_ctrl.constants, runtime=j_runtime, rm=j_rm, breaker=j_breaker, recorder=j_fr.recorder, telemetry=j_tpu.telemetry,
    tracing=j_tracing, behavior=j_probe.sim_agent_behavior, pool_label=j_tpu.GKE_NODEPOOL_LABEL,
    device_resource=j_tpu.TPU_RESOURCE, selector_keys=(j_tpu.GKE_TPU_ACCELERATOR_LABEL, j_tpu.GKE_TPU_TOPOLOGY_LABEL),
    accelerator_label=j_tpu.GKE_TPU_ACCELERATOR_LABEL,
    plan_slice=j_tpu.plan_slice,
    slices={"multi-host": ("v5p", "2x2x2"), "one-host": ("v5e", "2x2")},
    add_pool=lambda cluster, *a, **kw: cluster.add_tpu_pool(*a, **kw),
)
PORT = SimpleNamespace(
    name="port", apps=p_apps, core=p_core, nb=p_notebook, inference=p_inference, gateway=p_gateway, slicepool=p_slicepool,
    job=p_job, jm=p_jm, scheduler=p_scheduler, sm=p_sm, am=p_am, cluster=p_cluster, faults=p_faults, ctrl=p_ctrl,
    C=p_ctrl.constants, runtime=p_runtime, rm=p_rm, breaker=p_breaker, recorder=p_fr.recorder, telemetry=p_telemetry,
    tracing=p_tracing, behavior=p_probe.sim_agent_behavior, pool_label=p_gpu.GKE_NODEPOOL_LABEL,
    device_resource=p_gpu.GPU_RESOURCE, selector_keys=(p_gpu.GKE_GPU_ACCELERATOR_LABEL, p_gpu.GPU_TOPOLOGY_LABEL),
    accelerator_label=p_gpu.GKE_GPU_ACCELERATOR_LABEL,
    plan_slice=p_gpu.plan_slice,
    slices={"multi-host": ("h100", "2x4"), "one-host": ("h100", "1x4")},
    add_pool=lambda cluster, *a, **kw: cluster.add_gpu_pool(*a, **kw),
)
SIDES = (JAX, PORT)


SCENARIO_LIMIT_S = 300.0  # a side still running past it fails the test instead of holding its worker


def both(scenario, make_env, stop_env, sides=SIDES):
    """Runs scenario(env) on the JAX side and the port side at once, each in
    its own env (`make_env(side)`, stopped by `stop_env(env)` in a
    `finally`); returns {"jax": result, "port": result}. `sides` are the
    two namespaces (tests/test_torch_operator.py passes its own). A side
    that has not finished within SCENARIO_LIMIT_S fails the test."""
    results, errors = {}, {}

    def run(side):
        env = None
        try:
            env = make_env(side)
            results[side.name] = scenario(env)
        except BaseException as e:  # re-raised in the test's thread
            errors[side.name] = e
        finally:
            if env is not None:
                stop_env(env)

    threads = [threading.Thread(target=run, args=(side,), daemon=True) for side in sides]
    for t in threads:
        t.start()
    deadline = time.monotonic() + SCENARIO_LIMIT_S
    for side, t in zip(sides, threads):
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            raise AssertionError(f"the {side.name} side did not finish its scenario in {SCENARIO_LIMIT_S} s")
    for name, e in errors.items():
        raise AssertionError(f"the {name} side failed: {e!r}") from e
    return results


def wait_for(fn, timeout=30.0, msg="condition", retry=()):
    """Polls fn until it returns something true; exceptions of the types in
    `retry` (transient injected faults on the test's own reads) count as
    not yet."""
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            out = fn()
            if out:
                return out
            last = out
        except retry as e:
            last = e
        time.sleep(0.05)
    raise AssertionError(f"timeout waiting for {msg}: last={last!r}")


class Sequences:
    """A store watch on Notebooks (or another kind) that keeps, per object, the values an
    annotation took (each change: one writer owns a state annotation) and
    the values a condition took in the order of their first appearance. A
    condition value that comes back (a stale status mirror re-writing an
    older condition, which the repair controller re-asserts over) adds
    nothing: what is compared is which values it went through, and in which
    order it first reached each."""

    def __init__(self, store, annotation, condition, kind="Notebook"):
        self.annotation, self.condition = annotation, condition
        self._watch = store.watch("kubeflow.org/v1beta1", kind)
        self._lock = threading.Lock()
        self._done = threading.Event()
        self.values = {}  # (notebook, "annotation" | "condition") -> [value, ...]
        self.latest = {}  # the same keys -> the value of the last event seen
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _add(self, key, value):
        self.latest[key] = value
        seen = self.values.setdefault(key, [])
        if (seen[-1:] if key[1] == "annotation" else seen).count(value) == 0:
            seen.append(value)

    def _note(self, ev):
        obj = ev.object
        meta = obj.get("metadata", {})
        name = meta.get("name")
        with self._lock:
            self._add((name, "annotation"), (meta.get("annotations") or {}).get(self.annotation, ""))
            cond = next((c for c in (obj.get("status") or {}).get("conditions") or []
                         if c.get("type") == self.condition), None)
            if cond is not None:
                self._add((name, "condition"), (cond.get("status"), cond.get("reason")))

    def _run(self):
        for ev in self._watch.pending:
            self._note(ev)
        while not self._done.is_set():
            ev = self._watch.get(timeout=0.05)
            if ev is not None:
                self._note(ev)

    def caught_up(self, name, annotation, condition):
        """The watch has seen the notebook with these values last."""
        with self._lock:
            return (self.latest.get((name, "annotation")) == annotation
                    and self.latest.get((name, "condition")) == condition)

    def of(self, name):
        with self._lock:
            return {"annotation": list(self.values.get((name, "annotation"), [])),
                    "condition": list(self.values.get((name, "condition"), []))}

    def stop(self):
        self._done.set()
        self._thread.join()
        self._watch.stop()
