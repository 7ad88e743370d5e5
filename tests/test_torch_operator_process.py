"""The port's operator with notebook pods that are real processes, on the
CPU (`probe.behavior.pod_process_behavior`, tests/torch_operator_flow.py):
a `torchrun` per pod from the env the reconciler rendered, running a tiny
worker on the CPU beside an agent over `SimTPUMonitor`, behind the port's
admission webhook and workbench extension. An unplannable slice is denied
at admission and leaves nothing behind; each notebook is admitted with the
lock and its readiness root's traceparent, gets its route and policies,
and is unlocked before it binds. The worker sees PET_STANDALONE,
PET_NPROC_PER_NODE and NB_TPU_CHIPS_EXPECTED as rendered; the gate opens
and closes the root; the cull terminates the pod's process group, no pid
left; the second notebook, Pending on the one-card pool, binds after the
cull; a deleted notebook takes its route and policies with it. A
preempted notebook is repaired onto another pool and resumed bit-equal,
also while its replacement's cards come up late. The promotion into an
InferenceEndpoint is tests/test_torch_promotion_process.py (a file of its
own, so that the test runner's workers share the process episodes). The
same flow runs on the card in tests/test_torch_cuda.py. Also the downward-API
resolution, the process stop and the cards a pod's process tree holds
under a CUDA context on their own (the gate's reading of one process's
mappings is tests/test_torch_gate.py)."""
import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

import torch_operator_flow
import torch_pod_worker
import torch_threads
from odh_kubeflow_tpu_torch.api.core import Container, EnvVar, EnvVarSource, Pod
from odh_kubeflow_tpu_torch.probe.agent import CudaMonitor, NotebookAgent, SimTPUMonitor
from odh_kubeflow_tpu_torch.probe.behavior import (
    PodProcesses,
    ProcessKernels,
    cards_in_context,
    container_env,
    cuda_monitor,
    process_tree,
)

torch_threads.cap()


def test_notebook_pods_as_processes_on_the_cpu(tmp_path):
    seen = torch_operator_flow.run(
        tmp_path, torch_operator_flow.pod_worker("cpu"),
        monitor=lambda pod, chips, procs: SimTPUMonitor(chips=chips, expected=chips, duty=0.0))
    torch_operator_flow.check(seen, "cpu")


def test_notebook_pod_preempted_checkpointed_and_resumed_on_the_cpu(tmp_path):
    """The flow's repair episode on the CPU: the worker trains a tiny model,
    its node is preempted, the SliceRepairController drives the forwarded
    /tpu/checkpoint, evicts the pod (its processes stop before its object
    goes), the replacement binds in the other pool, restores the acked
    checkpoint and takes the next step bit-equal to the first worker's."""
    seen = torch_operator_flow.run(
        tmp_path, torch_operator_flow.pod_worker("cpu"), waves=(("nb-r",),), repair="nb-r",
        monitor=lambda pod, chips, procs: SimTPUMonitor(chips=chips, expected=chips, duty=0.0))
    torch_operator_flow.check(seen, "cpu")
    assert seen["nb-r"]["repair"]["result"]["resumed"]["step"] == torch_pod_worker.REPAIR_STEPS + 1


def test_a_replacement_whose_cards_come_up_late_is_not_evicted(tmp_path):
    """The repair episode at Config's default backoff, each pod's card view
    empty for its first LAG_S seconds, as a pod's is on the card until its
    worker's CUDA context (`cuda_monitor`): the agent answers its readiness
    with 503 meanwhile, which the gate reads as a host coming up, not as a
    ChipFailure, and the controller waits for the replacement instead of
    evicting it again."""
    lag_s = 3.0

    def monitor(pod, chips, procs):
        started = time.monotonic()
        return CudaMonitor(chips_expected=chips, window_s=1.0, sample_period_s=0.25, device_reader=lambda: None,
                           utilization_reader=lambda: 0.0,
                           chips_reader=lambda: chips if time.monotonic() - started >= lag_s else 0)

    seen = torch_operator_flow.run(
        tmp_path, torch_operator_flow.pod_worker("cpu"), waves=(("nb-r",),), repair="nb-r", monitor=monitor)
    torch_operator_flow.check(seen, "cpu")
    r = seen["nb-r"]["repair"]
    assert r["mesh-ready again"] - r["rebound"] >= lag_s, r


def test_the_readiness_is_503_until_the_pods_cards_first_come_up():
    """cuda_monitor's agent over HTTP: 503 (the host coming up) until the
    pod's processes first hold their card, 200 and ready then, and 200
    with the card failed once it is lost after that (a ChipFailure)."""
    import json
    import urllib.error
    import urllib.request

    held = set()
    agent = NotebookAgent(monitor=cuda_monitor(window_s=1.0, sample_period_s=0.5)(
        None, 1, SimpleNamespace(cards=lambda: held)), kernels=ProcessKernels(lambda: None))
    host, port, close = agent.serve()

    def readiness():
        try:
            with urllib.request.urlopen(f"http://{host}:{port}/tpu/readiness", timeout=10) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        coming_up = readiness()
        held.add(0)
        up = readiness()
        held.clear()
        lost = readiness()
    finally:
        close()
    assert coming_up[0] == 503 and coming_up[1]["ready"] is False and "_status" not in coming_up[1], coming_up
    assert up == (200, {**up[1], "ready": True, "chips_visible": 1, "chips_failed": 0}), up
    assert lost == (200, {**lost[1], "ready": False, "chips_visible": 0, "chips_failed": 1}), lost


def test_container_env_resolves_field_refs():
    pod = Pod()
    pod.metadata.name, pod.metadata.namespace = "nb-1", "user"
    pod.metadata.labels = {"apps.kubernetes.io/pod-index": "1"}
    pod.spec.node_name = "h100-w1"
    c = Container(name="nb", env=[
        EnvVar(name="A", value="x"),
        EnvVar(name="PET_NODE_RANK", value_from=EnvVarSource(
            field_ref={"fieldPath": "metadata.labels['apps.kubernetes.io/pod-index']"})),
        EnvVar(name="POD", value_from=EnvVarSource(field_ref={"fieldPath": "metadata.name"})),
        EnvVar(name="NODE", value_from=EnvVarSource(field_ref={"fieldPath": "spec.nodeName"}))])
    assert container_env(pod, c) == {"A": "x", "PET_NODE_RANK": "1", "POD": "nb-1", "NODE": "h100-w1"}
    c.env.append(EnvVar(name="S", value_from=EnvVarSource(secret_key_ref={"name": "s", "key": "k"})))
    with pytest.raises(ValueError):
        container_env(pod, c)


def test_close_stops_a_tree_whose_children_left_the_group(tmp_path):
    """A child in a session of its own that ignores SIGTERM (as torchrun's
    workers run) is among the pids close() kills."""
    child = ("import os, signal, time; signal.signal(signal.SIGTERM, signal.SIG_IGN); os.setsid(); "
             "time.sleep(600)")
    parent = (f"import subprocess, sys, time; subprocess.Popen([sys.executable, '-c', {child!r}]); "
              "time.sleep(600)")
    procs = PodProcesses([sys.executable, "-c", parent], dict(os.environ), None, str(tmp_path / "log"), "n")
    deadline = time.monotonic() + 30
    while len(process_tree(procs.proc.pid)) < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    tree = process_tree(procs.proc.pid)
    assert len(tree) == 2
    procs.close(grace_s=1.0)
    procs.close(grace_s=1.0)  # idempotent
    for pid in tree:
        assert not os.path.exists(f"/proc/{pid}") or open(f"/proc/{pid}/stat").read().split(")")[-1].split()[0] == "Z"
    assert procs.closed and sorted(procs.pids) == sorted(tree)


def test_cards_held_are_the_device_nodes_the_pod_tree_holds_open(tmp_path):
    """A child of the pod mapping a card's node and the context node and
    running the driver's event thread (as a torchrun worker maps
    /dev/nvidiaN and /dev/nvidia-uvm under its CUDA context) counts that
    card; the same nodes mapped by a process outside
    the pod's tree do not; a stopped pod holds none."""
    for name in ("nvidia0", "nvidia3", "nvidia-uvm"):
        (tmp_path / name).write_bytes(b"\0")
    root = re.escape(str(tmp_path))
    node, context = re.compile(rf"^{root}/nvidia(\d+)$"), re.compile(rf"^{root}/nvidia-uvm$")

    def mapping(*names):
        return "; ".join(f"f{i} = open({str(tmp_path / n)!r}, 'r+b'); m{i} = mmap.mmap(f{i}.fileno(), 1)"
                         for i, n in enumerate(names))

    # and a thread named as the driver's event handler, which starts as a
    # CUDA context's creation ends
    named = ("import ctypes, threading; threading.Thread(target=lambda: (ctypes.CDLL(None).prctl("
             "15, b'cuda-EvtHandlr', 0, 0, 0), time.sleep(600)), daemon=True).start()")
    child = f"import mmap, time; {mapping('nvidia3', 'nvidia-uvm')}; {named}; time.sleep(600)"
    parent = f"import subprocess, sys, time; subprocess.Popen([sys.executable, '-c', {child!r}]); time.sleep(600)"
    outside = subprocess.Popen([sys.executable, "-c", f"import mmap, time; {mapping('nvidia0', 'nvidia-uvm')}; "
                                "time.sleep(600)"])
    try:
        procs = PodProcesses([sys.executable, "-c", parent], dict(os.environ), None, str(tmp_path / "log"), "n")
        try:
            deadline = time.monotonic() + 30
            while not cards_in_context(procs.proc.pid, node, context) and time.monotonic() < deadline:
                time.sleep(0.05)
            assert cards_in_context(procs.proc.pid, node, context) == {3}
            assert cards_in_context(outside.pid, node, context) in (set(), {0})  # {0} once it has mapped
            assert procs.cards() == set()  # no process of the tree maps a card's /dev node
        finally:
            procs.close(grace_s=1.0)
        assert cards_in_context(procs.proc.pid, node, context) == set() and procs.cards() == set()
    finally:
        outside.kill()
        outside.wait(timeout=30)


def test_the_card_gate_reads_the_cards_the_pod_holds():
    """cuda_monitor's agent is ready once the pod's processes hold their
    card under a CUDA context (`PodProcesses.cards`), whatever cards the
    operator's own process sees; a pod's kernels
    source has no terminals, a fresh list each time."""
    held = set()
    agent = NotebookAgent(monitor=cuda_monitor(window_s=1.0, sample_period_s=0.5)(
        None, 1, SimpleNamespace(cards=lambda: held)), kernels=ProcessKernels(lambda: None))
    assert agent.routes("/tpu/readiness")["ready"] is False
    held.add(0)
    got = agent.routes("/tpu/readiness")
    assert got["ready"] is True and got["chips_visible"] == got["chips_expected"] == 1
    assert agent.routes("/api/terminals") == {"_raw": []}
    agent.kernels.terminals.append({})
    assert agent.kernels.terminals == []
