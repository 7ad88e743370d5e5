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
cull; a deleted notebook takes its route and policies with it. The same
flow runs on the card in tests/test_torch_cuda.py. Also the downward-API
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
import torch_threads
from odh_kubeflow_tpu_torch.api.core import Container, EnvVar, EnvVarSource, Pod
from odh_kubeflow_tpu_torch.probe.agent import NotebookAgent, SimTPUMonitor
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
    """A child of the pod mapping a card's node and the context node (as a
    torchrun worker maps /dev/nvidiaN and /dev/nvidia-uvm under its CUDA
    context) counts that card; the same nodes mapped by a process outside
    the pod's tree do not; a stopped pod holds none."""
    for name in ("nvidia0", "nvidia3", "nvidia-uvm"):
        (tmp_path / name).write_bytes(b"\0")
    root = re.escape(str(tmp_path))
    node, context = re.compile(rf"^{root}/nvidia(\d+)$"), re.compile(rf"^{root}/nvidia-uvm$")

    def mapping(*names):
        return "; ".join(f"f{i} = open({str(tmp_path / n)!r}, 'r+b'); m{i} = mmap.mmap(f{i}.fileno(), 1)"
                         for i, n in enumerate(names))

    child = f"import mmap, time; {mapping('nvidia3', 'nvidia-uvm')}; time.sleep(600)"
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
