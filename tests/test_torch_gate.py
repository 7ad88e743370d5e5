"""The card's readiness gate of the port's process pods
(`probe.behavior.cards_in_context`, `cuda_monitor`), on the CPU: a card
counts once one process of the pod's tree maps both the card's node and the
node that only a CUDA context maps (`/dev/nvidia-uvm`; the driver's
initialisation alone opens and maps the card's node). Regular files named
like the nodes stand in for them, through the node patterns the functions
take. Imports no jax.
"""
import mmap
import os
import re
import sys
import time
from types import SimpleNamespace

import pytest

from odh_kubeflow_tpu_torch.probe.agent import NotebookAgent
from odh_kubeflow_tpu_torch.probe.behavior import PodProcesses, ProcessKernels, cards_in_context, cuda_monitor

# a process that maps the files it is told to, one step at a time: it waits
# for <dir>/go-<i>, maps the step's files, then writes <dir>/done-<i>
STEPPER = """
import mmap, os, sys, time
d, steps = sys.argv[1], sys.argv[2:]
held = []
for i, step in enumerate(steps):
    while not os.path.exists(os.path.join(d, f"go-{i}")):
        time.sleep(0.01)
    for name in filter(None, step.split(",")):
        f = open(os.path.join(d, name), "r+b")
        held.append((f, mmap.mmap(f.fileno(), 1)))
    open(os.path.join(d, f"done-{i}"), "w").close()
time.sleep(600)
"""


@pytest.fixture
def nodes(tmp_path):
    for name in ("nvidia0", "nvidia3", "nvidia-uvm", "nvidiactl"):
        (tmp_path / name).write_bytes(b"\0")
    root = re.escape(str(tmp_path))
    return tmp_path, re.compile(rf"^{root}/nvidia(\d+)$"), re.compile(rf"^{root}/nvidia-uvm$")


def _pod(tmp_path, *processes):
    """A pod whose command starts one stepper child per entry of
    `processes` (each a list of comma-joined steps, in its own directory)."""
    children = []
    for i, steps in enumerate(processes):
        d = tmp_path / f"p{i}"
        d.mkdir()
        for name in ("nvidia0", "nvidia3", "nvidia-uvm", "nvidiactl"):
            os.symlink(tmp_path / name, d / name)
        children.append([sys.executable, "-c", STEPPER, str(d), *steps])
    parent = (f"import subprocess, time; [subprocess.Popen(a) for a in {children!r}]; time.sleep(600)")
    return PodProcesses([sys.executable, "-c", parent], dict(os.environ), None, str(tmp_path / "log"), "n")


def _step(tmp_path, process, i):
    d = tmp_path / f"p{process}"
    (d / f"go-{i}").touch()
    deadline = time.monotonic() + 30
    while not (d / f"done-{i}").exists():
        assert time.monotonic() < deadline, f"process {process} did not finish step {i}"
        time.sleep(0.01)


def test_the_gate_opens_at_the_context_node_not_at_the_card_node(nodes):
    """A process of the pod that maps the card's node (and holds the
    driver's control node) leaves the gate not ready, read after read; once
    it also maps the context node, the gate opens with the card visible."""
    tmp_path, node, context = nodes
    procs = _pod(tmp_path, ["nvidiactl,nvidia3", "nvidia-uvm"])
    try:
        agent = NotebookAgent(monitor=cuda_monitor(window_s=1.0, sample_period_s=0.5)(
            None, 1, SimpleNamespace(cards=lambda: cards_in_context(procs.proc.pid, node, context))),
            kernels=ProcessKernels(lambda: None))
        _step(tmp_path, 0, 0)
        for _ in range(3):
            got = agent.routes("/tpu/readiness")
            assert got["ready"] is False and got["chips_visible"] == 0, got
            time.sleep(0.05)
        _step(tmp_path, 0, 1)
        got = agent.routes("/tpu/readiness")
        assert got["ready"] is True and got["chips_visible"] == got["chips_expected"] == 1, got
    finally:
        procs.close(grace_s=1.0)
    assert cards_in_context(procs.proc.pid, node, context) == set()


def test_a_card_counts_in_the_process_that_maps_the_context_node(nodes):
    """The card's node and the context node count together only in one
    process: a launcher-like process mapping the card and a worker-like one
    mapping only the context node give no card; once the worker maps its
    card too, that card counts. The context node mapped by a process outside
    the pod's tree (the operator's own) adds nothing."""
    tmp_path, node, context = nodes
    procs = _pod(tmp_path, ["nvidia0", ""], ["nvidia-uvm", "nvidia3"])
    try:
        with open(tmp_path / "nvidia-uvm", "r+b") as f, mmap.mmap(f.fileno(), 1):  # this process, not the pod
            _step(tmp_path, 0, 0)
            _step(tmp_path, 1, 0)
            assert cards_in_context(procs.proc.pid, node, context) == set()
            _step(tmp_path, 1, 1)
            assert cards_in_context(procs.proc.pid, node, context) == {3}
        assert procs.cards() == set()  # the real node patterns: no /dev node mapped
    finally:
        procs.close(grace_s=1.0)
