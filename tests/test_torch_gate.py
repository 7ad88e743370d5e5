"""The card's readiness gate of the port's process pods
(`probe.behavior.cards_in_context`, `cuda_monitor`), on the CPU: a card
counts once one process of the pod's tree maps both the card's node and the
node that only a CUDA context maps (`/dev/nvidia-uvm`; the driver's
initialisation alone opens and maps the card's node) and runs the thread
that the driver starts at the end of the context's creation
(`cuda-EvtHandlr`). Regular files named like the nodes stand in for them,
through the node patterns the functions take, and a thread that names
itself so for the driver's. Imports no jax.
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
# for <dir>/go-<i>, maps the step's files (or, for "thread:NAME", starts a
# thread that names itself NAME through prctl), then writes <dir>/done-<i>
STEPPER = """
import ctypes, mmap, os, sys, threading, time
d, steps = sys.argv[1], sys.argv[2:]
held = []

def named(name, ready):
    ctypes.CDLL(None).prctl(15, name.encode(), 0, 0, 0)  # PR_SET_NAME
    ready.set()
    time.sleep(600)

for i, step in enumerate(steps):
    while not os.path.exists(os.path.join(d, f"go-{i}")):
        time.sleep(0.01)
    for name in filter(None, step.split(",")):
        if name.startswith("thread:"):
            ready = threading.Event()
            threading.Thread(target=named, args=(name[len("thread:"):], ready), daemon=True).start()
            ready.wait()
            continue
        f = open(os.path.join(d, name), "r+b")
        held.append((f, mmap.mmap(f.fileno(), 1)))
    open(os.path.join(d, f"done-{i}"), "w").close()
time.sleep(600)
"""
EVENT_THREAD = "thread:cuda-EvtHandlr"  # the driver's thread, started as the context's creation ends


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
    driver's control node) leaves the gate not ready, read after read, and
    so does the context node mapped while the context is still being made;
    once the driver's event thread runs too, the gate opens with the card
    visible."""
    tmp_path, node, context = nodes
    procs = _pod(tmp_path, ["nvidiactl,nvidia3", "nvidia-uvm", EVENT_THREAD])
    try:
        agent = NotebookAgent(monitor=cuda_monitor(window_s=1.0, sample_period_s=0.5)(
            None, 1, SimpleNamespace(cards=lambda: cards_in_context(procs.proc.pid, node, context))),
            kernels=ProcessKernels(lambda: None))
        for step in (0, 1):
            _step(tmp_path, 0, step)
            for _ in range(3):
                got = agent.routes("/tpu/readiness")
                assert got["ready"] is False and got["chips_visible"] == 0, (step, got)
                time.sleep(0.05)
        _step(tmp_path, 0, 2)
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
    procs = _pod(tmp_path, ["nvidia0", ""], [f"nvidia-uvm,{EVENT_THREAD}", "nvidia3"])
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
