"""The forwarded /tpu/checkpoint of a notebook pod whose worker is a process
of its own (`probe.behavior.pod_process_behavior` with `checkpoint_hook`,
`forward_checkpoint` in the agent, `answer_checkpoint` in the worker), on
the CPU, with a plain Python child in place of the worker: its ack reaches
the agent's /tpu/checkpoint JSON; a child that never acks, or whose save
fails, gives `saved: false` within the deadline; each request is answered
once, and a re-probe made while a slow save is still unanswered joins it
instead of asking for a second save. A TPUJob's pod is served the same
way."""
import json
import sys
import time
import urllib.request
import uuid
from pathlib import Path

import torch_threads
from odh_kubeflow_tpu_torch.api.core import Container, Pod
from odh_kubeflow_tpu_torch.controllers import constants as C
from odh_kubeflow_tpu_torch.probe.agent import SimTPUMonitor
from odh_kubeflow_tpu_torch.probe.behavior import answer_checkpoint, forward_checkpoint, pod_process_behavior

torch_threads.cap()

DEADLINE_S = 3.0
REPO = Path(__file__).resolve().parent.parent

# the child: once its imports are done (the "ready" file), answers every
# forwarded request with the save `mode` names
CHILD = """
import os, sys, time
from odh_kubeflow_tpu_torch.probe.behavior import answer_checkpoint
directory, mode = sys.argv[1], sys.argv[2]
answered, step = set(), 41
open(os.path.join(directory, "ready"), "w").close()

def save():
    global step
    if mode == "fail":
        raise OSError("disk full")
    if mode == "slow":
        time.sleep(1.5)
    step += 1
    return {"step": step, "checksum": f"sum-{step}", "bytes": 1024}

while True:
    if mode != "silent":
        answer_checkpoint(directory, save, answered)
    time.sleep(0.01)
"""


def _pod(label=C.NOTEBOOK_NAME_LABEL):
    pod = Pod()
    pod.metadata.name, pod.metadata.namespace, pod.metadata.uid = "nb-0", "user", str(uuid.uuid4())
    pod.metadata.labels = {label: "nb"}
    pod.spec.node_name = "cpu-0"
    pod.spec.containers = [Container(name="nb", image="img:1")]
    return pod


def _serve(tmp_path, mode, label=C.NOTEBOOK_NAME_LABEL):
    """The pod's agent and its child worker, through the kubelet behavior."""
    processes = {}
    behavior = pod_process_behavior(
        [sys.executable, "-c", CHILD, str(tmp_path), mode], str(tmp_path),
        monitor=lambda pod, chips, procs: SimTPUMonitor(chips=1, expected=1),
        idle_since=lambda pod: None, cwd=str(REPO), grace_s=5.0, processes=processes,
        checkpoint_hook=lambda pod: forward_checkpoint(str(tmp_path), DEADLINE_S))
    pod = _pod(label)
    decision = behavior(pod)
    assert decision.graceful
    host, port, close = decision.serve(pod)
    assert list(processes) == [pod.metadata.uid]  # by uid: a replacement pod keeps the name
    # the deadline is the answer's, not the child's start-up: wait for its imports
    deadline = time.monotonic() + 120
    while not (tmp_path / "ready").exists() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert (tmp_path / "ready").exists(), "the child did not start"
    return host, port, close, processes[pod.metadata.uid]


def _checkpoint(host, port, timeout=30):
    with urllib.request.urlopen(f"http://{host}:{port}/tpu/checkpoint", timeout=timeout) as r:
        return json.loads(r.read())


def test_the_workers_ack_reaches_the_agents_route(tmp_path):
    host, port, close, procs = _serve(tmp_path, "save")
    try:
        first, second = _checkpoint(host, port), _checkpoint(host, port)
    finally:
        close()
    assert first == {"saved": True, "step": 42, "checksum": "sum-42"}
    assert second == {"saved": True, "step": 43, "checksum": "sum-43"}  # each request answered once
    assert procs.closed and procs.closed_at is not None


def test_a_worker_that_never_acks_gives_saved_false_within_the_deadline(tmp_path):
    host, port, close, _ = _serve(tmp_path, "silent")
    try:
        t0 = time.monotonic()
        got = _checkpoint(host, port)
        took = time.monotonic() - t0
    finally:
        close()
    assert got["saved"] is False and "did not ack" in got["reason"], got
    assert DEADLINE_S <= took < DEADLINE_S + 2.0, took


def test_a_failed_save_is_reported_not_acked(tmp_path):
    host, port, close, _ = _serve(tmp_path, "fail")
    try:
        got = _checkpoint(host, port)
    finally:
        close()
    assert got["saved"] is False and "disk full" in got["reason"], got


def test_answer_checkpoint_without_a_request_does_nothing(tmp_path):
    calls = []
    assert answer_checkpoint(str(tmp_path), lambda: calls.append(1) or {}, set()) is None
    assert calls == [] and list(tmp_path.iterdir()) == []


def test_a_reprobe_during_a_slow_save_joins_it_and_the_worker_saves_once(tmp_path):
    """The job and repair controllers' checkpoint probe gives up after 2 s,
    and a save on the card takes longer: the window's re-probe gets the
    ack of the save already under way, not a second save."""
    host, port, close, _ = _serve(tmp_path, "slow", label=C.JOB_NAME_LABEL)
    try:
        try:
            _checkpoint(host, port, timeout=0.3)
            raise AssertionError("the first probe should have timed out before the 1.5 s save acked")
        except OSError:
            pass
        joined = _checkpoint(host, port)
        later = _checkpoint(host, port)
    finally:
        close()
    assert joined == {"saved": True, "step": 42, "checksum": "sum-42"}
    assert later == {"saved": True, "step": 43, "checksum": "sum-43"}  # a new request once the first was acked
    assert len(list(tmp_path.glob("checkpoint-ack-*.json"))) == 2  # two saves for three probes
