"""A notebook pod's processes that outlive their stop, on the CPU: the pod
is not closed (`PodProcesses.close` raises and stamps no `closed_at`, and
the next call tries again), and the kubelet keeps a graceful pod's object,
its finalizer on, retrying the stop until it holds; only then does the
object go, so a StatefulSet cannot recreate the ordinal while an old
process may still hold the card."""
import os
import sys
import time

import torch_threads
from odh_kubeflow_tpu_torch.api.core import Container, Pod
from odh_kubeflow_tpu_torch.apimachinery import NotFoundError
from odh_kubeflow_tpu_torch.cluster import SimCluster
from odh_kubeflow_tpu_torch.cluster.kubelet import TERMINATION_FINALIZER, PodDecision
from odh_kubeflow_tpu_torch.probe import behavior
from odh_kubeflow_tpu_torch.probe.behavior import PodProcesses

torch_threads.cap()

UNKILLABLE = 2**22 + 7  # above Linux's largest pid: no process has it


def test_a_stop_that_leaves_a_process_is_not_a_close(tmp_path, monkeypatch):
    procs = PodProcesses([sys.executable, "-c", "import time; time.sleep(600)"], dict(os.environ), None,
                         str(tmp_path / "log"), "n")
    procs.pids.append(UNKILLABLE)
    alive = behavior._alive
    monkeypatch.setattr(behavior, "_alive", lambda pid: pid == UNKILLABLE or alive(pid))
    try:
        procs.close(grace_s=0.2)
        raise AssertionError("close returned with a process left")
    except RuntimeError as e:
        assert str(UNKILLABLE) in str(e)
    assert not procs.closed and procs.closed_at is None
    monkeypatch.setattr(behavior, "_alive", alive)  # the process is gone at last
    procs.close(grace_s=0.2)
    assert procs.closed and procs.closed_at is not None and not alive(procs.proc.pid)


def test_a_graceful_pod_keeps_its_object_until_its_stop_holds():
    fails, stops = [2], []

    def stop():
        stops.append(time.time())
        if fails[0]:
            fails[0] -= 1
            raise RuntimeError(f"processes [{UNKILLABLE}] of the pod outlived SIGKILL")

    cluster = SimCluster().start()
    try:
        cluster.add_pod_behavior(lambda pod: PodDecision(serve=lambda pod: ("127.0.0.1", 1, stop), graceful=True))
        (node,) = cluster.add_cpu_pool("cpu")
        pod = Pod()
        pod.metadata.name, pod.metadata.namespace = "nb-0", "user"
        pod.spec.node_name = node.metadata.name
        pod.spec.containers = [Container(name="nb", image="img:1")]
        cluster.client.create(pod)

        def wait(fn, what, timeout=30.0):
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                got = fn()
                if got:
                    return got
                time.sleep(0.02)
            raise AssertionError(f"timeout waiting for {what}")

        def current():
            try:
                return cluster.client.get(Pod, "user", "nb-0")
            except NotFoundError:
                return None

        wait(lambda: (p := current()) and p.is_ready() and TERMINATION_FINALIZER in p.metadata.finalizers,
             "the pod ready with the kubelet's finalizer")
        cluster.client.delete(Pod, "user", "nb-0")
        wait(lambda: len(stops) == 2, "a second stop")
        held = current()
        assert held is not None and held.metadata.deletion_timestamp, held
        assert TERMINATION_FINALIZER in held.metadata.finalizers
        wait(lambda: current() is None, "the object gone")
        assert len(stops) == 3 and fails == [0], stops
    finally:
        cluster.stop()
