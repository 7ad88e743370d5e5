"""The port's suspend and resume with real pod processes, on the CPU
(tests/torch_operator_flow.py with `resume`, `probe.behavior.
pod_process_behavior`): a notebook's train loop runs under `torchrun`, is
preempted and repaired onto the second pool, then suspended by the
SuspendResumeController (the culler's stamp, the forwarded save, its pool
released warm). A TPUJob
is admitted on a warm claim of that pool and trains; the notebook is
unstopped, its warm claim misses (the repair's node stays tainted, the
job holds the other), and the reclaimer preempts the job for it (cause
`reclaim`). The notebook's new pod restores the suspended step, the
resume completes with the restore verified (`ok`) and the worker's next
step is bit-equal to the one its predecessor took on a copy; the notebook
is stopped again, suspends and releases its slice warm, and the requeued
job claims it, restores its acked step bit-equal and runs to Succeeded.

Each pod's devices come up at its worker's context stamp
(`torch_operator_flow.stamp_monitor`, as the card's CUDA context), and a
restoring worker holds its restore RESTORE_DELAY_S past it: the notebook's
agent stays not ready until the worker reports the state back, so the
controller's one restore check at mesh-ready is answered (`ok`, never
`unverified`). A ChipAccountant ticks over the flow and conserves, and
the manager's every call stays inside the RBAC of the port's generated
manifests (DEPLOYGUARD, `check_deployguard`). The same episode runs on
the card in tests/test_torch_cuda.py and
chip_smoke.py's phase 15."""
import torch_dist
import torch_operator_flow
import torch_threads

torch_threads.cap()

# the CPU's tiny steps take ~30 ms: enough of them that the job's first pod
# is still short of the budget when the reclaim lands, a second or two after
# its first acked save past step 0
STEPS, PERIOD_S = 300, 1.0
RESTORE_DELAY_S = 2.5  # past the forwarded /tpu/restore's 1.5 s wait


def test_a_notebook_suspended_and_resumed_by_reclaiming_a_job_on_the_cpu(tmp_path):
    seen = torch_operator_flow.run(
        tmp_path, torch_operator_flow.pod_worker("cpu"), waves=(("nb-s",),), repair="nb-s", resume=True,
        job=torch_operator_flow.Job(steps=STEPS, period_s=PERIOD_S),
        cfg=dict(torch_operator_flow.CFG, accounting_period_s=0.5),
        env=dict(torch_dist.clean_env(), OMP_NUM_THREADS="1", NB_RESTORE_DELAY_S=str(RESTORE_DELAY_S)),
        monitor=torch_operator_flow.stamp_monitor(tmp_path))
    torch_operator_flow.check(seen, "cpu", gate_waits=True)
    re_, j = seen["nb-s"]["resume"], seen["job"]
    assert j["cause"] == "reclaim" and j["counters"]["preemptions reclaim"] == 1
    assert re_["pool"] == j["first"]["pool"] == j["second"]["pool"], (re_["pool"], j["first"]["pool"])
    # the restore held back past the probe's wait: mesh-ready only after it
    times = re_["result"]["times"]
    assert times["restored"] - times["context"] >= RESTORE_DELAY_S, times
    assert re_["mesh-ready"][0] >= times["restored"], (re_["mesh-ready"], times)
    assert j["first"]["result"]["train"]["steps"] < STEPS <= j["status"]["completedSteps"]
    by = seen["accounting"]["by class and phase"]
    assert by.get("job ready", 0) > 0, by
    # DEPLOYGUARD over the flow: the job, reclaim and resume flows inside the generated RBAC
    torch_operator_flow.check_deployguard(seen, tmp_path / "deploy-surface.json")
    assert {"tpu-job", "suspend-resume"} <= {f for f, _, _, _ in seen["deployguard"]["surface"]}
