"""The port's TPUJob with its learner pods as real processes, on the CPU
(tests/torch_operator_flow.py's job episode, `probe.behavior.
pod_process_behavior`): a `torchrun` per pod from the env the job
reconciler rendered runs tests/torch_pod_worker.py's "job" mode, a tiny
model trained on the CPU beside an agent over `SimTPUMonitor`. The job is
admitted on the one-card pool, Running once the gate has its pod ready,
checkpoints at its cadence through the forwarded /tpu/checkpoint, is
preempted by a user's stamp (the save, Preempted, its slice parked warm
at its priority), requeues, claims the slice warm again, and the new pod
restores the acked step, whose next step is bit-equal to the first pod's
on a copy, and trains on to Succeeded. A ChipAccountant ticks in the
manager the whole time: its ledger conserves, and the job class banked
chip-seconds. The same episode runs on the card in tests/test_torch_cuda.py
and chip_smoke.py's phase 15."""
import torch_operator_flow
import torch_threads
from odh_kubeflow_tpu_torch.probe.agent import SimTPUMonitor

torch_threads.cap()

# the CPU's tiny steps take ~30 ms: enough of them that the first pod is
# still short of the budget when the user's preempt lands, right after its
# first acked cadence save past step 0 (a save asked before the worker is up
# is answered at step 0 once it is)
STEPS, PERIOD_S = 150, 1.0


def test_a_job_preempted_requeued_and_resumed_bit_equal_runs_to_succeeded_on_the_cpu(tmp_path):
    seen = torch_operator_flow.run(
        tmp_path, torch_operator_flow.pod_worker("cpu"), waves=(),
        job=torch_operator_flow.Job(steps=STEPS, period_s=PERIOD_S),
        cfg=dict(torch_operator_flow.CFG, accounting_period_s=0.5),
        monitor=lambda pod, chips, procs: SimTPUMonitor(chips=chips, expected=chips, duty=0.0))
    torch_operator_flow.check(seen, "cpu")
    j = seen["job"]
    assert j["first"]["result"]["train"]["steps"] < STEPS <= j["status"]["completedSteps"]
    assert j["second"]["result"]["train"]["steps"] == STEPS
    by = seen["accounting"]["by class and phase"]
    assert by.get("job ready", 0) > 0, by
