"""The port's operator promoting a repaired notebook into an
InferenceEndpoint whose pod is a real serving process, on the CPU
(tests/torch_operator_flow.py's promotion episode, `python -m
odh_kubeflow_tpu_torch.serving` on the CPU): the notebook's train loop runs
under `torchrun`, is preempted and repaired onto another pool, suspended
by the SuspendResumeController with its pool released warm, and promoted
with a warm bind; the serving process restores the saved train state, the restore is
verified, the requests are served with `generate()`'s tokens, and the stop
drains the endpoint route first; with the restore late past the probe's
timeout the verdict is still `ok`. These episodes were in
tests/test_torch_operator_process.py; they have a file of their own so that
the test runner's workers share the process episodes. The same episode runs
on the card in tests/test_torch_cuda.py."""
import sys

import torch_operator_flow
import torch_pod_worker
import torch_threads
from odh_kubeflow_tpu_torch.probe.agent import SimTPUMonitor

torch_threads.cap()


PROMOTED_REQUESTS = [([3, 1, 4, 1, 5, 9, 2, 6], 8), ([2, 7, 1, 8], 12), ([1, 6, 1, 8, 0, 3], 6),
                     ([5, 7, 7, 2, 1, 5, 6, 6, 4, 9], 10)]


def promoted(tmp_path, command=None):
    """The repair flow on the CPU with the repaired notebook then promoted
    into an endpoint that serves PROMOTED_REQUESTS from its checkpoint
    (torch_operator_flow.Promotion); returns what the flow saw, checked."""
    cfg = torch_pod_worker.tiny_cfg()
    promotion = torch_operator_flow.Promotion(
        model_config=torch_operator_flow.model_config(cfg), device="cpu", requests=PROMOTED_REQUESTS, slots=2,
        max_seq=cfg.max_seq, drain_s=0.5, **({} if command is None else {"command": command}))
    seen = torch_operator_flow.run(
        tmp_path, torch_operator_flow.pod_worker("cpu"), waves=(("nb-p",),), repair="nb-p", promotion=promotion,
        monitor=lambda pod, chips, procs: SimTPUMonitor(chips=chips, expected=chips, duty=0.0))
    torch_operator_flow.check(seen, "cpu")
    return seen


def test_a_suspended_notebook_promoted_into_an_endpoint_serves_its_model_on_the_cpu(tmp_path):
    """The promotion episode with processes on the CPU: the notebook's
    resumed state is saved through its agent, the suspend controller
    suspends it and releases its pool warm, the endpoint claims that pool, its serving
    process restores the whole saved train state and acks its checksum,
    the restore is verified (`ok`), the four requests are served, and their
    greedy tokens equal `generate()`'s on the restored params; the stop
    drains the endpoint route first and terminates it."""
    import torch

    from odh_kubeflow_tpu_torch.models import adamw, generate, init_params, latest_step, restore_train_state

    seen = promoted(tmp_path)
    pe = seen["nb-p"]["promotion"]
    cfg = torch_pod_worker.tiny_cfg()
    ckpt = tmp_path / "out" / "nb-p" / "checkpoints"
    params = init_params(torch.Generator().manual_seed(7), cfg, device="cpu")
    state = restore_train_state(str(ckpt), {"params": params, "opt_state": adamw().init(params)})
    assert latest_step(str(ckpt)) == pe["ready"]["restore"]["step"] == torch_pod_worker.REPAIR_STEPS + 1
    for (prompt, max_new), (status, body, _, _) in zip(PROMOTED_REQUESTS, pe["replies"]):
        want = generate(state["params"], [prompt], cfg, max_new, max_seq=cfg.max_seq, device="cpu")[0].tolist()
        assert status == 200 and body["tokens"] == want, (prompt, body, want)
    assert pe["exit"]["stats"]["generated_tokens"] == sum(m for _, m in PROMOTED_REQUESTS), pe["exit"]


def test_a_restore_slower_than_the_probe_still_ends_verified(tmp_path):
    """The serving process starts its restore 3 s late, past the
    reconciler's 2 s restore probe: its agent reports ready only once the
    process has restored and listens, so Loading probes the restore once it
    can answer and the endpoint reaches Serving with the verdict `ok`,
    never `unverified`."""
    delayed = [sys.executable, "-c", "import runpy, time; time.sleep(3.0); "
               "runpy.run_module('odh_kubeflow_tpu_torch.serving', run_name='__main__')"]
    seen = promoted(tmp_path, command=delayed)
    pe = seen["nb-p"]["promotion"]
    assert pe["counters"]["verifications ok"] == 1 and pe["counters"]["verifications unverified"] == 0
    # from the bind, which comes before the wrapper's sleep: the serving
    # module's own "started" comes after it
    assert pe["ready"]["times"]["restored"] - pe["bound"][0] >= 3.0, (pe["bound"], pe["ready"]["times"])
    assert pe["bound"][0] + 3.0 <= pe["mesh-ready"][0], (pe["bound"], pe["mesh-ready"])
