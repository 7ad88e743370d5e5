"""The container command of tests/torch_operator_flow.py's notebook pods,
started by `python -m torch.distributed.run` from the env the port's
reconciler rendered. Imports no jax.

    torch_pod_worker.py DEVICE OUT_DIR [MODE]

Each rank brings the world up with the port's `initialize_from_env`, puts a
tensor on DEVICE ("cpu", or "cuda": the rank's card, which creates its CUDA
context), writes its env, rank, pid, the time its tensor was on the device
(its CUDA context) and the time it was done to
OUT_DIR/rank-R.json (written whole, then renamed), and holds until
SIGTERM, as a notebook kernel holds its card.

MODE "repair" is the worker of a notebook whose pod the flow preempts
(`repair_run`, which chip_smoke.py's card worker shares): it trains a tiny
model and answers the forwarded checkpoint requests until SIGTERM, or, in
the pod that replaced it, restores the notebook's latest checkpoint and
takes the next step. MODE "promote" is "repair" for a notebook the flow
then suspends (and promotes into an InferenceEndpoint, and resumes): a pod
that restored stays busy after its step, reports the logit fingerprint of
its params and answers the forwarded checkpoint requests (the suspend's
save), each with the next step taken on a copy, until SIGTERM. A pod that
restores reports it (`probe.behavior.RESTORE_REPORT`: restoring before its
device, then what it restored) and answers the forwarded /tpu/restore
requests with what it restored; NB_RESTORE_DELAY_S in its env holds the
restore back that many seconds past its device. MODE "job" is a TPUJob's learner (`job_run`): it trains up to
TPU_JOB_STEPS from TPU_JOB_RESUME_STEP's checkpoint (or from scratch),
answering the forwarded checkpoint requests between two steps, until
SIGTERM.
"""
import json
import os
import signal
import sys
import threading
import time

import numpy as np
import torch

NAMES = ("PET_STANDALONE", "PET_NPROC_PER_NODE", "PET_NNODES", "NB_TPU_CHIPS_EXPECTED", "NB_TPU_HOSTS",
         "TPU_ACCELERATOR_TYPE", "TPU_TOPOLOGY", "RANK", "LOCAL_RANK", "WORLD_SIZE")
REPAIR_STEPS = 2  # the steps the first incarnation takes before it is preempted


CONTEXT_STAMP = "context.json"  # the time the worker's device first held a tensor (its CUDA context on a card)


def write_json_stamp(out_dir, context):
    """CONTEXT_STAMP, written whole: on the CPU, where no CUDA context marks
    the worker's start, a monitor can come up on it
    (torch_operator_flow.stamp_monitor)."""
    path = os.path.join(out_dir, CONTEXT_STAMP)
    with open(path + ".tmp", "w") as f:
        json.dump({"context": context}, f)
    os.replace(path + ".tmp", path)


def write_result(out_dir, out):
    """rank-R.json, written whole, then renamed."""
    path = os.path.join(out_dir, f"rank-{out['rank']}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)


def checkpoint_dir(out_dir):
    """The notebook's checkpoint directory (its volume): beside the pods'
    own directories, so the pod that replaces a preempted one finds it."""
    return os.path.join(os.path.dirname(os.path.abspath(out_dir)), "checkpoints")


def resuming(out_dir):
    """Whether the notebook has a finished checkpoint, that is whether this
    pod replaces one that saved."""
    from odh_kubeflow_tpu_torch.models import latest_step

    return latest_step(checkpoint_dir(out_dir)) is not None


def announce_restore(out_dir):
    """The restore report's first half, written before the worker touches
    its device: its pod's agent does not come up until the second."""
    from odh_kubeflow_tpu_torch.probe.behavior import RESTORE_REPORT, write_json

    write_json(os.path.join(out_dir, RESTORE_REPORT), {"restoring": True, "at": time.time()})


def report_restored(out_dir, restored, stop):
    """The restore report's second half (`restored`: step, checksum,
    seconds), then the forwarded /tpu/restore requests answered with it from
    a thread until `stop`, whatever the worker does meanwhile."""
    from odh_kubeflow_tpu_torch.probe.behavior import RESTORE_REPORT, answer_restore, write_json

    ack = {"restored": True, "step": restored["step"], "checksum": restored["checksum"]}
    write_json(os.path.join(out_dir, RESTORE_REPORT), {"restoring": False, **ack, "seconds": restored["seconds"],
                                                       "at": time.time()})

    def answer():
        answered = set()
        while not stop.is_set():
            answer_restore(out_dir, lambda: ack, answered)
            stop.wait(0.02)

    threading.Thread(target=answer, daemon=True, name="restore-answers").start()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches(attention):
    return {k: v for k, v in attention.launch_counts.items() if v}


def answer_saves(ckpt, out_dir, current, stop, after_save=None, work=lambda: False):
    """Answers the forwarded checkpoint requests
    (probe.behavior.answer_checkpoint) until `stop`: save `current()`, a
    (step, state) pair, and ack its step, checksum, seconds, bytes and
    time; `after_save(step, state, ack)` runs before the ack goes out.
    Between two polls `work()` runs; the loop waits 20 ms when it did
    nothing (returned False)."""
    from odh_kubeflow_tpu_torch.models import make_checkpoint_hook
    from odh_kubeflow_tpu_torch.probe.behavior import answer_checkpoint

    hook = make_checkpoint_hook(ckpt, current)

    def save():
        step, state = current()
        t0 = time.time()
        ack = hook()
        step_dir = os.path.join(ckpt, str(step))
        ack.update(seconds=time.time() - t0, at=time.time(),
                   bytes=sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir)))
        if after_save is not None:
            after_save(step, state, ack)
        return ack

    answered = set()
    while not stop.is_set():
        answer_checkpoint(out_dir, save, answered)
        if not work():
            stop.wait(0.02)


def step_on_copy(dev, step_fn, state, k, batch_of):
    """Step k+1 on a copy of `state` at step k, the run that is never
    interrupted: its step, loss and params checksum, and its launches."""
    from odh_kubeflow_tpu_torch.models import state_checksum
    from odh_kubeflow_tpu_torch.models.tree import tree_map
    from odh_kubeflow_tpu_torch.ops import attention

    twin = tree_map(torch.clone, state)
    attention.reset_launch_counts()
    _, _, loss = step_fn(twin["params"], twin["opt_state"], batch_of(k))
    _sync(dev)
    return {"step": k + 1, "loss": loss.item(), "checksum": state_checksum(twin["params"])}, _launches(attention)


def restore_and_step(dev, ckpt, k, cfg, step_fn, opt, batch_of, on_restored=None):
    """Restores step k of `ckpt` onto a state initialised from another seed
    (seed 1), checks its checksum and takes step k+1. Returns the state
    and "resumed": what was restored (step, checksum, seconds) and the
    step's step, loss, params checksum and launches. `on_restored(what)`
    runs between the restore and the step."""
    from odh_kubeflow_tpu_torch.models import init_params, restore_train_state, state_checksum
    from odh_kubeflow_tpu_torch.ops import attention

    params = init_params(torch.Generator().manual_seed(1), cfg, device=dev)
    t0 = time.time()
    state = restore_train_state(ckpt, {"params": params, "opt_state": opt.init(params)}, step=k)
    _sync(dev)
    restored = {"step": k, "checksum": state_checksum(state), "seconds": time.time() - t0}
    if on_restored is not None:
        on_restored(restored)
    attention.reset_launch_counts()
    _, _, loss = step_fn(state["params"], state["opt_state"], batch_of(k))
    _sync(dev)
    return state, {"restored": restored, "step": int(state["opt_state"]["count"]), "loss": loss.item(),
                   "checksum": state_checksum(state["params"]), "launches": _launches(attention)}


def repair_run(dev, out_dir, cfg, batch_of, out, stop, steps=REPAIR_STEPS, promote=False):
    """A notebook's train loop across a slice repair, filling `out` and
    writing it (`write_result`).

    First incarnation (no checkpoint yet): `steps` train steps, each step's
    loss and flash launches; then step k+1 on a copy of the state at step k
    (`step_on_copy`), so the run that is never interrupted is known before
    any ack: its loss and params checksum. The result is written with no
    "done" time (the kernel stays busy); then the forwarded checkpoint
    requests are answered (`answer_saves`: save the state at step k, ack
    its step, checksum, seconds and bytes) until `stop`.

    A later incarnation (the notebook's checkpoint directory holds a step):
    `restore_and_step` from the latest step, reporting the restore
    (`report_restored`) before the step, and write its loss and params
    checksum with the time it "stepped" and the "done" time. With `promote`
    it has no "done" time (its kernel stays busy): it writes the logit
    fingerprint of its params (serving.server.FINGERPRINT_PROMPT) and
    answers the forwarded checkpoint requests with step k+1 until `stop`,
    taking step k+2 on a copy before each ack ("saves", as `job_run`).
    `batch_of(i)` is the batch of the step from i to i + 1."""
    from odh_kubeflow_tpu_torch.models import init_params, latest_step, logit_fingerprint, make_train_step, state_checksum
    from odh_kubeflow_tpu_torch.ops import attention
    from odh_kubeflow_tpu_torch.serving.server import FINGERPRINT_PROMPT

    ckpt = checkpoint_dir(out_dir)
    step_fn, opt = make_train_step(cfg)
    saved = latest_step(ckpt)
    if saved is not None:
        delay = float(os.environ.get("NB_RESTORE_DELAY_S") or 0)
        if delay:
            stop.wait(delay)

        def restored(what):
            out["times"]["restored"] = time.time()
            report_restored(out_dir, what, stop)

        state, out["resumed"] = restore_and_step(dev, ckpt, saved, cfg, step_fn, opt, batch_of, restored)
        out["times"]["stepped"] = time.time()
        out["times"]["done"] = None if promote else out["times"]["stepped"]
        if promote:
            out["resumed"]["logit_fingerprint"] = logit_fingerprint(state["params"], cfg, FINGERPRINT_PROMPT)
            out["saves"] = []
        write_result(out_dir, out)
        if promote:
            def after_save(step, state, ack):
                out["saves"].append(dict(ack, next=step_on_copy(dev, step_fn, state, step, batch_of)[0]))
                write_result(out_dir, out)

            answer_saves(ckpt, out_dir, lambda: (out["resumed"]["step"], state), stop, after_save=after_save)
        else:
            stop.wait()
        return
    params = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    state = {"params": params, "opt_state": opt.init(params)}
    losses, launches = [], []
    for i in range(steps):
        attention.reset_launch_counts()
        losses.append(step_fn(state["params"], state["opt_state"], batch_of(i))[2])
        _sync(dev)
        launches.append(_launches(attention))
    k = int(state["opt_state"]["count"])
    following, launched = step_on_copy(dev, step_fn, state, k, batch_of)
    launches.append(launched)
    out["train"] = {"steps": k, "losses": [x.item() for x in losses], "launches": launches, "next": following,
                    "state checksum": state_checksum(state)}
    out["times"]["done"] = None  # busy: the notebook keeps working until it is preempted
    write_result(out_dir, out)
    answer_saves(ckpt, out_dir, lambda: (k, state), stop)


def job_run(dev, out_dir, cfg, batch_of, out, stop):
    """A TPUJob learner's train loop across its incarnations, filling `out`
    and writing it (`write_result`) after each event.

    The job's checkpoints are its checkpoint directory (`checkpoint_dir`).
    With TPU_JOB_RESUME_STEP k > 0 (the acked step the job controller
    pinned for this admission) it resumes from step k (`restore_and_step`)
    and writes "resumed". Else it starts from seed 0. Then it trains until
    the step count reaches TPU_JOB_STEPS, each step's launches counted, and
    stays busy after that. Between two steps it answers a forwarded
    checkpoint request (`answer_saves`): it saves its current step k and,
    before it acks, takes step k+1 on a copy of the state (`step_on_copy`)
    and records that step's loss and params checksum beside the save in
    "saves" (the run that is never interrupted, known before any ack).
    `batch_of(i)` is the batch of the step from i to i + 1."""
    from odh_kubeflow_tpu_torch.models import init_params, make_train_step
    from odh_kubeflow_tpu_torch.ops import attention

    ckpt = checkpoint_dir(out_dir)
    target, k = int(os.environ["TPU_JOB_STEPS"]), int(os.environ.get("TPU_JOB_RESUME_STEP") or 0)
    step_fn, opt = make_train_step(cfg)
    launches = {}  # a step's launches (as JSON) -> the steps that launched them
    losses = []

    def count(launched, loss):
        key = json.dumps(launched, sort_keys=True)
        launches[key] = launches.get(key, 0) + 1
        losses.append(loss)

    if k:
        state, out["resumed"] = restore_and_step(dev, ckpt, k, cfg, step_fn, opt, batch_of)
        k = out["resumed"]["step"]
        count(out["resumed"]["launches"], out["resumed"]["loss"])
        out["times"]["stepped"] = time.time()
    else:
        params = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
        state = {"params": params, "opt_state": opt.init(params)}

    def record():
        out["train"] = {"steps": k, "losses": losses, "launches": launches}
        write_result(out_dir, out)

    def after_save(step, state, ack):
        out["saves"].append(dict(ack, next=step_on_copy(dev, step_fn, state, step, batch_of)[0]))
        record()

    def work():
        nonlocal k
        if k >= target:
            return False
        attention.reset_launch_counts()
        loss = step_fn(state["params"], state["opt_state"], batch_of(k))[2].item()
        count(_launches(attention), loss)
        k += 1
        out["times"].setdefault("first step", time.time())
        if k == target:
            out["times"]["trained"] = time.time()
            record()
        return True

    out["saves"], out["times"]["done"] = [], None  # busy until the job is torn down
    out["times"]["answering"] = time.time()
    record()
    answer_saves(ckpt, out_dir, lambda: (k, state), stop, after_save=after_save, work=work)


def tiny_cfg():
    """The CPU flow's model: two layers of a few dozen widths, f32."""
    from odh_kubeflow_tpu_torch.models import TransformerConfig

    return TransformerConfig(vocab=64, d_model=32, n_layers=2, n_heads=2, d_ff=64, max_seq=32,
                             dtype=torch.float32, use_flash=True, remat=True, remat_policy="flash")


def main(device: str, out_dir: str, mode: str = "serve") -> None:
    from odh_kubeflow_tpu_torch.parallel import initialize_from_env, rank_device, reinitialize_after_repair

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    torch.set_num_threads(1)
    again = mode in ("repair", "promote") and resuming(out_dir)
    if again:
        announce_restore(out_dir)
    # the device first, its time taken at once: bring-up with nccl makes the
    # card current, which creates the CUDA context before the world forms.
    # An empty allocation creates the context and launches no kernel (the
    # first kernel loads its module, which took up to 0.35 s past the
    # context on the card), as chip_smoke.py's worker stamps it
    dev = rank_device(device)
    torch.empty(1, device=dev)
    _sync(dev)
    context = time.time()
    write_json_stamp(out_dir, context)
    x = torch.ones(64, 64, device=dev)
    rank, world = (reinitialize_after_repair if again else initialize_from_env)(timeout_s=60, device=device)
    total = float((x @ x).sum())
    out = {"rank": rank, "world": [rank, world], "device": str(dev), "pid": os.getpid(), "ppid": os.getppid(),
           "sum": total, "env": {n: os.environ.get(n) for n in NAMES},
           "times": {"context": context, "formed": time.time(), "done": time.time()}}
    if mode in ("repair", "promote", "job"):
        cfg = tiny_cfg()

        def batch_of(i):
            return {"tokens": torch.as_tensor(np.random.default_rng(100 + i).integers(0, cfg.vocab, (2, 16)),
                                              device=dev)}

        if mode == "job":
            job_run(dev, out_dir, cfg, batch_of, out, stop)
        else:
            repair_run(dev, out_dir, cfg, batch_of, out, stop, promote=mode == "promote")
        return
    write_result(out_dir, out)
    stop.wait()


if __name__ == "__main__":
    main(*sys.argv[1:4])
