"""Imported by the port's multi-process tests (tests/test_torch_parallel.py,
test_torch_ring.py, test_torch_sp.py). Imports no jax: the ranks it spawns
load only torch, the port and this module.

`run_ranks(world, cases)` spawns `world` processes (the "spawn" start
method), each brought up through the port's `initialize_from_env` from the
env names the webhook injects (JAX_NUM_PROCESSES, JAX_PROCESS_ID,
JAX_COORDINATOR_ADDRESS) on the gloo backend, on the CPU unless the caller
names the card, with one torch thread. Every rank runs every case, a (name, "module:function", kwargs)
triple, as function(rank, world, **kwargs), and the results come back per
case as a list indexed by rank. Several cases share one spawn, so the
start-up is paid once. The group's init has a timeout, and so has the
wait for the results: a hung rank fails the test (RankFailure), it never
holds the run.

The pods of a planned GPU slice, started by torchrun as a pod would start
them (tests/test_torch_torchrun.py and chip_smoke.py's phase 14):
`pod_env(shape, ordinal)` is one pod's env as `gpu.apply_slice` renders it,
and `run_processes` starts every torchrun process at once, each in a
session of its own, and stops each at a shared deadline.
"""
import importlib
import multiprocessing
import os
import queue
import signal
import socket
import subprocess
import time
import traceback

INIT_TIMEOUT_S = 60
RUN_TIMEOUT_S = 300
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# names a process may carry that would change a pod's bring-up
POD_PREFIXES = ("PET_", "JAX_", "TPU_", "NB_TPU_", "TORCHELASTIC_")
POD_NAMES = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "GROUP_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


class RankFailure(RuntimeError):
    """A rank raised, died or did not finish in time."""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def webhook_env(rank: int, world: int, port: int) -> dict:
    return {"JAX_NUM_PROCESSES": str(world), "JAX_PROCESS_ID": str(rank),
            "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}"}


def resolve(path: str):
    module, name = path.split(":")
    return getattr(importlib.import_module(module), name)


def _rank_main(rank, world, port, cases, results, device):
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        os.environ.update(webhook_env(rank, world, port))
        from odh_kubeflow_tpu_torch.parallel import initialize_from_env

        # gloo on the card too: the ranks of a one-card run share its device
        initialize_from_env(timeout_s=INIT_TIMEOUT_S, backend="gloo", device=device)
        out = {}
        for name, path, kwargs in cases:
            out[name] = resolve(path)(rank, world, **kwargs)
        if dist.is_initialized():
            dist.destroy_process_group()
        results.put((rank, out, None))
    except BaseException:  # reported to the parent, which fails the test
        results.put((rank, None, traceback.format_exc()))


def run_ranks(world: int, cases, timeout_s: float = RUN_TIMEOUT_S, device: str = "cpu") -> dict:
    """{case name: [result of rank 0, rank 1, ...]}; raises RankFailure
    with the failing rank's traceback. `device` "cuda" puts every rank on
    the card (gloo all the same)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, cases, results, device),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, []
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < world:
            try:
                rank, out, err = results.get(timeout=1.0)
            except queue.Empty:
                waiting = sorted(set(range(world)) - set(got))
                dead = [r for r in waiting if procs[r].exitcode is not None]
                if dead:
                    raise RankFailure(f"ranks {dead} exited ({[procs[r].exitcode for r in dead]}) "
                                      "without a result") from None
                if time.monotonic() > deadline:
                    raise RankFailure(f"ranks {waiting} gave no result in {timeout_s} s") from None
                continue
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
                break
            got[rank] = out
    finally:
        # the results are drained before the joins (a process that wrote to
        # a queue is joined only after its data is read)
        for p in procs:
            p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors:
        raise RankFailure("\n".join(errors))
    return {name: [got[r][name] for r in range(world)] for name, _, _ in cases}


def clean_env() -> dict:
    """This process's env without the names of a pod's bring-up, with the
    repository on PYTHONPATH."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(POD_PREFIXES) and k not in POD_NAMES}
    env["PYTHONPATH"] = REPO
    return env


def statefulset() -> dict:
    """The JSON of a notebook's StatefulSet before a slice is put in."""
    return {"metadata": {"name": "nb", "namespace": "user", "labels": {"notebook-name": "nb"}},
            "spec": {"replicas": 1, "serviceName": "nb-hosts",
                     "template": {"spec": {"containers": [{"name": "nb", "image": "img"}]}}}}


def pod_env(shape, ordinal: int, master=None) -> dict:
    """One pod's env as gpu.apply_slice renders it into the primary
    container, the downward API resolved to the pod's ordinal. `master`
    (host, port) replaces the rendered PET_MASTER_ADDR/PORT: there is no
    cluster DNS off the cluster."""
    from odh_kubeflow_tpu_torch.gpu import apply_slice

    env = {}
    for e in apply_slice(statefulset(), shape)["spec"]["template"]["spec"]["containers"][0]["env"]:
        env[e["name"]] = str(ordinal) if "valueFrom" in e else e["value"]
    env.setdefault("PET_NODE_RANK", str(ordinal))
    if master is not None:
        env.update(PET_MASTER_ADDR=master[0], PET_MASTER_PORT=str(master[1]))
    return env


def stop(proc) -> None:
    """SIGTERM to the process's group (torchrun then stops its workers, each
    in a session of its own), SIGKILL after a grace period."""
    if proc.poll() is not None:
        return
    os.killpg(proc.pid, signal.SIGTERM)
    try:
        proc.wait(timeout=20)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def run_processes(commands, log_dir, timeout_s: float) -> list:
    """Starts every (argv, env) at once from the repository, each in a
    session of its own with its output in LOG_DIR/process-I.log, waits for
    all against one deadline and stops every one still running. Returns
    [(exit code, or "no exit in N s", log text)]."""
    procs, codes = [], []
    try:
        for i, (argv, env) in enumerate(commands):
            with open(os.path.join(log_dir, f"process-{i}.log"), "w") as log:
                procs.append(subprocess.Popen(argv, env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                                              start_new_session=True))
        deadline = time.monotonic() + timeout_s
        for proc in procs:
            try:
                codes.append(proc.wait(timeout=max(0.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(f"no exit in {timeout_s} s")
    finally:
        for proc in procs:
            stop(proc)
    out = []
    for i, code in enumerate(codes):
        with open(os.path.join(log_dir, f"process-{i}.log")) as log:
            out.append((code, log.read()))
    return out
