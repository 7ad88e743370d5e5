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
"""
import importlib
import multiprocessing
import os
import queue
import socket
import time
import traceback

INIT_TIMEOUT_S = 60
RUN_TIMEOUT_S = 300


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
