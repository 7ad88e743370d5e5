#!/usr/bin/env python3
"""Does the gloo backend move a CUDA tensor? Two processes on one card
(gloo, as the port's phases 10 and 11 run their ranks) try each op on CUDA
tensors: point-to-point (isend/irecv, received into a CUDA tensor) in a
pair of processes of its own, and all_reduce, all_gather_into_tensor,
reduce_scatter_tensor and broadcast one after another in a second pair
(both pairs at once), so that a crash is a reading and not the end of the
probe. Prints one line per op and rank: "moved", "wrong values",
"raised: ...", "crashed (exit code N)" or "not reached" (an earlier op of
its pair crashed).

    python3 tools/gloo_cuda_probe.py     # on a machine with a card
"""
import multiprocessing
import queue
import socket
import sys
import traceback
from concurrent.futures import ThreadPoolExecutor

import torch

COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor", "broadcast")


def _run(op, rank):
    """Runs one op between the two ranks; whether the values came out right."""
    import torch.distributed as dist

    n = 1024
    t = torch.full((n,), float(rank + 1), device="cuda")
    if op == "p2p":
        recv = torch.zeros(n, device="cuda")
        works = dist.batch_isend_irecv([dist.P2POp(dist.isend, t, 1 - rank),
                                        dist.P2POp(dist.irecv, recv, 1 - rank)])
        for w in works:
            w.wait()
        return bool((recv == float(2 - rank)).all())
    if op == "all_reduce":
        dist.all_reduce(t)
        return bool((t == 3.0).all())
    if op == "all_gather_into_tensor":
        out = torch.zeros(2 * n, device="cuda")
        dist.all_gather_into_tensor(out, t)
        return bool((out[:n] == 1.0).all() and (out[n:] == 2.0).all())
    if op == "reduce_scatter_tensor":
        full = torch.cat([t, 10 * t])
        out = torch.zeros(n, device="cuda")
        dist.reduce_scatter_tensor(out, full)
        return bool((out == (3.0 if rank == 0 else 30.0)).all())
    if op == "broadcast":
        dist.broadcast(t, src=1)
        return bool((t == 2.0).all())
    raise ValueError(op)


def _rank(rank, port, ops, results):
    import datetime

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    for op in ops:
        try:
            ok = _run(op, rank)
            torch.cuda.synchronize()
            results.put((rank, op, "moved" if ok else "wrong values"))
        except Exception as e:  # the reading is the exception
            results.put((rank, op, f"raised: {type(e).__name__}: {str(e).splitlines()[0][:200]}"))
            traceback.print_exc()
    dist.destroy_process_group()


def probe(ops):
    """{op: {rank: reading}} of one pair of processes running `ops` in turn."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=_rank, args=(r, port, ops, results)) for r in range(2)]
    for p in procs:
        p.start()
    readings = {op: {} for op in ops}
    while any(p.is_alive() for p in procs) or not results.empty():
        try:
            rank, op, reading = results.get(timeout=1.0)
        except queue.Empty:
            continue
        readings[op][rank] = reading
    for p in procs:
        p.join(timeout=120)
        if p.is_alive():
            p.kill()
            p.join()
    for r, p in enumerate(procs):
        crashed = False
        for op in ops:
            if r not in readings[op]:
                readings[op][r] = "not reached" if crashed else f"crashed (exit code {p.exitcode})"
                crashed = True
    return readings


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    with ThreadPoolExecutor(2) as pool:
        pairs = list(pool.map(probe, (("p2p",), COLLECTIVES)))
    for readings in pairs:
        for op, reading in readings.items():
            print(f"gloo {op} of a CUDA tensor: {dict(sorted(reading.items()))}", flush=True)


if __name__ == "__main__":
    main()
