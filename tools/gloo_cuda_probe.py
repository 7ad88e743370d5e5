#!/usr/bin/env python3
"""Does the gloo backend move a CUDA tensor? Two processes on one card
(gloo, as the port's phase 10 runs its ranks) try, each in a child process
of its own so that a crash is a reading and not the end of the probe:
point-to-point (isend/irecv of a CUDA tensor, received into a CUDA
tensor) and all_reduce of a CUDA tensor. Prints one line per op: "moved",
"wrong values", "raised: ..." or "crashed (exit code N)".

    python3 tools/gloo_cuda_probe.py     # on a machine with a card
"""
import multiprocessing
import socket
import sys
import traceback

import torch


def _rank(rank, port, op, results):
    try:
        import datetime

        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
                                timeout=datetime.timedelta(seconds=60))
        t = torch.full((1024,), float(rank + 1), device="cuda")
        if op == "p2p":
            recv = torch.zeros(1024, device="cuda")
            works = dist.batch_isend_irecv([dist.P2POp(dist.isend, t, 1 - rank),
                                            dist.P2POp(dist.irecv, recv, 1 - rank)])
            for w in works:
                w.wait()
            ok = bool((recv == float(2 - rank)).all())
        else:
            dist.all_reduce(t)
            ok = bool((t == 3.0).all())
        dist.destroy_process_group()
        results.put((rank, "moved" if ok else "wrong values"))
    except Exception as e:  # the reading is the exception
        results.put((rank, f"raised: {type(e).__name__}: {str(e).splitlines()[0][:200]}"))
        traceback.print_exc()


def probe(op):
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=_rank, args=(r, port, op, results)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    readings = {}
    while not results.empty():
        rank, reading = results.get()
        readings[rank] = reading
    for r, p in enumerate(procs):
        readings.setdefault(r, f"crashed (exit code {p.exitcode})")
    return readings


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    for op in ("p2p", "all_reduce"):
        print(f"gloo {op} of a CUDA tensor: {probe(op)}", flush=True)


if __name__ == "__main__":
    main()
