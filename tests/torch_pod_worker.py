"""The container command of tests/torch_operator_flow.py's notebook pods,
started by `python -m torch.distributed.run` from the env the port's
reconciler rendered. Imports no jax.

    torch_pod_worker.py DEVICE OUT_DIR

Each rank brings the world up with the port's `initialize_from_env`, puts a
tensor on DEVICE ("cpu", or "cuda": the rank's card, which creates its CUDA
context), writes its env, rank, pid, the time its tensor was on the device
(its CUDA context) and the time it was done to
OUT_DIR/rank-R.json (written whole, then renamed), and holds until
SIGTERM, as a notebook kernel holds its card.
"""
import json
import os
import signal
import sys
import threading
import time

import torch

NAMES = ("PET_STANDALONE", "PET_NPROC_PER_NODE", "PET_NNODES", "NB_TPU_CHIPS_EXPECTED", "NB_TPU_HOSTS",
         "TPU_ACCELERATOR_TYPE", "TPU_TOPOLOGY", "RANK", "LOCAL_RANK", "WORLD_SIZE")


def main(device: str, out_dir: str) -> None:
    from odh_kubeflow_tpu_torch.parallel import initialize_from_env, rank_device

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    torch.set_num_threads(1)
    rank, world = initialize_from_env(timeout_s=60, device=device)
    dev = rank_device(device)
    x = torch.ones(64, 64, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    context = time.time()
    total = float((x @ x).sum())
    out = {"rank": rank, "world": [rank, world], "device": str(dev), "pid": os.getpid(), "ppid": os.getppid(),
           "sum": total, "env": {n: os.environ.get(n) for n in NAMES}, "times": {"context": context, "done": time.time()}}
    path = os.path.join(out_dir, f"rank-{rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)
    stop.wait()


if __name__ == "__main__":
    main(*sys.argv[1:3])
