#!/usr/bin/env python3
"""Where a pod worker's CUDA context stamp falls against what the card's
readiness gate reads, on one NVIDIA card.

The gate (`probe.behavior.cards_in_context`) counts a card once a process of
the pod maps both the card's node and /dev/nvidia-uvm. The test worker
(tests/torch_pod_worker.py) and chip_smoke.py's worker stamp their context
after `torch.empty(1, device=dev)` and a synchronize. This starts `torchrun`
(standalone, one rank) PAIRS times two at once, as a wave of two notebook
pods starts, for each of two workers:

- "pod": the test worker's start: `rank_device`, then the stamp before and
  after `torch.empty` and the synchronize;
- "driver": the same, with the primary context made first through the
  driver (`cuInit`, then `cuDevicePrimaryCtxRetain`), each call stamped.

Meanwhile this process polls every POLL_S the gate's predicate over each
launch's process tree, how many regions of each NVIDIA device node each of
its processes maps, the names of its threads, and nvidia-smi's compute
apps. Prints one JSON line a
launch, each time in seconds after the worker's stamp (`torch.empty`
returned; negative: before it), then the card's name and power limit.

    python3 tools/context_stamp.py     # from the repository root
"""
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

STARTED = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PAIRS = int(os.environ.get("CONTEXT_STAMP_PAIRS", "3"))
POLL_S = 0.002


def worker(variant: str, out_path: str) -> None:
    times = {"started": STARTED}
    import torch

    from odh_kubeflow_tpu_torch.parallel import rank_device

    times["imported"] = time.time()
    dev = rank_device("cuda")
    times["rank_device"] = time.time()
    if variant == "driver":
        cuda = ctypes.CDLL("libcuda.so.1")
        if cuda.cuInit(0) != 0:
            raise SystemExit("cuInit failed")
        times["cuInit"] = time.time()
        handle, ctx = ctypes.c_int(), ctypes.c_void_p()
        if cuda.cuDeviceGet(ctypes.byref(handle), dev.index) != 0:
            raise SystemExit("cuDeviceGet failed")
        times["retain called"] = time.time()
        if cuda.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), handle) != 0:
            raise SystemExit("cuDevicePrimaryCtxRetain failed")
        times["retain returned"] = time.time()
    times["empty called"] = time.time()
    torch.empty(1, device=dev)
    torch.cuda.synchronize(dev)
    times["context"] = time.time()
    x = torch.ones(64, 64, device=dev)
    float((x @ x).sum())
    times["first kernel"] = time.time()
    with open(out_path + ".tmp", "w") as f:
        json.dump({"pid": os.getpid(), "times": times}, f)
    os.replace(out_path + ".tmp", out_path)
    time.sleep(1.0)


def _compute_apps(seen: dict, stop: threading.Event) -> None:
    """pid -> the first time nvidia-smi listed it as a compute app."""
    while not stop.is_set():
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout
        now = time.time()
        for line in out.split():
            if line.strip().isdigit():
                seen.setdefault(int(line), now)


NODE = re.compile(r"/dev/(nvidiactl|nvidia-uvm|nvidia\d+)$")


def _maps(pid: int) -> tuple:
    """How many regions of each NVIDIA device node pid maps, sorted."""
    counts = {}
    try:
        with open(f"/proc/{pid}/maps") as f:
            for line in f:
                m = NODE.search(line.rstrip())
                if m:
                    counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    except OSError:
        pass
    return tuple(sorted(counts.items()))


def _threads(pid: int) -> set:
    """The names of pid's threads."""
    out = set()
    try:
        for tid in os.listdir(f"/proc/{pid}/task"):
            try:
                with open(f"/proc/{pid}/task/{tid}/comm") as f:
                    out.add(f.read().strip())
            except OSError:
                continue
    except OSError:
        pass
    return out


def launch(tmp: str, variant: str, i: int, smi_seen: dict) -> dict:
    from odh_kubeflow_tpu_torch.probe.behavior import cards_in_context, process_tree

    out_path = os.path.join(tmp, f"{variant}-{i}.json")
    env = dict(os.environ, PET_STANDALONE="1", PET_NPROC_PER_NODE="1", OMP_NUM_THREADS="1")
    with open(os.path.join(tmp, f"{variant}-{i}.log"), "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", os.path.abspath(__file__),
                                 "--worker", variant, out_path], env=env, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
    t_launch, gate = time.time(), None
    maps = {}  # (process, its mapped regions by node) -> first seen
    threads = {}  # (process, a thread's name) -> first seen
    while proc.poll() is None:
        now = time.time()
        if gate is None and cards_in_context(proc.pid):
            gate = now
        for pid in process_tree(proc.pid):
            role = "launcher" if pid == proc.pid else "worker"
            maps.setdefault((role, _maps(pid)), now)
            for name in _threads(pid):
                threads.setdefault((role, name), now)
        time.sleep(POLL_S)
    if proc.returncode != 0 or not os.path.exists(out_path):
        with open(os.path.join(tmp, f"{variant}-{i}.log")) as f:
            raise SystemExit(f"{variant} launch {i} exited {proc.returncode}:\n{f.read()[-3000:]}")
    with open(out_path) as f:
        got = json.load(f)
    stamp = got["times"]["context"]
    listed = smi_seen.get(got["pid"])
    return {"variant": variant, "launch": i, "launched": round(t_launch - stamp, 4),
            "worker": {k: round(v - stamp, 4) for k, v in got["times"].items()},
            "gate": None if gate is None else round(gate - stamp, 4),
            "nvidia-smi listed": None if listed is None else round(listed - stamp, 4),
            "maps": [[role, dict(regions), round(t - stamp, 4)] for (role, regions), t in
                     sorted(maps.items(), key=lambda kv: kv[1]) if regions],
            "threads": [[role, name, round(t - stamp, 4)] for (role, name), t in
                        sorted(threads.items(), key=lambda kv: kv[1])]}


def main() -> None:
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], sys.argv[3])
        return
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    torch.empty(1, device="cuda")  # this process holds a context, as the test process does
    seen, stop = {}, threading.Event()
    poller = threading.Thread(target=_compute_apps, args=(seen, stop), daemon=True)
    poller.start()
    results = []
    try:
        with tempfile.TemporaryDirectory(prefix="context-stamp-") as tmp:
            for variant in ("pod", "driver"):
                for pair in range(PAIRS):
                    got = [None, None]
                    threads = [threading.Thread(target=lambda k=k: got.__setitem__(
                        k, launch(tmp, variant, 2 * pair + k, seen))) for k in range(2)]
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join()
                    for r in got:
                        if r is None:
                            raise SystemExit(f"{variant} pair {pair}: a launch gave no result")
                        print(json.dumps(r), flush=True)
                        results.append(r)
    finally:
        stop.set()
        poller.join(timeout=60)
    for variant in ("pod", "driver"):
        gates = [r["gate"] for r in results if r["variant"] == variant and r["gate"] is not None]
        calls = [r["worker"]["empty called"] for r in results if r["variant"] == variant]
        print(f"{variant}: the gate's predicate held {min(gates):+.4f} .. {max(gates):+.4f} s after the stamp; "
              f"torch.empty called {min(calls):+.4f} .. {max(calls):+.4f} s", flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
