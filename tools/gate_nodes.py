#!/usr/bin/env python3
"""When a torchrun pod's processes first hold each NVIDIA device node, beside
the worker's own CUDA steps: what a readiness gate that reads the pod's
processes from /proc can tell apart.

Starts `torchrun` (standalone, one rank) LAUNCHES times, as a notebook pod
starts it, over a worker that records its clock at each step: its first
line, `import torch`, `torch.cuda.device_count()` (the driver's
initialisation), `torch.cuda.set_device`, the first tensor on the card
(its CUDA context), each step a pause apart so the steps stay apart in the
readings. Meanwhile this process polls /proc every POLL_S for each process
of the tree: the first time each of /dev/nvidiactl, /dev/nvidia-uvm and
/dev/nvidiaN is held open (an fd) and mapped (a line of /proc/PID/maps),
by the launcher or the worker. Prints one JSON line a launch, each time in
seconds after the worker's CUDA context (negative: before it), and the
card's name and power limit. Needs an NVIDIA card.

    python3 tools/gate_nodes.py     # from the repository root
"""
import json
import os
import re
import subprocess
import sys
import tempfile
import time

STARTED = time.time()

LAUNCHES = 3
POLL_S = 0.005
PAUSE_S = 1.0
NODE = re.compile(r"/dev/(nvidiactl|nvidia-uvm|nvidia\d+)\b")


def worker(out_path: str) -> None:
    times = {"started": STARTED}
    import torch

    times["imported"] = time.time()
    torch.cuda.device_count()
    times["device_count"] = time.time()
    time.sleep(PAUSE_S)
    torch.cuda.set_device(0)
    times["set_device"] = time.time()
    time.sleep(PAUSE_S)
    torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    times["context"] = time.time()
    with open(out_path + ".tmp", "w") as f:
        json.dump({"pid": os.getpid(), "times": times}, f)
    os.replace(out_path + ".tmp", out_path)
    time.sleep(PAUSE_S)


def _tree(root: int):
    children = {}
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            children.setdefault(int(stat[stat.rindex(")") + 2:].split()[1]), []).append(int(entry))
    out, todo = [], [root]
    while todo:
        p = todo.pop()
        out.append(p)
        todo += children.get(p, [])
    return out


def _held(pid: int):
    """(node, "fd"|"map") pairs the process holds now."""
    out = set()
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                m = NODE.fullmatch(os.readlink(f"/proc/{pid}/fd/{fd}"))
            except OSError:
                continue
            if m:
                out.add((m.group(1), "fd"))
        with open(f"/proc/{pid}/maps") as f:
            for line in f:
                m = NODE.search(line)
                if m:
                    out.add((m.group(1), "map"))
    except OSError:
        pass
    return out


def launch(tmp: str, i: int) -> dict:
    out_path = os.path.join(tmp, f"worker-{i}.json")
    env = dict(os.environ, PET_STANDALONE="1", PET_NPROC_PER_NODE="1", OMP_NUM_THREADS="1")
    with open(os.path.join(tmp, f"launch-{i}.log"), "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", os.path.abspath(__file__),
                                 "--worker", out_path], env=env, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
    t_launch = time.time()
    first = {}  # (role, node, kind) -> time
    while proc.poll() is None:
        now = time.time()
        for pid in _tree(proc.pid):
            role = "launcher" if pid == proc.pid else "worker"
            for node, kind in _held(pid):
                first.setdefault(f"{role} {kind} {node}", now)
        time.sleep(POLL_S)
    if proc.returncode != 0 or not os.path.exists(out_path):
        with open(os.path.join(tmp, f"launch-{i}.log")) as f:
            raise SystemExit(f"launch {i} exited {proc.returncode}:\n{f.read()[-3000:]}")
    with open(out_path) as f:
        got = json.load(f)
    ctx = got["times"]["context"]
    return {"launch": i, "launched": round(t_launch - ctx, 4),
            "worker": {k: round(v - ctx, 4) for k, v in got["times"].items()},
            "held": {k: round(v - ctx, 4) for k, v in sorted(first.items(), key=lambda kv: kv[1])}}


def main() -> None:
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    with tempfile.TemporaryDirectory(prefix="gate-nodes-") as tmp:
        for i in range(LAUNCHES):
            print(json.dumps(launch(tmp, i)), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
