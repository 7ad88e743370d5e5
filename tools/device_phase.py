#!/usr/bin/env python3
"""chip_smoke.py's phase 14 alone on one NVIDIA Hopper card: the kernels
built from this checkout, then `chip_smoke.device_phase` (ranks started by
`python -m torch.distributed.run` from the env that the port's GPU planner
renders into a pod: (a) one host x one card, a fresh launch serving the
flagship and training it; (b) two hosts x two cards, 4 ranks
sharing the card on gloo, fsdp 2 x tp 2 against one process). It fails as
the smoke does.

    python3 tools/device_phase.py     # from the repository root
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from odh_kubeflow_tpu_torch.ops import _build, attention  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: this needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    print("launches", chip_smoke.device_phase(attention, smi), flush=True)


if __name__ == "__main__":
    main()
