#!/usr/bin/env python3
"""chip_smoke.py's phase 12 alone on one NVIDIA Hopper card: the kernels
built from this checkout, then `chip_smoke.ep_phase` (ranks spawned on the
card and brought up from the webhook's env names on gloo: generate(mesh=)
of the flagship at tp 2 and fsdp 2 x tp 2 against one process, tp 4 with
n_kv_heads 2, and bench.py:389-400's MoE train step at ep 2 x tp 2 and
ep 2 x fsdp 2 with the checkpoint through every rank's agent, restored
onto one process). It fails as the smoke does.

    python3 tools/ep_phase.py     # from the repository root
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    print("launches", chip_smoke.ep_phase(attention, smi), flush=True)


if __name__ == "__main__":
    main()
