#!/usr/bin/env python3
"""chip_smoke.py's phase 13 alone on one NVIDIA Hopper card: the kernels
built from this checkout, then `chip_smoke.pp_phase` (4 ranks spawned on
the card and brought up from the webhook's env names on gloo: the f32
pipelines against one process, the flagship's 1F1B at pp 2 x tp 2 with
its checkpoint through every rank's agent, interleaved 1F1B at pp 2 x
fsdp 2, phase 8's MoE at pp 2 x ep 2, GPipe at pp 2 x sp 2 zigzag, and the
peak memory of GPipe against 1F1B). It fails as the smoke does.

    python3 tools/pp_phase.py     # from the repository root
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
    print("launches", chip_smoke.pp_phase(attention, smi), flush=True)


if __name__ == "__main__":
    main()
