#!/usr/bin/env python3
"""chip_smoke.py's phase 10 alone on one NVIDIA Hopper card: the kernels
built from this checkout, then `chip_smoke.sp_phase` (ranks spawned on the
card and brought up from the webhook's env names on gloo: the f32 ring and
a 2-layer f32 model against one process, then the flagship sp train step at
sp 2 contiguous and zigzag and sp 4 contiguous). It fails as the smoke does.

    python3 tools/sp_phase.py     # from the repository root
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
    ranks = chip_smoke._RankPool(chip_smoke.RANK_POOL_WORLD)
    try:
        print("launches", chip_smoke.sp_phase(attention, smi, ranks), flush=True)
    finally:
        ranks.close()


if __name__ == "__main__":
    main()
