#!/usr/bin/env python3
"""chip_smoke.py's phase 9 alone on one NVIDIA Hopper card: the kernels
built from this checkout, the flagship serving model (phase 5's
configuration, random weights from seed 0), then `chip_smoke.router_phase`
(two engines behind the TokenRouter with PROFILE=1 and TORCHGUARD=1;
routed, drained and hedged requests, where_time_went, the guard's counts,
the router's added latency, a burst's host time with the profiler and
guard off and on). It fails as the smoke does.

    python3 tools/router_phase.py     # from the repository root
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from odh_kubeflow_tpu_torch.models import TransformerConfig, init_params  # noqa: E402
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
    cfg = TransformerConfig(vocab=32768, d_model=1024, n_layers=8, n_heads=8, d_ff=4096,
                            max_seq=2048, dtype=torch.bfloat16, use_flash=True, remat=False)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    print("launches", chip_smoke.router_phase(attention, smi, cfg, params), flush=True)


if __name__ == "__main__":
    main()
