#!/usr/bin/env python3
"""chip_smoke.py's phase 5 serving episode, repeated, from a checkout the
caller names: the flagship model (random weights from seed 0) in a fresh
engine (8 slots, max_seq 512, burst 8, check_syncs) behind the HTTP
server, 8 clients at once (prompt 128, max_new from MAX_NEWS); each
repetition prints the smoke's line (tokens/s over HTTP, TTFT median and
max). To compare two commits on one card, unpack both and run them in
turns in one call (parent, change, change, parent):

    python3 tools/serving_ab.py CHECKOUT [--reps N]
"""
import argparse
import subprocess
import sys
from pathlib import Path


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("checkout", type=Path)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()
    sys.path.insert(0, str(args.checkout.resolve()))

    import numpy as np
    import torch

    import chip_smoke
    from odh_kubeflow_tpu_torch.models import TransformerConfig, init_params
    from odh_kubeflow_tpu_torch.ops import _build, attention
    from odh_kubeflow_tpu_torch.serving.engine import ServingEngine

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: this needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"{args.checkout}: {smi}", flush=True)
    _build.build_all()
    cfg = TransformerConfig(vocab=32768, d_model=1024, n_layers=8, n_heads=8, d_ff=4096,
                            max_seq=2048, dtype=torch.bfloat16, use_flash=True, remat=False)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 128).tolist() for _ in chip_smoke.MAX_NEWS]
    for _ in range(args.reps):
        engine = chip_smoke.warm_engine(ServingEngine(params, cfg, max_slots=8, max_seq=512,
                                                      decode_burst=8, check_syncs=True, device="cuda"))
        chip_smoke.serve_over_http(engine, prompts, attention)


if __name__ == "__main__":
    main()
