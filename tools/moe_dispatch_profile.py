#!/usr/bin/env python3
"""Where the MoE path's device time goes on one NVIDIA Hopper card, at the
configuration of bench.py:389-400 (chip_smoke.py phase 8's model, batch 8
x 2048): routing, dispatch and combine at the step's 16384 tokens, each by
CUDA-graph replay (chip_smoke.time_ms), beside the cumulative sum of the
routing one-hots in both layouts (token-major (N, E) down dim 0, and
expert-major (E, N) along dim 1) and in three dtypes; then a profiler table
of one `dispatch_only` call and of one train step (remat_policy ""), by
kernel.

    python3 tools/moe_dispatch_profile.py     # from the repository root
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from odh_kubeflow_tpu_torch.models import (  # noqa: E402
    MoEConfig,
    TransformerConfig,
    init_params,
    make_train_step,
    moe,
    transformer,
)
from odh_kubeflow_tpu_torch.ops import _build  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this profile needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.build_all()
    cfg = TransformerConfig(vocab=32768, d_model=1024, n_layers=8, n_heads=8, d_ff=2048, max_seq=2048,
                            dtype=torch.bfloat16, remat=True, remat_policy="",
                            moe=MoEConfig(n_experts=8, experts_per_token=2, capacity_factor=1.25))
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (8, 2048)), device="cuda")
    x = params["embed"][tokens]
    lp = transformer.layer_view(params, 0)
    mc = cfg.moe_resolved
    k = mc.experts_per_token
    flat, cap, logits = moe._route(x, lp, mc)
    choice, gate, pos, keep, _aux = moe.route_indices(logits, k, cap)
    expert_in, dest, slot_pick = moe._indexed_dispatch(flat, choice, pos, keep, mc.n_experts, cap)
    onehot = moe._one_hot(choice[:, 0], mc.n_experts)
    parts = {
        "dispatch_only": lambda: moe.dispatch_only(x, lp, mc),
        "router logits": lambda: moe._route(x, lp, mc),
        "route_indices": lambda: moe.route_indices(logits, k, cap),
        "_indexed_dispatch": lambda: moe._indexed_dispatch(flat, choice, pos, keep, mc.n_experts, cap),
        "_indexed_combine": lambda: moe._indexed_combine(expert_in, dest, slot_pick, gate, keep, x.dtype),
        "cumsum (N,E) int64 dim0": lambda: onehot.cumsum(dim=0),
        "cumsum (E,N) int64 dim1": lambda: onehot.t().contiguous().cumsum(dim=1),
        "cumsum (N,E) int32 dim0": lambda: onehot.int().cumsum(dim=0),
        "cumsum (N,E) f32 dim0": lambda: onehot.float().cumsum(dim=0),
        "softmax": lambda: torch.softmax(logits, -1),
        "expert_mlp": lambda: moe._expert_mlp(expert_in, lp, x.dtype),
    }
    for name, fn in parts.items():
        print(f"  {name}: {cs.time_ms(fn, runs=10, reps=5):.4f} ms on {smi}", flush=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        moe.dispatch_only(x, lp, mc)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15, max_name_column_width=70))
    step, opt = make_train_step(cfg)
    state = opt.init(params)
    batch = {"tokens": tokens}
    step(params, state, batch)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(params, state, batch)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30, max_name_column_width=90))


if __name__ == "__main__":
    main()
