"""The script tests/test_torch_torchrun.py starts in each rank, through
`python -m torch.distributed.run` (the GPU pod's env) or as a plain process
(the reference's JAX_* names). Imports no jax.

    torch_torchrun_worker.py INPUTS.pkl OUT_DIR

It brings the world up with the port's `initialize_from_env` on gloo on the
CPU, plans the mesh with `slice_mesh_axes` over the slice the env names
(`gpu.slice_from_env`; without it, the plan in the inputs), and runs
tests/torch_shard_cases.py's model_case on it. Its result, with the
torchrun names it was given and its tp group, goes to OUT_DIR/rank-R.pkl.
"""
import os
import pickle
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))  # torch_shard_cases, beside this file

TORCHRUN_NAMES = ("RANK", "LOCAL_RANK", "GROUP_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE")


def main(inputs_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from odh_kubeflow_tpu_torch.gpu import slice_from_env
    from odh_kubeflow_tpu_torch.parallel import MeshPlan, initialize_from_env, slice_mesh_axes
    from torch_shard_cases import model_case

    torch.set_num_threads(1)
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    rank, world = initialize_from_env(timeout_s=60, device="cpu")
    if os.environ.get("TPU_TOPOLOGY"):
        plan = slice_mesh_axes(slice_from_env())
    else:
        plan = MeshPlan(**inputs["plan"])
    sizes = {a: n for a, n in plan.sizes().items() if n > 1}
    mesh = plan.build("cpu")
    out = {"rank": rank, "world": world, "plan": sizes, "tp_ranks": mesh.ranks("tp"),
           "env": {n: os.environ.get(n) for n in TORCHRUN_NAMES},
           "case": model_case(rank, world, inputs["params"], inputs["batch"], inputs["cfg"], sizes, None)}
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank-{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:3])
