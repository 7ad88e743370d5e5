"""Bring-up through torchrun on the CPU, from the env the port's GPU planner
renders into a pod.

Two `python -m torch.distributed.run` processes play the two pods of an
h100 "2x2" slice: each is started with the env of its StatefulSet's
primary container (gpu.apply_slice: PET_NNODES 2, PET_NPROC_PER_NODE 2,
the roster) and its node rank (the ordinal env's downward-API value), the
master address replaced by 127.0.0.1 and a free port (there is no cluster
DNS here). Each starts 2 workers (tests/torch_torchrun_worker.py): they
bring the world up with `initialize_from_env(device="cpu")` on gloo, plan
`slice_mesh_axes(shape)` (fsdp 2 x tp 2) and run
tests/torch_shard_cases.py's model_case at tests/test_torch_shard.py's
tiny config. Checked: RANK = node_rank x 2 + LOCAL_RANK, a world of 4,
each tp group one pod's ranks, and the sharded loss and gathered
gradients within 1e-5 of the JAX loss_fn and jax.grad on the full batch.
A second case starts the same worker as 4 plain processes under the
reference's JAX_* names: they still bring the world up, unchanged.

Every subprocess has a timeout (PROCESS_TIMEOUT_S) and is stopped on expiry
(torchrun's workers with it), so a hung rendezvous fails the test and never
holds the run.
"""
import dataclasses
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist
import torch_threads
from odh_kubeflow_tpu.models import TransformerConfig as JaxConfig
from odh_kubeflow_tpu.models import init_params as jax_init_params
from odh_kubeflow_tpu.models import loss_fn as jax_loss_fn
from odh_kubeflow_tpu_torch.gpu import apply_slice, plan_slice
from odh_kubeflow_tpu_torch.models import TransformerConfig

torch_threads.cap()

WORKER = Path(__file__).resolve().parent / "torch_torchrun_worker.py"
PROCESS_TIMEOUT_S = 120
ATOL = 1e-5
JCFG = JaxConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
                 dtype=jnp.float32, use_flash=False, remat=False)
TOKENS = np.random.default_rng(1).integers(0, JCFG.vocab, (4, 32)).astype(np.int32)
TOPOLOGY = "2x2"


def port_cfg(jcfg, **kw):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(TransformerConfig)}
    fields.update(dtype="float32", **kw)
    return TransformerConfig(**fields)


def _ranks(commands, tmp: Path, world: int):
    results = torch_dist.run_processes(commands, tmp, PROCESS_TIMEOUT_S)
    bad = [f"process {i} exited {code}:\n{log[-3000:]}" for i, (code, log) in enumerate(results) if code != 0]
    assert not bad, "\n".join(bad)
    got = {}
    for r in range(world):
        with open(tmp / "out" / f"rank-{r}.pkl", "rb") as f:
            got[r] = pickle.load(f)
    return got


def _inputs(tmp: Path, reference, plan=None) -> Path:
    path = tmp / "inputs.pkl"
    (tmp / "out").mkdir()
    cfg = port_cfg(JCFG, use_flash=True, remat=True, remat_policy="flash")
    with open(path, "wb") as f:
        pickle.dump({"params": reference[0], "batch": {"tokens": TOKENS}, "cfg": cfg, "plan": plan}, f)
    return path


@pytest.fixture(scope="module")
def reference():
    """The JAX init (numpy) and the JAX loss and gradients on the full batch."""
    params = jax.device_get(jax_init_params(jax.random.PRNGKey(0), JCFG))
    loss, grads = jax.value_and_grad(jax_loss_fn)(params, {"tokens": jnp.asarray(TOKENS)}, JCFG)
    nparams = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)
    return nparams, float(loss), [np.asarray(g) for g in jax.tree_util.tree_leaves(jax.device_get(grads))]


@pytest.fixture(scope="module")
def pods(reference, tmp_path_factory):
    """The 4 ranks of two torchrun "pods", by global rank."""
    tmp = tmp_path_factory.mktemp("torchrun")
    inputs = _inputs(tmp, reference)
    shape = plan_slice("h100", topology=TOPOLOGY)
    master = ("127.0.0.1", torch_dist.free_port())
    commands = [([sys.executable, "-m", "torch.distributed.run", str(WORKER), str(inputs), str(tmp / "out")],
                 {**torch_dist.clean_env(), **torch_dist.pod_env(shape, node, master)})
                for node in range(shape.hosts)]
    return shape, _ranks(commands, tmp, shape.chips)


@pytest.fixture(scope="module")
def reference_env_ranks(reference, tmp_path_factory):
    """The same worker as 4 plain processes brought up by the reference's
    JAX_* names (tests/torch_dist.py's webhook_env), no torchrun."""
    tmp = tmp_path_factory.mktemp("jax-env")
    inputs = _inputs(tmp, reference, plan={"fsdp": 2, "tp": 2})
    port = torch_dist.free_port()
    commands = [([sys.executable, str(WORKER), str(inputs), str(tmp / "out")],
                 {**torch_dist.clean_env(), **torch_dist.webhook_env(r, 4, port)}) for r in range(4)]
    return _ranks(commands, tmp, 4)


def test_pod_env_is_the_rendered_slice():
    shape = plan_slice("h100", topology=TOPOLOGY)
    env = torch_dist.pod_env(shape, 1, ("127.0.0.1", 1234))
    assert (env["PET_NNODES"], env["PET_NPROC_PER_NODE"], env["PET_NODE_RANK"]) == ("2", "2", "1")
    assert env["NB_TPU_CHIPS_EXPECTED"] == "4" and env["TPU_TOPOLOGY"] == TOPOLOGY
    rendered = apply_slice(torch_dist.statefulset(), shape)["spec"]["template"]["spec"]["containers"][0]["env"]
    master = next(e["value"] for e in rendered if e["name"] == "PET_MASTER_ADDR")
    assert master == "nb-0.nb-hosts.user.svc.cluster.local"  # replaced above: no cluster DNS here
    assert (env["PET_MASTER_ADDR"], env["PET_MASTER_PORT"]) == ("127.0.0.1", "1234")
    assert not [n for n in env if n.startswith("JAX_")]


def test_ranks_are_node_rank_times_cards_plus_local_rank(pods):
    shape, ranks = pods
    assert sorted(ranks) == [0, 1, 2, 3]
    for r, got in ranks.items():
        env = got["env"]
        node, local = int(env["GROUP_RANK"]), int(env["LOCAL_RANK"])
        assert int(env["RANK"]) == r == node * shape.chips_per_host + local == got["rank"]
        assert int(env["WORLD_SIZE"]) == got["world"] == shape.chips == 4
        assert int(env["LOCAL_WORLD_SIZE"]) == shape.chips_per_host


def test_slice_mesh_axes_puts_each_tp_group_on_one_pod(pods):
    shape, ranks = pods
    for r, got in ranks.items():
        assert got["plan"] == {"fsdp": 2, "tp": 2}
        node = int(got["env"]["GROUP_RANK"])
        assert got["tp_ranks"] == [node * 2, node * 2 + 1]


def _check_case(ranks, reference):
    _, want_loss, want_grads = reference
    losses = {got["case"]["loss"] for got in ranks.values()}
    assert len(losses) == 1  # the global loss, the same bits on every rank
    assert abs(losses.pop() - want_loss) < ATOL
    grads = ranks[0]["case"]["grads"]
    assert len(grads) == len(want_grads)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_sharded_loss_and_grads_match_jax_full_batch(pods, reference):
    _check_case(pods[1], reference)


def test_reference_env_names_still_bring_ranks_up(reference_env_ranks, reference):
    for r, got in reference_env_ranks.items():
        assert (got["rank"], got["world"]) == (r, 4)
        assert got["env"]["RANK"] is None  # no torchrun here
        assert got["tp_ranks"] == [r // 2 * 2, r // 2 * 2 + 1]
    _check_case(reference_env_ranks, reference)
