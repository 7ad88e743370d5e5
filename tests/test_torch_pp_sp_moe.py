"""The port's pipeline with sp and ep inside the stages against the JAX
package's on the CPU (tests/torch_pp_jax.py holds the JAX side): GPipe at
pp 2 x sp 2, contiguous and zigzag (make_zigzag_batch's explicit targets
and mask; the ring inside the stages, its reference path on the CPU), and
the MoE (4 experts, top 2, capacity factor 1.25: capacity from one
microbatch's tokens; the aux loss through the pipeline) at pp 2 x ep 2,
GPipe and 1F1B; loss and gathered gradients within 1e-5 absolute, f32.
pp_forward under sp warns that the aux is a per-shard statistic, as the
reference's pipeline_apply does.

The same spawn runs the non-pipelined entry points over a mesh with a live
pp axis (pp 2 x tp 2; params replicated over pp, as the reference's
param_specs name no stage axis): value_and_grad's loss and gathered
gradients and generate's greedy tokens equal one process's.
"""
import jax
import numpy as np
import pytest
import torch

import torch_pp_jax as ref
import torch_threads
from odh_kubeflow_tpu_torch.models import generate, params_from_numpy, value_and_grad
from odh_kubeflow_tpu_torch.models.tree import tree_leaves

torch_threads.cap()

ATOL = 1e-5
NAMES = ("pp2 x sp2", "pp2 x sp2 zigzag", "pp2 x ep2 moe")
CASES = ref.cases(NAMES)


@pytest.fixture(scope="module")
def params():
    return ref.init_all()


PROMPT = np.random.default_rng(2).integers(0, ref.JCFG.vocab, (2, 5))
MAX_NEW = 6


@pytest.fixture(scope="module")
def ranks(params):
    nparams = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params["dense"])
    extra = [(4, ("replicated", "torch_pp_cases:replicated_case",
                  dict(params=nparams, batch={"tokens": ref.TOKENS}, prompt=PROMPT,
                       cfg=ref.port_cfg(ref.JCFG, use_flash=True), plan={"pp": 2, "tp": 2}, max_new=MAX_NEW)))]
    return ref.spawn(params, NAMES, extra)


@pytest.mark.parametrize("name,run", CASES, ids=[f"{n}-{r}" for n, r in CASES])
def test_pp_loss_and_grads_match_jax(params, ranks, name, run):
    ref.assert_matches_jax(params, ranks, name, run, ATOL)


@pytest.mark.parametrize("name", ["pp2 x sp2", "pp2 x sp2 zigzag"])
def test_pp_forward_under_sp_warns_of_the_per_shard_aux(ranks, name):
    assert all(r["gpipe"]["sp_warned"] for r in ranks[name])


def test_non_pipelined_entry_points_replicate_over_pp(params, ranks):
    cfg = ref.port_cfg(ref.JCFG, use_flash=True)
    full = params_from_numpy(params["dense"], "float32", device="cpu")
    loss, grads = value_and_grad(full, {"tokens": torch.as_tensor(ref.TOKENS).long()}, cfg)
    tokens = generate(full, torch.as_tensor(PROMPT), cfg, MAX_NEW, device="cpu").numpy()
    per = ranks["replicated"]
    assert all(abs(r["loss"] - loss.item()) < ATOL for r in per)
    got = tree_leaves(per[0]["grads"])
    for g, w in zip(got, grads):
        np.testing.assert_allclose(g, w.numpy(), atol=ATOL, rtol=0)
    assert all(np.array_equal(r["tokens"], tokens) for r in per)


@pytest.mark.parametrize("name", NAMES)
def test_exchanges_by_kind(ranks, name):
    ref.assert_exchanges(ranks, name)
