"""The port's pipeline-parallel transformer (models/transformer.py's pp
functions over gloo ranks) against the JAX package's pipelines on the CPU:
the dense meshes of 2 and 4 ranks (tests/torch_pp_jax.py holds the JAX side
and the configurations; test_torch_pp_sp_moe.py the sp and MoE meshes;
test_torch_pp_shard.py the 8-rank mesh, the layouts and the checkpoint).

The JAX side runs on the 8-device virtual mesh (tests/conftest.py; device
i is rank i): jax.value_and_grad(pp_loss_fn) for GPipe, and
pp_1f1b_value_and_grad for 1F1B and interleaved 1F1B, on the same params
in the pipeline layout. The port's loss and gathered gradients (in that
layout) equal them within 1e-5 absolute, f32, vocab 64, d_model 64 (head
dim 16, the flash op's smallest), GQA 4/2, batch 4 x 16, n_micro 2:
GPipe and 1F1B at pp 2 and pp 2 x tp 2, GPipe at pp 2 x dp 2 (2 layers),
interleaved GPipe and interleaved 1F1B at pp 2, v 2 (4 layers). The port
runs the flash op (its plain versions on the CPU).

pp_loss_fn equals the GPipe loss; every leaf a rank holds with others has
the same gradient bits on each; the flash op's calls per rank are the
schedule's; one make_pp_train_step step (GPipe and 1F1B at pp 2 x tp 2),
gathered, equals the one-process port step. The reference's raises are
the port's.
"""
import types

import numpy as np
import pytest
import torch

import torch_pp_jax as ref
import torch_threads
from odh_kubeflow_tpu_torch.models import (make_pp_train_step, make_train_step, params_from_numpy,
                                           pp_1f1b_value_and_grad, pp_forward, pp_loss_fn, pp_value_and_grad,
                                           to_pp_params)

torch_threads.cap()

ATOL = 1e-5
NAMES = ("pp2", "pp2 v2", "pp2 x tp2", "pp2 x dp2")
CASES = ref.cases(NAMES)


@pytest.fixture(scope="module")
def params():
    return ref.init_all()


@pytest.fixture(scope="module")
def ranks(params):
    return ref.spawn(params, NAMES)


@pytest.mark.parametrize("name,run", CASES, ids=[f"{n}-{r}" for n, r in CASES])
def test_pp_loss_and_grads_match_jax(params, ranks, name, run):
    ref.assert_matches_jax(params, ranks, name, run, ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_pp_launches_per_rank(ranks, name):
    """The flash op's plain calls per rank (the CPU kernel of the op the
    card launches): GPipe runs each of the stage's layers' forward, dq and
    dk/dv once a microbatch; 1F1B the forward twice (the forward visit and
    the backward's recompute)."""
    _, _, plan, cfg_name, runs, _ = next(m for m in ref.MESHES if m[1] == name)
    n = ref.N_MICRO * ref.CFGS[cfg_name].n_layers // plan["pp"]
    for r in ranks[name]:
        for run, schedule, _ in runs:
            want = {"fwd": n * (2 if schedule == "1f1b" else 1), "dq": n, "dkv": n}
            assert r[run]["launches"] == want, (run, r[run]["launches"])


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp_train_step_matches_one_process(params, ranks, schedule):
    """One make_pp_train_step step at pp 2 x tp 2, gathered, against the
    one-process port step on the full batch (AdamW is elementwise, so the
    one-process result is compared in the pipeline layout); the replicated
    leaves of params and AdamW state bit-equal across their ranks."""
    cfg = ref.port_cfg(ref.JCFG, use_flash=True)
    full = params_from_numpy(params["dense"], "float32", device="cpu")
    step, opt = make_train_step(cfg)
    state = opt.init(full)
    full, state, loss = step(full, state, {"tokens": torch.as_tensor(ref.TOKENS).long()})
    mesh = types.SimpleNamespace(sizes={"dp": 1, "fsdp": 1, "pp": 2, "ep": 1, "tp": 2, "sp": 1})
    want = to_pp_params(full, 2, cfg, mesh)
    per = [r[schedule] for r in ranks["pp2 x tp2"]]
    assert all(abs(r["step_loss"] - loss.item()) < ATOL for r in per)
    for path in ref.paths(want):
        np.testing.assert_allclose(ref.at(per[0]["params"], path), ref.at(want, path).numpy(), atol=ATOL, rtol=0,
                                   err_msg=str(path))
    ref.assert_replicas_equal(per, "replicas")


def test_pp_raises_as_the_reference():
    cfg = ref.port_cfg(ref.CFGS["sp"])
    mesh = types.SimpleNamespace(sizes={"dp": 1, "fsdp": 1, "pp": 2, "ep": 1, "tp": 1, "sp": 2})
    batch = {"tokens": torch.zeros(4, 16, dtype=torch.long)}
    with pytest.raises(NotImplementedError, match="GPipe schedule only"):
        pp_1f1b_value_and_grad({}, batch, cfg, mesh)
    with pytest.raises(NotImplementedError, match="explicit batch targets"):
        pp_1f1b_value_and_grad({}, dict(batch, targets=batch["tokens"]), ref.port_cfg(ref.JCFG), mesh)
    zz = ref.port_cfg(ref.CFGS["zigzag"])
    with pytest.raises(ValueError, match="needs explicit batch targets"):
        pp_loss_fn({}, batch, zz, mesh)
    with pytest.raises(ValueError, match="needs explicit batch targets"):
        pp_value_and_grad({}, batch, zz, mesh)
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        make_pp_train_step(cfg, mesh, schedule="zero-bubble")
    one_stage = types.SimpleNamespace(sizes={"dp": 1, "fsdp": 1, "pp": 1, "ep": 1, "tp": 1, "sp": 1})
    with pytest.raises(ValueError, match="needs pp > 1"):
        pp_forward({}, batch["tokens"], ref.port_cfg(ref.JCFG), one_stage)


@pytest.mark.parametrize("name", NAMES)
def test_exchanges_by_kind(ranks, name):
    ref.assert_exchanges(ranks, name)
