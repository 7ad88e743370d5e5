"""The port's pipeline layouts, its 8-rank mesh and its checkpoint against
the JAX package on the CPU (tests/torch_pp_jax.py holds the JAX side).

- `pp_param_specs` equals the reference's as spec tuples (dense, GQA,
  MoE; tp inside the stages or replicated where tp does not divide
  kv_heads; ZeRO's fsdp storage; the interleaved layout), over the plans
  below.
- Each rank's `to_pp_params` + `shard_params` block equals the JAX array's
  addressable shard under pp_param_specs on the 8-device virtual mesh
  (device i is rank i), at fsdp 2 x pp 2 x tp 2, v 1 and v 2;
  `gather_params` joins the blocks back.
- GPipe and 1F1B at fsdp 2 x pp 2 x tp 2: loss and gathered gradients
  within 1e-5 of the JAX pipelines'; one 1F1B make_pp_train_step step,
  gathered, equals the one-process port step.
- The pipeline checkpoint (tests/test_checkpoint.py:85's contract) at
  fsdp 2 x pp 2 x tp 2: the initial params' checksum equals the JAX
  digest of the same pipeline params, every rank saves its shards (the
  ack is the gathered state's checksum), the state restores bit-equal
  onto the same mesh, and the resumed step is bit-equal to the
  uninterrupted one.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import torch_dist
import torch_pp_jax as ref
import torch_threads
from odh_kubeflow_tpu.models import checkpoint as jax_checkpoint
from odh_kubeflow_tpu.models import pp_param_specs as jax_pp_param_specs
from odh_kubeflow_tpu.models import to_pp_params as jax_to_pp_params
from odh_kubeflow_tpu.parallel import MeshPlan as JaxMeshPlan
from odh_kubeflow_tpu_torch.models import make_train_step, params_from_numpy, pp_param_specs, to_pp_params
from odh_kubeflow_tpu_torch.parallel import MeshPlan

torch_threads.cap()

ATOL = 1e-5
NAMES = ("fsdp2 x pp2 x tp2",)
CASES = ref.cases(NAMES)
PLAN = {"fsdp": 2, "pp": 2, "tp": 2}
SPEC_PLANS = [dict(pp=2), dict(pp=2, tp=2), dict(fsdp=2, pp=2, tp=2), dict(pp=2, ep=2), dict(dp=2, pp=2),
              dict(pp=2, tp=4), dict(pp=2, sp=2)]
SPEC_CFGS = {"dense": {}, "gqa-8-2": dict(n_heads=8, n_kv_heads=2), "moe": "moe"}


@pytest.mark.parametrize("n_chunks", [1, 2])
@pytest.mark.parametrize("plan", SPEC_PLANS, ids=lambda p: "-".join(f"{k}{v}" for k, v in p.items()))
@pytest.mark.parametrize("name", sorted(SPEC_CFGS))
def test_pp_param_specs_match_reference(name, plan, n_chunks):
    jcfg = ref.CFGS["moe"] if SPEC_CFGS[name] == "moe" else dataclasses.replace(ref.JCFG, n_layers=4,
                                                                               **SPEC_CFGS[name])
    n = MeshPlan(**plan).n_devices
    jmesh = JaxMeshPlan(**plan).build(jax.devices()[:n])
    want = jax.tree_util.tree_map(tuple, jax_pp_param_specs(jcfg, jmesh, plan["pp"], n_chunks=n_chunks),
                                  is_leaf=lambda x: isinstance(x, PartitionSpec))
    mesh = types.SimpleNamespace(sizes=MeshPlan(**plan).sizes())
    assert pp_param_specs(ref.port_cfg(jcfg), mesh, plan["pp"], n_chunks) == want


@pytest.fixture(scope="module")
def params():
    return ref.init_all()


@pytest.fixture(scope="module")
def ranks(params, tmp_path_factory):
    nparams = {k: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), v) for k, v in params.items()}
    cfg = ref.port_cfg(ref.JCFG, use_flash=True)
    extra = [(8, (f"shard v{v}", "torch_pp_cases:pp_shard_case",
                  dict(params=nparams["dense4"], cfg=ref.port_cfg(ref.CFGS["dense4"]), plan=PLAN, n_chunks=v)))
             for v in (1, 2)]
    extra.append((8, ("checkpoint", "torch_pp_cases:checkpoint_case",
                      dict(directory=str(tmp_path_factory.mktemp("pp-ckpt")), params=nparams["dense"],
                           batch={"tokens": ref.TOKENS}, cfg=cfg, plan=PLAN, n_micro=ref.N_MICRO,
                           schedule="1f1b"))))
    return ref.spawn(params, NAMES, extra)


@pytest.mark.parametrize("name,run", CASES, ids=[f"{n}-{r}" for n, r in CASES])
def test_pp_loss_and_grads_match_jax(params, ranks, name, run):
    ref.assert_matches_jax(params, ranks, name, run, ATOL)


@pytest.mark.parametrize("n_chunks", [1, 2])
def test_rank_blocks_match_jax_addressable_shards(params, ranks, n_chunks):
    jcfg = ref.CFGS["dense4"]
    jmesh = JaxMeshPlan(**PLAN).build(jax.devices()[:8])
    pp = jax_to_pp_params(params["dense4"], 2, jcfg, jmesh, n_chunks=n_chunks)
    specs = jax_pp_param_specs(jcfg, jmesh, 2, n_chunks=n_chunks)
    per = ranks[f"shard v{n_chunks}"]
    for path in ref.paths(pp):
        sharded = jax.device_put(np.asarray(ref.at(pp, path), np.float32), NamedSharding(jmesh, ref.at(specs, path)))
        for r, got in enumerate(per):
            want = next(s.data for s in sharded.addressable_shards if s.device == jax.devices()[r])
            np.testing.assert_array_equal(ref.at(got["blocks"], path), np.asarray(want), err_msg=f"rank {r} {path}")
        np.testing.assert_array_equal(ref.at(per[0]["gathered"], path), np.asarray(ref.at(pp, path), np.float32))


def test_pp_1f1b_train_step_matches_one_process(params, ranks):
    cfg = ref.port_cfg(ref.JCFG, use_flash=True)
    full = params_from_numpy(params["dense"], "float32", device="cpu")
    step, opt = make_train_step(cfg)
    state = opt.init(full)
    full, state, loss = step(full, state, {"tokens": torch.as_tensor(ref.TOKENS).long()})
    want = to_pp_params(full, 2, cfg, types.SimpleNamespace(sizes=MeshPlan(**PLAN).sizes()))
    per = [r["1f1b"] for r in ranks["fsdp2 x pp2 x tp2"]]
    assert all(abs(r["step_loss"] - loss.item()) < ATOL for r in per)
    for path in ref.paths(want):
        np.testing.assert_allclose(ref.at(per[0]["params"], path), ref.at(want, path).numpy(), atol=ATOL, rtol=0,
                                   err_msg=str(path))
    ref.assert_replicas_equal(per, "replicas")


def test_pp_checkpoint_digest_restore_and_resume(params, ranks):
    per = ranks["checkpoint"]
    jmesh = JaxMeshPlan(**PLAN).build(jax.devices()[:8])
    want = jax_checkpoint.state_checksum({"params": jax_to_pp_params(params["dense"], 2, ref.JCFG, jmesh)})
    assert {r["init"] for r in per} == {want}
    assert len({r["saved"] for r in per}) == 1 and per[0]["saved"] == per[0]["gathered"]
    for r in per:
        assert r["same_blocks"] and r["resumed_equal"] and r["count"] == 2
        assert r["resumed_loss"] == r["ref_loss"]


@pytest.mark.parametrize("name", NAMES)
def test_exchanges_by_kind(ranks, name):
    ref.assert_exchanges(ranks, name)
