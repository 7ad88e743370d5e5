"""The port's tensor-parallel `generate(mesh=)` against the JAX package on
the CPU, over gloo ranks (tests/torch_dist.py; the rank job is
tests/torch_ep_cases.py's `decode_case`, jax-free): one spawn of 2 ranks
(tp 2) and one of 4 (fsdp 2 x tp 2; tp 4 with n_kv_heads 2, where tp
does not divide kv_heads; an MoE config at ep 2 x tp 2 and ep 2 x fsdp
2).

- Greedy tokens equal the JAX `generate(sharded, mesh=)`
  (tests/test_decode.py:108-164) on the same mesh of the 8-device virtual
  CPU mesh, and the port's one-process `generate()`; every rank returns
  the same tokens.
- Sampled tokens (two seeds) equal the port's one-process run with the
  same seed.
- The logits are never gathered: a rank's exchanges are the tp sums (two
  a layer a call), the vocab-parallel argmax (a max and an index of each
  row a pick), the expert sums over ep and the weights' fsdp gathers,
  counted by kind with their bytes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding

import torch_dist
import torch_ep_cases
import torch_threads
from odh_kubeflow_tpu.models import MoEConfig as JaxMoE
from odh_kubeflow_tpu.models import TransformerConfig as JaxConfig
from odh_kubeflow_tpu.models import generate as jax_generate
from odh_kubeflow_tpu.models import init_params as jax_init_params
from odh_kubeflow_tpu.models import param_specs as jax_param_specs
from odh_kubeflow_tpu.parallel import MeshPlan as JaxMeshPlan
from odh_kubeflow_tpu_torch.models import MoEConfig, TransformerConfig

torch_threads.cap()

# tests/test_decode.py:108-164's config
JCFG = JaxConfig(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, max_seq=64,
                 dtype=jnp.float32, use_flash=False, remat=False)
MOE = dataclasses.replace(JCFG, moe=JaxMoE(n_experts=4, experts_per_token=2, capacity_factor=1.25, d_ff=64))
PROMPT = np.random.default_rng(1).integers(0, JCFG.vocab, (2, 8)).astype(np.int32)
MAX_NEW = 12
RUNS = [(0.0, 0), (0.8, 7), (0.8, 8)]  # (temperature, generator seed): greedy, then sampled
# name -> (world, plan, config)
CASES = {
    "tp2": (2, {"tp": 2}, JCFG),
    "fsdp2-tp2": (4, {"fsdp": 2, "tp": 2}, JCFG),
    "tp4-kv2": (4, {"tp": 4}, JCFG),
    "moe-ep2-tp2": (4, {"ep": 2, "tp": 2}, MOE),
    # the reference's decode routes the whole batch as one (its layers run
    # without the mesh) at any mesh: not cut over fsdp as its train step's
    "moe-ep2-fsdp2": (4, {"ep": 2, "fsdp": 2}, MOE),
}


def port_cfg(jcfg):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(TransformerConfig)}
    if jcfg.moe is not None:
        fields["moe"] = MoEConfig(**{f.name: getattr(jcfg.moe, f.name) for f in dataclasses.fields(MoEConfig)})
    fields.update(dtype="float32")
    return TransformerConfig(**fields)


def _params(jcfg):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  jax.device_get(jax_init_params(jax.random.PRNGKey(0), jcfg)))


@pytest.fixture(scope="module")
def ranks():
    out = {}
    for world in (2, 4):
        cases = [(name, "torch_ep_cases:decode_case",
                  dict(params=_params(jcfg), prompt=PROMPT, cfg=port_cfg(jcfg), plan=plan, max_new=MAX_NEW,
                       runs=RUNS))
                 for name, (w, plan, jcfg) in CASES.items() if w == world]
        out.update(torch_dist.run_ranks(world, cases))
    return out


@pytest.fixture(scope="module")
def one_process():
    return {jcfg.moe is not None: torch_ep_cases.sampled_reference(_params(jcfg), PROMPT, port_cfg(jcfg), MAX_NEW,
                                                                    RUNS)
            for jcfg in (JCFG, MOE)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_generate_greedy_matches_jax_and_one_process(ranks, one_process, name):
    world, plan, jcfg = CASES[name]
    mesh = JaxMeshPlan(**plan).build(jax.devices()[:world])
    params = jax_init_params(jax.random.PRNGKey(0), jcfg)
    sharded = jax.tree_util.tree_map(lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), params,
                                     jax_param_specs(jcfg, mesh))
    want = np.asarray(jax_generate(sharded, jnp.asarray(PROMPT), jcfg, max_new=MAX_NEW, mesh=mesh))
    assert (want == np.asarray(jax_generate(params, jnp.asarray(PROMPT), jcfg, max_new=MAX_NEW))).all()
    per = ranks[name]
    for r in per:
        np.testing.assert_array_equal(r[0]["tokens"], want, err_msg=name)
    np.testing.assert_array_equal(one_process[jcfg.moe is not None][0], want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_generate_sampled_matches_one_process(ranks, one_process, name):
    _, _, jcfg = CASES[name]
    want = one_process[jcfg.moe is not None]
    assert not np.array_equal(want[1], want[2])  # the seeds draw different tokens
    for r in ranks[name]:
        for i in (1, 2):
            np.testing.assert_array_equal(r[i]["tokens"], want[i], err_msg=f"{name} seed {RUNS[i][1]}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_generate_exchanges_never_gather_the_logits(ranks, name):
    """Bytes a rank sends by kind: the tp sums (f32 rows of d_model, two a
    layer, in the prefill for every prompt position and then once a
    step), the vocab-parallel argmax (an f32 max and an int64 index a row,
    each pick), the fsdp gathers of the weights (the layers' twice: in the
    prefill and once for the token loop), nothing else; no exchange holds
    a vocab-wide row."""
    world, plan, jcfg = CASES[name]
    cfg = port_cfg(jcfg)
    b, s = PROMPT.shape
    tp, fsdp = plan.get("tp", 1), plan.get("fsdp", 1)
    steps = MAX_NEW - 1
    rows = b * s + b * steps  # the prefill's rows, then one a step
    sums = 1 if cfg.moe is not None else 2  # wo's, and wo_mlp's in a dense layer
    calls = cfg.n_layers * (1 + steps)  # a layer's calls: the prefill, then one a step
    if tp == 1:
        sums = 0
    for r in ranks[name]:
        ex = r[0]["exchanges"]
        assert ex["tp_sum"] == sums * calls
        assert ex["tp_sum_bytes"] == sums * cfg.n_layers * rows * cfg.d_model * 4
        assert (ex["argmax"], ex["argmax_bytes"]) == ((2 * MAX_NEW, MAX_NEW * b * (4 + 8)) if tp > 1 else (0, 0))
        assert ex["vocab"] == ex["sum"] == ex["scatter"] == ex["ring"] == ex["aux"] == 0
        if cfg.moe is not None:  # the experts' sum over ep, f32 rows of d_model
            assert (ex["ep"], ex["ep_bytes"]) == (calls, cfg.n_layers * rows * cfg.d_model * 4)
        else:
            assert ex["ep"] == 0
            d, f, hd, L = cfg.d_model, cfg.d_ff, cfg.head_dim, cfg.n_layers
            fused = (cfg.n_heads + 2 * cfg.kv_heads) // tp
            layer = (d * fused * hd + cfg.n_heads // tp * hd * d + 3 * d * f // tp) * 4
            top = (cfg.vocab * d + d * cfg.vocab // tp) * 4  # the table, the unembedding's vocab block
            want = (2 * (2 + 5 * L), 2 * (top + L * layer)) if fsdp > 1 else (0, 0)
            assert (ex["gather"], ex["gather_bytes"]) == want
