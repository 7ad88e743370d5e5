"""The port's transformer and decode path (odh_kubeflow_tpu_torch.models)
against the JAX package on the CPU.

The same weights (the JAX init, converted by params_from_numpy) and the same
numpy-made tokens go through both. f32 configs: logits agree within 1e-4
(summation order only), and greedy tokens agree exactly. The port's config
runs attention through `flash_attention` (its plain version on the CPU);
the JAX config through its reference, as on a non-TPU host.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from odh_kubeflow_tpu_torch.parallel import MeshPlan
from odh_kubeflow_tpu.models import TransformerConfig as JaxConfig
from odh_kubeflow_tpu.models import decode_step as jax_decode_step
from odh_kubeflow_tpu.models import forward as jax_forward
from odh_kubeflow_tpu.models import generate as jax_generate
from odh_kubeflow_tpu.models import init_params as jax_init_params
from odh_kubeflow_tpu.models import prefill as jax_prefill
from odh_kubeflow_tpu_torch.models import (
    TransformerConfig,
    decode_step,
    forward,
    generate,
    init_params,
    params_from_numpy,
    pp_forward,
    prefill,
)
from odh_kubeflow_tpu_torch.models.transformer import check_mesh

ATOL = 1e-4
ENTRY = __graft_entry__._tiny_cfg(jnp)  # the shape entry() builds, MHA
GQA = dataclasses.replace(ENTRY, n_kv_heads=2)


def port_config(jax_cfg: JaxConfig, **overrides) -> TransformerConfig:
    fields = {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(TransformerConfig)}
    fields.update(dtype="float32", use_flash=True, **overrides)
    return TransformerConfig(**fields)


@pytest.fixture(scope="module", params=[ENTRY, GQA], ids=["entry", "gqa"])
def models(request):
    jcfg = request.param
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.device_get(jparams), torch.float32, device="cpu")
    return jcfg, jparams, port_config(jcfg), tparams


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for name, child in tree.items():
            yield from _leaves(child, f"{prefix}/{name}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)])
def test_params_from_numpy_round_trips(jdtype, tdtype):
    jcfg = dataclasses.replace(GQA, dtype=jdtype)
    jparams = jax.device_get(jax_init_params(jax.random.PRNGKey(1), jcfg))
    tparams = params_from_numpy(jparams, tdtype, device="cpu")
    want = dict(_leaves(jparams))
    got = dict(_leaves(tparams))
    assert want.keys() == got.keys()
    for name, arr in want.items():
        assert got[name].dtype == tdtype and tuple(got[name].shape) == arr.shape, name
        np.testing.assert_array_equal(got[name].float().numpy(), np.asarray(arr).astype(np.float32))


def test_forward_matches_jax(models):
    jcfg, jparams, cfg, params = models
    tokens = _tokens(0, 2, 64, jcfg.vocab)
    want = np.asarray(jax_forward(jparams, jnp.asarray(tokens), jcfg))
    got = forward(params, torch.from_numpy(tokens).long(), cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_prefill_and_decode_step_match_jax(models):
    jcfg, jparams, cfg, params = models
    prompt = _tokens(1, 2, 12, jcfg.vocab)
    jlogits, jcache = jax_prefill(jparams, jnp.asarray(prompt), jcfg, 32)
    logits, cache = prefill(params, torch.from_numpy(prompt).long(), cfg, 32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), atol=ATOL, rtol=0)
    assert cache.length == 12
    for step in range(3):
        token = np.asarray(jnp.argmax(jlogits, axis=-1), np.int32)
        jlogits, jcache = jax_decode_step(jparams, jcache, jnp.asarray(token), jcfg)
        logits, cache = decode_step(params, cache, torch.tensor(token, dtype=torch.long), cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0,
                                   err_msg=f"decode step {step}")
    assert cache.length == 15
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), atol=ATOL, rtol=0)


def test_greedy_generate_matches_jax(models):
    jcfg, jparams, cfg, params = models
    prompt = _tokens(2, 3, 8, jcfg.vocab)
    want = np.asarray(jax_generate(jparams, jnp.asarray(prompt), jcfg, max_new=12, max_seq=32))
    got = generate(params, prompt, cfg, max_new=12, max_seq=32, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_refuses_to_decode_past_the_cache(models):
    _, _, cfg, params = models
    with pytest.raises(ValueError, match="exceeds cache max_seq"):
        generate(params, [[1, 2, 3, 4]], cfg, max_new=8, max_seq=10, device="cpu")
    assert tuple(generate(params, [[1, 2]], cfg, max_new=0, device="cpu").shape) == (1, 0)


def test_sampled_generate_is_deterministic_per_seed(models):
    _, _, cfg, params = models

    def sample(seed):
        gen = torch.Generator().manual_seed(seed)
        return generate(params, [[5, 6, 7], [8, 9, 10]], cfg, max_new=16, max_seq=32,
                        generator=gen, temperature=1.0, device="cpu")

    first = sample(3)
    assert torch.equal(first, sample(3))
    assert not torch.equal(first, sample(4))
    assert int(first.min()) >= 0 and int(first.max()) < cfg.vocab


def test_init_params_is_seeded_and_shaped():
    cfg = port_config(GQA)
    a = init_params(torch.Generator().manual_seed(7), cfg, device="cpu")
    b = init_params(torch.Generator().manual_seed(7), cfg, device="cpu")
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(_leaves(a), _leaves(b)))
    want = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), GQA))
    assert {n: tuple(t.shape) for n, t in _leaves(a)} == {n: s.shape for n, s in _leaves(want)}
    wqkv = a["layers"]["wqkv"]
    assert float(wqkv.abs().max()) <= 2.0 * cfg.d_model**-0.5 + 1e-6  # truncated at 2 std


def test_config_dtype_accepts_json_names():
    assert TransformerConfig(dtype="bfloat16").dtype is torch.bfloat16
    assert TransformerConfig(dtype=torch.float32).dtype is torch.float32
    with pytest.raises(ValueError, match="unsupported model dtype"):
        TransformerConfig(dtype="float16")


def test_unported_features_raise(models):
    _, _, cfg, params = models
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(TypeError, match="MoEConfig"):  # MoE is ported; a dict is no config
        init_params(None, dataclasses.replace(cfg, moe={"n_experts": 4}), device="cpu")
    # a sequence axis without a mesh runs on one device, as in the JAX package
    assert torch.equal(forward(params, tokens, dataclasses.replace(cfg, seq_axis="sp")),
                       forward(params, tokens, cfg))
    # the mesh path runs data, expert, tensor and sequence axes on this
    # rank's blocks of the params: whole params over a tp axis are refused;
    # a pp axis replicates forward and generate over its ranks (parity over
    # gloo ranks: tests/test_torch_pp_sp_moe.py), and the pipeline's
    # forward refuses params that are not in its stage layout
    tp_mesh = types.SimpleNamespace(sizes=dict(dp=1, fsdp=1, pp=1, ep=1, tp=2, sp=1))
    with pytest.raises(ValueError, match="not this rank's blocks .*shard_params"):
        forward(params, tokens, cfg, mesh=tp_mesh)
    with pytest.raises(ValueError, match="not this rank's blocks .*shard_params"):
        generate(params, [[1]], cfg, max_new=2, mesh=tp_mesh, device="cpu")
    pp_mesh = types.SimpleNamespace(sizes=dict(dp=1, fsdp=1, pp=2, ep=1, tp=1, sp=1))
    check_mesh(pp_mesh, cfg, "forward")
    check_mesh(pp_mesh, cfg, "generate")
    with pytest.raises(ValueError, match="not this rank's pipeline blocks .*to_pp_params"):
        pp_forward(params, tokens, cfg, pp_mesh)
    # generate over a mesh runs (tp parity over gloo ranks:
    # tests/test_torch_tp_decode.py); a one-rank mesh is the one-process run
    one = MeshPlan().build("cpu")
    assert torch.equal(generate(params, [[1, 2, 3]], cfg, max_new=4, mesh=one, device="cpu"),
                       generate(params, [[1, 2, 3]], cfg, max_new=4, device="cpu"))
    # inference ignores the training-time sequence sharding, as in the JAX package
    sharded = generate(params, [[1, 2]], dataclasses.replace(cfg, seq_axis="sp"), max_new=3,
                       device="cpu")
    assert torch.equal(sharded, generate(params, [[1, 2]], cfg, max_new=3, device="cpu"))


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(None, port_config(GQA))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate({}, [[1]], port_config(GQA), max_new=1)
