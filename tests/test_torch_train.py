"""The port's training path (losses, remat policies, AdamW, the train step)
against the JAX package on the CPU.

The same weights (the JAX init, converted by params_from_numpy), the same
numpy-made tokens and, for the optimizer, the same gradients go through
both. f32 tolerances: losses 1e-5, gradients 1e-5 absolute (summation order
only; the port's attention is the flash op's plain version and its backward,
the JAX config's is mha_reference under jax.grad). AdamW is bitwise equal
to optax's eager update on identical gradients on this CPU; the tests allow
1e-6 in f32 and one bf16 ulp, since XLA may fuse bf16 elementwise ops and
round once where torch rounds after each op.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__
import torch_threads
from odh_kubeflow_tpu.models import TransformerConfig as JaxConfig
from odh_kubeflow_tpu.models import init_params as jax_init_params
from odh_kubeflow_tpu.models import loss_fn as jax_loss_fn
from odh_kubeflow_tpu.models import make_train_step as jax_make_train_step
from odh_kubeflow_tpu.models.transformer import causal_ce as jax_causal_ce
from odh_kubeflow_tpu.models.transformer import next_token_ce as jax_next_token_ce
from odh_kubeflow_tpu_torch.models import (
    TransformerConfig,
    adamw,
    causal_ce,
    loss_fn,
    make_train_step,
    next_token_ce,
    opt_state_from_numpy,
    params_from_numpy,
)
from odh_kubeflow_tpu_torch.models.tree import tree_leaves, tree_map
from odh_kubeflow_tpu_torch.models.transformer import _matmul_f32
from odh_kubeflow_tpu_torch.ops import attention

torch_threads.cap()

ATOL = 1e-5
ENTRY = __graft_entry__._tiny_cfg(jnp)  # the shape entry() builds, MHA
GQA = dataclasses.replace(ENTRY, n_kv_heads=2)
POLICIES = ["", "flash", "attn", "dots"]


def port_config(jax_cfg: JaxConfig, **overrides) -> TransformerConfig:
    fields = {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(TransformerConfig)}
    fields.update(dtype="float32", use_flash=True, **overrides)
    return TransformerConfig(**fields)


@pytest.fixture(scope="module", params=[ENTRY, GQA], ids=["entry", "gqa"])
def models(request):
    jcfg = request.param
    jparams = jax.device_get(jax_init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, jparams, port_config(jcfg), params_from_numpy(jparams, torch.float32, device="cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _batches(vocab):
    """(name, numpy batch): tokens only, and explicit targets with a mask."""
    tokens = _tokens(0, 2, 32, vocab)
    mask = (np.random.default_rng(1).random((2, 32)) < 0.7).astype(np.float32)
    targets = _tokens(2, 2, 32, vocab)
    return [("tokens", {"tokens": tokens}),
            ("targets", {"tokens": tokens, "targets": targets, "loss_mask": mask})]


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _value_and_grad(params, batch, cfg):
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = loss_fn(live, batch, cfg)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return loss.detach(), grads


def _assert_tree_close(got_leaves, want_tree, names, atol):
    assert len(got_leaves) == len(names)
    for name, got in zip(names, got_leaves):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(_jax_leaf(want_tree, name), np.float32),
                                   atol=atol, rtol=0, err_msg=name)


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in _names(v, f"{prefix}/{k}")]
    return [prefix]


def _jax_leaf(tree, name):
    for part in name.strip("/").split("/"):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("masked", [False, True])
def test_causal_ce_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 16, 64)) * 3).astype(np.float32)
    targets = rng.integers(0, 64, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) < 0.5).astype(np.float32) if masked else None

    def jloss(x):
        return jax_causal_ce(x, jnp.asarray(targets), None if mask is None else jnp.asarray(mask))

    want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = causal_ce(x, torch.from_numpy(targets), None if mask is None else torch.from_numpy(mask))
    (grad,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(float(got.detach()), float(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), atol=1e-7, rtol=0)


def test_causal_ce_all_masked_is_zero():
    logits = torch.randn(1, 4, 8)
    assert float(causal_ce(logits, torch.zeros(1, 4, dtype=torch.long), torch.zeros(1, 4))) == 0.0


def test_next_token_ce_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 16, 64)).astype(np.float32)
    tokens = rng.integers(0, 64, (2, 16)).astype(np.int32)
    want, want_grad = jax.value_and_grad(lambda x: jax_next_token_ce(x, jnp.asarray(tokens)))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = next_token_ce(x, torch.from_numpy(tokens))
    (grad,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(float(got.detach()), float(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), atol=1e-7, rtol=0)
    assert not grad[:, -1].any()  # the fabricated last-position label is masked


@pytest.mark.parametrize("batch_kind", ["tokens", "targets"])
def test_loss_and_grads_match_jax(models, batch_kind):
    jcfg, jparams, cfg, params = models
    batch = dict(_batches(jcfg.vocab))[batch_kind]
    want, want_grads = jax.value_and_grad(jax_loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, grads = _value_and_grad(params, _torch_batch(batch), cfg)
    assert loss.dim() == 0
    np.testing.assert_allclose(float(loss), float(want), atol=ATOL, rtol=0)
    _assert_tree_close(grads, want_grads, _names(params), ATOL)


def test_loss_fn_positions_key_reaches_rope(models):
    """Explicit positions equal to the default arange give the same loss;
    stretched ones (other relative distances, which rope sees) do not."""
    _, _, cfg, params = models
    tokens = torch.from_numpy(_tokens(5, 1, 16, cfg.vocab)).long()
    base = loss_fn(params, {"tokens": tokens}, cfg)
    same = loss_fn(params, {"tokens": tokens, "positions": torch.arange(16)[None]}, cfg)
    moved = loss_fn(params, {"tokens": tokens, "positions": torch.arange(16)[None] * 3}, cfg)
    assert float(same) == float(base) and float(moved) != float(base)


def test_loss_fn_refuses_what_is_not_ported(models):
    _, _, cfg, params = models
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.long)}
    with pytest.raises(ValueError, match="zigzag"):
        loss_fn(params, batch, dataclasses.replace(cfg, seq_layout="zigzag"))
    with pytest.raises(NotImplementedError, match="MoE"):
        loss_fn(params, batch, dataclasses.replace(cfg, moe={"n_experts": 4}))
    with pytest.raises(NotImplementedError, match="mesh"):
        loss_fn(params, batch, cfg, mesh=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        make_train_step(cfg, mesh=object())


def _count_flash_forwards(monkeypatch):
    calls = []
    plain = attention.flash_attention_plain

    def counting(*args, **kwargs):
        calls.append(kwargs.get("with_lse", False))
        return plain(*args, **kwargs)

    monkeypatch.setattr(attention, "flash_attention_plain", counting)
    return calls


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p or "none-saved")
def test_remat_policy_matches_no_remat(models, policy, monkeypatch):
    """Every policy gives remat=False's loss and gradients; they differ only
    in what the backward recomputes: "" and "dots" run the flash forward
    again (2 per layer), "flash" and "attn" keep its (out, lse) (1)."""
    _, _, cfg, params = models
    batch = _torch_batch(dict(_batches(cfg.vocab))["tokens"])
    want, want_grads = _value_and_grad(params, batch, dataclasses.replace(cfg, remat=False))
    calls = _count_flash_forwards(monkeypatch)
    loss, grads = _value_and_grad(params, batch, dataclasses.replace(cfg, remat=True, remat_policy=policy))
    assert float(loss) == float(want)
    for name, g, w in zip(_names(params), grads, want_grads):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0, msg=name)
    per_layer = 1 if policy in ("flash", "attn") else 2
    assert len(calls) == per_layer * cfg.n_layers
    assert all(calls)  # every training forward runs the with-lse variant


def test_no_remat_runs_one_flash_forward_per_layer(models, monkeypatch):
    _, _, cfg, params = models
    calls = _count_flash_forwards(monkeypatch)
    _value_and_grad(params, _torch_batch(dict(_batches(cfg.vocab))["tokens"]),
                    dataclasses.replace(cfg, remat=False))
    assert len(calls) == cfg.n_layers


def test_unknown_remat_policy_raises(models):
    _, _, cfg, params = models
    with pytest.raises(ValueError, match="unknown remat_policy"):
        _value_and_grad(params, _torch_batch(dict(_batches(cfg.vocab))["tokens"]),
                        dataclasses.replace(cfg, remat_policy="everything"))


def _to_torch(tree, dtype):
    return params_from_numpy(jax.device_get(tree), dtype, device="cpu")


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_adamw_matches_optax_over_three_steps(jdtype, tdtype):
    rng = np.random.default_rng(6)
    shapes = {"embed": (16, 32), "final_norm": (32,), "layers": {"wqkv": (2, 32, 6, 8)}}
    jparams = jax.tree.map(lambda s: jnp.asarray(rng.standard_normal(s), jdtype), shapes,
                           is_leaf=lambda x: isinstance(x, tuple))
    params = _to_torch(jparams, tdtype)
    ref = optax.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1, mu_dtype=jnp.float32)
    jstate = ref.init(jparams)
    opt = adamw()
    state = opt.init(params)
    tol = {torch.float32: dict(atol=1e-6, rtol=0), torch.bfloat16: dict(atol=0, rtol=2**-8)}[tdtype]
    for step in range(3):
        jgrads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape) * 10.0**-step, jdtype),
                              jparams)
        updates, jstate = ref.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.update_(_to_torch(jgrads, tdtype), state, params)
        for name in _names(params):
            for got, want in ((params, jparams), (state["mu"], jstate[0].mu), (state["nu"], jstate[0].nu)):
                g = _jax_leaf(got, name)
                assert g.dtype == (torch.float32 if got is state["mu"] else tdtype)
                np.testing.assert_allclose(g.float().numpy(), np.asarray(_jax_leaf(want, name), np.float32),
                                           err_msg=f"step {step} {name}", **tol)
    assert int(state["count"]) == int(jstate[0].count) == 3


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_opt_state_from_numpy_round_trips(jdtype, tdtype):
    jcfg = dataclasses.replace(GQA, dtype=jdtype)
    jparams = jax_init_params(jax.random.PRNGKey(1), jcfg)
    ref = optax.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1, mu_dtype=jnp.float32)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.5), jparams)
    _, jstate = ref.update(grads, ref.init(jparams), jparams)
    adam = jax.device_get(jstate[0])
    state = opt_state_from_numpy(adam, tdtype, device="cpu")
    assert state["count"].dtype == torch.int32 and int(state["count"]) == 1
    for name in _names(state["mu"]):
        for key, dtype in (("mu", torch.float32), ("nu", tdtype)):
            got = _jax_leaf(state[key], name)
            want = np.asarray(_jax_leaf(getattr(adam, key), name)).astype(np.float32)
            assert got.dtype == dtype and tuple(got.shape) == want.shape, name
            np.testing.assert_array_equal(got.float().numpy(), want, err_msg=f"{key} {name}")


def test_train_step_matches_jax(models):
    """One step from the same params and optimizer state: the loss and the
    optimizer's first moment (0.1 * grad) everywhere; the updated params
    where |grad| > 1e-4, since at step 1 the update is about
    -lr * sign(grad) and a near-zero gradient's sign is summation noise."""
    jcfg, jparams, cfg, params = models
    batch = dict(_batches(jcfg.vocab))["tokens"]
    jstep, jopt = jax_make_train_step(jcfg)
    jstate = jopt.init(jparams)
    _, jgrads = jax.value_and_grad(jax_loss_fn)(jparams, {"tokens": jnp.asarray(batch["tokens"])}, jcfg)
    new_jparams, new_jstate, jloss = jstep(jparams, jstate, {"tokens": jnp.asarray(batch["tokens"])})

    params = tree_map(torch.clone, params)
    step, opt = make_train_step(cfg)
    state = opt.init(params)
    before = tree_map(torch.clone, params)
    out_params, out_state, loss = step(params, state, _torch_batch(batch))
    assert out_params is params and out_state is state  # updated in place
    assert loss.dim() == 0 and not loss.requires_grad
    assert not any(t.requires_grad for t in tree_leaves(params))
    np.testing.assert_allclose(float(loss), float(jloss), atol=ATOL, rtol=0)
    for name in _names(params):
        g = np.asarray(_jax_leaf(jgrads, name))
        np.testing.assert_allclose(_jax_leaf(state["mu"], name).numpy(),
                                   np.asarray(_jax_leaf(new_jstate[0].mu, name)), atol=1e-6, rtol=0,
                                   err_msg=name)
        firm = np.abs(g) > 1e-4
        got = _jax_leaf(params, name).numpy()
        np.testing.assert_allclose(got[firm], np.asarray(_jax_leaf(new_jparams, name))[firm],
                                   atol=1e-7, rtol=0, err_msg=name)
        assert not np.array_equal(got, _jax_leaf(before, name).numpy()), f"{name} did not move"


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_matmul_f32_backward_matches_jax(jdtype, tdtype):
    """The f32-output product's gradients follow JAX's transpose of
    einsum(preferred_element_type=f32): f32 contractions, cast to each
    operand's dtype (here the CPU branch; tests/test_torch_cuda.py holds
    the CUDA branch, torch.mm(out_dtype=f32), against it on the card)."""
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((2, 5, 16)), jdtype)
    w = jnp.asarray(rng.standard_normal((16, 24)), jdtype)
    gy = rng.standard_normal((2, 5, 24)).astype(np.float32)

    def f(x, w):
        return jnp.einsum("bsd,df->bsf", x, w, preferred_element_type=jnp.float32)

    want, vjp = jax.vjp(f, x, w)
    want_gx, want_gw = vjp(jnp.asarray(gy))
    tx, tw = _to_torch(x, tdtype).requires_grad_(), _to_torch(w, tdtype).requires_grad_()
    y = _matmul_f32(tx, tw)
    assert y.dtype == torch.float32
    gx, gw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(gy))
    assert gx.dtype == tdtype and gw.dtype == tdtype
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    tol = dict(atol=1e-5, rtol=0) if tdtype == torch.float32 else dict(atol=1e-5, rtol=2**-8)
    np.testing.assert_allclose(gx.float().numpy(), np.asarray(want_gx, np.float32), **tol)
    np.testing.assert_allclose(gw.float().numpy(), np.asarray(want_gw, np.float32), **tol)


@pytest.mark.parametrize("tdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_matmul_f32_under_inference_mode(tdtype):
    """Serving runs the same Function under torch.inference_mode: the f32
    product, with no graph recorded."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 5, 16)).astype(np.float32)).to(tdtype)
    w = torch.from_numpy(rng.standard_normal((16, 24)).astype(np.float32)).to(tdtype)
    with torch.inference_mode():
        y = _matmul_f32(x, w)
    assert y.dtype == torch.float32 and y.grad_fn is None and not y.requires_grad
    np.testing.assert_allclose(y.numpy(), (x.float() @ w.float()).numpy(), atol=1e-5, rtol=0)
