"""The port's Mixture-of-Experts (odh_kubeflow_tpu_torch.models.moe, and
the MoE model through forward, loss, train step, decode and the serving
engine's burst) against the JAX package on the CPU.

Inputs come from numpy seeds; weights are the JAX init, converted by
params_from_numpy. Tolerances, f32: routing (choice, pos, keep) and the
dense dispatch one-hots exactly equal; gates, combine weights and the aux
loss within 1e-6 (softmax's exp rounds differently in XLA and torch; gates
also relatively, since a token whose picks all dropped divides by 1e-9);
moe_ffn outputs within 1e-5; gradients within 1e-5 of the largest JAX
gradient; logits within 1e-4 and losses within 1e-5 (the tolerances of
tests/test_torch_model.py and tests/test_torch_train.py); greedy tokens
exactly equal. bf16 moe_ffn outputs within 2e-2 with the routing asserted
identical.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads
from odh_kubeflow_tpu.models import MoEConfig as JaxMoE
from odh_kubeflow_tpu.models import TransformerConfig as JaxConfig
from odh_kubeflow_tpu.models import checkpoint as ref_checkpoint
from odh_kubeflow_tpu.models import decode_step as jax_decode_step
from odh_kubeflow_tpu.models import forward as jax_forward
from odh_kubeflow_tpu.models import generate as jax_generate
from odh_kubeflow_tpu.models import init_params as jax_init_params
from odh_kubeflow_tpu.models import loss_fn as jax_loss_fn
from odh_kubeflow_tpu.models import make_train_step as jax_make_train_step
from odh_kubeflow_tpu.models import moe as jmoe
from odh_kubeflow_tpu.models import prefill as jax_prefill
from odh_kubeflow_tpu.serving import engine as jengine
from odh_kubeflow_tpu_torch.models import (
    MoEConfig,
    TransformerConfig,
    decode_step,
    dispatch_only,
    forward,
    generate,
    init_params,
    loss_fn,
    make_train_step,
    moe_ffn,
    opt_state_from_numpy,
    params_from_numpy,
    prefill,
    route_indices,
    routing_stats,
    state_checksum,
)
from odh_kubeflow_tpu_torch.models import moe, transformer
from odh_kubeflow_tpu_torch.models.decode import _layer_views
from odh_kubeflow_tpu_torch.models.tree import tree_leaves, tree_map
from odh_kubeflow_tpu_torch.serving import engine as tengine

torch_threads.cap()

GATE_ATOL = 1e-6
OUT_ATOL = 1e-5
GRAD_RTOL = 1e-5
LOGIT_ATOL = 1e-4
LOSS_ATOL = 1e-5
BF16_ATOL = 2e-2
D, F = 32, 48
POLICIES = ["", "flash", "attn", "dots"]


def port_moe(jcfg: JaxMoE) -> MoEConfig:
    return MoEConfig(**dataclasses.asdict(jcfg))


def port_config(jax_cfg: JaxConfig, dtype="float32", **overrides) -> TransformerConfig:
    fields = {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(TransformerConfig)}
    fields.update(dtype=dtype, use_flash=True,
                  moe=None if jax_cfg.moe is None else port_moe(jax_cfg.moe), **overrides)
    return TransformerConfig(**fields)


def _jax_model_cfg(capacity_factor=4.0, k=2, n_kv_heads=0, dtype=jnp.float32, aux=0.01):
    return JaxConfig(vocab=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=n_kv_heads, d_ff=64,
                     max_seq=64, dtype=dtype, use_flash=False, remat=False,
                     moe=JaxMoE(n_experts=4, experts_per_token=k, capacity_factor=capacity_factor,
                                router_aux_weight=aux))


def _jax_grad(params, batch, cfg):
    return jax.jit(jax.grad(jax_loss_fn), static_argnums=2)(params, batch, cfg)


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor) else x)


def _rng(seed):
    return np.random.default_rng(seed)


def _logits(seed, n=64, e=4, skew=True):
    """Router logits with an expert preferred (skew), so a tight capacity
    drops picks."""
    x = _rng(seed).standard_normal((n, e)).astype(np.float32)
    if skew:
        x[:, 0] += 1.0
    return x


def _moe_params(seed, cfg: JaxMoE, dtype=jnp.float32):
    jp = jax.device_get(jmoe.init_moe_params(jax.random.PRNGKey(seed), D, cfg, dtype))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    return jp, params_from_numpy(jp, tdtype, device="cpu")


def _x(seed, b=2, s=32, dtype=np.float32):
    return _rng(seed).standard_normal((b, s, D)).astype(dtype)


# ---- routing ----

@pytest.mark.parametrize("capacity_factor", [0.5, 4.0], ids=["tight", "ample"])
@pytest.mark.parametrize("k", [1, 2])
def test_route_indices_matches_jax(k, capacity_factor):
    logits = _logits(10 + k)
    capacity = max(1, int(capacity_factor * 64 * k / 4))
    want = jmoe.route_indices(jnp.asarray(logits), k, capacity)
    got = route_indices(torch.from_numpy(logits), k, capacity)
    for i, name in ((0, "choice"), (2, "pos"), (3, "keep")):
        np.testing.assert_array_equal(_np(got[i]), np.asarray(want[i]), err_msg=name)
    # relative too: a token whose picks all dropped has its gates divided by
    # the 1e-9 floor
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), atol=GATE_ATOL, rtol=GATE_ATOL)
    np.testing.assert_allclose(float(got[4]), float(want[4]), atol=GATE_ATOL, rtol=0)
    assert got[4].dtype == torch.float32 and got[4].dim() == 0
    # the tight capacity drops picks; the ample one keeps them all
    assert bool(got[3].all()) == (capacity_factor == 4.0)


@pytest.mark.parametrize("k", [1, 2])
def test_route_topk_matches_jax(k):
    logits = _logits(20 + k)
    capacity = int(0.75 * 64 * k / 4)
    wd, wc, waux = jmoe.route_topk(jnp.asarray(logits), k, capacity)
    gd, gc, gaux = moe.route_topk(torch.from_numpy(logits), k, capacity)
    np.testing.assert_array_equal(_np(gd), np.asarray(wd))
    np.testing.assert_allclose(_np(gc), np.asarray(wc), atol=GATE_ATOL, rtol=0)
    np.testing.assert_allclose(float(gaux), float(waux), atol=GATE_ATOL, rtol=0)
    assert float(gd.sum()) < 64 * k  # some picks dropped


def test_dropped_pick_gets_no_slot_and_reads_zeros():
    """The slot maps under drops: every kept pick owns one slot, a dropped
    pick points at the overflow row, an empty slot at the zero row."""
    logits = torch.from_numpy(_logits(30))
    choice, gate, pos, keep, _ = route_indices(logits, 2, 8)
    flat = torch.from_numpy(_x(31).reshape(64, D))
    expert_in, dest, slot_pick = moe._indexed_dispatch(flat, choice, pos, keep, 4, 8)
    assert (dest[~keep] == 32).all() and len(set(dest[keep].tolist())) == int(keep.sum())
    filled = slot_pick < 128
    assert int(filled.sum()) == int(keep.sum()) and not keep.all()
    assert (expert_in.reshape(32, D)[~filled] == 0).all()
    rows = torch.div(slot_pick[filled], 2, rounding_mode="floor")
    assert torch.equal(expert_in.reshape(32, D)[filled], flat[rows])


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_expert_product_backward_matches_jax(jdtype, tdtype):
    """The per-expert gate/up product (matmul_f32 on (E, C, d) x (E, d, f))
    and its gradients against JAX's einsum(..., preferred_element_type=f32):
    f32 results, cotangents contracted in f32 and cast to each operand's
    dtype. bf16 gradients within one bf16 ulp (2**-8 relative)."""
    from odh_kubeflow_tpu_torch.ops import matmul_f32

    rng = _rng(40)
    x = jnp.asarray(rng.standard_normal((4, 6, 16)), jdtype)
    w = jnp.asarray(rng.standard_normal((4, 16, 24)), jdtype)
    gy = rng.standard_normal((4, 6, 24)).astype(np.float32)
    want, vjp = jax.vjp(lambda x, w: jnp.einsum("ecd,edf->ecf", x, w,
                                                preferred_element_type=jnp.float32), x, w)
    want_gx, want_gw = vjp(jnp.asarray(gy))
    conv = params_from_numpy({"x": jax.device_get(x), "w": jax.device_get(w)}, tdtype, device="cpu")
    tx, tw = conv["x"].requires_grad_(), conv["w"].requires_grad_()
    y = matmul_f32(tx, tw)
    assert y.dtype == torch.float32
    gx, gw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(gy))
    assert gx.dtype == tdtype and gw.dtype == tdtype
    np.testing.assert_allclose(_np(y), np.asarray(want), atol=OUT_ATOL, rtol=0)
    tol = dict(atol=OUT_ATOL, rtol=0) if tdtype == torch.float32 else dict(atol=OUT_ATOL, rtol=2**-8)
    np.testing.assert_allclose(_np(gx), np.asarray(want_gx, np.float32), **tol)
    np.testing.assert_allclose(_np(gw), np.asarray(want_gw, np.float32), **tol)


# ---- moe_ffn ----

CASES = [(0.5, 2), (1.25, 2), (4.0, 2), (1.0, 1)]
CASE_IDS = ["drops-k2", "bench-k2", "ample-k2", "k1"]


@pytest.mark.parametrize("dispatch", ["indexed", "dense"])
@pytest.mark.parametrize("capacity_factor,k", CASES, ids=CASE_IDS)
def test_moe_ffn_matches_jax_f32(capacity_factor, k, dispatch):
    jcfg = JaxMoE(n_experts=4, experts_per_token=k, capacity_factor=capacity_factor, d_ff=F,
                  dispatch=dispatch)
    jp, tp = _moe_params(1, jcfg)
    x = _x(2)
    want, waux = jmoe.moe_ffn(jnp.asarray(x), jp, jcfg)
    got, gaux = moe_ffn(torch.from_numpy(x), tp, port_moe(jcfg))
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(float(gaux), float(waux), atol=GATE_ATOL, rtol=0)


def _routing_of(x, router):
    """(choice, keep) of the port's and of JAX's routing for activations x
    (numpy f32 rows) and a router (numpy f32)."""
    n = x.shape[0]
    cap = jmoe._capacity(jmoe.MoEConfig(n_experts=4, experts_per_token=2, capacity_factor=0.75), n)
    j = jmoe.route_indices(jnp.asarray(x) @ jnp.asarray(router), 2, cap)
    t = route_indices(torch.from_numpy(x) @ torch.from_numpy(np.array(router)), 2, cap)
    return (np.asarray(j[0]), np.asarray(j[3])), (_np(t[0]), _np(t[3]))


@pytest.mark.parametrize("dispatch", ["indexed", "dense"])
def test_moe_ffn_matches_jax_bf16(dispatch):
    jcfg = JaxMoE(n_experts=4, experts_per_token=2, capacity_factor=0.75, d_ff=F, dispatch=dispatch)
    jp, tp = _moe_params(3, jcfg, jnp.bfloat16)
    assert tp["router"].dtype == torch.float32 and tp["we_gate"].dtype == torch.bfloat16
    xj = jnp.asarray(_x(4), jnp.bfloat16)
    xt = params_from_numpy({"x": jax.device_get(xj)}, torch.bfloat16, device="cpu")["x"]
    want, waux = jmoe.moe_ffn(xj, jp, jcfg)
    got, gaux = moe_ffn(xt, tp, port_moe(jcfg))
    assert got.dtype == torch.bfloat16
    (jc, jk), (tc, tk) = _routing_of(_np(xt).reshape(-1, D), np.asarray(jp["router"]))
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tk, jk)
    assert not tk.all()  # capacity factor 0.75 drops picks
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=BF16_ATOL, rtol=0)
    np.testing.assert_allclose(float(gaux), float(waux), atol=GATE_ATOL, rtol=0)


@pytest.mark.parametrize("dispatch", ["indexed", "dense"])
@pytest.mark.parametrize("capacity_factor,k", CASES, ids=CASE_IDS)
def test_moe_ffn_gradients_match_jax(capacity_factor, k, dispatch):
    """d/d(x, router, experts) of sum(out * ct) + aux against jax.grad."""
    jcfg = JaxMoE(n_experts=4, experts_per_token=k, capacity_factor=capacity_factor, d_ff=F,
                  dispatch=dispatch)
    jp, tp = _moe_params(5, jcfg)
    x = _x(6)
    ct = _rng(7).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_ffn(x, p, jcfg)
        return jnp.sum(out * ct) + aux

    wgp, wgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    live = {n: t.clone().requires_grad_() for n, t in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = moe_ffn(tx, live, port_moe(jcfg))
    loss = (out * torch.from_numpy(ct)).sum() + aux
    grads = torch.autograd.grad(loss, [tx, *live.values()])
    for name, g, w in zip(["x", *live], grads, [wgx, *(wgp[n] for n in live)]):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, atol=GRAD_RTOL * np.abs(w).max(), rtol=0, err_msg=name)


def test_top1_router_learns_from_the_lm_loss():
    """k = 1 keeps the raw gate: with the aux weight 0 the router's
    gradient comes from the output alone, and equals JAX's."""
    jcfg = _jax_model_cfg(k=1, aux=0.0)
    jparams = jax.device_get(jax_init_params(jax.random.PRNGKey(0), jcfg))
    cfg = port_config(jcfg, remat=False)
    tokens = _rng(8).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    want = _jax_grad(jparams, {"tokens": jnp.asarray(tokens)}, jcfg)["layers"]["router"]
    live = tree_map(lambda t: t.detach().requires_grad_(), params_from_numpy(jparams, torch.float32, "cpu"))
    loss = loss_fn(live, {"tokens": torch.from_numpy(tokens).long()}, cfg)
    (got,) = torch.autograd.grad(loss, [live["layers"]["router"]])
    want = np.asarray(want)
    assert np.abs(_np(got)).sum() > 0
    np.testing.assert_allclose(_np(got), want, atol=GRAD_RTOL * np.abs(want).max(), rtol=0)


def test_moe_ffn_refuses_a_mesh_and_unknown_dispatch():
    """moe_ffn runs over a mesh (the ep paths' parity over gloo ranks is
    tests/test_torch_ep.py): on a one-rank mesh, and through
    _moe_ffn_manual with ep_axis, it is the one-device result; the dense
    dispatch over a live ep axis and an unknown dispatch are refused."""
    from odh_kubeflow_tpu_torch.parallel import MeshPlan

    cfg = MoEConfig(n_experts=4, d_ff=F)
    _, tp = _moe_params(9, JaxMoE(n_experts=4, d_ff=F))
    x = torch.from_numpy(_rng(9).standard_normal((2, 8, D)).astype(np.float32))
    want_out, want_aux = moe_ffn(x, tp, cfg)
    one = MeshPlan().build("cpu")
    for out, aux in (moe_ffn(x, tp, cfg, mesh=one), moe_ffn(x, tp, cfg, mesh=one, ep_axis="ep")):
        assert torch.equal(out, want_out) and torch.equal(aux, want_aux)
    ep_mesh = types.SimpleNamespace(sizes=dict(dp=1, fsdp=1, pp=1, ep=2, tp=1, sp=1))
    with pytest.raises(NotImplementedError, match="dense MoE dispatch over a live ep axis"):
        moe_ffn(x, tp, dataclasses.replace(cfg, dispatch="dense"), mesh=ep_mesh)
    with pytest.raises(ValueError, match="unknown MoE dispatch"):
        moe_ffn(x, tp, dataclasses.replace(cfg, dispatch="sparse"))


@pytest.mark.parametrize("dense", [False, True], ids=["indexed", "dense"])
def test_dispatch_only_matches_jax(dense):
    jcfg = JaxMoE(n_experts=4, experts_per_token=2, capacity_factor=1.0, d_ff=F)
    jp, tp = _moe_params(11, jcfg)
    x = _x(12)
    want = jmoe.dispatch_only(jnp.asarray(x), jp, jcfg, dense=dense)
    got = dispatch_only(torch.from_numpy(x), tp, port_moe(jcfg), dense=dense)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=OUT_ATOL, rtol=0)


@pytest.mark.parametrize("capacity_factor", [0.5, 4.0], ids=["tight", "ample"])
def test_routing_stats_match_jax(capacity_factor):
    jcfg = JaxMoE(n_experts=4, experts_per_token=2, capacity_factor=capacity_factor, d_ff=F)
    jp, tp = _moe_params(13, jcfg)
    x = _x(14)
    want = jmoe.routing_stats(jnp.asarray(x), jp, jcfg)
    got = routing_stats(torch.from_numpy(x), tp, port_moe(jcfg))
    assert got["capacity"] == want["capacity"]
    assert float(got["drop_rate"]) == float(want["drop_rate"])
    assert (float(got["drop_rate"]) > 0) == (capacity_factor == 0.5)
    np.testing.assert_array_equal(_np(got["expert_load_frac"]), np.asarray(want["expert_load_frac"]))


# ---- the model ----

@pytest.fixture(scope="module", params=[0, 2], ids=["mha", "gqa"])
def model(request):
    jcfg = _jax_model_cfg(capacity_factor=1.25, n_kv_heads=request.param)
    jparams = jax.device_get(jax_init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, jparams, port_config(jcfg), params_from_numpy(jparams, torch.float32, device="cpu")


def _tokens(seed, b, s, vocab=96):
    return _rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def test_init_params_is_seeded_and_shaped():
    jcfg = _jax_model_cfg(dtype=jnp.bfloat16)
    cfg = port_config(jcfg, dtype="bfloat16")
    a = init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    want = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), jcfg))
    for name, leaf in want["layers"].items():
        got = a["layers"][name]
        assert tuple(got.shape) == leaf.shape, name
        assert got.dtype == (torch.float32 if leaf.dtype == jnp.float32 else torch.bfloat16), name
    assert "wi_gate" not in a["layers"] and tuple(a["layers"]["we_gate"].shape) == (2, 4, 64, 64)
    router = a["layers"]["router"]
    assert torch.equal(router, router.to(torch.bfloat16).float())  # drawn in bf16, as JAX does
    assert float(router.abs().max()) <= 2.0 * 64**-0.5 + 1e-6


def test_forward_with_aux_and_loss_match_jax(model):
    jcfg, jparams, cfg, params = model
    tokens = _tokens(0, 2, 32)
    want, waux = jax_forward(jparams, jnp.asarray(tokens), jcfg, with_aux=True)
    got, gaux = forward(params, torch.from_numpy(tokens).long(), cfg, with_aux=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(float(gaux), float(waux), atol=LOSS_ATOL, rtol=0)
    assert float(gaux) > 0
    batch = {"tokens": tokens}
    wloss = jax_loss_fn(jparams, {"tokens": jnp.asarray(tokens)}, jcfg)
    gloss = loss_fn(params, {"tokens": torch.from_numpy(tokens).long()}, cfg)
    np.testing.assert_allclose(float(gloss), float(wloss), atol=LOSS_ATOL, rtol=0)
    # the aux term is in the loss: without it the loss differs
    plain = loss_fn(params, batch | {"tokens": torch.from_numpy(tokens).long()},
                    dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, router_aux_weight=0.0)))
    assert float(gloss) - float(plain) == pytest.approx(0.01 * float(gaux) / cfg.n_layers, abs=1e-6)


def test_dense_forward_aux_is_zero():
    jcfg = dataclasses.replace(_jax_model_cfg(), moe=None)
    jparams = jax.device_get(jax_init_params(jax.random.PRNGKey(0), jcfg))
    _, aux = forward(params_from_numpy(jparams, torch.float32, device="cpu"),
                     torch.zeros((1, 4), dtype=torch.long), port_config(jcfg), with_aux=True)
    assert aux.dtype == torch.float32 and aux.dim() == 0 and float(aux) == 0.0


def _value_and_grad(params, tokens, cfg):
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = loss_fn(live, {"tokens": tokens}, cfg)
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(live))


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in _names(v, f"{prefix}/{k}")]
    return [prefix]


def _leaf(tree, name):
    for part in name.strip("/").split("/"):
        tree = tree[part]
    return tree


def test_loss_gradients_match_jax(model):
    jcfg, jparams, cfg, params = model
    tokens = _tokens(1, 2, 32)
    want = _jax_grad(jparams, {"tokens": jnp.asarray(tokens)}, jcfg)
    _, grads = _value_and_grad(params, torch.from_numpy(tokens).long(), cfg)
    for name, g in zip(_names(params), grads):
        w = np.asarray(_leaf(want, name))
        np.testing.assert_allclose(_np(g), w, atol=GRAD_RTOL * np.abs(w).max(), rtol=0, err_msg=name)


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p or "none-saved")
def test_remat_policy_matches_no_remat(model, policy):
    """Under every remat policy the backward's recompute routes as the
    forward did: loss and gradients equal remat=False's."""
    _, _, cfg, params = model
    tokens = torch.from_numpy(_tokens(2, 2, 32)).long()
    want, want_grads = _value_and_grad(params, tokens, dataclasses.replace(cfg, remat=False))
    loss, grads = _value_and_grad(params, tokens, dataclasses.replace(cfg, remat=True, remat_policy=policy))
    assert float(loss) == float(want)
    for name, g, w in zip(_names(params), grads, want_grads):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0, msg=name)


def test_two_train_steps_match_jax(model):
    """Two steps from the same params and optimizer state: each step's loss,
    and after the first the optimizer's first moment everywhere."""
    jcfg, jparams, cfg, params = model
    tokens = _tokens(3, 2, 32)
    jstep, jopt = jax_make_train_step(jcfg)
    jstep = jax.jit(jstep)
    jstate = jopt.init(jparams)
    params = tree_map(torch.clone, params)
    step, opt = make_train_step(cfg)
    state = opt.init(params)
    for i in range(2):
        jparams, jstate, jloss = jstep(jparams, jstate, {"tokens": jnp.asarray(tokens)})
        params, state, loss = step(params, state, {"tokens": torch.from_numpy(tokens).long()})
        np.testing.assert_allclose(float(loss), float(jloss), atol=LOSS_ATOL, rtol=0, err_msg=f"step {i}")
        if i == 0:
            for name in _names(params):
                np.testing.assert_allclose(_np(_leaf(state["mu"], name)),
                                           np.asarray(_leaf(jstate[0].mu, name)), atol=1e-6, rtol=0,
                                           err_msg=name)
    assert state["mu"]["layers"]["router"].dtype == torch.float32


def test_prefill_and_decode_step_match_jax(model):
    jcfg, jparams, cfg, params = model
    prompt = _tokens(4, 2, 12)
    jlogits, jcache = jax_prefill(jparams, jnp.asarray(prompt), jcfg, 32)
    logits, cache = prefill(params, torch.from_numpy(prompt).long(), cfg, 32)
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0)
    for step in range(3):
        token = np.asarray(jnp.argmax(jlogits, axis=-1), np.int32)
        np.testing.assert_array_equal(_np(logits.argmax(-1)), token, err_msg=f"step {step}")
        jlogits, jcache = jax_decode_step(jparams, jcache, jnp.asarray(token), jcfg)
        logits, cache = decode_step(params, cache, torch.tensor(token, dtype=torch.long), cfg)
        np.testing.assert_allclose(_np(logits), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"decode step {step}")


def test_greedy_generate_matches_jax(model):
    """Batch 3 at capacity factor 1.25: each decode step routes 3 tokens
    at capacity 1 per expert, so picks are dropped, as in JAX."""
    jcfg, jparams, cfg, params = model
    prompt = _tokens(5, 3, 8)
    want = np.asarray(jax_generate(jparams, jnp.asarray(prompt), jcfg, max_new=12, max_seq=32))
    got = generate(params, prompt, cfg, max_new=12, max_seq=32, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert "wi_fused" not in _layer_views(params, cfg)[0]


def test_engine_decode_burst_matches_jax_with_drops(model, monkeypatch):
    """The port's burst against JAX's on the same caches and slots: 8 slots
    (3 free) at capacity factor 1.25, so each step routes 8 rows at
    capacity 5 per expert and drops picks; every slot is routed, free ones
    included, in slot order. Emitted tokens and active masks equal."""
    jcfg, jparams, cfg, params = model
    n_slots, max_seq, burst = 8, 32, 6
    rng = _rng(6)
    shape = (n_slots, max_seq, cfg.kv_heads, cfg.head_dim)
    kv = [(rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(np.float32))
          for _ in range(cfg.n_layers)]
    lengths = rng.integers(3, 12, n_slots).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab, n_slots).astype(np.int32)
    remaining = np.array([5, 0, 7, 2, 0, 9, 0, 4], np.int32)

    jlayers = tuple(jax.tree_util.tree_map(lambda a, i=i: a[i], jparams["layers"])
                    for i in range(cfg.n_layers))
    jcaches = tuple((jnp.asarray(k), jnp.asarray(v)) for k, v in kv)
    *_, jtoks, jactives = jengine._decode_burst(
        jparams, jcaches, jlayers, jnp.asarray(lengths), jnp.asarray(tokens), jnp.asarray(remaining),
        jnp.int32(-1), jcfg, burst)

    seen = []

    def recording(x, params, cfg, *args):
        seen.append(x.detach().clone())
        return moe.moe_ffn(x, params, cfg, *args)

    monkeypatch.setattr(transformer, "moe_ffn", recording)
    caches = tuple((torch.from_numpy(k.copy()), torch.from_numpy(v.copy())) for k, v in kv)
    with torch.inference_mode():
        *_, toks, actives = tengine._decode_burst(
            params, caches, tuple(_layer_views(params, cfg)), torch.from_numpy(lengths).long(),
            torch.from_numpy(tokens).long(), torch.from_numpy(remaining).long(), torch.tensor(-1),
            cfg, burst, max_seq)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(actives.numpy(), np.asarray(jactives))
    assert len(seen) == burst * cfg.n_layers and all(x.shape[0] == n_slots for x in seen)
    drops = [float(routing_stats(x, transformer.layer_view(params, i % cfg.n_layers), cfg.moe_resolved)
                   ["drop_rate"]) for i, x in enumerate(seen)]
    assert max(drops) > 0, drops


def test_check_supported_takes_only_a_port_config():
    with pytest.raises(TypeError, match="MoEConfig"):
        transformer.check_supported(TransformerConfig(moe=JaxMoE()))
    transformer.check_supported(TransformerConfig(moe=MoEConfig()))
    assert TransformerConfig(d_ff=96, moe=MoEConfig()).moe_resolved.d_ff == 96
    assert TransformerConfig(d_ff=96, moe=MoEConfig(d_ff=8)).moe_resolved.d_ff == 8


# ---- conversion ----

def test_bf16_tree_converts_with_an_f32_router_and_the_reference_digest():
    """The JAX package keeps the router f32 inside a bf16 model, and optax
    keeps its nu in the param's dtype: both convert unrounded, and the
    digest equals the reference's (it hashes each leaf's dtype name)."""
    import optax

    jcfg = _jax_model_cfg(dtype=jnp.bfloat16)
    jparams = jax_init_params(jax.random.PRNGKey(1), jcfg)
    host = jax.device_get(jparams)
    params = params_from_numpy(host, torch.bfloat16, device="cpu")
    assert params["layers"]["router"].dtype == torch.float32
    assert params["layers"]["we_gate"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params["layers"]["router"].numpy(), host["layers"]["router"])
    assert state_checksum(params) == ref_checkpoint.state_checksum(host)
    ref = optax.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1, mu_dtype=jnp.float32)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.5), jparams)
    _, jstate = ref.update(grads, ref.init(jparams), jparams)
    state = opt_state_from_numpy(jax.device_get(jstate[0]), torch.bfloat16, device="cpu")
    assert state["nu"]["layers"]["router"].dtype == torch.float32
    assert state["nu"]["layers"]["we_up"].dtype == torch.bfloat16
    np.testing.assert_array_equal(state["nu"]["layers"]["router"].numpy(),
                                  np.asarray(jstate[0].nu["layers"]["router"]))
