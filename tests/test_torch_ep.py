"""The port's ep MoE and tp with shared kv heads against the JAX package on
the CPU, over gloo ranks (tests/torch_dist.py; the rank jobs are
tests/torch_ep_cases.py and tests/torch_shard_cases.py, jax-free), one
spawn of 4 ranks for every case.

- `moe_ffn(mesh=)` at ep 2 x tp 2 and ep 2 x fsdp 2 (and at fsdp 2 x tp
  2, where no ep axis is live and the reference routes the global batch)
  against
  `jax.value_and_grad` through the reference's `moe_ffn(mesh=)`
  (tests/test_moe.py:420-470's shapes; its `_moe_ffn_ep_indexed`): out,
  aux and the gradients of the router, every expert stack and x, of
  sum(out**2) + aux / 2, within 1e-5 (of each array's largest, where it
  is above 1).
- The MoE `loss_fn` at those three meshes: the loss and the gathered gradients
  against `jax.value_and_grad` of the reference's `loss_fn` on the same
  mesh (per-shard capacity and the aux averaged over the data axes, as
  the reference's), within 1e-5; one make_train_step step leaves every
  replicated leaf bit-equal across its ranks.
- The dense dispatch (`dispatch="dense"`) over those two ep meshes: out,
  aux and the gradients against the reference's dense `moe_ffn(mesh=)`
  (its GSPMD einsums: the global batch's capacity and aux), within 1e-5;
  at ep 2 x tp 2, whose tokens are not cut over a data axis, also against
  the port's indexed ep path, and the model's loss and gradients against
  the reference's dense `loss_fn` and the port's indexed run.
- tp 4 with n_kv_heads 2 (kv_heads % tp != 0): the loss and gathered
  gradients against the JAX loss on the same mesh, within 1e-5.
- Each rank's `shard_params` block of the ep leaves equals the JAX
  array's addressable shard on the 8-device virtual mesh
  (tests/conftest.py; device i is rank i).
- A checkpoint of the ep 2 x tp 2 train state, saved through every rank's
  hook, restored onto one process: the checksum the ranks acked.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import torch_dist
import torch_threads
from odh_kubeflow_tpu.models import MoEConfig as JaxMoE
from odh_kubeflow_tpu.models import TransformerConfig as JaxConfig
from odh_kubeflow_tpu.models import init_params as jax_init_params
from odh_kubeflow_tpu.models import loss_fn as jax_loss_fn
from odh_kubeflow_tpu.models import moe as jmoe
from odh_kubeflow_tpu.models import param_specs as jax_param_specs
from odh_kubeflow_tpu.models.transformer import _interleave_wqkv
from odh_kubeflow_tpu.parallel import MeshPlan as JaxMeshPlan
from odh_kubeflow_tpu.parallel import shard_batch as jax_shard_batch
from odh_kubeflow_tpu_torch.models import (MoEConfig, TransformerConfig, adamw, init_params, restore_train_state,
                                           state_checksum)

torch_threads.cap()

ATOL = 1e-5
WORLD = 4
EP_PLANS = [{"ep": 2, "tp": 2}, {"ep": 2, "fsdp": 2}]
# no live ep axis: the reference's GSPMD routes the global batch
GLOBAL_PLAN = {"fsdp": 2, "tp": 2}
SHARED_PLAN = {"tp": 4}
# tests/test_moe.py:420-470's layer, with a capacity that drops picks
MOE = JaxMoE(n_experts=4, experts_per_token=2, capacity_factor=1.25, d_ff=64)
D, AUX_WEIGHT = 32, 0.5
X = np.random.default_rng(1).standard_normal((4, 16, D)).astype(np.float32)
# the model: 2 layers, GQA 4/2, the MoE layer of bench.py:389-400's shape
# (8 experts, top-2, capacity 1.25, remat "") at narrow widths
JCFG = JaxConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
                 dtype=jnp.float32, use_flash=False, remat=False,
                 moe=JaxMoE(n_experts=8, experts_per_token=2, capacity_factor=1.25, d_ff=32))
DENSE = dataclasses.replace(JCFG, moe=None)
# the dense dispatch (the reference's A/B knob) on the same layer and model
MOE_DENSE = dataclasses.replace(MOE, dispatch="dense")
JCFG_DENSE = dataclasses.replace(JCFG, moe=dataclasses.replace(JCFG.moe, dispatch="dense"))
# the ep mesh whose tokens are not cut over a data axis: the indexed ep
# path's per-shard capacity is the global batch's there
WHOLE_PLAN = EP_PLANS[0]
TOKENS = np.random.default_rng(2).integers(0, JCFG.vocab, (4, 32)).astype(np.int32)


def _close(got, want, what=""):
    """Within ATOL, of the array's largest where it is above 1 (f32
    summation order)."""
    np.testing.assert_allclose(got, want, atol=ATOL * max(1.0, float(np.abs(want).max())), rtol=0,
                               err_msg=what)


def _id(plan):
    return "-".join(f"{k}{v}" for k, v in plan.items())


def port_moe(m):
    return MoEConfig(**{f.name: getattr(m, f.name) for f in dataclasses.fields(MoEConfig)})


def port_cfg(jcfg, **kw):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(TransformerConfig)}
    if jcfg.moe is not None:
        fields["moe"] = port_moe(jcfg.moe)
    fields.update(dtype="float32", **kw)
    return TransformerConfig(**fields)


def run_cfg(jcfg):
    """The port's run: the flash op (its plain version on the CPU), the
    layer checkpoint saving nothing (the backward recomputes the layer,
    its collectives included)."""
    return port_cfg(jcfg, use_flash=True, remat=True, remat_policy="")


def _jmesh(plan):
    return JaxMeshPlan(**plan).build(jax.devices()[:WORLD])


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, prefix + (k,))]
    return [prefix]


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jax.device_get(tree))


@pytest.fixture(scope="module")
def moe_params():
    return _numpy(jmoe.init_moe_params(jax.random.PRNGKey(0), D, MOE, jnp.float32))


@pytest.fixture(scope="module")
def model_params():
    return {"moe": _numpy(jax_init_params(jax.random.PRNGKey(0), JCFG)),
            "dense": _numpy(jax_init_params(jax.random.PRNGKey(0), DENSE))}


@pytest.fixture(scope="module")
def ranks(moe_params, model_params, tmp_path_factory):
    cases = []
    for plan in EP_PLANS + [GLOBAL_PLAN]:
        cases.append((f"moe {_id(plan)}", "torch_ep_cases:moe_case",
                      dict(params=moe_params, x=X, cfg=port_moe(MOE), plan=plan, aux_weight=AUX_WEIGHT)))
        cases.append((f"model {_id(plan)}", "torch_shard_cases:model_case",
                      dict(params=model_params["moe"], batch={"tokens": TOKENS}, cfg=run_cfg(JCFG), plan=plan,
                           use_kernel=None, train_step=True)))
    for plan in EP_PLANS:
        cases.append((f"moe dense {_id(plan)}", "torch_ep_cases:moe_case",
                      dict(params=moe_params, x=X, cfg=port_moe(MOE_DENSE), plan=plan, aux_weight=AUX_WEIGHT)))
    cases.append((f"model dense {_id(WHOLE_PLAN)}", "torch_shard_cases:model_case",
                  dict(params=model_params["moe"], batch={"tokens": TOKENS}, cfg=run_cfg(JCFG_DENSE),
                       plan=WHOLE_PLAN, use_kernel=None)))
    for plan in EP_PLANS:
        cases.append((f"shard {_id(plan)}", "torch_shard_cases:shard_case",
                      dict(params=model_params["moe"], cfg=port_cfg(JCFG), plan=plan)))
    cases.append(("shared kv", "torch_shard_cases:model_case",
                  dict(params=model_params["dense"], batch={"tokens": TOKENS}, cfg=run_cfg(DENSE),
                       plan=SHARED_PLAN, use_kernel=None, train_step=True)))
    cases.append(("comm", "torch_ep_cases:comm_ep_case", {}))
    directory = str(tmp_path_factory.mktemp("ep-ckpt"))
    cases.append(("checkpoint", "torch_shard_cases:sharded_hooks_case",
                  dict(directory=directory, params=model_params["moe"], batch={"tokens": TOKENS},
                       cfg=run_cfg(JCFG), plan=EP_PLANS[0])))
    out = torch_dist.run_ranks(WORLD, cases)
    out["directory"] = directory
    return out


def _jax_moe(params, plan, cfg=MOE):
    mesh = _jmesh(plan)

    def f(p, x):
        out, aux = jmoe.moe_ffn(x, p, cfg, mesh=mesh)
        return jnp.sum(out ** 2) + AUX_WEIGHT * aux, (out, aux)

    (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(X))
    return np.asarray(out), float(aux), _numpy(gp), np.asarray(gx)


def _rows(full, coords, plan):
    """The (batch, seq) block of a global array that the rank at `coords`
    holds (the batch over dp x fsdp; no sp here)."""
    n = plan.get("dp", 1) * plan.get("fsdp", 1)
    i = coords["dp"] * plan.get("fsdp", 1) + coords["fsdp"]
    b = full.shape[0] // n
    return full[i * b:(i + 1) * b]


@pytest.mark.parametrize("plan", EP_PLANS + [GLOBAL_PLAN], ids=_id)
def test_moe_ffn_on_ep_mesh_matches_jax(moe_params, ranks, plan):
    out, aux, grads, dx = _jax_moe(moe_params, plan)
    per = ranks[f"moe {_id(plan)}"]
    for r in per:
        _close(r["out"], _rows(out, r["coords"], plan), "out")
        _close(r["dx"], _rows(dx, r["coords"], plan), "dx")
        assert abs(r["aux"] - aux) <= ATOL
    assert sorted(per[0]["grads"]) == sorted(grads)
    for name, want in grads.items():
        assert np.abs(want).max() > 0, name
        _close(per[0]["grads"][name], want, name)
    # the ep sum, forward and backward, and the aux mean over the data
    # axes; without ep, the tokens' gather over the data axes instead
    ex = per[0]["exchanges"]
    n_data = plan.get("fsdp", 1)
    rows = X.shape[0] // n_data * X.shape[1]
    if plan.get("ep", 1) > 1:
        assert (ex["ep"], ex["ep_bytes"]) == (2, 2 * rows * D * 4)
        assert (ex["aux"], ex["aux_bytes"]) == ((1, 4) if n_data > 1 else (0, 0))
    else:
        assert ex["ep"] == ex["aux"] == 0
        assert (ex["scatter"], ex["scatter_bytes"]) >= (1, X.size * 4)


@pytest.mark.parametrize("plan", EP_PLANS, ids=_id)
def test_dense_dispatch_on_ep_mesh_matches_jax_and_the_indexed_path(moe_params, ranks, plan):
    """The dense dispatch over a live ep axis: each rank's one-hot dispatch
    and combine over its own experts, one f32 sum over ep, the global
    batch's capacity and aux, as the reference's dense einsums compute."""
    out, aux, grads, dx = _jax_moe(moe_params, plan, MOE_DENSE)
    per = ranks[f"moe dense {_id(plan)}"]
    for r in per:
        _close(r["out"], _rows(out, r["coords"], plan), "out")
        _close(r["dx"], _rows(dx, r["coords"], plan), "dx")
        assert abs(r["aux"] - aux) <= ATOL
    assert sorted(per[0]["grads"]) == sorted(grads)
    for name, want in grads.items():
        assert np.abs(want).max() > 0, name
        _close(per[0]["grads"][name], want, name)
    ex = per[0]["exchanges"]
    assert (ex["ep"], ex["ep_bytes"]) == (2, 2 * X.size * 4)
    assert ex["aux"] == 0
    if plan == WHOLE_PLAN:  # no data axis: the indexed ep path routes the same tokens
        for dense, indexed in zip(per, ranks[f"moe {_id(plan)}"]):
            _close(dense["out"], indexed["out"], "out vs indexed")
            _close(dense["dx"], indexed["dx"], "dx vs indexed")
            assert abs(dense["aux"] - indexed["aux"]) <= ATOL
        for name, want in ranks[f"moe {_id(plan)}"][0]["grads"].items():
            _close(per[0]["grads"][name], want, f"{name} vs indexed")


def test_dense_dispatch_model_loss_on_ep_mesh_matches_jax_and_the_indexed_run(model_params, ranks):
    want_loss, want = _jax_loss(model_params["moe"], JCFG_DENSE, WHOLE_PLAN)
    per, indexed = ranks[f"model dense {_id(WHOLE_PLAN)}"], ranks[f"model {_id(WHOLE_PLAN)}"]
    assert len({r["loss"] for r in per}) == 1
    assert abs(per[0]["loss"] - want_loss) <= ATOL
    assert abs(per[0]["loss"] - indexed[0]["loss"]) <= ATOL
    assert len(per[0]["grads"]) == len(want) == len(indexed[0]["grads"])
    for g, w, i in zip(per[0]["grads"], want, indexed[0]["grads"]):
        assert g.shape == w.shape
        _close(g, w)
        _close(g, i)
    _assert_replicas_equal(per, "grad_replicas")


def _jax_loss(params, jcfg, plan):
    mesh = _jmesh(plan)
    specs = jax_param_specs(jcfg, mesh)
    sharded = jax.tree_util.tree_map(lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), params, specs)
    batch = jax_shard_batch(mesh, {"tokens": jnp.asarray(TOKENS)})
    loss, grads = jax.jit(jax.value_and_grad(jax_loss_fn), static_argnums=(2, 3))(sharded, batch, jcfg, mesh)
    return float(loss), [np.asarray(g) for g in _leaves(jax.device_get(grads))]


def _assert_replicas_equal(per, key):
    for name in per[0][key]:
        blocks = {}
        for r in per:
            coords, digest = r[key][name]
            blocks.setdefault(coords, set()).add(digest)
        assert all(len(d) == 1 for d in blocks.values()), (key, name, blocks)


@pytest.mark.parametrize("name,jcfg,plan", [(f"model {_id(p)}", JCFG, p) for p in EP_PLANS + [GLOBAL_PLAN]]
                         + [("shared kv", DENSE, SHARED_PLAN)],
                         ids=[_id(p) for p in EP_PLANS + [GLOBAL_PLAN]] + ["tp4-kv2"])
def test_sharded_loss_and_grads_match_jax_on_mesh(model_params, ranks, name, jcfg, plan):
    want_loss, want = _jax_loss(model_params["moe" if jcfg.moe else "dense"], jcfg, plan)
    per = ranks[name]
    assert len({r["loss"] for r in per}) == 1  # the same bits on every rank
    assert abs(per[0]["loss"] - want_loss) <= ATOL
    got = per[0]["grads"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)
    _assert_replicas_equal(per, "grad_replicas")
    _assert_replicas_equal(per, "replicas")  # after one make_train_step step
    # the flash op's plain calls: one forward a layer, again in the
    # recompute (remat ""), one backward pair a layer
    n = jcfg.n_layers
    assert all(r["launches"] == {"fwd": 2 * n, "dq": n, "dkv": n} for r in per)


@pytest.mark.parametrize("plan", EP_PLANS, ids=_id)
def test_ep_rank_blocks_match_jax_addressable_shards(model_params, ranks, plan):
    params = model_params["moe"]
    per = ranks[f"shard {_id(plan)}"]
    jmesh = _jmesh(plan)
    specs = jax_param_specs(JCFG, jmesh)
    tp = plan.get("tp", 1)
    for path in _paths(params):
        full = np.asarray(_at(params, path), np.float32)
        if path[-1] == "wqkv" and tp > 1:  # the manual-tp layout: each rank's own [q | k | v]
            full = np.asarray(_interleave_wqkv(jnp.asarray(full), JCFG.n_heads, JCFG.kv_heads, tp))
        sharded = jax.device_put(full, NamedSharding(jmesh, _at(specs, path)))
        for r, got in enumerate(per):
            want = next(s.data for s in sharded.addressable_shards if s.device == jax.devices()[r])
            np.testing.assert_array_equal(_at(got["blocks"], path), np.asarray(want), err_msg=f"rank {r} {path}")
        np.testing.assert_array_equal(_at(per[0]["gathered"], path), np.asarray(_at(params, path), np.float32))


def test_ep_checkpoint_restores_onto_one_process(ranks):
    """The ep 2 x tp 2 state, saved by every rank's hook at once: four
    equal acks; restored onto one process (a fresh init of other values),
    the checksum they acked."""
    per = ranks["checkpoint"]
    acks = [r["ack"] for r in per]
    assert acks == [{"checksum": per[0]["global"], "step": 1}] * WORLD
    assert acks[0]["checksum"] == per[0]["global"] and all(r["same_blocks"] for r in per)
    cfg = run_cfg(JCFG)
    like = init_params(torch.Generator().manual_seed(11), cfg, device="cpu")
    restored = restore_train_state(ranks["directory"], {"params": like, "opt_state": adamw().init(like)})
    assert state_checksum(restored) == per[0]["global"]


def test_ep_and_decode_collectives(ranks):
    """The ep pair is tp's pair over another group: ep_enter the identity
    whose gradient is summed over the group, ep_sum the f32 sum whose
    gradient is the identity; gather_slices' gradient is the rank's slice
    of the whole one; aux_mean the mean, its gradient scaled as asked;
    vocab_argmax over blocks with ties gives argmax's first index of the
    whole row, moving one f32 and one int64 value a row."""
    per = ranks["comm"]
    x = [np.arange(6.0).reshape(2, 3) + 10 * r for r in range(WORLD)]
    for r, got in enumerate(per):
        np.testing.assert_array_equal(got["ep_enter"][0], x[r])
        np.testing.assert_array_equal(got["ep_enter"][1], sum(x))
        np.testing.assert_array_equal(got["ep_sum"][0], sum(x))
        np.testing.assert_array_equal(got["ep_sum"][1], x[r])
        blocks = [np.arange(6.0).reshape(3, 2) + 10 * q for q in range(WORLD)]
        np.testing.assert_array_equal(got["gather_slices"][0], np.concatenate(blocks, axis=1))
        whole = np.arange(6.0 * WORLD).reshape(3, 2 * WORLD)
        np.testing.assert_array_equal(got["gather_slices"][1], whole[:, 2 * r:2 * r + 2])
        assert got["aux_mean"] == (np.mean(np.arange(1.0, WORLD + 1)), 0.25)
        argmax, want = got["argmax"]
        np.testing.assert_array_equal(argmax, want)
        assert got["argmax_bytes"] == 5 * (4 + 8)
