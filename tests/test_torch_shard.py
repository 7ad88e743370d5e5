"""The port's fsdp/tp sharded train step against the JAX package on the CPU.

- `param_specs` equals the JAX `param_specs` as spec tuples (dense, GQA
  4/2, MoE, and the GQA configs whose fused QKV axis tp does not divide,
  which the reference replicates), over the plans of
  tests/test_torch_parallel.py.
- Each rank's `shard_params` block equals the JAX array's addressable
  shard on the 8-device virtual mesh (tests/conftest.py; device i is rank
  i), at fsdp 2 x tp 2 x sp 2 and dp 2 x fsdp 2 x tp 2; for wqkv, the shard
  of the reference's own `_interleave_wqkv` layout (each tp rank's own
  [q | k | v] heads). `gather_params` joins the blocks back.
- The loss and the gathered gradients at fsdp 2 x tp 2, tp 2 x sp 2 (both
  layouts), fsdp 2 x tp 2 x sp 2 (tests/test_model.py:62's mesh) and dp 2 x
  fsdp 2 x tp 2 equal the JAX `loss_fn` and `jax.grad` on the full batch,
  through the reference path and the kernel path (the flash op's plain
  versions on the CPU); f32, 2 layers, GQA 4/2, tolerance 1e-5 absolute,
  as tests/test_torch_sp.py's.
- One make_train_step step, gathered, equals the one-process port step
  (tests/test_model.py:178's GQA sharded step), and every leaf replicated
  over an axis has the same bits on every rank of it (params, AdamW
  state, gradients).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import torch_dist
import torch_threads
from odh_kubeflow_tpu.models import MoEConfig as JaxMoEConfig
from odh_kubeflow_tpu.models import TransformerConfig as JaxConfig
from odh_kubeflow_tpu.models import init_params as jax_init_params
from odh_kubeflow_tpu.models import loss_fn as jax_loss_fn
from odh_kubeflow_tpu.models import param_specs as jax_param_specs
from odh_kubeflow_tpu.models.transformer import _interleave_wqkv
from odh_kubeflow_tpu.parallel import MeshPlan as JaxMeshPlan
from odh_kubeflow_tpu_torch.models import (MoEConfig, TransformerConfig, make_train_step, make_zigzag_batch,
                                           param_placements, param_specs, params_from_numpy)
from odh_kubeflow_tpu_torch.models.transformer import check_mesh
from odh_kubeflow_tpu_torch.parallel import MeshPlan

torch_threads.cap()

ATOL = 1e-5
JCFG = JaxConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
                 dtype=jnp.float32, use_flash=False, remat=False)
TOKENS = np.random.default_rng(1).integers(0, JCFG.vocab, (4, 32)).astype(np.int32)
# (world, plan, layout) of the whole-slice cases
MESHES = [(4, {"fsdp": 2, "tp": 2}, "contiguous"), (4, {"tp": 2, "sp": 2}, "contiguous"),
          (4, {"tp": 2, "sp": 2}, "zigzag"), (8, {"fsdp": 2, "tp": 2, "sp": 2}, "contiguous"),
          (8, {"dp": 2, "fsdp": 2, "tp": 2}, "contiguous")]
SHARD_PLANS = {4: [{"fsdp": 2, "tp": 2}], 8: [{"fsdp": 2, "tp": 2, "sp": 2}, {"dp": 2, "fsdp": 2, "tp": 2}]}
# the plans of tests/test_torch_parallel.py's spec cases, and tp 8 for the
# fused QKV axis the reference replicates
SPEC_PLANS = [dict(), dict(fsdp=2, tp=2, sp=2), dict(sp=8), dict(dp=2, fsdp=4), dict(dp=2, sp=4),
              dict(ep=2, pp=2, tp=2), dict(dp=2, fsdp=2, sp=2), dict(tp=8)]
SPEC_CFGS = {
    "dense": dict(n_heads=4),
    "gqa-4-2": dict(n_heads=4, n_kv_heads=2),
    "gqa-8-2": dict(n_heads=8, n_kv_heads=2),  # fused 12: tp 8 replicates it
    "gqa-32-4": dict(n_heads=32, n_kv_heads=4, d_model=256),
    "moe": dict(n_heads=4, moe="moe"),
}


def _id(plan, layout="contiguous", kernel=None):
    out = "-".join(f"{k}{v}" for k, v in plan.items()) or "one"
    out += "" if layout == "contiguous" else "-zigzag"
    return out if kernel is None else out + ("-kernel" if kernel else "-ref")


def port_cfg(jcfg, **kw):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(TransformerConfig)}
    if jcfg.moe is not None:
        fields["moe"] = MoEConfig(**{f.name: getattr(jcfg.moe, f.name) for f in dataclasses.fields(MoEConfig)})
    fields.update(dtype="float32", **kw)
    return TransformerConfig(**fields)


def run_cfg(plan, layout, kernel):
    """The port config of one run: remat "flash"; under sp the ring (its
    kernel path or reference path), else the flash op or mha_reference."""
    sp = plan.get("sp", 1) > 1
    return port_cfg(JCFG, use_flash=kernel or sp, remat=True, remat_policy="flash",
                    seq_axis="sp" if sp else "", seq_layout=layout)


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


@pytest.mark.parametrize("plan", SPEC_PLANS, ids=_id)
@pytest.mark.parametrize("name", sorted(SPEC_CFGS))
def test_param_specs_match_reference(name, plan):
    kw = dict(SPEC_CFGS[name])
    if kw.pop("moe", None):
        kw["moe"] = JaxMoEConfig(n_experts=4, experts_per_token=2)
    jcfg = dataclasses.replace(JCFG, **kw)
    n = MeshPlan(**plan).n_devices
    jmesh = JaxMeshPlan(**plan).build(jax.devices()[:n])
    mesh = types.SimpleNamespace(sizes=MeshPlan(**plan).sizes())
    want = jax.tree_util.tree_map(tuple, jax_param_specs(jcfg, jmesh),
                                  is_leaf=lambda x: isinstance(x, PartitionSpec))
    got = param_specs(port_cfg(jcfg), mesh)
    assert got == want
    assert param_specs(port_cfg(jcfg)) == jax.tree_util.tree_map(
        tuple, jax_param_specs(jcfg), is_leaf=lambda x: isinstance(x, PartitionSpec))
    # the placements carry the specs; the fused axis cut over tp carries
    # its [q | k | v] segments, except where tp does not divide kv_heads:
    # there the port keeps wqkv replicated over tp (each rank slices its
    # heads), wherever the reference cuts the fused axis
    placements = param_placements(port_cfg(jcfg), mesh)
    shared = jcfg.kv_heads % mesh.sizes["tp"] != 0
    want_specs = jax.tree_util.tree_map(lambda x: x, got, is_leaf=lambda x: isinstance(x, tuple))
    if shared and len(got["layers"]["wqkv"]) > 2 and got["layers"]["wqkv"][2] is not None:
        spec = tuple(got["layers"]["wqkv"][:2])
        while spec and spec[-1] is None:
            spec = spec[:-1]
        want_specs["layers"]["wqkv"] = spec
    assert jax.tree_util.tree_map(lambda p: p.spec, placements,
                                  is_leaf=lambda x: hasattr(x, "spec")) == want_specs
    wqkv = placements["layers"]["wqkv"]
    cut = len(wqkv.spec) > 2 and wqkv.spec[2] is not None
    assert wqkv.segments == (((2, (jcfg.n_heads, jcfg.kv_heads, jcfg.kv_heads)),) if cut else ())


@pytest.mark.parametrize("name,tp", [("gqa-8-2", 8), ("gqa-32-4", 8), ("gqa-4-2", 4)])
def test_kv_heads_tp_does_not_divide_raises(name, tp):
    """A rank's q heads share kv heads with another rank's (the replicated
    fused axis is such a config): check_mesh no longer raises; wqkv is
    replicated over tp, and each rank's widths are its q heads and the kv
    heads they read (one head, or one per q head where they span groups
    unevenly). The parity over gloo ranks: tests/test_torch_tp_decode.py
    and tests/test_torch_ep.py (tp 4 with kv_heads 2)."""
    from odh_kubeflow_tpu_torch.models.transformer import _local_cfg, _rank_kv_heads

    cfg = port_cfg(dataclasses.replace(JCFG, **SPEC_CFGS[name]))
    mesh = types.SimpleNamespace(sizes=MeshPlan(tp=tp).sizes())
    check_mesh(mesh, cfg, "forward")
    assert param_placements(cfg, mesh)["layers"]["wqkv"].axes() == ()
    local = _local_cfg(cfg, mesh)
    heads = [_rank_kv_heads(cfg.n_heads, cfg.kv_heads, tp, r) for r in range(tp)]
    assert local.n_heads == cfg.n_heads // tp and {len(h) for h in heads} == {local.kv_heads}
    group = cfg.n_heads // cfg.kv_heads
    for r, mine in enumerate(heads):  # every q head of the rank reads a kv head it holds
        q_heads = range(r * local.n_heads, (r + 1) * local.n_heads)
        assert all(q // group == mine[i * len(mine) // local.n_heads] for i, q in enumerate(q_heads))


@pytest.fixture(scope="module")
def reference():
    """The JAX init (numpy) and the JAX loss and gradients on the full batch."""
    params = jax.device_get(jax_init_params(jax.random.PRNGKey(0), JCFG))
    loss, grads = jax.value_and_grad(jax_loss_fn)(params, {"tokens": jnp.asarray(TOKENS)}, JCFG)
    return params, float(loss), grads


@pytest.fixture(scope="module")
def ranks(reference):
    nparams = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), reference[0])
    out = {}
    for world in (4, 8):
        cases = [(f"shard {_id(plan)}", "torch_shard_cases:shard_case",
                  dict(params=nparams, cfg=port_cfg(JCFG), plan=plan)) for plan in SHARD_PLANS[world]]
        for w, plan, layout in MESHES:
            if w != world:
                continue
            sp = plan.get("sp", 1)
            batch = ({"tokens": TOKENS} if layout == "contiguous"
                     else {k: v.numpy() for k, v in make_zigzag_batch(TOKENS, sp).items()})
            for kernel in (False, True):
                cases.append((_id(plan, layout, kernel), "torch_shard_cases:model_case",
                              dict(params=nparams, batch=batch, cfg=run_cfg(plan, layout, kernel), plan=plan,
                                   use_kernel=kernel if sp > 1 else None, train_step=kernel)))
        out[world] = torch_dist.run_ranks(world, cases)
    return out


@pytest.mark.parametrize("world,plan", [(w, p) for w, plans in SHARD_PLANS.items() for p in plans],
                         ids=lambda x: _id(x) if isinstance(x, dict) else str(x))
def test_rank_blocks_match_jax_addressable_shards(reference, ranks, world, plan):
    params = reference[0]
    per = ranks[world][f"shard {_id(plan)}"]
    jmesh = JaxMeshPlan(**plan).build(jax.devices()[:world])
    specs = jax_param_specs(JCFG, jmesh)
    tp = MeshPlan(**plan).sizes()["tp"]
    for path in _paths(params):
        full = np.asarray(_at(params, path), np.float32)
        spec = _at(specs, path)
        if path[-1] == "wqkv" and tp > 1:  # the manual-tp layout: each rank's own [q | k | v]
            full = np.asarray(_interleave_wqkv(jnp.asarray(full), JCFG.n_heads, JCFG.kv_heads, tp))
        sharded = jax.device_put(full, NamedSharding(jmesh, spec))
        for r, got in enumerate(per):
            want = next(s.data for s in sharded.addressable_shards if s.device == jax.devices()[r])
            np.testing.assert_array_equal(_at(got["blocks"], path), np.asarray(want),
                                          err_msg=f"rank {r} {path}")
        # gather_params joins the blocks back into the global leaf
        np.testing.assert_array_equal(_at(per[0]["gathered"], path), np.asarray(_at(params, path), np.float32))


@pytest.mark.parametrize("world,plan,layout", MESHES, ids=[_id(p, lay) for _, p, lay in MESHES])
@pytest.mark.parametrize("kernel", [False, True], ids=["ref", "kernel"])
def test_sharded_loss_and_grads_match_jax_full_batch(reference, ranks, world, plan, layout, kernel):
    params, want_loss, want_grads = reference
    per = ranks[world][_id(plan, layout, kernel)]
    assert len({r["loss"] for r in per}) == 1  # the global loss, the same bits on every rank
    assert abs(per[0]["loss"] - want_loss) < ATOL
    got = per[0]["grads"]
    want = _leaves(jax.device_get(want_grads))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0)
    _assert_replicas_equal(per, "grad_replicas")


def _assert_replicas_equal(per, key):
    """Ranks that hold the same block of a leaf (equal coordinates on the
    axes that cut it) hold the same bits."""
    for name in per[0][key]:
        blocks = {}
        for r in per:
            coords, digest = r[key][name]
            blocks.setdefault(coords, set()).add(digest)
        assert all(len(d) == 1 for d in blocks.values()), (key, name, blocks)


@pytest.mark.parametrize("world,plan,layout", MESHES, ids=[_id(p, lay) for _, p, lay in MESHES])
def test_sharded_train_step_matches_one_process(reference, ranks, world, plan, layout):
    """One make_train_step step over the mesh, gathered, against the
    one-process port step on the full batch; the replicated leaves of the
    params and AdamW state bit-equal across their ranks; the kernel path's
    plain forward/dq/dk-dv calls per rank (the ring's under sp)."""
    per = ranks[world][_id(plan, layout, True)]
    cfg = port_cfg(JCFG, use_flash=True, remat=True, remat_policy="flash")
    params = params_from_numpy(reference[0], "float32", device="cpu")
    step, opt = make_train_step(cfg)
    state = opt.init(params)
    params, state, loss = step(params, state, {"tokens": torch.as_tensor(TOKENS).long()})
    assert all(abs(r["step_loss"] - loss.item()) < ATOL for r in per)
    for path in _paths(params):
        np.testing.assert_allclose(_at(per[0]["params"], path), _at(params, path).numpy(), atol=ATOL, rtol=0,
                                   err_msg=str(path))
    _assert_replicas_equal(per, "replicas")
    from odh_kubeflow_tpu_torch.ops.ring_attention import ring_launches

    sp = plan.get("sp", 1)
    sched = ring_launches(sp, layout) if sp > 1 else [1]
    n = JCFG.n_layers
    for r, got in enumerate(per):  # sp is innermost: rank r's sp index is r % sp
        want = n * sched[r % sp]
        assert got["launches"] == {"fwd": want, "dq": want, "dkv": want}, (r, got["launches"])


@pytest.mark.parametrize("world,plan,layout", MESHES, ids=[_id(p, lay) for _, p, lay in MESHES])
def test_exchanges_by_kind(ranks, world, plan, layout):
    """The step's exchanges per kind, from the shapes: fsdp gathers every
    weight before use (the layer's again in the checkpoint's recompute)
    and reduce-scatters each gather's gradient; tp sums the row-parallel
    outputs (forward and the recomputed wo) and each column-parallel
    input's gradient; the vocab loss's max and two sums over tp."""
    got = ranks[world][_id(plan, layout, True)][0]["exchanges"]
    sizes = MeshPlan(**plan).sizes()
    fsdp, tp, sp = sizes["fsdp"], sizes["tp"], sizes["sp"]
    L, b, s = JCFG.n_layers, TOKENS.shape[0] // (sizes["dp"] * fsdp), TOKENS.shape[1] // sp
    d, v, f, hd = JCFG.d_model, JCFG.vocab, JCFG.d_ff, JCFG.d_model // JCFG.n_heads
    fused = (JCFG.n_heads + 2 * JCFG.kv_heads) // tp
    layer = (d * fused * hd + JCFG.n_heads // tp * hd * d + 3 * d * f // tp) * 4
    top = (v * d + d * v // tp) * 4  # the embedding table, the unembedding's vocab block
    if fsdp > 1:
        assert (got["gather"], got["scatter"]) == (2 + 2 * 5 * L, 2 + 5 * L)
        assert got["gather_bytes"] == top + 2 * L * layer
        assert got["scatter_bytes"] == top + L * layer
    else:
        assert got["gather"] == got["scatter"] == 0
    # row-parallel sums: 2 a layer forward, wo's again in the recompute (the
    # checkpoint stops before wo_mlp's); the column-parallel inputs'
    # gradients: 2 a layer and the unembedding's
    assert got["tp_sum"] == 2 * L + L + 2 * L + 1
    assert got["tp_sum_bytes"] == got["tp_sum"] * b * s * d * 4
    assert got["vocab"] == 2 and got["vocab_bytes"] == 3 * b * s * 4
