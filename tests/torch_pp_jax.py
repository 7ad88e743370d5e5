"""The JAX side and the shared machinery of the port's pipeline parity tests
(tests/test_torch_pp.py, test_torch_pp_sp_moe.py, test_torch_pp_shard.py):
the configurations, the meshes and their runs, the JAX package's loss and
gradients on the 8-device virtual mesh, and the comparisons. The ranks
run tests/torch_pp_cases.py (jax-free).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding

import torch_dist
import torch_threads
from odh_kubeflow_tpu.models import MoEConfig as JaxMoEConfig
from odh_kubeflow_tpu.models import TransformerConfig as JaxConfig
from odh_kubeflow_tpu.models import init_params as jax_init_params
from odh_kubeflow_tpu.models import pp_loss_fn as jax_pp_loss_fn
from odh_kubeflow_tpu.models import pp_param_specs as jax_pp_param_specs
from odh_kubeflow_tpu.models import to_pp_params as jax_to_pp_params
from odh_kubeflow_tpu.models.transformer import make_zigzag_batch as jax_make_zigzag_batch
from odh_kubeflow_tpu.models.transformer import pp_1f1b_value_and_grad as jax_pp_1f1b
from odh_kubeflow_tpu.parallel import MeshPlan as JaxMeshPlan
from odh_kubeflow_tpu.parallel import shard_batch as jax_shard_batch
from odh_kubeflow_tpu_torch.models import MoEConfig, TransformerConfig

torch_threads.cap()

ATOL = 1e-5
N_MICRO = 2
JCFG = JaxConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
                 dtype=jnp.float32, use_flash=False, remat=False)
CFGS = {
    "dense": JCFG,
    "dense4": dataclasses.replace(JCFG, n_layers=4),
    "sp": dataclasses.replace(JCFG, seq_axis="sp"),
    "zigzag": dataclasses.replace(JCFG, seq_axis="sp", seq_layout="zigzag"),
    "moe": dataclasses.replace(JCFG, moe=JaxMoEConfig(n_experts=4, experts_per_token=2)),
}
TOKENS = np.random.default_rng(1).integers(0, JCFG.vocab, (4, 16)).astype(np.int32)
# (world, mesh name, plan, config, [(run name, schedule, n_chunks)], the runs
# that also take one make_pp_train_step step)
MESHES = [
    (2, "pp2", {"pp": 2}, "dense", [("gpipe", "gpipe", 1), ("1f1b", "1f1b", 1)], ()),
    (2, "pp2 v2", {"pp": 2}, "dense4", [("gpipe", "gpipe", 2), ("1f1b", "1f1b", 2)], ()),
    (4, "pp2 x tp2", {"pp": 2, "tp": 2}, "dense", [("gpipe", "gpipe", 1), ("1f1b", "1f1b", 1)],
     ("gpipe", "1f1b")),
    (4, "pp2 x dp2", {"dp": 2, "pp": 2}, "dense", [("gpipe", "gpipe", 1)], ()),
    (4, "pp2 x sp2", {"pp": 2, "sp": 2}, "sp", [("gpipe", "gpipe", 1)], ()),
    (4, "pp2 x sp2 zigzag", {"pp": 2, "sp": 2}, "zigzag", [("gpipe", "gpipe", 1)], ()),
    (4, "pp2 x ep2 moe", {"pp": 2, "ep": 2}, "moe", [("gpipe", "gpipe", 1), ("1f1b", "1f1b", 1)], ()),
    (8, "fsdp2 x pp2 x tp2", {"fsdp": 2, "pp": 2, "tp": 2}, "dense",
     [("gpipe", "gpipe", 1), ("1f1b", "1f1b", 1)], ("1f1b",)),
]


def cases(names):
    return [(name, run) for _, name, _, _, runs, _ in MESHES if name in names for run, _, _ in runs]


def port_cfg(jcfg, **kw):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(TransformerConfig)}
    if jcfg.moe is not None:
        fields["moe"] = MoEConfig(**{f.name: getattr(jcfg.moe, f.name) for f in dataclasses.fields(MoEConfig)})
    fields.update(dtype="float32", **kw)
    return TransformerConfig(**fields)


def batch_of(cfg_name, sp=2):
    if cfg_name != "zigzag":
        return {"tokens": TOKENS}
    return {k: np.asarray(v) for k, v in jax_make_zigzag_batch(jnp.asarray(TOKENS), sp).items()}


def paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in paths(v, prefix + (k,))]
    return [prefix]


def at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def init_all():
    """The JAX init of each configuration's params (numpy)."""
    return {name: jax.device_get(jax_init_params(jax.random.PRNGKey(0), jcfg)) for name, jcfg in CFGS.items()
            if name in ("dense", "dense4", "moe")}


def params_of(params, cfg_name):
    return params["dense" if cfg_name in ("sp", "zigzag") else cfg_name]


def spawn(params, names, extra=()):
    """The port's ranks for the meshes `names` (one spawn per world, with
    `extra` (world, case) cases added to their world's)."""
    out = {}
    for world in sorted({m[0] for m in MESHES if m[1] in names} | {w for w, _ in extra}):
        cases = [case for w, case in extra if w == world]
        for w, name, plan, cfg_name, runs, train in MESHES:
            if w != world or name not in names:
                continue
            nparams = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params_of(params, cfg_name))
            port_runs = [(run, schedule, v, N_MICRO) for run, schedule, v in runs]
            cases.append((name, "torch_pp_cases:model_case",
                          dict(params=nparams, batch=batch_of(cfg_name), plan=plan,
                               cfg=port_cfg(CFGS[cfg_name], use_flash=True),  # the flash op's plain versions
                               runs=port_runs, train_step=train)))
        out.update(torch_dist.run_ranks(world, cases))
    return out


def reference(params, name, run):
    world, _, plan, cfg_name, runs, _ = next(m for m in MESHES if m[1] == name)
    schedule, n_chunks = next((s, v) for r, s, v in runs if r == run)
    jcfg = CFGS[cfg_name]
    mesh = JaxMeshPlan(**plan).build(jax.devices()[:world])
    pp = jax_to_pp_params(params_of(params, cfg_name), plan["pp"], jcfg, mesh, n_chunks=n_chunks)
    specs = jax_pp_param_specs(jcfg, mesh, plan["pp"], n_chunks=n_chunks)
    pp = jax.tree_util.tree_map(lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), pp, specs)
    batch = jax_shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch_of(cfg_name).items()})
    if schedule == "gpipe":
        fn = jax.value_and_grad(lambda p, b: jax_pp_loss_fn(p, b, jcfg, mesh, N_MICRO, n_chunks))
    else:
        def fn(p, b):
            return jax_pp_1f1b(p, b, jcfg, mesh, N_MICRO, n_chunks)
    loss, grads = jax.jit(fn)(pp, batch)
    return float(loss), jax.device_get(grads)




def assert_matches_jax(params, ranks, name, run, atol):
    """The loss (the same bits on every rank) and gathered gradients of one
    run against the JAX reference, and the gradient blocks replicated over
    an axis bit-equal across it."""
    want_loss, want = reference(params, name, run)
    per = [r[run] for r in ranks[name]]
    assert len({r["loss"] for r in per}) == 1
    assert abs(per[0]["loss"] - want_loss) < atol, (per[0]["loss"], want_loss)
    if "pp_loss" in per[0]:
        assert all(abs(r["pp_loss"] - want_loss) < atol for r in per)
    got = per[0]["grads"]
    for path in paths(want):
        np.testing.assert_allclose(at(got, path), np.asarray(at(want, path)), atol=atol, rtol=0,
                                   err_msg=str(path))
    assert_replicas_equal(per, "grad_replicas")


def assert_replicas_equal(per, key):
    for leaf in per[0][key]:
        blocks = {}
        for r in per:
            coords, digest = r[key][leaf]
            blocks.setdefault(coords, set()).add(digest)
        assert all(len(d) == 1 for d in blocks.values()), (key, leaf, blocks)


def assert_exchanges(ranks, name):
    """Each rank's exchanges of one step, by kind (all but the ring), equal
    chip_smoke._pp_bytes' count from the shapes for its stage: the count
    the card's phase 13 gates on, held here on the CPU ranks."""
    import chip_smoke

    _, _, plan, cfg_name, runs, _ = next(m for m in MESHES if m[1] == name)
    cfg = port_cfg(CFGS[cfg_name])
    for r in ranks[name]:
        for run, schedule, v in runs:
            want = chip_smoke._pp_bytes(plan, schedule, v, TOKENS.shape, cfg, N_MICRO, r["coords"]["pp"])
            got = {k: (r[run]["exchanges"][k], r[run]["exchanges"][k + "_bytes"]) for k in want}
            assert got == want, (name, run, r["coords"], got, want)
