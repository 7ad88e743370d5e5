"""The port's sequence-parallel training path against the JAX package on
the CPU: `loss_fn` and the gradients of `value_and_grad` over a mesh (sp 2
and 4, contiguous and zigzag, and dp 2 x sp 2), each rank on its shard of
the batch on spawned gloo ranks (tests/torch_dist.py), equal the JAX
`loss_fn` and `jax.grad` on the full unsharded batch, with the JAX init
converted into the port (the reference proves its own sharded loss equal to
that in tests/test_model.py:355). f32, 2 layers, GQA 4/2, remat_policy
"flash"; tolerances 1e-5 absolute, as tests/test_torch_train.py's (the
per-rank sums add in another order).

The contiguous layout's labels cross shard boundaries (the last position
of shard r is labelled with the first token of shard r+1, which each rank
receives over the sp ring); the zigzag batch comes from make_zigzag_batch.
Both the ring's reference path and its kernel path (the flash op's plain
versions on the CPU) run through the model, and one make_train_step step
leaves the params bit-equal across ranks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
import torch_threads
from odh_kubeflow_tpu.models import TransformerConfig as JaxConfig
from odh_kubeflow_tpu.models import init_params as jax_init_params
from odh_kubeflow_tpu.models import loss_fn as jax_loss_fn
from odh_kubeflow_tpu.models.transformer import make_zigzag_batch as jax_make_zigzag_batch
from odh_kubeflow_tpu_torch.models import TransformerConfig, make_zigzag_batch
from odh_kubeflow_tpu_torch.ops.ring_attention import ring_launches

torch_threads.cap()

ATOL = 1e-5
JCFG = JaxConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
                 dtype=jnp.float32, use_flash=False, remat=False)
TOKENS = np.random.default_rng(1).integers(0, JCFG.vocab, (2, 32)).astype(np.int32)
# (world, plan, layout) of the whole-slice cases
MESHES = [(2, {"sp": 2}, "contiguous"), (2, {"sp": 2}, "zigzag"), (4, {"sp": 4}, "contiguous"),
          (4, {"sp": 4}, "zigzag"), (4, {"dp": 2, "sp": 2}, "contiguous"), (4, {"dp": 2, "sp": 2}, "zigzag")]


def _id(world, plan, layout, kernel):
    return "-".join(f"{k}{v}" for k, v in plan.items()) + f"-{layout}-{'kernel' if kernel else 'ref'}"


def port_cfg(layout):
    fields = {f.name: getattr(JCFG, f.name) for f in dataclasses.fields(TransformerConfig)}
    fields.update(dtype="float32", use_flash=True, remat=True, remat_policy="flash", seq_axis="sp",
                  seq_layout=layout)
    return TransformerConfig(**fields)


def _sp_of(plan):
    return plan.get("sp", 1)


@pytest.fixture(scope="module")
def reference():
    """The JAX init (numpy) and the JAX loss and gradients on the full batch."""
    params = jax.device_get(jax_init_params(jax.random.PRNGKey(0), JCFG))
    loss, grads = jax.value_and_grad(jax_loss_fn)(params, {"tokens": jnp.asarray(TOKENS)}, JCFG)
    return params, float(loss), grads


def _leaves(tree):
    """The tree's leaves in the port's tree_leaves order (dicts in insertion
    order: the JAX init's and the converter's)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


@pytest.fixture(scope="module")
def ranks(reference):
    params = reference[0]
    nparams = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)
    out = {}
    for world in (2, 4):
        cases = []
        for w, plan, layout in MESHES:
            if w != world:
                continue
            batch = ({"tokens": TOKENS} if layout == "contiguous"
                     else {k: v.numpy() for k, v in make_zigzag_batch(TOKENS, _sp_of(plan)).items()})
            for kernel in (False, True):
                cases.append((_id(world, plan, layout, kernel), "torch_sp_cases:model_case",
                              dict(params=nparams, batch=batch, cfg=port_cfg(layout),
                                   plan=plan, use_kernel=kernel, train_step=kernel)))
        cases.append(("targets", "torch_sp_cases:targets_case", dict(tokens=TOKENS)))
        out[world] = torch_dist.run_ranks(world, cases)
    return out


@pytest.mark.parametrize("world,plan,layout", MESHES, ids=[_id(*m, True)[:-7] for m in MESHES])
@pytest.mark.parametrize("kernel", [False, True], ids=["ref", "kernel"])
def test_sp_loss_and_grads_match_jax_full_batch(reference, ranks, world, plan, layout, kernel):
    params, want_loss, want_grads = reference
    per = ranks[world][_id(world, plan, layout, kernel)]
    # every rank returns the global loss, the same bits
    assert len({r["loss"] for r in per}) == 1
    assert abs(per[0]["loss"] - want_loss) < ATOL
    # the summed gradients: every rank the same bits, equal to jax.grad's
    assert len({r["grads_digest"] for r in per}) == 1
    got = per[0]["grads"]
    want = _leaves(jax.device_get(want_grads))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("world,plan,layout", MESHES, ids=[_id(*m, True)[:-7] for m in MESHES])
def test_sp_launches_and_one_step(ranks, world, plan, layout):
    """The kernel path's flash calls per rank are n_layers times the ring
    schedule's (the ring is outside the layer checkpoint, so remat "flash"
    runs it once); one make_train_step step leaves the params bit-equal
    across ranks, and its loss is the value_and_grad loss."""
    per = ranks[world][_id(world, plan, layout, True)]
    sched = ring_launches(_sp_of(plan), layout)
    sp_index = [r % _sp_of(plan) for r in range(world)]  # sp is the innermost axis
    n = JCFG.n_layers
    assert [r["launches"] for r in per] == [{"fwd": n * sched[i], "dq": n * sched[i], "dkv": n * sched[i]}
                                            for i in sp_index]
    assert len({r["params_digest"] for r in per}) == 1
    assert all(r["step_loss"] == r["loss"] for r in per)
    ref = ranks[world][_id(world, plan, layout, False)]
    assert all(r["launches"] == {"fwd": 0, "dq": 0, "dkv": 0} for r in ref)


@pytest.mark.parametrize("world", [2, 4])
def test_contiguous_labels_cross_shard_boundaries(ranks, world):
    """Each rank's next-token labels and mask, put back in order, are the
    reference's global roll and mask: a shard's last label is the next
    shard's first token, and only the sequence's last position is masked."""
    per = ranks[world]["targets"]
    targets = np.concatenate([r["targets"] for r in per], axis=1)
    mask = np.concatenate([r["mask"] for r in per], axis=1)
    np.testing.assert_array_equal(targets, np.roll(TOKENS, -1, axis=1))
    want_mask = np.ones(TOKENS.shape, np.float32)
    want_mask[:, -1] = 0
    np.testing.assert_array_equal(mask, want_mask)
    s = TOKENS.shape[1] // world
    for r in range(world - 1):  # the boundary labels come from the next shard
        np.testing.assert_array_equal(per[r]["targets"][:, -1], TOKENS[:, (r + 1) * s])


@pytest.mark.parametrize("sp", [1, 2, 4])
def test_make_zigzag_batch_matches_jax(sp):
    want = jax_make_zigzag_batch(jnp.asarray(TOKENS), sp)
    got = make_zigzag_batch(TOKENS, sp)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    # torch tensors in, the same batch out
    again = make_zigzag_batch(torch.from_numpy(TOKENS), sp)
    assert all(torch.equal(again[n], got[n]) for n in got)
