"""The port's checkpoint and restore (odh_kubeflow_tpu_torch.models.checkpoint)
on the CPU, against the JAX package's orbax-backed module.

- The digest: the port's `state_checksum` equals the reference's byte for
  byte for the same params, f32 and bf16, whatever order the dict was built
  in.
- The round trip, pruning, reads that create nothing, and restores that
  refuse a tree, shape or dtype other than `like`'s.
- Exact resume: the port's train step from a restored state gives the same
  loss and params, bit for bit, as the run that was never interrupted (the
  reference's tests/test_checkpoint.py flow, without the mesh).
- The hooks' acks have the reference's keys.
- Across packages: an orbax checkpoint the JAX package saved, read by a
  test-local helper through numpy into `params_from_numpy`, gives the port
  the reference's checksum, and prefill logits within 1e-4 (f32; the
  tolerance of tests/test_torch_model.py).
- Serving: `build_engine_from_env` with SERVING_CHECKPOINT serves the
  greedy tokens of `generate()` on the saved params.
- Several ranks (spawned gloo ranks, tests/torch_dist.py; f32, 2 layers,
  GQA 4/2, tests/test_torch_sp.py's config): 2 and 4 ranks driving
  `make_checkpoint_hook` at one step into one directory (ROADMAP Queue 3
  entry 4) never raise and ack one checksum, 20 times, and saving steps
  0-39 each with max_to_keep 3 leaves the newest 3; a save from sp 2
  restores onto sp 4 and onto one process; at fsdp 2 x tp 2 every rank's
  hook (its blocks) acks the checksum of the gathered state, and the
  restore hook acks it too; a one-process save restores onto fsdp 2 x tp 2;
  tests/test_checkpoint.py:36 on 8 ranks at fsdp 2 x tp 2 x sp 2 (two
  steps, save, one step; a fresh init restored with mesh= takes the same
  step with atol 0), restored onto dp 2 x fsdp 2 x tp 2 and onto one
  process with the same checksum.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import torch_dist
import torch_threads
from odh_kubeflow_tpu.models import TransformerConfig as JaxConfig
from odh_kubeflow_tpu.models import checkpoint as ref
from odh_kubeflow_tpu.models import init_params as jax_init_params
from odh_kubeflow_tpu.models import prefill as jax_prefill
from odh_kubeflow_tpu_torch.models import (
    TransformerConfig,
    adamw,
    generate,
    init_params,
    latest_step,
    logit_fingerprint,
    make_checkpoint_hook,
    make_restore_hook,
    make_train_step,
    params_from_numpy,
    prefill,
    restore_train_state,
    save_train_state,
    state_checksum,
)
from odh_kubeflow_tpu_torch.models.tree import tree_leaves, tree_map
from odh_kubeflow_tpu_torch.parallel import MeshPlan
from odh_kubeflow_tpu_torch.serving.server import build_engine_from_env

torch_threads.cap()

LOGIT_ATOL = 1e-4
ENTRY = __graft_entry__._tiny_cfg(jnp)  # the shape entry() builds
PROMPT = [1, 2, 3, 4, 5]


def port_config(jax_cfg: JaxConfig, dtype: str = "float32") -> TransformerConfig:
    fields = {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(TransformerConfig)}
    fields.update(dtype=dtype, use_flash=True)
    return TransformerConfig(**fields)


def config_json(cfg: TransformerConfig) -> str:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[cfg.dtype]
    return json.dumps(fields)


def port_params(seed: int, cfg: TransformerConfig):
    return init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")


def assert_trees_equal(a, b):
    assert len(tree_leaves(a)) == len(tree_leaves(b))
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x, y)


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_state_checksum_equals_the_reference(jdtype, tdtype):
    jcfg = dataclasses.replace(ENTRY, dtype=jdtype)
    jparams = jax.device_get(jax_init_params(jax.random.PRNGKey(0), jcfg))
    params = params_from_numpy(jparams, tdtype, device="cpu")
    assert params["embed"].dtype == tdtype
    assert state_checksum(params) == ref.state_checksum(jparams)
    assert state_checksum({"params": params}) == ref.state_checksum({"params": jparams})


def test_state_checksum_walks_sorted_keys():
    """jax.tree_util flattens dicts in sorted-key order; the port's trees
    keep insertion order, which the digest must not see. Leaves of every
    kind the port's states hold: 0-d int32 (AdamW's count), 1-d, 2-d, bf16."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    h = rng.standard_normal((2, 4)).astype(np.float32)
    jtree = {"zeta": {"w": w, "b": b}, "count": np.asarray(3, np.int32),
             "alpha": np.asarray(h, jnp.bfloat16)}
    tree = {"zeta": {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
            "count": torch.tensor(3, dtype=torch.int32),
            "alpha": torch.from_numpy(h).to(torch.bfloat16)}
    reordered = {"alpha": tree["alpha"], "count": tree["count"],
                 "zeta": {"b": tree["zeta"]["b"], "w": tree["zeta"]["w"]}}
    assert state_checksum(tree) == ref.state_checksum(jtree)
    assert state_checksum(reordered) == state_checksum(tree)
    # every byte counts: one bf16 ulp in one element moves the digest
    bumped = dict(tree, alpha=tree["alpha"].clone())
    bumped["alpha"].view(torch.int16)[0, 0] += 1
    assert state_checksum(bumped) != state_checksum(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_latest_restore_round_trip(tmp_path, dtype):
    cfg = port_config(ENTRY, dtype)
    params = port_params(0, cfg)
    step_fn, opt = make_train_step(cfg)
    state = {"params": params, "opt_state": opt.init(params)}
    d = str(tmp_path / "ckpt")
    save_train_state(d, 5, state)
    assert latest_step(d) == 5
    assert sorted(os.listdir(d)) == ["5"], "no temporary directory is left behind"
    fresh = port_params(42, cfg)
    restored = restore_train_state(d, {"params": fresh, "opt_state": opt.init(fresh)})
    assert_trees_equal(restored, state)
    assert state_checksum(restored) == state_checksum(state)
    assert restored["opt_state"]["count"].dtype == torch.int32
    assert logit_fingerprint(restored["params"], cfg, PROMPT) == logit_fingerprint(params, cfg, PROMPT)


def test_max_to_keep_prunes(tmp_path):
    """tests/test_checkpoint.py::test_max_to_keep_prunes for the port."""
    state = {"x": torch.arange(8.0)}
    d = str(tmp_path / "ckpt")
    for s in range(5):
        save_train_state(d, s, state, max_to_keep=2)
    assert latest_step(d) == 4
    assert sorted(os.listdir(d)) == ["3", "4"]
    # restoring an evicted step fails; the latest restores
    with pytest.raises(FileNotFoundError, match="step 0"):
        restore_train_state(d, state, step=0)
    restored = restore_train_state(d, state)
    assert torch.equal(restored["x"], torch.arange(8.0))


def test_resaving_a_step_replaces_it(tmp_path):
    d = str(tmp_path / "ckpt")
    save_train_state(d, 1, {"x": torch.zeros(3)})
    save_train_state(d, 1, {"x": torch.ones(3)})
    assert sorted(os.listdir(d)) == ["1"]
    assert torch.equal(restore_train_state(d, {"x": torch.empty(3)})["x"], torch.ones(3))


def test_reads_create_nothing_and_half_steps_do_not_count(tmp_path):
    missing = tmp_path / "typo"
    assert latest_step(str(missing)) is None
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        restore_train_state(str(missing), {"x": torch.zeros(2)})
    assert not missing.exists()
    d = tmp_path / "ckpt"
    save_train_state(str(d), 2, {"x": torch.zeros(2)})
    # a save cut before its os.replace leaves a temporary sibling or a step
    # directory without its state file: neither is a finished step
    (d / ".tmp-9-123").mkdir()
    (d / "7").mkdir()
    assert latest_step(str(d)) == 2


def test_restore_refuses_another_tree_shape_or_dtype(tmp_path):
    d = str(tmp_path / "ckpt")
    save_train_state(d, 1, {"layers": {"w": torch.zeros(2, 3)}, "b": torch.zeros(3)})
    with pytest.raises(ValueError, match=r"/layers/w is \(2, 3\) torch.float32, want \(3, 2\)"):
        restore_train_state(d, {"layers": {"w": torch.zeros(3, 2)}, "b": torch.zeros(3)})
    with pytest.raises(ValueError, match="/b is .* torch.float32, want .* torch.bfloat16"):
        restore_train_state(d, {"layers": {"w": torch.zeros(2, 3)},
                                "b": torch.zeros(3, dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="want \\['b', 'extra', 'layers'\\]"):
        restore_train_state(d, {"layers": {"w": torch.zeros(2, 3)}, "b": torch.zeros(3),
                                "extra": torch.zeros(1)})
    # onto a mesh the tree is checked the same way
    with pytest.raises(ValueError, match="want \\['b'\\]"):
        restore_train_state(d, {"b": torch.zeros(3)}, mesh=MeshPlan().build("cpu"))


def test_save_refuses_a_leaf_that_is_not_a_tensor(tmp_path):
    with pytest.raises(TypeError, match="/optim/lr is a float"):
        save_train_state(str(tmp_path), 1, {"optim": {"lr": 3e-4}})


def test_a_view_saves_only_its_own_elements(tmp_path):
    base = torch.arange(1000.0)
    save_train_state(str(tmp_path), 1, {"v": base[10:14]})
    path = tmp_path / "1" / "state.pt"
    assert path.stat().st_size < 2000
    assert torch.equal(restore_train_state(str(tmp_path), {"v": torch.empty(4)})["v"], base[10:14])


def test_save_restore_resume_exact(tmp_path):
    """tests/test_checkpoint.py::test_save_restore_resume_exact without the
    mesh: two steps, save, one step; then a fresh seed-42 init restored from
    the save takes the same step, and the losses and params are bit-equal."""
    cfg = port_config(ENTRY)
    params = port_params(0, cfg)
    step_fn, opt = make_train_step(cfg)
    opt_state = opt.init(params)
    batch = {"tokens": torch.ones((4, 32), dtype=torch.long)}

    params, opt_state, _ = step_fn(params, opt_state, batch)
    params, opt_state, _ = step_fn(params, opt_state, batch)
    ckpt_dir = str(tmp_path / "ckpt")
    save_train_state(ckpt_dir, 2, {"params": params, "opt_state": opt_state})
    assert latest_step(ckpt_dir) == 2
    ref_params, _, ref_loss = step_fn(params, opt_state, batch)

    fresh = port_params(42, cfg)
    like = {"params": fresh, "opt_state": opt.init(fresh)}
    restored = restore_train_state(ckpt_dir, like)
    assert int(restored["opt_state"]["count"]) == 2
    resumed_params, _, resumed_loss = step_fn(restored["params"], restored["opt_state"], batch)
    assert resumed_loss.item() == ref_loss.item()
    assert state_checksum(resumed_params) == state_checksum(ref_params)


def test_hook_acks_have_the_reference_keys(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    rng = np.random.default_rng(0)
    arrays = {"w": rng.standard_normal((4, 3)).astype(np.float32), "b": np.zeros(3, np.float32)}
    jstate = {"params": arrays}
    state = {"params": {k: torch.from_numpy(v) for k, v in arrays.items()}}

    for root, save_hook, restore_hook, st in (
            (tmp_path / "jax", ref.make_checkpoint_hook, ref.make_restore_hook, jstate),
            (tmp_path / "port", make_checkpoint_hook, make_restore_hook, state)):
        empty = restore_hook(str(root), lambda st=st: st)()
        assert empty == {"restored": False, "reason": f"no checkpoint under {str(root)!r}"}
        assert not root.exists()
    port_save = make_checkpoint_hook(str(tmp_path / "port"), lambda: (7, state))()
    jax_save = ref.make_checkpoint_hook(str(tmp_path / "jax"), lambda: (7, jstate))()
    assert port_save == jax_save == {"step": 7, "checksum": ref.state_checksum(jstate)}
    port_restore = make_restore_hook(str(tmp_path / "port"), lambda: state)()
    jax_restore = ref.make_restore_hook(str(tmp_path / "jax"), lambda: jstate)()
    assert port_restore == jax_restore == {"restored": True, "step": 7,
                                           "checksum": port_save["checksum"]}


def orbax_params_to_port(directory: str, jax_like, dtype: torch.dtype):
    """The offline converter: the JAX package restores its orbax checkpoint,
    and the params go through numpy into the port."""
    restored = ref.restore_train_state(directory, {"params": jax_like})
    return params_from_numpy(jax.device_get(restored["params"]), dtype, device="cpu")


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_orbax_checkpoint_of_the_jax_package_loads_into_the_port(tmp_path, jdtype, tdtype):
    pytest.importorskip("orbax.checkpoint")
    jcfg = dataclasses.replace(ENTRY, dtype=jdtype)
    jparams = jax_init_params(jax.random.PRNGKey(3), jcfg)
    jax_dir = str(tmp_path / "orbax")
    ref.save_train_state(jax_dir, 11, {"params": jparams})
    params = orbax_params_to_port(jax_dir, jax_init_params(jax.random.PRNGKey(0), jcfg), tdtype)
    assert state_checksum({"params": params}) == ref.state_checksum({"params": jparams})
    # the converted weights, saved by the port, restore to the same digest
    port_dir = str(tmp_path / "port")
    save_train_state(port_dir, 11, {"params": params})
    cfg = port_config(ENTRY, "float32" if tdtype == torch.float32 else "bfloat16")
    restored = restore_train_state(port_dir, {"params": port_params(0, cfg)})
    assert state_checksum(restored) == ref.state_checksum({"params": jparams})
    if tdtype == torch.float32:
        tokens = np.asarray([PROMPT], np.int32)
        jlogits, _ = jax_prefill(jparams, jnp.asarray(tokens), jcfg, len(PROMPT))
        logits, _ = prefill(restored["params"], torch.from_numpy(tokens).long(), cfg, len(PROMPT))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0)


def test_serving_checkpoint_serves_the_saved_params(tmp_path):
    cfg = port_config(ENTRY)
    params = port_params(7, cfg)
    d = str(tmp_path / "endpoint")
    save_train_state(d, 1, {"params": params})
    engine = build_engine_from_env(
        {"SERVING_CHECKPOINT": d, "SERVING_MODEL_CONFIG": config_json(cfg),
         "SERVING_MAX_SEQ": "64", "SERVING_MAX_SLOTS": "2"}, device="cpu")
    assert engine.cfg == cfg
    assert state_checksum(engine.params) == state_checksum(params)
    assert logit_fingerprint(engine.params, cfg, PROMPT) == logit_fingerprint(params, cfg, PROMPT)
    prompts = [[1, 2, 3], [7, 8, 9, 10], [11, 12]]
    handles = [engine.submit(p, max_new=6) for p in prompts]
    assert engine.run_until_idle(timeout=120)
    for h, p in zip(handles, prompts):
        assert h.result == "ok"
        assert h.tokens == generate(params, [p], cfg, 6, device="cpu")[0].tolist()


# the multi-rank cases: tests/test_torch_sp.py's config
RANKS_JCFG = JaxConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
                       dtype=jnp.float32, use_flash=False, remat=False)
RANKS_TOKENS = np.random.default_rng(1).integers(0, RANKS_JCFG.vocab, (4, 32)).astype(np.int32)
TRIALS, STEPS = 20, 40


def ranks_cfg(sp=False):
    return dataclasses.replace(port_config(RANKS_JCFG), remat=True, remat_policy="flash",
                               seq_axis="sp" if sp else "")


def _train_state(params):
    return {"params": params, "opt_state": adamw().init(params)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Three spawns (2, 4 and 8 ranks) over one root directory: a save of
    one spawn is restored in the next."""
    root = tmp_path_factory.mktemp("ranks")
    nparams = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), jax.device_get(jax_init_params(jax.random.PRNGKey(0), RANKS_JCFG)))
    # a one-process save, restored onto fsdp 2 x tp 2
    save_train_state(str(root / "whole"), 4, _train_state(params_from_numpy(nparams, "float32", device="cpu")))
    common = dict(params=nparams)
    out = {2: torch_dist.run_ranks(2, [
        ("hooks", "torch_shard_cases:concurrent_hooks_case",
         dict(directory=str(root / "hooks2"), trials=TRIALS, steps=STEPS)),
        ("sp save", "torch_shard_cases:replicated_save_case",
         dict(directory=str(root / "sp"), cfg=ranks_cfg(True), plan={"sp": 2}, **common))])}
    out[4] = torch_dist.run_ranks(4, [
        ("hooks", "torch_shard_cases:concurrent_hooks_case",
         dict(directory=str(root / "hooks4"), trials=TRIALS, steps=STEPS)),
        ("sp restore", "torch_shard_cases:replicated_restore_case",
         dict(directory=str(root / "sp"), cfg=ranks_cfg(True), plan={"sp": 4}, **common)),
        ("sharded hooks", "torch_shard_cases:sharded_hooks_case",
         dict(directory=str(root / "sharded"), batch={"tokens": RANKS_TOKENS}, cfg=ranks_cfg(),
              plan={"fsdp": 2, "tp": 2}, **common)),
        ("whole restore", "torch_shard_cases:restore_case",
         dict(directory=str(root / "whole"), cfg=ranks_cfg(), plan={"fsdp": 2, "tp": 2}, **common))])
    out[8] = torch_dist.run_ranks(8, [
        ("resume", "torch_shard_cases:resume_case",
         dict(directory=str(root / "resume"), batch={"tokens": RANKS_TOKENS}, cfg=ranks_cfg(True),
              plan={"fsdp": 2, "tp": 2, "sp": 2}, other_plan={"dp": 2, "fsdp": 2, "tp": 2}, **common))])
    return root, nparams, out


@pytest.mark.parametrize("world", [2, 4])
def test_concurrent_hooks_at_one_step_end_in_one_save(ranks, world):
    """ROADMAP Queue 3 entry 4: every rank's hook at the same step into one
    directory (each rank holds the one replicated state) acks, none
    raises, all acks are equal and the step reads back; ranks saving
    steps 0..39 (max_to_keep 3) without a barrier leave the newest 3."""
    per = ranks[2][world]["hooks"]
    want = per[0]["want"]
    for r in per:
        assert r["acks"] == [{"step": 7, "checksum": want}] * TRIALS
        assert r["restored"] == [want] * TRIALS
        assert r["listing"] == [str(s) for s in range(STEPS - 3, STEPS)]


def test_sp2_save_restores_onto_sp4_and_one_process(ranks):
    root, nparams, out = ranks
    params = params_from_numpy(nparams, "float32", device="cpu")
    want = state_checksum(_train_state(params))
    assert [r["ack"] for r in out[2]["sp save"]] == [{"step": 3, "checksum": want}] * 2
    assert all(r["checksum"] == want for r in out[2]["sp save"])
    # the replicated state restores whole onto every rank of another mesh
    assert [r["checksum"] for r in out[4]["sp restore"]] == [want] * 4
    assert all(r["device"] == "cpu" for r in out[4]["sp restore"])
    fresh = port_params(5, ranks_cfg())
    restored = restore_train_state(str(root / "sp"), _train_state(fresh))
    assert state_checksum(restored) == want
    # the same leaves, walked in one key order
    assert_trees_equal(restored["params"], tree_map(lambda _, t: t, restored["params"], params))


def test_sharded_hooks_ack_the_global_checksum(ranks):
    """fsdp 2 x tp 2: every rank's hook saves its blocks; all acks carry the
    checksum of the gathered global state (what one process holding it
    would ack); the restore hooks onto a fresh init ack it too; the
    restored blocks are the saved ones; one process restores the global
    state with that checksum."""
    root, _, out = ranks
    per = out[4]["sharded hooks"]
    want = per[0]["global"]
    assert [r["ack"] for r in per] == [{"step": 1, "checksum": want}] * 4
    assert [r["restored_ack"] for r in per] == [{"restored": True, "step": 1, "checksum": want}] * 4
    assert all(r["same_blocks"] for r in per)
    like = _train_state(port_params(9, ranks_cfg()))
    assert state_checksum(restore_train_state(str(root / "sharded"), like)) == want
    # a one-process save restores onto the sharded mesh
    whole = _train_state(params_from_numpy(ranks[1], "float32", device="cpu"))
    assert [r["checksum"] for r in out[4]["whole restore"]] == [state_checksum(whole)] * 4


def test_sharded_save_restore_resume_exact(ranks):
    """tests/test_checkpoint.py::test_save_restore_resume_exact on 8 ranks at
    fsdp 2 x tp 2 x sp 2: the step from the restored state gives the
    uninterrupted run's loss, bit for bit, on every rank; the save restores
    onto dp 2 x fsdp 2 x tp 2 and onto one process with its checksum."""
    root, _, out = ranks
    per = out[8]["resume"]
    assert all(r["resumed_loss"] == r["ref_loss"] for r in per)
    assert len({r["ref_loss"] for r in per}) == 1
    assert all(r["count"] == 2 for r in per)
    checksum = per[0]["checksum"]
    assert all(r["checksum"] == checksum and r["other"] == checksum for r in per)
    like = _train_state(port_params(9, ranks_cfg()))
    assert state_checksum(restore_train_state(str(root / "resume"), like)) == checksum
