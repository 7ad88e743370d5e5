"""The port's pipeline engines (parallel/pipeline.py,
parallel/interleaved_1f1b.py) against the JAX package on the CPU.

- `build_schedule`'s tables equal the reference's field by field for every
  (S, v, m) of tests/test_parallel.py:479, `validate_schedule` passes, a
  corrupted table (a dropped op, an early backward) is flagged, and
  `build_schedule(4, 2, 6)` raises.
- `stack_stages` equals the reference's, both layouts.
- The tanh stacks of tests/test_parallel.py:85 (8 layers over 4 stages)
  and :119 (4 layers over 2 stages) through the port's pipeline on gloo
  ranks, GPipe, 1F1B and their interleaved forms (v 2): the output, the
  gradients of sum(y**2) by the weights (each stage's block) and by x,
  against the reference's pipeline_apply and jax.grad; f32, 1e-5 absolute.
- The stage hops' counter: the "pp" exchanges and bytes of each rank and
  the broadcast's equal the count from the shapes; 1F1B, whose adjacent
  ranks send to each other in the same step (one an activation, the other
  a cotangent), completes within the spawn's wait (RUN_TIMEOUT_S), and no
  rank holds more than 2(S-1)+1 stage inputs.
- The reference's raises: a batch n_micro does not divide, the
  interleaved schedule's n_micro % S, sp with n_chunks > 1.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
import torch_threads
from odh_kubeflow_tpu.parallel import MeshPlan as JaxMeshPlan
from odh_kubeflow_tpu.parallel import pipeline_apply as jax_pipeline_apply
from odh_kubeflow_tpu.parallel import stack_stages as jax_stack_stages
from odh_kubeflow_tpu.parallel.interleaved_1f1b import build_schedule as jax_build_schedule
from odh_kubeflow_tpu_torch.parallel import MeshPlan, pipeline_apply, stack_stages
from odh_kubeflow_tpu_torch.parallel.interleaved_1f1b import build_schedule, validate_schedule

torch_threads.cap()

ATOL = 1e-5
SCHEDULES = [(2, 2, 4), (4, 2, 8), (2, 4, 8), (4, 4, 16), (8, 2, 16)]
# (name, stages, layers, d, batch, n_micro, n_chunks, the reference's mesh)
STACKS = [("test_parallel.py:85", 4, 8, 16, 8, 4, 1, dict(pp=4, tp=2)),
          ("test_parallel.py:85 v2", 4, 8, 16, 8, 4, 2, dict(pp=4, tp=2)),
          ("test_parallel.py:119", 2, 4, 8, 4, 2, 1, dict(pp=2, tp=4)),
          ("test_parallel.py:119 v2", 2, 4, 8, 4, 2, 2, dict(pp=2, tp=4))]


@pytest.mark.parametrize("S,v,m", SCHEDULES)
def test_schedule_tables_equal_the_reference(S, v, m):
    got, want = build_schedule(S, v, m), jax_build_schedule(S, v, m)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    validate_schedule(got)


@pytest.mark.parametrize("corrupt", ["drop", "early"])
def test_validate_schedule_flags_a_corrupted_table(corrupt):
    sched = build_schedule(2, 2, 4)
    if corrupt == "drop":
        t = next(t for t in range(sched.T) if sched.f_on[t][1])
        sched.f_on[t][1] = 0
        match = "missing forward ops|dep"
    else:
        # the last backward op of rank 0 moved to the first step
        t = max(t for t in range(sched.T) if sched.b_on[t][0])
        for name in ("b_on", "b_mb", "b_chunk"):
            table = getattr(sched, name)
            table[0][0], table[t][0] = table[t][0], table[0][0]
        match = "before its own F|dep violated"
    with pytest.raises(AssertionError, match=match):
        validate_schedule(sched)


def test_build_schedule_needs_n_micro_divisible_by_stages():
    with pytest.raises(ValueError, match="divisible"):
        build_schedule(4, 2, 6)


@pytest.mark.parametrize("n_chunks", [1, 2])
def test_stack_stages_equals_the_reference(n_chunks):
    w = np.random.default_rng(0).standard_normal((8, 3, 5)).astype(np.float32)
    got = stack_stages({"w": torch.as_tensor(w)}, 2, n_chunks)["w"].numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_stack_stages({"w": jnp.asarray(w)}, 2, n_chunks)["w"]))
    with pytest.raises(ValueError, match="not divisible"):
        stack_stages({"w": torch.zeros(6, 2)}, 4, n_chunks)


def _stack(layers, d, batch):
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (layers, d, d)) * 0.1, np.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (batch, d)), np.float32)
    return w, x


def _jax_stage(stage_w, h):
    def body(carry, wi):
        return jnp.tanh(carry @ wi), None

    h, _ = jax.lax.scan(body, h, stage_w)
    return h


@pytest.fixture(scope="module")
def tanh_runs():
    """The port's ranks for every stack (one spawn per stage count), and
    the reference's output and gradients."""
    out = {}
    for world in (2, 4):
        cases = []
        for name, S, L, d, b, m, v, _ in STACKS:
            if S == world:
                w, x = _stack(L, d, b)
                cases.append((name, "torch_pp_cases:tanh_case", dict(w=w, x=x, n_micro=m, n_chunks=v)))
        out.update(torch_dist.run_ranks(world, cases))
    return out


def _reference(name):
    _, S, L, d, b, m, v, plan = next(s for s in STACKS if s[0] == name)
    w, x = _stack(L, d, b)
    mesh = JaxMeshPlan(**plan).build(jax.devices()[:8])

    def y_of(w, x):
        return jax_pipeline_apply(_jax_stage, jax_stack_stages(w, S, v), x, mesh, n_micro=m, n_chunks=v)

    y = jax.jit(y_of)(w, x)
    gw, gx = jax.jit(jax.grad(lambda w, x: jnp.sum(y_of(w, x) ** 2), argnums=(0, 1)))(w, x)
    return np.asarray(y), np.asarray(jax_stack_stages(gw, S, v)), np.asarray(gx), float(jnp.sum(y ** 2))


@pytest.mark.parametrize("name", [s[0] for s in STACKS])
def test_tanh_pipeline_matches_the_reference(tanh_runs, name):
    y, gw, gx, loss = _reference(name)
    per = tanh_runs[name]
    for r, run in enumerate(per):
        np.testing.assert_allclose(run["y"], y, atol=ATOL, rtol=0, err_msg=f"rank {r} output")
        for schedule in ("gpipe", "1f1b"):
            np.testing.assert_allclose(run[schedule]["grad"], gw[r], atol=ATOL, rtol=0,
                                       err_msg=f"{schedule} rank {r} stage gradient")
        assert abs(run["gpipe"]["loss"] - loss) < ATOL * max(1.0, abs(loss))
        assert abs(run["1f1b"]["loss"] - loss) < ATOL * max(1.0, abs(loss))
    for schedule in ("gpipe", "1f1b"):
        np.testing.assert_allclose(per[0][schedule]["dx"], gx, atol=ATOL, rtol=0, err_msg=schedule)
        assert all(run[schedule]["dx"] is None for run in per[1:])


@pytest.mark.parametrize("name", [s[0] for s in STACKS])
def test_stage_hops_count_from_the_shapes(tanh_runs, name):
    """Each rank's hops and bytes by kind, from the shapes: a stage sends
    every visit's output on except the last virtual stage's (m of them),
    and every visit's input cotangent back except the first's; the
    broadcast moves the whole output once per rank."""
    _, S, L, d, b, m, v, _ = next(s for s in STACKS if s[0] == name)
    payload = b // m * d * 4
    for r, run in enumerate(tanh_runs[name]):
        fwd = m * v - (m if r == S - 1 else 0)
        bwd = m * v - (m if r == 0 else 0)
        ex = run["exchanges"]
        assert (ex["pp"], ex["pp_bytes"]) == (fwd, fwd * payload), (r, ex)
        assert (ex["pp_bcast"], ex["pp_bcast_bytes"]) == (1, b * d * 4)
        ex = run["gpipe"]["exchanges"]
        assert (ex["pp"], ex["pp_bytes"]) == (fwd + bwd, (fwd + bwd) * payload), (r, ex)
        assert (ex["pp_bcast"], ex["pp_bcast_bytes"]) == (1, b * d * 4)
        ex = run["1f1b"]["exchanges"]
        assert (ex["pp"], ex["pp_bytes"]) == (fwd + bwd, (fwd + bwd) * payload), (r, ex)
        assert ex["pp_bcast"] == 0 and ex["ring"] == 0
        if v == 1:
            assert run["1f1b"]["most"] <= 2 * (S - 1) + 1


def test_pipeline_raises_as_the_reference():
    mesh = types.SimpleNamespace(sizes=MeshPlan(pp=2, sp=2).sizes())
    params = {"w": torch.zeros(1, 2, 4, 4)}
    with pytest.raises(ValueError, match="not divisible by n_micro"):
        pipeline_apply(lambda p, h: (h, 0.0), params, torch.zeros(3, 4), mesh, n_micro=2)
    with pytest.raises(ValueError, match="divisible by the stage count"):
        pipeline_apply(lambda p, h: (h, 0.0), params, torch.zeros(6, 4), mesh, n_micro=3, n_chunks=2)
    with pytest.raises(NotImplementedError, match="GPipe schedule only"):
        pipeline_apply(lambda p, h: (h, 0.0), params, torch.zeros(4, 4), mesh, n_micro=2, n_chunks=2,
                       seq_axis="sp")
