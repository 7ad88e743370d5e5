"""The port's ring attention (odh_kubeflow_tpu_torch/ops/ring_attention.py)
against the JAX package's on the CPU.

The same numpy-made q, k, v go through the JAX ring under jax.shard_map on
the conftest's virtual mesh (its reference path, as the JAX package's own
tests run it off the TPU) and through the port's ring on spawned gloo
ranks (tests/torch_dist.py), sp 2 and 4, GQA 4/2 and 4/1: the reference
path and the kernel path (on the CPU the kernel path composes the flash
op's plain versions through the same code the card runs). Outputs and
q/k/v gradients of sum(out**2) agree within 1e-5 of max(largest, 1) in
f32, as in tests/test_ops.py. The zigzag ring is held against the JAX
mha_reference output and gradients permuted by zigzag_permutation, as
tests/test_ops.py's zigzag test does (the JAX zigzag ring's shard_map
compiles take minutes on the CPU).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
import torch_threads
from odh_kubeflow_tpu.ops import mha_reference as jax_mha_reference
from odh_kubeflow_tpu.ops import ring_attention as jax_ring_attention
from odh_kubeflow_tpu.ops.ring_attention import _merge as jax_merge
from odh_kubeflow_tpu.ops.ring_attention import ring_balance_report as jax_ring_balance_report
from odh_kubeflow_tpu.ops.ring_attention import zigzag_permutation as jax_zigzag_permutation
from odh_kubeflow_tpu.parallel import MeshPlan as JaxMeshPlan
from odh_kubeflow_tpu.parallel.mesh import logical_to_spec as jax_logical_to_spec
from odh_kubeflow_tpu_torch.ops.ring_attention import (
    _merge,
    flash_block_with_lse,
    ring_attention,
    ring_attention_zigzag,
    ring_balance_report,
    ring_launches,
    ring_schedule,
    zigzag_permutation,
)
from odh_kubeflow_tpu_torch.parallel import MeshPlan

torch_threads.cap()

TOL = 1e-5
B, S, H, D = 2, 64, 4, 16
KV_HEADS = (2, 1)
# (layout, causal) x kv_heads x kernel path, at each world
CASES = [(layout, causal, kv, kernel) for layout, causal in (("contiguous", True), ("contiguous", False),
                                                             ("zigzag", True))
         for kv in KV_HEADS for kernel in (False, True)]


def _case_id(world, layout, causal, kv, kernel):
    return f"sp{world}-{layout}-{'causal' if causal else 'full'}-gqa4_{kv}-{'kernel' if kernel else 'ref'}"


def _qkv(kv):
    rng = np.random.default_rng(kv)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, kv, D)).astype(np.float32),
            rng.standard_normal((B, S, kv, D)).astype(np.float32))


@pytest.fixture(scope="module")
def port_rings():
    """{(world, layout, causal, kv, kernel): per-rank results}: one spawn per world."""
    out = {}
    for world in (2, 4):
        cases = []
        for layout, causal, kv, kernel in CASES:
            q, k, v = _qkv(kv)
            if layout == "zigzag":
                perm = zigzag_permutation(S, world)
                q, k, v = q[:, perm], k[:, perm], v[:, perm]
            cases.append((_case_id(world, layout, causal, kv, kernel), "torch_sp_cases:ring_case",
                          dict(q=q, k=k, v=v, layout=layout, causal=causal, use_kernel=kernel)))
        res = torch_dist.run_ranks(world, cases)
        for layout, causal, kv, kernel in CASES:
            out[(world, layout, causal, kv, kernel)] = res[_case_id(world, layout, causal, kv, kernel)]
    return out


def _jax_ring(world, causal, kv):
    """The JAX ring (reference path) under shard_map: out and q/k/v grads."""
    q, k, v = (jnp.asarray(x) for x in _qkv(kv))
    mesh = JaxMeshPlan(sp=world).build(jax.devices()[:world])
    q_spec = jax_logical_to_spec(("batch", "seq", "heads", "head_dim"), mesh)
    kv_spec = jax_logical_to_spec(("batch", "seq", "kv_heads", "head_dim"), mesh)
    fn = jax.shard_map(partial(jax_ring_attention, axis_name="sp", causal=causal), mesh=mesh,
                       in_specs=(q_spec, kv_spec, kv_spec), out_specs=q_spec, check_vma=False)
    out = jax.jit(fn)(q, k, v)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(x) for x in (out, *grads)]


def _jax_zigzag(world, kv):
    """JAX mha_reference's out and grads, permuted into zigzag order."""
    q, k, v = (jnp.asarray(x) for x in _qkv(kv))
    perm = jax_zigzag_permutation(S, world)
    out = jax_mha_reference(q, k, v, causal=True)
    grads = jax.grad(lambda *a: jnp.sum(jax_mha_reference(*a, causal=True) ** 2), argnums=(0, 1, 2))(q, k, v)
    return [np.asarray(x)[:, perm] for x in (out, *grads)]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("layout,causal,kv", [(lay, c, kv) for lay, c in (("contiguous", True),
                                                                        ("contiguous", False),
                                                                        ("zigzag", True))
                                            for kv in KV_HEADS])
def test_ring_matches_jax(port_rings, world, layout, causal, kv):
    want = _jax_zigzag(world, kv) if layout == "zigzag" else _jax_ring(world, causal, kv)
    for kernel in (False, True):
        ranks = port_rings[(world, layout, causal, kv, kernel)]
        for name, w in zip(("out", "dq", "dk", "dv"), want):
            got = np.concatenate([r[name] for r in ranks], axis=1)
            scale = max(float(np.abs(w).max()), 1.0)
            err = float(np.abs(got - w).max()) / scale
            assert err < TOL, (name, "kernel" if kernel else "reference", err)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_kernel_path_launches_follow_the_schedule(port_rings, world, layout):
    """Each rank's flash forward, dq and dk/dv calls per ring are the
    causal schedule's blocks: r + 1 contiguous, 2*sp + 1 zigzag; a full
    (non-causal) ring visits every shard; the reference path calls none."""
    for kv in KV_HEADS:
        want = ring_launches(world, layout)
        ranks = port_rings[(world, layout, True, kv, True)]
        assert [r["launches"] for r in ranks] == [{"fwd": n, "dq": n, "dkv": n} for n in want]
        ref = port_rings[(world, layout, True, kv, False)]
        assert all(r["launches"] == {"fwd": 0, "dq": 0, "dkv": 0} for r in ref)
        if layout == "contiguous":
            full = port_rings[(world, layout, False, kv, True)]
            assert all(r["launches"] == {"fwd": world, "dq": world, "dkv": world} for r in full)


@pytest.mark.parametrize("sp", list(range(1, 9)))
@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_ring_balance_report_matches_reference(sp, layout):
    assert ring_balance_report(sp, layout) == jax_ring_balance_report(sp, layout)
    units = {"contiguous": {"full": 4.0, "diag": 2.0}, "zigzag": {"full": 1.0, "diag": 0.5}}[layout]
    report = ring_balance_report(sp, layout)
    for rank, row in enumerate(ring_schedule(sp, layout)):
        assert [sum(units[k] for k in kinds) for kinds in row] == report["per_rank_units_per_step"][rank]


def test_ring_balance_report_refuses_unknown_layout():
    with pytest.raises(ValueError, match="unknown layout"):
        ring_balance_report(2, "striped")
    with pytest.raises(ValueError, match="unknown layout"):
        jax_ring_balance_report(2, "striped")


@pytest.mark.parametrize("seq_len,sp", [(8, 1), (16, 2), (64, 4), (96, 3), (128, 8)])
def test_zigzag_permutation_matches_reference(seq_len, sp):
    np.testing.assert_array_equal(zigzag_permutation(seq_len, sp), jax_zigzag_permutation(seq_len, sp))
    with pytest.raises(ValueError, match="not divisible"):
        zigzag_permutation(seq_len + 1, sp)


def test_flash_block_with_lse_merge_grads():
    """Two flash blocks merged by log-sum-exp equal attention over the
    concatenated K/V, values and q/k/v gradients (the lse cotangent folded
    into delta), against JAX's mha_reference; the merge equals JAX's."""
    rng = np.random.default_rng(5)
    b, s, h, d = 1, 64, 2, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, 2 * s, h, d)).astype(np.float32)
    v = rng.standard_normal((b, 2 * s, h, d)).astype(np.float32)

    def loss_ref(q_, k_, v_):
        out = jax_mha_reference(q_, k_, v_, causal=False).astype(jnp.float32)
        return jnp.sum(out ** 2), out

    (_, want_out), want = jax.value_and_grad(loss_ref, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o1, l1 = flash_block_with_lse(tq, tk[:, :s], tv[:, :s], False)
    o2, l2 = flash_block_with_lse(tq, tk[:, s:], tv[:, s:], False)
    out, lse = _merge(o1.float(), l1, o2.float(), l2)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=TOL, rtol=0)
    for name, t, w in zip("qkv", (tq, tk, tv), want):
        scale = max(float(np.abs(np.asarray(w)).max()), 1.0)
        assert float(np.abs(t.grad.numpy() - np.asarray(w)).max()) / scale < TOL, name
    # the merge itself against the reference's, in its (b, sq, h) lse layout
    j_out, j_lse = jax_merge(jnp.asarray(o1.detach().numpy()), jnp.asarray(l1.detach().numpy().transpose(0, 2, 1)),
                             jnp.asarray(o2.detach().numpy()), jnp.asarray(l2.detach().numpy().transpose(0, 2, 1)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), atol=1e-6, rtol=0)
    np.testing.assert_allclose(lse.detach().numpy().transpose(0, 2, 1), np.asarray(j_lse), atol=1e-6, rtol=0)


@pytest.mark.parametrize("kernel", [False, True])
def test_one_rank_ring_is_plain_attention(kernel):
    """A ring of one rank (a mesh without a live sp axis) is attention
    over the local sequence; zigzag's two chunks are then its whole."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2))
    mesh = MeshPlan().build("cpu")
    want = jax_mha_reference(*(jnp.asarray(x.numpy()) for x in (q, k, v)), causal=True)
    for fn in (partial(ring_attention, causal=True), ring_attention_zigzag):
        got = fn(q, k, v, mesh, use_kernel=kernel)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_kernel_path_refuses_what_its_kernels_refuse():
    """The kernel path raises on a shape the flash kernels refuse (here
    head_dim 8), on any device; it never drops to the reference path."""
    mesh = MeshPlan().build("cpu")
    q, k, v = torch.zeros(1, 8, 2, 8), torch.zeros(1, 8, 2, 8), torch.zeros(1, 8, 2, 8)
    with pytest.raises(ValueError, match="head_dim 8"):
        ring_attention(q, k, v, mesh, use_kernel=True)
    with pytest.raises(ValueError, match="head_dim 8"):
        ring_attention_zigzag(q, k, v, mesh, use_kernel=True)
    assert ring_attention(q, k, v, mesh, use_kernel=False).shape == q.shape
    with pytest.raises(ValueError, match="odd"):
        ring_attention_zigzag(torch.zeros(1, 7, 2, 16), torch.zeros(1, 7, 2, 16), torch.zeros(1, 7, 2, 16), mesh)
    with pytest.raises(ValueError, match="one length"):
        ring_attention(torch.zeros(1, 8, 2, 16), torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 2, 16), mesh)
