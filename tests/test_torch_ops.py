"""The port's ops (odh_kubeflow_tpu_torch.ops) against the JAX package's.

Inputs are made from a seed with numpy and handed to both. The flash
kernel's plain version is held against the JAX Pallas kernel run in
interpret mode (out and lse) and against both packages' mha_reference.
Tolerances are f32: the two sides differ only in summation order (the
interpret kernel and mha_reference agree to <= 6e-7 on these shapes).
The backward's plain versions and the gradients through the port's
differentiable `flash_attention` are held against the JAX Pallas backward
(`_flash_backward`, interpret mode) within 1e-5 absolute: a scratch run
measured at most 4.3e-6 on gradients of magnitude up to 6.
tests/test_torch_cuda.py holds the Hopper kernels themselves against the
plain versions on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads
from odh_kubeflow_tpu.ops import apply_rope as jax_apply_rope
from odh_kubeflow_tpu.ops import rms_norm as jax_rms_norm
from odh_kubeflow_tpu.ops.attention import _flash_backward, _flash_forward_kernel
from odh_kubeflow_tpu.ops.attention import flash_attention as jax_flash_attention
from odh_kubeflow_tpu.ops.attention import mha_reference as jax_mha_reference
from odh_kubeflow_tpu_torch.ops import (
    apply_rope,
    attention,
    flash_attention,
    flash_attention_plain,
    mha_reference,
    rms_norm,
)
from odh_kubeflow_tpu_torch.ops.attention import (
    flash_bwd_dkv,
    flash_bwd_dkv_plain,
    flash_bwd_dq,
    flash_bwd_dq_plain,
)

torch_threads.cap()

ATOL = 1e-5
# (b, s, h, hk, d): MHA and GQA (h=8, hk=2)
ATTN_SHAPES = [(2, 256, 4, 4, 64), (1, 256, 8, 2, 32)]
# (b, s, h, hk, d) for the backward: MHA at s 128, GQA (h=4, hk=2) at s 256
BWD_SHAPES = [(1, 128, 4, 4, 32), (1, 256, 4, 2, 64)]


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _qkv(seed, b, sq, h, hk, d, sk=None):
    sk = sq if sk is None else sk
    return (_randn(seed, b, sq, h, d), _randn(seed + 1, b, sk, hk, d),
            _randn(seed + 2, b, sk, hk, d))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_rms_norm_matches_jax():
    x, scale = _randn(0, 2, 5, 64), _randn(1, 64)
    want = np.asarray(jax_rms_norm(*_j(x, scale)))
    got = rms_norm(*_t(x, scale)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("offset", [0, 1000])
def test_apply_rope_matches_jax(offset):
    x = _randn(2, 2, 64, 4, 32)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32) + offset, (2, 64)).copy()
    want = np.asarray(jax_apply_rope(*_j(x, pos)))
    got = apply_rope(*_t(x, pos)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_apply_rope_rotates_interleaved_pairs():
    """Pair (x[0], x[1]) rotates by position * freq_0 = position: the
    interleaved convention, not the half-split one."""
    x = torch.zeros(1, 1, 1, 8)
    x[..., 0] = 1.0
    out = apply_rope(x, torch.tensor([[3]]))[0, 0, 0]
    torch.testing.assert_close(out[:2], torch.tensor([np.cos(3.0), np.sin(3.0)], dtype=torch.float32))
    assert torch.all(out[2:] == 0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_flash_attention_matches_jax_interpret_kernel(shape, causal):
    b, s, h, hk, d = shape
    q, k, v = _qkv(3, b, s, h, hk, d)
    want = np.asarray(jax_flash_attention(*_j(q, k, v), causal=causal, block_q=128,
                                          block_k=128, interpret=True))
    got = flash_attention(*_t(q, k, v), causal=causal, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jax_mha_reference(*_j(q, k, v), causal=causal)),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_flash_lse_matches_jax_interpret_kernel(shape, causal):
    b, s, h, hk, d = shape
    q, k, v = _qkv(4, b, s, h, hk, d)
    _, lse = _flash_forward_kernel(*_j(q, k, v), causal, 128, 128, True, with_lse=True)
    # (b*hk, group, sq, 128) lane-broadcast -> (b, h, sq): head j = kvh*group + g
    want = np.asarray(lse)[..., 0].reshape(b, h, s)
    out, got = flash_attention(*_t(q, k, v), causal=causal, with_lse=True, device="cpu")
    assert out.shape == (b, s, h, d)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_mha_reference_matches_jax(causal):
    q, k, v = _qkv(5, 2, 48, 8, 2, 16)
    want = np.asarray(jax_mha_reference(*_j(q, k, v), causal=causal))
    np.testing.assert_allclose(mha_reference(*_t(q, k, v), causal=causal).numpy(), want,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_ragged_and_unequal_lengths(causal):
    """Lengths no TPU block tiles, and sq != sk: the plain version (the
    kernel's semantics) against the port's reference with the same
    top-left-aligned causal mask."""
    q, k, v = _qkv(6, 2, 37, 4, 2, 16, sk=53)
    got = flash_attention_plain(*_t(q, k, v), causal=causal)
    want = mha_reference(*_t(q, k, v), causal=causal)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_flash_attention_rejects_unsupported_inputs():
    q, k, v = _t(*_qkv(7, 1, 8, 2, 2, 24))
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, k, v, device="cpu")
    q, k, v = _t(*_qkv(7, 1, 8, 2, 2, 16))
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention(q.half(), k.half(), v.half(), device="cpu")
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :1].expand(1, 8, 3, 16), v[:, :, :1].expand(1, 8, 3, 16),
                        device="cpu")


def test_flash_attention_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    q, k, v = _t(*_qkv(8, 1, 8, 2, 2, 16))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        flash_attention(q, k, v)


def test_cpu_tensors_never_launch_the_kernel():
    attention.reset_launch_counts()
    q, k, v = (t.requires_grad_() for t in _t(*_qkv(9, 1, 16, 2, 2, 16)))
    flash_attention(q, k, v, device="cpu").sum().backward()
    assert attention.launch_counts == {"flash_fwd": 0, "flash_fwd_scalar": 0, "flash_bwd_dq": 0,
                                       "flash_bwd_dkv": 0, "flash_bwd_dq_scalar": 0,
                                       "flash_bwd_dkv_scalar": 0}
    assert q.grad is not None and k.grad is not None and v.grad is not None


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 128, "flash_fwd"), (torch.bfloat16, 64, "flash_fwd"),
    (torch.bfloat16, 32, "flash_fwd_scalar"), (torch.bfloat16, 16, "flash_fwd_scalar"),
    (torch.float32, 128, "flash_fwd_scalar"), (torch.float32, 64, "flash_fwd_scalar"),
    (torch.float32, 32, "flash_fwd_scalar"), (torch.float32, 16, "flash_fwd_scalar"),
])
def test_fwd_kernel_for_names_the_kernel_by_dtype_and_head_dim(dtype, d, kernel):
    """bf16 at d 64/128 takes the tensor cores; f32 (no tensor-core f32
    product, and TF32 would break the f32 gates) and bf16 d16/32 the scalar
    kernel. The C entry odh_flash_fwd_kernel makes the same choice; the chip
    smoke holds the two against each other."""
    assert attention._fwd_kernel_for(dtype, d) == kernel
    assert kernel in attention.launch_counts


@pytest.mark.parametrize("dtype,d", [(torch.float16, 128), (torch.bfloat16, 24), (torch.float32, 256)])
def test_fwd_kernel_for_rejects_what_no_kernel_takes(dtype, d):
    with pytest.raises(ValueError, match="no forward kernel"):
        attention._fwd_kernel_for(dtype, d)


@pytest.mark.parametrize("dtype,d,tensor_cores", [
    (torch.bfloat16, 128, True), (torch.bfloat16, 64, True),
    (torch.bfloat16, 32, False), (torch.bfloat16, 16, False),
    (torch.float32, 128, False), (torch.float32, 64, False),
    (torch.float32, 32, False), (torch.float32, 16, False),
])
def test_bwd_kernel_for_names_the_kernels_by_dtype_and_head_dim(dtype, d, tensor_cores):
    """The backward pair follows the forward's rule: the tensor-core dq and
    dk/dv kernels for bf16 at d 64/128, the scalar pair otherwise. The C
    entry odh_flash_bwd_kernel makes the same choice; the chip smoke holds
    the two against each other."""
    want = ("flash_bwd_dq", "flash_bwd_dkv")
    if not tensor_cores:
        want = ("flash_bwd_dq_scalar", "flash_bwd_dkv_scalar")
    assert attention._bwd_kernel_for(dtype, d) == want
    assert all(name in attention.launch_counts for name in want)
    assert (attention._fwd_kernel_for(dtype, d) == "flash_fwd") == tensor_cores


@pytest.mark.parametrize("dtype,d", [(torch.float16, 128), (torch.bfloat16, 24), (torch.float32, 256)])
def test_bwd_kernel_for_rejects_what_no_kernel_takes(dtype, d):
    with pytest.raises(ValueError, match="no backward kernel"):
        attention._bwd_kernel_for(dtype, d)


def _fused_qkv_views(b, s, h, hk, d):
    qkv = torch.zeros(b, s, h + 2 * hk, d, dtype=torch.bfloat16)
    return qkv.split([h, hk, hk], dim=2)


def _misaligned_base(b, s, h, d):
    flat = torch.zeros(b * s * h * d + 1, dtype=torch.bfloat16)
    return flat[1:].view(b, s, h, d)  # 2 bytes past an aligned allocation


@pytest.mark.parametrize("make,problem", [
    (lambda: torch.zeros(2, 64, 8, 128, dtype=torch.bfloat16), None),
    (lambda: _fused_qkv_views(2, 64, 8, 2, 128)[0], None),
    (lambda: _fused_qkv_views(2, 64, 8, 2, 128)[1], None),
    (lambda: _fused_qkv_views(1, 33, 16, 4, 64)[2], None),
    # a dim of size 1 has no stride that matters
    (lambda: torch.zeros(1, 64, 8, 160, dtype=torch.bfloat16)[..., :128], None),
    (lambda: torch.zeros(2, 64, 8, 128, dtype=torch.bfloat16).transpose(2, 3), "last dim"),
    (lambda: _misaligned_base(1, 16, 4, 64), "16-byte aligned"),
    (lambda: torch.zeros(2, 16, 8, 65, dtype=torch.bfloat16)[..., :64], "head stride"),
    (lambda: torch.zeros(2, 16, 1, 68, dtype=torch.bfloat16)[..., :64], "seq stride"),
], ids=["contiguous", "fused-q", "fused-k", "fused-v-d64", "size1-batch", "transposed",
        "misaligned-base", "head-stride", "seq-stride"])
def test_tma_problem_names_what_tma_cannot_read(make, problem):
    """The wrapper's check of TMA's rule before the tensor-core kernel: the
    last dim contiguous, a 16-byte aligned base, batch/seq/head strides in
    multiples of 16 bytes. Every view the port hands over passes."""
    got = attention._tma_problem(make())
    if problem is None:
        assert got is None
    else:
        assert problem in got


@pytest.mark.parametrize("make,in_place", [
    (lambda: torch.zeros(2, 64, 8, 128, dtype=torch.bfloat16), True),
    # the transpose of a (b, h, s, d) gradient: strides in multiples of 16 bytes
    (lambda: torch.zeros(2, 8, 64, 128, dtype=torch.bfloat16).transpose(1, 2), True),
    (lambda: _fused_qkv_views(2, 64, 8, 2, 64)[0], True),
    # a broadcast over a dim of size 1 has no stride that matters
    (lambda: torch.zeros(1, 64, 8, 128, dtype=torch.bfloat16).expand(1, 64, 8, 128), True),
    # an expanded gradient (the backward of a sum): stride 0 everywhere
    (lambda: torch.ones((), dtype=torch.bfloat16).expand(2, 64, 8, 128), False),
    (lambda: torch.zeros(1, 64, 1, 128, dtype=torch.bfloat16).expand(2, 64, 8, 128), False),
    (lambda: torch.zeros(2, 64, 128, 8, dtype=torch.bfloat16).transpose(2, 3), False),
    (lambda: _misaligned_base(1, 16, 4, 64), False),
    (lambda: torch.zeros(2, 16, 8, 65, dtype=torch.bfloat16)[..., :64], False),
], ids=["contiguous", "transposed-heads", "fused-view", "size1-broadcast", "expanded-scalar",
        "expanded-heads", "last-dim-strided", "misaligned-base", "head-stride"])
def test_tma_readable_dout_copies_only_what_tma_cannot_read(make, in_place):
    """dO reaches the tensor-core backward kernels in place where TMA can
    read it, and as a contiguous copy of the same values otherwise."""
    dout = make()
    got = attention._tma_readable_dout(dout)
    assert (got is dout) == in_place
    assert got.shape == dout.shape and torch.equal(got, dout)
    if not in_place:
        assert got.is_contiguous() and attention._tma_problem(got) is None


@pytest.mark.parametrize("rows,groups,sms,tile", [
    (128, 8, 132, 16),    # b1 s128 h8: 16 blocks of 64 rows (32 split), 32 of 32 (64), 64 of 16
    (512, 8, 132, 64),    # the f32 gradient check: 64 blocks of 64 rows, 128 split
    (512, 16, 132, 64),
    (2048, 64, 132, 64),  # b8 s2048 h8: 2048 blocks of 64 rows
    (4, 4, 132, 16),      # the demo model's prefill (h4)
    (1, 50, 132, 64),     # one row: every tile gives the same grid; 100 split blocks reach 3/4
    (1, 49, 132, 16),     # 98 split blocks do not
    (65, 20, 132, 32),    # 40 blocks of 64 rows (80 split), 60 of 32 (120)
    (513, 4, 132, 32),    # 36 of 64 (72), 68 of 32 (136)
    (513, 4, 114, 32),    # a card of 114 SMs: 72 < 85.5 <= 136
    (129, 15, 114, 64),   # 45 of 64 (90)
])
def test_scalar_tile_fills_the_card(rows, groups, sms, tile):
    """The scalar forward's q tile and dk/dv's k tile: 64 rows, else 32,
    where that tile's grid, split over 2-block clusters, gives at least
    three quarters of the SMs a block, else 16. The C entries
    (odh_flash::scalar_tile) make the same choice; the chip smoke and the
    card tests hold the two against each other."""
    assert attention._scalar_tile(rows, groups, sms) == tile


@pytest.mark.parametrize("rows,groups,tile,inner,max_split,sms,split", [
    (128, 8, 16, 2, 4, 132, 2),    # the scalar forward at b1 s128 h8: 64 blocks, 2 key tiles
    (512, 8, 64, 16, 4, 132, 4),   # the forward at the gradient check: 64 blocks, 16 key tiles
    (512, 8, 64, 16, 2, 132, 2),   # dk/dv there: at most 2-block clusters
    (512, 8, 64, 8, 2, 132, 2),    # dq there: 8 key tiles of 64, at most 2-block clusters
    (512, 8, 64, 3, 4, 132, 2),    # 3 inner tiles give no block of a 4-block cluster two
    (2048, 64, 64, 32, 4, 132, 1),  # 2048 blocks fill the card
    (512, 8, 64, 8, 4, 114, 2),    # on 114 SMs, 128 blocks leave none idle
    (33, 4, 16, 1, 4, 132, 1),     # one inner tile: nothing to split
])
def test_scalar_split_doubles_while_sms_idle(rows, groups, tile, inner, max_split, sms, split):
    """Blocks per cluster of the scalar kernels: doubled, up to the
    kernel's largest, while the grid leaves SMs idle and the longest row
    block has two inner tiles for each block. The C rule
    (odh_flash::scalar_split) makes the same choice; the chip smoke holds
    the two against each other."""
    assert attention._scalar_split(rows, groups, tile, inner, max_split, sms) == split


@pytest.mark.parametrize("b,sq,sk,h,causal,plan", [
    (1, 512, 512, 8, True, (64, 2)),    # the f32 gradient check: 64 blocks, 128 in clusters of 2
    (1, 512, 512, 8, False, (64, 2)),
    (8, 2048, 2048, 8, True, (64, 1)),  # b8 s2048 h8: 2048 blocks
    (1, 4, 4, 4, True, (16, 1)),        # the demo model's prefill length: one key tile
    (4, 65, 65, 8, True, (64, 2)),      # 64 blocks of 64 rows, two key tiles
    (9, 65, 65, 8, True, (64, 1)),      # 144 blocks
    (1, 513, 513, 1, False, (16, 2)),   # one head: 33 blocks of 16 rows
    (1, 1024, 200, 2, True, (32, 2)),   # causal: the longest rows see min(sq, sk) keys
    (1, 1024, 50, 2, True, (32, 1)),    # one key tile
    (1, 512, 64, 8, False, (64, 1)),    # one key tile: nothing to split
])
def test_scalar_dq_plan_fills_the_card(b, sq, sk, h, causal, plan):
    """The scalar dq kernel's (q tile, cluster size) on 132 SMs: the
    forward's tile rule over batch * heads, and clusters that split the
    64-key tiles of the longest rows, up to 2 blocks. The C entries
    (odh_flash_bwd_dq_tile_q, odh_flash_bwd_dq_k_split) make the same
    choice; the chip smoke and the card tests hold the two against each
    other."""
    assert attention._scalar_dq_plan(b, sq, sk, h, causal, 132) == plan


@pytest.mark.parametrize("make,problem", [
    (lambda: torch.zeros(2, 64, 8, 16, dtype=torch.bfloat16), None),
    (lambda: torch.zeros(2, 64, 8, 128), None),
    (lambda: _fused_qkv_views(2, 64, 4, 2, 16)[1], None),
    (lambda: _misaligned_base(1, 16, 4, 64).float(), None),
    # f32 at any element offset or stride is 4-byte aligned
    (lambda: torch.zeros(64 * 8 * 32 + 1)[1:].view(1, 64, 8, 32), None),
    (lambda: torch.zeros(2, 16, 8, 33)[..., :32], None),
    (lambda: torch.zeros(2, 64, 8, 32, dtype=torch.bfloat16).transpose(2, 3), "last dim"),
    (lambda: _misaligned_base(1, 16, 4, 32), "4-byte aligned"),
    (lambda: torch.zeros(2, 16, 8, 33, dtype=torch.bfloat16)[..., :32], "head stride"),
    (lambda: torch.zeros(1, 15, 1, 33, dtype=torch.bfloat16)[..., :32], "seq stride"),
], ids=["contiguous-bf16", "contiguous-f32", "fused-k-d16", "f32-copy", "f32-odd-offset",
        "f32-odd-stride", "transposed", "bf16-odd-offset", "bf16-head-stride", "bf16-seq-stride"])
def test_cp_async_problem_names_what_the_scalar_kernels_copy(make, problem):
    """The scalar kernels read q, k, v and dO in place by cp.async of 4 (or
    16) bytes: the last dim contiguous, base and batch/seq/head strides in
    multiples of 4 bytes. `_inner_contiguous` copies exactly the views that
    fail, into tensors that pass."""
    t = make()
    got = attention._cp_async_problem(t)
    if problem is None:
        assert got is None
    else:
        assert problem in got
    (copied,) = attention._inner_contiguous(t)
    assert (copied is t) == (problem is None)
    assert torch.equal(copied, t) and attention._cp_async_problem(copied) is None


def test_kernel_strides_give_size_one_dims_a_contiguous_stride():
    t = torch.zeros(1, 64, 8, 160, dtype=torch.bfloat16)[..., :128]
    assert tuple(attention._strides(t)) == (64 * 8 * 128, 8 * 160, 160)
    q = _fused_qkv_views(2, 64, 8, 2, 128)[0]
    assert tuple(attention._strides(q)) == q.stride()[:3]


def _jax_backward(q, k, v, do, causal, g_lse=None):
    """The Pallas forward (with lse) and backward in interpret mode; lse
    and g_lse in the kernel layout (b*hk, group, sq[, 128])."""
    out, lse = _flash_forward_kernel(*_j(q, k, v), causal, 128, 128, True, with_lse=True)
    grads = _flash_backward(*_j(q, k, v), out, lse, jnp.asarray(do), causal, 128, 128, True,
                            g_lse=None if g_lse is None else jnp.asarray(g_lse))
    return np.array(out), np.array(lse)[..., 0], [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_flash_bwd_plain_matches_jax_interpret_kernels(shape, causal):
    b, s, h, hk, d = shape
    q, k, v = _qkv(10, b, s, h, hk, d)
    do = _randn(13, b, s, h, d)
    out, lse, want = _jax_backward(q, k, v, do, causal)
    tq, tk, tv, tdo = _t(q, k, v, do)
    lse = torch.from_numpy(lse.reshape(b, h, s).copy())
    # delta = rowsum(dO * out), (b, h, sq)
    delta = (tdo * torch.from_numpy(out)).sum(-1).transpose(1, 2).contiguous()
    dq = flash_bwd_dq_plain(tq, tk, tv, tdo, lse, delta, causal)
    dk, dv = flash_bwd_dkv_plain(tq, tk, tv, tdo, lse, delta, causal)
    for name, got, ref in zip("qkv", (dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0, err_msg=f"d{name}")
    # the wrappers take the plain versions on CPU tensors
    torch.testing.assert_close(flash_bwd_dq(tq, tk, tv, tdo, lse, delta, causal), dq, atol=0, rtol=0)
    torch.testing.assert_close(flash_bwd_dkv(tq, tk, tv, tdo, lse, delta, causal), (dk, dv),
                               atol=0, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_grads_match_jax_interpret(causal):
    """Autograd through the port's op (forward with lse, then delta and the
    two backward functions) against jax.grad of the interpret-mode kernel
    path (_flash_diff), GQA h=4 hk=2."""
    b, s, h, hk, d = 2, 128, 4, 2, 32
    q, k, v = _qkv(14, b, s, h, hk, d)
    do = _randn(17, b, s, h, d)

    def jloss(q, k, v):
        out = jax_flash_attention(q, k, v, causal=causal, block_q=128, block_k=128, interpret=True)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*_j(q, k, v))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, device="cpu")
    got = torch.autograd.grad((out * torch.from_numpy(do)).sum(), (tq, tk, tv))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0, err_msg=f"d{name}")


def test_flash_attention_lse_cotangent_matches_jax():
    """A loss that reads lse: its cotangent enters as delta - g_lse, as in
    _flash_backward(g_lse=)."""
    b, s, h, hk, d = 1, 128, 4, 2, 32
    q, k, v = _qkv(18, b, s, h, hk, d)
    do = _randn(21, b, s, h, d)
    g_lse = _randn(22, b, h, s) * 0.3  # head j = kvh * group + g: (b*hk, group, sq) is a reshape
    _, _, want = _jax_backward(q, k, v, do, True, g_lse=g_lse.reshape(b * hk, h // hk, s))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out, lse = flash_attention(tq, tk, tv, causal=True, with_lse=True, device="cpu")
    loss = (out * torch.from_numpy(do)).sum() + (lse * torch.from_numpy(g_lse)).sum()
    got = torch.autograd.grad(loss, (tq, tk, tv))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0, err_msg=f"d{name}")


def test_inference_forward_runs_the_no_lse_variant(monkeypatch):
    """Serving (inference mode, or no tensor requiring grad) runs the
    forward without lse; a training forward runs it with lse."""
    seen = []
    plain = attention.flash_attention_plain

    def recording(*args, with_lse=False, **kwargs):
        seen.append(with_lse)
        return plain(*args, with_lse=with_lse, **kwargs)

    monkeypatch.setattr(attention, "flash_attention_plain", recording)
    q, k, v = _t(*_qkv(23, 1, 16, 2, 2, 16))
    with torch.inference_mode():
        flash_attention(q, k, v, device="cpu")
    with torch.no_grad():
        flash_attention(q.requires_grad_(), k, v, device="cpu")
    flash_attention(q, k, v, device="cpu")
    assert seen == [False, False, True]


def test_flash_bwd_rejects_bad_statistics():
    q, k, v = _t(*_qkv(24, 1, 8, 2, 2, 16))
    good = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="lse"):
        flash_bwd_dq(q, k, v, q, torch.zeros(1, 8, 2), good)
    with pytest.raises(ValueError, match="delta"):
        flash_bwd_dkv(q, k, v, q, good, good.double())
    with pytest.raises(ValueError, match="dO"):
        flash_bwd_dq(q, k, v, q[:, :4], good, good)
