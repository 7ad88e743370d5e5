"""The port's ops (odh_kubeflow_tpu_torch.ops) against the JAX package's.

Inputs are made from a seed with numpy and handed to both. The flash
kernel's plain version is held against the JAX Pallas kernel run in
interpret mode (out and lse) and against both packages' mha_reference.
Tolerances are f32: the two sides differ only in summation order (the
interpret kernel and mha_reference agree to <= 6e-7 on these shapes).
tests/test_torch_cuda.py holds the Hopper kernel itself against the plain
version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu.ops import apply_rope as jax_apply_rope
from odh_kubeflow_tpu.ops import rms_norm as jax_rms_norm
from odh_kubeflow_tpu.ops.attention import _flash_forward_kernel
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

ATOL = 1e-5
# (b, s, h, hk, d): MHA and GQA (h=8, hk=2)
ATTN_SHAPES = [(2, 256, 4, 4, 64), (1, 256, 8, 2, 32)]


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
    flash_attention(*_t(*_qkv(9, 1, 16, 2, 2, 16)), device="cpu")
    assert attention.launch_counts == {"flash_fwd": 0}
