"""The port's CUDA kernels on the card (marker `cuda`): each kernel against
its plain PyTorch version at the port's head dims, bf16 and f32, causal and
not, GQA and ragged lengths. They skip with a reason where there is no
Hopper card. This file imports no jax, so it runs on a CUDA image without it:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""
import numpy as np
import pytest
import torch

from odh_kubeflow_tpu_torch.device import hopper_present
from odh_kubeflow_tpu_torch.ops import attention, flash_attention, flash_attention_plain

# bf16 out is compared in bf16 (one ulp at |out| ~ 1 is 4e-3); f32 differs
# from the plain version in summation order only
TOLERANCE = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def card():
    if not hopper_present("cuda"):
        pytest.skip("needs a Hopper card (compute capability 9.0) with CUDA")
    return torch.device("cuda")


def _qkv(b, sq, sk, h, hk, d, dtype, device):
    rng = np.random.default_rng(b * 1000 + sq + h + d)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device, dtype)
            for s in ((b, sq, h, d), (b, sk, hk, d), (b, sk, hk, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", [
    (1, 128, 128, 8, 8, 128),   # one full-width prefill
    (2, 200, 200, 8, 2, 64),    # GQA, ragged tail
    (1, 37, 37, 4, 2, 16),      # the demo model's head dim
    (1, 90, 150, 4, 4, 32),     # sq != sk
], ids=["prefill", "gqa-ragged", "d16", "sq-ne-sk"])
def test_flash_kernel_matches_plain_on_card(card, shape, causal, dtype):
    b, sq, sk, h, hk, d = shape
    q, k, v = _qkv(b, sq, sk, h, hk, d, dtype, card)
    before = attention.launch_counts["flash_fwd"]
    out, lse = flash_attention(q, k, v, causal=causal, with_lse=True)
    assert attention.launch_counts["flash_fwd"] == before + 1
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal=causal, with_lse=True)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == ref_out.shape
    torch.testing.assert_close(out.float(), ref_out.float(), atol=TOLERANCE[dtype], rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views(card):
    """q/k/v as the model hands them over: views into one fused qkv tensor,
    read in place through their strides."""
    qkv = torch.randn(2, 64, 8 + 2 * 4, 128, device=card, dtype=torch.bfloat16)
    q, k, v = qkv.split([8, 4, 4], dim=2)
    out = flash_attention(q, k, v, causal=True)
    ref = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
