"""The port's CUDA kernels on the card (marker `cuda`): each kernel against
its plain PyTorch version at the port's head dims, bf16 and f32, causal and
not, GQA and ragged lengths; the differentiable attention, the f32-output
matmul's backward and one train step on the card. They skip with a reason
where there is no Hopper card. This file imports no jax, so it runs on a
CUDA image without it:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""
import numpy as np
import pytest
import torch

import torch_threads
from odh_kubeflow_tpu_torch.device import hopper_present
from odh_kubeflow_tpu_torch.models import TransformerConfig, init_params, make_train_step
from odh_kubeflow_tpu_torch.models.transformer import _matmul_f32
from odh_kubeflow_tpu_torch.ops import attention, flash_attention, flash_attention_plain
from odh_kubeflow_tpu_torch.ops.attention import (
    flash_bwd_dkv,
    flash_bwd_dkv_plain,
    flash_bwd_dq,
    flash_bwd_dq_plain,
)

torch_threads.cap()

# bf16 out is compared in bf16 (one ulp at |out| ~ 1 is 4e-3); f32 differs
# from the plain version in summation order only
TOLERANCE = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# gradients: relative to the plain result's max |grad|; bf16 about two bf16
# ulps at the largest gradient, f32 summation order only
BWD_TOLERANCE = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
SHAPES = [
    (1, 128, 128, 8, 8, 128),   # one full-width prefill
    (2, 200, 200, 8, 2, 64),    # GQA, ragged tail
    (1, 37, 37, 4, 2, 16),      # the demo model's head dim
    (1, 90, 150, 4, 4, 32),     # sq != sk
]
SHAPE_IDS = ["prefill", "gqa-ragged", "d16", "sq-ne-sk"]


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
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
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


def _assert_grads_close(got, want, dtype, what):
    for name, g, w in zip(what, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        bound = BWD_TOLERANCE[dtype] * w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= bound, f"{name}: max abs err {err:.3e} > {bound:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_flash_bwd_kernels_match_plain_on_card(card, shape, causal, dtype):
    b, sq, sk, h, hk, d = shape
    q, k, v = _qkv(b, sq, sk, h, hk, d, dtype, card)
    dout = torch.randn(q.shape, device=card).to(dtype)
    out, lse = flash_attention(q, k, v, causal=causal, with_lse=True)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    before = dict(attention.launch_counts)
    dq = flash_bwd_dq(q, k, v, dout, lse, delta, causal)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, causal)
    assert attention.launch_counts["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert attention.launch_counts["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    want = (flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal),
            *flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal))
    torch.cuda.synchronize()
    _assert_grads_close((dq, dk, dv), want, dtype, ("dq", "dk", "dv"))


@pytest.mark.cuda
def test_flash_attention_autograd_on_card(card):
    """Autograd through the op on the card, with an lse cotangent and the
    non-contiguous dO a transpose hands over, against the plain versions."""
    q, k, v = (t.requires_grad_() for t in _qkv(2, 192, 192, 8, 2, 64, torch.float32, card))
    g_out = torch.randn(2, 8, 192, 64, device=card).transpose(1, 2)  # strided
    g_lse = torch.randn(2, 8, 192, device=card)
    out, lse = flash_attention(q, k, v, causal=True, with_lse=True)
    got = torch.autograd.grad((out, lse), (q, k, v), (g_out, g_lse))
    delta = (g_out * out.detach()).sum(-1).transpose(1, 2) - g_lse
    args = (q.detach(), k.detach(), v.detach(), g_out.contiguous(), lse.detach(), delta.contiguous(), True)
    want = (flash_bwd_dq_plain(*args), *flash_bwd_dkv_plain(*args))
    _assert_grads_close(got, want, torch.float32, ("dq", "dk", "dv"))


@pytest.mark.cuda
def test_matmul_f32_backward_on_card(card):
    """torch.mm(out_dtype=f32) has no derivative of its own; the Function
    gives it the CPU branch's backward."""
    x = torch.randn(4, 16, 256, dtype=torch.bfloat16)
    w = torch.randn(256, 512, dtype=torch.bfloat16)
    gy = torch.randn(4, 16, 512)
    results = []
    for dev in ("cpu", card):
        xd, wd = x.to(dev).requires_grad_(), w.to(dev).requires_grad_()
        y = _matmul_f32(xd, wd)
        results.append([y, *torch.autograd.grad(y, (xd, wd), gy.to(dev))])
    for name, c, g in zip(("y", "dx", "dw"), *results):
        assert g.dtype == c.dtype, name
        torch.testing.assert_close(g.cpu().float(), c.float(), atol=1e-2, rtol=1e-2, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["flash", ""])
def test_train_step_launches_the_kernels(card, policy):
    cfg = TransformerConfig(vocab=512, d_model=256, n_layers=2, n_heads=2, d_ff=512,
                            max_seq=256, dtype=torch.bfloat16, remat=True, remat_policy=policy)
    params = init_params(torch.Generator().manual_seed(0), cfg, device=card)
    step, opt = make_train_step(cfg)
    state = opt.init(params)
    tokens = torch.randint(0, cfg.vocab, (2, 256), device=card)
    losses = []
    for _ in range(3):
        attention.reset_launch_counts()
        params, state, loss = step(params, state, {"tokens": tokens})
        losses.append(loss)
    losses = torch.stack(losses).tolist()
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    fwd = cfg.n_layers * (1 if policy == "flash" else 2)
    assert attention.launch_counts == {"flash_fwd": fwd, "flash_bwd_dq": cfg.n_layers,
                                       "flash_bwd_dkv": cfg.n_layers}
    assert not any(t.requires_grad for t in params["layers"].values())
