"""The port's CUDA kernels on the card (marker `cuda`): each kernel against
its plain PyTorch version at the port's head dims, bf16 and f32, causal and
not, GQA and ragged lengths; the tensor-core forward and backward kernels at
their tile edges (the forward with both q-tile widths), and their refusal of
views TMA cannot read; the differentiable attention, the f32-output matmul's
backward and one train step on the card. They skip with a reason
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
    counter = attention._fwd_kernel_for(dtype, d)
    before = attention.launch_counts[counter]
    out, lse = flash_attention(q, k, v, causal=causal, with_lse=True)
    assert attention.launch_counts[counter] == before + 1
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


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("s", [63, 64, 65, 127, 129, 2049])
def test_tensor_core_kernel_at_tile_edges_on_card(card, s, d, causal):
    """bf16 at d 128/64 (the tensor-core kernel) at the edges of its 64-row
    warpgroup tiles and 128-row K/V tiles, with and without lse, once with
    128-row q tiles (a batch whose grid covers every SM, GQA 16/4, strided
    fused-qkv views) and once with 64-row q tiles (one sequence, GQA 8/1)."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    wide_b = -(-sms // (-(-s // 128) * 16))
    for b, h, hk, strided in ((wide_b, 16, 4, True), (1, 4, 1, False)):
        want_tile = 128 if strided else 64
        assert attention.fwd_launch_plan(torch.bfloat16, b, s, h, d) == ("flash_fwd", want_tile)
        if strided:
            qkv = torch.randn(b, s, h + 2 * hk, d, device=card, dtype=torch.bfloat16)
            q, k, v = qkv.split([h, hk, hk], dim=2)
        else:
            q, k, v = _qkv(b, s, s, h, hk, d, torch.bfloat16, card)
        before = attention.launch_counts["flash_fwd"]
        out = flash_attention(q, k, v, causal=causal)
        out_lse, lse = flash_attention(q, k, v, causal=causal, with_lse=True)
        assert attention.launch_counts["flash_fwd"] == before + 2
        ref_out, ref_lse = flash_attention_plain(q, k, v, causal=causal, with_lse=True)
        torch.cuda.synchronize()
        for got in (out, out_lse):
            torch.testing.assert_close(got.float(), ref_out.float(), atol=2e-2, rtol=0)
        torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 64])
def test_tensor_core_kernel_sq_ne_sk_full_on_card(card, d):
    q, k, v = _qkv(3, 300, 700, 16, 4, d, torch.bfloat16, card)
    out, lse = flash_attention(q, k, v, causal=False, with_lse=True)
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal=False, with_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref_out.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_tensor_core_kernel_rejects_views_tma_cannot_read(card):
    """A misaligned base or a stride TMA cannot take raises ValueError: no
    copy, and no launch of the scalar kernel instead."""
    flat = torch.randn(64 * 8 * 128 + 1, device=card, dtype=torch.bfloat16)
    shifted = flat[1:].view(1, 64, 8, 128)
    odd = torch.randn(1, 64, 8, 129, device=card, dtype=torch.bfloat16)[..., :128]
    ok = torch.randn(1, 64, 8, 128, device=card, dtype=torch.bfloat16)
    before = dict(attention.launch_counts)
    for bad in (shifted, odd):
        with pytest.raises(ValueError, match="TMA"):
            flash_attention(bad, ok, ok, causal=True)
        with pytest.raises(ValueError, match="TMA"):
            flash_attention(ok, bad, ok, causal=True)
    assert attention.launch_counts == before


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
    _check_bwd_on_card(q, k, v, dout, lse, delta, causal)


def _check_bwd_on_card(q, k, v, dout, lse, delta, causal):
    """Both backward kernels against their plain versions, each launched once
    and counted under the name `_bwd_kernel_for` gives."""
    names = attention._bwd_kernel_for(q.dtype, q.shape[3])
    before = dict(attention.launch_counts)
    dq = flash_bwd_dq(q, k, v, dout, lse, delta, causal)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, causal)
    launched = {n: c - before[n] for n, c in attention.launch_counts.items() if c != before[n]}
    assert launched == {names[0]: 1, names[1]: 1}
    want = (flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal),
            *flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal))
    torch.cuda.synchronize()
    _assert_grads_close((dq, dk, dv), want, q.dtype, ("dq", "dk", "dv"))


def _bwd_inputs(q, k, v, causal, dout=None):
    dout = torch.randn(q.shape, device=q.device).to(q.dtype) if dout is None else dout
    out, lse = flash_attention(q, k, v, causal=causal, with_lse=True)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return dout, lse, delta


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("s", [63, 64, 65, 127, 129, 2049])
def test_tensor_core_bwd_kernels_at_tile_edges_on_card(card, s, d, causal):
    """bf16 at d 128/64 (the tensor-core dq and dk/dv kernels) at the edges
    of their 64-row warpgroup and streamed tiles and 128-row blocks: GQA 16/4
    on strided fused-qkv views, and GQA 4/1 on contiguous tensors."""
    for b, h, hk, strided in ((2, 16, 4, True), (1, 4, 1, False)):
        assert attention._bwd_kernel_for(torch.bfloat16, d) == ("flash_bwd_dq", "flash_bwd_dkv")
        if strided:
            qkv = torch.randn(b, s, h + 2 * hk, d, device=card, dtype=torch.bfloat16)
            q, k, v = qkv.split([h, hk, hk], dim=2)
        else:
            q, k, v = _qkv(b, s, s, h, hk, d, torch.bfloat16, card)
        _check_bwd_on_card(q, k, v, *_bwd_inputs(q, k, v, causal), causal)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 64])
def test_tensor_core_bwd_kernels_sq_ne_sk_full_on_card(card, d):
    for sq, sk in ((300, 700), (129, 63)):
        q, k, v = _qkv(2, sq, sk, 8, 2, d, torch.bfloat16, card)
        _check_bwd_on_card(q, k, v, *_bwd_inputs(q, k, v, False), False)


@pytest.mark.cuda
def test_tensor_core_bwd_kernels_read_any_dout(card):
    """dO as autograd may hand it over: a transpose (read in place), and an
    expanded gradient with stride 0 (copied first); both give the gradients
    of the same values made contiguous."""
    q, k, v = _qkv(2, 130, 130, 8, 2, 128, torch.bfloat16, card)
    for dout in (torch.randn(2, 8, 130, 128, device=card).to(torch.bfloat16).transpose(1, 2),
                 torch.randn(1, 1, 8, 128, device=card).to(torch.bfloat16).expand(2, 130, 8, 128)):
        dout, lse, delta = _bwd_inputs(q, k, v, True, dout)
        got = (flash_bwd_dq(q, k, v, dout, lse, delta, True),
               *flash_bwd_dkv(q, k, v, dout, lse, delta, True))
        want = (flash_bwd_dq(q, k, v, dout.contiguous(), lse, delta, True),
                *flash_bwd_dkv(q, k, v, dout.contiguous(), lse, delta, True))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_tensor_core_bwd_kernels_reject_views_tma_cannot_read(card):
    """A q, k or v view TMA cannot read raises ValueError: no copy, and no
    launch of the scalar kernels instead."""
    flat = torch.randn(64 * 8 * 128 + 1, device=card, dtype=torch.bfloat16)
    shifted = flat[1:].view(1, 64, 8, 128)
    ok = torch.randn(1, 64, 8, 128, device=card, dtype=torch.bfloat16)
    stats = torch.zeros(1, 8, 64, device=card)
    before = dict(attention.launch_counts)
    for args in ((shifted, ok, ok), (ok, shifted, ok), (ok, ok, shifted)):
        with pytest.raises(ValueError, match="TMA"):
            flash_bwd_dq(*args, ok, stats, stats)
        with pytest.raises(ValueError, match="TMA"):
            flash_bwd_dkv(*args, ok, stats, stats)
    assert attention.launch_counts == before


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
    assert attention.launch_counts == {"flash_fwd": fwd, "flash_fwd_scalar": 0,
                                       "flash_bwd_dq": cfg.n_layers, "flash_bwd_dkv": cfg.n_layers,
                                       "flash_bwd_dq_scalar": 0, "flash_bwd_dkv_scalar": 0}
    assert not any(t.requires_grad for t in params["layers"].values())
