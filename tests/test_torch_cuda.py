"""The port's CUDA kernels on the card (marker `cuda`): each kernel against
its plain PyTorch version at the port's head dims, bf16 and f32, causal and
not, GQA and ragged lengths; the tensor-core forward and backward kernels at
their tile edges (the forward with both q-tile widths), and their refusal of
views TMA cannot read; the scalar kernels at the edges of each of their
16-, 32- and 64-row tiles, and the scalar dq kernel at each of its cluster
sizes; the differentiable attention, the f32-output matmul's
backward (plain and per expert), one train step on the card, and the MoE
layer and train step on the card (against the CPU, and bit-equal when
repeated); two engines with check_syncs on threads of one process, and
generate() under the armed guard; the sharded step's flash calls at its
per-rank shapes, parallel.comm's collectives on CUDA tensors over gloo
against their CPU results, and the fsdp 2 x tp 2 step against one process;
tp generate at tp 2, the tp 4 step with n_kv_heads 2, and the ep 2 x tp 2
MoE layer and step, against one process on the card; torchrun's LOCAL_RANK
picking the card.
They skip with a reason
where there is no Hopper card. This file imports no jax, so it runs on a
CUDA image without it:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""
import numpy as np
import pytest
import torch

import torch_threads
from odh_kubeflow_tpu_torch.device import hopper_present
from odh_kubeflow_tpu_torch.models import MoEConfig, TransformerConfig, init_params, make_train_step, moe_ffn
from odh_kubeflow_tpu_torch.models.tree import tree_leaves, tree_map
from odh_kubeflow_tpu_torch.ops import attention, flash_attention, flash_attention_plain, matmul_f32
from odh_kubeflow_tpu_torch.ops.attention import (
    flash_bwd_dkv,
    flash_bwd_dkv_plain,
    flash_bwd_dq,
    flash_bwd_dq_plain,
    mha_reference,
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
# the scalar kernels' tile edges: sq = sk at each length, at every row tile
# the grid can give (a 32-row tile adds no block over 64 rows at s <= 32, so
# the rule never takes it there), f32 at every head dim and bf16 at 16/32
SCALAR_EDGES = [(s, t) for s in (1, 15, 16, 17, 31, 33, 65, 129, 513) for t in (64, 32, 16)
                if not (t == 32 and s <= 32)]
# no batch gives the forward 16-row tiles at s 513 with 4 or more heads
FWD_SCALAR_EDGES = [e for e in SCALAR_EDGES if e != (513, 16)]
SCALAR_TYPES = [(torch.float32, 16), (torch.float32, 32), (torch.float32, 64), (torch.float32, 128),
                (torch.bfloat16, 16), (torch.bfloat16, 32)]
SCALAR_TYPE_IDS = ["f32-d16", "f32-d32", "f32-d64", "f32-d128", "bf16-d16", "bf16-d32"]


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


def _scalar_edge_inputs(card, s, tile, dtype, d, heads_for_tile):
    """(b, h, hk, q, k, v) for a scalar tile-edge case: GQA 8/2 on strided
    fused-qkv views for the 64- and 16-row tiles, GQA 4/1 contiguous for the
    32-row one, the batch the smallest whose grid gives `tile` rows per
    block (the grid counts `heads_for_tile(h, hk)` heads)."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    h, hk = (4, 1) if tile == 32 else (8, 2)
    heads = heads_for_tile(h, hk)
    b = next(b for b in range(1, 2 * sms + 1) if attention._scalar_tile(s, b * heads, sms) == tile)
    if tile == 32:
        return (b, h, hk, *_qkv(b, s, s, h, hk, d, dtype, card))
    qkv = torch.randn(b, s, h + 2 * hk, d, device=card).to(dtype)
    return (b, h, hk, *qkv.split([h, hk, hk], dim=2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", SCALAR_TYPES, ids=SCALAR_TYPE_IDS)
@pytest.mark.parametrize("s,tile", FWD_SCALAR_EDGES, ids=[f"s{s}-q{t}" for s, t in FWD_SCALAR_EDGES])
def test_scalar_kernel_at_tile_edges_on_card(card, s, tile, dtype, d):
    """The scalar forward (f32, bf16 d16/d32) at the edges of its 16-, 32-
    and 64-row q tiles and 64-key tiles, causal and full, with lse; the
    launch plan reports the tile the grid gives."""
    b, h, hk, q, k, v = _scalar_edge_inputs(card, s, tile, dtype, d, lambda h, hk: h)
    assert attention.fwd_launch_plan(dtype, b, s, h, d) == ("flash_fwd_scalar", tile)
    for causal in (True, False):
        before = attention.launch_counts["flash_fwd_scalar"]
        out, lse = flash_attention(q, k, v, causal=causal, with_lse=True)
        assert attention.launch_counts["flash_fwd_scalar"] == before + 1
        ref_out, ref_lse = flash_attention_plain(q, k, v, causal=causal, with_lse=True)
        torch.cuda.synchronize()
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


def _assert_grads_close(got, want, dtype, what, joint=False):
    """Each gradient within BWD_TOLERANCE of its own largest plain value, or
    with `joint` of the largest plain value of all of them (for a gradient
    that is 0 in exact arithmetic, which holds only rounding noise)."""
    largest = max(w.float().abs().max().item() for w in want)
    for name, g, w in zip(what, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        bound = BWD_TOLERANCE[dtype] * (largest if joint else w.float().abs().max().item())
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


def _check_bwd_on_card(q, k, v, dout, lse, delta, causal, joint=False):
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
    _assert_grads_close((dq, dk, dv), want, q.dtype, ("dq", "dk", "dv"), joint)


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
@pytest.mark.parametrize("dtype,d", SCALAR_TYPES, ids=SCALAR_TYPE_IDS)
@pytest.mark.parametrize("s,tile", SCALAR_EDGES, ids=[f"s{s}-k{t}" for s, t in SCALAR_EDGES])
def test_scalar_bwd_kernels_at_tile_edges_on_card(card, s, tile, dtype, d):
    """The scalar dq and dk/dv kernels (f32, bf16 d16/d32) at the edges of
    dk/dv's 16-, 32- and 64-row k tiles and streamed q tiles, then at the
    edges of dq's q tiles of the same rows and its 64-key tiles (the batch
    chosen for each), causal and full; the launch plans report the tiles the
    grid gives and dq's cluster size as the Python mirror does. At s = 1
    (one key: p = 1, dp = delta) dq and dk are 0 in exact arithmetic, so
    they are held against the largest plain gradient."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    # no batch gives dq 16-row tiles at s 513 with 4 or more heads
    for by_kv in (True, False) if (s, tile) in FWD_SCALAR_EDGES else (True,):
        b, h, hk, q, k, v = _scalar_edge_inputs(card, s, tile, dtype, d,
                                                lambda h, hk: hk if by_kv else h)
        if by_kv:
            assert attention.bwd_dkv_launch_plan(dtype, b, s, hk, d) == ("flash_bwd_dkv_scalar", tile)
        else:
            assert attention.bwd_dq_launch_plan(dtype, b, s, h, d) == ("flash_bwd_dq_scalar", tile)
        assert attention.bwd_dq_launch_plan(dtype, b, s, h, d)[1] == attention._scalar_tile(s, b * h, sms)
        for causal in (True, False):
            split = attention.scalar_splits(dtype, d, b, s, s, h, hk, causal)[2]
            assert split == attention._scalar_dq_plan(b, s, s, h, causal, sms)[1]
            _check_bwd_on_card(q, k, v, *_bwd_inputs(q, k, v, causal), causal, joint=s == 1)


DQ_PLANS = [(t, 2 ** i) for t in (64, 32, 16) for i in range(attention._DQ_MAX_SPLIT.bit_length())]


@pytest.mark.cuda
@pytest.mark.parametrize("tile,split", DQ_PLANS, ids=[f"q{t}-x{ks}" for t, ks in DQ_PLANS])
def test_scalar_dq_kernel_cluster_sizes_on_card(card, tile, split):
    """The scalar dq kernel at each (q tile, cluster size) its rule gives: f32
    at the first length of the tile edges (then 1024), heads 8/2 on strided
    fused-qkv views, 4/1, 2/1 or 1/1, and batch that the Python mirror plans
    so, causal and full; the C entries plan the same."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for causal in (True, False):
        found = next(((s, h, hk, b) for s in (1, 15, 16, 17, 31, 33, 65, 129, 513, 1024)
                      for h, hk in ((8, 2), (4, 1), (2, 1), (1, 1)) for b in range(1, 2 * sms + 1)
                      if attention._scalar_dq_plan(b, s, s, h, causal, sms) == (tile, split)), None)
        assert found is not None, f"no shape gives dq ({tile}, {split}) on {sms} SMs"
        s, h, hk, b = found
        d = 128 if tile == 64 else 64
        assert attention.bwd_dq_launch_plan(torch.float32, b, s, h, d) == ("flash_bwd_dq_scalar", tile)
        assert attention.scalar_splits(torch.float32, d, b, s, s, h, hk, causal)[2] == split
        qkv = torch.randn(b, s, h + 2 * hk, d, device=card)
        q, k, v = qkv.split([h, hk, hk], dim=2)
        _check_bwd_on_card(q, k, v, *_bwd_inputs(q, k, v, causal), causal, joint=s == 1)


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
        y = matmul_f32(xd, wd)
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


@pytest.mark.cuda
def test_batched_matmul_f32_backward_on_card(card):
    """The per-expert product, torch.bmm(out_dtype=f32) on the card, has the
    CPU branch's values and gradients."""
    x = torch.randn(4, 16, 256, dtype=torch.bfloat16)
    w = torch.randn(4, 256, 512, dtype=torch.bfloat16)
    gy = torch.randn(4, 16, 512)
    results = []
    for dev in ("cpu", card):
        xd, wd = x.to(dev).requires_grad_(), w.to(dev).requires_grad_()
        y = matmul_f32(xd, wd)
        results.append([y, *torch.autograd.grad(y, (xd, wd), gy.to(dev))])
    for name, c, g in zip(("y", "dx", "dw"), *results):
        assert g.dtype == c.dtype, name
        torch.testing.assert_close(g.cpu().float(), c.float(), atol=1e-2, rtol=1e-2, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", ["indexed", "dense"])
def test_moe_ffn_on_card_matches_cpu(card, dispatch):
    """f32 MoE layer at capacity factor 1.25 (picks dropped): routing, output
    and aux on the card equal the CPU's within 1e-4, and each gradient
    within 1e-5 of its largest CPU value (summation order only; the router's
    gradient sums terms of both signs over the tokens)."""
    cfg = MoEConfig(n_experts=8, experts_per_token=2, capacity_factor=1.25, d_ff=256, dispatch=dispatch)
    gen = torch.Generator().manual_seed(0)
    params = {"router": torch.randn(128, 8, generator=gen) * 0.3,
              "we_gate": torch.randn(8, 128, 256, generator=gen) * 0.1,
              "we_up": torch.randn(8, 128, 256, generator=gen) * 0.1,
              "we_out": torch.randn(8, 256, 128, generator=gen) * 0.1}
    x = torch.randn(2, 64, 128, generator=gen)
    results = []
    for dev in ("cpu", card):
        live = {n: t.to(dev).requires_grad_() for n, t in params.items()}
        xd = x.to(dev).requires_grad_()
        out, aux = moe_ffn(xd, live, cfg)
        grads = torch.autograd.grad(out.square().sum() + aux, [xd, *live.values()])
        results.append([out, aux, *grads])
    cpu, gpu = results
    for name, c, g in zip(("out", "aux"), cpu[:2], gpu[:2]):
        torch.testing.assert_close(g.cpu(), c, atol=1e-4, rtol=1e-4)
    _assert_grads_close([g.cpu() for g in gpu[2:]], cpu[2:], torch.float32, ("x", *params))


@pytest.mark.cuda
def test_moe_train_step_is_deterministic_on_card(card):
    """bf16 MoE step with remat_policy "" (the backward routes again): the
    same step twice from one state is bit-equal in loss, params and
    optimizer state, with 2/1/1 tensor-core launches per layer."""
    cfg = TransformerConfig(vocab=512, d_model=256, n_layers=2, n_heads=2, d_ff=256, max_seq=256,
                            dtype=torch.bfloat16, remat=True, remat_policy="",
                            moe=MoEConfig(n_experts=4, experts_per_token=2, capacity_factor=1.25))
    params = init_params(torch.Generator().manual_seed(0), cfg, device=card)
    assert params["layers"]["router"].dtype == torch.float32
    step, opt = make_train_step(cfg)
    state = opt.init(params)
    tokens = torch.randint(0, cfg.vocab, (2, 256), device=card,
                           generator=torch.Generator(device=card).manual_seed(1))
    params, state, _ = step(params, state, {"tokens": tokens})
    snapshot = tree_map(torch.clone, {"params": params, "state": state})
    runs = []
    for _ in range(2):
        run = tree_map(torch.clone, snapshot)
        attention.reset_launch_counts()
        _, _, loss = step(run["params"], run["state"], {"tokens": tokens})
        runs.append((loss, tree_leaves(run)))
        assert attention.launch_counts == {"flash_fwd": 2 * cfg.n_layers, "flash_fwd_scalar": 0,
                                           "flash_bwd_dq": cfg.n_layers, "flash_bwd_dkv": cfg.n_layers,
                                           "flash_bwd_dq_scalar": 0, "flash_bwd_dkv_scalar": 0}
    (loss_a, leaves_a), (loss_b, leaves_b) = runs
    assert torch.isfinite(loss_a) and torch.equal(loss_a, loss_b)
    for a, b in zip(leaves_a, leaves_b):
        assert torch.equal(a, b) and a.dtype == b.dtype


SERVE_CFG = dict(vocab=512, d_model=256, n_layers=2, n_heads=2, d_ff=512, max_seq=256,
                 dtype=torch.bfloat16, remat=False)


@pytest.mark.cuda
def test_two_check_syncs_engines_on_threads_on_card(card, monkeypatch):
    """Torch's sync debug mode is one switch for the process. Two engines
    with check_syncs=True, each on its own thread, each serve 8 requests:
    no request fails on the other engine's "error" window, every burst made
    its one copy, and the mode is the caller's again afterwards. A hidden
    sync inside a burst is still caught."""
    from odh_kubeflow_tpu_torch.serving import engine as engine_mod

    cfg = TransformerConfig(**SERVE_CFG)
    params = init_params(torch.Generator().manual_seed(0), cfg, device=card)
    engines = [engine_mod.ServingEngine(params, cfg, max_slots=4, max_seq=256, decode_burst=4,
                                        check_syncs=True, device=card).start() for _ in range(2)]
    rng = np.random.default_rng(0)
    try:
        handles = [eng.submit(rng.integers(0, cfg.vocab, 32).tolist(), max_new=int(n))
                   for eng in engines for n in rng.integers(4, 24, 8)]
        assert all(h.wait(timeout=300) for h in handles)
    finally:
        for eng in engines:
            eng.stop()
    assert [h.result for h in handles] == ["ok"] * 16
    assert all(len(h.tokens) == h.max_new for h in handles)
    assert [eng.stats()["host_syncs_last_burst"] for eng in engines] == [1, 1]
    assert torch.cuda.get_sync_debug_mode() == 0

    burst = engine_mod._decode_burst

    def hidden_sync(*args, **kw):
        out = burst(*args, **kw)
        out[0].sum().item()  # a host sync the burst must not make
        return out

    monkeypatch.setattr(engine_mod, "_decode_burst", hidden_sync)
    eng = engine_mod.ServingEngine(params, cfg, max_slots=2, max_seq=256, check_syncs=True, device=card)
    eng.submit([1, 2, 3], max_new=8)
    with pytest.raises(RuntimeError, match="synchroniz"):
        eng.step()
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_guarded_generate_makes_no_host_sync_on_card(card, monkeypatch):
    """generate() under TORCHGUARD=1 runs its models.generate region in
    torch's "error" sync mode: it finishes, greedy and sampled, so nothing
    in it syncs."""
    from odh_kubeflow_tpu_torch.models import generate
    from odh_kubeflow_tpu_torch.utils import torchguard

    monkeypatch.setenv("TORCHGUARD", "1")
    cfg = TransformerConfig(**SERVE_CFG)
    params = init_params(torch.Generator().manual_seed(0), cfg, device=card)
    before = torchguard.transfer_count()
    out = generate(params, [[1, 2, 3, 4]], cfg, max_new=6, device=card)
    sampled = generate(params, [[1, 2, 3, 4]], cfg, max_new=6, temperature=1.0, device=card)
    assert out.shape == sampled.shape == (1, 6) and torchguard.transfer_count() == before
    assert torch.cuda.get_sync_debug_mode() == 0


# sequence parallelism on the card: ranks spawned on the one card share it
# over gloo (NCCL refuses two ranks on one device), the ring's payloads
# staged through pinned host memory
SP_RING_CASES = [(layout, dtype) for layout in ("contiguous", "zigzag") for dtype in ("float32", "bfloat16")]


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_ring_attention_on_card_matches_one_device(card, world):
    """The ring's kernel path on the card (scalar kernels in f32,
    tensor-core kernels in bf16 d128), both layouts: out and q/k/v
    gradients of sum(out**2) against mha_reference over the whole
    sequence, and each rank's kernel launches as the ring's schedule."""
    import torch_dist
    from odh_kubeflow_tpu_torch.ops.ring_attention import ring_launches, zigzag_permutation

    rng = np.random.default_rng(world)
    b, s, h, hk, d = 1, 512, 8, 2, 128
    full = [rng.standard_normal(shape).astype(np.float32) for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d))]
    cases = []
    for layout, dtype in SP_RING_CASES:
        perm = zigzag_permutation(s, world) if layout == "zigzag" else np.arange(s)
        q, k, v = (x[:, perm] for x in full)
        cases.append((f"{layout}-{dtype}", "torch_sp_cases:ring_case_typed",
                      dict(q=q, k=k, v=v, layout=layout, dtype=dtype, device="cuda")))
    res = torch_dist.run_ranks(world, cases, device="cuda")
    for layout, dtype in SP_RING_CASES:
        tdtype = getattr(torch, dtype)
        qkv = [torch.from_numpy(x).to(card, tdtype).requires_grad_() for x in full]
        out = mha_reference(*qkv, causal=True)
        (out.float() ** 2).sum().backward()
        perm = zigzag_permutation(s, world) if layout == "zigzag" else np.arange(s)
        want = [t.detach().float().cpu().numpy()[:, perm] for t in (out, *(x.grad for x in qkv))]
        ranks = res[f"{layout}-{dtype}"]
        tol = BWD_TOLERANCE[tdtype] if dtype == "bfloat16" else 1e-4
        for name, w in zip(("out", "dq", "dk", "dv"), want):
            got = np.concatenate([r[name] for r in ranks], axis=1)
            err = float(np.abs(got - w).max()) / float(np.abs(w).max())
            assert err <= (TOLERANCE[tdtype] if name == "out" else tol), (layout, dtype, name, err)
        kernel = attention._fwd_kernel_for(tdtype, d)
        dq_k, dkv_k = attention._bwd_kernel_for(tdtype, d)
        for r, n in enumerate(ring_launches(world, layout)):
            got = ranks[r]["kernel_launches"]
            assert (got[kernel], got[dq_k], got[dkv_k]) == (n, n, n), (layout, dtype, r, got)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_sp_train_step_on_card_matches_one_process(card, layout):
    """value_and_grad over an sp=2 mesh on the card (f32, 2 layers, the
    scalar kernels through the ring) against one process, and one
    make_train_step step leaving the params bit-equal across ranks."""
    import dataclasses

    import torch_dist
    from odh_kubeflow_tpu_torch.models import make_zigzag_batch, value_and_grad

    cfg = TransformerConfig(vocab=256, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=512,
                            dtype=torch.float32, remat=True, remat_policy="flash", seq_axis="sp",
                            seq_layout=layout)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 128))
    batch = make_zigzag_batch(tokens, 2) if layout == "zigzag" else {"tokens": torch.as_tensor(tokens)}
    nparams = tree_map(lambda t: t.numpy(), params)
    res = torch_dist.run_ranks(2, [("sp", "torch_sp_cases:model_case", dict(
        params=nparams, batch={k: v.numpy() for k, v in batch.items()},
        cfg=cfg, plan={"sp": 2}, use_kernel=None, train_step=True,
        device="cuda"))], device="cuda")["sp"]
    one = dataclasses.replace(cfg, seq_axis="", seq_layout="contiguous")
    cparams = tree_map(lambda t: t.to(card), params)
    want_loss, want = value_and_grad(cparams, {"tokens": torch.as_tensor(tokens, device=card)}, one)
    assert abs(res[0]["loss"] - want_loss.item()) <= 1e-5 * abs(want_loss.item())
    largest = max(w.abs().max().item() for w in want)
    for g, w in zip(res[0]["grads"], want):
        assert float(np.abs(g - w.cpu().numpy()).max()) / largest <= 1e-4
    assert len({r["params_digest"] for r in res}) == 1
    from odh_kubeflow_tpu_torch.ops.ring_attention import ring_launches

    for r, n in enumerate(ring_launches(2, layout)):  # remat "flash" runs the ring once
        got = res[r]["kernel_launches"]
        assert (got["flash_fwd_scalar"], got["flash_bwd_dq_scalar"], got["flash_bwd_dkv_scalar"]) == \
            (cfg.n_layers * n,) * 3, (r, got)


# the fsdp/tp sharded step on the card: ranks spawned on the one card share
# it over gloo, every collective on a CUDA tensor staged through pinned
# host memory
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 2048, 4, 4, 128), (2, 512, 2, 1, 128)], ids=["fsdp2-tp2", "gqa-tp2"])
def test_sharded_step_flash_calls_on_card(card, shape):
    """The flash calls of the sharded step at its per-rank shapes (phase
    11's fsdp 2 x tp 2 layer, b4 s2048 h4 d128; and a GQA 4/2 layer at tp 2)
    on strided views of one fused projection: the forward with lse, dq and
    dk/dv, each against its plain version."""
    b, s, h, hk, d = shape
    qkv = torch.randn((b, s, h + 2 * hk, d), device=card).to(torch.bfloat16)
    q, k, v = qkv.split([h, hk, hk], dim=2)
    out, lse = flash_attention(q, k, v, causal=True, with_lse=True)
    ref, ref_lse = flash_attention_plain(q, k, v, causal=True, with_lse=True)
    assert (out.float() - ref.float()).abs().max().item() <= TOLERANCE[torch.bfloat16]
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    dout = torch.randn(q.shape, device=card).to(torch.bfloat16)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    _check_bwd_on_card(q, k, v, dout, lse, delta, True)


@pytest.mark.cuda
def test_comm_collectives_on_card_match_cpu(card):
    """Each collective of parallel.comm and its autograd Functions on CUDA
    tensors over gloo (staged) against the same on CPU tensors: the same
    bits, and the staged transport's host waits counted; the ep pair,
    gather_slices, aux_mean and vocab_argmax too."""
    import torch_dist

    res = torch_dist.run_ranks(2, [(dev, "torch_shard_cases:comm_case", dict(device=dev))
                                   for dev in ("cpu", "cuda")]
                               + [("ep " + dev, "torch_ep_cases:comm_ep_case", dict(device=dev))
                                  for dev in ("cpu", "cuda")], device="cuda")
    for r in range(2):
        got, want = res["cuda"][r], res["cpu"][r]
        assert want["host_waits"] == 0 and got["host_waits"] > 0
        for name in want:
            if name == "host_waits":
                continue
            for g, w in zip(_flat(got[name]), _flat(want[name])):
                np.testing.assert_array_equal(g, w, err_msg=f"rank {r} {name}")
        got, want = res["ep cuda"][r], res["ep cpu"][r]
        for name in want:
            for g, w in zip(_flat(got[name]), _flat(want[name])):
                np.testing.assert_array_equal(g, w, err_msg=f"rank {r} {name}")


def _flat(x):
    return [y for item in x for y in _flat(item)] if isinstance(x, (list, tuple)) else [x]


@pytest.mark.cuda
def test_sharded_train_step_on_card_matches_one_process(card):
    """value_and_grad at fsdp 2 x tp 2 on the card (f32, 2 layers, GQA 4/2:
    the scalar kernels) against one process, the gathered gradients within
    1e-4 of the largest; one make_train_step step launches each scalar
    kernel once a layer, and leaves the replicated leaves bit-equal."""
    import torch_dist
    from odh_kubeflow_tpu_torch.models import value_and_grad

    cfg = TransformerConfig(vocab=256, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=512,
                            dtype=torch.float32, remat=True, remat_policy="flash")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (4, 128))
    res = torch_dist.run_ranks(4, [("step", "torch_shard_cases:sharded_step_case", dict(
        params=tree_map(lambda t: t.numpy(), params), tokens=tokens, cfg=cfg, plan={"fsdp": 2, "tp": 2},
        device="cuda"))], device="cuda")["step"]
    want_loss, want = value_and_grad(tree_map(lambda t: t.to(card), params),
                                     {"tokens": torch.as_tensor(tokens, device=card)}, cfg)
    assert all(abs(r["loss"] - want_loss.item()) <= 1e-5 * abs(want_loss.item()) for r in res)
    largest = max(w.abs().max().item() for w in want)
    for g, w in zip(res[0]["grads"], want):
        assert float(np.abs(g - w.cpu().numpy()).max()) / largest <= 1e-4
    for r in res:
        got = r["kernel_launches"]
        assert (got["flash_fwd_scalar"], got["flash_bwd_dq_scalar"], got["flash_bwd_dkv_scalar"]) == \
            (cfg.n_layers,) * 3, got
    for name in res[0]["replicas"]:
        blocks = {}
        for r in res:
            coords, digest = r["replicas"][name]
            blocks.setdefault(coords, set()).add(digest)
        assert all(len(d) == 1 for d in blocks.values()), name


# tensor-parallel generate, shared kv heads and the ep MoE on the card:
# ranks spawned on the one card share it over gloo, as above

SMALL = dict(vocab=256, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=512, dtype=torch.float32)
SHARED_CFG = TransformerConfig(**SMALL, remat=True, remat_policy="flash")
EP_CFG = TransformerConfig(**SMALL, remat=True, remat_policy="",
                           moe=MoEConfig(n_experts=4, experts_per_token=2, capacity_factor=1.25, d_ff=256))
EP_MOE = MoEConfig(n_experts=4, experts_per_token=2, capacity_factor=1.25, d_ff=64)
EP_FFN_PLANS = {"ep2-tp2": {"ep": 2, "tp": 2}, "ep2-fsdp2": {"ep": 2, "fsdp": 2}}


@pytest.fixture(scope="module")
def ep_card_ranks():
    """One spawn of 4 ranks sharing the card for the shared-kv step, the ep
    MoE step and moe_ffn at each ep plan (on CUDA and on CPU tensors), and
    the one-process inputs they are held against."""
    if not hopper_present("cuda"):
        pytest.skip("needs a Hopper card (compute capability 9.0) with CUDA")
    import torch_dist
    from odh_kubeflow_tpu_torch.models.moe import init_moe_params

    tokens = np.random.default_rng(1).integers(0, 256, (4, 128))
    params = {name: init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
              for name, cfg in (("shared", SHARED_CFG), ("ep", EP_CFG))}
    moe_params = tree_map(lambda t: t.numpy(), init_moe_params(torch.Generator().manual_seed(0), 32, EP_MOE,
                                                               torch.float32, "cpu"))
    x = np.random.default_rng(1).standard_normal((4, 16, 32)).astype(np.float32)
    cases = [(name, "torch_shard_cases:sharded_step_case", dict(
        params=tree_map(lambda t: t.numpy(), params[name]), tokens=tokens, cfg=cfg, plan=plan, device="cuda"))
        for name, cfg, plan in (("shared", SHARED_CFG, {"tp": 4}), ("ep", EP_CFG, {"ep": 2, "tp": 2}))]
    cases += [(f"{pid} {dev}", "torch_ep_cases:moe_case", dict(
        params=moe_params, x=x, cfg=EP_MOE, plan=plan, aux_weight=0.5, device=dev))
        for pid, plan in EP_FFN_PLANS.items() for dev in ("cpu", "cuda")]
    return torch_dist.run_ranks(4, cases, device="cuda"), params, tokens


@pytest.mark.cuda
def test_tp_generate_on_card_matches_one_process(card):
    """generate(mesh=) at tp 2 on the card (f32, 2 layers, GQA 4/2: the
    scalar forward kernel in the prefill): greedy and sampled tokens equal
    the one-process run on the card, on every rank."""
    import torch_dist
    import torch_ep_cases

    cfg = TransformerConfig(**SMALL, remat=False)
    params = tree_map(lambda t: t.numpy(), init_params(torch.Generator().manual_seed(0), cfg, device="cpu"))
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (2, 16))
    runs = [(0.0, 0), (0.8, 7)]
    res = torch_dist.run_ranks(2, [("gen", "torch_ep_cases:decode_case", dict(
        params=params, prompt=prompt, cfg=cfg, plan={"tp": 2}, max_new=12, runs=runs, device="cuda"))],
        device="cuda")["gen"]
    want = torch_ep_cases.sampled_reference(params, prompt, cfg, 12, runs, device=card)
    for r in res:
        for got, w in zip(r, want):
            np.testing.assert_array_equal(got["tokens"], w)


def _sharded_vs_one_process(card, ep_card_ranks, name, cfg):
    from odh_kubeflow_tpu_torch.models import value_and_grad

    ranks, params, tokens = ep_card_ranks
    res = ranks[name]
    want_loss, want = value_and_grad(tree_map(lambda t: t.to(card), params[name]),
                                     {"tokens": torch.as_tensor(tokens, device=card)}, cfg)
    assert all(abs(r["loss"] - want_loss.item()) <= 1e-5 * abs(want_loss.item()) for r in res)
    for g, w in zip(res[0]["grads"], want):
        assert float(np.abs(g - w.cpu().numpy()).max()) / w.abs().max().item() <= 1e-4
    for name in res[0]["replicas"]:
        blocks = {}
        for r in res:
            coords, digest = r["replicas"][name]
            blocks.setdefault(coords, set()).add(digest)
        assert all(len(d) == 1 for d in blocks.values()), name
    return res


@pytest.mark.cuda
def test_shared_kv_heads_step_on_card_matches_one_process(card, ep_card_ranks):
    """value_and_grad at tp 4 with n_kv_heads 2 on the card (f32, 2
    layers: each rank's q head reads a kv head another rank's reads too)
    against one process, each gathered gradient leaf within 1e-4 of its
    largest; one step leaves the replicated leaves bit-equal."""
    res = _sharded_vs_one_process(card, ep_card_ranks, "shared", SHARED_CFG)
    for r in res:
        got = r["kernel_launches"]
        assert (got["flash_fwd_scalar"], got["flash_bwd_dq_scalar"], got["flash_bwd_dkv_scalar"]) == \
            (SHARED_CFG.n_layers,) * 3, got


@pytest.mark.cuda
def test_ep_moe_step_on_card_matches_one_process(card, ep_card_ranks):
    """The MoE step at ep 2 x tp 2 on the card (f32, 2 layers, remat "",
    capacity factor 1.25: the tokens are not cut, so the capacity is one
    process's) against one process, each gathered gradient leaf within
    1e-4 of its largest; one step launches each scalar kernel as one
    process does, and leaves the replicated leaves bit-equal."""
    res = _sharded_vs_one_process(card, ep_card_ranks, "ep", EP_CFG)
    n = EP_CFG.n_layers
    for r in res:
        got = r["kernel_launches"]
        assert (got["flash_fwd_scalar"], got["flash_bwd_dq_scalar"], got["flash_bwd_dkv_scalar"]) == \
            (2 * n, n, n), got


@pytest.mark.cuda
@pytest.mark.parametrize("plan", sorted(EP_FFN_PLANS))
def test_ep_moe_ffn_on_card_matches_cpu(card, ep_card_ranks, plan):
    """moe_ffn(mesh=) on ranks sharing the card: out, aux and every
    gradient equal the same ranks' run on CPU tensors within 1e-5 of the
    largest (f32: summation order only)."""
    ranks = ep_card_ranks[0]
    for got, want in zip(ranks[f"{plan} cuda"], ranks[f"{plan} cpu"]):
        assert abs(got["aux"] - want["aux"]) <= 1e-6
        for key in ("out", "dx"):
            assert np.abs(got[key] - want[key]).max() <= 1e-5 * max(1.0, np.abs(want[key]).max())
    for name, want in ranks[f"{plan} cpu"][0]["grads"].items():
        got = ranks[f"{plan} cuda"][0]["grads"][name]
        assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max()), name


@pytest.mark.cuda
def test_torchrun_local_rank_picks_the_card(card, monkeypatch):
    """Under torchrun's worker env (a fake LOCAL_RANK 0, WORLD_SIZE 1),
    rank_device is cuda:0 (LOCAL_RANK mod the cards, whatever the
    reference's process id says), and initialize_from_env is a no-op that
    returns (0, 1)."""
    import torch.distributed as dist

    from odh_kubeflow_tpu_torch.parallel import initialize_from_env, rank_device

    for name, value in {"LOCAL_RANK": "0", "WORLD_SIZE": "1", "RANK": "0", "JAX_PROCESS_ID": "5"}.items():
        monkeypatch.setenv(name, value)
    assert rank_device() == torch.device("cuda", 0)
    assert initialize_from_env() == (0, 1) and not dist.is_initialized()
    monkeypatch.setenv("LOCAL_RANK", str(torch.cuda.device_count()))
    assert rank_device() == torch.device("cuda", 0)
