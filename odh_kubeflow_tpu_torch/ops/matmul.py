"""Products with an f32 result from operands in the model dtype: the
counterpart of ``einsum(..., preferred_element_type=f32)`` where the JAX
package keeps the f32 result (the SwiGLU gate/up products, dense and per
expert, and the logits).

Plain PyTorch; no kernel of the port's own. A bf16 matmul in torch rounds
its f32 accumulator to bf16 at the output; these products do not.
"""
from __future__ import annotations

import torch


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., k) @ w (k, n), or the batched x (e, m, k) @ w (e, k, n)."""
    if x.dtype == torch.float32:
        return x @ w.float()
    if x.is_cuda:
        if w.dim() == 3:
            return torch.bmm(x, w, out_dtype=torch.float32)
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


class _MatmulF32(torch.autograd.Function):
    """The gradient of `_mm_f32`. On a CUDA bf16 tensor the product is
    torch.mm (or torch.bmm) with out_dtype=f32, whose aten op has no
    derivative; this Function gives both device branches the one backward,
    JAX's transpose of einsum(..., preferred_element_type=f32): the f32
    cotangent contracts in f32 against the other operand and the result is
    cast to the operand's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = (gy @ w.float().transpose(-1, -2)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            if w.dim() == 3:
                gw = (x.float().transpose(1, 2) @ gy).to(w.dtype)
            else:
                x2 = x.reshape(-1, x.shape[-1]).float()
                gw = (x2.t() @ gy.reshape(-1, gy.shape[-1])).to(w.dtype)
        return gx, gw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., k) @ w (k, n), or per expert x (e, m, k) @ w (e, k, n),
    accumulated in f32 and returned in f32, without the rounding to x's
    dtype a bf16 matmul makes at its output."""
    return _MatmulF32.apply(x, w)
