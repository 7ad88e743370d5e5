"""AdamW as optax computes it (the reference's train step uses
`optax.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1, mu_dtype=f32)`).

`torch.optim.AdamW` is not used: its decoupled decay and epsilon arithmetic
differ from optax's chain scale_by_adam -> add_decayed_weights ->
scale_by_learning_rate -> apply_updates, which `adamw.update_` follows step
for step, at the same dtypes and rounding points:
- mu = (1-b1)*g + b1*mu is kept in mu_dtype (f32); nu = (1-b2)*g**2 + b2*nu
  in the parameter's dtype (optax's mu_dtype applies to mu only);
- bias correction divides by 1 - b**t with t = count + 1, the factor cast
  to each moment's dtype;
- u = mu_hat / (sqrt(nu_hat) + eps) + weight_decay*p on every leaf (optax's
  mask is None), then p = (p - lr*u) rounded once to p's dtype.
A Python scalar times a bf16 tensor is a bf16 product in JAX, with the
scalar itself rounded to bf16 (a weak type); `_weak` gives torch the same
rounded scalar. State lives on the params' device, count included, so an
update never copies to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from .tree import tree_leaves, tree_map


def _weak(x: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX's weak typing applies it to a `dtype` array."""
    return torch.tensor(x, dtype=dtype).item()


@dataclass(frozen=True)
class adamw:  # lower case: named and called as optax.adamw is
    """The optimizer of the reference's `make_train_step`, with its
    defaults: `adamw(lr=3e-4, ...)` gives `init(params)` and
    `update_(grads, state, params)`."""

    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    mu_dtype: torch.dtype = torch.float32

    def init(self, params) -> Dict[str, Any]:
        """{"count": 0-d int32, "mu": zeros in mu_dtype, "nu": zeros in each
        param's dtype}, on the params' device (optax's ScaleByAdamState)."""
        device = tree_leaves(params)[0].device
        return {
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": tree_map(lambda p: torch.zeros_like(p, dtype=self.mu_dtype), params),
            "nu": tree_map(torch.zeros_like, params),
        }

    @torch.no_grad()
    def update_(self, grads, state, params) -> None:
        """One step, in place on `params` and `state`."""
        state["count"].add_(1)
        t = state["count"].float()
        corr1 = 1 - torch.pow(self.b1, t)  # f32, on the device
        corr2 = 1 - torch.pow(self.b2, t)
        for p, g, mu, nu in zip(*(tree_leaves(x) for x in (params, grads, state["mu"], state["nu"]))):
            mu.mul_(_weak(self.b1, mu.dtype)).add_(g * _weak(1 - self.b1, g.dtype))
            nu.mul_(_weak(self.b2, nu.dtype)).add_(g.square().mul_(_weak(1 - self.b2, g.dtype)))
            denom = (nu / corr2.to(nu.dtype)).sqrt_().add_(_weak(self.eps, nu.dtype))
            u = (mu / corr1.to(mu.dtype)) / denom
            u = u + p * _weak(self.weight_decay, p.dtype)
            p.copy_(p + u * -self.lr)
