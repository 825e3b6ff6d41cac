"""MADGRAD (Defazio & Jelassi, 2021) as a ``torch.optim.Optimizer``.

Counterpart of the JAX package's ``optim/madgrad.py`` (momentum dual
averaging, x0 kept explicitly):

    λ_k   = lr · √(k+1)
    g_k  += weight_decay · x_k           (when weight_decay != 0)
    s_k+1 = s_k + λ_k g_k
    ν_k+1 = ν_k + λ_k g_k²
    z_k+1 = x_0 − s_k+1 / (ν_k+1^{1/3} + ε)
    x_k+1 = (1−c)·x_k + c·z_k+1          (c = 1 − momentum)

Parameters are updated in place.  A parameter whose ``grad`` is ``None``
is left as it is (its step count still advances, as one shared count does
in the JAX state).
"""

from __future__ import annotations

import math

import torch


class MADGRAD(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-2, momentum: float = 0.9,
                 weight_decay: float = 0.0, eps: float = 1e-6):
        if isinstance(lr, str) or not isinstance(lr, (int, float)):
            raise TypeError(f"lr must be numeric, got {lr!r}")
        if not 0.0 <= momentum < 1.0:
            raise ValueError(f"momentum must be in [0, 1), got {momentum}")
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay, eps=eps))
        self.count = 0
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                st["grad_sum"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["grad_sum_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["x0"] = p.detach().clone()

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        k = self.count
        for group in self.param_groups:
            lamb = group["lr"] * math.sqrt(k + 1.0)
            ck = 1.0 - group["momentum"]
            wd, eps = group["weight_decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                g = p.grad
                if wd != 0.0:
                    g = g + wd * p
                s, v = st["grad_sum"], st["grad_sum_sq"]
                s.add_(g, alpha=lamb)
                v.addcmul_(g, g, value=lamb)
                z = st["x0"] - s / (v.pow(1.0 / 3.0) + eps)
                p.mul_(1.0 - ck).add_(z, alpha=ck)
        self.count = k + 1
        return loss
