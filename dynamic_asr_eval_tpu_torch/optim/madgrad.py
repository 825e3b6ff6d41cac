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

:class:`RecordsMADGRAD` steps R records' parameters stacked on a leading
axis at once, as JAX's ``vmap`` of the optimizer does: each record keeps its
own step count, and a record left out of a step keeps its weights and state.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence

import numpy as np
import torch


def _check_args(lr, momentum) -> None:
    if isinstance(lr, str) or not isinstance(lr, (int, float)):
        raise TypeError(f"lr must be numeric, got {lr!r}")
    if not 0.0 <= momentum < 1.0:
        raise ValueError(f"momentum must be in [0, 1), got {momentum}")


class MADGRAD(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-2, momentum: float = 0.9,
                 weight_decay: float = 0.0, eps: float = 1e-6):
        _check_args(lr, momentum)
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


class RecordsMADGRAD:
    """MADGRAD over parameters stacked per record, ``[R, ...]``: the slice
    of record r moves as :class:`MADGRAD` moves that record's parameters
    alone.  ``step(active)`` steps the records where ``active`` is true;
    the others keep their weights, sums and step count (JAX's ``lax.cond``
    skip of a bucket's padded window, under ``vmap``).  While every record
    is active at one count, each tensor takes :class:`MADGRAD`'s own ops."""

    def __init__(self, params: Iterable[torch.Tensor], n_records: int, lr: float = 1e-2,
                 momentum: float = 0.9, weight_decay: float = 0.0, eps: float = 1e-6):
        _check_args(lr, momentum)
        self.params = list(params)
        self.lr, self.momentum, self.weight_decay, self.eps = lr, momentum, weight_decay, eps
        self.counts = np.zeros(n_records, np.int64)
        self.state = [{"grad_sum": torch.zeros_like(p), "grad_sum_sq": torch.zeros_like(p),
                       "x0": p.detach().clone()} for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, active: Optional[Sequence[bool]] = None) -> None:
        R = len(self.counts)
        active = np.ones(R, bool) if active is None else np.asarray(active, bool)
        ck, wd, eps = 1.0 - self.momentum, self.weight_decay, self.eps
        uniform = bool(active.all()) and bool((self.counts == self.counts[0]).all())
        if uniform:
            lamb = self.lr * math.sqrt(self.counts[0] + 1.0)
        else:
            lams = self.lr * np.sqrt(self.counts + 1.0) * active
        for p, st in zip(self.params, self.state):
            if p.grad is None:
                continue
            g = p.grad
            if wd != 0.0:
                g = g + wd * p
            s, v = st["grad_sum"], st["grad_sum_sq"]
            if uniform:
                s.add_(g, alpha=lamb)
                v.addcmul_(g, g, value=lamb)
                z = st["x0"] - s / (v.pow(1.0 / 3.0) + eps)
                p.mul_(1.0 - ck).add_(z, alpha=ck)
                continue
            shape = (R,) + (1,) * (p.dim() - 1)
            keep = torch.as_tensor(active, device=p.device).view(shape)
            lam = torch.as_tensor(lams, dtype=p.dtype, device=p.device).view(shape)
            g = torch.where(keep, g, torch.zeros((), dtype=g.dtype, device=g.device))
            s.add_(g * lam)
            v.add_(g * g * lam)
            z = st["x0"] - s / (v.pow(1.0 / 3.0) + eps)
            p.copy_(torch.where(keep, p.mul(1.0 - ck).add_(z, alpha=ck), p))
        self.counts[active] += 1
