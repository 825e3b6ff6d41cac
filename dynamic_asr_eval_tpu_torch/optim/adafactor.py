"""Adafactor as a ``torch.optim.Optimizer``, step for step the chain that
``optax.adafactor(learning_rate=lr)`` builds with its defaults (the JAX
package's consistency engine's optimizer):

1. ``scale_by_factored_rms``: with ``t = count + 1`` and ``β = 1 − t^−0.8``
   (f32), ``g² + 1e-30`` averaged into a row and a column statistic where the
   two largest dimensions are both ≥ 128, else into a full second moment;
   the update is ``g / √v̂``, ``v̂`` the factored estimate
   ``row · col / mean(row)``;
2. ``clip_by_block_rms(1.0)``: each tensor's update divided by
   ``max(1, rms(update))``;
3. the learning rate;
4. ``scale_by_param_block_rms``: times ``max(rms(param), 1e-3)`` (the
   parameter before the step);
5. the sign: the parameter moves by ``−update``.

One step count serves every parameter, as optax's one ``count``.  Factoring
picks the two largest axes of the tensor as stored; torch stores a dense
kernel [out, in] where flax stores [in, out], but the factored estimate is
symmetric in rows and columns, so the transposed layout gives the same
update up to rounding.  A parameter whose ``grad`` is ``None`` is left as it
is.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


# optax.adafactor's defaults
MIN_DIM_SIZE_TO_FACTOR = 128
DECAY_RATE = 0.8
EPS = 1e-30
CLIPPING_THRESHOLD = 1.0
MIN_PARAM_SCALE = 1e-3


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """(second-largest axis, largest axis) of ``shape`` when both are at
    least MIN_DIM_SIZE_TO_FACTOR, else None (optax's rule, ties included)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x))


class Adafactor(torch.optim.Optimizer):
    def __init__(self, params, lr: float):
        if isinstance(lr, str) or not isinstance(lr, (int, float)):
            raise TypeError(f"lr must be numeric, got {lr!r}")
        super().__init__(params, dict(lr=lr))
        self.count = 0
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                dims = factored_dims(tuple(p.shape))
                st["dims"] = dims
                if dims is None:
                    st["v"] = torch.zeros_like(p)
                else:
                    d1, d0 = dims
                    st["v_row"] = torch.zeros_like(p.select(d0, 0))
                    st["v_col"] = torch.zeros_like(p.select(d1, 0))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            t = torch.tensor(self.count + 1, dtype=torch.float32)
            beta = float(1.0 - t ** -DECAY_RATE)
            for p in group["params"]:
                if p.grad is None:
                    continue
                st, g = self.state[p], p.grad
                g_sqr = g * g + EPS
                if st["dims"] is None:
                    v = st["v"].mul_(beta).add_(g_sqr, alpha=1.0 - beta)
                    u = g * torch.rsqrt(v)
                else:
                    d1, d0 = st["dims"]
                    v_row = st["v_row"].mul_(beta).add_(g_sqr.mean(dim=d0), alpha=1.0 - beta)
                    v_col = st["v_col"].mul_(beta).add_(g_sqr.mean(dim=d1), alpha=1.0 - beta)
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_factor = torch.rsqrt(v_row / v_row.mean(dim=reduced_d1, keepdim=True))
                    u = g * row_factor.unsqueeze(d0) * torch.rsqrt(v_col).unsqueeze(d1)
                u = u / torch.clamp(_rms(u) / CLIPPING_THRESHOLD, min=1.0)
                rms_p = _rms(p)
                scale = torch.where(rms_p <= MIN_PARAM_SCALE,
                                    torch.full_like(rms_p, MIN_PARAM_SCALE), rms_p)
                p.sub_(u * group["lr"] * scale)
        self.count += 1
        return loss
