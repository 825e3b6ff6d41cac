"""Exponential moving averages over dicts of tensors.

Counterpart of the JAX package's ``optim/ema.py``: ``ema_update`` sets each
average to ``d · e + (1 − d) · p``; a decay of 1 or more is a frozen
snapshot (the AWMC anchor).  The port updates the averages in place (one
fused multiply and one fused add over all tensors), so the tensors of
``EmaState.params`` may be the parameters of a model that runs with them.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch


class EmaState(NamedTuple):
    params: Dict[str, torch.Tensor]
    decay: float


def ema_init(params: Dict[str, torch.Tensor], decay: float) -> EmaState:
    return EmaState({k: v.detach().clone() for k, v in params.items()}, decay)


@torch.no_grad()
def ema_update(state: EmaState, new_params: Dict[str, torch.Tensor],
               decay: Optional[float] = None) -> EmaState:
    """One update with ``decay`` (default: the state's own), in place;
    returns ``state``."""
    d = state.decay if decay is None else decay
    if d >= 1.0:
        return state
    avg = list(state.params.values())
    torch._foreach_mul_(avg, d)
    torch._foreach_add_(avg, [new_params[k].detach() for k in state.params], alpha=1.0 - d)
    return state


def ema_params(state: EmaState) -> Dict[str, torch.Tensor]:
    return state.params
