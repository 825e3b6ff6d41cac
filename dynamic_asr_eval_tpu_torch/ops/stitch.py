"""Overlap-averaged stitching of per-window probabilities.

Counterpart of the JAX package's ``ops/stitch.py``: accumulate
``exp(log_probs)`` and a hit count per downsampled frame, divide, take the
log (floored at ``eps``); zero-coverage rows keep count 0 and are trimmed by
the caller.
"""

from __future__ import annotations

import numpy as np
import torch


def stitch_chunk_probs(
    probs: torch.Tensor,  # [N, T_ds, V] probabilities, padded
    ds_lengths: torch.Tensor,  # [N] true downsampled lengths (0 for pad windows)
    starts_ds: torch.Tensor,  # [N] downsampled start offsets
    total_ds: int,
    eps: float = 1e-12,
):
    """Returns ``(stitched_log_probs [total_ds, V], frame_counts [total_ds])``."""
    N, T_ds, V = probs.shape
    dev = probs.device
    frame_idx = torch.arange(T_ds, device=dev)[None, :]
    mask = frame_idx < ds_lengths.to(dev)[:, None]
    positions = torch.where(mask, starts_ds.to(dev)[:, None] + frame_idx,
                            torch.full_like(frame_idx, total_ds))
    positions = positions.clamp(max=total_ds).reshape(-1)
    acc = torch.zeros(total_ds + 1, V, dtype=probs.dtype, device=dev)
    acc.index_add_(0, positions, (probs * mask[..., None]).reshape(-1, V))
    counts = torch.zeros(total_ds + 1, dtype=probs.dtype, device=dev)
    counts.index_add_(0, positions, mask.reshape(-1).to(probs.dtype))
    acc, counts = acc[:total_ds], counts[:total_ds]
    avg = acc / torch.clamp(counts[:, None], min=1.0)
    return torch.log(torch.clamp(avg, min=eps)), counts


def trim_stitched(log_probs, counts) -> np.ndarray:
    """Host-side trim of zero-coverage rows."""
    counts = counts.detach().cpu().numpy() if torch.is_tensor(counts) else np.asarray(counts)
    lp = log_probs.detach().cpu().numpy() if torch.is_tensor(log_probs) else np.asarray(log_probs)
    return lp[counts > 0]
