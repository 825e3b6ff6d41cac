"""CTC loss and greedy decoding.

Counterpart of the JAX package's ``ops/ctc.py``:

- :func:`ctc_loss` — summed negative log-likelihood (``reduction='sum'``),
  arbitrary blank, padded labels masked by ``label_lengths``, optional
  per-sample weights; a zero-length label costs −Σ log P(blank).  An input
  length of 0 counts as 1: the JAX recursion always takes the first frame
  (a zero-length row of a padded training batch costs −log P(blank) of its
  frame 0 there).  It is
  ``F.ctc_loss`` (the JAX package's CTC is plain XLA, not a kernel).  An
  impossible alignment (label longer than the frames allow) costs 1e30, the
  value the JAX recursion's −1e30 floor gives, not ``inf``, with zero
  gradient; JAX's floor gives a path-count gradient there instead, which
  overflows at a few hundred frames.
  PyTorch's CTC backward folds the softmax in: the gradient is exact with
  respect to the logits under a log-softmax (how the model uses it), not
  with respect to free-standing log-probs.
- :func:`greedy_labels` — argmax (first maximum on ties) → collapse repeats →
  drop blanks → left-compact into a fixed-width label tensor, on the device,
  with no host sync.
- :func:`greedy_decode` — host-side greedy decode to text.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMPOSSIBLE_LOSS = 1e30


def ctc_loss(
    log_probs: torch.Tensor,  # [B, T, V] log-softmax outputs
    input_lengths: torch.Tensor,  # [B]
    labels: torch.Tensor,  # [B, U] padded label ids
    label_lengths: torch.Tensor,  # [B]
    blank_id: Optional[int] = None,
    sample_weights: Optional[torch.Tensor] = None,  # [B]
) -> torch.Tensor:
    B, T, V = log_probs.shape
    if blank_id is None:
        blank_id = V - 1
    input_lengths = torch.clamp(input_lengths, min=1)
    nll = F.ctc_loss(
        log_probs.transpose(0, 1).float(),
        labels.long(),
        input_lengths.long(),
        label_lengths.long(),
        blank=blank_id,
        reduction="none",
        zero_infinity=True,
    )
    # zero_infinity zeroes both the value and the gradient of an impossible
    # sample; restore the JAX package's finite 1e30 value (constant, no grad).
    # A label of length L with r adjacent repeats needs L + r frames.
    U = labels.shape[1]
    pos = torch.arange(1, U, device=labels.device)
    repeats = ((labels[:, 1:] == labels[:, :-1])
               & (pos[None, :] < label_lengths[:, None])).sum(1)
    impossible = input_lengths.to(labels.device) < label_lengths + repeats
    nll = torch.where(impossible.to(nll.device),
                      torch.full_like(nll, IMPOSSIBLE_LOSS), nll)
    if sample_weights is not None:
        nll = nll * sample_weights
    return nll.sum()


def greedy_labels(
    log_probs: torch.Tensor,  # [T, V]
    input_length,  # scalar (int or 0-d tensor)
    blank_id: int,
    max_tokens: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(labels [max_tokens] int32, length int32 0-d)``."""
    T = log_probs.shape[0]
    dev = log_probs.device
    toks = torch.argmax(log_probs, dim=-1)  # first maximum on ties
    prev = torch.cat([torch.full((1,), -1, dtype=toks.dtype, device=dev), toks[:-1]])
    frame_mask = torch.arange(T, device=dev) < torch.as_tensor(input_length, device=dev)
    keep = (toks != prev) & (toks != blank_id) & frame_mask
    idx = torch.cumsum(keep.to(torch.int64), 0) - 1
    length = torch.clamp(keep.sum(), max=max_tokens).to(torch.int32)
    scatter_to = torch.where(keep & (idx < max_tokens), idx, torch.full_like(idx, max_tokens))
    labels = torch.zeros(max_tokens + 1, dtype=torch.int32, device=dev)
    labels = labels.scatter(0, scatter_to, toks.to(torch.int32))[:max_tokens]
    # the dump slot at max_tokens may hold any dropped token; it is cut off
    return labels, length


def greedy_decode(
    log_probs,
    tokenizer,
    blank_id: Optional[int] = None,
    input_length: Optional[int] = None,
) -> str:
    """Host-facing greedy decode of [T, V] (or [1, T, V]) to text."""
    lp = log_probs.detach().cpu().numpy() if torch.is_tensor(log_probs) else np.asarray(log_probs)
    if lp.ndim == 3:
        lp = lp[0]
    T, V = lp.shape
    if blank_id is None:
        blank_id = V - 1
    if input_length is None:
        input_length = T
    toks = lp.argmax(axis=-1)[:input_length]
    out = []
    prev = -1
    for t in toks:
        if t != prev and t != blank_id:
            out.append(int(t))
        prev = t
    return tokenizer.decode(out)
