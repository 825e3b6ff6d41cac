"""Pseudo-label re-tokenisation: the reference's text round trip.

Counterpart of the JAX package's ``tta/retokenize.py``.  The reference builds
its CTC pseudo-targets from text: the decoded clean stream is turned into a
string and encoded again (``tokenizer.encode(tokenizer.decode(ids))``), which
for a unigram SentencePiece model gives the canonical segmentation, not
necessarily the piece path the decoder emitted.  The engine uses the decoded
ids unless ``pseudo_label_retokenize`` is set; then every window's labels
take :func:`retokenize_labels`.

- :func:`retokenize` — the round trip for one label sequence;
- :func:`divergence_report` — how often, and by how much, the round trip
  changes the CTC target (the transcript itself never changes);
- :func:`retokenize_labels` — one window's host round trip: the labels to
  the host, the round trip, truncated to ``max_tokens``, back to the device
  (where JAX's ``make_retokenize_callback`` runs it through
  ``jax.pure_callback``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch


def retokenize(ids: Sequence[int], tokenizer) -> List[int]:
    """``tokenizer.encode(tokenizer.decode(ids))``."""
    return list(tokenizer.encode(tokenizer.decode([int(i) for i in ids])))


def _edit_distance(a: Sequence[int], b: Sequence[int]) -> int:
    """Token-level Levenshtein distance."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


def divergence_report(label_seqs: Sequence[Sequence[int]], tokenizer) -> Dict:
    """``rate`` (share of sequences whose CTC target changes),
    ``mean_token_edit`` / ``mean_len_delta`` over the diverged ones, and
    ``text_preserved`` (sequences whose transcript the round trip keeps:
    anything but ``n_cases`` is a fault of the tokenizer)."""
    n = len(label_seqs)
    diverged = edit_total = len_delta_total = text_preserved = 0
    for ids in label_seqs:
        ids = [int(i) for i in ids]
        new = retokenize(ids, tokenizer)
        if tokenizer.decode(new) == tokenizer.decode(ids):
            text_preserved += 1
        if new != ids:
            diverged += 1
            edit_total += _edit_distance(ids, new)
            len_delta_total += len(new) - len(ids)
    return {
        "n_cases": n,
        "n_diverged": diverged,
        "rate": diverged / n if n else 0.0,
        "mean_token_edit": edit_total / diverged if diverged else 0.0,
        "mean_len_delta": len_delta_total / diverged if diverged else 0.0,
        "text_preserved": text_preserved,
    }


def retokenize_labels(labels: torch.Tensor, length, tokenizer,
                      max_tokens: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One window's labels ``[max_tokens]`` and length → the re-encoded
    labels, zero-padded to ``[max_tokens]`` (longer ones truncated), and
    their length, both on ``labels``' device."""
    ids = labels[: int(length)].tolist()
    new = retokenize(ids, tokenizer)[:max_tokens]
    out = torch.zeros(max_tokens, dtype=labels.dtype)
    out[: len(new)] = torch.as_tensor(new, dtype=labels.dtype)
    return out.to(labels.device), torch.tensor(len(new), dtype=torch.int32,
                                                 device=labels.device)
