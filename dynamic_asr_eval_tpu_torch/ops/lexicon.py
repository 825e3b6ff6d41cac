"""Lexicon-constrained (word-constrained) CTC beam decoding.

Counterpart of the JAX package's ``ops/lexicon.py`` (the reference's
``word_beam_search`` extension, ``wav2vec2/wbeamtest.py``): decoding keeps
to the words of a fixed list.  :class:`LexiconConstrainedAdapter` wraps any
LM adapter of :mod:`.beam_search`: per beam it carries the current word
prefix as the beam's rolling token-id hash (:func:`..lm.ngram.roll_hash`,
int64 wrapping as the beam's own prefix hashes); a token that leaves the
prefix set gets ``-1e30`` added to its LM log-prob, and the separator only
passes when the prefix is a complete word.  The two sets are sorted int64
hashes searched with one exact ``searchsorted``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dynamic_asr_eval_tpu_torch.device import resolve_device
from dynamic_asr_eval_tpu_torch.lm.arpa_native import HASH_INC
from dynamic_asr_eval_tpu_torch.lm.ngram import _hash_ctx, roll_hash

NEG = -1e30


class _HashSet:
    """A sorted set of 64-bit hashes (int64, the signed reading of the
    bits) with membership queries on the device."""

    def __init__(self, hashes: Sequence[int], device=None):
        keys = np.unique(np.array(sorted(hashes), dtype=np.uint64).view(np.int64))
        self.keys = torch.from_numpy(keys).to(resolve_device(device))
        self.n = int(keys.shape[0])

    def contains(self, h: torch.Tensor) -> torch.Tensor:
        if self.n == 0:
            return torch.zeros(h.shape, dtype=torch.bool, device=h.device)
        pos = torch.searchsorted(self.keys, h).clamp_(max=self.n - 1)
        return self.keys[pos] == h


def build_lexicon_tables(words: Sequence[str], tokenizer,
                         device: Optional[Union[str, torch.device]] = None
                         ) -> Tuple[_HashSet, _HashSet]:
    """(prefix set, word set) over the token-id hashes of each word's
    encoding, on ``device`` (default ``cuda``)."""
    prefixes, completes = set(), set()
    for w in words:
        ids = tokenizer.encode(w)
        if not ids:
            continue
        for i in range(1, len(ids) + 1):
            prefixes.add(_hash_ctx(ids[:i]))
        completes.add(_hash_ctx(ids))
    return _HashSet(prefixes, device), _HashSet(completes, device)


class LexiconConstrainedAdapter:
    """An LM adapter with word-trie masking.  ``separator_id`` is the word
    boundary (space for char vocabularies).  State: ``(inner state, word
    prefix hash [B], prefix length [B])``."""

    def __init__(self, inner, prefix_set: _HashSet, word_set: _HashSet,
                 separator_id: int, vocab_size: int):
        self.inner = inner
        self.device = inner.device
        self.prefix_set = prefix_set
        self.word_set = word_set
        self.sep = separator_id
        self.vocab_size = vocab_size
        self._vocab = torch.arange(vocab_size, device=self.device)

    def _mask(self, wp, wp_len):
        """[B, V] additive mask."""
        ok_char = self.prefix_set.contains(roll_hash(wp[:, None], self._vocab[None, :]))
        complete = self.word_set.contains(wp) & (wp_len > 0)
        mask = torch.where(ok_char, 0.0, NEG)
        mask[:, self.sep] = torch.where(complete, 0.0, NEG)
        return mask

    def init_state(self, batch: int):
        inner_state, lps = self.inner.init_state(batch)
        wp = torch.full((batch,), HASH_INC, dtype=torch.int64, device=self.device)
        wp_len = torch.zeros((batch,), dtype=torch.int64, device=self.device)
        return (inner_state, wp, wp_len), lps + self._mask(wp, wp_len)

    def advance(self, state, tokens, mask):
        inner_state, wp, wp_len = state
        inner_state, lps = self.inner.advance(inner_state, tokens, mask)
        is_sep = tokens == self.sep
        new_wp = torch.where(is_sep, HASH_INC, roll_hash(wp, tokens))
        new_len = torch.where(is_sep, 0, wp_len + 1)
        wp = torch.where(mask, new_wp, wp)
        wp_len = torch.where(mask, new_len, wp_len)
        return (inner_state, wp, wp_len), lps + self._mask(wp, wp_len)

    def gather(self, state, idx):
        inner_state, wp, wp_len = state
        return self.inner.gather(inner_state, idx), wp[idx], wp_len[idx]


def word_beam_search(
    log_probs,  # [T, V+1], numpy or a tensor
    words: Sequence[str],
    tokenizer,
    separator_id: Optional[int] = None,
    beam_width: int = 5,
    lm_adapter=None,
    device: Optional[Union[str, torch.device]] = None,
    **beam_kwargs,
):
    """Word-constrained decode of a CTC log-prob matrix → text (the
    ``WordBeamSearch(...).compute`` surface).  Runs on the log-probs'
    device when they are a tensor, else on ``device`` (default ``cuda``)."""
    from dynamic_asr_eval_tpu_torch.ops.beam_search import UniformLMAdapter, beam_search_device

    dev = log_probs.device if torch.is_tensor(log_probs) else resolve_device(device)
    log_probs = torch.as_tensor(log_probs, device=dev)
    V = log_probs.shape[1] - 1
    if separator_id is None:
        separator_id = tokenizer.encode(" ")[0] if tokenizer.encode(" ") else 0
    prefix_set, word_set = build_lexicon_tables(words, tokenizer, dev)
    if beam_kwargs.get("alpha", 1.0) == 0.0:
        raise ValueError(
            "word_beam_search requires alpha > 0 (the lexicon mask rides the "
            "LM log-probs; alpha=0 would disable the constraint)")
    inner = lm_adapter or UniformLMAdapter(V, device=dev)
    adapter = LexiconConstrainedAdapter(inner, prefix_set, word_set, separator_id, V)
    beam_kwargs.setdefault("alpha", 1.0)
    beam_kwargs.setdefault("beta", 0.0)
    # token 0 stays decodable: the lexicon mask decides what is valid
    beam_kwargs.setdefault("exclude_token_zero", False)
    toks, lens, _ = beam_search_device(log_probs, adapter, beam_width=beam_width, **beam_kwargs)
    toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
    # only complete final words: the best beam whose last word is in the
    # lexicon, else the best beam with its trailing fragment stripped
    word_strs = set(words)
    candidates = []
    for b in range(toks.shape[0]):
        text = tokenizer.decode([int(x) for x in toks[b, : int(lens[b])]]).strip()
        candidates.append(text)
        parts = text.split()
        if not parts or parts[-1] in word_strs:
            return text
    best = candidates[0].split()
    while best and best[-1] not in word_strs:
        best.pop()
    return " ".join(best)
