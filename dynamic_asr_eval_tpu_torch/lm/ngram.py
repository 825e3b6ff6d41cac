"""N-gram language model: ARPA file → sorted hash tables on the device, with
Katz backoff.

Counterpart of the JAX package's ``lm/ngram.py``:

- host side: parse ARPA (optionally gzipped; natively by
  :mod:`.arpa_native`, or in Python) into per-order tables: each n-gram's
  64-bit hash, its natural-log probability and backoff;
- device side: :meth:`NGramLM.score_next` gives ``[B, V]`` next-token
  log-probs for a batch of contexts with ``torch.searchsorted`` on the
  sorted keys, P(w|h) = p(h,w) if seen else b(h)·P(w|h').

The hash is the LCG ``h = h * MUL + id + 1`` from ``h = INC``.  The JAX
package carries it as two uint32 halves and finds a key by a binary search
on the high half and a probe over equal high halves; here it is one int64
that wraps mod 2**64 (the same bits read as signed), the keys are sorted as
signed int64, and one exact binary search finds the key: no probe.

Vocabulary is indexed by token id; the caller supplies the token → id map
when loading (n-grams with a token outside it are dropped).
:func:`load_word_arpa` reads a word-level ARPA over its own word ids instead
(for :class:`..lm.word_fusion.WordNGramAdapter`).
"""

from __future__ import annotations

import gzip
import math
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dynamic_asr_eval_tpu_torch.device import resolve_device
from dynamic_asr_eval_tpu_torch.lm import arpa_native
from dynamic_asr_eval_tpu_torch.lm.arpa_native import HASH_INC, HASH_MUL

LOG10 = math.log(10.0)


def _hash_ctx(tokens: Sequence[int]) -> int:
    """The hash of an id sequence as an unsigned 64-bit Python int."""
    h = HASH_INC
    for t in tokens:
        h = (h * HASH_MUL + int(t) + 1) % (1 << 64)
    return h


def roll_hash(h: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """One LCG step on int64 hashes: ``h * MUL + token + 1``, wrapping."""
    return h * HASH_MUL + (token.to(torch.int64) + 1)


class NGramLM:
    """Backoff n-gram tables over token ids, on ``device`` (default
    ``cuda``).  Per order k (1-indexed): sorted int64 ``keys[k]`` (hashes of
    the k-token n-grams), ``logp[k]`` and ``backoff[k]`` (natural log, f32;
    the backoff of a k-gram weighs order k+1 lookups in its context)."""

    def __init__(self, order: int, tables: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]],
                 vocab_size: int, unk_logp: float = -20.0,
                 device: Optional[Union[str, torch.device]] = None):
        self.order = order
        self.vocab_size = vocab_size
        self.unk_logp = unk_logp
        self.device = resolve_device(device)
        self.reader = "python"  # load_arpa records which parser read the file
        self.keys: Dict[int, torch.Tensor] = {}
        self.logp: Dict[int, torch.Tensor] = {}
        self.backoff: Dict[int, torch.Tensor] = {}
        for k, (keys, logp, backoff) in tables.items():
            signed = np.asarray(keys, np.uint64).view(np.int64)
            idx = np.argsort(signed, kind="stable")  # equal keys: first in file order first
            self.keys[k] = torch.from_numpy(signed[idx]).to(self.device)
            self.logp[k] = torch.from_numpy(np.asarray(logp, np.float32)[idx]).to(self.device)
            self.backoff[k] = torch.from_numpy(np.asarray(backoff, np.float32)[idx]).to(self.device)

    def table_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for d in (self.keys, self.logp, self.backoff) for t in d.values())

    def _lookup(self, k: int, h: torch.Tensor):
        """(found, logp, backoff) of hashes ``h`` (any shape) in order k."""
        keys = self.keys.get(k)
        if keys is None or keys.numel() == 0:
            z = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
            return torch.zeros(h.shape, dtype=torch.bool, device=h.device), z, z
        pos = torch.searchsorted(keys, h).clamp_(max=keys.numel() - 1)
        return keys[pos] == h, self.logp[k][pos], self.backoff[k][pos]

    def score_candidates(self, context_tokens: torch.Tensor, context_lens: torch.Tensor,
                         cand: torch.Tensor) -> torch.Tensor:
        """Log-probs ``[B, C]`` of candidate next tokens ``cand [B, C]``
        after right-aligned contexts ``context_tokens [B, W]`` (left-padded
        with -1) of ``context_lens [B]`` real tokens."""
        B = cand.shape[0]
        start = torch.full((B,), HASH_INC, dtype=torch.int64, device=cand.device)
        found, lp, _ = self._lookup(1, roll_hash(start[:, None], cand))
        scores = torch.where(found, lp, self.unk_logp)
        W = context_tokens.shape[1]
        for k in range(2, self.order + 1):
            n = k - 1
            ch = start
            for j in range(n):
                ch = roll_hash(ch, context_tokens[:, W - n + j])
            ctx_found, _, ctx_bo = self._lookup(n, ch)
            bo = torch.where(ctx_found, ctx_bo, 0.0)
            kfound, klp, _ = self._lookup(k, roll_hash(ch[:, None], cand))
            upd = torch.where(kfound, klp, scores + bo[:, None])
            scores = torch.where((context_lens >= n)[:, None], upd, scores)
        return scores

    def score_next(self, context_tokens: torch.Tensor, context_lens: torch.Tensor) -> torch.Tensor:
        """``[B, vocab_size]`` next-token log-probs (natural log)."""
        B = context_tokens.shape[0]
        vocab = torch.arange(self.vocab_size, device=context_tokens.device)
        return self.score_candidates(context_tokens, context_lens, vocab[None].expand(B, -1))


def _iter_arpa(path: str, max_order: Optional[int] = None):
    """Yield ``(order, logp_log10, tokens, backoff_log10)`` rows of an ARPA
    file (optionally .gz)."""
    opener = gzip.open if path.endswith(".gz") else open
    cur = None
    with opener(path, "rt", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("\\") and "-grams:" in line:
                cur = int(line[1:].split("-")[0])
                if max_order and cur > max_order:
                    cur = None
                continue
            if line.startswith("\\") or line.startswith("ngram ") or cur is None:
                if line == "\\end\\":
                    break
                continue
            parts = line.split("\t")
            if len(parts) < 2:
                parts = line.split()
                if len(parts) < cur + 1:
                    continue
                logp = float(parts[0])
                toks = parts[1 : 1 + cur]
                bo = float(parts[1 + cur]) if len(parts) > cur + 1 else 0.0
            else:
                logp = float(parts[0])
                toks = parts[1].split(" ")
                bo = float(parts[2]) if len(parts) > 2 else 0.0
            yield cur, logp, toks, bo


def _tables_to_numpy(tables: Dict[int, List[Tuple[int, float, float]]]):
    np_tables = {}
    for k, rows in tables.items():
        if rows:
            np_tables[k] = (np.array([r[0] for r in rows], dtype=np.uint64),
                            np.array([r[1] for r in rows], dtype=np.float32),
                            np.array([r[2] for r in rows], dtype=np.float32))
    return np_tables


def _warn_dropped(path: str, total: int, kept: int, warn_drop_fraction: float) -> None:
    if total and (total - kept) / total > warn_drop_fraction:
        msg = (f"load_arpa: dropped {total - kept}/{total} n-grams "
               f"({100.0 * (total - kept) / total:.1f}%) because their tokens are not in the "
               f"tokenizer vocab: '{path}' looks like a WORD-level LM, and token-level fusion "
               f"will be a near-no-op.  Use lm.ngram.load_word_arpa + "
               f"lm.word_fusion.WordNGramAdapter instead.")
        print(f"WARNING: {msg}")
        warnings.warn(msg, stacklevel=3)


def _load_arpa_native(path, token_to_id, vocab_size, max_order, warn_drop_fraction,
                      device) -> NGramLM:
    """The native reader's rows, mapped to tokenizer ids and hashed in numpy."""
    vocab, raw = arpa_native.parse_arpa(path, max_order)
    id_map = np.array([token_to_id.get(w, -1) for w in vocab], np.int64)
    np_tables: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    order = total = kept = 0
    for k, (ids, lp, bo) in raw.items():
        order = max(order, k)
        total += ids.shape[0]
        mapped = id_map[ids] if len(vocab) else np.empty_like(ids, np.int64)
        valid = (mapped >= 0).all(axis=1)
        kept += int(valid.sum())
        if valid.any():
            np_tables[k] = (arpa_native.hash_rows(mapped[valid]), lp[valid] * LOG10,
                            bo[valid] * LOG10)
    _warn_dropped(path, total, kept, warn_drop_fraction)
    lm = NGramLM(order, np_tables, vocab_size, device=device)
    lm.reader = "native"
    return lm


def load_arpa(
    path: str,
    token_to_id: Dict[str, int],
    vocab_size: int,
    max_order: Optional[int] = None,
    warn_drop_fraction: float = 0.2,
    use_native: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> NGramLM:
    """An ARPA file (optionally .gz) as an :class:`NGramLM` over tokenizer
    ids on ``device``.  Log10 values become natural log; n-grams with a token
    outside ``token_to_id`` are dropped, with a warning when more than
    ``warn_drop_fraction`` of them are (a word-level LM against a subword
    vocabulary).  The C++ reader is used unless ``use_native`` is False
    (the plain Python parser, a reference for the tests); where it cannot be
    built, this raises rather than falling back."""
    if use_native:
        return _load_arpa_native(path, token_to_id, vocab_size, max_order, warn_drop_fraction,
                                 device)
    tables: Dict[int, List[Tuple[int, float, float]]] = {}
    order = total = kept = 0
    for cur, logp, toks, bo in _iter_arpa(path, max_order):
        order = max(order, cur)
        tables.setdefault(cur, [])
        total += 1
        ids = [token_to_id.get(t) for t in toks]
        if any(i is None for i in ids):
            continue
        kept += 1
        tables[cur].append((_hash_ctx(ids), logp * LOG10, bo * LOG10))
    _warn_dropped(path, total, kept, warn_drop_fraction)
    return NGramLM(order, _tables_to_numpy(tables), vocab_size, device=device)


def _load_word_arpa_native(path: str, max_order: Optional[int],
                           device) -> Tuple[NGramLM, Dict[str, int]]:
    """The native reader's rows over word ids in unigram-section order (the
    first occurrence of a word wins); higher-order rows with a word absent
    from the unigrams are dropped, as in the Python parser."""
    vocab, raw = arpa_native.parse_arpa(path, max_order)
    if 1 not in raw:
        lm = NGramLM(0, {}, 0, device=device)
        lm.reader = "native"
        return lm, {}
    id_map = np.full((len(vocab),), -1, np.int64)
    word_to_id: Dict[str, int] = {}
    for nid in raw[1][0][:, 0]:  # native intern ids of the unigram words
        if id_map[nid] == -1:
            id_map[nid] = len(word_to_id)
            word_to_id[vocab[nid]] = int(id_map[nid])
    np_tables: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    order = 0
    for k, (ids, lp, bo) in raw.items():
        order = max(order, k)
        mapped = id_map[ids]
        valid = (mapped >= 0).all(axis=1)
        if valid.any():
            np_tables[k] = (arpa_native.hash_rows(mapped[valid]), lp[valid] * LOG10,
                            bo[valid] * LOG10)
    lm = NGramLM(order, np_tables, len(word_to_id), device=device)
    lm.reader = "native"
    return lm, word_to_id


def load_word_arpa(
    path: str,
    max_order: Optional[int] = None,
    use_native: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[NGramLM, Dict[str, int]]:
    """A WORD-level ARPA file (optionally .gz) as ``(NGramLM over word ids on
    device, word → id)``: ids in unigram-section order, which the ARPA format
    puts first.  The C++ reader unless ``use_native`` is False (the Python
    parser); where the reader cannot be built, this raises."""
    if use_native:
        return _load_word_arpa_native(path, max_order, device)
    word_to_id: Dict[str, int] = {}
    tables: Dict[int, List[Tuple[int, float, float]]] = {}
    order = 0
    for cur, logp, toks, bo in _iter_arpa(path, max_order):
        order = max(order, cur)
        tables.setdefault(cur, [])
        if cur == 1:
            word_to_id.setdefault(toks[0], len(word_to_id))
        ids = [word_to_id.get(t) for t in toks]
        if any(i is None for i in ids):
            continue
        tables[cur].append((_hash_ctx(ids), logp * LOG10, bo * LOG10))
    return NGramLM(order, _tables_to_numpy(tables), len(word_to_id), device=device), word_to_id
