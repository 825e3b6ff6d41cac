"""Word-boundary n-gram fusion: KenLM / pyctcdecode semantics in the beam.

Counterpart of the JAX package's ``lm/word_fusion.py``.  A word-level ARPA
(read by :func:`..lm.ngram.load_word_arpa`) scores ``P(word | word history)``
when a word completes, not per emitted token:

- per beam, the state holds the word history (the last ``order - 1`` word
  ids) and a 64-bit rolling hash of the current partial word's UTF-8 bytes,
  ``h = h * MUL + byte + 1`` from ``h = INC``;
- every vocabulary token has host constants: whether it closes the current
  word (SentencePiece "▁" pieces and the separators " ", "|", "<sep>") and
  its hash composition ``(MUL^len, C)`` so that ``h' = h * MUL^len + C``;
- a closing token looks the completed word's hash up in a sorted table
  (→ word id, else ``<unk>``, else ``unk_logp``) and the adapter charges its
  n-gram score (plus ``word_bonus``) at that token only;
- :meth:`WordNGramAdapter.final_scores` scores the pending partial word at
  end of stream;
- the partial-word lookahead (``unk_score_offset``): while a word is open, a
  provisional ``unk_score_offset × max(1, len / avg_token_len)`` applies iff
  the partial is no lexicon word's prefix (a second sorted table of every
  prefix's hash).  The adapter emits score deltas, so it telescopes away when
  the word closes.

Hashes without signed overflow: each 64-bit value is a pair of int64 tensors
holding its high and low 32 bits, multiplied through 16-bit halves, so no
intermediate leaves [0, 2^35) and the pair equals the host's
:func:`_hash_bytes` bit for bit on any device.  The tables are sorted, and
searched, as ``hash - 2^63`` in int64 (``(hi - 2^31) * 2^32 + lo``), an
order-preserving map of unsigned 64-bit order into signed int64 that no
value overflows; one exact ``searchsorted`` finds a key, with no probe.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

_MUL = 6364136223846793005
_INC = 1442695040888963407
_M64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


def _hash_bytes(text: str, h: int = _INC) -> int:
    for b in text.encode("utf-8"):
        h = (h * _MUL + b + 1) & _M64
    return h


def _piece_contribution(piece: str) -> Tuple[int, int, bool, int]:
    """``(MUL^len, C, closes_word, byte_len)`` of one piece: extending a word
    hash h by it gives ``h * MUL^len + C`` (mod 2^64)."""
    if piece in (" ", "|", "<sep>"):
        return 1, 0, True, 0  # an explicit separator closes and adds nothing
    closes = piece.startswith("▁")  # an SPM "▁" piece starts a new word
    text = piece[1:] if closes else piece
    mult, add = 1, 0
    for b in text.encode("utf-8"):
        mult = (mult * _MUL) & _M64
        add = (add * _MUL + b + 1) & _M64
    return mult, add, closes, len(text.encode("utf-8"))


def _sort_keys(hashes) -> np.ndarray:
    """Unsigned 64-bit hashes → int64 ``hash - 2^63`` (order-preserving)."""
    return (np.asarray(hashes, np.uint64) ^ np.uint64(1 << 63)).view(np.int64)


def _split(hashes, device) -> Tuple[torch.Tensor, torch.Tensor]:
    h = np.asarray(hashes, np.uint64)
    return (torch.from_numpy((h >> np.uint64(32)).astype(np.int64)).to(device),
            torch.from_numpy((h & np.uint64(_M32)).astype(np.int64)).to(device))


def _mul32(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x * y mod 2^32, x * y >> 32)`` of 32-bit values held in int64."""
    x0, x1, y0, y1 = x & _M16, x >> 16, y & _M16, y >> 16
    p00 = x0 * y0
    mid = x1 * y0 + (p00 >> 16)
    mid2 = x0 * y1 + (mid & _M16)
    hi = x1 * y1 + (mid >> 16) + (mid2 >> 16)
    lo = ((mid2 & _M16) << 16) | (p00 & _M16)
    return lo, hi


def _muladd64(h_hi, h_lo, m_hi, m_lo, c_hi, c_lo):
    """``(h * m + c) mod 2^64`` on (hi, lo) pairs of 32-bit values."""
    lo, carry_hi = _mul32(h_lo, m_lo)
    cross = (_mul32(h_hi, m_lo)[0] + _mul32(h_lo, m_hi)[0]) & _M32
    lo = lo + c_lo
    hi = (cross + carry_hi + c_hi + (lo >> 32)) & _M32
    return hi, lo & _M32


def _key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) → int64 ``hash - 2^63``, the tables' sort order."""
    return (hi - (1 << 31)) * (1 << 32) + lo


def _lookup(keys: torch.Tensor, q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(found, position of the first equal key) of queries ``q`` (any shape)."""
    if keys.numel() == 0:
        return torch.zeros(q.shape, dtype=torch.bool, device=q.device), torch.zeros_like(q)
    pos = torch.searchsorted(keys, q).clamp_(max=keys.numel() - 1)
    return keys[pos] == q, pos


class WordNGramAdapter:
    """Beam-search LM adapter with word-boundary KenLM semantics.

    ``word_lm``: an ``NGramLM`` over word ids (:func:`..lm.ngram.load_word_arpa`),
    ``word_to_id`` its vocabulary, ``tokenizer`` the acoustic model's (for
    ``id_to_piece`` and ``vocab_size``).  ``word_bonus``: added to every
    completed word (pyctcdecode's beta over the beam's alpha).
    ``unk_logp``: a completed OOV word's score when the ARPA has no
    ``<unk>``.  ``unk_score_offset`` / ``avg_token_len``: the partial-word
    lookahead (``None`` turns it off).  The state lives on the LM's device.
    """

    def __init__(self, word_lm, word_to_id: Dict[str, int], tokenizer,
                 word_bonus: float = 0.0, unk_logp: float = -20.0,
                 unk_score_offset: Optional[float] = -10.0, avg_token_len: int = 6,
                 device: Optional[Union[str, torch.device]] = None):
        self.lm = word_lm
        self.device = torch.device(device) if device is not None else word_lm.device
        self.ctx = max(word_lm.order - 1, 1)
        self.vocab_size = tokenizer.vocab_size()
        self.word_bonus = word_bonus
        self.unk_logp = unk_logp
        self.unk_score_offset = unk_score_offset
        self.avg_token_len = avg_token_len
        dev = self.device

        V = self.vocab_size
        pieces = [tokenizer.id_to_piece(i) for i in range(V)]
        contrib = [_piece_contribution(p) for p in pieces]
        self.tok_mult_hi, self.tok_mult_lo = _split([c[0] for c in contrib], dev)
        self.tok_add_hi, self.tok_add_lo = _split([c[1] for c in contrib], dev)
        closes = np.array([c[2] for c in contrib], bool)
        self.tok_closes = torch.from_numpy(closes).to(dev)
        self.tok_blen = torch.tensor([c[3] for c in contrib], dtype=torch.int64, device=dev)

        # sorted word-hash table → word id (stable: the first of equal hashes)
        keys = _sort_keys([_hash_bytes(w) for w in word_to_id])
        order = np.argsort(keys, kind="stable")
        self.word_keys = torch.from_numpy(keys[order]).to(dev)
        self.word_ids = torch.from_numpy(
            np.array(list(word_to_id.values()), np.int64)[order]).to(dev)
        self.n_words = len(word_to_id)
        self.unk_id = word_to_id.get("<unk>", -1)
        self.bos_id = word_to_id.get("<s>", -1)
        # pushed into the history for an OOV word when the ARPA has no <unk>:
        # an id outside the tables, so later lookups back off
        self.oov_sentinel = self.n_words + 1

        if unk_score_offset is not None:
            # every byte-prefix of every lexicon word (pyctcdecode's char trie)
            prefixes = set()
            for w in word_to_id:
                if w.startswith("<"):  # <s> </s> <unk>
                    continue
                h = _INC
                for b in w.encode("utf-8"):
                    h = (h * _MUL + b + 1) & _M64
                    prefixes.add(h)
            self.prefix_keys = torch.from_numpy(
                np.sort(_sort_keys(np.fromiter(prefixes, np.uint64, len(prefixes))))).to(dev)
            # a closing token's own text starts the next partial: its score
            p_after = np.zeros((V,), np.float32)
            for i, piece in enumerate(pieces):
                if closes[i]:
                    text = piece[1:] if piece.startswith("▁") else ""
                    p_after[i] = self._host_partial_score(text, _hash_bytes(text) in prefixes)
            self.tok_p_after = torch.from_numpy(p_after).to(dev)

    def _host_partial_score(self, text: str, is_prefix: bool) -> float:
        n = len(text.encode("utf-8"))
        if n == 0 or is_prefix:
            return 0.0
        s = float(self.unk_score_offset)
        if n > self.avg_token_len:
            s *= n / self.avg_token_len
        return s

    # -- lookups -------------------------------------------------------------
    def _partial_scores(self, h_hi, h_lo, blen):
        """The lookahead penalty of partials ``(h_hi, h_lo)`` of ``blen``
        bytes (any shape; f32)."""
        if self.unk_score_offset is None:
            return torch.zeros(blen.shape, dtype=torch.float32, device=blen.device)
        found, _ = _lookup(self.prefix_keys, _key(h_hi, h_lo))
        scale = torch.clamp(blen.to(torch.float32) / self.avg_token_len, min=1.0)
        return torch.where(found | (blen <= 0), 0.0, self.unk_score_offset * scale)

    def _word_id(self, h_hi, h_lo):
        """(found, word id) of completed-word hashes."""
        found, pos = _lookup(self.word_keys, _key(h_hi, h_lo))
        return found, self.word_ids[pos] if self.n_words else pos

    def _close_of(self, hist, hlen, h_hi, h_lo, wlen):
        """[B]: n-gram score (+ word bonus) of closing the current partial
        word; 0 when nothing is pending."""
        found, wid = self._word_id(h_hi, h_lo)
        if self.unk_id >= 0:
            wid_eff = torch.where(found, wid, self.unk_id)
            close = self.lm.score_candidates(hist, hlen, wid_eff[:, None])[:, 0]
        else:
            close = torch.where(found, self.lm.score_candidates(hist, hlen, wid[:, None])[:, 0],
                                self.unk_logp)
        close = close + self.word_bonus
        return torch.where(wlen > 0, close, 0.0)

    def _lm_lps(self, state):
        """[B, V]: the score delta of emitting each token: at a closing token
        the completed word's score, less the partial penalty it replaces, plus
        the new partial's; elsewhere the change of the partial penalty."""
        hist, hlen, h_hi, h_lo, wlen, p_cur = state
        close = self._close_of(hist, hlen, h_hi, h_lo, wlen)
        base = torch.where(self.tok_closes[None, :], close[:, None], 0.0)
        if self.unk_score_offset is None:
            return base
        ext_hi, ext_lo = _muladd64(h_hi[:, None], h_lo[:, None],
                                   self.tok_mult_hi[None, :], self.tok_mult_lo[None, :],
                                   self.tok_add_hi[None, :], self.tok_add_lo[None, :])
        p_ext = self._partial_scores(ext_hi, ext_lo, wlen[:, None] + self.tok_blen[None, :])
        p_next = torch.where(self.tok_closes[None, :], self.tok_p_after[None, :], p_ext)
        return base + p_next - p_cur[:, None]

    # -- the adapter surface -------------------------------------------------
    def init_state(self, batch: int):
        dev = self.device
        hist = torch.full((batch, self.ctx), -1, dtype=torch.int64, device=dev)
        hlen = torch.zeros((batch,), dtype=torch.int64, device=dev)
        if self.bos_id >= 0:
            hist[:, -1] = self.bos_id
            hlen += 1
        h_hi = torch.full((batch,), _INC >> 32, dtype=torch.int64, device=dev)
        h_lo = torch.full((batch,), _INC & _M32, dtype=torch.int64, device=dev)
        wlen = torch.zeros((batch,), dtype=torch.int64, device=dev)
        p_cur = torch.zeros((batch,), dtype=torch.float32, device=dev)
        state = (hist, hlen, h_hi, h_lo, wlen, p_cur)
        return state, self._lm_lps(state)

    def advance(self, state, tokens, mask):
        hist, hlen, h_hi, h_lo, wlen, p_cur = state
        tokens = tokens.to(torch.int64)
        closes = self.tok_closes[tokens] & mask
        closing_real = closes & (wlen > 0)

        # push the completed word into the history
        found, wid = self._word_id(h_hi, h_lo)
        push = torch.where(found, wid, self.unk_id if self.unk_id >= 0 else self.oov_sentinel)
        new_hist = torch.cat([hist[:, 1:], push[:, None]], dim=1)
        hist = torch.where(closing_real[:, None], new_hist, hist)
        hlen = torch.where(closing_real, torch.clamp(hlen + 1, max=self.ctx), hlen)

        # extend, or restart, the partial-word hash
        base_hi = torch.where(closes, _INC >> 32, h_hi)
        base_lo = torch.where(closes, _INC & _M32, h_lo)
        ext_hi, ext_lo = _muladd64(base_hi, base_lo, self.tok_mult_hi[tokens],
                                   self.tok_mult_lo[tokens], self.tok_add_hi[tokens],
                                   self.tok_add_lo[tokens])
        new_wlen = torch.where(closes, 0, wlen) + self.tok_blen[tokens]
        h_hi = torch.where(mask, ext_hi, h_hi)
        h_lo = torch.where(mask, ext_lo, h_lo)
        wlen = torch.where(mask, new_wlen, wlen)
        if self.unk_score_offset is not None:
            p_cur = torch.where(mask, self._partial_scores(h_hi, h_lo, wlen), p_cur)
        state = (hist, hlen, h_hi, h_lo, wlen, p_cur)
        return state, self._lm_lps(state)

    def gather(self, state, idx):
        return tuple(x[idx] for x in state)

    def final_scores(self, state):
        """[B]: the end-of-stream delta: the pending partial word scored as a
        full word, its provisional penalty retired.  The beam search adds
        ``alpha ×`` this to the final scores."""
        hist, hlen, h_hi, h_lo, wlen, p_cur = state
        return self._close_of(hist, hlen, h_hi, h_lo, wlen) - p_cur
