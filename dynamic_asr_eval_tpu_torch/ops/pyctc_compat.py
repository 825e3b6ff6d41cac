"""pyctcdecode-compatible decode surface.

Counterpart of the JAX package's ``ops/pyctc_compat.py`` (the reference's
``build_ctcdecoder(vocab, kenlm_model_path=...)`` and
``decode_beams_lm([logits], decoder, beam_width, ds_factor)``), backed by the
port's beam search (:func:`.beam_search.beam_search_device`) and its ARPA
tables: a token-level ARPA through :class:`.beam_search.NGramAdapter`, a
word-level one through :class:`..lm.word_fusion.WordNGramAdapter`.  Word
offsets are in input frames (frames × ``ds_factor``), split evenly, as in
JAX.  The beam runs on the decoder's device (default ``cuda``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dynamic_asr_eval_tpu_torch.device import resolve_device


class CTCDecoder:
    def __init__(self, tokenizer, ngram=None, alpha: float = 0.45, beta: float = 1.53,
                 exclude_token_zero: bool = False, word_adapter=None,
                 device: Optional[Union[str, torch.device]] = None):
        self.tokenizer = tokenizer
        self.ngram = ngram
        self.word_adapter = word_adapter
        have_lm = ngram is not None or word_adapter is not None
        self.alpha = alpha if have_lm else 0.0
        self.beta = beta if have_lm else 0.0
        self.exclude_token_zero = exclude_token_zero
        lm = word_adapter if word_adapter is not None else ngram
        self.device = lm.device if lm is not None else resolve_device(device)

    def _adapter(self):
        from dynamic_asr_eval_tpu_torch.ops.beam_search import NGramAdapter, UniformLMAdapter

        if self.word_adapter is not None:
            return self.word_adapter
        if self.ngram is None:
            return UniformLMAdapter(self.tokenizer.vocab_size(), device=self.device)
        return NGramAdapter(self.ngram)

    def beams(self, logits, beam_width: int = 1):
        """The beam search's ``(tokens, lengths, scores)``, best first."""
        from dynamic_asr_eval_tpu_torch.ops.beam_search import beam_search_device

        # word-level fusion: the word bonus (pyctcdecode's beta) is applied
        # per completed word inside the adapter, not per token
        beta = 0.0 if self.word_adapter is not None else self.beta
        return beam_search_device(
            torch.as_tensor(logits, device=self.device), self._adapter(),
            beam_width=max(beam_width, 1), alpha=self.alpha, beta=beta,
            exclude_token_zero=self.exclude_token_zero)

    def decode(self, logits, beam_width: int = 1) -> str:
        from dynamic_asr_eval_tpu_torch.ops.ctc import greedy_decode

        if beam_width <= 1 and self.ngram is None and self.word_adapter is None:
            return greedy_decode(logits, self.tokenizer)
        toks, lens, _ = self.beams(logits, beam_width)
        return self.tokenizer.decode([int(x) for x in toks[0, : int(lens[0])].tolist()])


def build_ctcdecoder(tokenizer, kenlm_model_path: Optional[str] = None,
                     alpha: float = 0.45, beta: float = 1.53, lm_level: str = "auto",
                     unk_score_offset: Optional[float] = -10.0,
                     device: Optional[Union[str, torch.device]] = None) -> CTCDecoder:
    """The reference's constructor; an ARPA file (optionally .gz) is loaded
    into tables on ``device`` (default ``cuda``).

    ``lm_level``: ``"token"`` fuses the ARPA per acoustic token (its
    vocabulary must be the tokenizer's pieces); ``"word"`` gives word-boundary
    KenLM semantics; ``"auto"`` picks word level when fewer than half the
    ARPA's unigrams (``<s>``, ``</s>``, ``<unk>`` aside) are tokenizer pieces.
    ``unk_score_offset``: the word-level partial-word lookahead (``None``
    turns it off)."""
    if not kenlm_model_path:
        return CTCDecoder(tokenizer, None, alpha, beta, device=device)

    from dynamic_asr_eval_tpu_torch.lm.ngram import load_arpa, load_word_arpa

    token_to_id = {tokenizer.id_to_piece(i): i for i in range(tokenizer.vocab_size())}
    if lm_level == "token":
        return CTCDecoder(tokenizer, load_arpa(kenlm_model_path, token_to_id,
                                               tokenizer.vocab_size(), device=device),
                          alpha, beta)

    word_lm, word_to_id = load_word_arpa(kenlm_model_path, device=device)
    if lm_level == "auto":
        real_words = [w for w in word_to_id if w not in {"<s>", "</s>", "<unk>"}]
        overlap = sum(1 for w in real_words if w in token_to_id)
        if real_words and overlap / len(real_words) >= 0.5:
            # the ARPA's vocabulary is the tokenizer's: token-level fusion
            return CTCDecoder(tokenizer, load_arpa(kenlm_model_path, token_to_id,
                                                   tokenizer.vocab_size(), device=device),
                              alpha, beta)

    from dynamic_asr_eval_tpu_torch.lm.word_fusion import WordNGramAdapter

    # pyctcdecode's beta is per word; the beam multiplies lm_lps by alpha,
    # so the adapter's bonus is beta / alpha
    bonus = beta / alpha if alpha else 0.0
    adapter = WordNGramAdapter(word_lm, word_to_id, tokenizer, word_bonus=bonus,
                               unk_score_offset=unk_score_offset)
    return CTCDecoder(tokenizer, None, alpha, beta, word_adapter=adapter)


def decode_beams_lm(
    logits_list: Sequence[np.ndarray],
    decoder: CTCDecoder,
    beam_width: int = 1,
    ds_factor: float = 1.0,
) -> Tuple[List[str], List[List[Tuple[str, Tuple[int, int]]]]]:
    """Decode a list of log-prob matrices → (texts, per-text word offsets in
    input frames, each word an even share of the frames)."""
    texts, offsets = [], []
    for logits in logits_list:
        text = decoder.decode(logits, beam_width=beam_width)
        texts.append(text)
        words = text.split()
        T = int(logits.shape[0] * ds_factor)
        offsets.append([(w, (int(T * i / max(len(words), 1)),
                             int(T * (i + 1) / max(len(words), 1))))
                        for i, w in enumerate(words)])
    return texts, offsets
