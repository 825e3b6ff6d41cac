"""Teacher-quality filters for enc-dec TTA.

Counterpart of the JAX package's ``tta/filters.py``: eight
heuristic gates that veto faulty pseudo-labels before a TTA update.  All
operate on host-side token lists / text (the teacher transcript is decoded to
text anyway), configured through a :class:`TeacherFilterConfig`.
"""

from __future__ import annotations

import dataclasses
import re
from difflib import SequenceMatcher
from typing import List, Optional, Sequence, Tuple

from dynamic_asr_eval_tpu_torch.text.wer import word_error_rate_detail


@dataclasses.dataclass
class TeacherFilterConfig:
    max_length: bool = False
    min_frames_per_token: int = 8
    max_consecutive_token_repeat_enabled: bool = False
    max_consecutive_token_repeat: int = 3
    repeated_token_ngrams_enabled: bool = False
    repeated_token_ngram_sizes: Tuple[int, ...] = (2, 3)
    repeated_token_ngram_min_repeats: int = 2
    decode_agreement_enabled: bool = False
    decode_agreement_temperature: float = 0.7
    decode_agreement_min_similarity: float = 0.65
    low_confidence_enabled: bool = False
    min_mean_max_prob: float = 0.35
    max_mean_entropy: float = 2.5
    repeated_words_enabled: bool = False
    max_consecutive_word_repeat: int = 3
    ctc_agreement_enabled: bool = False
    ctc_agreement_min_similarity: float = 0.5

    @classmethod
    def from_args(cls, args) -> "TeacherFilterConfig":
        g = lambda k, d: vars(args).get(k, d)
        return cls(
            max_length=g("teacher_filter_max_length", False),
            min_frames_per_token=g("teacher_min_frames_per_token", 8),
            max_consecutive_token_repeat_enabled=g("teacher_filter_max_consecutive_token_repeat", False),
            max_consecutive_token_repeat=g("teacher_max_consecutive_token_repeat", 3),
            repeated_token_ngrams_enabled=g("teacher_filter_repeated_token_ngrams", False),
            repeated_token_ngram_sizes=tuple(g("teacher_repeated_token_ngram_sizes", [2, 3])),
            repeated_token_ngram_min_repeats=g("teacher_repeated_token_ngram_min_repeats", 2),
            decode_agreement_enabled=g("teacher_filter_decode_agreement", False),
            decode_agreement_temperature=g("teacher_decode_agreement_temperature", 0.7),
            decode_agreement_min_similarity=g("teacher_decode_agreement_min_similarity", 0.65),
            low_confidence_enabled=g("teacher_filter_low_confidence", False),
            min_mean_max_prob=g("teacher_min_mean_max_prob", 0.35),
            max_mean_entropy=g("teacher_max_mean_entropy", 2.5),
            repeated_words_enabled=g("teacher_filter_repeated_words", False),
            max_consecutive_word_repeat=g("teacher_max_consecutive_word_repeat", 3),
            ctc_agreement_enabled=g("teacher_filter_ctc_agreement", False),
            ctc_agreement_min_similarity=g("teacher_ctc_agreement_min_similarity", 0.5),
        )

    @property
    def needs_teacher_forced_pass(self) -> bool:
        return self.low_confidence_enabled or self.ctc_agreement_enabled

    @property
    def needs_agreement_decode(self) -> bool:
        return self.decode_agreement_enabled


def words_of(text: str) -> List[str]:
    return re.findall(r"[a-z0-9']+", text.lower())


def longest_run(seq: Sequence) -> Tuple[int, Optional[object]]:
    best, best_item, run, prev = 0, None, 0, object()
    for item in seq:
        run = run + 1 if item == prev else 1
        prev = item
        if run > best:
            best, best_item = run, item
    return best, best_item


def has_ngram_loop(seq: Sequence, n: int, min_repeats: int) -> Tuple[bool, tuple, int]:
    span = n * min_repeats
    if n <= 0 or min_repeats <= 1 or len(seq) < span:
        return False, (), 0
    for start in range(len(seq) - span + 1):
        gram = tuple(seq[start : start + n])
        count, cur = 1, start + n
        while cur + n <= len(seq) and tuple(seq[cur : cur + n]) == gram:
            count += 1
            cur += n
        if count >= min_repeats:
            return True, gram, count
    return False, (), 0


def cer_similarity(hyp: str, ref: str) -> float:
    """1 − CER clamped to [0, 1] (``_text_cer_similarity``)."""
    if not hyp and not ref:
        return 1.0
    if not hyp or not ref:
        return 0.0
    cer = word_error_rate_detail([hyp], [ref], use_cer=True)[0]
    return max(0.0, 1.0 - cer)


def should_skip_teacher(
    cfg: TeacherFilterConfig,
    teacher_tokens: Sequence[int],
    teacher_text: str,
    spec_frames: int,
    agreement_text: Optional[str] = None,
    mean_max_prob: Optional[float] = None,
    mean_entropy: Optional[float] = None,
    ctc_text: Optional[str] = None,
) -> Tuple[bool, str]:
    """Returns (skip?, reason)."""
    if cfg.max_length and cfg.min_frames_per_token > 0:
        cap = spec_frames / cfg.min_frames_per_token
        if len(teacher_tokens) > cap:
            return True, (
                f"too many teacher tokens ({len(teacher_tokens)} for "
                f"{spec_frames} frames; max {cap:.2f})"
            )

    if cfg.max_consecutive_token_repeat_enabled:
        run, item = longest_run(list(teacher_tokens))
        if run > cfg.max_consecutive_token_repeat:
            return True, f"token {item} repeated {run}x consecutively"

    if cfg.repeated_token_ngrams_enabled:
        for n in sorted(set(cfg.repeated_token_ngram_sizes)):
            looped, gram, count = has_ngram_loop(
                list(teacher_tokens), n, cfg.repeated_token_ngram_min_repeats
            )
            if looped:
                return True, f"token {n}-gram {list(gram)} repeated {count}x"

    if cfg.decode_agreement_enabled and agreement_text is not None:
        sim = cer_similarity(agreement_text, teacher_text)
        if sim < cfg.decode_agreement_min_similarity:
            return True, f"decode agreement 1-CER={sim:.2f} < {cfg.decode_agreement_min_similarity}"

    if cfg.low_confidence_enabled:
        if mean_max_prob is not None and mean_max_prob < cfg.min_mean_max_prob:
            return True, f"mean max prob {mean_max_prob:.3f} < {cfg.min_mean_max_prob}"
        if mean_entropy is not None and mean_entropy > cfg.max_mean_entropy:
            return True, f"mean entropy {mean_entropy:.3f} > {cfg.max_mean_entropy}"

    if cfg.repeated_words_enabled:
        run, word = longest_run(words_of(teacher_text))
        if run > cfg.max_consecutive_word_repeat:
            return True, f'word "{word}" repeated {run}x consecutively'

    if cfg.ctc_agreement_enabled and ctc_text is not None:
        sim = SequenceMatcher(a=words_of(teacher_text), b=words_of(ctc_text)).ratio()
        if sim < cfg.ctc_agreement_min_similarity:
            return True, f"enc-dec/ctc agreement {sim:.2f} < {cfg.ctc_agreement_min_similarity}"

    return False, ""
