"""English text normalization for WER scoring: Whisper's
``EnglishTextNormalizer`` (from ``transformers``) then ``.lower()``, with the
British→American table of :mod:`.spelling`.  Where ``transformers`` is not
installed, a basic normalizer (lowercase, strip punctuation and bracketed
tags, collapse whitespace) is used instead, and :data:`KIND` says which.
Counterpart of the JAX package's ``text/normalizer.py``.
"""

from __future__ import annotations

import re
import unicodedata


class _BasicEnglishNormalizer:
    def __call__(self, text: str) -> str:
        text = text.lower()
        text = re.sub(r"[<\[][^>\]]*[>\]]", "", text)  # remove bracketed tags
        text = re.sub(r"\(([^)]+?)\)", "", text)
        text = unicodedata.normalize("NFKC", text)
        text = re.sub(r"[^\w\s'$%]", " ", text)
        text = re.sub(r"\s+", " ", text)
        return text.strip()


def _build_normalizer():
    try:
        from transformers.models.whisper.english_normalizer import (
            EnglishTextNormalizer as _HFNormalizer,
        )
    except ImportError:
        return _BasicEnglishNormalizer(), "basic"
    from dynamic_asr_eval_tpu_torch.text.spelling import english_spelling_mapping

    return _HFNormalizer(english_spelling_mapping()), "whisper"


class EnglishTextNormalizer:
    def __init__(self):
        self._impl, self.kind = _build_normalizer()

    def __call__(self, text: str) -> str:
        return self._impl(text).lower()


_default = None


def normalize(text: str) -> str:
    """Module-level convenience using a shared normalizer instance."""
    global _default
    if _default is None:
        _default = EnglishTextNormalizer()
    return _default(text)
