"""Tokenizers with the reference-compatible surface: ``encode(text)``,
``decode(ids)``, ``vocab_size()``; the CTC blank is ``vocab_size()``.

Counterpart of the JAX package's ``text/tokenizer.py`` (character and
vocabulary-file tokenizers; the SentencePiece reader is not ported yet).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence


class CharTokenizer:
    """Character-level tokenizer: space + apostrophe + a-z, ids 0..27."""

    def __init__(self, alphabet: Optional[str] = None):
        self.alphabet = alphabet if alphabet is not None else " '" + "".join(
            chr(c) for c in range(ord("a"), ord("z") + 1)
        )
        self._stoi: Dict[str, int] = {c: i for i, c in enumerate(self.alphabet)}
        self._itos: Dict[int, str] = {i: c for i, c in enumerate(self.alphabet)}

    def vocab_size(self) -> int:
        return len(self.alphabet)

    @property
    def blank_id(self) -> int:
        return self.vocab_size()

    def encode(self, text: str) -> List[int]:
        return [self._stoi[c] for c in text.lower() if c in self._stoi]

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self._itos.get(int(i), "") for i in ids)

    def id_to_piece(self, i: int) -> str:
        return self._itos.get(int(i), "")


class VocabTokenizer:
    """Greedy longest-match tokenizer over a fixed vocabulary list ("##"
    continuations, "▁" word starts)."""

    def __init__(self, pieces: Sequence[str]):
        self.pieces = list(pieces)
        self._stoi = {p: i for i, p in enumerate(self.pieces)}
        self._max_len = max((len(p) for p in self.pieces), default=1)

    @classmethod
    def from_file(cls, path: str) -> "VocabTokenizer":
        with open(path, "r", encoding="utf-8") as f:
            pieces = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        return cls(pieces)

    def vocab_size(self) -> int:
        return len(self.pieces)

    @property
    def blank_id(self) -> int:
        return self.vocab_size()

    def encode(self, text: str) -> List[int]:
        text = "▁" + text.replace(" ", "▁") if any(
            p.startswith("▁") for p in self.pieces[: min(64, len(self.pieces))]
        ) else text
        out: List[int] = []
        i = 0
        while i < len(text):
            for L in range(min(self._max_len, len(text) - i), 0, -1):
                sub = text[i : i + L]
                if sub in self._stoi:
                    out.append(self._stoi[sub])
                    i += L
                    break
            else:
                i += 1  # skip unknown char
        return out

    def decode(self, ids: Sequence[int]) -> str:
        s = "".join(self.pieces[int(i)] for i in ids if 0 <= int(i) < len(self.pieces))
        return s.replace("▁", " ").replace("##", "").strip()

    def id_to_piece(self, i: int) -> str:
        return self.pieces[int(i)]


def load_tokenizer(path: Optional[str] = None):
    """``None`` → :class:`CharTokenizer`; ``*.txt`` / ``*.vocab`` →
    :class:`VocabTokenizer`."""
    if path is None:
        return CharTokenizer()
    if path.endswith((".txt", ".vocab")):
        return VocabTokenizer.from_file(path)
    raise NotImplementedError(
        f"tokenizer {path!r}: only character and vocab-file tokenizers are "
        "ported (SentencePiece is in ROADMAP queue 1)")
