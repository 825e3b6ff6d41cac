"""Tokenizers with the reference-compatible surface: ``encode(text)``,
``decode(ids)``, ``vocab_size()``; the CTC blank is ``vocab_size()``.

Counterpart of the JAX package's ``text/tokenizer.py``: character and
vocabulary-file tokenizers, and a pure-Python SentencePiece reader (the
serialized ``ModelProto`` parsed from its protobuf wire format, unigram
Viterbi encoding, "▁"-aware decoding), so the ``tokenizer.model`` of an lcasr
checkpoint loads without the ``sentencepiece`` wheel.
"""

from __future__ import annotations

import struct
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


# ---------------------------------------------------------------------------
# SentencePiece ModelProto (protobuf wire format, parsed by hand)
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse_fields(buf: bytes):
    """Yield (field number, wire type, value) of a protobuf message."""
    pos, n = 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 0x7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val, pos = buf[pos : pos + 8], pos + 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos : pos + ln], pos + ln
        elif wire == 5:  # 32-bit
            val, pos = buf[pos : pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def parse_sentencepiece_model(data: bytes):
    """A serialized SentencePiece ModelProto → ``(pieces, scores, types)``;
    types follow the SentencePiece enum (1 NORMAL, 2 UNKNOWN, 3 CONTROL,
    4 USER_DEFINED, 5 BYTE, 6 UNUSED)."""
    pieces: List[str] = []
    scores: List[float] = []
    types: List[int] = []
    for field, wire, val in _parse_fields(data):
        if field == 1 and wire == 2:  # repeated SentencePiece
            piece, score, ptype = "", 0.0, 1
            for f2, w2, v2 in _parse_fields(val):
                if f2 == 1 and w2 == 2:
                    piece = v2.decode("utf-8", errors="replace")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            pieces.append(piece)
            scores.append(score)
            types.append(ptype)
    return pieces, scores, types


class SentencePieceTokenizer:
    """Unigram Viterbi segmentation over the piece scores (exact for unigram
    models; an approximation for BPE models, whose merge order is not stored
    per piece).  A character no piece covers maps to the UNK piece if there
    is one, else is skipped."""

    def __init__(self, pieces: Sequence[str], scores: Sequence[float], types: Sequence[int]):
        self.pieces = list(pieces)
        self.scores = list(scores)
        self.types = list(types)
        self._stoi = {p: i for i, p in enumerate(self.pieces)}
        self._max_len = max((len(p) for p in self.pieces), default=1)
        self._unk_id = next((i for i, t in enumerate(self.types) if t == 2), None)

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceTokenizer":
        with open(path, "rb") as f:
            return cls(*parse_sentencepiece_model(f.read()))

    def vocab_size(self) -> int:
        return len(self.pieces)

    @property
    def blank_id(self) -> int:
        return self.vocab_size()

    def _viterbi(self, text: str) -> List[int]:
        n = len(text)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Optional[tuple]] = [None] * (n + 1)
        best[0] = 0.0
        unk_penalty = min(self.scores, default=0.0) - 10.0
        for i in range(n):
            if best[i] <= NEG / 2:
                continue
            for L in range(1, min(self._max_len, n - i) + 1):
                idx = self._stoi.get(text[i : i + L])
                if idx is None:
                    continue
                sc = best[i] + self.scores[idx]
                if sc > best[i + L]:
                    best[i + L] = sc
                    back[i + L] = (i, idx)
            if back[i + 1] is None:  # no single-character piece: one UNK
                sc = best[i] + unk_penalty
                if sc > best[i + 1]:
                    best[i + 1] = sc
                    back[i + 1] = (i, self._unk_id)
        ids: List[int] = []
        pos = n
        while pos > 0:
            prev, idx = back[pos]
            if idx is not None:
                ids.append(idx)
            pos = prev
        ids.reverse()
        return ids

    def encode(self, text: str) -> List[int]:
        return self._viterbi("▁" + text.replace(" ", "▁"))

    def decode(self, ids: Sequence[int]) -> str:
        out = [self.pieces[int(i)] for i in ids
               if 0 <= int(i) < len(self.pieces) and self.types[int(i)] in (1, 4, 5)]
        return "".join(out).replace("▁", " ").strip()

    def id_to_piece(self, i: int) -> str:
        return self.pieces[int(i)]


def load_tokenizer(path: Optional[str] = None, kind: str = "auto"):
    """``None`` → :class:`CharTokenizer`; ``kind="auto"`` picks
    :class:`VocabTokenizer` for ``*.txt`` / ``*.vocab`` and
    :class:`SentencePieceTokenizer` for anything else (``*.model``)."""
    if path is None:
        return CharTokenizer()
    if kind == "auto":
        kind = "vocab" if path.endswith((".txt", ".vocab")) else "sentencepiece"
    if kind == "sentencepiece":
        return SentencePieceTokenizer.from_file(path)
    if kind == "vocab":
        return VocabTokenizer.from_file(path)
    raise ValueError(f"unknown tokenizer kind: {kind}")
