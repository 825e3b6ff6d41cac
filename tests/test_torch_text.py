"""The port's text stack (its own copies, no import of the JAX package)
against the JAX package's: normaliser output, tokenizer round trips (the
SentencePiece reader on hand-built ``ModelProto`` bytes, as in
tests/test_text.py::test_wire_parse) and the corpus WER detail are exactly
equal."""

import struct

import numpy as np
import pytest
import torch

from dynamic_asr_eval_tpu import text as jax_text
from dynamic_asr_eval_tpu_torch import text

torch.set_num_threads(1)

SENTENCES = [
    "Mr. Smith's colour TV cost $1,200 in 1999!",
    "  the quick brown fox -- jumps over the lazy dog  ",
    "We've organised 3 meetings (um, uh) at 10:30 a.m.",
    "",
    "Hello, World? It's 50% off.",
]


@pytest.mark.parametrize("sentence", SENTENCES)
def test_normalizer_equal(sentence):
    assert text.normalize(sentence) == jax_text.normalize(sentence)


@pytest.mark.parametrize("which", ["char", "vocab"])
def test_tokenizer_round_trips_equal(which, tmp_path):
    if which == "char":
        ours, theirs = text.CharTokenizer(), jax_text.CharTokenizer()
    else:
        pieces = ["▁the", "▁qu", "ick", "▁b", "rown", "▁", "f", "o", "x", "s", "a", "t"]
        path = tmp_path / "pieces.vocab"
        path.write_text("\n".join(pieces) + "\n", encoding="utf-8")
        ours, theirs = text.load_tokenizer(str(path)), jax_text.load_tokenizer(str(path))
    for s in ("the quick brown fox", "a fast cat's toast", ""):
        ids = ours.encode(s)
        assert ids == theirs.encode(s)
        assert ours.decode(ids) == theirs.decode(ids)
    assert ours.vocab_size() == theirs.vocab_size()


def test_wer_detail_equal_over_random_corpora():
    rng = np.random.default_rng(0)
    words = ["a", "b", "c", "d", "e"]
    for _ in range(30):
        n = int(rng.integers(1, 5))
        refs = [" ".join(rng.choice(words, int(rng.integers(0, 8)))) for _ in range(n)]
        hyps = [" ".join(rng.choice(words, int(rng.integers(0, 8)))) for _ in range(n)]
        ours = text.word_error_rate_detail(hyps, refs)
        theirs = jax_text.word_error_rate_detail(hypotheses=hyps, references=refs)
        np.testing.assert_array_equal(np.asarray(ours, float), np.asarray(theirs, float))
        assert text.cer(hyps, refs) == pytest.approx(jax_text.cer(hyps, refs))


def _sp_model_bytes():
    """A hand-built SentencePiece ModelProto: (piece, score, type) entries."""
    def sp(piece, score, ptype):
        pb = piece.encode("utf-8")
        body = bytes([0x0A, len(pb)]) + pb + bytes([0x15]) + struct.pack("<f", score)
        body += bytes([0x18, ptype])
        return bytes([0x0A, len(body)]) + body

    entries = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("▁a", -1.5, 1), ("b", -2.0, 1),
               ("▁the", -1.0, 1), ("▁th", -3.0, 1), ("e", -2.5, 1), ("▁", -4.0, 1),
               ("c", -3.5, 1), ("at", -2.2, 1), ("'s", -2.8, 4), ("t", -3.0, 1)]
    return b"".join(sp(*e) for e in entries)


def test_sentencepiece_parse_matches_jax():
    data = _sp_model_bytes()
    ours, theirs = text.parse_sentencepiece_model(data), jax_text.tokenizer.parse_sentencepiece_model(data)
    assert ours == theirs
    assert ours[0][:4] == ["<unk>", "<s>", "▁a", "b"] and ours[2][:4] == [2, 3, 1, 1]


@pytest.mark.parametrize("sentence", ["ab", "the cat", "a bat's", "the the", "xyz", ""])
def test_sentencepiece_round_trips_equal(sentence, tmp_path):
    path = tmp_path / "tokenizer.model"
    path.write_bytes(_sp_model_bytes())
    ours, theirs = text.load_tokenizer(str(path)), jax_text.load_tokenizer(str(path))
    assert type(ours).__name__ == type(theirs).__name__ == "SentencePieceTokenizer"
    ids = ours.encode(sentence)
    assert ids == theirs.encode(sentence)
    assert ours.decode(ids) == theirs.decode(ids)
    assert ours.vocab_size() == theirs.vocab_size() == ours.blank_id


def test_tokenizer_kind_sniffing_matches_jax(tmp_path):
    vocab = tmp_path / "pieces.txt"
    vocab.write_text("a\nb\n", encoding="utf-8")
    model = tmp_path / "tok.bin"
    model.write_bytes(_sp_model_bytes())
    for path, kind in ((vocab, "auto"), (model, "auto"), (model, "sentencepiece"), (vocab, "vocab")):
        assert (type(text.load_tokenizer(str(path), kind)).__name__
                == type(jax_text.load_tokenizer(str(path), kind)).__name__)
    with pytest.raises(ValueError, match="unknown tokenizer kind"):
        text.load_tokenizer(str(vocab), "bpe")
