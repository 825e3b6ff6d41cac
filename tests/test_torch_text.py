"""The port's text stack (its own copies, no import of the JAX package)
against the JAX package's: normaliser output, tokenizer round trips and the
corpus WER detail are exactly equal."""

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
