"""The port's native WER (``native/levenshtein.cc``, built by the port's own
``nativelib`` into ``build/native/``) against the JAX package's native and
pure-Python paths and against the port's pure-Python DP: every count exactly
equal."""

import os

import numpy as np
import pytest
import torch

from dynamic_asr_eval_tpu.text import wer as jax_wer
from dynamic_asr_eval_tpu_torch import nativelib
from dynamic_asr_eval_tpu_torch.text import wer as port_wer

torch.set_num_threads(1)


def _corpus(seed, n, vocab, max_len, chars=False):
    rng = np.random.default_rng(seed)
    sym = np.array(list("abcdef ") if chars else [f"w{i}" for i in range(vocab)])
    join = "".join if chars else " ".join
    return [join(rng.choice(sym, size=int(rng.integers(0, max_len)))) for _ in range(n)]


def _jax_python(hyps, refs, use_cer=False):
    os.environ["DAE_NO_NATIVE_LEV"] = "1"
    try:
        return jax_wer.word_error_rate_detail(hyps, refs, use_cer=use_cer)
    finally:
        del os.environ["DAE_NO_NATIVE_LEV"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_corpus_detail_equals_jax_native_and_python(seed):
    hyps, refs = _corpus(seed, 40, 30, 25), _corpus(seed + 10, 40, 30, 25)
    ours = port_wer.word_error_rate_detail(hyps, refs)
    assert ours == jax_wer.word_error_rate_detail(hyps, refs)
    assert ours == _jax_python(hyps, refs)


def test_cer_equals_jax():
    hyps, refs = _corpus(3, 20, 0, 40, chars=True), _corpus(4, 20, 0, 40, chars=True)
    assert port_wer.word_error_rate_detail(hyps, refs, use_cer=True) == _jax_python(
        hyps, refs, use_cer=True)
    assert port_wer.cer(hyps, refs) == jax_wer.cer(hyps, refs)


@pytest.mark.parametrize("seed", [5, 6])
def test_native_counts_equal_the_python_dp_pair_by_pair(seed):
    hyps, refs = _corpus(seed, 30, 8, 30), _corpus(seed + 1, 30, 8, 30)
    for h, r in zip(hyps, refs):
        want = port_wer._edit_ops(h.split(), r.split())
        got = port_wer.wer_counts(h, r)
        assert tuple(got[:3]) == want and got[3] == len(r.split())
        np.testing.assert_array_equal(got, jax_wer.wer_counts(h, r))


def test_wer_counts_sum_to_the_corpus_detail():
    hyps, refs = _corpus(7, 25, 10, 20), _corpus(8, 25, 10, 20)
    ins, dels, subs, words = np.sum([port_wer.wer_counts(h, r) for h, r in zip(hyps, refs)], 0)
    wer, n, *_ = port_wer.word_error_rate_detail(hyps, refs)
    assert n == words and wer == (ins + dels + subs) / words


def test_long_pair_equal_to_the_python_dp():
    rng = np.random.default_rng(9)
    ref = " ".join(f"w{i}" for i in rng.integers(0, 50, 600))
    hyp = " ".join(f"w{i}" for i in rng.integers(0, 50, 550))
    want = port_wer._edit_ops(hyp.split(), ref.split())
    assert tuple(port_wer.wer_counts(hyp, ref)[:3]) == want


def test_empty_cases_as_jax():
    for hyps, refs in (([""], ["a b"]), (["a b"], [""]), ([""], [""]), ([], [])):
        ours, theirs = (port_wer.word_error_rate_detail(hyps, refs),
                        jax_wer.word_error_rate_detail(hyps, refs))
        assert ours[:2] == theirs[:2]
        np.testing.assert_array_equal(np.asarray(ours[2:]), np.asarray(theirs[2:]))


def test_known_alignment_prefers_substitution():
    assert port_wer.word_error_rate_detail(["the fat cat"], ["the cat sat"]) == \
        jax_wer.word_error_rate_detail(["the fat cat"], ["the cat sat"])


def test_length_mismatch_raises():
    with pytest.raises(ValueError, match="same length"):
        port_wer.word_error_rate_detail(["a"], [])


def test_library_builds_under_build_native():
    path = port_wer.LIBRARY.build()
    assert path.parent == nativelib.REPO_ROOT / "build" / "native"
    assert path.name.startswith("liblevenshtein_") and path.exists()


def test_a_failed_build_raises_with_the_compiler_error(tmp_path):
    src = tmp_path / "broken.cc"
    src.write_text("extern \"C\" int f() { return undefined_name; }\n")
    lib = nativelib.NativeLibrary(src, lambda lib: None, build_dir=tmp_path / "out")
    with pytest.raises(RuntimeError, match="undefined_name"):
        lib.load()
    assert not list((tmp_path / "out").glob("*.tmp"))  # no half-written file stays
