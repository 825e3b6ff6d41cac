"""The port's ``ops/pyctc_compat.py`` and ``ops/lexicon.py`` against the JAX
package's: ``CTCDecoder`` greedy and beam decodes, ``decode_beams_lm``'s
texts and word offsets, ``build_ctcdecoder``'s choice of token- or
word-level fusion, the lexicon's hash sets, and ``word_beam_search`` (the
cases of ``tests/test_tools.py`` and a multi-word lexicon decode), its text
and its beams.  JAX's beam searches run under ``jax.jit`` (one compile per
search instead of one per eager operation)."""

import contextlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamic_asr_eval_tpu.ops import beam_search as J
from dynamic_asr_eval_tpu.ops import lexicon as JL
from dynamic_asr_eval_tpu.ops import pyctc_compat as JP
from dynamic_asr_eval_tpu.text import CharTokenizer as JaxCharTokenizer
from dynamic_asr_eval_tpu_torch.lm.ngram import _hash_ctx
from dynamic_asr_eval_tpu_torch.ops import lexicon as L
from dynamic_asr_eval_tpu_torch.ops import pyctc_compat as PC
from dynamic_asr_eval_tpu_torch.text import CharTokenizer
from test_torch_ngram import random_arpa
from test_word_fusion import TOY_ARPA

torch.set_num_threads(1)


def emissions(tok, text, floor=-5.0):
    """Log-probs [T, V+1] spelling ``text``, a blank after each token."""
    V, blank = tok.vocab_size(), tok.blank_id
    frames = []
    for i in tok.encode(text):
        frames += [i, blank]
    lp = np.full((len(frames), V + 1), floor, np.float32)
    for t, k in enumerate(frames):
        lp[t, k] = 0.0
    return lp - np.log(np.exp(lp).sum(-1, keepdims=True))


def jitted_beams(lp, adapter, **kw):
    return [np.asarray(x) for x in jax.jit(
        lambda x: J.beam_search_device(x, adapter, **kw))(jnp.asarray(lp))]


def assert_same_beams(got, want, rel=1e-5):
    gt, gl, gs = (x.cpu().numpy() for x in got)
    wt, wl, ws = want
    live = ws > -1e29
    np.testing.assert_array_equal(gs > -1e29, live)
    np.testing.assert_array_equal(gl[live], wl[live])
    for b in np.nonzero(live)[0]:
        np.testing.assert_array_equal(gt[b, : gl[b]], wt[b, : wl[b]])
    np.testing.assert_allclose(gs[live], ws[live], rtol=rel)


def test_decoder_greedy_beam_and_offsets_equal_jax():
    tok, jtok = CharTokenizer(), JaxCharTokenizer()
    lp = emissions(tok, "hi there", floor=-8.0)
    dec = PC.CTCDecoder(tok, exclude_token_zero=False, device="cpu")
    jdec = JP.CTCDecoder(jtok, exclude_token_zero=False)
    assert dec.decode(lp, beam_width=1) == jdec.decode(lp, beam_width=1) == "hi there"
    got = dec.beams(lp, beam_width=4)
    want = jitted_beams(lp, jdec._adapter(), beam_width=4, alpha=0.0, beta=0.0,
                        exclude_token_zero=False)
    assert_same_beams(got, want)
    for ds in (1, 4, 2.5):
        texts, offsets = PC.decode_beams_lm([lp], dec, beam_width=4, ds_factor=ds)
        jtexts, joffsets = JP.decode_beams_lm(
            [lp], types.SimpleNamespace(decode=lambda logits, beam_width: texts[0]),
            beam_width=4, ds_factor=ds)
        assert texts == jtexts == ["hi there"]
        assert offsets == joffsets
        assert offsets[0][0][0] == "hi" and offsets[0][-1][1][1] == int(lp.shape[0] * ds)
    # a tensor goes through as it is (the last ds_factor, 2.5)
    assert PC.decode_beams_lm([torch.from_numpy(lp)], dec, beam_width=4,
                              ds_factor=2.5)[1] == joffsets


@pytest.fixture(scope="module")
def arpas(tmp_path_factory):
    d = tmp_path_factory.mktemp("pyctc")
    word = d / "word.arpa"
    word.write_text(TOY_ARPA)
    token = d / "token.arpa"
    random_arpa(token, pieces=tuple("abcdefghijklmnopqrstuvwxyz") + (" ",), order=3,
                counts=(0, 60, 40))
    return {"word": str(word), "token": str(token)}


@pytest.mark.parametrize("level", ["auto", "token", "word"])
@pytest.mark.parametrize("arpa", ["word", "token"])
def test_build_ctcdecoder_picks_the_level_of_jax(arpas, level, arpa):
    tok = CharTokenizer()
    path = arpas[arpa]
    if level == "token" and arpa == "word":
        with pytest.warns(UserWarning, match="WORD-level"):
            dec = PC.build_ctcdecoder(tok, path, lm_level=level, device="cpu")
    else:
        dec = PC.build_ctcdecoder(tok, path, lm_level=level, device="cpu")
    jdec = JP.build_ctcdecoder(JaxCharTokenizer(), path, lm_level=level)
    assert (dec.word_adapter is None) == (jdec.word_adapter is None)
    assert (dec.ngram is None) == (jdec.ngram is None)
    assert (dec.alpha, dec.beta) == (jdec.alpha, jdec.beta)
    if dec.word_adapter is not None:
        assert dec.word_adapter.word_bonus == pytest.approx(jdec.word_adapter.word_bonus)
        assert dec.word_adapter.device.type == "cpu"
    else:
        assert dec.ngram.device.type == "cpu"
    assert PC.build_ctcdecoder(tok, None, device="cpu").alpha == 0.0


def test_lexicon_sets_equal_jax():
    tok = CharTokenizer()
    words = ["the", "cat", "cart", "dog", "a", "zebra", "it's"]
    pre, full = L.build_lexicon_tables(words, tok, device="cpu")
    jpre, jfull = JL.build_lexicon_tables(words, JaxCharTokenizer())
    rng = np.random.default_rng(0)
    queries = [tok.encode(w)[:k] for w in words + ["cab", "dot", "zz"] for k in range(1, 6)]
    queries += [list(rng.integers(0, 28, rng.integers(1, 5))) for _ in range(50)]
    h = np.array([_hash_ctx(q) for q in queries], np.uint64)
    ours = [s.contains(torch.from_numpy(h.view(np.int64))).numpy() for s in (pre, full)]
    hi = jnp.asarray((h >> np.uint64(32)).astype(np.uint32))
    lo = jnp.asarray((h & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    theirs = [np.asarray(s.contains(hi, lo)) for s in (jpre, jfull)]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert ours[0].sum() > ours[1].sum() > 0


WBS_CASES = {
    "oov_to_lexicon": ("catt", ["cat", "cart"], None, None),
    "multiword": ("the cat", ["the", "cat", "dog"], None, None),
    "incomplete_final_word": ("ac", ["ab", "ca", "b"], None, None),
    "token_zero": ("ab ca", ["ab", "ca"], "abc ", 3),
}


@contextlib.contextmanager
def recording(module, name, out, wrap=lambda fn: fn):
    """``module.name`` (a beam search) wrapped by ``wrap``, each call's beams
    appended to ``out``."""
    search = wrap(getattr(module, name))

    def call(x, adapter, **kw):
        out.append(search(x, adapter, **kw))
        return out[-1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, name, call)
        yield


@pytest.mark.parametrize("case", list(WBS_CASES))
def test_word_beam_search_equals_jax(case):
    """The text, and the beams each package's ``word_beam_search`` searched
    (read from its call of ``beam_search_device``; JAX's under jit)."""
    from dynamic_asr_eval_tpu_torch.ops import beam_search as P

    text, words, alphabet, sep = WBS_CASES[case]
    tok, jtok = CharTokenizer(alphabet), JaxCharTokenizer(alphabet)
    lp = emissions(tok, text)
    beams, want_beams = [], []
    with recording(P, "beam_search_device", beams):
        got = L.word_beam_search(lp, words, tok, separator_id=sep, beam_width=8, device="cpu")
    with recording(J, "beam_search_device", want_beams, wrap=lambda search: (
            lambda x, adapter, **kw: jax.jit(lambda y: search(y, adapter, **kw))(x))):
        want = JL.word_beam_search(lp, words, jtok, separator_id=sep, beam_width=8)
    assert got == want
    assert len(beams) == len(want_beams) == 1
    assert_same_beams(beams[0], [np.asarray(x) for x in want_beams[0]])
    assert all(w in words for w in got.split())


def test_word_beam_search_rejects_alpha_zero():
    tok = CharTokenizer()
    with pytest.raises(ValueError, match="alpha > 0"):
        L.word_beam_search(emissions(tok, "cat"), ["cat"], tok, alpha=0.0, device="cpu")


def test_word_beam_search_runs_on_the_log_probs_device():
    from dynamic_asr_eval_tpu_torch.ops import beam_search as P

    tok = CharTokenizer()
    lp = torch.from_numpy(emissions(tok, "the cat"))
    beams = []
    with recording(P, "beam_search_device", beams):
        text = L.word_beam_search(lp, ["the", "cat"], tok, beam_width=4)
    assert text == "the cat" and beams[0][0].device.type == "cpu"
