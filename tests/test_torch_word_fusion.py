"""The port's word-level LM fusion (``lm/ngram.py::load_word_arpa``,
``lm/word_fusion.py``) against the JAX package's.

Two word ARPAs: the toy bigram of ``tests/test_word_fusion.py`` and a random
4-gram over 40 words of 1-11 letters with ``<s>``, ``</s>`` and (in one
variant) ``<unk>``.  The adapters run side by side over the same token
streams (a batch of beams, some idle on some steps), through a character
tokenizer and a SentencePiece-style vocabulary whose "▁" pieces carry text:
each step's score deltas and the final scores within 1e-5, with and without
the partial-word lookahead; partial-word hashes equal to ``_hash_bytes`` bit
for bit (long and multi-byte words wrap 64 bits many times); the 64-bit
arithmetic against Python integers on random operands with every high bit
set; the word-level decoder's beams (tokens and scores), text and word
offsets equal to JAX's.
"""

import math
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamic_asr_eval_tpu.lm.ngram import load_word_arpa as jax_load_word_arpa
from dynamic_asr_eval_tpu.lm.word_fusion import WordNGramAdapter as JaxAdapter
from dynamic_asr_eval_tpu.lm.word_fusion import _hash_bytes as jax_hash_bytes
from dynamic_asr_eval_tpu.ops import beam_search as J
from dynamic_asr_eval_tpu.ops.pyctc_compat import build_ctcdecoder as jax_build_ctcdecoder
from dynamic_asr_eval_tpu.ops.pyctc_compat import decode_beams_lm as jax_decode_beams_lm
from dynamic_asr_eval_tpu.text import CharTokenizer as JaxCharTokenizer
from dynamic_asr_eval_tpu.text import VocabTokenizer as JaxVocabTokenizer
from dynamic_asr_eval_tpu_torch.lm import word_fusion as W
from dynamic_asr_eval_tpu_torch.lm.ngram import load_arpa, load_word_arpa
from dynamic_asr_eval_tpu_torch.ops.pyctc_compat import build_ctcdecoder, decode_beams_lm
from dynamic_asr_eval_tpu_torch.text import CharTokenizer, VocabTokenizer
from test_torch_ngram import random_arpa
from test_word_fusion import BIS, TOY_ARPA, UNIS, brute_force_word_score

torch.set_num_threads(1)

WORDS = [w for w in ("the cat sat on a mat dog ran far away big small red blue green fox "
                     "jumps over lazy quick brown extraordinarily unbelievable x ab abc abcd "
                     "abcde abcdef abcdefg hello world news time zebra quietly end ok go").split()]
SPM_PIECES = ["▁the", "▁ca", "▁c", "▁do", "t", "g", "s", "a", "b", "c", "d", "e", "x", "z",
              "▁", "▁ab", "▁zz", "ly", "▁quiet", "▁extra", "ordinarily", "▁é", "é"]


@pytest.fixture(scope="module")
def arpas(tmp_path_factory):
    d = tmp_path_factory.mktemp("word_arpa")
    toy = d / "toy.arpa"
    toy.write_text(TOY_ARPA)
    paths = {"toy": str(toy)}
    for name, specials in (("random", ("<s>", "</s>")), ("random_unk", ("<s>", "</s>", "<unk>"))):
        path = d / f"{name}.arpa"
        random_arpa(path, pieces=specials + tuple(WORDS), order=4, counts=(0, 120, 100, 80),
                    seed=len(specials))
        paths[name] = str(path)
    return paths


def tokenizers(kind):
    if kind == "char":
        return CharTokenizer(), JaxCharTokenizer()
    return VocabTokenizer(SPM_PIECES), JaxVocabTokenizer(SPM_PIECES)


def test_load_word_arpa_equals_jax(arpas):
    for name, path in arpas.items():
        native, w2i = load_word_arpa(path, device="cpu")
        plain, w2i_plain = load_word_arpa(path, use_native=False, device="cpu")
        _, want = jax_load_word_arpa(path, use_native=False)
        assert w2i == w2i_plain == want
        assert native.reader == "native" and native.order == plain.order
        for k in plain.keys:
            assert torch.equal(native.keys[k], plain.keys[k])
            torch.testing.assert_close(native.logp[k], plain.logp[k], rtol=1e-6, atol=0)
            torch.testing.assert_close(native.backoff[k], plain.backoff[k], rtol=1e-6, atol=0)


def test_token_level_load_names_word_fusion(arpas):
    tok = CharTokenizer()
    with pytest.warns(UserWarning, match="load_word_arpa"):
        load_arpa(arpas["toy"], {tok.id_to_piece(i): i for i in range(tok.vocab_size())},
                  tok.vocab_size(), device="cpu")


def test_muladd64_equals_python_integers():
    rng = np.random.default_rng(0)
    n = 4096
    vals = [rng.integers(0, 1 << 32, n, dtype=np.uint64) | np.uint64(1 << 31) * (i % 2)
            for i in range(6)]
    vals[0][:8] = vals[2][:8] = vals[4][:8] = np.uint64(0xFFFFFFFF)  # every carry
    hi, lo = W._muladd64(*(torch.from_numpy(v.astype(np.int64)) for v in vals))
    h, m, c = ((int(a) << 32 | int(b) for a, b in zip(vals[i], vals[i + 1])) for i in (0, 2, 4))
    want = [(x * y + z) & W._M64 for x, y, z in zip(h, m, c)]
    got = [(int(a) << 32) | int(b) for a, b in zip(hi.tolist(), lo.tolist())]
    assert got == want
    assert int(hi.max()) < (1 << 32) and int(lo.max()) < (1 << 32) and int(lo.min()) >= 0


def test_sort_keys_keep_unsigned_order():
    rng = np.random.default_rng(1)
    odd = rng.integers(0, 1 << 63, 200, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    h = np.concatenate([odd, np.array([0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1], np.uint64)])
    order_u = np.argsort(h, kind="stable")
    order_k = np.argsort(W._sort_keys(h), kind="stable")
    np.testing.assert_array_equal(order_u, order_k)
    hi, lo = W._split(h, "cpu")
    assert torch.equal(W._key(hi, lo), torch.from_numpy(W._sort_keys(h)))


@pytest.mark.parametrize("word", ["cat", "extraordinarily" * 3, "naïve", "ééé",
                                  "日本語テキスト"])
def test_partial_hash_is_hash_bytes(arpas, word):
    """Fed byte-carrying pieces one character at a time (the char tokenizer's
    alphabet extended by the word's characters), the state's hash pair is
    the host hash of the word, bit for bit, and the word is found when it is
    in the lexicon."""
    alphabet = " '" + "".join(sorted(set("abcdefghijklmnopqrstuvwxyz") | set(word)))
    tok = CharTokenizer(alphabet)
    lm, w2i = load_word_arpa(arpas["toy"], device="cpu")
    ad = W.WordNGramAdapter(lm, w2i, tok)
    state, _ = ad.init_state(1)
    for ch in word:
        state, _ = ad.advance(state, torch.tensor([tok.encode(ch)[0]]), torch.tensor([True]))
    _, _, h_hi, h_lo, wlen, _ = state
    assert (int(h_hi[0]) << 32) | int(h_lo[0]) == jax_hash_bytes(word) == W._hash_bytes(word)
    assert int(wlen[0]) == len(word.encode("utf-8"))
    found, wid = ad._word_id(h_hi, h_lo)
    assert bool(found[0]) == (word in w2i)


def test_close_scores_match_brute_force(arpas):
    tok = CharTokenizer()
    lm, w2i = load_word_arpa(arpas["toy"], device="cpu")
    ad = W.WordNGramAdapter(lm, w2i, tok)
    state, lps = ad.init_state(1)
    total = 0.0
    for ch in "the cat sat":
        tid = tok.encode(ch)[0]
        total += float(lps[0, tid])
        state, lps = ad.advance(state, torch.tensor([tid]), torch.tensor([True]))
    total += float(ad.final_scores(state)[0])
    assert total == pytest.approx(brute_force_word_score(["the", "cat", "sat"], UNIS, BIS),
                                  abs=1e-4)


def _streams(tok, texts, steps, seed):
    """Per step, each beam's token and whether it emits (idle beams hold)."""
    rng = np.random.default_rng(seed)
    ids = [tok.encode(t) for t in texts]
    pos = [0] * len(texts)
    out = []
    for _ in range(steps):
        toks, mask = [], []
        for b, seq in enumerate(ids):
            emit = pos[b] < len(seq) and rng.random() < 0.8
            toks.append(seq[pos[b]] if emit else int(rng.integers(0, tok.vocab_size())))
            mask.append(emit)
            pos[b] += emit
        out.append((toks, mask))
    return out


@pytest.mark.parametrize("arpa,kind,offset", [
    ("toy", "char", -10.0), ("random", "char", None), ("random_unk", "spm", -10.0),
    ("random", "spm", None)])
def test_adapter_scores_equal_jax(arpas, arpa, kind, offset):
    tok, jtok = tokenizers(kind)
    lm, w2i = load_word_arpa(arpas[arpa], device="cpu")
    jlm, jw2i = jax_load_word_arpa(arpas[arpa], use_native=False)
    kw = dict(word_bonus=0.7, unk_score_offset=offset)
    ad, jad = W.WordNGramAdapter(lm, w2i, tok, **kw), JaxAdapter(jlm, jw2i, jtok, **kw)
    texts = ["the cat sat on a mat ", "quietly extraordinarily big fox",
             "zzq abcdefg abcdefgh xx", "dog ran far away end", "é naïve ok go", "ab abc abcd"]
    state, lps = ad.init_state(len(texts))
    jstate, jlps = jax.jit(jad.init_state, static_argnums=0)(len(texts))
    advance = jax.jit(jad.advance)
    np.testing.assert_allclose(lps.numpy(), np.asarray(jlps), rtol=0, atol=1e-5)
    perm = np.array([1, 0, 2, 3, 5, 4])
    for step, (toks, mask) in enumerate(_streams(tok, texts, 24, seed=len(texts[0]))):
        if step == 12:  # a beam reorder between steps
            state = ad.gather(state, torch.from_numpy(perm))
            jstate = jax.jit(jad.gather)(jstate, jnp.asarray(perm))
            texts = [texts[i] for i in perm]
        state, lps = ad.advance(state, torch.tensor(toks), torch.tensor(mask))
        jstate, jlps = advance(jstate, jnp.asarray(toks, jnp.int32), jnp.asarray(mask))
        np.testing.assert_allclose(lps.numpy(), np.asarray(jlps), rtol=0, atol=1e-5,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(state[0].numpy(), np.asarray(jstate[0]))
        np.testing.assert_array_equal(((state[2] << 32) | state[3]).numpy().view(np.uint64),
                                      (np.asarray(jstate[2]).astype(np.uint64) << np.uint64(32))
                                      | np.asarray(jstate[3]).astype(np.uint64))
    np.testing.assert_allclose(ad.final_scores(state).numpy(),
                               np.asarray(jax.jit(jad.final_scores)(jstate)), rtol=0, atol=1e-5)
    assert float(lps.abs().max()) > 1.0  # scores fired


def frames_for(tok, text, margin=None, seed=0):
    """Log-probs [T, V+1] spelling ``text`` with a blank between tokens and
    some noise; ``margin`` (pos, rival token, its log-prob) adds a close
    rival at one token."""
    V = tok.vocab_size() + 1
    rng = np.random.default_rng(seed)
    rows = []
    for i, tid in enumerate(tok.encode(text)):
        row = rng.uniform(-14, -9, V).astype(np.float32)
        row[V - 1], row[tid] = -6.0, 0.0
        if margin is not None and margin[0] == i:
            row[margin[1]] = margin[2]
        rows += [row, np.where(np.arange(V) == V - 1, 0.0, row - 6).astype(np.float32)]
    lp = np.stack(rows)
    return (lp - np.log(np.exp(lp).sum(-1, keepdims=True))).astype(np.float32)


def test_word_level_decode_equals_jax(arpas):
    """``build_ctcdecoder(lm_level="word")`` on both sides: the beams
    (tokens, lengths, scores), the decoded text, and ``decode_beams_lm``'s
    text and word offsets.  The acoustic model narrowly prefers the OOV
    "ovex"; the word LM and its lookahead weigh in."""
    tok, jtok = CharTokenizer(), JaxCharTokenizer()
    lp = frames_for(tok, "the quick brown fox jumps ovex lazy dog", seed=3,
                    margin=(28, tok.encode("r")[0], -0.4))
    dec = build_ctcdecoder(tok, arpas["random_unk"], alpha=0.6, beta=1.53, lm_level="word",
                           device="cpu")
    jdec = jax_build_ctcdecoder(jtok, arpas["random_unk"], alpha=0.6, beta=1.53,
                                lm_level="word")
    assert dec.word_adapter is not None and jdec.word_adapter is not None
    got = dec.beams(lp, beam_width=8)
    adapter = jdec._adapter()
    want = jax.jit(lambda x: J.beam_search_device(x, adapter, beam_width=8, alpha=0.6, beta=0.0,
                                                  exclude_token_zero=False))(jnp.asarray(lp))
    gt, gl, gs = (x.numpy() for x in got)
    wt, wl, ws = (np.asarray(x) for x in want)
    live = ws > -1e29
    np.testing.assert_array_equal(gs > -1e29, live)
    np.testing.assert_array_equal(gl[live], wl[live])
    for b in np.nonzero(live)[0]:
        np.testing.assert_array_equal(gt[b, : gl[b]], wt[b, : wl[b]])
    np.testing.assert_allclose(gs[live], ws[live], rtol=1e-5)
    assert math.isfinite(float(gs[0]))
    text = dec.decode(lp, beam_width=8)
    assert text == jtok.decode([int(x) for x in wt[0, : wl[0]]])
    texts, offsets = decode_beams_lm([lp], dec, beam_width=8, ds_factor=4)
    # JAX's decode_beams_lm around the text of JAX's beams (JAX's decode is
    # that search, eager: one more compile)
    jtexts, joffsets = jax_decode_beams_lm(
        [lp], types.SimpleNamespace(decode=lambda logits, beam_width: text), beam_width=8,
        ds_factor=4)
    assert texts == jtexts == [text]
    assert offsets == joffsets and offsets[0][-1][1][1] == 4 * lp.shape[0]
