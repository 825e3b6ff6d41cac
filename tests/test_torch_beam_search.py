"""The port's CTC beam search (``ops/beam_search.py``) and LM loader
(``lm/loader.py``) against the JAX package's, on the same log-probs and the
same n-gram tables.

Bar for every search: the live beams (score above -1e29) in the same order,
with equal tokens and lengths and scores within 1e-5 relative; the same bar
holds between the port's tensorized search and its :class:`BeamSearchHost`.
Cases cover the blank-only fast path, idle frames, pruning, the token-0
rule, bf16 log-probs, a capped token buffer, segments and streams.  With a
tiny transformer LM (``TransformerLMAdapter``, shared weights) the device,
segmented, streams and host searches hold JAX's beams: equal tokens, scores
within 1e-4 relative."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamic_asr_eval_tpu.lm import loader as jax_loader
from dynamic_asr_eval_tpu.lm.ngram import NGramLM as JaxNGramLM
from dynamic_asr_eval_tpu.lm.transformer_lm import TransformerLMConfig as JaxLMConfig
from dynamic_asr_eval_tpu.lm.transformer_lm import init_lm as jax_init_lm
from dynamic_asr_eval_tpu.ops import beam_search as J
from dynamic_asr_eval_tpu.text import CharTokenizer as JaxCharTokenizer
from dynamic_asr_eval_tpu_torch.lm import loader
from dynamic_asr_eval_tpu_torch.lm.ngram import NGramLM, _hash_ctx
from dynamic_asr_eval_tpu_torch.lm.transformer_lm import TransformerLM, TransformerLMConfig
from dynamic_asr_eval_tpu_torch.models.convert import lm_params_from_jax
from dynamic_asr_eval_tpu_torch.ops import beam_search as P
from dynamic_asr_eval_tpu_torch.text import CharTokenizer
from dynamic_asr_eval_tpu_torch.tta.runner import EngineOutput
from test_torch_ngram import random_arpa

torch.set_num_threads(1)

V = 12  # tokens; blank is V
NEG_HALF = -1e29


def ngram_tables(vocab, seed=0, order=3, n=60):
    rng = np.random.default_rng(seed)
    tables = {1: (np.array([_hash_ctx([v]) for v in range(vocab)], np.uint64),
                  rng.uniform(-4, -1, vocab).astype(np.float32),
                  rng.uniform(-1, 0, vocab).astype(np.float32))}
    for k in range(2, order + 1):
        grams = sorted({tuple(rng.integers(0, vocab, k).tolist()) for _ in range(n)})
        tables[k] = (np.array([_hash_ctx(g) for g in grams], np.uint64),
                     rng.uniform(-3, 0, len(grams)).astype(np.float32),
                     (rng.uniform(-1, 0, len(grams)) if k < order
                      else np.zeros(len(grams))).astype(np.float32))
    return tables


@pytest.fixture(scope="module")
def lms():
    tables = ngram_tables(V)
    return JaxNGramLM(3, tables, V), NGramLM(3, tables, V, device="cpu")


@pytest.fixture(scope="module")
def tlm():
    """A tiny transformer LM over the V tokens, as (JAX adapter, port
    adapter) on shared weights; its ring (6) is shorter than most beams."""
    jcfg = JaxLMConfig(vocab_size=V, n_layers=2, d_model=32, n_heads=2, max_cache_length=6)
    model, variables = jax_init_lm(jcfg, jax.random.PRNGKey(3))
    cfg = TransformerLMConfig(vocab_size=V, n_layers=2, d_model=32, n_heads=2,
                              max_cache_length=6)
    port = TransformerLM(cfg)
    port.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, variables["params"])))
    return (J.TransformerLMAdapter(model, variables, jcfg, bos_id=0),
            P.TransformerLMAdapter(port, cfg, bos_id=0))


def adapters(kind, lms, bos_id=0):
    if kind == "transformer":
        return lms
    if kind == "uniform":
        return J.UniformLMAdapter(V), P.UniformLMAdapter(V, device="cpu")
    return J.NGramAdapter(lms[0], bos_id=bos_id), P.NGramAdapter(lms[1], bos_id=bos_id)


def random_lp(T, seed, blank_lean=1.5, scale=2.0, vocab=V):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, vocab + 1)).astype(np.float32) * scale
    logits[:, vocab] += blank_lean
    return np.array(jax.nn.log_softmax(jnp.asarray(logits)))


def blank_dominant_lp(T, seed, every=5):
    rng = np.random.default_rng(seed)
    lp = np.full((T, V + 1), np.log(0.002 / V), np.float32)
    lp[:, V] = np.log(0.998)
    for t in range(1, T, every):
        tok = int(rng.integers(1, V))
        lp[t, tok], lp[t, V] = np.log(0.9), np.log(0.05)
    return lp - np.log(np.exp(lp).sum(-1, keepdims=True))


def assert_live_beams_equal(port, ref, rtol=1e-5):
    pt, pl, ps = (x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x) for x in port)
    rt, rl, rs = (np.asarray(x) for x in ref)
    live = rs > NEG_HALF
    assert live.any()
    np.testing.assert_array_equal(ps > NEG_HALF, live)
    np.testing.assert_array_equal(pl[live], rl[live])
    for b in np.nonzero(live)[0]:
        np.testing.assert_array_equal(pt[b, : pl[b]], rt[b, : rl[b]])
    np.testing.assert_allclose(ps[live], rs[live], rtol=rtol, atol=0)


def both(lp, kind, lms, jax_dtype=jnp.float32, torch_dtype=torch.float32, **kw):
    ja, pa = adapters(kind, lms)
    ref = J.beam_search_device(jnp.asarray(lp, jax_dtype), ja, **kw)
    port = P.beam_search_device(torch.from_numpy(np.asarray(lp)).to(torch_dtype), pa, **kw)
    return port, ref


# ---------------------------------------------------------------------------
# the tensorized search against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["uniform", "ngram"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_search_equals_jax(kind, seed, lms):
    kw = dict(beam_width=6, alpha=0.5, beta=0.3, top_k_tokens=8,
              prune_less_than_val=None if seed % 2 else 3.17)
    assert_live_beams_equal(*both(random_lp(40, seed), kind, lms, **kw))


@pytest.mark.parametrize("seed", [0, 1])
def test_blank_fast_path_and_idle_frames_equal_jax(seed, lms):
    """Mostly blank-only frames (the fast path) and a valid_frames cut (idle
    frames after it)."""
    lp = blank_dominant_lp(36, seed)
    kw = dict(beam_width=5, alpha=0.4, beta=1.0, prune_less_than_val=None, valid_frames=30)
    assert_live_beams_equal(*both(lp, "ngram", lms, **kw))


def test_token_zero_proposed_when_allowed(lms):
    lp = random_lp(30, 7)
    lp[:, 0] += 3.0
    kw = dict(beam_width=4, alpha=0.3, beta=0.2, exclude_token_zero=False, top_k_tokens=V)
    port, ref = both(lp, "ngram", lms, **kw)
    assert_live_beams_equal(port, ref)
    assert 0 in port[0][0, : port[1][0]].tolist()


@pytest.mark.parametrize("seed", [0, 4])
def test_bf16_log_probs_score_in_f32(seed, lms):
    """bf16 log-probs: beam scores promote to f32 (f32 + bf16), so the search
    equals JAX's on the same values in f32.  (JAX's own search cannot trace
    bf16 log-probs: its weakly typed f32 score start makes the blank-only
    branch bf16 and the full branch f32.  The engines hand it f32 anyway: the
    CTC head's log-softmax is f32 in both packages.)  The threshold admits
    every token, so bf16 and f32 thresholds propose the same candidates."""
    lp = torch.from_numpy(random_lp(40, seed)).bfloat16()
    kw = dict(beam_width=5, alpha=0.45, beta=1.53, top_am_threshold=-60.0)
    _, pa = adapters("ngram", lms)
    port = P.beam_search_device(lp, pa, **kw)
    assert port[2].dtype == torch.float32
    ref = J.beam_search_device(jnp.asarray(lp.float().numpy()), adapters("ngram", lms)[0], **kw)
    assert_live_beams_equal(port, ref)


def test_capped_token_buffer_equals_jax(lms):
    """max_tokens below the number of emissions (the pseudo-label cap)."""
    kw = dict(beam_width=4, alpha=0.3, beta=2.0, max_tokens=6, prune_less_than_val=None)
    port, ref = both(random_lp(40, 9, blank_lean=-2.0), "ngram", lms, **kw)
    assert port[0].shape == (4, 6)
    assert_live_beams_equal(port, ref)


def test_a_frame_where_nothing_is_proposable_is_skipped(lms):
    """Only token 0 clears the threshold: no candidate, the frame is idle."""
    lp = random_lp(20, 2)
    lp[7] = -30.0
    lp[7, 0] = 0.0
    assert_live_beams_equal(*both(lp, "ngram", lms, beam_width=4, top_k_tokens=V))


# ---------------------------------------------------------------------------
# the tensorized search against the port's host search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["uniform", "ngram"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_search_equals_host_search(kind, seed, lms):
    lp = random_lp(30, seed + 20)
    kw = dict(beam_width=6, alpha=0.5, beta=0.3, prune_less_than_val=3.17 if seed else None)
    _, pa = adapters(kind, lms)
    host = P.BeamSearchHost(lp, pa, **kw).run_search()
    toks, lens, scores = P.beam_search_device(torch.from_numpy(lp), pa, top_k_tokens=V - 1, **kw)
    live = scores > NEG_HALF
    assert int(live.sum()) == len(host)
    for b, (prefix, score) in enumerate(host):
        assert tuple(toks[b, : lens[b]].tolist()) == prefix
        assert float(scores[b]) == pytest.approx(score, rel=1e-5)


def test_host_search_equals_jax_host_search(lms):
    lp = blank_dominant_lp(30, 3, every=3)
    ja, pa = adapters("ngram", lms)
    kw = dict(beam_width=5, alpha=0.4, beta=1.0)
    assert P.BeamSearchHost(lp, pa, **kw).run_search() == pytest.approx(
        J.BeamSearchHost(lp, ja, **kw).run_search())


# ---------------------------------------------------------------------------
# segments and streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seg", [16, 50, 64])
def test_segmented_equals_jax_and_one_long_search(seg, lms):
    lp = random_lp(200, 7)
    kw = dict(beam_width=5, alpha=0.3, beta=0.4, prune_less_than_val=None, top_k_tokens=V - 1)
    ja, pa = adapters("ngram", lms)
    port = P.beam_search_segmented(torch.from_numpy(lp), pa, segment_frames=seg, **kw)
    assert_live_beams_equal(port, J.beam_search_segmented(jnp.asarray(lp), ja,
                                                          segment_frames=seg, **kw))
    whole = P.beam_search_device(torch.from_numpy(lp), pa, **kw)
    np.testing.assert_array_equal(port[0][0, : port[1][0]], whole[0][0, : whole[1][0]])


def test_streams_equal_jax(lms):
    """Ragged streams (the last ends inside a segment) over three segments."""
    lens = [40, 33, 21]
    streams = np.stack([np.concatenate([blank_dominant_lp(n, s, every=3),
                                        np.zeros((40 - n, V + 1), np.float32)])
                        for s, n in enumerate(lens)])
    kw = dict(beam_width=5, alpha=0.4, beta=1.0, prune_less_than_val=3.0, segment_frames=16)
    ja, pa = adapters("ngram", lms)
    port = P.beam_search_streams(torch.from_numpy(streams), pa, valid_frames=lens, **kw)
    ref = J.beam_search_streams(jnp.asarray(streams), ja, valid_frames=jnp.asarray(lens), **kw)
    assert port[0].shape == (3, 5, 40)
    for s in range(3):
        assert_live_beams_equal([x[s] for x in port], [np.asarray(x)[s] for x in ref])


def test_resumed_state_equals_one_search(lms):
    lp = torch.from_numpy(random_lp(60, 11))
    _, pa = adapters("ngram", lms)
    kw = dict(beam_width=4, alpha=0.4, beta=0.5, max_tokens=60)
    first = P.beam_search_device(lp[:25], pa, return_state=True, **kw)
    resumed = P.beam_search_device(lp[25:], pa, init_state=first, **kw)
    assert_live_beams_equal(resumed, P.beam_search_device(lp, pa, **kw))


# ---------------------------------------------------------------------------
# blank collapse
# ---------------------------------------------------------------------------


def test_collapse_equals_jax_on_host_and_device():
    lp = blank_dominant_lp(60, 5)
    host = P.collapse_blank_frames(lp, threshold=0.9)
    np.testing.assert_array_equal(host, J.collapse_blank_frames(lp, threshold=0.9))
    assert host.shape[0] < lp.shape[0]
    padded = np.concatenate([lp, np.zeros((7, V + 1), np.float32)])
    dev, n = P.collapse_blank_frames_device(torch.from_numpy(padded), threshold=0.9,
                                            valid_frames=torch.tensor(60))
    jdev, jn = J.collapse_blank_frames_device(jnp.asarray(padded), threshold=0.9,
                                              valid_frames=jnp.asarray(60, jnp.int32))
    assert int(n) == int(jn) == host.shape[0]
    np.testing.assert_array_equal(dev.numpy(), np.asarray(jdev))
    assert not dev[int(n):].any()


def test_collapse_keeps_repeats_apart(lms):
    lp = blank_dominant_lp(40, 1, every=6)
    collapsed = P.collapse_blank_frames(lp, threshold=0.9)
    _, pa = adapters("uniform", lms)
    kw = dict(beam_width=4, alpha=0.0, beta=0.0, prune_less_than_val=None, top_k_tokens=V - 1)
    a = P.beam_search_device(torch.from_numpy(lp), pa, **kw)
    b = P.beam_search_device(torch.from_numpy(collapsed), pa, **kw)
    assert a[0][0, : a[1][0]].tolist() == b[0][0, : b[1][0]].tolist()


# ---------------------------------------------------------------------------
# the loader: the drivers' decoders
# ---------------------------------------------------------------------------

LETTERS = [chr(c) for c in range(ord("a"), ord("z") + 1)]


@pytest.fixture(scope="module")
def char_arpa(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm") / "chars.arpa"
    random_arpa(path, LETTERS, order=3, counts=(0, 120, 120), seed=2)
    return str(path)


def _stitched(T, seed):
    """A stitched engine output of 28 characters + blank, padded by 9 rows."""
    lp = random_lp(T, seed, blank_lean=2.5, scale=3.0, vocab=28)
    logits = torch.from_numpy(np.concatenate([lp, np.zeros((9, 29), np.float32)]))
    counts = torch.cat([torch.ones(T), torch.zeros(9)])
    return lp, EngineOutput(logits, counts, None, 0.0, 28)


def test_beam_decoders_equal_jax(char_arpa):
    kw = dict(alpha=0.6, beta=1.0, segment_frames=32)
    ours = loader.load_beamsearch(char_arpa, CharTokenizer(), device="cpu", **kw)
    theirs = jax_loader.load_beamsearch(char_arpa, JaxCharTokenizer(), **kw)
    for seed in (0, 1):
        lp, out = _stitched(70, seed)
        want = theirs(lp, beam_width=6)
        assert want and ours(lp, beam_width=6) == want
        assert ours.from_engine_output(out, beam_width=6) == want


def test_batched_decoder_equals_jax(char_arpa):
    """The port decodes stream by stream; JAX pads them to one padded batch."""
    kw = dict(alpha=0.6, beta=1.0, segment_frames=32)
    ours = loader.load_beamsearch_batched(char_arpa, CharTokenizer(), device="cpu", **kw)
    theirs = jax_loader.load_beamsearch_batched(char_arpa, JaxCharTokenizer(), pad_streams=3, **kw)
    lps = [_stitched(T, s)[0] for s, T in enumerate((70, 45))]
    want = theirs(lps, beam_width=5)
    assert all(want) and ours(lps, beam_width=5) == want


def test_the_adapter_puts_the_tables_on_the_asked_device(char_arpa):
    ad = loader.load_lm_adapter(char_arpa, CharTokenizer(), device="cpu")
    assert ad.device.type == "cpu" and ad.lm.reader == "native" and ad.lm.order == 3
    assert ad.bos_id == 0 and ad.lm.vocab_size == 28


@pytest.mark.parametrize("name", ["lm.dlm", "lm.pt"])
def test_a_transformer_lm_raises_naming_its_roadmap_item(tmp_path, name):
    """The item it named (12b) is done: a transformer LM, a DLM1 file or a
    lming torch pickle, now gives a ``TransformerLMAdapter``, and a file that
    is neither (a DLM1 magic with nothing after it) still raises."""
    from dynamic_asr_eval_tpu_torch.lm.transformer_lm import init_lm

    tok = CharTokenizer()
    cfg = TransformerLMConfig(vocab_size=tok.vocab_size(), n_layers=1, d_model=16, n_heads=2)
    path = str(tmp_path / name)
    if name.endswith(".dlm"):
        loader.save_lm_checkpoint(path, init_lm(cfg), cfg)
    else:
        torch.save({"model": init_lm(cfg).state_dict(), "config": {"n_heads": 2}}, path)
    ad = loader.load_lm_adapter(path, tok, max_cache_length=8, device="cpu")
    assert isinstance(ad, P.TransformerLMAdapter) and ad.config.max_cache_length == 8
    (tmp_path / "bad").write_bytes(b"DLM1")
    with pytest.raises(Exception):
        loader.load_lm_adapter(str(tmp_path / "bad"), tok, device="cpu")


# ---------------------------------------------------------------------------
# the transformer LM's adapter
# ---------------------------------------------------------------------------

TLM_RTOL = 1e-4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_search_with_a_transformer_lm_equals_jax(seed, tlm):
    kw = dict(beam_width=6, alpha=0.5, beta=0.3, top_k_tokens=8,
              prune_less_than_val=None if seed % 2 else 3.17)
    port, ref = both(random_lp(30, seed + 40), "transformer", tlm, **kw)
    assert_live_beams_equal(port, ref, rtol=TLM_RTOL)
    assert int(port[1][0]) > 6  # the best beam is longer than the ring


def test_segmented_search_with_a_transformer_lm_equals_jax(tlm):
    lp = random_lp(70, 8)
    kw = dict(beam_width=5, alpha=0.4, beta=0.4, prune_less_than_val=None, top_k_tokens=V - 1)
    ja, pa = tlm
    port = P.beam_search_segmented(torch.from_numpy(lp), pa, segment_frames=32, **kw)
    ref = J.beam_search_segmented(jnp.asarray(lp), ja, segment_frames=32, **kw)
    assert_live_beams_equal(port, ref, rtol=TLM_RTOL)


def test_streams_with_a_transformer_lm_equal_jax(tlm):
    lens = [30, 19]
    streams = np.stack([np.concatenate([blank_dominant_lp(n, s, every=2),
                                        np.zeros((30 - n, V + 1), np.float32)])
                        for s, n in enumerate(lens)])
    kw = dict(beam_width=4, alpha=0.4, beta=1.0, prune_less_than_val=3.0, segment_frames=16)
    ja, pa = tlm
    port = P.beam_search_streams(torch.from_numpy(streams), pa, valid_frames=lens, **kw)
    ref = J.beam_search_streams(jnp.asarray(streams), ja, valid_frames=jnp.asarray(lens), **kw)
    for s in range(2):
        assert_live_beams_equal([x[s] for x in port], [np.asarray(x)[s] for x in ref],
                                rtol=TLM_RTOL)


def test_host_search_with_a_transformer_lm_equals_jax_and_the_device_search(tlm):
    """The host search hands ``advance`` a gathered copy of the parent's
    state (the ring is written in place), so siblings see the same cache."""
    lp = random_lp(24, 12)
    ja, pa = tlm
    kw = dict(beam_width=5, alpha=0.5, beta=0.5, prune_less_than_val=None)
    host = P.BeamSearchHost(lp, pa, **kw).run_search()
    ref = J.BeamSearchHost(lp, ja, **kw).run_search()
    assert [p for p, _ in host] == [p for p, _ in ref]
    np.testing.assert_allclose([s for _, s in host], [s for _, s in ref], rtol=TLM_RTOL)
    toks, lens, scores = P.beam_search_device(torch.from_numpy(lp), pa, top_k_tokens=V - 1, **kw)
    for b, (prefix, score) in enumerate(host):
        assert tuple(toks[b, : lens[b]].tolist()) == prefix
        assert float(scores[b]) == pytest.approx(score, rel=TLM_RTOL)
