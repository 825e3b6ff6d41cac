"""The port's transformer-LM tools (``evals/tlm_tools.py``) and its LM-beam
decoders against the JAX package's, in the patterns of tests/test_tools.py
(``TestTLMTools``, ``TestLMLoader``): logit dumps of a windowed inference,
their rescoring by the host search (a thread pool) and by the device search
(groups of streams) with a transformer LM, the prefilled ring cache, and
``load_beamsearch`` over a DLM1 file with the device-resident path.  The
same shared weights on both sides; transcripts and WER must be equal."""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamic_asr_eval_tpu.config import TTAConfig as JaxTTAConfig
from dynamic_asr_eval_tpu.evals import tlm_tools as jax_tools
from dynamic_asr_eval_tpu.lm import loader as jax_loader
from dynamic_asr_eval_tpu.lm.transformer_lm import TransformerLMConfig as JaxLMConfig
from dynamic_asr_eval_tpu.lm.transformer_lm import init_lm as jax_init_lm
from dynamic_asr_eval_tpu.models import ConformerConfig as JaxConfig
from dynamic_asr_eval_tpu.models import init_conformer as jax_init
from dynamic_asr_eval_tpu.text import CharTokenizer as JaxCharTokenizer
from dynamic_asr_eval_tpu.tta import DynamicEvalEngine as JaxEngine
from dynamic_asr_eval_tpu.tta.runner import EngineOutput as JaxEngineOutput
from dynamic_asr_eval_tpu_torch.config import TTAConfig
from dynamic_asr_eval_tpu_torch.evals import tlm_tools
from dynamic_asr_eval_tpu_torch.lm import loader
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, SCConformer, params_from_jax
from dynamic_asr_eval_tpu_torch.text import CharTokenizer
from dynamic_asr_eval_tpu_torch.tta import DynamicEvalEngine, EngineOutput

torch.set_num_threads(1)

CONFORMER = dict(feat_in=16, n_layers=2, d_model=32, n_heads=2, head_dim=16, vocab_size=28,
                 subsampling_factor=4, subsampling_conv_channels=8, conv_kernel_size=5)


def _records(n=3):
    return [{"id": f"r{i}", "text": "x",
             "process_fn": lambda rec, i=i: (
                 np.random.default_rng(i).standard_normal((16, 100 + 37 * i)).astype(np.float32),
                 "hello world")}
            for i in range(n)]


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Both packages' logit dumps of the same weights and records."""
    tmp = tmp_path_factory.mktemp("dumps")
    jcfg = JaxConfig(compute_dtype=jnp.float32, **CONFORMER)
    model, variables = jax_init(jcfg, jax.random.PRNGKey(0), example_T=64)
    tta = dict(seq_len=64, overlap=32, epochs=0, shuffle=False)
    jax_engine = JaxEngine(model, jcfg.blank_id, 4, JaxTTAConfig(**tta))
    port = SCConformer(ConformerConfig(compute_dtype="float32", **CONFORMER))
    state = params_from_jax(jax.tree.map(np.asarray, variables["params"]))
    port.load_state_dict(state)
    engine = DynamicEvalEngine(port, jcfg.blank_id, 4, TTAConfig(**tta), device="cpu")
    jax_paths = jax_tools.create_logits(jax_engine, variables, _records(), str(tmp / "jax"), 64, 32)
    paths = tlm_tools.create_logits(engine, state, _records(), str(tmp / "port"), 64, 32)
    return jax_paths, paths


@pytest.fixture(scope="module")
def char_lm(tmp_path_factory):
    """A tiny transformer LM over the char tokenizer as a DLM1 file."""
    cfg = JaxLMConfig(vocab_size=28, n_layers=1, d_model=32, n_heads=2, max_cache_length=8)
    _, variables = jax_init_lm(cfg, jax.random.PRNGKey(4))
    path = str(tmp_path_factory.mktemp("lm") / "chars.dlm")
    jax_loader.save_lm_checkpoint(path, variables, cfg)
    return path


def test_create_logits_dumps_what_jax_dumps(dumps):
    jax_paths, paths = dumps
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in jax_paths]
    for jp, pp in zip(jax_paths, paths):
        with open(jp, "rb") as f:
            j = pickle.load(f)
        with open(pp, "rb") as f:
            p = pickle.load(f)
        assert p["gold"] == j["gold"] == "hello world" and p["id"] == j["id"]
        assert p["logits"].shape == j["logits"].shape and p["logits"].shape[1] == 29
        np.testing.assert_allclose(p["logits"], j["logits"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["host_pool", "device_groups"])
def test_rescore_with_a_transformer_lm_equals_jax(dumps, char_lm, mode):
    """The host search over 2 threads, or the device search in groups of 2
    (the last group of 1: JAX pads it with an empty stream, the port does
    not), each against JAX's device-stream rescoring of its own dumps."""
    jax_paths, paths = dumps
    kw = dict(beam_width=4, alpha=0.5, beta=0.5, blank_collapse_threshold=None)
    want_wer, want = jax_tools.tlm_beam_rescore(
        jax_paths, lambda: jax_loader.load_lm_adapter(char_lm, JaxCharTokenizer()),
        JaxCharTokenizer(), use_device=True, stream_batch=2, segment_frames=16, **kw)
    factory = lambda: loader.load_lm_adapter(char_lm, CharTokenizer(), device="cpu")  # noqa: E731
    if mode == "host_pool":
        kw.pop("blank_collapse_threshold")
        wer, got = tlm_tools.tlm_beam_rescore(paths, factory, CharTokenizer(), num_workers=2,
                                              **kw)
    else:
        wer, got = tlm_tools.tlm_beam_rescore(paths, factory, CharTokenizer(), use_device=True,
                                              stream_batch=2, segment_frames=16, **kw)
    assert [d["hyp"] for d in got] == [d["hyp"] for d in want]
    assert any(d["hyp"] for d in got) and wer == pytest.approx(want_wer)


def test_stream_groups_never_change_results(dumps, char_lm):
    _, paths = dumps
    factory = lambda: loader.load_lm_adapter(char_lm, CharTokenizer(), device="cpu")  # noqa: E731
    kw = dict(beam_width=4, alpha=0.5, beta=0.5, use_device=True, segment_frames=8,
              blank_collapse_threshold=0.99)
    a = tlm_tools.tlm_beam_rescore(paths, factory, CharTokenizer(), stream_batch=3, **kw)
    b = tlm_tools.tlm_beam_rescore(paths, factory, CharTokenizer(), stream_batch=1, **kw)
    assert [d["hyp"] for d in a[1]] == [d["hyp"] for d in b[1]] and a[0] == b[0]


def test_grid_sorts_its_points_by_wer(dumps, char_lm, capsys):
    _, paths = dumps
    factory = lambda: loader.load_lm_adapter(char_lm, CharTokenizer(), device="cpu")  # noqa: E731
    res = tlm_tools.tlm_beam_grid(paths, factory, CharTokenizer(), alphas=(0.0, 0.5),
                                  betas=(0.5,), prunes=(3.17,), beam_width=3, num_workers=1)
    assert len(res) == 2 and res[0]["WER"] <= res[1]["WER"]
    assert capsys.readouterr().out.count("-> WER") == 2


def test_lm_prefill_ring_buffer_equals_jax(char_lm):
    """The cache length counts every consumed token; the ring keeps the last
    8; the log-probs after the prompt equal JAX's."""
    tok = CharTokenizer()
    model, cfg = loader.load_lm_checkpoint(char_lm)
    cache, lps = tlm_tools.lm_init_state_from_text(model, cfg, tok, "hello there friend")
    jmodel, jvars, jcfg = jax_loader.load_lm_checkpoint(char_lm)
    jcache, jlps = jax_tools.lm_init_state_from_text(jmodel, jvars, jcfg, JaxCharTokenizer(),
                                                     "hello there friend")
    assert int(cache["lengths"][0]) == len(tok.encode("hello there friend")) + 1
    assert lps.shape == (1, 28)
    np.testing.assert_allclose(lps.numpy(), np.asarray(jlps), rtol=0, atol=1e-4)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), rtol=0, atol=1e-4)


def test_lm_checkpoint_roundtrip_and_beamsearch_equal_jax(tmp_path, char_lm):
    """``load_beamsearch`` over a DLM1 file: the host-matrix and the
    engine-output paths give JAX's text, also with zero-count padding rows."""
    model, cfg = loader.load_lm_checkpoint(char_lm)
    path = str(tmp_path / "again.dlm")
    loader.save_lm_checkpoint(path, model, cfg)
    assert loader.load_lm_checkpoint(path)[1] == cfg and cfg.d_model == 32
    tok = CharTokenizer()
    V, blank = tok.vocab_size(), tok.blank_id
    frames = []
    for i in tok.encode("hi there"):
        frames += [i, blank]
    lp = np.full((len(frames), V + 1), -8.0, np.float32)
    for t, k in enumerate(frames):
        lp[t, k] = 0.0
    lp -= np.log(np.exp(lp).sum(-1, keepdims=True))
    fn = loader.load_beamsearch(path, tok, alpha=0.2, beta=0.1, device="cpu")
    jfn = jax_loader.load_beamsearch(char_lm, JaxCharTokenizer(), alpha=0.2, beta=0.1)
    text = fn(lp, beam_width=4)
    assert text == jfn(lp, beam_width=4) and text
    pad = 5
    padded = np.concatenate([lp, np.zeros((pad, V + 1), np.float32)])
    counts = np.concatenate([np.ones(lp.shape[0], np.float32), np.zeros(pad, np.float32)])
    out = EngineOutput(torch.from_numpy(padded), torch.from_numpy(counts), None, 0.0, blank)
    jout = JaxEngineOutput(jnp.asarray(padded), jnp.asarray(counts), None, 0.0, blank)
    assert fn.from_engine_output(out, beam_width=4) == text == jfn.from_engine_output(
        jout, beam_width=4)


def test_cli_dumps_then_rescores(tmp_path, char_lm, capsys):
    out_dir = str(tmp_path / "logits")
    paths = tlm_tools._cli(["dump", "-d", "synthetic", "-seq", "256", "-overlap", "128",
                            "-s", out_dir, "--device", "cpu"])
    assert paths and all(os.path.exists(p) for p in paths)
    wer = tlm_tools._cli(["rescore", "-logits", out_dir, "-lm", char_lm, "-beams", "3",
                          "--device", "cpu", "--stream_batch", "2"])
    assert np.isfinite(wer) and "WER:" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="no logit pickles"):
        tlm_tools._cli(["rescore", "-logits", str(tmp_path / "none"), "-lm", char_lm,
                        "--device", "cpu"])
