"""The port's utterance and wav2vec2 drivers against the JAX package's, on
``-d synthetic`` with shared weights.

- ``run_utterance_eval``: the scenario of
  tests/test_drivers.py::TestUtteranceDriver (128-frame segments, one
  online epoch) on the tiny f32 conformer of tests/test_torch_protocols.py,
  the JAX driver's model injected through its ``load_model_and_tokenizer``
  and its params handed to the port (``jax_params``); also with
  ``--accumulate_gradients 2 --prob_collection final``.
- ``run_wav2vec2``: the scenarios of TestWav2Vec2Driver (chunked, one
  online epoch at the remapped 48000 / 16000 samples; ``--per_utterance``
  with ``ctc_mean`` and clip 10), the port's tiny model's weights read into
  JAX by JAX's own ``load_hf_weights`` (injected through its
  ``init_wav2vec2``) and handed to the port as a ``--checkpoint`` of that
  state dict.  The waveform
  augmentation's draws cannot match across frameworks, so both drivers get
  the same fixed perturbation in place of ``wav_augment_pipeline``.

Transcripts, WERs and the pickles' detail must be identical, and the
pickles' keys the same (the port's ``args_dict`` adds ``device``).  Every
port entry point runs with ``--device cpu``.
"""

import pickle

import numpy as np
import pytest
import torch

import dynamic_asr_eval_tpu.augment.waveform as jax_waveform
import dynamic_asr_eval_tpu.evals.run_utterance_eval as jax_utt
import dynamic_asr_eval_tpu.evals.run_wav2vec2 as jax_w2v
import dynamic_asr_eval_tpu.models.wav2vec2 as jax_w2v_model
from dynamic_asr_eval_tpu_torch.evals import run_utterance_eval, run_wav2vec2
from dynamic_asr_eval_tpu_torch.models import wav2vec2 as port_w2v_model
from dynamic_asr_eval_tpu_torch.text import CharTokenizer
from test_torch_protocols import DETAIL_KEYS, rolled_scans, run_both

torch.set_num_threads(1)

UTT_FLAGS = {"default": [], "acc2_final": ["--accumulate_gradients", "2",
                                           "--prob_collection", "final"]}


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def assert_same_run(jax_out, port_out, j, p):
    assert port_out == jax_out and np.isfinite(port_out)
    for key in DETAIL_KEYS:
        assert p[key] == j[key], key
    assert set(p) == set(j)
    assert set(p["args_dict"]) - set(j["args_dict"]) == {"device"}


@pytest.mark.parametrize("flags", sorted(UTT_FLAGS))
def test_utterance_driver_matches_jax(flags, tmp_path):
    jax_out, port_out = run_both(
        jax_utt, run_utterance_eval,
        lambda side: ["-d", "synthetic", "--quiet", "--segment_frames", "128",
                      "-s", str(tmp_path / f"{side}.pkl")] + UTT_FLAGS[flags])
    j, p = load(tmp_path / "jax_1.pkl"), load(tmp_path / "port_1.pkl")
    assert_same_run(jax_out, port_out, j, p)
    assert len(p["model_output"]) == 3 and any(p["model_output"])


def test_segment_spec_matches_jax():
    spec = np.random.default_rng(0).standard_normal((1, 8, 1000)).astype(np.float32)
    for frames in (128, 333, 2000):
        ours, ref = run_utterance_eval.segment_spec(spec, frames), jax_utt.segment_spec(spec,
                                                                                        frames)
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a["spectrogram"], b["spectrogram"])


def _fixed(W):
    return 0.01 * np.random.default_rng(W).standard_normal(W).astype(np.float32)


def jax_pipeline(wave, key, n_time_dropout=100, *args, **kwargs):
    return 0.8 * wave + _fixed(wave.shape[-1])


def port_pipeline(wave, generator, n_time_dropout=100, *args, **kwargs):
    return 0.8 * wave + torch.from_numpy(_fixed(wave.shape[-1]))


# the drivers' tiny wav2vec2 (input normalized, as without --raw_input)
W2V_TINY = dict(vocab_size=CharTokenizer().vocab_size() + 1, hidden=64, n_layers=2, n_heads=2,
                ff_dim=128, conv_dim=32, pos_conv_kernel=16, pos_conv_groups=4,
                normalize_input=True)
W2V_FLAGS = {"chunked": ["-kwargs", "epochs=1", "online=true"],
             "per_utterance": ["--per_utterance", "-kwargs", "epochs=1"]}


@pytest.mark.parametrize("mode", sorted(W2V_FLAGS))
def test_wav2vec2_driver_matches_jax(mode, tmp_path, monkeypatch):
    state = port_w2v_model.init_wav2vec2(port_w2v_model.Wav2Vec2Config(**W2V_TINY),
                                         seed=5).state_dict()
    jcfg = jax_w2v_model.Wav2Vec2Config(**W2V_TINY)
    variables = jax_w2v_model.load_hf_weights(state, jcfg)
    model = jax_w2v_model.Wav2Vec2ForCTC(jcfg)
    monkeypatch.setattr(jax_w2v_model, "init_wav2vec2", lambda cfg, rng, example_T: (
        model if cfg == jcfg else pytest.fail(f"JAX driver built {cfg}"), variables))
    monkeypatch.setattr(jax_waveform, "wav_augment_pipeline", jax_pipeline)
    monkeypatch.setattr(run_wav2vec2, "wav_augment_pipeline", port_pipeline)
    argv = ["-d", "synthetic", "--quiet"]
    with rolled_scans():
        jax_out = jax_w2v.cli(argv + ["-s", str(tmp_path / "jax.pkl")] + W2V_FLAGS[mode])
    torch.save(state, tmp_path / "w.pt")
    port_out = run_wav2vec2.cli(
        argv + ["-s", str(tmp_path / "port.pkl"), "--device", "cpu", "--checkpoint",
                str(tmp_path / "w.pt")] + W2V_FLAGS[mode])
    j, p = load(tmp_path / "jax_1.pkl"), load(tmp_path / "port_1.pkl")
    assert_same_run(jax_out, port_out, j, p)
    assert len(p["model_output"]) == 2 and any(p["model_output"])
    assert p["args_dict"]["seq_len"] == 48000 and p["args_dict"]["overlap"] == 16000


def test_wav2vec2_driver_reads_an_hf_checkpoint(tmp_path):
    """``--checkpoint`` with an HF-named torch state dict (weight-normed
    positional conv, a ``module.`` prefix): the driver runs the weights it
    holds, and gives what the same weights in the plain layout give."""
    cfg = run_wav2vec2.default_config(run_wav2vec2.parse_args([]), CharTokenizer())
    assert cfg == port_w2v_model.Wav2Vec2Config(**W2V_TINY)
    state = port_w2v_model.init_wav2vec2(cfg, seed=7).state_dict()
    torch.save(state, tmp_path / "plain.pt")
    pos = "wav2vec2.encoder.pos_conv_embed.conv"
    w = state.pop(f"{pos}.weight")
    g = w.pow(2).sum((0, 1), keepdim=True).sqrt()
    state[f"{pos}.parametrizations.weight.original0"] = g
    state[f"{pos}.parametrizations.weight.original1"] = w
    path = tmp_path / "hf.pt"
    torch.save({"module." + k: v for k, v in state.items()}, path)
    flags = ["-d", "synthetic", "--quiet", "--device", "cpu", "--per_utterance",
             "-kwargs", "epochs=0"]
    from_file = run_wav2vec2.cli(flags + ["--checkpoint", str(path), "-s",
                                          str(tmp_path / "a.pkl")])
    from_plain = run_wav2vec2.cli(flags + ["--checkpoint", str(tmp_path / "plain.pt"), "-s",
                                           str(tmp_path / "b.pkl")])
    a, b = load(tmp_path / "a_1.pkl"), load(tmp_path / "b_1.pkl")
    assert from_file == from_plain and a["model_output"] == b["model_output"]
    assert any(a["model_output"])
