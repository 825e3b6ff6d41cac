"""The port's wav2vec2-CTC model and waveform augmentation against the JAX
package's, and the model against HuggingFace ``transformers``.

- The model at a tiny width (2 layers × 64, conv 32, positional conv 16 in
  4 groups) in f32, the JAX side's weights from JAX's own
  ``load_hf_weights(port_model.state_dict(), cfg)``: log-probs within 1e-4
  on the valid frames, for ``stable_layer_norm`` False and True and
  ``normalize_input`` off and on, on an unpadded and a padded batch (the
  masked group norm leaves padding out of its statistics in both).
- ``load_hf_weights`` on the three layouts of the weight-normed positional
  convolution (``parametrizations.weight.original0/1``, ``weight_g`` /
  ``weight_v``, plain ``weight``) against JAX's reading of the same dict.
- HF's ``Wav2Vec2ForCTC`` built from a config (no download), group norm, no
  conv bias: the port within 1e-4 of its log-softmax on unpadded input,
  base and stable layer norm.
- ``simple_reverb`` exactly as JAX's; ``time_dropout`` and
  ``additive_noise`` by their properties (their draws cannot match JAX's).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamic_asr_eval_tpu.augment import waveform as jax_waveform
from dynamic_asr_eval_tpu.models import wav2vec2 as J
from dynamic_asr_eval_tpu_torch.augment import waveform
from dynamic_asr_eval_tpu_torch.models import wav2vec2 as P

torch.set_num_threads(1)

TINY = dict(vocab_size=29, hidden=64, n_layers=2, n_heads=2, ff_dim=128, conv_dim=32,
            pos_conv_kernel=16, pos_conv_groups=4)
SAMPLES = 8000
POS = "wav2vec2.encoder.pos_conv_embed.conv"


def both(**kw):
    """(port model, its state dict, JAX model, JAX variables from JAX's
    load_hf_weights of that state dict)."""
    pc, jc = P.Wav2Vec2Config(**TINY, **kw), J.Wav2Vec2Config(**TINY, **kw)
    model = P.init_wav2vec2(pc, seed=3)
    state = model.state_dict()
    return model, state, J.Wav2Vec2ForCTC(jc), J.load_hf_weights(state, jc), pc, jc


def waves(B=2, n=SAMPLES, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal((B, n))).astype(np.float32)


@pytest.mark.parametrize("stable", [False, True], ids=["base", "stable"])
@pytest.mark.parametrize("normalize", [False, True], ids=["raw", "normalized"])
@pytest.mark.parametrize("lengths", [(SAMPLES, SAMPLES), (SAMPLES, 5555)], ids=["full", "padded"])
def test_log_probs_match_jax(stable, normalize, lengths):
    model, _, jmodel, jvars, pc, jc = both(stable_layer_norm=stable, normalize_input=normalize)
    x, lens = waves(), np.asarray(lengths)
    ref = jmodel.apply(jvars, jnp.asarray(x), length=jnp.asarray(lens))
    with torch.no_grad():
        out = model(torch.from_numpy(x)[:, None, :], torch.from_numpy(lens))
    n_valid = [int(P.feat_extract_output_lengths(pc, int(n))) for n in lengths]
    assert out["length"].tolist() == np.asarray(ref["length"]).tolist() == n_valid
    assert out["final_posteriors"].shape == (2, n_valid[0], TINY["vocab_size"])
    assert out["final_posteriors"].dtype == torch.float32
    for i, n in enumerate(n_valid):
        np.testing.assert_allclose(out["final_posteriors"][i, :n].numpy(),
                                   np.asarray(ref["final_posteriors"])[i, :n], rtol=0, atol=1e-4)
        np.testing.assert_allclose(out["a_hidden"][i, :n].numpy(),
                                   np.asarray(ref["a_hidden"])[i, :n], rtol=0, atol=1e-4)


def test_padding_leaves_valid_frames_as_unpadded():
    """The masked group norm and the normalization read valid samples only:
    a padded row gives the frames of the same wave unpadded."""
    model, *_ = both(normalize_input=True)
    x = waves(1, 5555)
    padded = np.zeros((1, SAMPLES), np.float32)
    padded[:, :5555] = x
    with torch.no_grad():
        a = model(torch.from_numpy(x), torch.tensor([5555]))
        b = model(torch.from_numpy(padded), torch.tensor([5555]))
    n = int(a["length"][0])
    assert n == int(b["length"][0]) and b["final_posteriors"].shape[1] > n
    torch.testing.assert_close(b["final_posteriors"][:, :n], a["final_posteriors"],
                               rtol=0, atol=1e-5)


def test_checkpoint_round_trip_is_exact(tmp_path):
    """The port's state dict saved with ``torch.save`` (as the drivers'
    ``--checkpoint`` reads it) comes back through ``load_torch_checkpoint``
    and ``load_hf_weights`` bit for bit."""
    from dynamic_asr_eval_tpu_torch.models.checkpoint import load_torch_checkpoint

    _, state, _, _, pc, _ = both()
    torch.save(state, tmp_path / "w.pt")
    loaded, _ = load_torch_checkpoint(str(tmp_path / "w.pt"))
    back = P.load_hf_weights(loaded, pc)
    assert set(back) == set(state)
    for k in state:
        assert torch.equal(back[k], state[k]), k


@pytest.mark.parametrize("n", [400, 401, 8000, 48000, 65536])
def test_output_lengths_match_jax(n):
    pc, jc = P.Wav2Vec2Config(), J.Wav2Vec2Config()
    assert P.feat_extract_output_lengths(pc, n) == J.feat_extract_output_lengths(jc, n)
    assert pc.downsampling_factor == jc.downsampling_factor == 320


def _layouts(state):
    """The positional conv as HF writes it, in the three layouts, with
    a DDP ``module.`` prefix on one of them."""
    g = torch.Generator().manual_seed(4)
    v = torch.randn(state[f"{POS}.weight"].shape, generator=g)
    mag = 0.5 + torch.rand((1, 1, v.shape[2]), generator=g)
    base = {k: v_ for k, v_ in state.items() if k != f"{POS}.weight"}
    base["wav2vec2.masked_spec_embed"] = torch.zeros(TINY["hidden"])
    plain = dict(base, **{f"{POS}.weight": mag * v / v.pow(2).sum((0, 1), keepdim=True).sqrt()})
    return {
        "parametrizations": dict(base, **{f"{POS}.parametrizations.weight.original0": mag,
                                          f"{POS}.parametrizations.weight.original1": v}),
        "weight_g_v": {"module." + k: x for k, x in
                       dict(base, **{f"{POS}.weight_g": mag, f"{POS}.weight_v": v}).items()},
        "plain": plain,
    }


@pytest.mark.parametrize("layout", ["parametrizations", "weight_g_v", "plain"])
def test_load_hf_weights_reads_every_pos_conv_layout(layout):
    _, state, *_, pc, jc = both()
    sd = _layouts(state)[layout]
    ours = P.load_hf_weights(sd, pc)
    ref = J.load_hf_weights(sd, jc)["params"]
    np.testing.assert_allclose(ours[f"{POS}.weight"].permute(2, 1, 0).numpy(),
                               np.asarray(ref["pos_conv"]["kernel"]), rtol=0, atol=1e-6)
    expect = _layouts(state)["plain"][f"{POS}.weight"]
    torch.testing.assert_close(ours[f"{POS}.weight"], expect, rtol=0, atol=1e-6)
    assert set(ours) == set(state)  # masked_spec_embed left out
    model = P.Wav2Vec2ForCTC(pc)
    model.load_state_dict(ours, strict=True)


def test_load_hf_weights_names_missing_keys():
    _, state, *_, pc, _ = both()
    sd = {k: v for k, v in state.items() if not k.startswith("lm_head")}
    with pytest.raises(KeyError, match="lm_head"):
        P.load_hf_weights(sd, pc)


@pytest.mark.parametrize("stable", [False, True], ids=["base", "stable"])
def test_matches_huggingface(stable):
    transformers = pytest.importorskip("transformers")
    hc = transformers.Wav2Vec2Config(
        vocab_size=TINY["vocab_size"], hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=128, conv_dim=(32,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
        conv_stride=(5, 2, 2, 2, 2, 2, 2), conv_bias=False, feat_extract_norm="group",
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, do_stable_layer_norm=stable,
        layer_norm_eps=1e-5)
    torch.manual_seed(0)
    hf = transformers.Wav2Vec2ForCTC(hc).eval()
    pc = P.Wav2Vec2Config(**TINY, stable_layer_norm=stable)
    model = P.Wav2Vec2ForCTC(pc).eval()
    model.load_state_dict(P.load_hf_weights(hf.state_dict(), pc), strict=True)
    x = torch.from_numpy(waves())
    with torch.no_grad():
        ref = torch.log_softmax(hf(x).logits, dim=-1)
        out = model(x)["final_posteriors"]
    assert out.shape == ref.shape
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# waveform augmentation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reverberance,delay_ms", [(0.5, 40.0), (0.9, 5.0), (2.0, 40.0)])
def test_simple_reverb_equals_jax(reverberance, delay_ms):
    x = waves(1, 4000)[0]
    ref = jax_waveform.simple_reverb(jnp.asarray(x), jax.random.PRNGKey(0),
                                     reverberance=reverberance, delay_ms=delay_ms)
    out = waveform.simple_reverb(torch.from_numpy(x), reverberance=reverberance,
                                 delay_ms=delay_ms)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    batched = waveform.simple_reverb(torch.from_numpy(np.stack([x, x])), reverberance=reverberance,
                                     delay_ms=delay_ms)
    assert torch.equal(batched[0], out) and torch.equal(batched[1], out)


def _boxes(zeroed: np.ndarray):
    """Runs of zeros: [(start, width)]."""
    edges = np.diff(np.concatenate([[0], zeroed.astype(np.int8), [0]]))
    starts, ends = np.flatnonzero(edges == 1), np.flatnonzero(edges == -1)
    return list(zip(starts, ends - starts))


def test_time_dropout_zeroes_boxes_no_wider_than_max_seconds():
    sr, max_s, n_boxes = 16000, 0.01, 5
    x = torch.from_numpy(np.abs(waves(3, 48000)) + 0.5)  # no zero of its own
    out = waveform.time_dropout(x, torch.Generator().manual_seed(0), n_boxes, max_s, sr)
    for row_in, row in zip(x, out):
        zeroed = (row == 0).numpy()
        assert zeroed.any()
        assert torch.equal(row[~torch.from_numpy(zeroed)], row_in[~torch.from_numpy(zeroed)])
        runs = _boxes(zeroed)
        # overlapping boxes merge, so a run is at most n_boxes boxes wide
        assert 1 <= len(runs) <= n_boxes
        assert sum(w for _, w in runs) <= n_boxes * (int(max_s * sr) - 1)
    assert not torch.equal(out[0] == 0, out[1] == 0)  # each row its own boxes


def test_time_dropout_box_widths_stay_below_the_limit():
    """One box per row, many rows: every zeroed run narrower than
    ``max_seconds`` (JAX draws widths in [0, max_w))."""
    sr, max_s = 16000, 0.005
    x = torch.ones(200, 4000)
    out = waveform.time_dropout(x, torch.Generator().manual_seed(1), 1, max_s, sr)
    widths = [w for row in out for _, w in _boxes((row == 0).numpy())]
    assert widths and max(widths) < int(max_s * sr) and len(widths) <= 200


def test_additive_noise_snr_is_in_range_and_rows_are_independent():
    x = torch.from_numpy(waves(64, 16000))
    out = waveform.additive_noise(x, torch.Generator().manual_seed(2))
    noise = out - x
    snr = 10 * torch.log10((x ** 2).mean(1) / (noise ** 2).mean(1))
    assert snr.min() >= 10 - 0.5 and snr.max() <= 30 + 0.5  # finite-sample noise power
    assert snr.max() - snr.min() > 5  # one SNR draw per row
    corr = np.corrcoef(noise[:2].numpy())[0, 1]
    assert abs(corr) < 0.05


def test_pipeline_on_a_batch_draws_per_row():
    x = torch.from_numpy(np.repeat(waves(1, 16000), 2, axis=0))
    g = torch.Generator().manual_seed(3)
    out = waveform.wav_augment_pipeline(x, g, n_time_dropout=10)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert not torch.equal(out[0], out[1])
    one = waveform.wav_augment_pipeline(x[0], torch.Generator().manual_seed(3), n_time_dropout=10)
    assert one.shape == x[0].shape and not torch.equal(one, x[0])
    dry = waveform.wav_augment_pipeline(x[0], torch.Generator().manual_seed(3), n_time_dropout=0,
                                        noise=False, reverb=False)
    assert torch.equal(dry, x[0]) and math.isfinite(float(dry.sum()))
