"""The port's encoder-decoder model (``models/encdec.py``) and its loaders
against the JAX package's, on shared weights.

The port's model is drawn from a seed and handed to JAX through JAX's own
``convert_encdec_checkpoint`` (the port carries the reference enc-dec
names), at the tiny f32 widths of tests/test_encdec.py.  Held:

- the forward: ``a_hidden`` and the CTC log-probs on valid frames, the
  decoder's logits on valid text positions, within 1e-4, on a ragged batch,
  also with a decoder wider than the encoder;
- ``decode_step`` with the KV cache against the full forward at each
  position;
- greedy ``generate_encdec``: tokens and lengths equal to JAX's;
- sampled generation by its properties (no draw can match across
  frameworks): zeros past ``length``, EOS retirement, repeatable from a
  seed, the logits multiplied by ``temperature``;
- ``encdec_params_from_jax`` / ``encdec_params_to_jax`` round trip;
- ``infer_encdec_decoder_dims`` equal to JAX's; a ``TorchEncDec`` pickle
  through both packages' ``load_encdec_torch_checkpoint``: equal configs,
  logits within 1e-4.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dynamic_asr_eval_tpu.models.checkpoint as jax_ckpt
from dynamic_asr_eval_tpu.models.conformer import ConformerConfig as JaxConformerConfig
from dynamic_asr_eval_tpu.models.convert import convert_encdec_checkpoint
from dynamic_asr_eval_tpu.models.encdec import EncDecConfig as JaxEncDecConfig
from dynamic_asr_eval_tpu.models.encdec import EncDecConformer as JaxEncDec
from dynamic_asr_eval_tpu.models.encdec import generate_encdec as jax_generate
from dynamic_asr_eval_tpu_torch.models import checkpoint as port_ckpt
from dynamic_asr_eval_tpu_torch.models.conformer import ConformerConfig
from dynamic_asr_eval_tpu_torch.models.convert import (
    encdec_params_from_jax,
    encdec_params_to_jax,
)
from dynamic_asr_eval_tpu_torch.models.encdec import EncDecConfig, generate_encdec, init_encdec
from torch_oracles import TorchEncDec

torch.set_num_threads(1)

# tests/test_encdec.py's widths
ENC = dict(feat_in=16, n_layers=1, d_model=32, n_heads=2, head_dim=16, vocab_size=29,
           subsampling_factor=4, subsampling_conv_channels=8, conv_kernel_size=5)
DEC = dict(decoder_layers=1, decoder_d_model=32, decoder_heads=2, max_text_len=32)
CFG = EncDecConfig(encoder=ConformerConfig(compute_dtype="float32", **ENC), **DEC)
JCFG = JaxEncDecConfig(encoder=JaxConformerConfig(compute_dtype=jnp.float32, **ENC), **DEC)
TOL = 1e-4
MAX_GENERATE = 12
# (seed of the input, its length in frames of 64): generation inputs
GEN_CASES = ((1, 64), (2, 40), (3, 64))


def jax_variables(model):
    variables, unmatched = convert_encdec_checkpoint(
        {k: v.detach().numpy() for k, v in model.state_dict().items()})
    assert unmatched == []
    return variables


@pytest.fixture(scope="module")
def shared():
    model = init_encdec(CFG, seed=3).eval()
    return model, JaxEncDec(JCFG), jax_variables(model)


def audio(seed, batch=1, T=64):
    return np.random.default_rng(seed).standard_normal((batch, 16, T)).astype(np.float32)


# a decoder of another width than the encoder's (cross_kv reads the encoder's)
WIDE = dict(DEC, decoder_d_model=48, decoder_heads=3)


@pytest.fixture(scope="module", params=["test_encdec_widths", "decoder_48_wide"])
def forward_pair(request, shared):
    if request.param == "test_encdec_widths":
        return shared
    cfg = EncDecConfig(encoder=CFG.encoder, **WIDE)
    model = init_encdec(cfg, seed=4).eval()
    jcfg = JaxEncDecConfig(encoder=JCFG.encoder, **WIDE)
    return model, JaxEncDec(jcfg), jax_variables(model)


def test_forward_matches_jax_on_valid_frames_and_positions(forward_pair):
    model, jmodel, variables = forward_pair
    x = audio(0, batch=2)
    lengths, txt, txt_len = np.array([64, 40]), np.array([[0, 3, 5, 7], [0, 2, 9, 9]]), \
        np.array([4, 2])
    ref = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(txt), length=jnp.asarray(lengths),
                       text_lengths=jnp.asarray(txt_len))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(txt), length=torch.from_numpy(lengths),
                    text_lengths=torch.from_numpy(txt_len))
    assert set(out) == set(ref)
    np.testing.assert_array_equal(out["length"].numpy(), np.asarray(ref["length"]))
    for i, n in enumerate(out["length"].tolist()):
        for key in ("a_hidden", "final_posteriors_ctc"):
            np.testing.assert_allclose(out[key][i, :n].numpy(), np.asarray(ref[key])[i, :n],
                                       atol=TOL, rtol=0)
        np.testing.assert_allclose(out["final_posteriors_lm"][i, :txt_len[i]].numpy(),
                                   np.asarray(ref["final_posteriors_lm"])[i, :txt_len[i]],
                                   atol=TOL, rtol=0)


def test_decode_step_with_the_cache_equals_the_full_forward(shared):
    model = shared[0]
    x = torch.from_numpy(audio(4))
    tokens = torch.tensor([[0, 5, 17, 5, 2, 28, 11]])
    with torch.no_grad():
        enc = model.encode(x)
        full = model.decode(tokens, enc["a_hidden"], enc["length"])["logits"][0]
        L, N, H, D = CFG.decoder_layers, tokens.shape[1] + 1, CFG.decoder_heads, CFG.head_dim
        cache = {"k": torch.zeros(L, 1, N, H, D), "v": torch.zeros(L, 1, N, H, D)}
        for i in range(tokens.shape[1]):
            step = model.decode_step(tokens[:, i], enc["a_hidden"], enc["length"], cache,
                                     torch.tensor([i]))
            np.testing.assert_allclose(step["logits"][0, 0].numpy(), full[i].numpy(), atol=1e-5,
                                       rtol=0)


@pytest.fixture(scope="module")
def jax_greedy(shared):
    _, jmodel, variables = shared
    return {case: jax_generate(jmodel, variables, jnp.asarray(audio(case[0])), JCFG,
                               max_generate=MAX_GENERATE, length=jnp.asarray([case[1]]))[:2]
            for case in GEN_CASES}


@pytest.mark.parametrize("case", GEN_CASES, ids=[f"seed{s}_len{n}" for s, n in GEN_CASES])
def test_greedy_generation_matches_jax(case, shared, jax_greedy):
    toks, lens, _ = generate_encdec(shared[0], torch.from_numpy(audio(case[0])), CFG,
                                    max_generate=MAX_GENERATE, length=torch.tensor([case[1]]))
    want_toks, want_lens = jax_greedy[case]
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_lens))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want_toks))
    assert toks.shape == (1, MAX_GENERATE)


def sampled(model, temperature=1.0, seed=7, sample=16, max_generate=MAX_GENERATE, cfg=CFG):
    return generate_encdec(model, torch.from_numpy(audio(5)), cfg, sample=sample, greedy=False,
                           temperature=temperature, max_generate=max_generate,
                           generator=torch.Generator().manual_seed(seed))[:2]


def test_sampled_generation_retires_at_eos_and_zeroes_past_the_length(shared):
    toks, lens = sampled(shared[0])
    assert toks.shape == (16, MAX_GENERATE) and lens.dtype == torch.int32
    assert int(lens.max()) <= MAX_GENERATE - 1  # the last step retires every sample
    for row, n in zip(toks.tolist(), lens.tolist()):
        assert CFG.eos_id not in row[:n]  # EOS retires: no EOS inside the emitted tokens
        assert all(t == 0 for t in row[n:])
    assert len(set(map(tuple, toks.tolist()))) > 1, "the samples should differ"


def test_sampled_generation_is_repeatable_from_a_seed(shared):
    a, b, c = sampled(shared[0]), sampled(shared[0]), sampled(shared[0], seed=8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])


def test_sampled_generation_multiplies_the_logits_by_the_temperature(shared):
    """Temperature 2 on the model equals temperature 1 on a model whose head
    is doubled (exact in floating point), draw for draw; a division would
    equal a halved head instead."""
    model = shared[0]
    doubled = copy.deepcopy(model)
    with torch.no_grad():
        doubled.head.weight.mul_(2.0)
        doubled.head.bias.mul_(2.0)
    hot, ref = sampled(model, temperature=2.0), sampled(doubled)
    assert torch.equal(hot[0], ref[0]) and torch.equal(hot[1], ref[1])
    assert not torch.equal(sampled(model)[0], hot[0])


def test_encdec_params_round_trip_through_the_jax_layout(shared):
    model, _, variables = shared
    back = encdec_params_from_jax(jax.tree.map(np.asarray, variables))
    state = model.state_dict()
    assert set(back) == set(state)
    assert all(torch.equal(back[k], state[k]) for k in state)
    ported = encdec_params_to_jax(state)
    flat = jax.tree_util.tree_leaves_with_path(ported)
    want = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, variables)))
    assert len(flat) == len(want)
    for path, leaf in flat:
        np.testing.assert_array_equal(leaf, want[path])


def test_infer_encdec_decoder_dims_matches_jax(shared):
    state = {k: v.numpy() for k, v in shared[0].state_dict().items()}
    dec = {k: v for k, v in state.items() if not k.startswith("encoder.")}
    for s in (state, dec, {k: v for k, v in dec.items() if not k.startswith("pos_enc")}, {}):
        assert port_ckpt.infer_encdec_decoder_dims(s) == jax_ckpt.infer_encdec_decoder_dims(s)


PICKLE_DIMS = dict(feat_in=16, n_layers=2, d_model=32, n_heads=2, head_dim=16, vocab_size=29,
                   subsampling_factor=4, subsampling_conv_channels=8, conv_kernel_size=5)


@pytest.mark.parametrize("with_config", [True, False], ids=["config", "weights_only"])
def test_a_reference_pickle_loads_alike_in_both_packages(with_config, tmp_path, capsys):
    """``{'model', 'config'}`` (the config names the encoder's head split and
    the decoder's heads) or a bare state dict (both loaders then assume the
    head splits and warn alike)."""
    torch.manual_seed(11)
    twin = TorchEncDec(PICKLE_DIMS, decoder_layers=2, decoder_d_model=32, decoder_heads=2,
                       max_text_len=16)
    path = str(tmp_path / "ed.pt")
    config = {"model": {"encoder": {"n_heads": 2, "head_dim": 16, "subsampling_factor": 4},
                        "decoder_heads": 2}}
    torch.save({"model": twin.state_dict(), "config": config} if with_config
               else twin.state_dict(), path)
    jmodel, jvars, jcfg = jax_ckpt.load_encdec_torch_checkpoint(path, compute_dtype=jnp.float32)
    jax_err = capsys.readouterr().err
    model, params, cfg = port_ckpt.load_encdec_torch_checkpoint(path, compute_dtype="float32")
    port_err = capsys.readouterr().err
    enc, jenc = dataclasses.asdict(cfg.encoder), dataclasses.asdict(jcfg.encoder)
    enc.pop("compute_dtype"), jenc.pop("compute_dtype")
    assert enc == jenc
    assert cfg.encoder.compute_dtype == torch.float32 and \
        np.dtype(jcfg.encoder.compute_dtype) == np.float32
    assert {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "encoder"} \
        == {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "encoder"}
    assert ("WARNING" in port_err) == ("WARNING" in jax_err) == (not with_config)
    assert all(torch.equal(params[k], v) for k, v in twin.state_dict().items())
    x, txt = audio(6), np.array([[0, 4, 8, 15]])
    ref = jmodel.apply(jvars, jnp.asarray(x), jnp.asarray(txt))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(txt))
    for key in ("final_posteriors_ctc", "final_posteriors_lm"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=TOL, rtol=0)
