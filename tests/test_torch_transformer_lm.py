"""The port's transformer LM (``lm/transformer_lm.py``), its weight
conversion (``models/convert.py``) and its checkpoints (``lm/loader.py``)
against the JAX package's, on the same weights.

Bars: per-step log-probs within 1e-4 of JAX's ``TransformerLM`` (ring
eviction past ``max_cache_length`` and ``write_mask`` rows included) and of
the torch oracle's full causal forward (tests/torch_oracles.py); bf16
compute within JAX's own bf16 error against f32; DLM1 files byte-identical
to JAX's in both directions; the lming torch-pickle loader giving JAX's
configuration and weights, with its warning and both of its raises."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamic_asr_eval_tpu.lm import loader as jax_loader
from dynamic_asr_eval_tpu.lm.transformer_lm import TransformerLMConfig as JaxLMConfig
from dynamic_asr_eval_tpu.lm.transformer_lm import empty_cache as jax_empty_cache
from dynamic_asr_eval_tpu.lm.transformer_lm import init_lm as jax_init_lm
from dynamic_asr_eval_tpu.lm.transformer_lm import lm_score_sequence as jax_score
from dynamic_asr_eval_tpu.text import CharTokenizer as JaxCharTokenizer
from dynamic_asr_eval_tpu_torch.lm import loader
from dynamic_asr_eval_tpu_torch.lm.transformer_lm import (
    TransformerLM,
    TransformerLMConfig,
    empty_cache,
    init_lm,
    lm_score_sequence,
)
from dynamic_asr_eval_tpu_torch.models.convert import lm_params_from_jax, lm_params_to_jax
from dynamic_asr_eval_tpu_torch.text import CharTokenizer

sys.path.insert(0, os.path.dirname(__file__))
from torch_oracles import TorchTransformerLM  # noqa: E402

torch.set_num_threads(1)

VOCAB, LAYERS, D, HEADS = 30, 2, 32, 2
TOL = 1e-4


def jax_lm(n_cache=16, dtype=jnp.float32, seed=0):
    cfg = JaxLMConfig(vocab_size=VOCAB, n_layers=LAYERS, d_model=D, n_heads=HEADS,
                      max_cache_length=n_cache, compute_dtype=dtype)
    model, variables = jax_init_lm(cfg, jax.random.PRNGKey(seed))
    return cfg, model, variables


def port_lm(variables, n_cache=16, dtype=torch.float32):
    cfg = TransformerLMConfig(vocab_size=VOCAB, n_layers=LAYERS, d_model=D, n_heads=HEADS,
                              max_cache_length=n_cache, compute_dtype=dtype)
    model = TransformerLM(cfg)
    model.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, variables["params"])))
    return cfg, model.eval()


def step_both(jax_side, port_side, toks, masks=None):
    """Run both LMs over ``toks`` [B, T]; returns their log-probs [B, T, V]
    and final caches."""
    (jcfg, jmodel, variables), (pcfg, pmodel) = jax_side, port_side
    B, T = toks.shape
    jc, pc = jax_empty_cache(jcfg, B), empty_cache(pcfg, B)
    step = jax.jit(lambda v, t, c, m: jmodel.apply(v, t, c, write_mask=m))
    got, want = [], []
    with torch.no_grad():
        for t in range(T):
            m = None if masks is None else masks[:, t]
            jl, jc = step(variables, jnp.asarray(toks[:, t]), jc,
                          None if m is None else jnp.asarray(m))
            pl, pc = pmodel(torch.as_tensor(toks[:, t]), pc,
                            None if m is None else torch.as_tensor(m))
            want.append(np.asarray(jl))
            got.append(pl.float().numpy())
    return np.stack(got, 1), np.stack(want, 1), pc, jc


@pytest.mark.parametrize("n_cache,T", [(16, 12), (6, 14), (5, 23)],
                         ids=["no_eviction", "eviction", "two_wraps"])
@pytest.mark.parametrize("masked", [False, True], ids=["all_write", "write_mask"])
def test_step_log_probs_match_jax(n_cache, T, masked):
    j = jax_lm(n_cache)
    p = port_lm(j[2], n_cache)
    rng = np.random.default_rng(n_cache + T)
    toks = rng.integers(0, VOCAB, (3, T))
    masks = rng.random((3, T)) < 0.6 if masked else None
    got, want, pc, jc = step_both(j, p, toks, masks)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(pc["lengths"].numpy(), np.asarray(jc["lengths"]))
    np.testing.assert_allclose(pc["k"].numpy(), np.asarray(jc["k"]), rtol=0, atol=TOL)
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, rtol=1e-4)


def test_step_log_probs_match_the_torch_oracle_full_causal_forward():
    """The oracle attends over every earlier position at once; the port steps
    through its ring cache (no eviction at N >= T)."""
    torch.manual_seed(0)
    oracle = TorchTransformerLM(vocab_size=VOCAB, n_layers=LAYERS, d_model=D,
                                n_heads=HEADS).eval()
    cfg = TransformerLMConfig(vocab_size=VOCAB, n_layers=LAYERS, d_model=D, n_heads=HEADS,
                              max_cache_length=16)
    model = TransformerLM(cfg).eval()
    model.load_state_dict(oracle.state_dict())
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, VOCAB, (2, 12)))
    with torch.no_grad():
        want = oracle(toks)
        cache, got = empty_cache(cfg, 2), []
        for t in range(12):
            lp, cache = model(toks[:, t], cache)
            got.append(lp)
    assert (torch.stack(got, 1) - want).abs().max().item() < TOL


def test_masked_rows_keep_their_cache_and_length():
    _, _, variables = jax_lm(8)
    cfg, model = port_lm(variables, 8)
    cache = empty_cache(cfg, 3)
    with torch.no_grad():
        for t in range(10):  # past the ring size: the masked row's slot holds data
            _, cache = model(torch.full((3,), t % VOCAB), cache)
        before = {k: v.clone() for k, v in cache.items()}
        mask = torch.tensor([True, False, True])
        lps, cache = model(torch.tensor([1, 2, 3]), cache, write_mask=mask)
    assert torch.equal(cache["k"][:, 1], before["k"][:, 1])
    assert torch.equal(cache["v"][:, 1], before["v"][:, 1])
    assert cache["lengths"].tolist() == [11, 10, 11]
    assert not torch.equal(cache["k"][:, 0], before["k"][:, 0])
    assert torch.isfinite(lps).all()  # the masked row's log-probs are computed too


def test_lm_score_sequence_matches_jax():
    jcfg, jmodel, variables = jax_lm(8)
    _, model = port_lm(variables, 8)
    toks = np.random.default_rng(3).integers(0, VOCAB, 13)
    want = np.asarray(jax_score(jmodel, variables, jnp.asarray(toks), jcfg))
    got = lm_score_sequence(model, torch.as_tensor(toks)).numpy()
    assert got.shape == (12,)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_bf16_compute_within_jax_own_bf16_error():
    """Dense layers and the cache in bf16: the port's error against JAX's f32
    run is within twice JAX's own bf16 error (and small)."""
    toks = np.random.default_rng(4).integers(0, VOCAB, (3, 10))
    j32 = jax_lm(8)
    jb = jax_lm(8, jnp.bfloat16)
    pb = port_lm(j32[2], 8, torch.bfloat16)
    got, jbf, _, _ = step_both(jb, pb, toks)
    _, j32_lp, _, _ = step_both(j32, port_lm(j32[2], 8), toks)
    jax_err = np.abs(jbf - j32_lp).max()
    port_err = np.abs(got - j32_lp).max()
    assert 0 < jax_err < 0.2
    assert port_err <= 2 * jax_err, (port_err, jax_err)


def test_init_lm_is_seeded_at_flax_scales():
    cfg = TransformerLMConfig(vocab_size=VOCAB, n_layers=1, d_model=D, n_heads=HEADS)
    a, b = init_lm(cfg, seed=3), init_lm(cfg, seed=3)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert abs(a.embed.weight.std().item() - D ** -0.5) < 0.05
    assert torch.equal(a.layers[0].ln1.weight, torch.ones(D))
    assert torch.equal(a.head.bias, torch.zeros(VOCAB))


# ---------------------------------------------------------------------------
# conversion and checkpoints
# ---------------------------------------------------------------------------


def test_conversion_round_trips_and_covers_every_parameter():
    _, _, variables = jax_lm()
    params = jax.tree.map(np.asarray, variables["params"])
    state = lm_params_from_jax(params)
    assert set(state) == set(TransformerLM(port_lm(variables)[0]).state_dict())
    back = lm_params_to_jax(state)
    flat = jax.tree_util.tree_leaves_with_path(params)
    back_flat = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(back_flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(back_flat[path], leaf)


def test_dlm1_bytes_identical_to_jax_in_both_directions(tmp_path):
    jcfg, _, variables = jax_lm(12)
    jax_path = str(tmp_path / "jax.dlm")
    jax_loader.save_lm_checkpoint(jax_path, variables, jcfg)
    # JAX's file → the port → a file with the same bytes
    model, cfg = loader.load_lm_checkpoint(jax_path)
    assert (cfg.vocab_size, cfg.n_layers, cfg.max_cache_length) == (VOCAB, LAYERS, 12)
    port_path = str(tmp_path / "port.dlm")
    loader.save_lm_checkpoint(port_path, model, cfg)
    assert open(port_path, "rb").read() == open(jax_path, "rb").read()
    # the port's own weights → JAX reads them and writes the same bytes
    mine = init_lm(cfg, seed=9)
    loader.save_lm_checkpoint(port_path, mine, cfg)
    _, jvars, jcfg2 = jax_loader.load_lm_checkpoint(port_path)
    jax_loader.save_lm_checkpoint(jax_path, jvars, jcfg2)
    assert open(port_path, "rb").read() == open(jax_path, "rb").read()
    np.testing.assert_array_equal(np.asarray(jvars["params"]["head"]["kernel"]),
                                  mine.head.weight.detach().numpy().T)


def test_dlm1_rejects_another_file(tmp_path):
    path = tmp_path / "x.dlm"
    path.write_bytes(b"DAE1" + b"\0" * 8)
    with pytest.raises(ValueError, match="not a DLM checkpoint"):
        loader.load_lm_checkpoint(str(path))


def _oracle_pickle(tmp_path, ddp=True, config=None, extra=None, seed=0):
    torch.manual_seed(seed)
    oracle = TorchTransformerLM(vocab_size=VOCAB, n_layers=LAYERS, d_model=D,
                                n_heads=HEADS).eval()
    state = dict(oracle.state_dict(), **(extra or {}))
    if ddp:
        state = {f"module.{k}": v for k, v in state.items()}
    path = str(tmp_path / "lm.pt")
    torch.save({"model": state, "config": config if config is not None else {"n_heads": HEADS}},
               path)
    return oracle, path


def test_torch_pickle_with_ddp_prefixes_loads_as_in_jax(tmp_path):
    oracle, path = _oracle_pickle(tmp_path)
    model, cfg = loader.load_lm_torch_checkpoint(path, max_cache_length=16, verbose=False)
    _, jvars, jcfg = jax_loader.load_lm_torch_checkpoint(path, max_cache_length=16,
                                                         verbose=False)
    assert (cfg.vocab_size, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.expansion_factor,
            cfg.max_cache_length) == (jcfg.vocab_size, jcfg.n_layers, jcfg.d_model,
                                      jcfg.n_heads, jcfg.expansion_factor, 16)
    back = dict(jax.tree_util.tree_leaves_with_path(lm_params_to_jax(model.state_dict())))
    for path_, leaf in jax.tree_util.tree_leaves_with_path(jvars["params"]):
        np.testing.assert_array_equal(back[path_], np.asarray(leaf))
    assert all(torch.equal(v, oracle.state_dict()[k]) for k, v in model.state_dict().items())


def test_torch_pickle_without_n_heads_assumes_64_dim_heads_and_warns(tmp_path, capsys):
    _, path = _oracle_pickle(tmp_path, config={})
    _, cfg = loader.load_lm_torch_checkpoint(path)
    _, _, jcfg = jax_loader.load_lm_torch_checkpoint(path)
    err = capsys.readouterr().err
    assert cfg.n_heads == jcfg.n_heads == 8  # d_model 32 is no multiple of 64: JAX's 8
    assert err.count("assuming head_dim=64") == 2
    _, cfg = loader.load_lm_torch_checkpoint(path, n_heads=HEADS, verbose=False)
    assert cfg.n_heads == HEADS


def test_torch_pickle_with_attention_biases_raises(tmp_path):
    extra = {"layers.0.qkv.bias": torch.zeros(3 * D)}
    _, path = _oracle_pickle(tmp_path, extra=extra)
    with pytest.raises(ValueError, match="attention-projection biases"):
        loader.load_lm_torch_checkpoint(path, verbose=False)
    with pytest.raises(ValueError, match="attention-projection biases"):
        jax_loader.load_lm_torch_checkpoint(path, verbose=False)


def test_torch_pickle_with_a_shape_mismatch_raises(tmp_path):
    extra = {"layers.1.ff_in.bias": torch.zeros(3)}
    _, path = _oracle_pickle(tmp_path, extra=extra)
    with pytest.raises(ValueError, match="shape mismatches"):
        loader.load_lm_torch_checkpoint(path, verbose=False)
    with pytest.raises(ValueError, match="shape mismatches"):
        jax_loader.load_lm_torch_checkpoint(path, verbose=False)


def test_torch_pickle_without_an_embedding_raises(tmp_path):
    path = str(tmp_path / "x.pt")
    torch.save({"model": {"decoder.weight": torch.zeros(3, 4)}}, path)
    with pytest.raises(ValueError, match="no embed.weight"):
        loader.load_lm_torch_checkpoint(path, verbose=False)


@pytest.mark.parametrize("kind", ["dlm1", "torch"])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_load_lm_adapter_steps_as_jax(tmp_path, kind, dtype):
    """The adapter of each file kind, with the cache trimmed to 6 and an
    optional compute dtype, gives JAX's adapter's log-probs (bf16: within
    JAX's own bf16 rounding of the parameters, 2e-2)."""
    tok = CharTokenizer()
    if kind == "dlm1":
        jcfg = JaxLMConfig(vocab_size=tok.vocab_size(), n_layers=LAYERS, d_model=D,
                           n_heads=HEADS, max_cache_length=32)
        _, variables = jax_init_lm(jcfg, jax.random.PRNGKey(1))
        path = str(tmp_path / "lm.dlm")
        jax_loader.save_lm_checkpoint(path, variables, jcfg)
    else:
        torch.manual_seed(1)
        oracle = TorchTransformerLM(vocab_size=tok.vocab_size(), n_layers=LAYERS, d_model=D,
                                    n_heads=HEADS)
        path = str(tmp_path / "lm.pt")
        torch.save({"model": oracle.state_dict(), "config": {"n_heads": HEADS}}, path)
    jdt = None if dtype is None else jnp.bfloat16
    ja = jax_loader.load_lm_adapter(path, JaxCharTokenizer(), max_cache_length=6,
                                    compute_dtype=jdt)
    pa = loader.load_lm_adapter(path, tok, max_cache_length=6, compute_dtype=dtype,
                                device="cpu")
    assert pa.config.max_cache_length == 6 and pa.device.type == "cpu"
    js, jl = ja.init_state(2)
    ps, pl = pa.init_state(2)
    tol = TOL if dtype is None else 2e-2
    rng = np.random.default_rng(5)
    for _ in range(9):
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=tol)
        toks, mask = rng.integers(1, tok.vocab_size(), 2), rng.random(2) < 0.7
        js, jl = ja.advance(js, jnp.asarray(toks), jnp.asarray(mask))
        ps, pl = pa.advance(pa.gather(ps, torch.arange(2)), torch.as_tensor(toks),
                            torch.as_tensor(mask))
    assert ps["lengths"].tolist() == np.asarray(js["lengths"]).tolist()
