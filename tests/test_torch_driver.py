"""The port's NSTI driver (``evals/run.py``) against the JAX package's, on
``-d synthetic`` with the JAX driver's weights handed across.

Both drivers run the same CLI (one online epoch, seq 256 / overlap 128,
greedy decode, normalizer, corpus WER, result pickle) on a tiny fp32
conformer with ``attention_impl="pallas_flash"``; the JAX driver's model is
injected through its ``load_model_and_tokenizer`` (nothing in the JAX
package is edited), and the port receives the same flax params through
``params_from_jax``.  Transcripts and WER must be identical (the pattern of
tests/test_driver_golden.py).

The JAX driver runs with ``lax.scan``'s ``unroll`` dropped, as in
tests/test_torch_engine.py: XLA:CPU takes ~40 s to compile the JAX CTC
gradient unrolled, under a second rolled, for the same operations.
"""

import argparse
import contextlib
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dynamic_asr_eval_tpu.config as jax_config
import dynamic_asr_eval_tpu.evals.run as jax_run
import dynamic_asr_eval_tpu.ops.ctc as jax_ctc
from dynamic_asr_eval_tpu.config import TTAConfig as JaxTTAConfig
from dynamic_asr_eval_tpu.models import ConformerConfig as JaxConfig
from dynamic_asr_eval_tpu.models import init_conformer as jax_init
from dynamic_asr_eval_tpu.text import CharTokenizer as JaxCharTokenizer
from dynamic_asr_eval_tpu_torch.config import TTAConfig, parse_kwarg_value
from dynamic_asr_eval_tpu_torch.evals.common import load_model_and_tokenizer
from dynamic_asr_eval_tpu_torch.evals.run import cli, parse_args
from dynamic_asr_eval_tpu_torch.models import ConformerConfig

torch.set_num_threads(1)

TINY = dict(feat_in=80, n_layers=2, d_model=64, n_heads=2, head_dim=32, vocab_size=28,
            subsampling_factor=8, subsampling_conv_channels=16, conv_kernel_size=5,
            attention_impl="pallas_flash")
KWARGS = ["-kwargs", "epochs=1", "online=true", "seq_len=256", "overlap=128",
          "lm_tta_beams=0", "optim_lr=1e-3"]


@contextlib.contextmanager
def rolled_scans():
    scan = jax.lax.scan
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.lax, "scan", lambda *a, unroll=1, **kw: scan(*a, **kw))
    jax_ctc.ctc_loss.clear_cache()
    try:
        yield
    finally:
        mp.undo()
        jax_ctc.ctc_loss.clear_cache()


def _load_pickle(directory):
    (name,) = [f for f in os.listdir(directory) if f.endswith(".pkl")]
    with open(os.path.join(directory, name), "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("driver")
    jcfg = JaxConfig(compute_dtype=jnp.float32, **TINY)
    model, variables = jax_init(jcfg, jax.random.PRNGKey(7), example_T=256)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_run, "load_model_and_tokenizer",
               lambda args: (model, variables, JaxCharTokenizer(), jcfg))
    try:
        with rolled_scans():
            jax_wer = jax_run.cli(["-d", "synthetic", "--quiet", "-s", str(tmp / "jax" / "r.pkl")]
                                  + KWARGS)
    finally:
        mp.undo()
    params_np = jax.tree.map(np.asarray, variables["params"])
    port_wer = cli(["-d", "synthetic", "--quiet", "--device", "cpu",
                    "-s", str(tmp / "port" / "r.pkl")] + KWARGS,
                   model_config=ConformerConfig(compute_dtype="float32", **TINY),
                   jax_params=params_np)
    return (jax_wer, _load_pickle(tmp / "jax")), (port_wer, _load_pickle(tmp / "port"))


def test_transcripts_identical(both):
    (_, j), (_, p) = both
    assert p["model_output"] == j["model_output"]
    assert p["gold"] == j["gold"]
    assert any(p["model_output"])  # the model emitted something to compare


def test_wer_identical(both):
    (jw, j), (pw, p) = both
    assert pw == jw
    for key in ("wer", "words", "ins_rate", "del_rate", "sub_rate"):
        assert p[key] == j[key], key


def test_result_pickle_schema(both):
    (_, j), (_, p) = both
    assert set(p) == set(j)
    assert p["repeat"] == "1/1"


@pytest.mark.parametrize("raw", ["9e-5", "true", "False", "none", "[1, 2]", "abc",
                                 "__import__('os')", "3"])
def test_kwarg_values_parse_as_in_the_jax_cli(raw):
    assert parse_kwarg_value(raw) == jax_config.parse_kwarg_value(raw)


def test_cli_surface_matches_the_jax_driver():
    argv = ["-d", "synthetic", "-seq", "512", "-o", "256", "-ds", "-kwargs", "epochs=2",
            "optim_lr=1e-4", "spec_augment_n_freq_masks=6"]
    jax_parser = argparse.ArgumentParser()
    jax_parser.add_argument("-d", "--dataset")  # the rest come from the JAX apply_args
    jax_args = jax_config.apply_args(jax_parser, argv)
    ours, theirs = vars(parse_args(argv)), vars(jax_args)
    for key in ("dataset", "seq_len", "overlap", "shuffle", "epochs", "optim_lr",
                "spec_augment_n_freq_masks"):
        assert ours[key] == theirs[key], key
    port_tta = dataclasses.asdict(TTAConfig.from_args(parse_args(argv)))
    jax_tta = dataclasses.asdict(JaxTTAConfig.from_args(jax_args))
    assert port_tta == {k: jax_tta[k] for k in port_tta}


def test_model_config_from_a_yaml_file(tmp_path):
    path = tmp_path / "model.yaml"
    path.write_text("model:\n  feat_in: 80\n  n_layers: 1\n  d_model: 32\n  n_heads: 2\n"
                    "  head_dim: 16\n  subsampling_conv_channels: 4\n  conv_kernel_size: 3\n"
                    "  compute_dtype: float32\n  dropout_ff: 0.0\n")
    model, params, tok, cfg = load_model_and_tokenizer(
        parse_args(["--config", str(path), "--device", "cpu"]))
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (1, 32, tok.vocab_size())
    assert cfg.compute_dtype == torch.float32 and set(params) == set(model.state_dict())
