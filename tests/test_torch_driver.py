"""The port's drivers (``evals/run.py``, ``evals/run_dynamic_eval_full.py``)
against the JAX package's, on ``-d synthetic`` with the JAX driver's weights
handed across (or read by both from one reference ``.pt`` checkpoint).

Both drivers run the same CLI (one online epoch, seq 256 / overlap 128,
greedy decode, normalizer, corpus WER, result pickle) on a tiny fp32
conformer with ``attention_impl="pallas_flash"``; the JAX driver's model is
injected through its ``load_model_and_tokenizer`` (nothing in the JAX
package is edited), and the port receives the same flax params through
``params_from_jax``.  Transcripts and WER must be identical (the pattern of
tests/test_driver_golden.py).  The same holds for
``run_dynamic_eval_full.py`` with and without ``--awmc`` and with
``--consistency`` (its log lines too; with ``-lm`` the consistency engine
keeps greedy teachers and the LM serves the final decode), and for ``run.py --awmc --checkpoint ref.pt``, where each package
loads the reference pickle itself.  The options not ported yet raise
``NotImplementedError``; the invalid combinations raise what JAX raises.

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
import dynamic_asr_eval_tpu.evals.run_dynamic_eval_full as jax_full
import dynamic_asr_eval_tpu.ops.ctc as jax_ctc
from dynamic_asr_eval_tpu.config import TTAConfig as JaxTTAConfig
from dynamic_asr_eval_tpu.models import ConformerConfig as JaxConfig
from dynamic_asr_eval_tpu.models import init_conformer as jax_init
from dynamic_asr_eval_tpu.text import CharTokenizer as JaxCharTokenizer
from dynamic_asr_eval_tpu_torch.config import TTAConfig, parse_kwarg_value
from dynamic_asr_eval_tpu_torch.evals.common import load_model_and_tokenizer
from dynamic_asr_eval_tpu_torch.evals import run_dynamic_eval_full as full
from dynamic_asr_eval_tpu_torch.evals.run import cli, parse_args
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, init_conformer

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


# ---------------------------------------------------------------------------
# run_dynamic_eval_full.py, with and without --awmc
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["nsti", "awmc", "consistency"])
def full_runs(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"full_{request.param}")
    flags = {"nsti": [], "awmc": ["--awmc"], "consistency": ["--consistency"]}[request.param]
    jcfg = JaxConfig(compute_dtype=jnp.float32, **TINY)
    model, variables = jax_init(jcfg, jax.random.PRNGKey(11), example_T=256)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_full, "load_model_and_tokenizer",
               lambda args: (model, variables, JaxCharTokenizer(), jcfg))
    try:
        with rolled_scans():
            jax_wer = jax_full.cli(["-d", "synthetic", "--quiet", "-s", str(tmp / "jax" / "r.pkl"),
                                    "-log", str(tmp / "jax.log")] + flags + KWARGS)
    finally:
        mp.undo()
    port_wer = full.cli(["-d", "synthetic", "--quiet", "--device", "cpu", "-s",
                         str(tmp / "port" / "r.pkl"), "-log", str(tmp / "port.log")]
                        + flags + KWARGS,
                        model_config=ConformerConfig(compute_dtype="float32", **TINY),
                        jax_params=jax.tree.map(np.asarray, variables["params"]))
    logs = [(tmp / f"{side}.log").read_text().splitlines() for side in ("jax", "port")]
    return ((jax_wer, _load_pickle(tmp / "jax")), (port_wer, _load_pickle(tmp / "port")),
            logs, request.param)


def test_full_driver_transcripts_and_wer_identical(full_runs):
    (jw, j), (pw, p), _, _ = full_runs
    assert p["model_output"] == j["model_output"] and any(p["model_output"])
    assert p["gold"] == j["gold"]
    assert pw == jw
    for key in ("wer", "words", "ins_rate", "del_rate", "sub_rate"):
        assert p[key] == j[key], key


def test_full_driver_pickle_schema_and_log_line(full_runs):
    (_, j), (_, p), (jax_log, port_log), kind = full_runs
    assert set(p) == set(j) and p["repeat"] == "1/1"
    assert port_log == jax_log
    assert port_log[-1].startswith({"nsti": "DynamicEvalEngine", "awmc": "AWMCEngine",
                                    "consistency": "ConsistencyEngine"}[kind])


# ---------------------------------------------------------------------------
# run.py --awmc --checkpoint: a reference torch pickle read by each package
# ---------------------------------------------------------------------------

REF_DIMS = {k: v for k, v in TINY.items() if k != "attention_impl"}


@pytest.fixture(scope="module")
def checkpoint_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    state = init_conformer(ConformerConfig(compute_dtype="float32", **REF_DIMS), seed=5).state_dict()
    path = str(tmp / "ref.pt")
    torch.save({"model": state, "config": {"model": dict(REF_DIMS, compute_dtype="float32")}},
               path)
    argv = ["-d", "synthetic", "--quiet", "--awmc", "--checkpoint", path]
    with rolled_scans():
        jax_wer = jax_run.cli(argv + ["-s", str(tmp / "jax" / "r.pkl")] + KWARGS)
    port_wer = cli(argv + ["--device", "cpu", "-s", str(tmp / "port" / "r.pkl")] + KWARGS)
    return (jax_wer, _load_pickle(tmp / "jax")), (port_wer, _load_pickle(tmp / "port"))


def test_awmc_from_a_reference_checkpoint_transcripts_identical(checkpoint_runs):
    (_, j), (_, p) = checkpoint_runs
    assert p["model_output"] == j["model_output"] and any(p["model_output"])
    assert set(p) == set(j)


def test_awmc_from_a_reference_checkpoint_wer_identical(checkpoint_runs):
    (jw, j), (pw, p) = checkpoint_runs
    assert pw == jw
    for key in ("wer", "words", "ins_rate", "del_rate", "sub_rate"):
        assert p[key] == j[key], key


# ---------------------------------------------------------------------------
# what is not ported, and what JAX refuses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags,error", [(["--consistency", "--dp_records"], ValueError),
                                         (["--dp_records"], None)],
                         ids=["consistency", "dp_records"])
def test_full_driver_rejects_what_is_not_ported(flags, error, tmp_path):
    """``--consistency`` with ``--dp_records`` is refused as JAX refuses it;
    ``--dp_records`` alone is ported: a world of 1 here, the serial
    driver's transcripts and WER on an f32 model (its 2-rank run against
    JAX: tests/test_torch_parallel.py)."""
    if error is ValueError:
        with pytest.raises(ValueError, match="only the NSTI engine"):
            full.cli(["-d", "synthetic", "--quiet", "--device", "cpu"] + flags)
        with pytest.raises(ValueError, match="only the NSTI engine"):
            jax_full.cli(["-d", "synthetic", "--quiet"] + flags)
        return
    runs = []
    for extra in ([], flags):
        out = tmp_path / ("records" if extra else "serial") / "r.pkl"
        wer = full.cli(["-d", "synthetic", "--quiet", "--device", "cpu", "-s", str(out)]
                       + extra + KWARGS, model_config=ConformerConfig(compute_dtype="float32",
                                                                      **TINY))
        runs.append((wer, _load_pickle(out.parent)))
    (serial_wer, serial), (wer, detail) = runs
    assert wer == serial_wer and detail["model_output"] == serial["model_output"]
    assert set(detail) == set(serial)


def test_awmc_with_dp_records_is_refused_as_in_jax():
    argv = ["-d", "synthetic", "--quiet", "--awmc", "--dp_records"]
    with pytest.raises(ValueError, match="only the NSTI engine"):
        jax_full.cli(argv)
    with pytest.raises(ValueError, match="only the NSTI engine"):
        full.cli(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit, match="AWMC engine"):
        jax_run.cli(argv)
    with pytest.raises(SystemExit, match="AWMC engine"):
        cli(argv + ["--device", "cpu"])


@pytest.mark.parametrize("driver", ["run", "full"])
def test_a_transformer_lm_raises_naming_its_roadmap_item(driver, tmp_path, char_tlm):
    """The item it named (12b) is done: ``-lm`` with a DLM1 file runs in both
    drivers (their transcripts against JAX's: ``test_lm_*``), and a file that
    carries the DLM1 magic and nothing else raises."""
    run_cli = {"run": cli, "full": full.cli}[driver]
    argv = ["-d", "synthetic", "--quiet", "--device", "cpu", "--beams", "2"]
    wer = run_cli(argv + ["-lm", char_tlm["TLM"]] + KWARGS + ["epochs=0"],
                  model_config=ConformerConfig(compute_dtype="float32", **TINY))
    assert np.isfinite(wer)
    path = tmp_path / "lm.dlm"
    path.write_bytes(b"DLM1")
    with pytest.raises(Exception):
        run_cli(argv + ["-lm", str(path)])


def test_a_checkpoint_brings_its_own_config(tmp_path):
    cfg = ConformerConfig(compute_dtype="float32", **TINY)
    path = str(tmp_path / "ref.pt")
    torch.save({"model": init_conformer(cfg).state_dict()}, path)
    with pytest.raises(ValueError, match="own configuration"):
        load_model_and_tokenizer(parse_args(["--checkpoint", path, "--device", "cpu"]),
                                 config=cfg)


# ---------------------------------------------------------------------------
# -lm <file>.arpa, --beams, --decode_batch and --tp
# ---------------------------------------------------------------------------

LM_CASES = {
    # driver, flags; "LM" stands for the ARPA file, "TLM" for a transformer
    # LM's DLM1 file and "TLM_PT" for the same LM as a lming torch pickle;
    # lm_tta_beams is 0 unless set
    "run_lm": ("run", ["-lm", "LM", "--beams", "4", "-kwargs", "lm_tta_beams=3"]),
    "run_tlm": ("run", ["-lm", "TLM", "--beams", "4", "-kwargs", "lm_tta_beams=3"]),
    "run_tlm_pt": ("run", ["-lm", "TLM_PT", "--beams", "4"]),
    "full_tlm": ("full", ["-lm", "TLM", "--beams", "4", "-kwargs", "lm_tta_beams=3"]),
    "full_tlm_pt": ("full", ["-lm", "TLM_PT", "--beams", "4", "-kwargs", "lm_tta_beams=3"]),
    "full_consistency_tlm": ("full", ["--consistency", "-lm", "TLM", "--beams", "4", "-kwargs",
                                      "lm_tta_beams=3"]),
    "run_lm_batch_tp": ("run", ["-lm", "LM", "--beams", "4", "--decode_batch", "2", "--tp", "2"]),
    "full_lm": ("full", ["-lm", "LM", "--beams", "4", "-kwargs", "lm_tta_beams=3"]),
    "full_lm_batch": ("full", ["-lm", "LM", "--beams", "4", "--decode_batch", "2"]),
    "full_batch_without_lm": ("full", ["--decode_batch", "2"]),
}


@pytest.fixture(scope="module")
def char_lm(tmp_path_factory):
    from test_torch_ngram import random_arpa

    path = tmp_path_factory.mktemp("lm") / "chars.arpa"
    random_arpa(path, [chr(c) for c in range(ord("a"), ord("z") + 1)], order=3,
                counts=(0, 150, 150), seed=4)
    return str(path)


@pytest.fixture(scope="module")
def char_tlm(tmp_path_factory):
    """A tiny transformer LM over the char tokenizer (28 pieces), written by
    the JAX package as a DLM1 file and, with the same weights, as a lming
    torch pickle (the names of tests/torch_oracles.py)."""
    from dynamic_asr_eval_tpu.lm.loader import save_lm_checkpoint
    from dynamic_asr_eval_tpu.lm.transformer_lm import TransformerLMConfig, init_lm
    from dynamic_asr_eval_tpu_torch.models.convert import lm_params_from_jax

    tmp = tmp_path_factory.mktemp("tlm")
    cfg = TransformerLMConfig(vocab_size=28, n_layers=2, d_model=32, n_heads=2,
                              max_cache_length=128)
    _, variables = init_lm(cfg, jax.random.PRNGKey(17))
    save_lm_checkpoint(str(tmp / "chars.dlm"), variables, cfg)
    state = lm_params_from_jax(jax.tree.map(np.asarray, variables["params"]))
    torch.save({"model": {f"module.{k}": v for k, v in state.items()},
                "config": {"n_heads": 2}}, str(tmp / "chars.pt"))
    return {"TLM": str(tmp / "chars.dlm"), "TLM_PT": str(tmp / "chars.pt")}


@pytest.fixture(scope="module", params=list(LM_CASES))
def lm_runs(request, tmp_path_factory, char_lm, char_tlm):
    """The JAX driver and the port's on the same weights and flags (KWARGS
    first: a later ``-kwargs`` adds to it)."""
    driver, flags = LM_CASES[request.param]
    files = dict(char_tlm, LM=char_lm)
    flags = [files.get(f, f) for f in flags]
    kwargs = KWARGS + (flags[flags.index("-kwargs") + 1:] if "-kwargs" in flags else [])
    flags = flags[: flags.index("-kwargs")] if "-kwargs" in flags else flags
    tmp = tmp_path_factory.mktemp(request.param)
    jax_mod, port_cli = {"run": (jax_run, cli), "full": (jax_full, full.cli)}[driver]
    jcfg = JaxConfig(compute_dtype=jnp.float32, **TINY)
    model, variables = jax_init(jcfg, jax.random.PRNGKey(13), example_T=256)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_mod, "load_model_and_tokenizer",
               lambda args: (model, variables, JaxCharTokenizer(), jcfg))
    try:
        with rolled_scans():
            jax_wer = jax_mod.cli(["-d", "synthetic", "--quiet", "-s", str(tmp / "jax" / "r.pkl")]
                                  + flags + kwargs)
    finally:
        mp.undo()
    port_wer = port_cli(["-d", "synthetic", "--quiet", "--device", "cpu",
                         "-s", str(tmp / "port" / "r.pkl")] + flags + kwargs,
                        model_config=ConformerConfig(compute_dtype="float32", **TINY),
                        jax_params=jax.tree.map(np.asarray, variables["params"]))
    return (jax_wer, _load_pickle(tmp / "jax")), (port_wer, _load_pickle(tmp / "port"))


def test_lm_transcripts_identical(lm_runs):
    (_, j), (_, p) = lm_runs
    assert p["model_output"] == j["model_output"] and any(p["model_output"])
    assert p["gold"] == j["gold"] and len(p["elapsed_times"]) == len(j["elapsed_times"]) == 3


def test_lm_wer_identical(lm_runs):
    (jw, j), (pw, p) = lm_runs
    assert pw == jw
    for key in ("wer", "words", "ins_rate", "del_rate", "sub_rate"):
        assert p[key] == j[key], key


def test_the_lm_changes_the_transcripts(char_lm, tmp_path):
    """``-lm`` with ``--beams`` above 1 decodes otherwise than greedy (on the
    same weights), and ``--beams 1`` keeps the greedy decode."""
    outputs = {}
    for name, flags in (("greedy", []), ("beams1", ["-lm", char_lm, "--beams", "1"]),
                        ("beam", ["-lm", char_lm, "--beams", "4"])):
        cli(["-d", "synthetic", "--quiet", "--device", "cpu", "-s", str(tmp_path / name / "r.pkl")]
            + flags + KWARGS, model_config=ConformerConfig(compute_dtype="float32", **TINY))
        outputs[name] = _load_pickle(tmp_path / name)["model_output"]
    assert outputs["beams1"] == outputs["greedy"] != outputs["beam"]
