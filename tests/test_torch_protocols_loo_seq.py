"""The port's within-recording LOO and sequence-scaling drivers against
the JAX package's, on ``-d synthetic`` with shared weights (the pattern of
tests/test_torch_protocols.py), and their cores called
directly on both sides: ``loo_eval`` (the ``"loo"`` mode, both fallbacks
and the uncovered-position warning, each on an input that forces it) and
``seq_eval_one`` (one online epoch, and ``epochs=0``), whose stitched
log-probs must agree within 1e-4 (f32)."""

import argparse
import dataclasses

import numpy as np
import pytest
import torch

import jax

import dynamic_asr_eval_tpu.config as jax_config
import dynamic_asr_eval_tpu.evals.common as jax_common
import dynamic_asr_eval_tpu.evals.run_seq_eval as jax_seq
import dynamic_asr_eval_tpu.evals.run_within_recording_loo_eval as jax_loo
from dynamic_asr_eval_tpu.tta import DynamicEvalEngine as JaxEngine
from dynamic_asr_eval_tpu_torch.evals import run_seq_eval, run_within_recording_loo_eval
from dynamic_asr_eval_tpu_torch.evals.common import build_engine, build_eval_engine
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, init_conformer, params_from_jax
from test_torch_protocols import (
    KWARGS,
    TINY,
    assert_same_detail,
    jax_tiny,
    load,
    rolled_scans,
    run_both,
)

torch.set_num_threads(1)

TOL = 1e-4


# ---------------------------------------------------------------------------
# the drivers, port against JAX
# ---------------------------------------------------------------------------

DRIVERS = {
    # name: JAX module, port module, flags
    "loo": (jax_loo, run_within_recording_loo_eval, ["--loo_seq_len", "256",
                                                     "--loo_overlap", "128"]),
    "seq": (jax_seq, run_seq_eval, ["--nsti_seq_len", "256", "--nsti_overlap", "128"]),
}


@pytest.fixture(scope="module", params=sorted(DRIVERS))
def driver(request, tmp_path_factory):
    jax_module, port_module, flags = DRIVERS[request.param]
    tmp = tmp_path_factory.mktemp(request.param)
    outs = run_both(jax_module, port_module,
                    lambda side: ["-d", "synthetic", "--quiet", "-s", str(tmp / f"{side}.pkl")]
                    + flags)
    return outs, load(tmp / "jax_1.pkl"), load(tmp / "port_1.pkl")


def test_driver_transcripts_and_wer_identical(driver):
    (jax_wer, port_wer), j, p = driver
    assert port_wer == jax_wer and np.isfinite(port_wer)
    assert_same_detail(p, j)
    assert any(p["model_output"])


def test_driver_pickle_schema(driver):
    _, j, p = driver
    assert set(p) == set(j) and p["repeat"] == "1/1"
    assert set(p["args_dict"]) - set(j["args_dict"]) == {"device"}


# ---------------------------------------------------------------------------
# loo_eval and seq_eval_one, called directly on both sides
# ---------------------------------------------------------------------------


def both_args(flags, kwargs=KWARGS):
    """The JAX namespace (its ``apply_args``) and the port's for ``flags``."""
    parser = argparse.ArgumentParser()
    for name, default in (("--loo_seq_len", 256), ("--loo_overlap", 128),
                          ("--nsti_seq_len", -1), ("--nsti_overlap", 0)):
        parser.add_argument(name, type=int, default=default)
    jax_args = jax_config.apply_args(parser, flags + kwargs)
    port_driver = run_seq_eval if "--nsti_seq_len" in flags else run_within_recording_loo_eval
    return jax_args, port_driver.parse_args(flags + ["--device", "cpu"] + kwargs)


class Sides:
    """The tiny model on both sides, with each side's NSTI engine and
    evaluation engine built the drivers' way."""

    def __init__(self, flags, kwargs=KWARGS, seed=9):
        self.jax_args, self.port_args = both_args(flags, kwargs)
        model, self.variables, self.jcfg = jax_tiny(seed)
        self.jax_engine = jax_common.build_engine(self.jax_args, model, self.jcfg)
        eval_cfg = dataclasses.replace(self.jax_engine.config, epochs=0, online=False,
                                       shuffle=False)
        self.jax_eval = JaxEngine(model, self.jcfg.blank_id, self.jcfg.subsampling_factor,
                                  eval_cfg)
        cfg = ConformerConfig(compute_dtype="float32", **TINY)
        port_model = init_conformer(cfg)
        port_model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                                self.variables["params"])))
        self.params = {k: v.detach().clone() for k, v in port_model.state_dict().items()}
        self.port_engine = build_engine(self.port_args, port_model, cfg, device="cpu")
        self.port_eval = build_eval_engine(port_model, cfg, self.port_engine)
        self.cfg = cfg


def spec_of(frames, seed=0):
    return np.random.default_rng(seed).standard_normal((80, frames)).astype(np.float32)


LOO_CASES = {
    # name: frames, loo_seq_len, loo_overlap, mode, n_chunks
    "loo": (401, 256, 128, "loo", 3),  # chunks 0 and 2 share no frame
    "one_chunk": (401, 512, 256, "fallback_windowed_eval", 1),
    "no_disjoint_pair": (401, 256, 192, "fallback_no_disjoint_pairs", 4),
    "uncovered": (600, 256, 64, "loo", 3),  # chunk 1 alone covers frames 256..384
}


@pytest.fixture(scope="module")
def loo_sides():
    """One pair of engines for every case: ``loo_eval`` reads the LOO sizes
    from ``args``, so the cases share the JAX engines' compiled programs."""
    return Sides(["--loo_seq_len", "256", "--loo_overlap", "128"])


@pytest.mark.parametrize("case", sorted(LOO_CASES))
def test_loo_eval_matches_jax(case, loo_sides, capsys):
    frames, seq, overlap, mode, n_chunks = LOO_CASES[case]
    sides = loo_sides
    for args in (sides.jax_args, sides.port_args):
        args.loo_seq_len, args.loo_overlap = seq, overlap
    spec = spec_of(frames)
    with rolled_scans():
        want, want_meta = jax_loo.loo_eval(sides.jax_engine, sides.jax_eval, sides.variables,
                                           spec, sides.jax_args, 8, sides.jcfg.n_classes)
    jax_log = capsys.readouterr().out
    got, meta = run_within_recording_loo_eval.loo_eval(
        sides.port_engine, sides.port_eval, sides.params, spec, sides.port_args, 8,
        sides.cfg.n_classes)
    port_log = capsys.readouterr().out
    assert meta == want_meta == {"n_chunks": n_chunks, "mode": mode}
    assert got.dtype == np.float32 and got.shape == np.asarray(want).shape
    assert np.abs(got - np.asarray(want)).max() <= TOL
    warned = "uncovered position(s)" in port_log
    assert warned == ("uncovered position(s)" in jax_log) == (case == "uncovered")
    if case == "uncovered":
        assert got.shape[0] == -(-frames // 8) - 16  # positions 32..47 dropped


def test_loo_eval_leaves_the_pristine_weights(loo_sides):
    sides = loo_sides
    for args in (sides.jax_args, sides.port_args):
        args.loo_seq_len, args.loo_overlap = 256, 128
    before = {k: v.clone() for k, v in sides.params.items()}
    run_within_recording_loo_eval.loo_eval(sides.port_engine, sides.port_eval, sides.params,
                                           spec_of(401), sides.port_args, 8,
                                           sides.cfg.n_classes)
    assert all(torch.equal(before[k], v) for k, v in sides.params.items())


@pytest.mark.parametrize("epochs", [0, 1])
def test_seq_eval_one_matches_jax(epochs):
    """Outer chunks of 256 / 128 frames over inner windows of 128 / 64; with
    ``epochs=0`` the recording is one chunk of plain windowed inference."""
    kwargs = ["-kwargs", f"epochs={epochs}", "online=true", "seq_len=128", "overlap=64",
              "lm_tta_beams=0", "optim_lr=1e-3"]
    sides = Sides(["--nsti_seq_len", "256", "--nsti_overlap", "128"], kwargs)
    spec = spec_of(401, seed=1)
    with rolled_scans():
        want = jax_seq.seq_eval_one(sides.jax_engine, sides.variables, spec, sides.jax_args, 8,
                                    sides.jcfg.n_classes)
    got = run_seq_eval.seq_eval_one(sides.port_engine, sides.params, spec, sides.port_args, 8,
                                    sides.cfg.n_classes)
    assert got.dtype == np.float32 and got.shape == np.asarray(want).shape == (51, 29)
    assert np.abs(got - np.asarray(want)).max() <= TOL
