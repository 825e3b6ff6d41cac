"""The port's encoder-decoder drivers against the JAX package's, on ``-d
synthetic`` with shared weights.

The JAX drivers build their small default enc-dec from ``-kwargs seed=N``; the test
builds the same one through JAX's own ``load_encdec_from_args`` and hands
its variables to the port's drivers (``jax_params``), whose default
configuration is the same.  Each pair runs the same CLI:

- ``enc_dec_inference_test`` (chunked greedy AR decode, 256-frame chunks);
- ``enc_dec_ctc_beam_inference_test`` (``-beams 3``) against JAX's, and the
  port's ``enc_dec_inference_test -mode joint`` against the same run;
- ``enc_dec_dynamic_eval_test --breaks --training_mode teacher_ce``, one
  epoch, lr 1e-3, the first record as one chunk; JAX's updates go through
  ``.lower().compile()``, and its CTC gradient is stopped where the teacher
  transcript cannot align, as the port's CTC gives none there
  (tests/test_torch_encdec_rl.py).
  The ``grpo`` and ``maxrl`` engines are held in
  tests/test_torch_encdec_rl_policy.py.

Transcripts, WERs and the pickles' detail must be identical, and the
pickles' keys the same (the port's ``args_dict`` adds ``device``).
"""

import argparse
import pickle

import jax
import numpy as np
import pytest
import torch

import dynamic_asr_eval_tpu.evals.enc_dec_ctc_beam_inference_test as jax_beam
import dynamic_asr_eval_tpu.evals.enc_dec_dynamic_eval_test as jax_tta
import dynamic_asr_eval_tpu.evals.enc_dec_inference_test as jax_inf
from dynamic_asr_eval_tpu.text import CharTokenizer as JaxCharTokenizer
from dynamic_asr_eval_tpu_torch.evals import (
    enc_dec_ctc_beam_inference_test,
    enc_dec_dynamic_eval_test,
    enc_dec_inference_test,
)
from test_torch_encdec_rl import compiled_updates, feasibility_log
from test_torch_protocols import DETAIL_KEYS

torch.set_num_threads(1)

SEED = 2  # the drivers' seed: its small model emits a varied transcript
KWARGS = ["-kwargs", "epochs=1", "seq_len=256", "optim_lr=1e-3", f"seed={SEED}"]


def jax_params(seed=SEED):
    """The variables of the JAX drivers' default model for ``seed``."""
    _, variables, _ = jax_inf.load_encdec_from_args(argparse.Namespace(seed=seed),
                                                    JaxCharTokenizer())
    return jax.tree.map(np.asarray, variables)


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def run_pair(jax_module, port_module, tmp, flags=(), kwargs=()):
    argv = ["-d", "synthetic", "--quiet", *flags]
    kwargs = KWARGS + list(kwargs)
    jax_out = jax_module.cli(argv + ["-s", str(tmp / "jax.pkl")] + kwargs)
    port_out = port_module.cli(argv + ["-s", str(tmp / "port.pkl"), "--device", "cpu"] + kwargs,
                               jax_params=jax_params())
    return jax_out, port_out, load(tmp / "jax_1.pkl"), load(tmp / "port_1.pkl")


def assert_same_run(jax_out, port_out, j, p, n_records=3):
    assert port_out == jax_out and np.isfinite(port_out)
    for key in DETAIL_KEYS:
        assert p[key] == j[key], key
    assert set(p) == set(j)
    assert set(p["args_dict"]) - set(j["args_dict"]) == {"device"}
    assert len(p["model_output"]) == n_records and any(p["model_output"])


def test_inference_driver_matches_jax(tmp_path):
    assert_same_run(*run_pair(jax_inf, enc_dec_inference_test, tmp_path))


@pytest.fixture(scope="module")
def joint(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("joint")
    argv = ["-d", "synthetic", "--quiet", "-beams", "3"]
    jax_out = jax_beam.cli(argv + ["-s", str(tmp / "jax.pkl")] + KWARGS)
    return jax_out, load(tmp / "jax_1.pkl"), argv


@pytest.mark.parametrize("driver", ["enc_dec_ctc_beam_inference_test",
                                    "enc_dec_inference_test -mode joint"])
def test_joint_ctc_beam_matches_jax(driver, joint, tmp_path):
    jax_out, j, argv = joint
    port_module, flags = {
        "enc_dec_ctc_beam_inference_test": (enc_dec_ctc_beam_inference_test, []),
        "enc_dec_inference_test -mode joint": (enc_dec_inference_test, ["-mode", "joint"]),
    }[driver]
    port_out = port_module.cli(argv + flags + ["-s", str(tmp_path / "port.pkl"), "--device",
                                               "cpu"] + KWARGS, jax_params=jax_params())
    p = load(tmp_path / "port_1.pkl")
    assert_same_run(jax_out, port_out, j, p)
    assert p["args_dict"]["mode"] == "joint"


def test_dynamic_eval_driver_matches_jax(tmp_path, monkeypatch):
    """``teacher_ce`` on the first record (401 frames, one chunk at seq_len
    512; its teacher cannot align to the chunk's 101 frames)."""
    compiled_updates(monkeypatch)
    with feasibility_log(monkeypatch) as feasible:
        jax_out, port_out, j, p = run_pair(
            jax_tta, enc_dec_dynamic_eval_test, tmp_path,
            flags=("--breaks", "--training_mode", "teacher_ce"), kwargs=("seq_len=512",))
    assert feasible == [False]
    assert_same_run(jax_out, port_out, j, p, n_records=1)
    assert p["args_dict"]["training_mode"] == "teacher_ce" and p["args_dict"]["breaks"]
