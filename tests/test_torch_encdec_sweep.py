"""The port's sweep runner (``evals/run_sweep.py``) with each
encoder-decoder ``-run_script`` against the JAX package's, the real drivers
on ``-d synthetic`` with shared weights (tests/test_torch_encdec_drivers.py:
the JAX drivers' default model from ``-kwargs seed=N``, its variables handed
to the port), an offline grid of one trial: the same results JSONL and the
same best run.  Each record is one chunk (seq_len 512);
``enc_dec_dynamic_eval_test`` runs ``--training_mode teacher_ce --breaks``,
JAX's updates through ``.lower().compile()`` and its CTC gradient stopped
where the teacher cannot align (as there)."""

import json
import math

import pytest
import torch

import dynamic_asr_eval_tpu.evals.run_sweep as jax_sweep
from dynamic_asr_eval_tpu_torch.evals import run_sweep
from test_torch_encdec_drivers import KWARGS, jax_params
from test_torch_encdec_rl import compiled_updates, feasibility_log

torch.set_num_threads(1)

GRID = "method: grid\nmetric: {name: WER, goal: minimize}\nparameters:\n" \
       "  optim_lr: {values: [1.0e-3]}\n"
FLAGS = {"enc_dec_dynamic_eval_test": ["--training_mode", "teacher_ce", "--breaks"],
         "enc_dec_inference_test": [],
         "enc_dec_ctc_beam_inference_test": ["-beams", "3"]}


def jsonl(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("script", run_sweep.ENC_DEC_SCRIPTS)
def test_enc_dec_sweep_matches_jax(script, tmp_path, monkeypatch):
    compiled_updates(monkeypatch)
    cfg = tmp_path / "sweep.yaml"
    cfg.write_text(GRID)
    kwargs = KWARGS + ["seq_len=512"]  # each record one chunk (the drivers test chunks them)
    argv = ["-sc", str(cfg), "--no_wandb", "-run_script", script, "--quiet", *FLAGS[script]]
    with feasibility_log(monkeypatch):
        jax_best = jax_sweep.cli(argv + ["--out", str(tmp_path / "jax.jsonl")] + kwargs)
        port_best = run_sweep.cli(argv + ["--device", "cpu", "--out",
                                          str(tmp_path / "port.jsonl")] + kwargs,
                                  jax_params=jax_params())
    got, want = jsonl(tmp_path / "port.jsonl"), jsonl(tmp_path / "jax.jsonl")
    assert got == want and port_best == jax_best
    assert len(got) == 1 and math.isfinite(got[0]["WER"])
