"""The port's NST CLI (``train/cli.py``) against the JAX package's on one
tiny yaml: the same steps and recordings, the model section filtered to the
config's fields, the checkpoint written; ``--data`` with wav files and
``--resume`` on the port's side.  The yaml is written in flow style (JSON),
which the port reads without PyYAML and JAX reads with it."""

import json
import os
import wave

import numpy as np
import pytest
import torch

from dynamic_asr_eval_tpu.train import cli as jax_cli
from dynamic_asr_eval_tpu_torch.config import load_yaml
from dynamic_asr_eval_tpu_torch.train import cli as port_cli
from test_torch_engine import rolled_scans

torch.set_num_threads(1)

MODEL = dict(feat_in=16, n_layers=1, d_model=32, n_heads=2, head_dim=16, subsampling_factor=4,
             subsampling_conv_channels=8, conv_kernel_size=5, compute_dtype="float32",
             attention_impl="pallas_flash", subsampling_impl="conv",
             not_a_config_field=1)  # filtered out by both CLIs


def write_yaml(path, ckpt_dir, model=MODEL, size=256, batch=2):
    raw = {"model": model, "optimizer": {"args": {"lr": 1e-4}},
           "scheduler": {"warmup_steps": 2},
           "training": {"batch_size": batch, "ema_decay": 0.8, "clip_value": 0.8,
                        "max_epochs": 1, "random_seed": 3},
           "audio_chunking": {"size": size, "overlap": 0},
           "spec_augment": {"n_freq_masks": 2, "freq_mask_param": 4},
           "checkpointing": {"dir": str(ckpt_dir)}}
    path.write_text(json.dumps(raw, indent=1))
    return str(path)


def test_cli_runs_the_steps_and_recordings_of_jax(tmp_path, capsys):
    """Synthetic records of 2000 and 2500 frames in 256-frame windows (T_ds
    64: JAX's ``"pallas_flash"`` runs its XLA attention there) at batch 2:
    4 + 5 steps."""
    jax_yaml = write_yaml(tmp_path / "jax.yaml", tmp_path / "jax_ckpt")
    port_yaml = write_yaml(tmp_path / "port.yaml", tmp_path / "port_ckpt")
    with rolled_scans():
        jt = jax_cli.main(["-config", jax_yaml, "--max_recordings", "2"])
    jax_out = capsys.readouterr().out
    pt = port_cli.main(["-config", port_yaml, "--max_recordings", "2", "--device", "cpu"])
    port_out = capsys.readouterr().out
    assert (pt.step_count, pt.recordings_seen) == (jt.step_count, jt.recordings_seen) == (9, 2)
    assert port_out.splitlines()[-1] == jax_out.splitlines()[-1] == (
        "training done: 9 steps, 2 recordings")
    cfg = pt.model_config
    assert (cfg.feat_in, cfg.vocab_size, cfg.attention_impl, cfg.compute_dtype) == (
        16, 28, "pallas_flash", torch.float32)
    assert pt.cfg.spec_augment.n_freq_masks == 2 and pt.cfg.warmup_steps == 2
    assert pt.device.type == "cpu" and pt.generator.initial_seed() == 3
    for d in ("jax_ckpt", "port_ckpt"):
        assert os.path.exists(tmp_path / d / "epoch_0.ckpt")
        assert os.path.exists(tmp_path / d / "epoch_0.ckpt.train_state.pkl")


def write_wav(path, seconds, seed):
    x = np.random.default_rng(seed).uniform(-0.3, 0.3, int(16000 * seconds))
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((x * 32767).astype(np.int16).tobytes())
    return str(path)


def test_cli_with_wav_data_and_resume(tmp_path):
    """Two 0.5 s wavs (51 frames each) in 32-frame windows at batch 2: one
    step a recording; ``--resume`` picks up the step count and the seen
    records."""
    manifest = tmp_path / "data.json"
    manifest.write_text(json.dumps([
        {"id": f"utt{i}", "audio": write_wav(tmp_path / f"{i}.wav", 0.5, i), "text": "x"}
        for i in range(2)]))
    yaml_path = write_yaml(tmp_path / "c.yaml", tmp_path / "ckpt", model=dict(MODEL, feat_in=80),
                           size=32)
    first = port_cli.main(["-config", yaml_path, "--data", str(manifest), "--device", "cpu"])
    assert (first.step_count, first.recordings_seen) == (2, 2)
    ckpt = str(tmp_path / "ckpt" / "epoch_0.ckpt")
    again = port_cli.main(["-config", yaml_path, "--data", str(manifest), "--device", "cpu",
                           "--resume", ckpt])
    assert (again.step_count, again.recordings_seen) == (4, 4)


def test_yaml_is_read_with_and_without_pyyaml(tmp_path, monkeypatch):
    """A flow-style (JSON) file needs no PyYAML; a block-style one goes
    through it, to the same dict."""
    import sys

    flow = write_yaml(tmp_path / "flow.yaml", tmp_path)
    block = tmp_path / "block.yaml"
    block.write_text("model:\n  feat_in: 16\n  n_layers: 1\ntraining:\n  batch_size: 2\n")
    want = {"model": {"feat_in": 16, "n_layers": 1}, "training": {"batch_size": 2}}
    assert load_yaml(str(block)) == want
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml now fails
    assert load_yaml(flow)["audio_chunking"] == {"size": 256, "overlap": 0}
    with pytest.raises(ImportError):
        load_yaml(str(block))
