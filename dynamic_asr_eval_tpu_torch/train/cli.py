"""NST finetuning CLI.

    python -m dynamic_asr_eval_tpu_torch.train.cli -config cfg.yaml \\
        [--data manifest.json] [--resume ckpt] [--max_recordings n] [--device cpu]

Counterpart of the JAX package's ``train/cli.py`` (the reference's
``python earnings_finetune/train.py -config cfg.yaml``): reads an
lcasr160rb1-style yaml (sections ``model``, filtered to the
``ConformerConfig`` fields, so ``attention_impl`` / ``subsampling_impl`` /
``compute_dtype`` pass through; ``optimizer.args.lr``,
``scheduler.warmup_steps``, ``training.*``, ``audio_chunking.*``,
``spec_augment.*``, ``checkpointing.dir``), builds the model from
``training.random_seed`` and the trainer, and trains on a JSON manifest
(``[{"id", "audio", "text"}]``, audio read by :mod:`..audio.io` and
featurized by :mod:`..audio.features`) or, without ``--data``, the
four-record synthetic set.  A yaml file that is JSON (flow-style YAML) needs
no PyYAML.  Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-config", "--config", type=str, required=True)
    parser.add_argument("--data", type=str, default="",
                        help="JSON manifest [{'id','audio','text'}]; synthetic if empty")
    parser.add_argument("--resume", type=str, default="")
    parser.add_argument("--max_recordings", type=int, default=0)
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from dynamic_asr_eval_tpu_torch.config import SpecAugmentConfig, load_yaml
    from dynamic_asr_eval_tpu_torch.device import resolve_device
    from dynamic_asr_eval_tpu_torch.models import ConformerConfig, init_conformer
    from dynamic_asr_eval_tpu_torch.text import load_tokenizer
    from dynamic_asr_eval_tpu_torch.train import NSTTrainer, SimpleDataset, TrainConfig

    device = resolve_device(args.device)
    raw = load_yaml(args.config)
    tokenizer = load_tokenizer(raw.get("tokenizer") or None)
    fields = {f.name for f in dataclasses.fields(ConformerConfig)}
    mc = {k: v for k, v in dict(raw.get("model", {})).items() if k in fields}
    mc.setdefault("vocab_size", tokenizer.vocab_size())
    cfg = ConformerConfig.from_dict(mc)

    training = raw.get("training", {})
    chunking = raw.get("audio_chunking", {})
    sa = raw.get("spec_augment", {})
    tcfg = TrainConfig(
        peak_lr=float(raw.get("optimizer", {}).get("args", {}).get("lr", 1e-5)),
        warmup_steps=int(raw.get("scheduler", {}).get("warmup_steps", 1)),
        ema_decay=float(training.get("ema_decay", 0.8)),
        clip_value=float(training.get("clip_value", 0.8)),
        batch_size=int(training.get("batch_size", 4)),
        seq_len=int(chunking.get("size", 16384)),
        overlap=int(chunking.get("overlap", 0)),
        max_epochs=int(training.get("max_epochs", 1)),
        checkpoint_dir=str(raw.get("checkpointing", {}).get("dir", "checkpoints")),
        spec_augment=SpecAugmentConfig(
            n_time_masks=int(sa.get("n_time_masks", 0)),
            time_mask_param=int(sa.get("time_mask_param", -1)),
            n_freq_masks=int(sa.get("n_freq_masks", 6)),
            freq_mask_param=int(sa.get("freq_mask_param", 34)),
            min_p=float(sa.get("min_p", 0.0)),
            max_p=float(sa.get("max_p", 0.5)),
            zero_masking=bool(sa.get("zero_masking", False)),
        ),
        seed=int(training.get("random_seed", 8241)),
    )

    model = init_conformer(cfg, seed=tcfg.seed)
    trainer = NSTTrainer(model, None, cfg, tcfg, device=device)

    if args.data:
        with open(args.data, "r") as f:
            records = json.load(f)
        from dynamic_asr_eval_tpu_torch.audio.features import log_mel_spectrogram
        from dynamic_asr_eval_tpu_torch.audio.io import load_audio

        def process_fn(rec):
            return log_mel_spectrogram(load_audio(rec["audio"]))
    else:
        records = [{"id": f"synthetic_{i}", "duration": 10.0 + i, "text": "synthetic"}
                   for i in range(4)]

        def process_fn(rec):
            seed = int(rec["id"].rsplit("_", 1)[1])
            return np.random.default_rng(seed).standard_normal(
                (cfg.feat_in, 2000 + 500 * seed)).astype(np.float32)

    if args.max_recordings:
        records = records[: args.max_recordings]
    dataset = SimpleDataset(records)
    if args.resume:
        trainer.resume(args.resume, dataset)
    trainer.train(dataset, process_fn)
    print(f"training done: {trainer.step_count} steps, "
          f"{trainer.recordings_seen} recordings")
    return trainer


if __name__ == "__main__":
    main()
