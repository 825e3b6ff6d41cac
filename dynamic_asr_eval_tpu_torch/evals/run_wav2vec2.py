"""wav2vec2 waveform-domain evaluation driver.

Counterpart of the JAX package's ``evals/run_wav2vec2.py``: waveform-domain
TTA with the WavAugment-style chain (:func:`..augment.waveform.
wav_augment_pipeline`), either over the whole recording in windows (the NSTI
engine, :class:`..tta.DynamicEvalEngine`, with ``feat_extract_output_lengths``
as its output length and the vocabulary as its class count) or, with
``--per_utterance``, the recording as one utterance of the utterance engine
(``--loss_norm`` ctc_mean and ``--clip_norm`` 10 by default, the reference's
per-utterance loop).  ``-d synthetic`` synthesizes sine-plus-noise waves
(:func:`_wave_records`); other datasets read each record's audio file.

The model is wav2vec2-base with ``--full_size`` (12 × 768, 12 heads, ff
3072, conv 512, positional conv 128 in 16 groups) and a tiny one otherwise,
random from ``--seed``, or HF weights from ``--checkpoint``; the input is
normalized as the HF processor does unless ``--raw_input``.  The frame-domain
window defaults (16384 / 14336) become 48000 / 16000 samples.  Runs on
``cuda`` unless ``--device cpu`` is given.

CLI: ``python -m dynamic_asr_eval_tpu_torch.evals.run_wav2vec2 -d synthetic
-kwargs epochs=1 online=true``
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from dynamic_asr_eval_tpu_torch.audio.io import load_audio
from dynamic_asr_eval_tpu_torch.augment.waveform import wav_augment_pipeline
from dynamic_asr_eval_tpu_torch.config import TTAConfig, apply_args
from dynamic_asr_eval_tpu_torch.data import get_dataset
from dynamic_asr_eval_tpu_torch.device import resolve_device
from dynamic_asr_eval_tpu_torch.evals.common import append_log, evaluate_records, save_result_pickle
from dynamic_asr_eval_tpu_torch.models.checkpoint import load_torch_checkpoint
from dynamic_asr_eval_tpu_torch.models.wav2vec2 import (
    Wav2Vec2Config,
    feat_extract_output_lengths,
    init_wav2vec2,
    load_hf_weights,
)
from dynamic_asr_eval_tpu_torch.ops.ctc import greedy_decode
from dynamic_asr_eval_tpu_torch.text import CharTokenizer, normalize
from dynamic_asr_eval_tpu_torch.tta import DynamicEvalEngine
from dynamic_asr_eval_tpu_torch.tta.utterance import UtteranceTTAEngine

BLANK = 0  # HF convention


def _wave_records(args):
    if args.dataset == "synthetic":
        sr = 16000
        texts = ["the quick brown fox", "adaptation at test time"]
        out = []
        for i, t in enumerate(texts):
            rng = np.random.default_rng(i)
            n = int(4.0 * sr)
            wave = (0.1 * np.sin(2 * np.pi * (180 + 60 * i) * np.arange(n) / sr)
                    + 0.01 * rng.standard_normal(n)).astype(np.float32)
            out.append({"id": f"synthetic_{i}", "text": t, "wave": wave})
        return out
    return [{"id": rec["id"], "text": rec["text"], "audio": rec["audio"], "_orig": rec}
            for rec in get_dataset(args.dataset, args.split)
            if isinstance(rec.get("audio"), str)]


def default_config(args, tokenizer) -> Wav2Vec2Config:
    """wav2vec2-base with ``--full_size``, else the tiny model; input
    normalized unless ``--raw_input``."""
    norm_in = not getattr(args, "raw_input", False)
    if getattr(args, "full_size", False):
        return Wav2Vec2Config(vocab_size=tokenizer.vocab_size() + 1, normalize_input=norm_in)
    return Wav2Vec2Config(
        vocab_size=tokenizer.vocab_size() + 1, hidden=64, n_layers=2, n_heads=2, ff_dim=128,
        conv_dim=32, pos_conv_kernel=16, pos_conv_groups=4, normalize_input=norm_in)


def build_engine(args, model, cfg: Wav2Vec2Config):
    """The utterance engine with ``--per_utterance``, else the windowed NSTI
    engine; both augment with the waveform chain."""
    def aug(batch, generator, length):  # [B, 1, W]
        return wav_augment_pipeline(
            batch[:, 0, :], generator,
            n_time_dropout=int(vars(args).get("n_time_dropout", 100)))[:, None, :]

    tta = TTAConfig.from_args(args)
    device = getattr(args, "device", None)
    if getattr(args, "per_utterance", False):
        return UtteranceTTAEngine(
            model, BLANK, cfg.downsampling_factor, tta, augment_fn=aug,
            accumulate_gradients=int(vars(args).get("accumulate_gradients", 1)),
            prob_collection=str(vars(args).get("prob_collection", "online")),
            # the reference's per-utterance loop: CTCLoss(reduction='mean'), clip 10
            loss_norm=str(vars(args).get("loss_norm", "ctc_mean")),
            clip_norm=float(vars(args).get("clip_norm", 10.0)),
            device=device)
    return DynamicEvalEngine(
        model, BLANK, cfg.downsampling_factor, tta, augment_fn=aug,
        out_len_fn=lambda W: int(feat_extract_output_lengths(cfg, W)),
        n_classes=cfg.vocab_size, device=device)


def main(args, model_config: Optional[Wav2Vec2Config] = None) -> float:
    """Returns the corpus WER.  ``model_config`` (an in-memory
    :class:`Wav2Vec2Config`) replaces the ``--full_size`` choice."""
    device = resolve_device(getattr(args, "device", None))
    tokenizer = CharTokenizer()
    cfg = model_config if model_config is not None else default_config(args, tokenizer)
    model = init_wav2vec2(cfg, seed=int(getattr(args, "seed", 0) or 0))
    if getattr(args, "checkpoint", ""):
        state, _ = load_torch_checkpoint(args.checkpoint)
        model.load_state_dict(load_hf_weights(state, cfg), strict=True)
    model = model.to(device)
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}

    # seq / overlap count samples here: the frame-domain defaults become
    # sample-domain ones (multiples of 320)
    if args.seq_len == 16384 and args.overlap == 14336:
        args.seq_len, args.overlap = 48000, 16000
    engine = build_engine(args, model, cfg)
    per_utterance = getattr(args, "per_utterance", False)

    def run_one(rec):
        wave = rec.get("wave")
        if wave is None:
            wave = load_audio(rec["audio"])
        if per_utterance:  # the whole recording as one utterance
            outs, _, _ = engine(params, [{"spectrogram": wave[None]}])
            return normalize(greedy_decode(outs[0], tokenizer, BLANK)), normalize(rec["text"])
        out = engine(params, wave[None], args.seq_len, args.overlap)
        ids = out.greedy_ids()
        return normalize(tokenizer.decode([int(i) for i in ids])), normalize(rec["text"])

    wer, detail = evaluate_records(_wave_records(args), run_one,
                                   verbose=not getattr(args, "quiet", False))
    print(f"WER: {wer}")
    append_log(getattr(args, "log", ""), f"wav2vec2\t{args.dataset}\tWER: {wer}")
    if getattr(args, "save_path", ""):
        save_result_pickle(args.save_path, detail, args, 0, 1)
    return wer


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-d", "--dataset", type=str, default="synthetic")
    parser.add_argument("--per_utterance", action="store_true",
                        help="utterance-level TTA with gradient accumulation")
    parser.add_argument("--full_size", action="store_true",
                        help="wav2vec2-base dimensions (default: tiny)")
    parser.add_argument("-s", "--save_path", type=str, default="")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    parser.add_argument("--prob_collection", choices=["online", "final"], default="online")
    parser.add_argument("--loss_norm", choices=["frames", "ctc_mean"], default="ctc_mean",
                        help="per-utterance CTC loss normalization: the reference's "
                             "CTCLoss(reduction='mean') (ctc_mean) or frames x negatives")
    parser.add_argument("--clip_norm", type=float, default=10.0,
                        help="grad-norm clip for per-utterance TTA (the reference clips at 10)")
    parser.add_argument("--raw_input", action="store_true",
                        help="skip the HF processor's per-sequence zero-mean/unit-var "
                             "input normalization")
    parser.add_argument("--quiet", action="store_true")
    return apply_args(parser, argv)


def cli(argv=None, model_config: Optional[Wav2Vec2Config] = None) -> float:
    return main(parse_args(argv), model_config=model_config)


if __name__ == "__main__":
    cli()
