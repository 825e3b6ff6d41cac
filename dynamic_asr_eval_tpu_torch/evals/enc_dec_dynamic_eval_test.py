"""Encoder-decoder RL-TTA evaluation driver.

Counterpart of the JAX package's ``evals/enc_dec_dynamic_eval_test.py``:
per-recording TTA by :class:`..tta.encdec_rl.EncDecDynamicEvalEngine` with
``--training_mode {grpo, maxrl, teacher_ce}``, the teacher-filter flags
(:func:`add_teacher_filter_args`), ``--breaks`` (the first recording only),
chunks of ``seq_len`` frames; then the normalizer, the corpus WER, a log
line and the result pickle.  Runs on ``cuda`` unless ``--device cpu`` is
given.

CLI: ``python -m dynamic_asr_eval_tpu_torch.evals.enc_dec_dynamic_eval_test
-d synthetic --training_mode teacher_ce -seq 2048 -kwargs optim_lr=9e-6``
"""

from __future__ import annotations

import argparse
from typing import Mapping, Optional

from dynamic_asr_eval_tpu_torch.config import TTAConfig, apply_args
from dynamic_asr_eval_tpu_torch.data import get_dataset
from dynamic_asr_eval_tpu_torch.evals.common import append_log, evaluate_records, save_result_pickle
from dynamic_asr_eval_tpu_torch.evals.enc_dec_inference_test import load_encdec_from_args
from dynamic_asr_eval_tpu_torch.models.encdec import EncDecConfig
from dynamic_asr_eval_tpu_torch.text import load_tokenizer, normalize
from dynamic_asr_eval_tpu_torch.tta.encdec_rl import TRAINING_MODES, EncDecDynamicEvalEngine
from dynamic_asr_eval_tpu_torch.tta.filters import TeacherFilterConfig


def add_teacher_filter_args(parser: argparse.ArgumentParser):
    """The teacher-filter flags (:class:`..tta.filters.TeacherFilterConfig`)."""
    parser.add_argument("--teacher_filter_max_length", action="store_true")
    parser.add_argument("--teacher_min_frames_per_token", type=int, default=8)
    parser.add_argument("--teacher_filter_max_consecutive_token_repeat", action="store_true")
    parser.add_argument("--teacher_max_consecutive_token_repeat", type=int, default=3)
    parser.add_argument("--teacher_filter_repeated_token_ngrams", action="store_true")
    parser.add_argument("--teacher_repeated_token_ngram_sizes", type=int, nargs="+", default=[2, 3])
    parser.add_argument("--teacher_repeated_token_ngram_min_repeats", type=int, default=2)
    parser.add_argument("--teacher_filter_decode_agreement", action="store_true")
    parser.add_argument("--teacher_decode_agreement_temperature", type=float, default=0.7)
    parser.add_argument("--teacher_decode_agreement_min_similarity", type=float, default=0.65)
    parser.add_argument("--teacher_filter_low_confidence", action="store_true")
    parser.add_argument("--teacher_min_mean_max_prob", type=float, default=0.35)
    parser.add_argument("--teacher_max_mean_entropy", type=float, default=2.5)
    parser.add_argument("--teacher_filter_repeated_words", action="store_true")
    parser.add_argument("--teacher_max_consecutive_word_repeat", type=int, default=3)
    parser.add_argument("--teacher_filter_ctc_agreement", action="store_true")
    parser.add_argument("--teacher_ctc_agreement_min_similarity", type=float, default=0.5)
    return parser


def build_engine(args, model, cfg: EncDecConfig) -> EncDecDynamicEvalEngine:
    """The driver's engine, on ``--device``."""
    return EncDecDynamicEvalEngine(
        model, cfg, TTAConfig.from_args(args),
        filter_config=TeacherFilterConfig.from_args(args),
        training_mode=getattr(args, "training_mode", "grpo"),
        device=getattr(args, "device", None),
    )


def main(args, model_config: Optional[EncDecConfig] = None,
         jax_params: Optional[Mapping] = None) -> float:
    """Returns the corpus WER.  ``model_config`` and ``jax_params`` go to
    :func:`..evals.enc_dec_inference_test.load_encdec_from_args`."""
    tokenizer = load_tokenizer(getattr(args, "tokenizer", None) or None)
    model, params, cfg = load_encdec_from_args(args, tokenizer, model_config, jax_params)
    records = get_dataset(args.dataset, args.split)
    if getattr(args, "breaks", False):
        records = records[:1]
    engine = build_engine(args, model, cfg)

    def run_one(rec):
        spec, gold = rec["process_fn"](rec)
        transcript, _, _ = engine(params, spec, args.seq_len, tokenizer)
        return normalize(transcript), gold

    wer, detail = evaluate_records(records, run_one, verbose=not getattr(args, "quiet", False))
    print(f"WER: {wer}")
    append_log(getattr(args, "log", ""), f"enc_dec_tta\t{args.training_mode}\tWER: {wer}")
    if getattr(args, "save_path", ""):
        save_result_pickle(args.save_path, detail, args, 0, 1)
    return wer


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-d", "--dataset", type=str, default="synthetic")
    parser.add_argument("--training_mode", type=str, default="grpo", choices=list(TRAINING_MODES))
    parser.add_argument("--breaks", action="store_true", help="single-recording debug mode")
    parser.add_argument("-s", "--save_path", type=str, default="")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    parser.add_argument("--tokenizer", type=str, default="")
    parser.add_argument("--quiet", action="store_true")
    add_teacher_filter_args(parser)
    return apply_args(parser, argv)


def cli(argv=None, model_config: Optional[EncDecConfig] = None,
        jax_params: Optional[Mapping] = None) -> float:
    return main(parse_args(argv), model_config=model_config, jax_params=jax_params)


if __name__ == "__main__":
    cli()
