"""NSTI sequence-length scaling driver.

Counterpart of the JAX package's ``evals/run_seq_eval.py``: keep the
recordings of at least ``--min_duration`` seconds (the audio file's
duration; records without a file are kept), split each into outer chunks of
``--nsti_seq_len`` / ``--nsti_overlap`` frames, run the full NSTI engine on
each outer chunk from the pristine weights (its windows ``--seq_len`` /
``--overlap``), then stitch the chunks' probabilities a second time on the
host in float64 (:func:`seq_eval_one`).  With ``epochs=0`` the whole
recording is one chunk: plain windowed inference.  Runs on ``cuda`` unless
``--device cpu`` is given.

CLI: ``python -m dynamic_asr_eval_tpu_torch.evals.run_seq_eval -d earnings22
--nsti_seq_len 32768 --nsti_overlap 28672 -kwargs epochs=1``
"""

from __future__ import annotations

import argparse
from typing import Mapping, Optional

import numpy as np

from dynamic_asr_eval_tpu_torch.audio.io import audio_duration_seconds
from dynamic_asr_eval_tpu_torch.config import apply_args
from dynamic_asr_eval_tpu_torch.data import get_dataset
from dynamic_asr_eval_tpu_torch.evals.common import (
    build_engine,
    evaluate_records,
    load_model_and_tokenizer,
    save_result_pickle,
)
from dynamic_asr_eval_tpu_torch.models import ConformerConfig
from dynamic_asr_eval_tpu_torch.ops.chunk import chunk_starts_and_lengths
from dynamic_asr_eval_tpu_torch.ops.ctc import greedy_decode
from dynamic_asr_eval_tpu_torch.text import normalize


def seq_eval_one(engine, params, spec, args, ds: int, vocab_plus: int) -> np.ndarray:
    """Stitched log-probs [positions, vocab_plus] float32 of one recording:
    each outer chunk's engine output placed ``int(overlap / (L / ds_len))``
    positions back from the end of the previous one, probabilities averaged
    where they overlap."""
    spec = np.asarray(spec)
    if spec.ndim == 3:
        spec = spec[0]
    spec_n = spec.shape[-1]
    outer_len = args.nsti_seq_len if args.nsti_seq_len != -1 else spec_n
    outer_overlap = args.nsti_overlap
    if args.__dict__.get("epochs", 1) == 0:
        outer_len, outer_overlap = spec_n, 0

    starts, lens = chunk_starts_and_lengths(spec_n, outer_len, outer_overlap)
    total = spec_n // ds + outer_len // ds + 8
    acc = np.zeros((total, vocab_plus), np.float64)
    counts = np.zeros((total,), np.float64)
    pos = 0
    for k, (s, L) in enumerate(zip(starts, lens)):
        lp = engine(params, spec[:, s : s + L], args.seq_len, args.overlap).numpy_logits()
        ds_len = lp.shape[0]
        overlap_ds = int(outer_overlap / (L / ds_len)) if L else 0
        pos -= overlap_ds if k != 0 else 0
        acc[pos : pos + ds_len] += np.exp(lp)
        counts[pos : pos + ds_len] += 1
        pos += ds_len
    nz = counts > 0
    return np.log(np.maximum(acc[nz] / counts[nz, None], 1e-12)).astype(np.float32)


def main(args, model_config: Optional[ConformerConfig] = None,
         jax_params: Optional[Mapping] = None) -> float:
    """Returns the corpus WER (``model_config`` and ``jax_params`` as in
    :func:`.run.main`)."""
    model, params, tokenizer, cfg = load_model_and_tokenizer(
        args, config=model_config, jax_params=jax_params)
    engine = build_engine(args, model, cfg)
    records = get_dataset(args.dataset, args.split)

    min_dur = getattr(args, "min_duration", 0.0)
    if min_dur > 0:
        kept = []
        for rec in records:
            if rec.get("audio") and isinstance(rec["audio"], str):
                d = audio_duration_seconds(rec["audio"])
                if d is not None and d < min_dur:
                    continue
            kept.append(rec)
        records = kept

    def run_one(rec):
        spec, gold = rec["process_fn"](rec)
        logits = seq_eval_one(engine, params, spec, args, cfg.subsampling_factor, cfg.n_classes)
        return normalize(greedy_decode(logits, tokenizer, cfg.blank_id)), gold

    wer, detail = evaluate_records(records, run_one, verbose=not getattr(args, "quiet", False))
    print(f"WER: {wer}")
    if getattr(args, "save_path", ""):
        save_result_pickle(args.save_path, detail, args, 0, 1)
    return wer


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-d", "--dataset", type=str, default="synthetic")
    parser.add_argument("--nsti_seq_len", type=int, default=-1)
    parser.add_argument("--nsti_overlap", type=int, default=0)
    parser.add_argument("--min_duration", type=float, default=0.0,
                        help="keep only recordings at least this long (seconds)")
    parser.add_argument("-s", "--save_path", type=str, default="")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    parser.add_argument("--tokenizer", type=str, default="")
    parser.add_argument("--quiet", action="store_true")
    return apply_args(parser, argv)


def cli(argv=None, model_config: Optional[ConformerConfig] = None,
        jax_params: Optional[Mapping] = None) -> float:
    return main(parse_args(argv), model_config=model_config, jax_params=jax_params)


if __name__ == "__main__":
    cli()
