"""Within-recording leave-one-out driver.

Counterpart of the JAX package's ``evals/run_within_recording_loo_eval.py``:
two levels of chunks, outer LOO chunks (``--loo_seq_len`` /
``--loo_overlap``, default 65536 / 57344) over the engine's windows
(``--seq_len`` / ``--overlap``).  For each outer chunk i that has an
audio-disjoint partner: adapt on it, then run windowed inference on the
chunks j that share no frame with it (:func:`loo_eval`).  Their
probabilities are averaged per downsampled position on the host in float64;
positions that no partner covers inside the covered span are reported and
dropped before the greedy decode.  With fewer than two chunks, or no
disjoint pair, the recording is evaluated without adaptation.  Runs on
``cuda`` unless ``--device cpu`` is given.

CLI: ``python -m dynamic_asr_eval_tpu_torch.evals.run_within_recording_loo_eval
-d earnings22 --loo_seq_len 65536 --loo_overlap 57344 -kwargs epochs=1``
"""

from __future__ import annotations

import argparse
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from dynamic_asr_eval_tpu_torch.config import apply_args
from dynamic_asr_eval_tpu_torch.data import get_dataset
from dynamic_asr_eval_tpu_torch.evals.common import (
    build_engine,
    build_eval_engine,
    evaluate_records,
    load_model_and_tokenizer,
    save_result_pickle,
)
from dynamic_asr_eval_tpu_torch.models import ConformerConfig
from dynamic_asr_eval_tpu_torch.ops.chunk import chunk_starts_and_lengths
from dynamic_asr_eval_tpu_torch.ops.ctc import greedy_decode
from dynamic_asr_eval_tpu_torch.text import normalize


def loo_eval(engine, eval_engine, params, spec, args, ds: int,
             vocab_plus: int) -> Tuple[np.ndarray, Dict]:
    """``(log-probs [positions, vocab_plus] float32, {"n_chunks", "mode"})``
    of one recording; ``mode`` is ``"loo"``, ``"fallback_windowed_eval"``
    (one chunk) or ``"fallback_no_disjoint_pairs"``.  ``params`` (a state
    dict) is not modified: each adaptation starts from it."""
    spec = np.asarray(spec)
    if spec.ndim == 3:
        spec = spec[0]
    spec_n = spec.shape[-1]
    starts, lens = chunk_starts_and_lengths(spec_n, args.loo_seq_len, args.loo_overlap)
    n_chunks = len(starts)

    def windowed(weights, sub):
        return eval_engine(weights, sub, args.seq_len, args.overlap)

    if n_chunks <= 1:
        out = windowed(params, spec)
        return out.numpy_logits(), {"n_chunks": n_chunks, "mode": "fallback_windowed_eval"}

    def disjoint(i, j):
        return starts[j] >= starts[i] + lens[i] or starts[i] >= starts[j] + lens[j]

    valid = {i: [j for j in range(n_chunks) if disjoint(i, j)] for i in range(n_chunks)}
    pairs = sum(len(v) for v in valid.values())
    if pairs == 0:
        out = windowed(params, spec)
        return out.numpy_logits(), {"n_chunks": n_chunks, "mode": "fallback_no_disjoint_pairs"}

    usable = [i for i in range(n_chunks) if valid[i]]
    print(f"  {n_chunks} LOO chunks -> {len(usable)} adaptations + {pairs} "
          f"windowed inferences (audio-disjoint LOO)")

    # over-allocated by a chunk's frames and trimmed by coverage below
    total = spec_n // ds + args.loo_seq_len
    acc = np.zeros((total, vocab_plus), np.float64)
    counts = np.zeros((total,), np.float64)

    for i in usable:
        sub_i = spec[:, starts[i] : starts[i] + lens[i]]
        adapted = engine(params, sub_i, args.seq_len, args.overlap, return_params=True).params
        for j in valid[i]:
            sub_j = spec[:, starts[j] : starts[j] + lens[j]]
            lp = windowed(adapted, sub_j).numpy_logits()
            pos = starts[j] // ds
            acc[pos : pos + lp.shape[0]] += np.exp(lp)
            counts[pos : pos + lp.shape[0]] += 1

    nz = counts > 0
    idx = np.flatnonzero(nz)
    if idx.size == 0:
        raise RuntimeError("LOO stitching produced no coverage at any position.")
    span = idx[-1] - idx[0] + 1
    if idx.size != span:
        print(f"  WARNING: audio-disjoint LOO stitching has {span - idx.size} "
              f"uncovered position(s) inside covered span [{idx[0]}, {idx[-1]}]; "
              "uncovered positions are dropped before decoding.")
    logits = np.log(np.maximum(acc[nz] / counts[nz, None], 1e-12)).astype(np.float32)
    return logits, {"n_chunks": n_chunks, "mode": "loo"}


def main(args, model_config: Optional[ConformerConfig] = None,
         jax_params: Optional[Mapping] = None) -> float:
    """Returns the corpus WER (``model_config`` and ``jax_params`` as in
    :func:`.run.main`)."""
    model, params, tokenizer, cfg = load_model_and_tokenizer(
        args, config=model_config, jax_params=jax_params)
    engine = build_engine(args, model, cfg)
    eval_engine = build_eval_engine(model, cfg, engine)
    records = get_dataset(args.dataset, args.split)

    def run_one(rec):
        spec, gold = rec["process_fn"](rec)
        logits, _ = loo_eval(engine, eval_engine, params, spec, args,
                             cfg.subsampling_factor, cfg.n_classes)
        return normalize(greedy_decode(logits, tokenizer, cfg.blank_id)), gold

    wer, detail = evaluate_records(records, run_one, verbose=not getattr(args, "quiet", False))
    print(f"WER: {wer}")
    if getattr(args, "save_path", ""):
        save_result_pickle(args.save_path, detail, args, 0, 1)
    return wer


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-d", "--dataset", type=str, default="synthetic")
    parser.add_argument("--loo_seq_len", type=int, default=65536)
    parser.add_argument("--loo_overlap", type=int, default=57344)
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
