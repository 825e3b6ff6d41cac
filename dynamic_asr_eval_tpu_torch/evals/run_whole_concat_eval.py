"""Whole-concat adaptation driver (the upper bound).

Counterpart of the JAX package's ``evals/run_whole_concat_eval.py``:
concatenate the spectrograms of the whole test set, adapt on the
concatenation in an adapt-only pass (:func:`.run_half_concat_eval.
adapt_on_concat`), then evaluate every recording with the adapted weights.
``-s`` pickles the result detail with ``args_dict``.  Runs on ``cuda``
unless ``--device cpu`` is given.

CLI: ``python -m dynamic_asr_eval_tpu_torch.evals.run_whole_concat_eval -d
earnings22 -kwargs epochs=1``
"""

from __future__ import annotations

import argparse
import pickle
from typing import Mapping, Optional

from dynamic_asr_eval_tpu_torch.config import apply_args
from dynamic_asr_eval_tpu_torch.data import get_dataset
from dynamic_asr_eval_tpu_torch.evals.common import (
    adapt_overlap,
    build_engine,
    build_eval_engine,
    evaluate_with,
    load_model_and_tokenizer,
)
from dynamic_asr_eval_tpu_torch.evals.run_half_concat_eval import adapt_on_concat
from dynamic_asr_eval_tpu_torch.models import ConformerConfig


def main(args, model_config: Optional[ConformerConfig] = None,
         jax_params: Optional[Mapping] = None) -> float:
    """Returns the corpus WER (``model_config`` and ``jax_params`` as in
    :func:`.run.main`)."""
    model, params, tokenizer, cfg = load_model_and_tokenizer(
        args, config=model_config, jax_params=jax_params)
    engine = build_engine(args, model, cfg)
    eval_engine = build_eval_engine(model, cfg, engine)
    records = get_dataset(args.dataset, args.split)

    adapted = adapt_on_concat(engine, params, records, args.seq_len, adapt_overlap(args))
    wer, detail = evaluate_with(eval_engine, adapted, records, args, tokenizer)
    print(f"whole-concat WER: {wer}")
    if getattr(args, "save_path", ""):
        detail["args_dict"] = vars(args)
        with open(args.save_path, "wb") as f:
            pickle.dump(detail, f)
    return wer


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-d", "--dataset", type=str, default="synthetic")
    parser.add_argument("-s", "--save_path", type=str, default="")
    parser.add_argument("-ao", "--adapt_overlap", type=int, default=-1)
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    parser.add_argument("--tokenizer", type=str, default="")
    parser.add_argument("--quiet", action="store_true")
    return apply_args(parser, argv)


def cli(argv=None, model_config: Optional[ConformerConfig] = None,
        jax_params: Optional[Mapping] = None) -> float:
    return main(parse_args(argv), model_config=model_config, jax_params=jax_params)


if __name__ == "__main__":
    cli()
