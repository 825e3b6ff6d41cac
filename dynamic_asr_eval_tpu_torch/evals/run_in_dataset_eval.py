"""In-dataset transfer driver: adapt on record 0, evaluate records 1..N with
the adapted (frozen) weights.

Counterpart of the JAX package's ``evals/run_in_dataset_eval.py``: the NSTI
engine adapts on the first record with ``return_params=True``; the other
records run through the evaluation engine (``epochs=0, online=False``:
windowed inference) with the adapted state dict.  ``-ao/--adapt_overlap``
sets the adaptation's overlap only.  Runs on ``cuda`` unless ``--device
cpu`` is given.

CLI: ``python -m dynamic_asr_eval_tpu_torch.evals.run_in_dataset_eval -d
synthetic -ao 14336 -kwargs epochs=1``
"""

from __future__ import annotations

import argparse
from typing import Mapping, Optional

from dynamic_asr_eval_tpu_torch.config import apply_args
from dynamic_asr_eval_tpu_torch.data import get_dataset
from dynamic_asr_eval_tpu_torch.evals.common import (
    adapt_overlap,
    append_log,
    build_engine,
    build_eval_engine,
    evaluate_with,
    load_model_and_tokenizer,
    save_result_pickle,
)
from dynamic_asr_eval_tpu_torch.models import ConformerConfig


def main(args, model_config: Optional[ConformerConfig] = None,
         jax_params: Optional[Mapping] = None) -> float:
    """Returns the corpus WER of records 1..N (``model_config`` and
    ``jax_params`` as in :func:`.run.main`)."""
    model, params, tokenizer, cfg = load_model_and_tokenizer(
        args, config=model_config, jax_params=jax_params)
    engine = build_engine(args, model, cfg)
    eval_engine = build_eval_engine(model, cfg, engine)
    records = get_dataset(args.dataset, args.split)

    spec0, _ = records[0]["process_fn"](records[0])
    adapted = engine(params, spec0, args.seq_len, adapt_overlap(args), return_params=True).params

    wer, detail = evaluate_with(eval_engine, adapted, records[1:], args, tokenizer)
    print(f"WER: {wer}")
    append_log(getattr(args, "log", ""), f"in_dataset\t{args.dataset}\tWER: {wer}")
    if getattr(args, "save_path", ""):
        save_result_pickle(args.save_path, detail, args, 0, 1)
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
