"""Half-concat adaptation driver.

Counterpart of the JAX package's ``evals/run_half_concat_eval.py``: split
the dataset's recordings into two halves, concatenate one half's
spectrograms on the time axis, adapt on the concatenation in an adapt-only
pass (``adapt_only=True``: no stitched log-probs), evaluate the held-out
half with the adapted weights; the same with the halves swapped, and the
no-adapt baseline.  ``-ao/--adapt_overlap`` sets the adaptation's overlap
only.  ``-s`` pickles ``{"folds", "baseline", "args_dict"}``.  Runs on
``cuda`` unless ``--device cpu`` is given.

CLI: ``python -m dynamic_asr_eval_tpu_torch.evals.run_half_concat_eval -d
earnings22 -ao 14336 -kwargs epochs=1``
"""

from __future__ import annotations

import argparse
import pickle
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from dynamic_asr_eval_tpu_torch.config import apply_args
from dynamic_asr_eval_tpu_torch.data import get_dataset
from dynamic_asr_eval_tpu_torch.evals.common import (
    adapt_overlap,
    build_engine,
    build_eval_engine,
    evaluate_with,
    load_model_and_tokenizer,
)
from dynamic_asr_eval_tpu_torch.models import ConformerConfig


def split_records(records: Sequence, fold: int) -> Tuple[Sequence, Sequence]:
    """``(adapt half, evaluation half)``: fold 0 adapts on the first
    ``len // 2`` records, fold 1 on the rest."""
    half = len(records) // 2
    if fold == 0:
        return records[:half], records[half:]
    return records[half:], records[:half]


def concatenate_specs(specs) -> np.ndarray:
    """Time-axis concatenation of [F, T] or [1, F, T] spectrograms to one
    [F, sum T]."""
    specs = [np.asarray(s)[0] if np.asarray(s).ndim == 3 else np.asarray(s) for s in specs]
    return np.concatenate(specs, axis=-1)


def adapt_on_concat(engine, params, records: List[Dict], seq_len: int,
                    overlap: int) -> Dict:
    """The adapted state dict of an adapt-only pass over the concatenation
    of ``records``' spectrograms; ``params`` is not modified."""
    concat = concatenate_specs([rec["process_fn"](rec)[0] for rec in records])
    return engine(params, concat, seq_len, overlap, return_params=True, adapt_only=True).params


def main(args, model_config: Optional[ConformerConfig] = None,
         jax_params: Optional[Mapping] = None) -> float:
    """Returns the mean WER of the two folds (``model_config`` and
    ``jax_params`` as in :func:`.run.main`)."""
    model, params, tokenizer, cfg = load_model_and_tokenizer(
        args, config=model_config, jax_params=jax_params)
    engine = build_engine(args, model, cfg)
    eval_engine = build_eval_engine(model, cfg, engine)
    records = get_dataset(args.dataset, args.split)

    results = {"folds": [], "baseline": None}
    base_wer, results["baseline"] = evaluate_with(eval_engine, params, records, args, tokenizer)
    print(f"baseline WER: {base_wer}")

    for fold in (0, 1):
        adapt_half, eval_half = split_records(records, fold)
        adapted = adapt_on_concat(engine, params, adapt_half, args.seq_len, adapt_overlap(args))
        wer, detail = evaluate_with(eval_engine, adapted, eval_half, args, tokenizer)
        results["folds"].append({"fold": fold, "wer": wer, "detail": detail})
        print(f"fold {fold}: adapted-on {len(adapt_half)} recs, eval WER {wer}")

    mean_wer = sum(f["wer"] for f in results["folds"]) / 2
    print(f"mean half-concat WER: {mean_wer} (baseline {base_wer})")
    if getattr(args, "save_path", ""):
        results["args_dict"] = vars(args)
        with open(args.save_path, "wb") as f:
            pickle.dump(results, f)
    return mean_wer


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
