"""Cross-dataset transfer driver.

Counterpart of the JAX package's ``evals/run_cross_dataset_eval.py``: the
no-adapt baselines of datasets A and B, then for each recording A[i]: adapt
on it, evaluate the adapted weights on all of B (``a_to_b``) and on A
without A[i] (``a_to_a_loo``); each adaptation starts from the pristine
weights.  ``-s`` pickles ``{"a_to_b", "a_to_a_loo", "baselines",
"args_dict"}``.  Runs on ``cuda`` unless ``--device cpu`` is given.

CLI: ``python -m dynamic_asr_eval_tpu_torch.evals.run_cross_dataset_eval
-da tedlium -db earnings22 -kwargs epochs=1``
"""

from __future__ import annotations

import argparse
import pickle
from typing import Dict, Mapping, Optional

from dynamic_asr_eval_tpu_torch.config import apply_args
from dynamic_asr_eval_tpu_torch.data import get_dataset
from dynamic_asr_eval_tpu_torch.evals.common import (
    build_engine,
    build_eval_engine,
    evaluate_with,
    load_model_and_tokenizer,
)
from dynamic_asr_eval_tpu_torch.models import ConformerConfig


def main(args, model_config: Optional[ConformerConfig] = None,
         jax_params: Optional[Mapping] = None) -> Dict:
    """Returns the results dict (``model_config`` and ``jax_params`` as in
    :func:`.run.main`)."""
    model, params, tokenizer, cfg = load_model_and_tokenizer(
        args, config=model_config, jax_params=jax_params)
    engine = build_engine(args, model, cfg)
    eval_engine = build_eval_engine(model, cfg, engine)
    data_a = get_dataset(args.dataset_a, args.split)
    data_b = get_dataset(args.dataset_b, args.split)

    def eval_with(weights, records):
        return evaluate_with(eval_engine, weights, records, args, tokenizer)

    results = {"a_to_b": [], "a_to_a_loo": [], "baselines": {}}
    wer_a, _ = eval_with(params, data_a)
    wer_b, _ = eval_with(params, data_b)
    results["baselines"] = {"a": wer_a, "b": wer_b}
    print(f"baseline A WER: {wer_a}  baseline B WER: {wer_b}")

    for i, rec in enumerate(data_a):
        spec, _ = rec["process_fn"](rec)
        adapted = engine(params, spec, args.seq_len, args.overlap, return_params=True).params
        wer_ab, _ = eval_with(adapted, data_b)
        loo = [r for j, r in enumerate(data_a) if j != i]
        wer_loo, _ = eval_with(adapted, loo) if loo else (float("nan"), None)
        results["a_to_b"].append({"adapt_on": rec["id"], "wer": wer_ab})
        results["a_to_a_loo"].append({"adapt_on": rec["id"], "wer": wer_loo})
        print(f"[{i}] adapt {rec['id']}: a_to_b {wer_ab}  a_to_a_loo {wer_loo}")

    if getattr(args, "save_path", ""):
        results["args_dict"] = vars(args)
        with open(args.save_path, "wb") as f:
            pickle.dump(results, f)
    mean_ab = sum(r["wer"] for r in results["a_to_b"]) / max(len(results["a_to_b"]), 1)
    print(f"mean a_to_b WER: {mean_ab}")
    return results


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-da", "--dataset_a", type=str, default="synthetic")
    parser.add_argument("-db", "--dataset_b", type=str, default="synthetic")
    parser.add_argument("-s", "--save_path", type=str, default="")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    parser.add_argument("--tokenizer", type=str, default="")
    parser.add_argument("--quiet", action="store_true")
    return apply_args(parser, argv)


def cli(argv=None, model_config: Optional[ConformerConfig] = None,
        jax_params: Optional[Mapping] = None) -> Dict:
    return main(parse_args(argv), model_config=model_config, jax_params=jax_params)


if __name__ == "__main__":
    cli()
