"""Cross-gender transfer driver (TEDLIUM speaker manifest).

Counterpart of the JAX package's ``evals/run_cross_speaker_gender_tedlium.py``:
``--speaker_manifest`` (JSON ``{"female": [{"talk_id": ...}], "male":
[...]}``) keeps the manifested talks and gives each its gender; without a
manifest the records alternate between the two groups.  Then the per-gender
no-adapt baselines, and for each speaker: adapt on their recording from the
pristine weights, evaluate the other speakers of the same gender and all of
the other gender.  Returns (and ``-s`` pickles) the baselines and the tables
``m_to_m``, ``m_to_f``, ``f_to_f`` and ``f_to_m``.  Runs on ``cuda`` unless
``--device cpu`` is given.

CLI: ``python -m dynamic_asr_eval_tpu_torch.evals.run_cross_speaker_gender_tedlium
-d tedlium --speaker_manifest speaker_manifest_15x15.json -kwargs epochs=1``
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import Dict, Mapping, Optional, Tuple

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

TABLES = ("m_to_m", "m_to_f", "f_to_f", "f_to_m")


def load_speaker_manifest(path: str) -> Tuple[Dict, Dict[str, str]]:
    """``(manifest, {talk_id: "F" or "M"})``."""
    with open(path, "r") as f:
        manifest = json.load(f)
    gender = {}
    for row in manifest.get("female", []):
        gender[row["talk_id"]] = "F"
    for row in manifest.get("male", []):
        gender[row["talk_id"]] = "M"
    return manifest, gender


def _talk_id(rec) -> str:
    rid = os.path.basename(str(rec["id"]))
    return rid[: -len(".sph")] if rid.endswith(".sph") else rid


def main(args, model_config: Optional[ConformerConfig] = None,
         jax_params: Optional[Mapping] = None) -> Dict:
    """Returns the results dict (``model_config`` and ``jax_params`` as in
    :func:`.run.main`)."""
    model, params, tokenizer, cfg = load_model_and_tokenizer(
        args, config=model_config, jax_params=jax_params)
    engine = build_engine(args, model, cfg)
    eval_engine = build_eval_engine(model, cfg, engine)
    records = get_dataset(args.dataset, args.split)

    if getattr(args, "speaker_manifest", ""):
        _, gender_of = load_speaker_manifest(args.speaker_manifest)
        records = [r for r in records if _talk_id(r) in gender_of]
        males = [r for r in records if gender_of[_talk_id(r)] == "M"]
        females = [r for r in records if gender_of[_talk_id(r)] == "F"]
    else:  # no manifest (synthetic smoke): alternate records into two groups
        males = records[0::2]
        females = records[1::2]
    print(f"Male data: {len(males)}  Female data: {len(females)}")
    overlap = adapt_overlap(args)

    def eval_with(weights, recs):
        return evaluate_with(eval_engine, weights, recs, args, tokenizer)

    results = {"baselines": {}, **{k: [] for k in TABLES}}
    wer_m, _ = eval_with(params, males) if males else (float("nan"), None)
    wer_f, _ = eval_with(params, females) if females else (float("nan"), None)
    results["baselines"] = {"male": wer_m, "female": wer_f}
    print(f"Male baseline WER: {wer_m}  Female baseline WER: {wer_f}")

    def transfer(adapt_set, same_key, cross_key, cross_set):
        for i, rec in enumerate(adapt_set):
            spec, _ = rec["process_fn"](rec)
            adapted = engine(params, spec, args.seq_len, overlap, return_params=True).params
            same = [r for j, r in enumerate(adapt_set) if j != i]
            if same:
                wer, _ = eval_with(adapted, same)
                results[same_key].append({"adapt_on": rec["id"], "wer": wer})
            if cross_set:
                wer, _ = eval_with(adapted, cross_set)
                results[cross_key].append({"adapt_on": rec["id"], "wer": wer})

    transfer(males, "m_to_m", "m_to_f", females)
    transfer(females, "f_to_f", "f_to_m", males)

    for k in TABLES:
        vals = [r["wer"] for r in results[k]]
        if vals:
            print(f"{k}: mean WER {sum(vals) / len(vals):.5f} over {len(vals)} speakers")

    if getattr(args, "save_path", ""):
        results["args_dict"] = vars(args)
        with open(args.save_path, "wb") as f:
            pickle.dump(results, f)
    return results


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-d", "--dataset", type=str, default="tedlium")
    parser.add_argument("--speaker_manifest", type=str, default="")
    parser.add_argument("-ao", "--adapt_overlap", type=int, default=-1)
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
