"""Utterance-level TTA evaluation driver.

Counterpart of the JAX package's ``evals/run_utterance_eval.py``: each
recording is cut into utterances (TEDLIUM: the STM's timings through
``data.adapters.fetch_utterances``; other datasets and ``-d synthetic``:
``--segment_frames`` segments, :func:`segment_spec`), the utterance engine
(:class:`..tta.utterance.UtteranceTTAEngine`) adapts over them with
``--accumulate_gradients`` and ``--prob_collection``, and the per-utterance
outputs are greedy-decoded, joined and normalized for the corpus WER, a log
line and the result pickle.  As in JAX, the driver sets no soft-DTW weight.
Runs on ``cuda`` unless ``--device cpu`` is given.

CLI: ``python -m dynamic_asr_eval_tpu_torch.evals.run_utterance_eval -d
synthetic --segment_frames 512 -kwargs epochs=1``
"""

from __future__ import annotations

import argparse
from typing import Mapping, Optional

import numpy as np

from dynamic_asr_eval_tpu_torch.config import TTAConfig, apply_args
from dynamic_asr_eval_tpu_torch.data import get_dataset
from dynamic_asr_eval_tpu_torch.data.adapters import fetch_utterances
from dynamic_asr_eval_tpu_torch.evals.common import (
    append_log,
    evaluate_records,
    load_model_and_tokenizer,
    save_result_pickle,
)
from dynamic_asr_eval_tpu_torch.models import ConformerConfig
from dynamic_asr_eval_tpu_torch.ops.ctc import greedy_decode
from dynamic_asr_eval_tpu_torch.text import normalize
from dynamic_asr_eval_tpu_torch.tta.utterance import UtteranceTTAEngine


def segment_spec(spec: np.ndarray, segment_frames: int):
    """``segment_frames``-frame utterances of a [F, T] (or [1, F, T])
    spectrogram; a last piece of 8 frames or fewer is dropped."""
    spec = np.asarray(spec)
    if spec.ndim == 3:
        spec = spec[0]
    return [
        {"spectrogram": spec[:, i : i + segment_frames]}
        for i in range(0, spec.shape[1], segment_frames)
        if spec[:, i : i + segment_frames].shape[1] > 8
    ]


def build_engine(args, model, cfg) -> UtteranceTTAEngine:
    """The driver's utterance engine, on ``--device``."""
    return UtteranceTTAEngine(
        model, cfg.blank_id, cfg.subsampling_factor, TTAConfig.from_args(args),
        accumulate_gradients=int(vars(args).get("accumulate_gradients", 1)),
        prob_collection=str(vars(args).get("prob_collection", "online")),
        device=getattr(args, "device", None),
    )


def main(args, model_config: Optional[ConformerConfig] = None,
         jax_params: Optional[Mapping] = None) -> float:
    """Returns the corpus WER.  ``model_config`` and ``jax_params`` hand an
    in-memory configuration and the JAX package's flax params to
    :func:`..evals.common.load_model_and_tokenizer`."""
    model, params, tokenizer, cfg = load_model_and_tokenizer(
        args, config=model_config, jax_params=jax_params)
    engine = build_engine(args, model, cfg)
    records = get_dataset(args.dataset, args.split)
    seg_frames = int(vars(args).get("segment_frames", 512))

    def run_one(rec):
        spec, gold = rec["process_fn"](rec)
        if args.dataset == "tedlium" and isinstance(rec.get("text"), str):
            # true utterance boundaries from the STM
            utts, _ = fetch_utterances(rec["text"], np.asarray(spec))
            utterances = [{"spectrogram": u["spectrogram"]}
                          for u in utts if u["spectrogram"].shape[-1] > 8]
        else:
            utterances = segment_spec(spec, seg_frames)
        outs, _, _ = engine(params, utterances)
        texts = [greedy_decode(o, tokenizer, cfg.blank_id) for o in outs]
        return normalize(" ".join(texts)), gold

    wer, detail = evaluate_records(records, run_one, verbose=not getattr(args, "quiet", False))
    print(f"WER: {wer}")
    append_log(getattr(args, "log", ""), f"utterance_eval\t{args.dataset}\tWER: {wer}")
    if getattr(args, "save_path", ""):
        save_result_pickle(args.save_path, detail, args, 0, 1)
    return wer


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-d", "--dataset", type=str, default="synthetic")
    parser.add_argument("--segment_frames", type=int, default=512)
    parser.add_argument("--accumulate_gradients", type=int, default=1)
    parser.add_argument("--prob_collection", choices=["online", "final"], default="online",
                        help="'online': each utterance's log-probs from the forward of its "
                             "visit; 'final': a pass with the adapted weights")
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
