"""Per-recording dynamic evaluation (NSTI) driver.

Counterpart of the JAX package's ``evals/run.py``: adapt on each recording
from the pristine weights, greedy-decode the stitched posteriors, normalize,
corpus WER, log and result pickle, repeated ``-r`` times with a distinct seed
per repeat.  Runs on ``cuda`` unless ``--device cpu`` is given.

CLI: ``python -m dynamic_asr_eval_tpu_torch.evals.run -d synthetic -kwargs
optim_lr=9e-5 epochs=1 online=true``
"""

from __future__ import annotations

import argparse
from typing import Mapping, Optional

import numpy as np

from dynamic_asr_eval_tpu_torch.config import apply_args
from dynamic_asr_eval_tpu_torch.data import get_dataset
from dynamic_asr_eval_tpu_torch.evals.common import (
    append_log,
    build_engine,
    decode_output,
    evaluate_records,
    load_model_and_tokenizer,
    save_result_pickle,
)
from dynamic_asr_eval_tpu_torch.models import ConformerConfig
from dynamic_asr_eval_tpu_torch.text import normalize

_NOT_PORTED = {
    "awmc": "--awmc (the AWMC engine)",
    "language_model": "-lm (LM beam decode and LM pseudo-labels)",
    "dp": "--dp (data-parallel windowed inference)",
    "dp_records": "--dp_records (records-level data parallelism)",
    "profile": "--profile",
}


def main(args, model_config: Optional[ConformerConfig] = None,
         jax_params: Optional[Mapping] = None) -> float:
    """Returns the mean corpus WER over the repeats.  ``model_config`` and
    ``jax_params`` hand an in-memory configuration and the JAX package's
    flax params to :func:`load_model_and_tokenizer`."""
    for key, what in _NOT_PORTED.items():
        if getattr(args, key, False):
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1)")
    model, params, tokenizer, cfg = load_model_and_tokenizer(
        args, config=model_config, jax_params=jax_params)
    records = get_dataset(args.dataset, args.split)
    engine = build_engine(args, model, cfg)

    wers = []
    repeats = getattr(args, "repeats", 1)
    seed = getattr(args, "seed", None)
    base_seed = 0 if seed is None else int(seed)
    for repeat in range(repeats):
        repeat_seed = base_seed * 1000 + repeat
        repeat_shuffle = np.random.default_rng(repeat_seed)
        rec_counter = iter(range(len(records)))

        def run_one(rec):
            spec, gold = rec["process_fn"](rec)
            # a distinct augmentation stream per recording
            rec_seed = repeat_seed * 1_000_003 + next(rec_counter)
            out = engine(params, spec, args.seq_len, args.overlap,
                         rng=rec_seed, shuffle_rng=repeat_shuffle)
            return normalize(decode_output(out, tokenizer)), gold

        wer, detail = evaluate_records(records, run_one, verbose=not getattr(args, "quiet", False))
        print(f"WER: {wer}")
        append_log(
            getattr(args, "log", ""),
            f"{getattr(args, 'checkpoint', '')}\t overlap: {args.overlap}\t "
            f"seq_len: {args.seq_len}\t WER: {wer}",
        )
        if getattr(args, "save_path", ""):
            save_result_pickle(args.save_path, detail, args, repeat, repeats)
        wers.append(wer)

    mean_wer = sum(wers) / len(wers)
    print(f"Average WER: {mean_wer}")
    return mean_wer


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-d", "--dataset", type=str, default="synthetic")
    parser.add_argument("-r", "--repeats", type=int, default=1)
    parser.add_argument("-s", "--save_path", type=str, default="")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--awmc", action="store_true", help="not ported yet")
    parser.add_argument("--dp", action="store_true", help="not ported yet")
    parser.add_argument("--dp_records", action="store_true", help="not ported yet")
    parser.add_argument("--tokenizer", type=str, default="")
    parser.add_argument("--profile", type=str, default="", help="not ported yet")
    parser.add_argument("--quiet", action="store_true")
    return apply_args(parser, argv)


def cli(argv=None, model_config: Optional[ConformerConfig] = None,
        jax_params: Optional[Mapping] = None) -> float:
    return main(parse_args(argv), model_config=model_config, jax_params=jax_params)


if __name__ == "__main__":
    cli()
