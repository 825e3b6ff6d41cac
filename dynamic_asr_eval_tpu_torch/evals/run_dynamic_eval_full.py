"""Per-recording dynamic evaluation with engine dispatch: NSTI, the
consistency engine with ``--consistency`` (it wins over ``--awmc``, as in
JAX), or AWMC with ``--awmc``.

Counterpart of the JAX package's ``evals/run_dynamic_eval_full.py``: the
loop of :mod:`.run` (per-repeat and per-record seeds, greedy or ``-lm`` beam
decode, ``--decode_batch``, WER, ``--save_path`` pickles) with the log line
``"{engine}\\t{dataset}\\tWER: ..."``; LM-fused pseudo-labels are NSTI's
only (AWMC and consistency keep greedy teachers; ``-lm`` serves their final
decode); ``--dp_records`` (NSTI only) and ``--tp`` as in :mod:`.run`.  Runs on ``cuda``
(``cuda:{LOCAL_RANK}`` under torchrun) unless ``--device cpu`` is given.

CLI: ``python -m dynamic_asr_eval_tpu_torch.evals.run_dynamic_eval_full -d
synthetic --awmc -c model.dae -kwargs epochs=1``
"""

from __future__ import annotations

import argparse
from typing import Mapping, Optional

from dynamic_asr_eval_tpu_torch.config import apply_args
from dynamic_asr_eval_tpu_torch.data import get_dataset
from dynamic_asr_eval_tpu_torch.evals.common import (
    ENGINES,
    build_engine,
    data_parallel,
    evaluate_repeats,
    init_data_parallel,
    load_language_model,
    load_model_and_tokenizer,
    maybe_shard_variables,
)
from dynamic_asr_eval_tpu_torch.models import ConformerConfig


def main(args, model_config: Optional[ConformerConfig] = None,
         jax_params: Optional[Mapping] = None) -> float:
    """Returns the mean corpus WER over the repeats (``model_config`` and
    ``jax_params`` as in :func:`.run.main`)."""
    engine_kind = ("consistency" if getattr(args, "consistency", False)
                   else "awmc" if getattr(args, "awmc", False) else "dynamic_eval")
    if getattr(args, "dp_records", False) and engine_kind != "dynamic_eval":
        raise ValueError("--dp_records supports only the NSTI engine (drop --awmc/--consistency)")
    if data_parallel(args):
        init_data_parallel(args)
    model, params, tokenizer, cfg = load_model_and_tokenizer(
        args, config=model_config, jax_params=jax_params)
    lm_adapter, beam_search_fn = load_language_model(args, tokenizer)
    engine = build_engine(args, model, cfg, engine_kind, lm_adapter=lm_adapter,
                          tokenizer=tokenizer)
    params = maybe_shard_variables(engine, params)
    records = get_dataset(args.dataset, args.split)
    name = ENGINES[engine_kind].__name__
    return evaluate_repeats(args, engine, params, tokenizer, records,
                            lambda wer: f"{name}\t{args.dataset}\tWER: {wer}",
                            beam_search_fn=beam_search_fn)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-d", "--dataset", type=str, default="synthetic")
    parser.add_argument("-r", "--repeats", type=int, default=1)
    parser.add_argument("-s", "--save_path", type=str, default="")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    parser.add_argument("--awmc", action="store_true", help="use the AWMC engine")
    parser.add_argument("--consistency", action="store_true",
                        help="use the consistency engine (per-chunk parameters, Adafactor)")
    parser.add_argument("--dp_records", action="store_true",
                        help="records-level data parallelism: adapt one record a rank at once")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree of the mesh (with --dp_records)")
    parser.add_argument("--decode_batch", type=int, default=1,
                        help="with -lm, adapt this many records before decoding them")
    parser.add_argument("--tokenizer", type=str, default="")
    parser.add_argument("--quiet", action="store_true")
    return apply_args(parser, argv)


def cli(argv=None, model_config: Optional[ConformerConfig] = None,
        jax_params: Optional[Mapping] = None) -> float:
    return main(parse_args(argv), model_config=model_config, jax_params=jax_params)


if __name__ == "__main__":
    cli()
