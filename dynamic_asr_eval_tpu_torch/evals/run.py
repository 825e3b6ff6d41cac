"""Per-recording dynamic evaluation driver (NSTI, or AWMC with ``--awmc``).

Counterpart of the JAX package's ``evals/run.py``: adapt on each recording
from the pristine weights (``--checkpoint``: a DAE1 file or a reference
torch pickle), decode the stitched posteriors (greedy; with ``-lm
<file>.arpa --beams N`` the LM-fused beam search, which with ``lm_tta_beams
> 0``, the default, also gives the NSTI pseudo-labels; ``--decode_batch N``
adapts N records before their decodes), normalize, corpus WER, log and result
pickle, repeated ``-r`` times with a distinct seed per repeat; ``--profile
DIR`` writes a ``torch.profiler`` Chrome trace of repeat 0 into DIR.
``--dp`` splits each record's offline inference windows over the ranks of
``torch.distributed``, ``--dp_records`` adapts one record a rank at once
(:func:`..evals.common.run_records_dp`); start either under ``torchrun
--nproc_per_node=N`` (without torchrun: a world of 1); only rank 0 prints,
logs and pickles.  ``--tp N`` with either shards the model over N ranks
(tensor parallelism; each tp group adapts the same record).  Runs on
``cuda`` (``cuda:{LOCAL_RANK}`` under torchrun) unless ``--device cpu`` is
given.

CLI: ``python -m dynamic_asr_eval_tpu_torch.evals.run -d synthetic -kwargs
optim_lr=9e-5 epochs=1 online=true``
"""

from __future__ import annotations

import argparse
from typing import Mapping, Optional

from dynamic_asr_eval_tpu_torch.config import apply_args
from dynamic_asr_eval_tpu_torch.data import get_dataset
from dynamic_asr_eval_tpu_torch.evals.common import (
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
    """Returns the mean corpus WER over the repeats.  ``model_config`` and
    ``jax_params`` hand an in-memory configuration and the JAX package's
    flax params to :func:`load_model_and_tokenizer`."""
    engine_kind = "awmc" if getattr(args, "awmc", False) else "dynamic_eval"
    if engine_kind == "awmc" and getattr(args, "dp_records", False):
        raise SystemExit(
            "--dp_records is not implemented for the AWMC engine "
            "(records-DP batching currently covers the NSTI engine only)")
    if data_parallel(args):
        init_data_parallel(args)
    model, params, tokenizer, cfg = load_model_and_tokenizer(
        args, config=model_config, jax_params=jax_params)
    records = get_dataset(args.dataset, args.split)
    lm_adapter, beam_search_fn = load_language_model(args, tokenizer)
    engine = build_engine(args, model, cfg, engine_kind, lm_adapter=lm_adapter,
                          tokenizer=tokenizer)
    params = maybe_shard_variables(engine, params)
    return evaluate_repeats(
        args, engine, params, tokenizer, records,
        lambda wer: (f"{getattr(args, 'checkpoint', '')}\t overlap: {args.overlap}\t "
                     f"seq_len: {args.seq_len}\t WER: {wer}"),
        beam_search_fn=beam_search_fn)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-d", "--dataset", type=str, default="synthetic")
    parser.add_argument("-r", "--repeats", type=int, default=1)
    parser.add_argument("-s", "--save_path", type=str, default="")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--awmc", action="store_true", help="use the AWMC engine")
    parser.add_argument("--dp", action="store_true",
                        help="split each record's offline inference windows over the ranks")
    parser.add_argument("--dp_records", action="store_true",
                        help="records-level data parallelism: adapt one record a rank at once; "
                             "corpus WER reduced over the ranks")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree of the device mesh (with --dp)")
    parser.add_argument("--decode_batch", type=int, default=1,
                        help="with -lm, adapt this many records before decoding them")
    parser.add_argument("--tokenizer", type=str, default="")
    parser.add_argument("--profile", type=str, default="",
                        help="write a torch.profiler trace of repeat 0 to this dir")
    parser.add_argument("--quiet", action="store_true")
    return apply_args(parser, argv)


def cli(argv=None, model_config: Optional[ConformerConfig] = None,
        jax_params: Optional[Mapping] = None) -> float:
    return main(parse_args(argv), model_config=model_config, jax_params=jax_params)


if __name__ == "__main__":
    cli()
