"""Per-checkpoint evaluation loop.

Counterpart of the JAX package's ``evals/eval_for_each_cpt.py``: run the
per-recording driver (:func:`.run.main`) on every ``.pt`` (reference torch
pickle) and ``.ckpt`` (DAE1) file of ``--checkpoint_folder``, in sorted
order, and mark the best WER: how a finetuning run's saved checkpoints are
compared on a dev set.  Runs on ``cuda`` unless ``--device cpu`` is given.

CLI: ``python -m dynamic_asr_eval_tpu_torch.evals.eval_for_each_cpt -cf
ckpts/ -d tedlium --split dev``
"""

from __future__ import annotations

import argparse
import os
from typing import List, Mapping, Optional, Tuple

from dynamic_asr_eval_tpu_torch.config import apply_args
from dynamic_asr_eval_tpu_torch.evals import run as run_mod
from dynamic_asr_eval_tpu_torch.models import ConformerConfig


def main(args, model_config: Optional[ConformerConfig] = None,
         jax_params: Optional[Mapping] = None) -> List[Tuple[str, float]]:
    """Returns ``[(file name, mean WER), ...]``.  ``model_config`` and
    ``jax_params`` go to :func:`.run.main`, which refuses them beside a
    checkpoint: each checkpoint brings its own."""
    results: List[Tuple[str, float]] = []
    for name in sorted(os.listdir(args.checkpoint_folder)):
        if not name.endswith((".pt", ".ckpt")):
            continue
        path = os.path.join(args.checkpoint_folder, name)
        print(f"Evaluating checkpoint: {path}")
        args.checkpoint = path
        wer = run_mod.main(args, model_config=model_config, jax_params=jax_params)
        results.append((name, wer))
    if results:
        best = min(results, key=lambda r: r[1])
        print("\nPer-checkpoint WERs:")
        for name, wer in results:
            marker = "  <- best" if name == best[0] else ""
            print(f"  {name}\tWER: {wer:.5f}{marker}")
    return results


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-cf", "--checkpoint_folder", type=str, required=True)
    parser.add_argument("-d", "--dataset", type=str, default="synthetic")
    parser.add_argument("-r", "--repeats", type=int, default=1)
    parser.add_argument("-s", "--save_path", type=str, default="")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    parser.add_argument("--tokenizer", type=str, default="")
    parser.add_argument("--quiet", action="store_true")
    return apply_args(parser, argv)


def cli(argv=None, model_config: Optional[ConformerConfig] = None,
        jax_params: Optional[Mapping] = None) -> List[Tuple[str, float]]:
    return main(parse_args(argv), model_config=model_config, jax_params=jax_params)


if __name__ == "__main__":
    cli()
