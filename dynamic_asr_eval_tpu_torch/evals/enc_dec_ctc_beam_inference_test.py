"""Joint CTC-branch beam-decode evaluation driver.

Counterpart of the JAX package's ``evals/enc_dec_ctc_beam_inference_test.py``:
:mod:`.enc_dec_inference_test` pinned to ``-mode joint`` (the enc-dec
model's CTC branch over the whole recording through the beam search, α / β /
prune from the LM-fusion flags).  Runs on ``cuda`` unless ``--device cpu``
is given.

CLI: ``python -m dynamic_asr_eval_tpu_torch.evals.enc_dec_ctc_beam_inference_test
-d synthetic -beams 10``
"""

from __future__ import annotations

import argparse
from typing import Mapping, Optional

from dynamic_asr_eval_tpu_torch.config import apply_args
from dynamic_asr_eval_tpu_torch.evals import enc_dec_inference_test
from dynamic_asr_eval_tpu_torch.models.encdec import EncDecConfig


def main(args, model_config: Optional[EncDecConfig] = None,
         jax_params: Optional[Mapping] = None) -> float:
    args.mode = "joint"
    return enc_dec_inference_test.main(args, model_config=model_config, jax_params=jax_params)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-d", "--dataset", type=str, default="synthetic")
    parser.add_argument("-s", "--save_path", type=str, default="")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    parser.add_argument("--tokenizer", type=str, default="")
    parser.add_argument("--quiet", action="store_true")
    return apply_args(parser, argv)


def cli(argv=None, model_config: Optional[EncDecConfig] = None,
        jax_params: Optional[Mapping] = None) -> float:
    return main(parse_args(argv), model_config=model_config, jax_params=jax_params)


if __name__ == "__main__":
    cli()
