"""Encoder-decoder inference evaluation driver.

Counterpart of the JAX package's ``evals/enc_dec_inference_test.py``: each
recording is transcribed by chunked greedy AR decode (``-mode default``;
chunks of ``seq_len`` frames, no overlap) or by the CTC branch over the whole
recording through the beam search of :mod:`..ops.beam_search` with a
uniform LM and α / β / prune from ``lm_alpha`` / ``lm_beta`` /
``lm_prune_less_than_val`` (``-mode joint``, ``-beams`` wide); then the
normalizer, the corpus WER, a log line and the result pickle.  The model is
the small default enc-dec, random from ``--seed``, or ``--checkpoint`` (a
reference enc-dec torch pickle).  Runs on ``cuda`` unless ``--device cpu``
is given.

CLI: ``python -m dynamic_asr_eval_tpu_torch.evals.enc_dec_inference_test -d
synthetic -mode joint -beams 10``
"""

from __future__ import annotations

import argparse
from typing import Mapping, Optional

import numpy as np
import torch

from dynamic_asr_eval_tpu_torch.config import apply_args
from dynamic_asr_eval_tpu_torch.data import get_dataset
from dynamic_asr_eval_tpu_torch.device import resolve_device
from dynamic_asr_eval_tpu_torch.evals.common import append_log, evaluate_records, save_result_pickle
from dynamic_asr_eval_tpu_torch.models import ConformerConfig
from dynamic_asr_eval_tpu_torch.models.convert import encdec_params_from_jax
from dynamic_asr_eval_tpu_torch.models.encdec import EncDecConfig, init_encdec
from dynamic_asr_eval_tpu_torch.ops.beam_search import UniformLMAdapter, beam_search_device
from dynamic_asr_eval_tpu_torch.text import load_tokenizer, normalize
from dynamic_asr_eval_tpu_torch.tta.encdec_rl import enc_dec_inference


def default_config(vocab_size: int) -> EncDecConfig:
    """The drivers' small enc-dec (the JAX drivers' default)."""
    enc = ConformerConfig(
        feat_in=80, n_layers=2, d_model=64, n_heads=2, head_dim=32,
        vocab_size=vocab_size, subsampling_factor=4, subsampling_conv_channels=8,
        conv_kernel_size=5, compute_dtype=torch.float32,
    )
    return EncDecConfig(encoder=enc, decoder_layers=2, decoder_d_model=64, decoder_heads=2)


def load_encdec_from_args(args, tokenizer, model_config: Optional[EncDecConfig] = None,
                          jax_params: Optional[Mapping] = None):
    """``(model, params, config)`` on ``--device``: ``--checkpoint`` (a
    reference enc-dec torch pickle), else ``model_config`` (default:
    :func:`default_config`) with the JAX package's enc-dec variables or
    params ``jax_params`` (numpy leaves), else random from ``--seed``."""
    from dynamic_asr_eval_tpu_torch.models.checkpoint import load_encdec_torch_checkpoint

    device = resolve_device(getattr(args, "device", None))
    if getattr(args, "checkpoint", ""):
        if model_config is not None or jax_params is not None:
            raise ValueError("--checkpoint carries its own configuration and weights")
        model, _, cfg = load_encdec_torch_checkpoint(args.checkpoint)
    else:
        cfg = model_config or default_config(tokenizer.vocab_size())
        model = init_encdec(cfg, seed=int(getattr(args, "seed", 0) or 0))
        if jax_params is not None:
            model.load_state_dict(encdec_params_from_jax(jax_params), strict=True)
    model = model.to(device)
    return model, {k: v.detach().clone() for k, v in model.state_dict().items()}, cfg


@torch.no_grad()
def joint_decode(model, cfg: EncDecConfig, spec: np.ndarray, args, tokenizer) -> str:
    """The whole recording's CTC branch through the beam search with a
    uniform LM."""
    dev = next(model.parameters()).device
    out = model(torch.as_tensor(spec, dtype=torch.float32, device=dev)[None])
    toks, lens, _ = beam_search_device(
        out["final_posteriors_ctc"][0], UniformLMAdapter(cfg.vocab_size, device=dev),
        beam_width=getattr(args, "beams", 10) or 10,
        alpha=vars(args).get("lm_alpha", 0.45),
        beta=vars(args).get("lm_beta", 1.53),
        prune_less_than_val=vars(args).get("lm_prune_less_than_val", 3.17),
    )
    return tokenizer.decode([int(x) for x in toks[0].tolist()[: int(lens[0])]])


def main(args, model_config: Optional[EncDecConfig] = None,
         jax_params: Optional[Mapping] = None) -> float:
    """Returns the corpus WER.  ``model_config`` and ``jax_params`` go to
    :func:`load_encdec_from_args`."""
    tokenizer = load_tokenizer(getattr(args, "tokenizer", None) or None)
    model, _, cfg = load_encdec_from_args(args, tokenizer, model_config, jax_params)
    records = get_dataset(args.dataset, args.split)
    mode = getattr(args, "mode", "default")

    def run_one(rec):
        spec, gold = rec["process_fn"](rec)
        spec = np.asarray(spec)
        if spec.ndim == 3:
            spec = spec[0]
        if mode == "joint":
            text = joint_decode(model, cfg, spec, args, tokenizer)
        else:
            text = enc_dec_inference(model, spec, args.seq_len, tokenizer, cfg)
        return normalize(text), gold

    wer, detail = evaluate_records(records, run_one, verbose=not getattr(args, "quiet", False))
    print(f"WER: {wer}")
    append_log(getattr(args, "log", ""), f"enc_dec_inference\t{mode}\tWER: {wer}")
    if getattr(args, "save_path", ""):
        save_result_pickle(args.save_path, detail, args, 0, 1)
    return wer


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-d", "--dataset", type=str, default="synthetic")
    parser.add_argument("-mode", "--mode", type=str, default="default", choices=["default", "joint"])
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
