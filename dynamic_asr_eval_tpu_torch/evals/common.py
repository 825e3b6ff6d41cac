"""Shared driver toolkit: model/tokenizer loading, engine construction,
decoding, WER over records, and the result-pickle schema.

Counterpart of the JAX package's ``evals/common.py`` (NSTI with greedy
decode; checkpoints, AWMC, LM decode and the device mesh are not ported yet).
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from dynamic_asr_eval_tpu_torch.config import TTAConfig, load_yaml
from dynamic_asr_eval_tpu_torch.device import resolve_device
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, init_conformer, params_from_jax
from dynamic_asr_eval_tpu_torch.text import load_tokenizer, word_error_rate_detail
from dynamic_asr_eval_tpu_torch.tta import DynamicEvalEngine

# keys of lcasr-style model yamls that have no ConformerConfig field
_YAML_EXTRAS = ("dropout_ff", "dropout_attn", "dropout_conv", "flash_attn",
                "shift_kvs", "qk_rms_norm", "self_condition_subsampling",
                "gated_sc", "sandwich_norm", "encoder_mode")


def load_model_and_tokenizer(
    args,
    config: Optional[ConformerConfig] = None,
    jax_params: Optional[Mapping] = None,
    device=None,
):
    """Build ``(model, params, tokenizer, config)``; ``params`` is the
    model's state dict (the pristine weights each recording starts from).

    The configuration is ``config`` when given, else ``--config`` (a model
    yaml), else a small default model.  Weights come from ``jax_params`` (the
    JAX package's flax params, via :func:`params_from_jax`) when given, else
    random from ``--seed``."""
    if getattr(args, "checkpoint", ""):
        raise NotImplementedError(
            "--checkpoint loading is not ported yet (ROADMAP queue 1 item 9)")
    device = resolve_device(device if device is not None else getattr(args, "device", None))
    tokenizer = load_tokenizer(getattr(args, "tokenizer", None) or None)
    vocab = tokenizer.vocab_size()
    if config is not None:
        cfg = config
    elif getattr(args, "config", ""):
        raw = load_yaml(args.config)
        mc = dict(raw.get("model", raw))
        mc.setdefault("vocab_size", vocab)
        for k in _YAML_EXTRAS:
            mc.pop(k, None)
        cfg = ConformerConfig.from_dict(mc)
    else:
        cfg = ConformerConfig(
            feat_in=80, n_layers=2, d_model=64, n_heads=2, head_dim=32,
            vocab_size=vocab, subsampling_factor=4, subsampling_conv_channels=8,
            conv_kernel_size=5,
        )
    seed = int(getattr(args, "seed", 0) or 0)
    model = init_conformer(cfg, seed=seed)
    if jax_params is not None:
        model.load_state_dict(params_from_jax(jax_params), strict=True)
    model = model.to(device)
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return model, params, tokenizer, cfg


def build_engine(args, model, cfg: ConformerConfig, device=None) -> DynamicEvalEngine:
    tta = TTAConfig.from_args(args)
    if getattr(args, "dp", False) or getattr(args, "dp_records", False):
        raise NotImplementedError("--dp / --dp_records are not ported yet (ROADMAP queue 1)")
    transfer = torch.float32
    if cfg.compute_dtype == torch.bfloat16 and not bool(vars(args).get("f32_transfer", False)):
        # the model casts its input to bf16 anyway; the window copy is half
        transfer = torch.bfloat16
    device = device if device is not None else getattr(args, "device", None)
    return DynamicEvalEngine(model, cfg.blank_id, cfg.subsampling_factor, tta,
                             transfer_dtype=transfer, device=device)


def decode_output(out, tokenizer) -> str:
    """Greedy decode of a stitched engine output (ids decoded on the device,
    only the ids move to the host)."""
    return tokenizer.decode([int(i) for i in out.greedy_ids()])


def evaluate_records(
    records: List[Dict],
    run_one: Callable[[Dict], Tuple[str, str]],
    log_path: str = "",
    verbose: bool = True,
) -> Tuple[float, Dict]:
    """Loop records → (hyp, gold) pairs → corpus WER with detail."""
    all_texts, all_golds, elapsed_times = [], [], []
    for i, rec in enumerate(records):
        t0 = time.time()
        hyp, gold = run_one(rec)
        elapsed_times.append(time.time() - t0)
        if verbose:
            print(gold, "\n", hyp, "\n\n")
        append_log(
            log_path,
            f"record {i + 1}/{len(records)} "
            f"({rec.get('id', rec.get('audio', '?'))}): "
            f"elapsed {elapsed_times[-1]:.2f}s",
        )
        all_texts.append(hyp)
        all_golds.append(gold)
    wer, words, ins_rate, del_rate, sub_rate = word_error_rate_detail(
        hypotheses=all_texts, references=all_golds)
    append_log(log_path, f"corpus WER: {wer} over {words} words")
    detail = {
        "wer": wer,
        "words": words,
        "ins_rate": ins_rate,
        "del_rate": del_rate,
        "sub_rate": sub_rate,
        "model_output": all_texts,
        "gold": all_golds,
        "elapsed_times": elapsed_times,
    }
    return wer, detail


def save_result_pickle(save_path: str, detail: Dict, args, repeat: int, repeats: int) -> str:
    """Result pickle with the reference schema (detail + ``args_dict`` +
    ``repeat``), one file per repeat."""
    data = dict(detail)
    data["args_dict"] = vars(args) if hasattr(args, "__dict__") else dict(args)
    data["repeat"] = f"{repeat + 1}/{repeats}"
    path = save_path[: -len(".pkl")] if save_path.endswith(".pkl") else save_path
    path = f"{path}_{repeat + 1}.pkl"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


def append_log(log_path: str, line: str) -> None:
    if log_path:
        with open(log_path, "a") as f:
            f.write(line + "\n")
