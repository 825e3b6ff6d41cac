"""LM checkpoints, LM adapters and beam-search decoders for the drivers.

Counterpart of the JAX package's ``lm/loader.py``:

- :func:`save_lm_checkpoint` / :func:`load_lm_checkpoint` — the DLM1
  container of the transformer LM: magic ``b"DLM1"``, a ``<I`` header
  length, the JSON of :class:`..lm.transformer_lm.TransformerLMConfig`
  (``compute_dtype`` as a dtype name), then the variables ``{"params":
  ...}`` in flax's MessagePack layout through :mod:`..models.msgpack_codec`
  and :func:`..models.convert.lm_params_to_jax`, with sorted keys: the same
  bytes as the JAX package's file for the same weights;
- :func:`load_lm_torch_checkpoint` — a reference lming torch pickle (DDP
  prefixes stripped): dimensions from the weight shapes, the head count
  from the pickled config or, failing that, 64-dim heads (a warning on
  stderr); a strict=False overlay onto a fresh :func:`init_lm` that raises
  on a shape mismatch and on attention-projection biases (the LM has none,
  dropping them would change every score);
- :func:`load_lm_adapter` — an ARPA n-gram for ``.arpa`` / ``.gz`` paths,
  else the transformer LM from a DLM1 file or a torch pickle, with the ring
  cache resized to ``max_cache_length`` (the reference's cache trim) and
  ``compute_dtype`` overriding the LM's compute and cache dtype (its float
  parameters are cast to it, as in JAX);
- :func:`load_beamsearch` / :func:`load_beamsearch_batched` — the decoders,
  with the fusion defaults of the reference's published operating point
  (alpha 0.45, beta 1.53, prune 3.17, top_am -6).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import struct
import sys
from typing import Callable, Optional, Union

import numpy as np
import torch

from dynamic_asr_eval_tpu_torch.device import resolve_device
from dynamic_asr_eval_tpu_torch.lm.ngram import load_arpa
from dynamic_asr_eval_tpu_torch.lm.transformer_lm import (
    TransformerLM,
    TransformerLMConfig,
    init_lm,
)
from dynamic_asr_eval_tpu_torch.models import msgpack_codec
from dynamic_asr_eval_tpu_torch.models.checkpoint import (
    _dtype_name,
    _plain_config,
    _sorted_tree,
    load_torch_checkpoint,
)
from dynamic_asr_eval_tpu_torch.models.conformer import to_torch_dtype
from dynamic_asr_eval_tpu_torch.models.convert import lm_params_from_jax, lm_params_to_jax
from dynamic_asr_eval_tpu_torch.ops.beam_search import (
    NGramAdapter,
    TransformerLMAdapter,
    beam_search_segmented,
    collapse_blank_frames,
    collapse_blank_frames_device,
)

ARPA_SUFFIXES = (".arpa", ".arpa.gz", ".gz")
_MAGIC = b"DLM1"


def save_lm_checkpoint(path: str, model: Union[TransformerLM, dict],
                       config: TransformerLMConfig) -> None:
    """Write a DLM1 file of ``model`` (or its state dict)."""
    state = model.state_dict() if isinstance(model, torch.nn.Module) else model
    cfg = dataclasses.asdict(config)
    cfg["compute_dtype"] = _dtype_name(config.compute_dtype)
    header = json.dumps(cfg).encode("utf-8")
    payload = msgpack_codec.packb(_sorted_tree({"params": lm_params_to_jax(state)}))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(payload)


def load_lm_checkpoint(path: str):
    """A DLM1 file → ``(model, config)``, the model on the CPU."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != _MAGIC:
            raise ValueError(f"{path} is not a DLM checkpoint")
        (hlen,) = struct.unpack("<I", f.read(4))
        cfg_d = json.loads(f.read(hlen).decode("utf-8"))
        payload = f.read()
    cfg_d["compute_dtype"] = to_torch_dtype(cfg_d.get("compute_dtype", "float32"))
    config = TransformerLMConfig(**cfg_d)
    variables = msgpack_codec.unpackb(payload)
    if set(variables) != {"params"}:
        raise ValueError(f"{path}: variables {sorted(variables)}, expected only 'params'")
    model = TransformerLM(config)
    model.load_state_dict(lm_params_from_jax(variables["params"]), strict=True)
    return model.eval(), config


def _cast_floats(model: TransformerLM, compute_dtype) -> TransformerLM:
    """The JAX loaders cast every f32 parameter to ``compute_dtype`` when
    one is given."""
    if compute_dtype is not None:
        dtype = to_torch_dtype(compute_dtype)
        for p in model.parameters():
            if p.dtype == torch.float32:
                p.data = p.data.to(dtype)
    return model


def load_lm_torch_checkpoint(
    path: str,
    max_cache_length: int = 128,
    compute_dtype=None,
    n_heads: Optional[int] = None,
    verbose: bool = True,
):
    """A reference lming torch checkpoint → ``(model, config)``, the model
    on the CPU.  Structural dimensions (vocabulary, d_model, layers,
    expansion) come from the weight shapes; the head count from ``n_heads``,
    else the pickled config, else 64-dim heads (the published 512d / 8h
    shape; a wrong split changes the rotary partition, so it warns)."""
    state, raw_cfg = load_torch_checkpoint(path)
    cfg_plain = _plain_config(raw_cfg)
    cfg_d = dict(cfg_plain.get("model", cfg_plain) or {}) if isinstance(cfg_plain, dict) else {}

    emb = state.get("embed.weight")
    if emb is None:
        raise ValueError(f"{path}: no embed.weight — not a transformer LM "
                         "checkpoint this converter understands")
    vocab, d_model = int(emb.shape[0]), int(emb.shape[1])
    layer_ids = {int(m.group(1)) for k in state for m in [re.match(r"layers\.(\d+)\.", k)] if m}
    n_layers = (max(layer_ids) + 1) if layer_ids else int(cfg_d.get("n_layers", 6))
    ff = state.get("layers.0.ff_in.weight")
    expansion = (int(ff.shape[0]) // d_model if ff is not None
                 else int(cfg_d.get("expansion_factor", 4)))
    heads = n_heads or int(cfg_d.get("n_heads", 0))
    if not heads:
        heads = d_model // 64 if d_model % 64 == 0 else 8
        if verbose:
            print(f"load_lm_torch_checkpoint: checkpoint config carries no n_heads; assuming "
                  f"head_dim=64 → n_heads={heads} (the published 512d/8h lming shape) — a wrong "
                  f"split changes rotary partitioning; pass n_heads= explicitly if this is wrong",
                  file=sys.stderr)
    config = TransformerLMConfig(
        vocab_size=vocab, n_layers=n_layers, d_model=d_model, n_heads=heads,
        max_cache_length=max_cache_length,
        rotary_base=float(cfg_d.get("rotary_base", 10_000.0)),
        expansion_factor=expansion,
        compute_dtype=(to_torch_dtype(compute_dtype) if compute_dtype is not None
                       else torch.float32),
    )
    model = init_lm(config, seed=0)
    template = model.state_dict()
    bad = [f"{k}: checkpoint {tuple(state[k].shape)} vs model {tuple(template[k].shape)}"
           for k in sorted(template.keys() & state.keys()) if state[k].shape != template[k].shape]
    if bad:
        raise ValueError("LM checkpoint/model shape mismatches:\n  " + "\n  ".join(bad))
    unmatched = sorted(state.keys() - template.keys())
    # the attention projections carry no bias, here as in lming; a checkpoint
    # that has them cannot be represented, and dropping them would shift
    # every attention output
    attn_biases = [k for k in unmatched if re.fullmatch(r"layers\.\d+\.(qkv|out)\.bias", k)]
    if attn_biases:
        raise ValueError(
            f"{path}: checkpoint has attention-projection biases ({attn_biases[:4]}…) which "
            "this bias-free LM cannot represent; conversion would silently change scores")
    model.load_state_dict({**template, **{k: state[k] for k in template.keys() & state.keys()}},
                          strict=True)
    if verbose:
        missing = sorted(template.keys() - state.keys())
        if unmatched:
            print(f"load_lm_torch_checkpoint: {len(unmatched)} torch keys unconverted "
                  f"(first: {unmatched[:4]})", file=sys.stderr)
        if missing:
            print(f"load_lm_torch_checkpoint: {len(missing)} params kept fresh init "
                  f"(first: {missing[:4]})", file=sys.stderr)
    return _cast_floats(model, compute_dtype), config


def load_lm_adapter(path: str, tokenizer, max_cache_length: int = 128, bos_id: int = 0,
                    compute_dtype=None,
                    device: Optional[Union[str, torch.device]] = None):
    """The beam's LM adapter for an LM file on ``device`` (default
    ``cuda``): ARPA n-gram tables for ``.arpa`` / ``.gz`` paths, the
    transformer LM for a DLM1 file or a lming torch pickle.  One adapter
    serves the final decode and the LM-fused pseudo-labels
    (``lm_tta_beams``)."""
    device = resolve_device(device)
    if path.endswith(ARPA_SUFFIXES):
        token_to_id = {tokenizer.id_to_piece(i): i for i in range(tokenizer.vocab_size())}
        lm = load_arpa(path, token_to_id, tokenizer.vocab_size(), device=device)
        return NGramAdapter(lm, bos_id=bos_id)
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic != _MAGIC:
        model, config = load_lm_torch_checkpoint(path, max_cache_length=max_cache_length,
                                                 compute_dtype=compute_dtype)
    else:
        loaded, config = load_lm_checkpoint(path)
        # the reference's cache trim: the ring size is not a parameter
        config = dataclasses.replace(config, max_cache_length=max_cache_length)
        if compute_dtype is not None:
            config = dataclasses.replace(config, compute_dtype=to_torch_dtype(compute_dtype))
        model = TransformerLM(config)
        model.load_state_dict(loaded.state_dict())
        _cast_floats(model.eval(), compute_dtype)
    return TransformerLMAdapter(model.to(device), config, bos_id=bos_id)


def _ids_to_text(tokenizer, toks, lens) -> str:
    n = int(lens[0])
    return tokenizer.decode([int(x) for x in toks[0, :n].tolist()])


def load_beamsearch(
    path: str,
    tokenizer,
    alpha: float = 0.45,
    beta: float = 1.53,
    prune_less_than_val: float = 3.17,
    top_am_threshold: float = -6.0,
    bos_id: int = 0,
    blank_collapse_threshold: Optional[float] = 0.99,
    adapter=None,
    segment_frames: int = 4096,
    device: Optional[Union[str, torch.device]] = None,
) -> Callable:
    """``beam_search_fn(log_probs [T, V+1] host array, beam_width) -> text``,
    with ``beam_search_fn.from_engine_output(out, beam_width)`` for an
    engine's stitched output on the device.  ``blank_collapse_threshold``
    drops redundant blank-dominated frames first (``None``: every frame)."""
    if adapter is None:
        adapter = load_lm_adapter(path, tokenizer, bos_id=bos_id, device=device)
    kw = dict(alpha=alpha, beta=beta, top_am_threshold=top_am_threshold,
              prune_less_than_val=prune_less_than_val)

    def beam_search_fn(log_probs, beam_width: int = 20) -> str:
        lp = np.asarray(log_probs)
        if blank_collapse_threshold is not None:
            lp = collapse_blank_frames(lp, threshold=blank_collapse_threshold)
        toks, lens, _ = beam_search_segmented(
            torch.as_tensor(lp, device=adapter.device), adapter, segment_frames=segment_frames,
            beam_width=beam_width, **kw)
        return _ids_to_text(tokenizer, toks, lens)

    def from_engine_output(out, beam_width: int = 20) -> str:
        """The stitched log-probs stay on the device: collapsed there and
        decoded there; only the best beam's ids reach the host."""
        n_valid = (out.counts > 0).sum()
        if blank_collapse_threshold is not None:
            lp_c, n_kept = collapse_blank_frames_device(
                out.logits, threshold=blank_collapse_threshold, valid_frames=n_valid)
            lp = lp_c[: int(n_kept)]
        else:
            lp = out.logits[: int(n_valid)]
        toks, lens, _ = beam_search_segmented(lp, adapter, segment_frames=segment_frames,
                                              beam_width=beam_width, **kw)
        return _ids_to_text(tokenizer, toks, lens)

    beam_search_fn.from_engine_output = from_engine_output
    return beam_search_fn


def load_beamsearch_batched(
    path: str,
    tokenizer,
    alpha: float = 0.45,
    beta: float = 1.53,
    prune_less_than_val: float = 3.17,
    top_am_threshold: float = -6.0,
    bos_id: int = 0,
    blank_collapse_threshold: Optional[float] = 0.99,
    adapter=None,
    segment_frames: int = 4096,
    device: Optional[Union[str, torch.device]] = None,
) -> Callable:
    """``fn(list of [T, V+1] host log-prob matrices, beam_width) ->
    list[str]``: each stream through :func:`load_beamsearch`'s decoder in
    turn.  The JAX package pads the streams to one shape for one vmapped
    program; a stream's search does not depend on the others, so here they
    run one after another and nothing is padded."""
    beam_search_fn = load_beamsearch(
        path, tokenizer, alpha=alpha, beta=beta, prune_less_than_val=prune_less_than_val,
        top_am_threshold=top_am_threshold, bos_id=bos_id,
        blank_collapse_threshold=blank_collapse_threshold, adapter=adapter,
        segment_frames=segment_frames, device=device)

    def batched_fn(log_probs_list, beam_width: int = 20):
        return [beam_search_fn(lp, beam_width=beam_width) for lp in log_probs_list]

    return batched_fn
