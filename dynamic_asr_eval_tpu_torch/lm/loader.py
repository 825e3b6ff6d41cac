"""LM adapters and beam-search decoders for the drivers.

Counterpart of the JAX package's ``lm/loader.py`` (``load_lm_adapter``,
``load_beamsearch``, ``load_beamsearch_batched``) for n-gram ARPA files; the
fusion defaults are the reference's published operating point (alpha 0.45,
beta 1.53, prune 3.17, top_am -6).  A transformer LM checkpoint (DLM1 or a
torch pickle) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from dynamic_asr_eval_tpu_torch.lm.ngram import load_arpa
from dynamic_asr_eval_tpu_torch.ops.beam_search import (
    NGramAdapter,
    beam_search_segmented,
    collapse_blank_frames,
    collapse_blank_frames_device,
)

ARPA_SUFFIXES = (".arpa", ".arpa.gz", ".gz")


def load_lm_adapter(path: str, tokenizer, bos_id: int = 0,
                    device: Optional[Union[str, torch.device]] = None):
    """The beam's LM adapter for an LM file: ARPA n-gram tables on
    ``device`` (default ``cuda``) for ``.arpa`` / ``.gz`` paths.  One adapter
    serves the final decode and the LM-fused pseudo-labels
    (``lm_tta_beams``)."""
    if not path.endswith(ARPA_SUFFIXES):
        raise NotImplementedError(
            f"{path}: only ARPA n-gram LMs (.arpa, .arpa.gz) are ported; the transformer LM "
            "(DLM1 or torch checkpoints) is ROADMAP queue 1 item 12b")
    token_to_id = {tokenizer.id_to_piece(i): i for i in range(tokenizer.vocab_size())}
    lm = load_arpa(path, token_to_id, tokenizer.vocab_size(), device=device)
    return NGramAdapter(lm, bos_id=bos_id)


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
