"""Transformer-LM rescoring tools.

Counterpart of the JAX package's ``evals/tlm_tools.py`` (the reference's
``bin/create_logits.py``, ``tlm_beam.py`` and ``tlm_beam_search.py``):

- :func:`create_logits` — windowed inference per recording, each stitched
  log-prob matrix and its gold text dumped to a pickle;
- :func:`tlm_beam_rescore` — LM-fused beam search over the dumped logits:
  on the device (``use_device``, :func:`..ops.beam_search.beam_search_streams`,
  the recordings of a group one after another, nothing padded) or by the
  host search over a thread pool (the reference's CPU workers);
- :func:`lm_init_state_from_text` — the LM's cache warmed with a text
  prompt: the ring keeps the last ``max_cache_length`` tokens, the
  reference's cache slide;
- :func:`tlm_beam_grid` — the α / β / prune grid over
  :func:`tlm_beam_rescore`.

CLI (``python -m dynamic_asr_eval_tpu_torch.evals.tlm_tools``): ``dump``
(``-c``, ``-d``, ``-split``, ``-seq``, ``-overlap``, ``-s``,
``--tokenizer``), ``rescore`` and ``grid`` (``-logits``, ``-lm``,
``-beams``, ``-alpha``, ``-beta``, ``-p``, ``--stream_batch``,
``--blank_collapse``, ``--tokenizer``), each with ``--device`` (``cuda``
unless ``cpu`` is given).
"""

from __future__ import annotations

import itertools
import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dynamic_asr_eval_tpu_torch.lm.transformer_lm import empty_cache, model_device
from dynamic_asr_eval_tpu_torch.ops.beam_search import (
    BeamSearchHost,
    beam_search_streams,
    collapse_blank_frames,
)
from dynamic_asr_eval_tpu_torch.text import normalize, word_error_rate_detail


def create_logits(engine, params, records: Sequence[Dict], out_dir: str, seq_len: int,
                  overlap: int) -> List[str]:
    """Dump each record's stitched log-probs and gold text; returns the
    pickle paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for rec in records:
        spec, gold = rec["process_fn"](rec)
        out = engine(params, spec, seq_len, overlap)
        path = os.path.join(out_dir, f"{os.path.basename(str(rec['id']))}.pkl")
        with open(path, "wb") as f:
            pickle.dump({"logits": out.numpy_logits(), "gold": gold, "id": rec["id"]}, f)
        paths.append(path)
    return paths


@torch.no_grad()
def lm_init_state_from_text(model, config, tokenizer, text: str, batch: int = 1):
    """The LM's ``(cache, log-probs [batch, V])`` after the BOS and ``text``'s
    tokens."""
    device = model_device(model)
    cache = empty_cache(config, batch, device)
    lps = None
    for t in [0] + list(tokenizer.encode(text)):  # BOS then prompt
        lps, cache = model(torch.full((batch,), t, dtype=torch.int64, device=device), cache)
    return cache, lps


def _rescore_one(args):
    path, lm_adapter_factory, beam_kwargs = args
    with open(path, "rb") as f:
        data = pickle.load(f)
    bs = BeamSearchHost(data["logits"], lm_adapter_factory(), **beam_kwargs)
    return data["id"], list(bs.run_search()[0][0]), data["gold"]


def _rescore_streams(logit_paths, lm_adapter_factory, beam_kwargs, stream_batch,
                     blank_collapse_threshold, segment_frames):
    """The device search over groups of ``stream_batch`` recordings (one
    adapter serves every group); each stream is searched over its own
    frames, so a short group is not padded."""
    lm = lm_adapter_factory()
    results = []
    for i in range(0, len(logit_paths), stream_batch):
        datas = []
        for p in logit_paths[i : i + stream_batch]:
            with open(p, "rb") as f:
                datas.append(pickle.load(f))
        lps = [np.asarray(d["logits"]) for d in datas]
        if blank_collapse_threshold is not None:
            lps = [collapse_blank_frames(lp, threshold=blank_collapse_threshold) for lp in lps]
        lens = [lp.shape[0] for lp in lps]
        T = max(lens)
        batch = np.stack([np.pad(lp, ((0, T - lp.shape[0]), (0, 0))) for lp in lps])
        toks, lns, _ = beam_search_streams(
            torch.as_tensor(batch, device=lm.device), lm, valid_frames=lens,
            segment_frames=segment_frames, **beam_kwargs)
        toks, lns = toks[:, 0].cpu().numpy(), lns[:, 0].cpu().numpy()
        for s, d in enumerate(datas):
            results.append((d["id"], [int(x) for x in toks[s][: int(lns[s])]], d["gold"]))
    return results


def tlm_beam_rescore(
    logit_paths: Sequence[str],
    lm_adapter_factory,
    tokenizer,
    beam_width: int = 25,
    alpha: float = 0.45,
    beta: float = 1.53,
    prune_less_than_val: Optional[float] = 3.17,
    num_workers: int = 4,
    use_device: bool = False,
    stream_batch: int = 1,
    blank_collapse_threshold: Optional[float] = None,
    segment_frames: int = 4096,
) -> Tuple[float, List[Dict]]:
    """LM-beam rescoring of dumped logits → (corpus WER, per-record detail).
    ``use_device``: the device search, ``stream_batch`` recordings per
    group, every stream with the same collapse and segmentation (the group
    size never changes results); else the host search over a pool of
    ``num_workers`` threads, each job with its own adapter."""
    beam_kwargs = dict(beam_width=beam_width, alpha=alpha, beta=beta,
                       prune_less_than_val=prune_less_than_val)
    if use_device:
        results = _rescore_streams(logit_paths, lm_adapter_factory, beam_kwargs,
                                   max(1, stream_batch), blank_collapse_threshold,
                                   segment_frames)
    else:
        jobs = [(p, lm_adapter_factory, beam_kwargs) for p in logit_paths]
        if num_workers <= 1:
            results = [_rescore_one(j) for j in jobs]
        else:
            with ThreadPoolExecutor(max_workers=num_workers) as pool:
                results = list(pool.map(_rescore_one, jobs))
    hyps, refs, detail = [], [], []
    for rid, ids, gold in results:
        text = normalize(tokenizer.decode(ids))
        hyps.append(text)
        refs.append(gold)
        detail.append({"id": rid, "hyp": text, "gold": gold})
    return word_error_rate_detail(hyps, refs)[0], detail


def tlm_beam_grid(
    logit_paths: Sequence[str],
    lm_adapter_factory,
    tokenizer,
    alphas: Sequence[float] = (0.2, 0.45),
    betas: Sequence[float] = (0.8, 1.53),
    prunes: Sequence[float] = (1.5, 3.17),
    beam_width: int = 25,
    num_workers: int = 4,
    use_device: bool = False,
    stream_batch: int = 1,
    blank_collapse_threshold: Optional[float] = None,
    segment_frames: int = 4096,
) -> List[Dict]:
    """Every (α, β, prune) through :func:`tlm_beam_rescore` with the same
    decode settings; the points sorted by WER."""
    results = []
    for a, b, p in itertools.product(alphas, betas, prunes):
        wer, _ = tlm_beam_rescore(
            logit_paths, lm_adapter_factory, tokenizer, beam_width=beam_width, alpha=a, beta=b,
            prune_less_than_val=p, num_workers=num_workers, use_device=use_device,
            stream_batch=stream_batch, blank_collapse_threshold=blank_collapse_threshold,
            segment_frames=segment_frames)
        results.append({"alpha": a, "beta": b, "prune": p, "WER": wer})
        print(f"alpha={a} beta={b} prune={p} -> WER {wer:.5f}")
    return sorted(results, key=lambda r: r["WER"])


def _parser():
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump", help="windowed inference → per-recording logit pickles")
    d.add_argument("-c", "--checkpoint", default="")
    d.add_argument("-d", "--dataset", default="synthetic")
    d.add_argument("-split", "--split", default="test")
    d.add_argument("-seq", "--seq_len", type=int, default=16384)
    d.add_argument("-overlap", "--overlap", type=int, default=0)
    d.add_argument("-s", "--save_path", default="./logits")
    d.add_argument("--tokenizer", default="")
    d.add_argument("--device", default=None, help="cuda (default) or cpu")
    for name in ("rescore", "grid"):
        r = sub.add_parser(name)
        r.add_argument("-logits", "--logits_path", required=True,
                       help="logit-pickle directory or glob")
        r.add_argument("-lm", "--lm_checkpoint", required=True)
        r.add_argument("-beams", "--beam_width", type=int, default=25)
        # grid sweeps every combination of the (repeatable) values; rescore
        # uses exactly one of each
        nargs = "+" if name == "grid" else None
        r.add_argument("-alpha", "--alpha", type=float, nargs=nargs,
                       default=[0.2, 0.45] if name == "grid" else 0.45)
        r.add_argument("-beta", "--beta", type=float, nargs=nargs,
                       default=[0.8, 1.53] if name == "grid" else 1.53)
        r.add_argument("-p", "--p", type=float, nargs=nargs,
                       default=[1.5, 3.17] if name == "grid" else 3.17)
        r.add_argument("--stream_batch", type=int, default=1,
                       help="recordings per group of the device search")
        r.add_argument("--blank_collapse", type=float, default=0.99)
        r.add_argument("--tokenizer", default="")
        r.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser


def _cli(argv=None):
    import glob

    from dynamic_asr_eval_tpu_torch.config import TTAConfig
    from dynamic_asr_eval_tpu_torch.data import get_dataset
    from dynamic_asr_eval_tpu_torch.lm.loader import load_lm_adapter
    from dynamic_asr_eval_tpu_torch.text import load_tokenizer
    from dynamic_asr_eval_tpu_torch.tta import DynamicEvalEngine

    args = _parser().parse_args(argv)
    tokenizer = load_tokenizer(args.tokenizer or None)
    if args.cmd == "dump":
        from dynamic_asr_eval_tpu_torch.evals.common import load_model_and_tokenizer

        model, params, tokenizer, cfg = load_model_and_tokenizer(args)
        engine = DynamicEvalEngine(
            model, cfg.blank_id, cfg.subsampling_factor,
            TTAConfig(seq_len=args.seq_len, overlap=args.overlap, epochs=0, shuffle=False),
            device=args.device)
        paths = create_logits(engine, params, get_dataset(args.dataset, args.split),
                              args.save_path, args.seq_len, args.overlap)
        print(f"dumped {len(paths)} logit pickles to {args.save_path}")
        return paths

    paths = sorted(glob.glob(os.path.join(args.logits_path, "*.pkl"))
                   if os.path.isdir(args.logits_path) else glob.glob(args.logits_path))
    if not paths:
        raise SystemExit(f"no logit pickles at {args.logits_path}")

    def factory():
        return load_lm_adapter(args.lm_checkpoint, tokenizer, device=args.device)

    if args.cmd == "rescore":
        wer, _ = tlm_beam_rescore(
            paths, factory, tokenizer, beam_width=args.beam_width, alpha=args.alpha,
            beta=args.beta, prune_less_than_val=args.p, use_device=True,
            stream_batch=args.stream_batch, blank_collapse_threshold=args.blank_collapse)
        print(f"WER: {wer:.5f}")
        return wer
    return tlm_beam_grid(paths, factory, tokenizer, beam_width=args.beam_width,
                         alphas=args.alpha, betas=args.beta, prunes=args.p, num_workers=1,
                         use_device=True, stream_batch=args.stream_batch,
                         blank_collapse_threshold=args.blank_collapse)


if __name__ == "__main__":
    _cli()
