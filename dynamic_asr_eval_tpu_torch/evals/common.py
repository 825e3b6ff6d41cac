"""Shared driver toolkit: model/tokenizer loading, engine construction,
decoding, WER over records, and the result-pickle schema.

Counterpart of the JAX package's ``evals/common.py``: checkpoints (DAE1 and
reference torch pickles, :func:`..models.checkpoint.load_any_checkpoint`),
the NSTI, AWMC and consistency engines, the LM of ``-lm`` (an ARPA n-gram,
or the transformer LM from a DLM1 file or a lming torch pickle) for the
final beam decode, after groups of ``--decode_batch`` records, and for
LM-fused NSTI pseudo-labels,
greedy decode, the repeat loop the drivers share
(:func:`evaluate_repeats`), and the protocol drivers' evaluation engine
(:func:`build_eval_engine`, :func:`evaluate_with`).

``--dp`` and ``--dp_records`` run on ``torch.distributed``, one process a
card (``torchrun --nproc_per_node=N``; without torchrun, a world of 1):
every rank runs the driver, each on its ``cuda:{LOCAL_RANK}`` (or the CPU
with ``--device cpu``), and only rank 0 prints the corpus lines, writes the
log and writes the result pickle.  ``--dp`` splits each record's offline
inference windows over the ranks; ``--dp_records`` adapts a group of
records at once, one group member a rank (:func:`run_records_dp`).
``--tp N`` with either makes the mesh ``('dp', 'tp')`` with N adjacent
ranks a tp group, and the engine shards its working copy over them
(tensor parallelism).  Without ``--dp`` / ``--dp_records``,
``--tp`` changes nothing, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pickle
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dynamic_asr_eval_tpu_torch import spans
from dynamic_asr_eval_tpu_torch.config import TTAConfig, load_yaml
from dynamic_asr_eval_tpu_torch.device import resolve_device
from dynamic_asr_eval_tpu_torch.lm.loader import load_beamsearch, load_lm_adapter
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, init_conformer, params_from_jax
from dynamic_asr_eval_tpu_torch.models.checkpoint import load_any_checkpoint
from dynamic_asr_eval_tpu_torch.parallel import (
    axis_rank,
    axis_size,
    init_process_group,
    make_mesh,
    reduce_wer_counts,
)
from dynamic_asr_eval_tpu_torch.text import (
    load_tokenizer,
    normalize,
    wer_counts,
    word_error_rate_detail,
)
from dynamic_asr_eval_tpu_torch.tta import AWMCEngine, ConsistencyEngine, DynamicEvalEngine

ENGINES = {"dynamic_eval": DynamicEvalEngine, "awmc": AWMCEngine,
           "consistency": ConsistencyEngine}

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

    ``--checkpoint`` (a DAE1 file or a reference torch pickle) brings its own
    configuration and weights.  Otherwise the configuration is ``config``
    when given, else ``--config`` (a model yaml), else a small default model,
    and the weights come from ``jax_params`` (the JAX package's flax params,
    via :func:`params_from_jax`) when given, else random from ``--seed``."""
    device = resolve_device(device if device is not None else getattr(args, "device", None))
    tokenizer = load_tokenizer(getattr(args, "tokenizer", None) or None)
    vocab = tokenizer.vocab_size()
    if getattr(args, "checkpoint", ""):
        if config is not None or jax_params is not None:
            raise ValueError("--checkpoint carries its own configuration and weights")
        model, _, cfg = load_any_checkpoint(args.checkpoint)
        return _placed(model, device) + (tokenizer, cfg)
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
    return _placed(model, device) + (tokenizer, cfg)


def _placed(model, device):
    model = model.to(device)
    return model, {k: v.detach().clone() for k, v in model.state_dict().items()}


def lm_kwargs(args) -> Dict[str, float]:
    """The beam's fusion settings from ``-kwargs`` (lm_alpha, lm_beta,
    lm_prune_less_than_val, lm_top_am_threshold)."""
    return {"alpha": vars(args).get("lm_alpha", 0.45),
            "beta": vars(args).get("lm_beta", 1.53),
            "prune_less_than_val": vars(args).get("lm_prune_less_than_val", 3.17),
            "top_am_threshold": vars(args).get("lm_top_am_threshold", -6.0)}


def load_language_model(args, tokenizer):
    """``-lm``: ``(lm_adapter, beam_search_fn)``, both ``None`` without it.
    One adapter serves the final decode and the pseudo-labels.  No compute
    dtype is passed, as in the JAX drivers: a transformer LM runs in its
    checkpoint's dtype (f32 unless its DLM1 header says otherwise)."""
    if not getattr(args, "language_model", ""):
        return None, None
    adapter = load_lm_adapter(args.language_model, tokenizer, device=getattr(args, "device", None))
    beam_search_fn = load_beamsearch(args.language_model, tokenizer, adapter=adapter,
                                     **lm_kwargs(args))
    return adapter, beam_search_fn


def data_parallel(args) -> bool:
    """``--dp`` or ``--dp_records``."""
    return bool(getattr(args, "dp", False) or getattr(args, "dp_records", False))


def init_data_parallel(args) -> torch.device:
    """The process group of ``--dp`` / ``--dp_records``
    (:func:`..parallel.init_process_group`: this rank's ``cuda`` device
    becomes the current one, unless ``--device cpu``).  The drivers call it
    before they load the model."""
    return init_process_group(getattr(args, "device", None))


def is_lead_rank() -> bool:
    """Rank 0 of the default process group, or no group at all: the rank
    that prints the corpus lines and writes the log and the pickle."""
    return not dist.is_initialized() or dist.get_rank() == 0


def build_engine(args, model, cfg: ConformerConfig, engine_kind: str = "dynamic_eval",
                 device=None, lm_adapter=None, tokenizer=None) -> DynamicEvalEngine:
    """The ``engine_kind`` engine (``"dynamic_eval"``: NSTI; ``"awmc"``;
    ``"consistency"``).  ``lm_adapter`` gives the NSTI engine LM-fused
    pseudo-labels when ``lm_tta_beams > 0``; AWMC and consistency keep
    greedy teachers, as in the JAX package.  ``tokenizer`` goes to the NSTI
    engine only (``pseudo_label_retokenize``, ``print_pseudo_labels``)."""
    tta = TTAConfig.from_args(args)
    kwargs = {}
    if data_parallel(args):
        init_data_parallel(args)
        kwargs["mesh"] = make_mesh(tp=int(getattr(args, "tp", 1) or 1))
    if tokenizer is not None and engine_kind == "dynamic_eval":
        kwargs["tokenizer"] = tokenizer
    if lm_adapter is not None and engine_kind == "dynamic_eval" and tta.lm_tta_beams > 0:
        kwargs.update(lm_adapter=lm_adapter, lm_beam_kwargs=lm_kwargs(args))
    transfer = torch.float32
    if cfg.compute_dtype == torch.bfloat16 and not bool(vars(args).get("f32_transfer", False)):
        # the model casts its input to bf16 anyway; the window copy is half
        transfer = torch.bfloat16
    device = device if device is not None else getattr(args, "device", None)
    return ENGINES[engine_kind](model, cfg.blank_id, cfg.subsampling_factor, tta,
                                transfer_dtype=transfer, device=device, **kwargs)


def maybe_shard_variables(engine, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``params`` as they are: the counterpart, by name, of the JAX
    package's, whose GSPMD needs the variables placed sharded.  The port's
    engine takes full weights and slices them on every load."""
    return params


def build_eval_engine(model, cfg: ConformerConfig, engine: DynamicEvalEngine) -> DynamicEvalEngine:
    """The protocol drivers' evaluation engine: ``engine``'s configuration
    with ``epochs=0, online=False, shuffle=False`` (windowed inference, no
    adaptation, with whatever weights each call is given), on ``engine``'s
    device and with its transfer dtype (that of :func:`build_engine`)."""
    eval_cfg = dataclasses.replace(engine.config, epochs=0, online=False, shuffle=False)
    return DynamicEvalEngine(model, cfg.blank_id, cfg.subsampling_factor, eval_cfg,
                             transfer_dtype=engine.transfer_dtype, device=engine.device)


def adapt_overlap(args) -> int:
    """``-ao/--adapt_overlap``: the adaptation's overlap, ``--overlap`` when
    it is -1 (the default)."""
    overlap = getattr(args, "adapt_overlap", -1)
    return args.overlap if overlap == -1 else overlap


def evaluate_with(eval_engine, params, records: List[Dict], args, tokenizer) -> Tuple[float, Dict]:
    """Corpus WER of ``records`` through ``eval_engine`` with the weights
    ``params`` (a state dict; not modified): windowed inference at
    ``--seq_len`` / ``--overlap``, greedy decode, normalizer."""
    def run_one(rec):
        spec, gold = rec["process_fn"](rec)
        out = eval_engine(params, spec, args.seq_len, args.overlap)
        return normalize(decode_output(out, tokenizer)), gold

    return evaluate_records(records, run_one, verbose=not getattr(args, "quiet", False))


def run_records_dp(engine, params, records: List[Dict], tokenizer, args, repeat_seed: int,
                   repeat_shuffle: np.random.Generator, rec_counter, beam_search_fn=None,
                   verbose: bool = True) -> Tuple[float, Dict]:
    """``--dp_records``: records in groups of the dp size, each group
    adapted at once, one member a rank (``engine.batched`` on this rank's
    member); a partial last group is padded by repeating its last record,
    whose duplicate result is dropped.  Each record's seed is the serial
    drivers' (``repeat_seed · 1_000_003 + index``), and with ``shuffle`` its
    window orders are drawn from ``repeat_shuffle`` record-major over the
    whole group on every rank, so a record adapts as its serial run does.
    The (hypothesis, gold) pairs are gathered to every rank, and the corpus
    WER re-derived through :func:`..parallel.reduce_wer_counts`."""
    if not hasattr(engine, "batched"):
        raise ValueError(f"--dp_records needs the NSTI engine (got {type(engine).__name__})")
    if engine.mesh is None:
        raise ValueError("--dp_records requires a device mesh (engine.mesh)")
    mesh = engine.mesh
    ndp, rank = axis_size(mesh), axis_rank(mesh)
    group_pg = mesh.get_group("dp")
    cfg = engine.config
    beams = getattr(args, "beams", 1)

    def run_group(group):
        pads = (-len(group)) % ndp
        grp = list(group) + [group[-1]] * pads
        seeds = [repeat_seed * 1_000_003 + next(rec_counter) for _ in group]
        seeds += [seeds[-1]] * pads
        spec, gold = grp[rank]["process_fn"](grp[rank])
        orders = None
        if cfg.shuffle and cfg.epochs > 0:
            n_frames = [None] * ndp
            dist.all_gather_object(n_frames, int(np.asarray(spec).shape[-1]), group=group_pg)
            orders = _group_orders(engine, n_frames, args, repeat_shuffle)[rank : rank + 1]
        (out,) = engine.batched(params, [spec], args.seq_len, args.overlap,
                                rngs=seeds[rank : rank + 1], shuffle_rng=repeat_shuffle,
                                orders=orders)
        pair = (normalize(decode_output(out, tokenizer, beam_search_fn, beams)), gold)
        pairs = [None] * ndp
        dist.all_gather_object(pairs, pair, group=group_pg)
        return pairs[: len(group)]

    lead = is_lead_rank()
    wer, detail = evaluate_records_grouped(records, run_group, ndp, verbose=verbose and lead)
    counts = np.stack([wer_counts(h, g) for h, g in zip(detail["model_output"], detail["gold"])])
    tot = reduce_wer_counts(counts, mesh)
    detail["wer"] = float((int(tot[0]) + int(tot[1]) + int(tot[2])) / max(int(tot[3]), 1))
    return detail["wer"], detail


def _group_orders(engine, n_frames: List[int], args, shuffle_rng: np.random.Generator):
    """Every group member's window orders, a permutation of its real
    windows per epoch, drawn record-major from ``shuffle_rng`` as
    ``engine.batched`` draws them for a group it holds whole."""
    return [[shuffle_rng.permutation(engine.window_count(n, args.seq_len, args.overlap))
             for _ in range(engine.config.epochs)] for n in n_frames]


def decode_output(out, tokenizer, beam_search_fn: Optional[Callable] = None,
                  beams: int = 1) -> str:
    """Final decode of a stitched engine output: the LM beam search on the
    device when ``beam_search_fn`` is given and ``beams > 1``, else greedy
    (decoded on the device; only the ids move to the host)."""
    if beam_search_fn is not None and beams > 1:
        return beam_search_fn.from_engine_output(out, beam_width=beams)
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
        t0 = time.perf_counter()
        hyp, gold = run_one(rec)
        elapsed_times.append(time.perf_counter() - t0)
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
    return _wer_detail(all_texts, all_golds, elapsed_times, log_path)


def evaluate_records_grouped(
    records: List[Dict],
    run_group: Callable[[List[Dict]], List[Tuple[str, str]]],
    group_size: int,
    log_path: str = "",
    verbose: bool = True,
) -> Tuple[float, Dict]:
    """:func:`evaluate_records` over groups of records (``--decode_batch``):
    ``run_group(records[i:i + group_size]) -> [(hyp, gold), ...]``; each
    record's elapsed time is the group's wall over its size."""
    all_texts, all_golds, elapsed_times = [], [], []
    for g0 in range(0, len(records), group_size):
        group = records[g0 : g0 + group_size]
        t0 = time.perf_counter()
        pairs = run_group(group)
        per_rec = (time.perf_counter() - t0) / len(group)
        for i, (rec, (hyp, gold)) in enumerate(zip(group, pairs)):
            elapsed_times.append(per_rec)
            if verbose:
                print(gold, "\n", hyp, "\n\n")
            append_log(
                log_path,
                f"record {g0 + i + 1}/{len(records)} "
                f"({rec.get('id', rec.get('audio', '?'))}): "
                f"elapsed {per_rec:.2f}s (group of {len(group)})",
            )
            all_texts.append(hyp)
            all_golds.append(gold)
    return _wer_detail(all_texts, all_golds, elapsed_times, log_path)


def _wer_detail(all_texts, all_golds, elapsed_times, log_path):
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


def evaluate_repeats(args, engine, params, tokenizer, records: List[Dict],
                     log_line: Callable[[float], str], beam_search_fn=None) -> float:
    """The drivers' loop: ``-r`` repeats, each with its own seed (``seed ·
    1000 + repeat``) and a distinct augmentation stream per recording; final
    decode (greedy, or the LM beam with ``--beams`` above 1; with
    ``--decode_batch`` N above 1 too, N records are adapted before their
    decodes, as the JAX package groups them), normalizer, corpus WER, a log
    line, the result pickle.  With ``--profile DIR``, repeat 0 runs under
    :func:`profile_to`.  Returns the mean WER."""
    wers = []
    repeats = getattr(args, "repeats", 1)
    seed = getattr(args, "seed", None)
    base_seed = 0 if seed is None else int(seed)
    beams = getattr(args, "beams", 1)
    decode_batch = int(getattr(args, "decode_batch", 1) or 1)
    lead = is_lead_rank()
    verbose = not getattr(args, "quiet", False) and lead
    for repeat in range(repeats):
        repeat_seed = base_seed * 1000 + repeat
        repeat_shuffle = np.random.default_rng(repeat_seed)
        rec_counter = iter(range(len(records)))

        def adapt_one(rec):
            spec, gold = rec["process_fn"](rec)
            rec_seed = repeat_seed * 1_000_003 + next(rec_counter)
            out = engine(params, spec, args.seq_len, args.overlap,
                         rng=rec_seed, shuffle_rng=repeat_shuffle)
            return out, gold

        def run_one(rec):
            out, gold = adapt_one(rec)
            return normalize(decode_output(out, tokenizer, beam_search_fn, beams)), gold

        def run_group(group):
            # adapt one record after another, then decode each on the device
            outs = [adapt_one(rec) for rec in group]
            return [(normalize(decode_output(out, tokenizer, beam_search_fn, beams)), gold)
                    for out, gold in outs]

        profile_dir = getattr(args, "profile", "")
        with (profile_to(profile_dir) if profile_dir and repeat == 0
              else contextlib.nullcontext()):
            if getattr(args, "dp_records", False):
                wer, detail = run_records_dp(engine, params, records, tokenizer, args,
                                             repeat_seed, repeat_shuffle, rec_counter,
                                             beam_search_fn=beam_search_fn, verbose=verbose)
            elif beam_search_fn is not None and beams > 1 and decode_batch > 1:
                wer, detail = evaluate_records_grouped(records, run_group, decode_batch,
                                                       verbose=verbose)
            else:
                wer, detail = evaluate_records(records, run_one, verbose=verbose)
        wers.append(wer)
        if not lead:
            continue
        print(f"WER: {wer}")
        append_log(getattr(args, "log", ""), log_line(wer))
        if getattr(args, "save_path", ""):
            save_result_pickle(args.save_path, detail, args, repeat, repeats)
    mean_wer = sum(wers) / len(wers)
    if lead:
        print(f"Average WER: {mean_wer}")
    return mean_wer


PROFILE_TRACE = "repeat_0.pt.trace.json"
PROFILE_SPANS = "spans.json"


@contextlib.contextmanager
def profile_to(directory: str):
    """A ``torch.profiler`` trace of the enclosed work (host ops, and CUDA
    kernels where there is a card) written into ``directory`` as the Chrome
    trace :data:`PROFILE_TRACE` (TensorBoard's profiler plugin and Perfetto
    read it): the port's form of JAX's ``jax.profiler.trace``.  The spans
    recorded meanwhile (:mod:`..spans`: the engine's phases) go beside it
    as :data:`PROFILE_SPANS`, a JSON list of ``Span.as_dict()``, on the
    profiler's own clock (epoch ns)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    spans.start()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
    finally:
        recorded = spans.stop()
    prof.export_chrome_trace(os.path.join(directory, PROFILE_TRACE))
    with open(os.path.join(directory, PROFILE_SPANS), "w") as f:
        json.dump([s.as_dict() for s in recorded], f)


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
