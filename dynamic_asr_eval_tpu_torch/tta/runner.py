"""Chunked dynamic-evaluation (NSTI) engine.

Counterpart of the JAX package's ``tta/runner.py`` (``DynamicEvalEngine``,
``EngineOutput``, ``chunked_inference``):

- the same window plan (``_plan``: seq_len / overlap windows with the
  reference stop rule, the window count padded to a bucket, ``T_pad`` and
  ``total_ds`` derived from the bucket); padded zero-length windows are
  skipped with a plain ``if``;
- per window, one forward of the batch ``[augmented × num_negatives,
  clean]``, greedy pseudo-labels from the detached clean log-probs, CTC loss
  on the augmented copies divided by ``max(ds_len, 1) · num_negatives``,
  backward, one MADGRAD step;
- online mode stitches the clean output of each adaptation step (every epoch
  starts a fresh stitch; the last epoch's wins); offline mode runs a fresh
  no-grad pass over the windows, ``infer_batch`` at a time, with the adapted
  weights;
- the caller's weights are never modified: each call loads them into the
  engine's own working copy of the model.

With an LM adapter and ``lm_tta_beams > 0`` the pseudo-labels are the top
beam of the LM-fused beam search over the clean window
(:func:`..ops.beam_search.beam_search_device`) instead of greedy.  Options
of ``TTAConfig``, as in the JAX engine:

- ``entropy_augmentation``: after the augmentation pipeline, the augmented
  copies move by 1e-3 · ∂ mean_entropy / ∂ copies, where mean_entropy is
  the mean over all ``num_negatives × T_ds(W)`` frames of the padded window
  (padding frames included, as JAX computes it) of the model's output
  entropy; the pass runs on detached weights;
- ``pseudo_label_retokenize``: each window's labels go through the host
  round trip ``tokenizer.encode(tokenizer.decode(ids))``
  (:func:`.retokenize.retokenize_labels`); needs ``tokenizer=``;
- ``print_pseudo_labels``: per window, the pseudo-labels and the first
  noisy stream's greedy decode, through the tokenizer when there is one.

With ``mesh=`` (a ``('dp', 'tp')`` mesh of :mod:`..parallel`, ``--dp``)
the adaptation runs the same on every rank, and the offline inference
rounds ``infer_batch`` up to a multiple of dp: each rank forwards its block
of every batch, and the stitch accumulators are summed over the dp ranks
before the average.  Where the mesh's tp size is above 1, the engine's
working copy is sliced to this rank's shards (``parallel.shard_params``):
each call takes full weights and loads this rank's slices of them, every
tp rank draws the same augmentation and pseudo-labels, and
``EngineOutput.params`` holds the gathered full weights.

:meth:`DynamicEvalEngine.batched` adapts R recordings at once
(``--dp_records``): each keeps its own weights, stacked on a leading axis,
and one window step forwards all R through ``torch.func.vmap`` of the
model (the kernels' ``vmap`` rules: the attention folds the records into
its batch, one launch; the subsampling, with per-record weights, launches
once per record).
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from dynamic_asr_eval_tpu_torch import spans
from dynamic_asr_eval_tpu_torch.augment import apply_augmentation_pipeline
from dynamic_asr_eval_tpu_torch.config import TTAConfig
from dynamic_asr_eval_tpu_torch.device import resolve_device
from dynamic_asr_eval_tpu_torch.ops.beam_search import beam_search_device
from dynamic_asr_eval_tpu_torch.ops.chunk import chunk_starts_and_lengths, pad_num_chunks
from dynamic_asr_eval_tpu_torch.ops.ctc import ctc_loss, greedy_labels
from dynamic_asr_eval_tpu_torch.optim.madgrad import MADGRAD, RecordsMADGRAD
from dynamic_asr_eval_tpu_torch.optim.masks import param_labels
from dynamic_asr_eval_tpu_torch.parallel.mesh import (
    axis_rank,
    axis_size,
    gather_state,
    shard_params,
    shard_state,
)
from dynamic_asr_eval_tpu_torch.tta.retokenize import retokenize_labels


def _ds_ceil(x, factor):
    return -(-x // factor)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class EngineOutput:
    """``logits`` [total_ds, V] stitched log-probs and ``counts`` [total_ds]
    coverage on the device; ``numpy_logits()`` gives the trimmed host matrix,
    ``greedy_ids()`` decodes on the device and moves only the ids."""

    def __init__(self, logits, counts, params, elapsed: float, blank_id: int):
        self.logits = logits
        self.counts = counts
        self.params = params
        self.elapsed = elapsed
        self._blank_id = blank_id

    def numpy_logits(self) -> np.ndarray:
        keep = (self.counts > 0).cpu().numpy()
        return self.logits.detach().float().cpu().numpy()[keep]

    def greedy_ids(self, max_tokens: Optional[int] = None) -> np.ndarray:
        T = self.logits.shape[0]
        max_tokens = max_tokens or max(8, T // 2)
        n_valid = (self.counts > 0).sum()
        ids, length = greedy_labels(self.logits, n_valid, self._blank_id, max_tokens)
        return ids.cpu().numpy()[: int(length)]


class DynamicEvalEngine:
    """NSTI dynamic evaluation for a conformer-CTC model.

    ``model`` follows the call surface ``model(audio [B, F, T], length [B])
    -> {'final_posteriors', 'length'}``.  ``augment_fn(batch [B, F, W],
    generator, actual_len) -> [B, F, W]`` replaces the spectrogram
    augmentation pipeline (tests inject the same masks on both sides with
    it).  ``lm_adapter`` and ``lm_beam_kwargs`` (alpha, beta,
    prune_less_than_val, top_am_threshold) give LM-fused pseudo-labels when
    ``config.lm_tta_beams > 0``.  ``tokenizer`` serves
    ``pseudo_label_retokenize`` (required there) and the
    ``print_pseudo_labels`` text.  ``mesh`` splits the offline inference's
    windows over the dp ranks.  ``device`` defaults to ``cuda``."""

    def __init__(
        self,
        model: torch.nn.Module,
        blank_id: int,
        subsampling_factor: int,
        config: TTAConfig,
        num_negatives: int = 1,
        max_label_frames_ratio: float = 1.0,
        infer_batch: int = 4,
        transfer_dtype: torch.dtype = torch.float32,
        augment_fn: Optional[Callable] = None,
        out_len_fn: Optional[Callable[[int], int]] = None,
        n_classes: Optional[int] = None,
        lm_adapter=None,
        lm_beam_kwargs: Optional[Dict] = None,
        mesh=None,
        tokenizer=None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if config.pseudo_label_retokenize and tokenizer is None:
            raise ValueError("pseudo_label_retokenize=True needs tokenizer= on the engine")
        self.device = resolve_device(device)
        self.model = model
        self.blank_id = blank_id
        self.ds = subsampling_factor
        self.config = config
        self.num_negatives = num_negatives
        self.max_label_frames_ratio = max_label_frames_ratio
        self.infer_batch = infer_batch
        self.transfer_dtype = transfer_dtype
        self.augment_fn = augment_fn
        self.out_len_fn = out_len_fn or (lambda W: -(-W // subsampling_factor))
        self.n_classes = n_classes if n_classes is not None else blank_id + 1
        self.lm_adapter = lm_adapter
        self.lm_beam_kwargs = dict(lm_beam_kwargs or {})
        self.tokenizer = tokenizer
        self.mesh = mesh
        opt_args = dict(config.optim_args)
        self.lr = opt_args.pop("lr", 9e-5)
        self.opt_args = opt_args
        self._work = copy.deepcopy(model).to(self.device)
        self._sharding = (shard_params(self._work, mesh)
                          if mesh is not None and axis_size(mesh, "tp") > 1 else None)
        self._trainable_names = self._trainable()

    # -- parameters ---------------------------------------------------------
    def _trainable(self) -> Dict[str, bool]:
        c = self.config
        names = [n for n, _ in self._work.named_parameters()]
        if not (c.bitfit or c.freeze_subsampling or c.freeze_all_but_last_block_and_head
                or c.train_subsampling_only):
            return {n: True for n in names}
        labels = param_labels(
            names,
            bitfit=c.bitfit,
            freeze_subsampling=c.freeze_subsampling,
            last_block_and_head=c.freeze_all_but_last_block_and_head,
            subsampling_only=c.train_subsampling_only,
            n_layers=getattr(self.model.config, "n_layers", None),
        )
        return {n: labels[n] == "train" for n in names}

    def _local_state(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A full state dict as the working copy holds it: under tp, this
        rank's slices."""
        if self._sharding is None:
            return state
        return shard_state(state, self._sharding, self.mesh)

    def _full_state(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Detached copies of the working copy's ``state``, gathered to full
        tensors under tp."""
        if self._sharding is None:
            return {k: v.detach().clone() for k, v in state.items()}
        return gather_state(state, self._sharding, self.mesh)

    def _load(self, params: Optional[Dict[str, torch.Tensor]]) -> None:
        src = self.model.state_dict() if params is None else params
        self._work.load_state_dict(self._local_state(src), strict=True)
        for name, p in self._work.named_parameters():
            p.requires_grad_(self._trainable_names[name])

    def _generator(self, rng: Union[int, torch.Generator, None]) -> torch.Generator:
        if isinstance(rng, torch.Generator):
            return rng
        return torch.Generator(device=self.device).manual_seed(int(rng or 0))

    # -- host-side plan -----------------------------------------------------
    def _plan(self, spec: np.ndarray, seq_len: int, overlap: int):
        """One recording's window plan: :meth:`_records_plan` of a group of
        one."""
        spec_b, W, N, (n_real,), starts, lengths, total_ds = self._records_plan(
            [spec], seq_len, overlap)
        return spec_b[0], np.asarray(spec).shape[-1], W, N, n_real, starts[0], lengths[0], total_ds

    # -- one adaptation step ------------------------------------------------
    def _augment(self, batch: torch.Tensor, gen: torch.Generator, w_len: int) -> torch.Tensor:
        """``augment_fn`` when given, else the configured pipeline."""
        if self.augment_fn is not None:
            return self.augment_fn(batch, gen, w_len)
        c = self.config
        return apply_augmentation_pipeline(
            batch, gen, c.spec_augment, c.frame_shuffle, c.cutout, c.random_noise,
            actual_len=w_len)

    def _pseudo_labels(self, clean_lp, ds_len: int, max_tokens: int):
        """``(labels [max_tokens], length)`` of the clean window: greedy, or
        the top beam of the LM-fused beam search when ``lm_tta_beams`` is
        on; then, with ``pseudo_label_retokenize``, the host round trip."""
        beams = int(getattr(self.config, "lm_tta_beams", 0) or 0)
        if self.lm_adapter is None or beams <= 0:
            labels, lab_len = greedy_labels(clean_lp, ds_len, self.blank_id, max_tokens)
        else:
            toks, lens, _ = beam_search_device(
                clean_lp, self.lm_adapter, beam_width=beams, blank_id=self.blank_id,
                valid_frames=ds_len, max_tokens=max_tokens, **self.lm_beam_kwargs)
            labels, lab_len = toks[0], torch.clamp(lens[0], max=max_tokens)
        if self.config.pseudo_label_retokenize:
            labels, lab_len = retokenize_labels(labels, lab_len, self.tokenizer, max_tokens)
        return labels, lab_len

    def _print_pseudo_labels(self, labels, lab_len, noisy, noisy_len) -> None:
        """The per-window debug print (``print_pseudo_labels``)."""
        ids, nids = labels[: int(lab_len)].tolist(), noisy[: int(noisy_len)].tolist()
        if self.tokenizer is not None:
            ids, nids = self.tokenizer.decode(ids), self.tokenizer.decode(nids)
        print(f"Pseudo targets: {ids}")
        print(f"Noisy predictions: {nids}")
        print("\n--\n")

    def _entropy_delta(self, aug: torch.Tensor, w_len: int) -> torch.Tensor:
        """The entropy augmentation's perturbation ``1e-3 · ∂
        mean_entropy(aug) / ∂ aug``: the mean over every frame of the padded
        window (padding frames included) of the output entropy, on detached
        weights (no weight gradients; the kernels' own backward still
        computes theirs)."""
        aug = aug.detach().requires_grad_(True)
        lengths = torch.full((aug.shape[0],), w_len, dtype=torch.int64, device=self.device)
        weights = {n: p.detach() for n, p in self._work.named_parameters()}
        lp = torch.func.functional_call(self._work, weights, (aug, lengths))["final_posteriors"]
        entropy = torch.mean(-torch.sum(torch.exp(lp) * lp, dim=-1))
        (grad,) = torch.autograd.grad(entropy, aug)
        return 1e-3 * grad

    def _adapt_step(self, opt, spec_dev, start: int, w_len: int, W: int,
                    max_tokens: int, gen: torch.Generator):
        """Returns the detached clean log-probs [T_ds, V] and ds_len.  Its
        phases are the spans ``engine.augment``, ``.forward``, ``.labels``,
        ``.loss``, ``.backward`` and ``.optimizer``."""
        nn = self.num_negatives
        with spans.span("engine.augment"):
            window = spec_dev[:, start : start + W].float()
            aug = self._augment(window[None].repeat(nn, 1, 1), gen, w_len)
            if self.config.entropy_augmentation:
                aug = (aug + self._entropy_delta(aug, w_len)).detach()
            batch = torch.cat([aug, window[None]], dim=0)  # [nn + 1, F, W]
            lengths = torch.full((nn + 1,), w_len, dtype=torch.int64, device=self.device)
            ds_len = self.out_len_fn(w_len)

        with spans.span("engine.forward"):
            out = self._work(batch, lengths)
        with spans.span("engine.labels"):
            lp = out["final_posteriors"]
            clean_lp = lp[-1].detach()
            labels, lab_len = self._pseudo_labels(clean_lp, ds_len, max_tokens)
            if self.config.print_pseudo_labels:
                noisy, noisy_len = greedy_labels(lp[0].detach(), ds_len, self.blank_id,
                                                 max_tokens)
                self._print_pseudo_labels(labels, lab_len, noisy, noisy_len)
        with spans.span("engine.loss"):
            loss = ctc_loss(
                lp[:nn],
                torch.full((nn,), ds_len, dtype=torch.int64, device=self.device),
                labels[None].repeat(nn, 1),
                lab_len.expand(nn),
                blank_id=self.blank_id,
            ) / (max(ds_len, 1) * nn)
        with spans.span("engine.backward"):
            opt.zero_grad(set_to_none=True)
            loss.backward()
            # the autograd graph is torn down here rather than at the
            # return, so that its time (about 1 ms a window on an H100)
            # falls inside a span
            del out, lp, loss
        with spans.span("engine.optimizer"):
            opt.step()
        return clean_lp, ds_len

    # -- inference (no-grad chunked forward + stitch) -----------------------
    @torch.no_grad()
    def _infer(self, spec_dev, W, n_real, starts_np, lengths_np, total_ds):
        """With a mesh, ``infer_batch`` rounds up to a multiple of dp, each
        rank forwards its block of every batch, and the accumulators are
        summed over the ranks."""
        V = self.n_classes
        acc = torch.zeros(total_ds, V, dtype=torch.float32, device=self.device)
        counts = torch.zeros(total_ds, dtype=torch.float32, device=self.device)
        ndp, rank = (axis_size(self.mesh), axis_rank(self.mesh)) if self.mesh else (1, 0)
        share = -(-self.infer_batch // ndp)
        for b0 in range(rank * share, n_real, share * ndp):
            idx = range(b0, min(b0 + share, n_real))
            w = torch.stack([spec_dev[:, int(starts_np[i]) : int(starts_np[i]) + W]
                             for i in idx]).float()
            lens = torch.as_tensor([int(lengths_np[i]) for i in idx], device=self.device)
            lp = self._work(w, lens)["final_posteriors"]
            for j, i in enumerate(idx):
                self._accumulate(acc, counts, lp[j], int(starts_np[i]) // self.ds,
                                 self.out_len_fn(int(lengths_np[i])))
        if self.mesh is not None:
            group = self.mesh.get_group("dp")
            dist.all_reduce(acc, group=group)
            dist.all_reduce(counts, group=group)
        return self._finish(acc, counts)

    @staticmethod
    def _accumulate(acc, counts, lp, start_ds: int, ds_len: int) -> None:
        acc[start_ds : start_ds + ds_len] += torch.exp(lp[:ds_len])
        counts[start_ds : start_ds + ds_len] += 1.0

    @staticmethod
    def _finish(acc, counts):
        avg = acc / torch.clamp(counts[:, None], min=1.0)
        return torch.log(torch.clamp(avg, min=1e-12)), counts

    # -- public API ---------------------------------------------------------
    def __call__(
        self,
        params: Optional[Dict[str, torch.Tensor]],
        spec: np.ndarray,  # [F, T] or [1, F, T]
        seq_len: int = -1,
        overlap: int = -1,
        return_params: bool = False,
        rng: Union[int, torch.Generator, None] = None,
        shuffle_rng: Optional[np.random.Generator] = None,
        adapt_only: bool = False,
    ) -> EngineOutput:
        """Adapt on one recording and return its stitched log-probs.
        ``params`` is a state dict of the model (``None``: the engine's own
        model's weights); it is not modified.  ``rng`` seeds the augmentation
        generator; ``shuffle_rng`` draws the offline window order.

        Spans (:mod:`..spans`, recorded while the recorder is on): the root
        ``engine.record`` (attributes ``frames``, ``epochs`` and ``windows``,
        the adapted windows, counted as each ends), and under it
        ``engine.plan``, ``engine.load`` (the weights, the spectrogram's copy
        to the device, the optimizer's state), one ``engine.window`` for
        each adapted window (``epoch``, ``index``, ``valid_frames``; its children
        are :meth:`_adapt_step`'s phases and, online, ``engine.stitch``),
        offline ``engine.infer``, and ``engine.drain``, the wait for the
        device at the end.  ``EngineOutput.elapsed`` is the host's monotonic
        time from the end of the plan to the end of the drain."""
        cfg = self.config
        with spans.span("engine.record", epochs=cfg.epochs, windows=0) as record:
            with spans.span("engine.plan"):
                spec_padded, spec_n, W, N, n_real, starts_np, lengths_np, total_ds = self._plan(
                    spec, seq_len, overlap)
                gen = self._generator(rng)
                shuffle_rng = shuffle_rng or np.random.default_rng(0)
            record.set(frames=spec_n)

            t0 = time.perf_counter()
            with spans.span("engine.load"):
                self._load(params)
                spec_dev = torch.as_tensor(spec_padded, device=self.device).to(
                    self.transfer_dtype)
                max_tokens = max(8, int(self.out_len_fn(W) * self.max_label_frames_ratio))
                if cfg.epochs > 0:
                    trainable = [p for p in self._work.parameters() if p.requires_grad]
                    opt = MADGRAD(trainable, lr=self.lr, **self.opt_args)
            online_result = None

            for epoch in range(cfg.epochs):
                if cfg.shuffle:
                    order = np.concatenate([shuffle_rng.permutation(n_real),
                                            np.arange(n_real, N)])
                else:
                    order = np.arange(N)
                acc = counts = None
                if cfg.online:  # a fresh stitch per epoch; the last one wins
                    acc = torch.zeros(total_ds, self.n_classes, device=self.device)
                    counts = torch.zeros(total_ds, device=self.device)
                for i in order:
                    w_len = int(lengths_np[i])
                    if w_len == 0:  # padded window of the bucket
                        continue
                    with spans.span("engine.window", epoch=epoch, index=int(i),
                                    valid_frames=w_len):
                        clean_lp, ds_len = self._adapt_step(
                            opt, spec_dev, int(starts_np[i]), w_len, W, max_tokens, gen)
                        if cfg.online:
                            with spans.span("engine.stitch"):
                                self._accumulate(acc, counts, clean_lp,
                                                 int(starts_np[i]) // self.ds, ds_len)
                    record.add("windows")
                if cfg.online:
                    online_result = self._finish(acc, counts)

            adapted = None
            if return_params or adapt_only:
                adapted = self._full_state(self._work.state_dict())
            if adapt_only:
                with spans.span("engine.drain"):
                    _sync(self.device)
                return EngineOutput(None, None, adapted, time.perf_counter() - t0,
                                    self.blank_id)

            if cfg.online and online_result is not None:
                log_avg, counts = online_result
            else:
                with spans.span("engine.infer"):
                    log_avg, counts = self._infer(spec_dev, W, n_real, starts_np, lengths_np,
                                                  total_ds)
            with spans.span("engine.drain"):
                _sync(self.device)
            elapsed = time.perf_counter() - t0
        if cfg.print_runtimes:
            print(f"Spectrogram length: {spec_n}")
            print(f"Runtime: {elapsed}")
        return EngineOutput(log_avg, counts, adapted, elapsed, self.blank_id)

    # -- records batching (--dp_records) ------------------------------------
    def window_count(self, n_frames: int, seq_len: int = -1, overlap: int = -1) -> int:
        """The number of real windows of an ``n_frames`` recording."""
        seq_len = self.config.seq_len if seq_len == -1 else seq_len
        overlap = self.config.overlap if overlap == -1 else overlap
        if n_frames <= seq_len:
            return 1
        return len(chunk_starts_and_lengths(n_frames, seq_len, overlap)[0])

    def _records_plan(self, specs, seq_len: int, overlap: int):
        """The JAX package's plan (``_plan`` and ``batched``): one window
        size ``W = min(seq_len, max length)`` and one bucketed window count
        ``N`` for the group; ``T_pad`` and ``total_ds`` follow the bucket (in
        JAX they key the compiled program).  Returns (spectrograms [R, F,
        T_pad], W, N, real windows per record, starts [R, N], lengths [R,
        N], total_ds)."""
        cfg = self.config
        seq_len = cfg.seq_len if seq_len == -1 else seq_len
        overlap = cfg.overlap if overlap == -1 else overlap
        specs = [np.asarray(s) for s in specs]
        specs = [s[0] if s.ndim == 3 else s for s in specs]
        max_n = max(s.shape[-1] for s in specs)
        W = min(seq_len, max_n)
        if max_n <= W:  # every record fits one window: no overlap to check
            overlap = 0
        if overlap % self.ds:
            raise ValueError(
                f"overlap ({overlap}) must be a multiple of the subsampling "
                f"factor ({self.ds})")
        if max_n > W and W % self.ds:
            raise ValueError(
                f"seq_len ({W}) must be a multiple of the subsampling factor "
                f"({self.ds}) when any spectrogram spans multiple windows")
        plans = [chunk_starts_and_lengths(s.shape[-1], W, overlap if s.shape[-1] > W else 0)
                 for s in specs]
        R, N = len(specs), pad_num_chunks(max(len(p[0]) for p in plans))
        starts = np.zeros((R, N), np.int64)
        lengths = np.zeros((R, N), np.int64)
        for r, (st, ln) in enumerate(plans):
            starts[r, : len(st)] = st
            lengths[r, : len(ln)] = ln
        if max_n > W:
            T_pad = (N - 1) * (W - overlap) + W
        else:
            T_pad = int(max(starts.max() + W, max_n))
        spec_b = np.zeros((R, specs[0].shape[0], T_pad), dtype=specs[0].dtype)
        for r, sp in enumerate(specs):
            spec_b[r, :, : sp.shape[-1]] = sp
        total_ds = _ds_ceil(T_pad, self.ds) + _ds_ceil(W, self.ds)
        n_reals = [len(p[0]) for p in plans]
        return spec_b, W, N, n_reals, starts, lengths, total_ds

    def _records_forward(self, stacked, batch, lengths):
        """``final_posteriors`` of ``batch`` [R, B, F, W] (``lengths`` [R,
        B]), record r through its own weights ``stacked[name][r]``; the
        buffers are shared, as JAX's ``extra_vars`` is ``in_axes=None``."""
        buffers = dict(self._work.named_buffers())

        def one(weights, x, length):
            out = torch.func.functional_call(self._work, (weights, buffers), (x, length))
            return out["final_posteriors"]

        remat = getattr(self._work, "rematerialise", None)
        if remat is not None:  # a checkpoint cannot recompute inside vmap
            self._work.rematerialise = False
        try:
            return torch.func.vmap(one)(stacked, batch, lengths)
        finally:
            if remat is not None:
                self._work.rematerialise = remat

    def _records_entropy_delta(self, stacked, aug, lengths):
        """:meth:`_entropy_delta` of every record at once: each record's
        mean entropy over its own copies, on its own detached weights."""
        aug = aug.detach().requires_grad_(True)
        weights = {n: p.detach() for n, p in stacked.items()}
        lp = self._records_forward(weights, aug, lengths)
        entropy = torch.mean(-torch.sum(torch.exp(lp) * lp, dim=-1), dim=(1, 2)).sum()
        (grad,) = torch.autograd.grad(entropy, aug)
        return 1e-3 * grad

    def _records_step(self, opt, stacked, spec_dev, starts, w_lens, W, max_tokens, gens):
        """One window step of every record whose window here is real
        (``w_lens[r] > 0``); the others ride along and are not stepped.
        Returns the detached clean log-probs [R, T_ds, V]."""
        R, nn = len(w_lens), self.num_negatives
        active = [int(n) > 0 for n in w_lens]
        windows = torch.stack([spec_dev[r, :, int(starts[r]) : int(starts[r]) + W]
                               for r in range(R)]).float()  # [R, F, W]
        aug = torch.stack([self._augment(windows[r][None].repeat(nn, 1, 1), gens[r], int(w_lens[r]))
                           if active[r] else windows[r][None].repeat(nn, 1, 1)
                           for r in range(R)])  # [R, nn, F, W]
        lens = torch.as_tensor(np.asarray(w_lens, np.int64), device=self.device)
        if self.config.entropy_augmentation:
            aug = (aug + self._records_entropy_delta(stacked, aug, lens[:, None].expand(R, nn))
                   ).detach()
        batch = torch.cat([aug, windows[:, None]], dim=1)  # [R, nn + 1, F, W]
        lp = self._records_forward(stacked, batch, lens[:, None].expand(R, nn + 1))
        clean_lp = lp[:, -1].detach()

        rows, targets, target_lens, in_lens, weights = [], [], [], [], []
        for r in range(R):
            if not active[r]:
                continue
            ds_len = self.out_len_fn(int(w_lens[r]))
            labels, lab_len = self._pseudo_labels(clean_lp[r], ds_len, max_tokens)
            rows.append(r)
            targets.append(labels[None].expand(nn, -1))
            target_lens.append(lab_len.reshape(1).expand(nn))
            in_lens += [ds_len] * nn
            weights += [1.0 / (max(ds_len, 1) * nn)] * nn
        aug_lp = lp[rows, :nn]  # [A, nn, T_ds, V]
        loss = ctc_loss(
            aug_lp.reshape(-1, *aug_lp.shape[2:]),
            torch.as_tensor(in_lens, dtype=torch.int64, device=self.device),
            torch.cat(targets),
            torch.cat(target_lens),
            blank_id=self.blank_id,
            sample_weights=torch.as_tensor(weights, dtype=torch.float32, device=self.device),
        )
        opt.zero_grad()
        loss.backward()
        opt.step(active)
        return clean_lp

    @torch.no_grad()
    def _records_infer(self, stacked, spec_dev, W, n_reals, starts, lengths, total_ds):
        """The offline pass with the adapted stacks: ``infer_batch`` windows
        of every record a forward, the window axis unsplit (JAX's
        ``use_mesh=False``)."""
        R, V = len(n_reals), self.n_classes
        acc = torch.zeros(R, total_ds, V, dtype=torch.float32, device=self.device)
        counts = torch.zeros(R, total_ds, dtype=torch.float32, device=self.device)
        for b0 in range(0, max(n_reals), self.infer_batch):
            idx = range(b0, min(b0 + self.infer_batch, max(n_reals)))
            w = torch.stack([torch.stack([spec_dev[r, :, int(starts[r, i]) : int(starts[r, i]) + W]
                                          for i in idx]) for r in range(R)]).float()
            lens = torch.as_tensor(lengths[:, list(idx)], device=self.device)
            lp = self._records_forward(stacked, w, lens)
            for r in range(R):
                for j, i in enumerate(idx):
                    if i < n_reals[r]:
                        self._accumulate(acc[r], counts[r], lp[r, j], int(starts[r, i]) // self.ds,
                                         self.out_len_fn(int(lengths[r, i])))
        return [self._finish(acc[r], counts[r]) for r in range(R)]

    def batched(
        self,
        params: Optional[Dict[str, torch.Tensor]],
        specs,  # list of [F, T_r] (or [1, F, T_r]) spectrograms
        seq_len: int = -1,
        overlap: int = -1,
        rng: Optional[int] = None,
        shuffle_rng: Optional[np.random.Generator] = None,
        rngs=None,
        orders=None,
        return_params: bool = False,
    ) -> List[EngineOutput]:
        """Adapt R recordings at once (``--dp_records``), each from
        ``params`` (a state dict; ``None``: the engine's model's weights) as
        :meth:`__call__` adapts it alone; returns one :class:`EngineOutput`
        per recording, in order, with ``params=None`` (with
        ``return_params``, the record's adapted state dict) and ``elapsed``
        the group's wall over R.

        The group shares ``W = min(seq_len, max length)`` and one bucketed
        window count.  ``rngs`` holds each record's seed or
        ``torch.Generator`` (by default ``rng · 1_000_003 + r``); a record's
        augmentation stream is the one its serial run with that seed draws.
        With ``shuffle``, the window orders are drawn from ``shuffle_rng``
        record-major (every epoch of record r before record r + 1, as the
        serial loop draws them), the padded windows last; ``orders`` (per
        record, per epoch, a permutation of its real windows) gives them
        instead.  A record whose window in a
        step is a padded one keeps its weights and optimizer state."""
        cfg = self.config
        if cfg.pseudo_label_retokenize:
            raise ValueError(
                "pseudo_label_retokenize (host callback per window) is not "
                "supported under --dp_records; run serially for exact mode")
        if cfg.print_pseudo_labels:
            raise ValueError(
                "print_pseudo_labels (per-chunk host debug print) is not "
                "supported under --dp_records; run serially to debug")
        spec_b, W, N, n_reals, starts, lengths, total_ds = self._records_plan(
            specs, seq_len, overlap)
        R = len(n_reals)
        if rngs is None:
            if isinstance(rng, torch.Generator):
                raise TypeError("one generator cannot seed R records; pass rngs=")
            rngs = [int(rng or 0) * 1_000_003 + r for r in range(R)]
        if len(rngs) != R:
            raise ValueError(f"{len(rngs)} rngs for {R} records")
        gens = [self._generator(g) for g in rngs]
        if cfg.shuffle and cfg.epochs > 0:
            if orders is None:
                shuffle_rng = shuffle_rng or np.random.default_rng(0)
                orders = [[shuffle_rng.permutation(n) for _ in range(cfg.epochs)]
                          for n in n_reals]
            orders = [[np.concatenate([np.asarray(o), np.arange(n, N)]) for o in per_epoch]
                      for per_epoch, n in zip(orders, n_reals)]

        t0 = time.perf_counter()
        self._load(params)
        spec_dev = torch.as_tensor(spec_b, device=self.device).to(self.transfer_dtype)
        stacked = {n: p.detach().unsqueeze(0).repeat(R, *([1] * p.dim()))
                   .requires_grad_(self._trainable_names[n])
                   for n, p in self._work.named_parameters()}
        max_tokens = max(8, int(self.out_len_fn(W) * self.max_label_frames_ratio))
        online_result = None

        if cfg.epochs > 0:
            opt = RecordsMADGRAD([p for p in stacked.values() if p.requires_grad], R,
                                 lr=self.lr, **self.opt_args)
            for epoch in range(cfg.epochs):
                order = (np.stack([o[epoch] for o in orders]) if cfg.shuffle
                         else np.broadcast_to(np.arange(N), (R, N)))
                if cfg.online:  # a fresh stitch per epoch; the last one wins
                    acc = torch.zeros(R, total_ds, self.n_classes, device=self.device)
                    counts = torch.zeros(R, total_ds, device=self.device)
                for step in range(N):
                    idx = order[:, step]
                    w_lens = lengths[np.arange(R), idx]
                    if not w_lens.any():  # a padded window of every record
                        continue
                    st = starts[np.arange(R), idx]
                    clean_lp = self._records_step(opt, stacked, spec_dev, st, w_lens, W,
                                                  max_tokens, gens)
                    if cfg.online:
                        for r in np.flatnonzero(w_lens):
                            self._accumulate(acc[r], counts[r], clean_lp[r], int(st[r]) // self.ds,
                                             self.out_len_fn(int(w_lens[r])))
                if cfg.online:
                    online_result = [self._finish(acc[r], counts[r]) for r in range(R)]

        if cfg.online and online_result is not None:
            results = online_result
        else:
            results = self._records_infer(stacked, spec_dev, W, n_reals, starts, lengths,
                                          total_ds)
        adapted = [None] * R
        if return_params:
            buffers = {n: b.detach().clone() for n, b in self._work.named_buffers()}
            adapted = [self._full_state({**{n: p[r] for n, p in stacked.items()}, **buffers})
                       for r in range(R)]
        _sync(self.device)
        elapsed = time.perf_counter() - t0
        return [EngineOutput(log_avg, counts, params, elapsed / R, self.blank_id)
                for (log_avg, counts), params in zip(results, adapted)]


def chunked_inference(
    model,
    params,
    spec: np.ndarray,
    seq_len: int,
    overlap: int,
    blank_id: int,
    subsampling_factor: int,
    infer_batch: int = 4,
    device: Optional[Union[str, torch.device]] = None,
) -> np.ndarray:
    """Windowed inference with no adaptation, returning the trimmed host
    log-prob matrix."""
    cfg = TTAConfig(seq_len=seq_len, overlap=overlap, epochs=0, shuffle=False)
    engine = DynamicEvalEngine(model, blank_id, subsampling_factor, cfg,
                               infer_batch=infer_batch, device=device)
    return engine(params, spec, seq_len, overlap).numpy_logits()
