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

Not ported (raise ``NotImplementedError``): a device mesh and the
records-batched ``batched()``.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from dynamic_asr_eval_tpu_torch.augment import apply_augmentation_pipeline
from dynamic_asr_eval_tpu_torch.config import TTAConfig
from dynamic_asr_eval_tpu_torch.device import resolve_device
from dynamic_asr_eval_tpu_torch.ops.beam_search import beam_search_device
from dynamic_asr_eval_tpu_torch.ops.chunk import chunk_starts_and_lengths, pad_num_chunks
from dynamic_asr_eval_tpu_torch.ops.ctc import ctc_loss, greedy_labels
from dynamic_asr_eval_tpu_torch.optim.madgrad import MADGRAD
from dynamic_asr_eval_tpu_torch.optim.masks import param_labels
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
    ``print_pseudo_labels`` text.  ``device`` defaults to ``cuda``."""

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
        if mesh is not None:
            raise NotImplementedError("a device mesh is not ported yet (ROADMAP queue 1)")
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
        opt_args = dict(config.optim_args)
        self.lr = opt_args.pop("lr", 9e-5)
        self.opt_args = opt_args
        self._work = copy.deepcopy(model).to(self.device)
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

    def _load(self, params: Optional[Dict[str, torch.Tensor]]) -> None:
        src = self.model.state_dict() if params is None else params
        self._work.load_state_dict(src, strict=True)
        for name, p in self._work.named_parameters():
            p.requires_grad_(self._trainable_names[name])

    def _generator(self, rng: Union[int, torch.Generator, None]) -> torch.Generator:
        if isinstance(rng, torch.Generator):
            return rng
        return torch.Generator(device=self.device).manual_seed(int(rng or 0))

    # -- host-side plan -----------------------------------------------------
    def _plan(self, spec: np.ndarray, seq_len: int, overlap: int):
        cfg = self.config
        seq_len = cfg.seq_len if seq_len == -1 else seq_len
        overlap = cfg.overlap if overlap == -1 else overlap
        spec = np.asarray(spec)
        if spec.ndim == 3:
            spec = spec[0]
        spec_n = spec.shape[-1]
        if seq_len > spec_n:
            seq_len, overlap = spec_n, 0
        if overlap % self.ds:
            raise ValueError(
                f"overlap ({overlap}) must be a multiple of the subsampling "
                f"factor ({self.ds})")
        if spec_n > seq_len and seq_len % self.ds:
            raise ValueError(
                f"seq_len ({seq_len}) must be a multiple of the subsampling "
                f"factor ({self.ds}) when the spectrogram spans multiple windows")
        starts, lengths = chunk_starts_and_lengths(spec_n, seq_len, overlap)
        n_real = len(starts)
        W = seq_len
        N = pad_num_chunks(n_real)
        starts_np = np.zeros((N,), np.int64)
        lengths_np = np.zeros((N,), np.int64)
        starts_np[:n_real] = starts
        lengths_np[:n_real] = lengths
        # T_pad and total_ds follow the window-count bucket, as in the JAX
        # package (there they key the compiled program)
        if n_real > 1:
            T_pad = (N - 1) * (W - overlap) + W
        else:
            T_pad = int(max(starts_np.max() + W, spec_n))
        spec_padded = np.zeros((spec.shape[0], T_pad), dtype=spec.dtype)
        spec_padded[:, :spec_n] = spec
        total_ds = _ds_ceil(T_pad, self.ds) + _ds_ceil(W, self.ds)
        return spec_padded, spec_n, W, N, n_real, starts_np, lengths_np, total_ds

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
        """Returns the detached clean log-probs [T_ds, V] and ds_len."""
        nn = self.num_negatives
        window = spec_dev[:, start : start + W].float()
        aug = self._augment(window[None].repeat(nn, 1, 1), gen, w_len)
        if self.config.entropy_augmentation:
            aug = (aug + self._entropy_delta(aug, w_len)).detach()
        batch = torch.cat([aug, window[None]], dim=0)  # [nn + 1, F, W]
        lengths = torch.full((nn + 1,), w_len, dtype=torch.int64, device=self.device)
        ds_len = self.out_len_fn(w_len)

        out = self._work(batch, lengths)
        lp = out["final_posteriors"]
        clean_lp = lp[-1].detach()
        labels, lab_len = self._pseudo_labels(clean_lp, ds_len, max_tokens)
        loss = ctc_loss(
            lp[:nn],
            torch.full((nn,), ds_len, dtype=torch.int64, device=self.device),
            labels[None].repeat(nn, 1),
            lab_len.expand(nn),
            blank_id=self.blank_id,
        ) / (max(ds_len, 1) * nn)
        if self.config.print_pseudo_labels:
            noisy, noisy_len = greedy_labels(lp[0].detach(), ds_len, self.blank_id, max_tokens)
            self._print_pseudo_labels(labels, lab_len, noisy, noisy_len)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return clean_lp, ds_len

    # -- inference (no-grad chunked forward + stitch) -----------------------
    @torch.no_grad()
    def _infer(self, spec_dev, W, n_real, starts_np, lengths_np, total_ds):
        V = self.n_classes
        acc = torch.zeros(total_ds, V, dtype=torch.float32, device=self.device)
        counts = torch.zeros(total_ds, dtype=torch.float32, device=self.device)
        for b0 in range(0, n_real, self.infer_batch):
            idx = range(b0, min(b0 + self.infer_batch, n_real))
            w = torch.stack([spec_dev[:, int(starts_np[i]) : int(starts_np[i]) + W]
                             for i in idx]).float()
            lens = torch.as_tensor([int(lengths_np[i]) for i in idx], device=self.device)
            lp = self._work(w, lens)["final_posteriors"]
            for j, i in enumerate(idx):
                self._accumulate(acc, counts, lp[j], int(starts_np[i]) // self.ds,
                                 self.out_len_fn(int(lengths_np[i])))
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
        generator; ``shuffle_rng`` draws the offline window order."""
        cfg = self.config
        spec_padded, spec_n, W, N, n_real, starts_np, lengths_np, total_ds = self._plan(
            spec, seq_len, overlap)
        gen = self._generator(rng)
        shuffle_rng = shuffle_rng or np.random.default_rng(0)

        t0 = time.time()
        self._load(params)
        spec_dev = torch.as_tensor(spec_padded, device=self.device).to(self.transfer_dtype)
        max_tokens = max(8, int(self.out_len_fn(W) * self.max_label_frames_ratio))
        online_result = None

        if cfg.epochs > 0:
            trainable = [p for p in self._work.parameters() if p.requires_grad]
            opt = MADGRAD(trainable, lr=self.lr, **self.opt_args)
            for _ in range(cfg.epochs):
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
                    clean_lp, ds_len = self._adapt_step(
                        opt, spec_dev, int(starts_np[i]), w_len, W, max_tokens, gen)
                    if cfg.online:
                        self._accumulate(acc, counts, clean_lp,
                                         int(starts_np[i]) // self.ds, ds_len)
                if cfg.online:
                    online_result = self._finish(acc, counts)

        adapted = None
        if return_params or adapt_only:
            adapted = {k: v.detach().clone() for k, v in self._work.state_dict().items()}
        if adapt_only:
            _sync(self.device)
            return EngineOutput(None, None, adapted, time.time() - t0, self.blank_id)

        if cfg.online and online_result is not None:
            log_avg, counts = online_result
        else:
            log_avg, counts = self._infer(spec_dev, W, n_real, starts_np, lengths_np, total_ds)
        _sync(self.device)
        elapsed = time.time() - t0
        if cfg.print_runtimes:
            print(f"Spectrogram length: {spec_n}")
            print(f"Runtime: {elapsed}")
        return EngineOutput(log_avg, counts, adapted, elapsed, self.blank_id)

    def batched(self, *args, **kwargs):
        if self.config.pseudo_label_retokenize:
            raise ValueError(
                "pseudo_label_retokenize (host callback per window) is not "
                "supported under --dp_records; run serially for exact mode")
        if self.config.print_pseudo_labels:
            raise ValueError(
                "print_pseudo_labels (per-chunk host debug print) is not "
                "supported under --dp_records; run serially to debug")
        raise NotImplementedError(
            "records-batched adaptation (--dp_records) is not ported yet (ROADMAP queue 1)")


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
