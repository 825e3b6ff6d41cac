"""Utterance-level TTA with gradient accumulation.

Counterpart of the JAX package's ``tta/utterance.py``
(``UtteranceTTAEngine``): loop the utterances, forward the batch
``[augmented × num_negatives, clean]`` at the utterance's power-of-two
bucket (:func:`_bucket`), pseudo-label the detached clean stream (greedy, or
``pseudo_label_fn``'s labels), CTC on the augmented copies, gradients summed
over ``accumulate_gradients`` utterances, divided by their count, clipped by
global norm (``clip_norm``) and applied by one MADGRAD step.

- ``loss_norm="frames"``: the summed CTC loss over ``max(ds_len, 1) ·
  num_negatives``; ``"ctc_mean"``: each copy's loss over its label length
  (clamped at 1), averaged over the copies (torch ``CTCLoss(reduction=
  'mean')``).
- ``soft_dtw_weight > 0`` adds ``weight · mean(soft_dtw(D)) / W_ds``, D the
  pairwise squared distances [num_negatives, W_ds, W_ds] between the
  augmented and the clean posteriors over the whole padded window (W_ds the
  bucket's downsampled length).  It runs through
  :func:`..kernels.softdtw.soft_dtw` with ``use_pallas=True``: the R kernel
  forward and the E kernel backward on a CUDA tensor, the plain versions on
  the CPU.  D is f32 (the model's log-softmax is f32).
- ``prob_collection="online"`` keeps each utterance's clean log-probs from
  the forward of its visit (the last epoch's win); ``"final"``, and
  ``epochs=0``, run a final pass with the adapted weights.
- ``augment_fn(batch [nn, F, W], generator, length) -> [nn, F, W]``; without
  it the augmented copies are the clean utterance, as in JAX.
- ``pseudo_label_fn(params=<state dict of the current weights>,
  utterance=<padded [F, W] array>, length=<int>) -> label ids`` overrides
  the greedy labels (cut at the label budget).

The optimizer is MADGRAD from ``config.optim_args`` (lr default 9e-5), the
JAX engine's default; every parameter trains.  The caller's weights are not
modified.  Runs on ``cuda`` unless ``device`` says otherwise.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dynamic_asr_eval_tpu_torch.config import TTAConfig
from dynamic_asr_eval_tpu_torch.device import resolve_device
from dynamic_asr_eval_tpu_torch.kernels import softdtw
from dynamic_asr_eval_tpu_torch.ops.ctc import ctc_loss, greedy_labels
from dynamic_asr_eval_tpu_torch.optim.madgrad import MADGRAD


def _bucket(n: int, minimum: int = 256) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _as_2d(utterance) -> np.ndarray:
    """An utterance's ``spectrogram`` as [F, T] (``[1, F, T]`` and a [T]
    waveform accepted)."""
    utt = np.asarray(utterance)
    if utt.ndim == 3:
        utt = utt[0]
    if utt.ndim == 1:
        utt = utt[None]
    return utt


def _padded(utterance) -> Tuple[np.ndarray, int]:
    """(the utterance zero-padded to its bucket [F, W], its length T)."""
    utt = _as_2d(utterance)
    F, T = utt.shape
    padded = np.zeros((F, _bucket(T)), utt.dtype)
    padded[:, :T] = utt
    return padded, T


class UtteranceTTAEngine:
    def __init__(
        self,
        model: torch.nn.Module,
        blank_id: int,
        subsampling_factor: int,
        config: TTAConfig,
        augment_fn: Optional[Callable] = None,
        num_negatives: int = 1,
        accumulate_gradients: int = 1,
        max_label_frames_ratio: float = 1.0,
        soft_dtw_weight: float = 0.0,
        soft_dtw_gamma: float = 1.0,
        pseudo_label_fn: Optional[Callable] = None,
        clip_norm: Optional[float] = None,  # the reference's per-utterance loop clips at 10
        prob_collection: str = "online",  # "online" | "final"
        loss_norm: str = "frames",  # "frames" | "ctc_mean"
        device: Optional[Union[str, torch.device]] = None,
    ):
        if prob_collection not in ("online", "final"):
            raise ValueError(f"prob_collection: {prob_collection!r}")
        if loss_norm not in ("frames", "ctc_mean"):
            raise ValueError(f"loss_norm: {loss_norm!r}")
        self.device = resolve_device(device)
        self.model = model
        self.blank_id = blank_id
        self.ds = subsampling_factor
        self.config = config
        self.augment_fn = augment_fn
        self.num_negatives = num_negatives
        self.accumulate_gradients = max(accumulate_gradients, 1)
        self.max_label_frames_ratio = max_label_frames_ratio
        self.soft_dtw_weight = soft_dtw_weight
        self.soft_dtw_gamma = soft_dtw_gamma
        self.pseudo_label_fn = pseudo_label_fn
        self.clip_norm = clip_norm
        self.prob_collection = prob_collection
        self.loss_norm = loss_norm
        opt_args = dict(config.optim_args)
        self.lr = opt_args.pop("lr", 9e-5)
        self.opt_args = opt_args
        self._work = copy.deepcopy(model).to(self.device)

    def _load(self, params: Optional[Dict[str, torch.Tensor]]) -> None:
        src = self.model.state_dict() if params is None else params
        self._work.load_state_dict(src, strict=True)
        for p in self._work.parameters():
            p.requires_grad_(True)

    def _generator(self, rng: Union[int, torch.Generator, None]) -> torch.Generator:
        if isinstance(rng, torch.Generator):
            return rng
        return torch.Generator(device=self.device).manual_seed(int(rng or 0))

    def _max_tokens(self, W: int) -> int:
        return max(8, int(-(-W // self.ds) * self.max_label_frames_ratio))

    def _external_labels(self, padded: np.ndarray, T: int, max_tokens: int):
        """``pseudo_label_fn``'s labels cut to ``max_tokens``: (labels
        [max_tokens], length), or None without it."""
        if self.pseudo_label_fn is None:
            return None
        params = {k: v.detach() for k, v in self._work.state_dict().items()}
        ids = list(self.pseudo_label_fn(params=params, utterance=padded, length=T))[:max_tokens]
        ext = torch.zeros(max_tokens, dtype=torch.int32)
        ext[: len(ids)] = torch.as_tensor(ids, dtype=torch.int32)
        return ext.to(self.device), torch.tensor(len(ids), dtype=torch.int32, device=self.device)

    def _loss(self, utt: torch.Tensor, T: int, gen: torch.Generator, ext):
        """One utterance's loss (backward not taken) → (loss, detached clean
        log-probs [W_ds, V], ds_len as a 0-d device tensor)."""
        nn_neg = self.num_negatives
        W = utt.shape[-1]
        aug = utt[None].repeat(nn_neg, 1, 1)
        if self.augment_fn is not None:
            aug = self.augment_fn(aug, gen, T)
        batch = torch.cat([aug, utt[None]], dim=0)
        lengths = torch.full((nn_neg + 1,), T, dtype=torch.int64, device=self.device)
        out = self._work(batch, lengths)
        lp = out["final_posteriors"]
        ds_len = out["length"][0]
        clean_lp = lp[-1].detach()
        max_tokens = self._max_tokens(W)
        if ext is None:
            labels, lab_len = greedy_labels(clean_lp, ds_len, self.blank_id, max_tokens)
        else:
            labels, lab_len = ext
        in_lens = ds_len.expand(nn_neg)
        lab = labels[None].repeat(nn_neg, 1)
        lab_lens = lab_len.expand(nn_neg)
        if self.loss_norm == "ctc_mean":
            w = 1.0 / torch.clamp(lab_len, min=1).float()
            loss = ctc_loss(lp[:nn_neg], in_lens, lab, lab_lens, blank_id=self.blank_id,
                            sample_weights=w.expand(nn_neg)) / nn_neg
        else:
            loss = ctc_loss(lp[:nn_neg], in_lens, lab, lab_lens, blank_id=self.blank_id) / (
                torch.clamp(ds_len, min=1) * nn_neg)
        if self.soft_dtw_weight > 0:
            # soft-DTW between the augmented and the clean posterior sequences
            D = softdtw.pairwise_sq_dist(torch.exp(lp[:nn_neg]), torch.exp(clean_lp)[None])
            loss = loss + self.soft_dtw_weight * torch.mean(
                softdtw.soft_dtw(D, self.soft_dtw_gamma, 0, use_pallas=True)) / lp.shape[1]
        return loss, clean_lp, ds_len

    def _apply(self, opt: MADGRAD, n_acc: int) -> None:
        """The accumulated gradients over ``n_acc``, clipped by global norm,
        then one MADGRAD step; the gradients are cleared."""
        grads = [p.grad for p in self._work.parameters() if p.grad is not None]
        for g in grads:
            g.div_(max(n_acc, 1))
        if self.clip_norm is not None:
            gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        opt.step()
        opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def _infer(self, padded: np.ndarray, T: int) -> np.ndarray:
        utt = torch.as_tensor(padded, device=self.device).float()
        out = self._work(utt[None], torch.tensor([T], dtype=torch.int64, device=self.device))
        lp, ds_len = out["final_posteriors"][0], out["length"][0]
        return lp.cpu().numpy()[: int(ds_len)]

    def __call__(
        self,
        params: Optional[Dict[str, torch.Tensor]],
        utterances: Sequence[Dict],  # dicts with 'spectrogram' [F, T] (F = 1 for waveforms)
        rng: Union[int, torch.Generator, None] = None,
        return_params: bool = False,
    ) -> Tuple[List[np.ndarray], Optional[Dict[str, torch.Tensor]], float]:
        """Adapt over the utterances from ``params`` (a state dict; ``None``:
        the engine's own model's weights; not modified) → (per-utterance
        log-prob matrices [ds_len, V], the adapted state dict when
        ``return_params``, elapsed seconds).  ``rng`` seeds the augmentation
        generator."""
        cfg = self.config
        self._load(params)
        gen = self._generator(rng)
        opt = MADGRAD(list(self._work.parameters()), lr=self.lr, **self.opt_args)
        opt.zero_grad(set_to_none=True)

        t0 = time.time()
        online_probs: Dict[int, np.ndarray] = {}
        for epoch in range(max(cfg.epochs, 0)):
            n_acc = 0
            order = np.random.default_rng(epoch).permutation(len(utterances)) \
                if cfg.shuffle else np.arange(len(utterances))
            for idx in order:
                padded, T = _padded(utterances[idx]["spectrogram"])
                ext = self._external_labels(padded, T, self._max_tokens(padded.shape[-1]))
                utt = torch.as_tensor(padded, device=self.device).float()
                loss, clean_lp, ds_len = self._loss(utt, T, gen, ext)
                loss.backward()
                if self.prob_collection == "online":
                    online_probs[int(idx)] = clean_lp.cpu().numpy()[: int(ds_len)]
                n_acc += 1
                if n_acc >= self.accumulate_gradients:
                    self._apply(opt, n_acc)
                    n_acc = 0
            if n_acc > 0:
                self._apply(opt, n_acc)

        if self.prob_collection == "online" and len(online_probs) == len(utterances):
            # all collected in the loop; epochs=0 falls through to the final pass
            outputs = [online_probs[i] for i in range(len(utterances))]
        else:
            outputs = [self._infer(*_padded(u["spectrogram"])) for u in utterances]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.time() - t0
        adapted = None
        if return_params:
            adapted = {k: v.detach().clone() for k, v in self._work.state_dict().items()}
        return outputs, adapted, elapsed
