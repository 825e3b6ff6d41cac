"""Offline noisy-student-teacher (NST) finetuning.

Counterpart of the JAX package's ``train/nst.py`` (the reference's
``earnings_finetune/train.py``):

- per recording: the spectrogram cut into training windows
  (:func:`..ops.chunk.chunk_spectrogram`, no bucket padding), the window
  order drawn from ``np.random.default_rng(step_count)``, batches of
  ``batch_size`` windows, the last one padded with zero-length rows;
- one step, eager PyTorch: the EMA teacher's forward under ``no_grad`` →
  greedy pseudo-labels (``max_tokens = max(8, T_ds // 4)``) → SpecAugment of
  the student's input from the trainer's ``torch.Generator`` → CTC loss
  divided by the padded ``B × T_ds`` → backward; then, if the loss is
  finite, the global-norm clip (optax's ``clip_by_global_norm`` rule: the
  gradients scale by ``max_norm / norm`` only when ``norm >= max_norm``),
  MADGRAD at this step's scheduled lr, and the EMA update.  A non-finite
  loss moves nothing (weights, MADGRAD's state and step count ``k``, EMA);
  ``step_count`` still advances, and ``nan_strikes`` of them in a row
  abort;
- the cosine lr read per step, the optional sequence warm-up per recording;
- :meth:`NSTTrainer.save` / :meth:`~NSTTrainer.resume`: the weights as a
  DAE1 file (:func:`..models.checkpoint.save_checkpoint`, which the JAX
  package's ``load_checkpoint`` reads), the rest in ``<ckpt>.train_state.pkl``
  under JAX's keys, holding the port's tensors;
- :class:`EvalRunner`: dev WER of the EMA weights through the port's
  :class:`..tta.DynamicEvalEngine` with ``epochs=0``.

The teacher is a second copy of the model whose parameters are the EMA; the
student is the model handed in.  Both run on ``device`` (default ``cuda``).
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dynamic_asr_eval_tpu_torch.augment.spec_augment import spec_augment
from dynamic_asr_eval_tpu_torch.config import SpecAugmentConfig
from dynamic_asr_eval_tpu_torch.device import resolve_device
from dynamic_asr_eval_tpu_torch.models.checkpoint import save_checkpoint
from dynamic_asr_eval_tpu_torch.ops.chunk import chunk_spectrogram
from dynamic_asr_eval_tpu_torch.ops.ctc import ctc_loss, greedy_labels
from dynamic_asr_eval_tpu_torch.optim.ema import EmaState, ema_update
from dynamic_asr_eval_tpu_torch.optim.madgrad import MADGRAD
from dynamic_asr_eval_tpu_torch.train.data import SimpleDataset, VariableBatchLoader
from dynamic_asr_eval_tpu_torch.train.schedule import CosineSchedule, SequenceWarmupManager


@dataclasses.dataclass
class TrainConfig:
    peak_lr: float = 1e-5
    warmup_steps: int = 1
    total_steps: int = 10_000
    ema_decay: float = 0.8
    clip_value: float = 0.8
    batch_size: int = 4
    seq_len: int = 16384
    overlap: int = 0
    max_epochs: int = 1
    nan_strikes: int = 100
    checkpoint_dir: str = "checkpoints"
    save_every_recordings: int = 50
    spec_augment: SpecAugmentConfig = dataclasses.field(
        default_factory=lambda: SpecAugmentConfig(n_freq_masks=6, freq_mask_param=34))
    use_sequence_warmup: bool = False
    seed: int = 8241


def greedy_label_batch(log_probs: torch.Tensor, lengths: torch.Tensor, blank_id: int,
                       max_tokens: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`..ops.ctc.greedy_labels` of each row of ``log_probs [B, T, V]``:
    ``(labels [B, max_tokens], lengths [B])``."""
    rows = [greedy_labels(log_probs[b], lengths[b], blank_id, max_tokens)
            for b in range(log_probs.shape[0])]
    return torch.stack([r[0] for r in rows]), torch.stack([r[1] for r in rows])


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: every gradient becomes
    ``g / norm * max_norm`` when the global norm is at least ``max_norm``,
    else stays as it is.  Returns the norm (0-d, no host sync)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class NSTTrainer:
    """``model`` is the student (an ``SCConformer``), ``params`` a state dict
    to start from (``None``: the model's own weights).  ``eval_fn(state
    dict) -> dev WER`` runs on the EMA weights at the end of each epoch."""

    def __init__(
        self,
        model: torch.nn.Module,
        params: Optional[Dict[str, torch.Tensor]],
        model_config,
        config: TrainConfig,
        eval_fn: Optional[Callable] = None,
        log_fn: Optional[Callable[[Dict], None]] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.device = resolve_device(device)
        self.model_config = model_config
        self.cfg = config
        self.eval_fn = eval_fn
        self.log_fn = log_fn or self._default_log
        self.schedule = CosineSchedule(config.peak_lr, config.warmup_steps, config.total_steps)
        self.seq_warmup = (
            SequenceWarmupManager(max_seq_len=config.seq_len,
                                  initial_batch_size=config.batch_size)
            if config.use_sequence_warmup else None)
        self.model = model.to(self.device)
        if params is not None:
            self.model.load_state_dict(params, strict=True)
        self.teacher = copy.deepcopy(self.model)
        for p in self.teacher.parameters():
            p.requires_grad_(False)
        self.named_params = dict(self.model.named_parameters())
        for p in self.named_params.values():
            p.requires_grad_(True)
        self.ema = EmaState(dict(self.teacher.named_parameters()), config.ema_decay)
        self.optimizer = MADGRAD(list(self.named_params.values()), lr=config.peak_lr)
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self.step_count = 0
        self.recordings_seen = 0
        self.nan_count = 0

    @staticmethod
    def _default_log(data: Dict):
        try:
            import wandb

            if wandb.run is not None:
                wandb.log(data)
                return
        except ImportError:
            pass
        print({k: (round(v, 5) if isinstance(v, float) else v) for k, v in data.items()})

    # -- one NST step --------------------------------------------------------
    def loss_and_grads(self, batch: torch.Tensor, lengths: torch.Tensor):
        """The NST loss of one padded batch ``[B, F, W]`` (a 0-d tensor) and
        the student's weight gradients, in ``named_params`` order; nothing
        is updated."""
        blank = self.model_config.blank_id
        T_ds = -(-batch.shape[-1] // self.model_config.subsampling_factor)
        with torch.no_grad():
            t_out = self.teacher(batch, lengths)
            labels, lab_lens = greedy_label_batch(t_out["final_posteriors"], t_out["length"],
                                                  blank, max(8, T_ds // 4))
        student_in = spec_augment(batch, self.generator, self.cfg.spec_augment)
        out = self.model(student_in, lengths)
        lp = out["final_posteriors"]
        loss = ctc_loss(lp, out["length"], labels, lab_lens, blank_id=blank) / (
            lp.shape[0] * lp.shape[1])
        params = list(self.named_params.values())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params, grads)]

    @torch.no_grad()
    def apply_gradients(self, grads: List[torch.Tensor], lr: float) -> None:
        """The clip, MADGRAD at ``lr`` (read in f32, as JAX injects it), then
        the EMA."""
        clip_by_global_norm_(grads, self.cfg.clip_value)
        for group in self.optimizer.param_groups:
            group["lr"] = float(np.float32(lr))
        for p, g in zip(self.named_params.values(), grads):
            p.grad = g
        self.optimizer.step()
        for p in self.named_params.values():
            p.grad = None
        ema_update(self.ema, self.named_params)

    # -- loops ---------------------------------------------------------------
    def train_recording(self, spec: np.ndarray) -> List[float]:
        cfg = self.cfg
        seq_len = self.seq_warmup.current_seq_len if self.seq_warmup else cfg.seq_len
        batch_size = self.seq_warmup.current_batch_size if self.seq_warmup else cfg.batch_size
        spec = np.asarray(spec)
        if spec.ndim == 3:
            spec = spec[0]
        windows, lengths, _, n_real = chunk_spectrogram(spec, seq_len, cfg.overlap,
                                                        pad_to_bucket=False)
        order = np.random.default_rng(self.step_count).permutation(n_real)
        losses = []
        for i in range(0, n_real, batch_size):
            idx = order[i : i + batch_size]
            batch = np.zeros((batch_size,) + windows.shape[1:], np.float32)
            blens = np.zeros((batch_size,), np.int64)
            batch[: len(idx)] = windows[idx]
            blens[: len(idx)] = lengths[idx]
            lr = self.schedule(self.step_count)
            loss, grads = self.loss_and_grads(torch.from_numpy(batch).to(self.device),
                                              torch.from_numpy(blens).to(self.device))
            loss_f = float(loss)
            if not math.isfinite(loss_f):
                self.nan_count += 1
                print(f"NaN/inf loss skipped ({self.nan_count}/{cfg.nan_strikes})")
                if self.nan_count >= cfg.nan_strikes:
                    raise RuntimeError(
                        f"{cfg.nan_strikes} consecutive non-finite losses — aborting")
            else:
                self.apply_gradients(grads, lr)
                self.nan_count = 0
                losses.append(loss_f)
            self.step_count += 1
        return losses

    def train(self, dataset: SimpleDataset, process_fn):
        cfg = self.cfg
        for epoch in range(cfg.max_epochs):
            loader = VariableBatchLoader(dataset, 1, process_fn, epoch=epoch)
            for item in loader:
                spec = item["spectrograms"][0]
                try:
                    losses = self.train_recording(spec)
                except RuntimeError:
                    raise
                except Exception as e:  # a bad recording is skipped, as in JAX
                    print(f"skipping recording after error: {e}")
                    continue
                self.recordings_seen += 1
                if self.seq_warmup:
                    changed, new_len, new_bs = self.seq_warmup.step()
                    if changed:
                        print(f"sequence warmup: seq_len={new_len} batch={new_bs} "
                              f"rotary_interp={self.seq_warmup.rotary_interpolation_factor:.2f}")
                self.log_fn({
                    "epoch": epoch,
                    "recording": self.recordings_seen,
                    "loss": float(np.mean(losses)) if losses else float("nan"),
                    "lr": self.schedule(self.step_count),
                    "step": self.step_count,
                })
                if self.recordings_seen % cfg.save_every_recordings == 0:
                    self.save(os.path.join(cfg.checkpoint_dir, "latest.ckpt"), dataset)
            dataset.reset_seen_ids()
            if self.eval_fn is not None:
                self.log_fn({"epoch": epoch, "dev_wer": self.eval_fn(self.teacher.state_dict())})
            self.save(os.path.join(cfg.checkpoint_dir, f"epoch_{epoch}.ckpt"), dataset)

    # -- checkpointing -------------------------------------------------------
    def _opt_state(self) -> Dict:
        state = {"count": self.optimizer.count}
        for key in ("grad_sum", "grad_sum_sq", "x0"):
            state[key] = {n: self.optimizer.state[p][key].detach().cpu().clone()
                          for n, p in self.named_params.items()}
        return state

    def save(self, path: str, dataset: Optional[SimpleDataset] = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        save_checkpoint(path, self.model.state_dict(), self.model_config)
        side = {
            "ema_params": {n: t.detach().cpu().clone() for n, t in self.ema.params.items()},
            "opt_state": self._opt_state(),
            "step_count": self.step_count,
            "recordings_seen": self.recordings_seen,
            "seen_ids": sorted(dataset.seen_ids) if dataset else [],
            "seq_warmup": self.seq_warmup.state_dict() if self.seq_warmup else None,
        }
        with open(path + ".train_state.pkl", "wb") as f:
            pickle.dump(side, f)

    @torch.no_grad()
    def resume(self, path: str, dataset: Optional[SimpleDataset] = None):
        from dynamic_asr_eval_tpu_torch.models.checkpoint import load_checkpoint

        _, params, _ = load_checkpoint(path)
        self.model.load_state_dict(params, strict=True)
        # the teacher's buffers (batch-renorm statistics) from the checkpoint,
        # as JAX's ``extra_vars``; its parameters are the EMA below
        self.teacher.load_state_dict(params, strict=True)
        with open(path + ".train_state.pkl", "rb") as f:
            side = pickle.load(f)
        for n, t in self.ema.params.items():
            t.copy_(side["ema_params"][n])
        opt = side["opt_state"]
        self.optimizer.count = opt["count"]
        for n, p in self.named_params.items():
            for key in ("grad_sum", "grad_sum_sq", "x0"):
                self.optimizer.state[p][key].copy_(opt[key][n])
        self.step_count = side["step_count"]
        self.recordings_seen = side["recordings_seen"]
        if dataset is not None:
            dataset.seen_ids = set(side["seen_ids"])
        if side.get("seq_warmup") and self.seq_warmup:
            self.seq_warmup = SequenceWarmupManager.from_state_dict(side["seq_warmup"])


class EvalRunner:
    """In-training dev evaluation: windowed inference over dev records with
    the given weights → corpus WER.  Each record carries ``process_fn(rec)
    -> (spec, gold text)``."""

    def __init__(self, model, model_config, records: Sequence[Dict], tokenizer,
                 seq_len: int = 16384, overlap: int = 14336,
                 device: Optional[Union[str, torch.device]] = None):
        self.model = model
        self.model_config = model_config
        self.records = list(records)
        self.tokenizer = tokenizer
        self.seq_len = seq_len
        self.overlap = overlap
        self.device = resolve_device(device)

    def __call__(self, params) -> float:
        from dynamic_asr_eval_tpu_torch.config import TTAConfig
        from dynamic_asr_eval_tpu_torch.evals.common import decode_output
        from dynamic_asr_eval_tpu_torch.text import normalize, word_error_rate_detail
        from dynamic_asr_eval_tpu_torch.tta import DynamicEvalEngine

        cfg = self.model_config
        engine = DynamicEvalEngine(
            self.model, cfg.blank_id, cfg.subsampling_factor,
            TTAConfig(seq_len=self.seq_len, overlap=self.overlap, epochs=0, shuffle=False),
            device=self.device)
        hyps, refs = [], []
        for rec in self.records:
            spec, gold = rec["process_fn"](rec)
            out = engine(params, spec, self.seq_len, self.overlap)
            hyps.append(normalize(decode_output(out, self.tokenizer)))
            refs.append(gold)
        return word_error_rate_detail(hyps, refs)[0]
