"""AWMC: anchor-leader EMA test-time adaptation.

Counterpart of the JAX package's ``tta/awmc.py`` (``AWMCEngine``), step for
step.  Per window, in plan order (padded windows of the bucket skipped):

1. the anchor's greedy labels, once: a no-grad forward of the clean window
   with the pristine weights;
2. each epoch (``max(epochs, 1)`` of them):
   - the leader's greedy labels from a no-grad forward of the clean window;
   - one augmentation of the window (batch 1);
   - the student's forward on it; CTC of its log-probs, repeated twice,
     against the two label banks, an empty bank weighted 0, divided by
     ``max(ds_len, 1) · 2``; backward; one MADGRAD step;
   - the leader's EMA update with decay ``min(ema_decay, (1+n)/(10+n))``,
     ``n`` counting every update of the recording from 1 (torch_ema's
     ``use_num_updates``; flat ``ema_decay`` when
     ``ema_use_num_updates`` is off);
3. a no-grad forward of the clean window with the student's weights,
   stitched into the overlap average (always online).

The optimizer is created once per recording and trains every parameter:
the JAX engine applies no freeze mask in AWMC, and neither does the port.
The anchor, the leader and the student are three working copies of the
model on the device; the caller's weights are never modified.
``return_params`` returns the student's weights.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from dynamic_asr_eval_tpu_torch.ops.ctc import ctc_loss, greedy_labels
from dynamic_asr_eval_tpu_torch.optim.ema import EmaState, ema_update
from dynamic_asr_eval_tpu_torch.optim.madgrad import MADGRAD
from dynamic_asr_eval_tpu_torch.tta.runner import DynamicEvalEngine, EngineOutput, _sync


class AWMCEngine(DynamicEvalEngine):
    """The NSTI engine's plan, augmentation and stitching, with the
    anchor/leader/student adaptation step."""

    def __init__(self, model: torch.nn.Module, *args, **kwargs):
        super().__init__(model, *args, **kwargs)
        self._anchor = copy.deepcopy(self._work).requires_grad_(False)
        self._leader = copy.deepcopy(self._work).requires_grad_(False)

    @torch.no_grad()
    def _greedy(self, model, window, lengths, ds_len: int, max_tokens: int):
        lp = model(window, lengths)["final_posteriors"][0]
        return greedy_labels(lp, ds_len, self.blank_id, max_tokens)

    def _student_step(self, opt, aug, lengths, ds_len: int, banks) -> None:
        labels = torch.stack([b[0] for b in banks])
        lens = torch.stack([b[1] for b in banks])
        lp = self._work(aug, lengths)["final_posteriors"]  # [1, T_ds, V]
        loss = ctc_loss(
            lp.repeat(2, 1, 1),
            torch.full((2,), ds_len, dtype=torch.int64, device=self.device),
            labels, lens, blank_id=self.blank_id,
            sample_weights=(lens > 0).float(),  # an empty bank does not train
        ) / (max(ds_len, 1) * 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()

    def _decay(self, n_updates: np.float32) -> float:
        """The leader's decay for its ``n_updates``-th update, in f32."""
        ema_d = np.float32(self.config.ema_decay)
        if not self.config.ema_use_num_updates:
            return float(ema_d)
        one, ten = np.float32(1.0), np.float32(10.0)
        return float(min(ema_d, (one + n_updates) / (ten + n_updates)))

    def __call__(
        self,
        params: Optional[Dict[str, torch.Tensor]],
        spec: np.ndarray,
        seq_len: int = -1,
        overlap: int = -1,
        return_params: bool = False,
        rng: Union[int, torch.Generator, None] = None,
        **_,
    ) -> EngineOutput:
        cfg = self.config
        spec_padded, spec_n, W, N, _n_real, starts_np, lengths_np, total_ds = self._plan(
            spec, seq_len, overlap)
        gen = self._generator(rng)
        epochs = max(cfg.epochs, 1)

        t0 = time.time()
        src = self.model.state_dict() if params is None else params
        src = self._local_state(src)
        for m in (self._work, self._anchor, self._leader):
            m.load_state_dict(src, strict=True)
        student = dict(self._work.named_parameters())
        for p in student.values():
            p.requires_grad_(True)
        leader = EmaState(dict(self._leader.named_parameters()), cfg.ema_decay)
        opt = MADGRAD(list(student.values()), lr=self.lr, **self.opt_args)
        n_updates = np.float32(1.0)  # torch_ema's construction-time update
        spec_dev = torch.as_tensor(spec_padded, device=self.device).to(self.transfer_dtype)
        max_tokens = max(8, int(self.out_len_fn(W) * self.max_label_frames_ratio))
        acc = torch.zeros(total_ds, self.n_classes, device=self.device)
        counts = torch.zeros(total_ds, device=self.device)

        for i in range(N):
            w_len = int(lengths_np[i])
            if w_len == 0:  # padded window of the bucket
                continue
            start = int(starts_np[i])
            window = spec_dev[:, start : start + W].float()[None]
            lengths = torch.full((1,), w_len, dtype=torch.int64, device=self.device)
            ds_len = self.out_len_fn(w_len)
            anchor_bank = self._greedy(self._anchor, window, lengths, ds_len, max_tokens)
            for _ in range(epochs):
                leader_bank = self._greedy(self._leader, window, lengths, ds_len, max_tokens)
                aug = self._augment(window, gen, w_len)
                self._student_step(opt, aug, lengths, ds_len, (anchor_bank, leader_bank))
                n_updates = n_updates + np.float32(1.0)
                ema_update(leader, student, decay=self._decay(n_updates))
            with torch.no_grad():
                clean = self._work(window, lengths)["final_posteriors"][0]
            self._accumulate(acc, counts, clean, start // self.ds, ds_len)

        log_avg, counts = self._finish(acc, counts)
        adapted = self._full_state(self._work.state_dict()) if return_params else None
        _sync(self.device)
        elapsed = time.time() - t0
        if cfg.print_runtimes:
            print(f"Spectrogram length: {spec_n}")
            print(f"Runtime: {elapsed}")
        return EngineOutput(log_avg, counts, adapted, elapsed, self.blank_id)
