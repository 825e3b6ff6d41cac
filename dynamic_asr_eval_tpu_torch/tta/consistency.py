"""Consistency TTA: per-chunk parameter copies with distance-decayed gradient
sharing.

Counterpart of the JAX package's ``tta/consistency.py``
(``sequential_mix_matrix``, ``ConsistencyEngine``), step for step:

- every real chunk (window) owns a copy of the model's parameters and an
  :class:`..optim.adafactor.Adafactor` over it (``optax.adafactor`` with its
  defaults in JAX, learning rate ``optim_lr``);
- each of ``max(epochs, 1)`` epochs computes every chunk's NSTI gradient
  with its own parameters (augmented copies plus the clean window in one
  batch, greedy pseudo-labels from the detached clean log-probs, CTC on the
  augmented copies divided by ``max(ds_len, 1) · num_negatives``), without
  applying it; then the gradients are mixed across chunks by the matrix of
  :func:`sequential_mix_matrix` (one product per parameter tensor, in f32
  with TF32 off) and every chunk's optimizer steps;
- online mode stitches the last epoch's clean log-probs; offline mode
  re-infers each chunk with its own adapted parameters;
- ``return_params`` gives one state dict per real chunk.

Every parameter adapts: the JAX engine applies no freeze policy here.  The
JAX engine holds copies for the padding chunks of the window-count bucket
too (identity rows of the mixing matrix, zero gradients, length 0, so they
never move and never reach the stitch); the port holds copies for the real
chunks only, and the stitched output is the same.  The chunks run one after
another through the model with :func:`torch.func.functional_call` on their
own parameters (not ``vmap``: the kernels' autograd functions have no vmap
rule).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch
from torch.func import functional_call

from dynamic_asr_eval_tpu_torch.ops.ctc import ctc_loss, greedy_labels
from dynamic_asr_eval_tpu_torch.optim.adafactor import Adafactor
from dynamic_asr_eval_tpu_torch.tta.runner import DynamicEvalEngine, EngineOutput, _sync


def sequential_mix_matrix(chunk_mask: torch.Tensor, decay: float) -> torch.Tensor:
    """The reference's in-place gradient-sharing loop as one matrix ``L``
    (f32, on the CPU), mixed gradients ``L @ G``.  The loop walks real
    chunks in order and overwrites each chunk's gradient before later chunks
    read it:

        g_i ← (g_i + Σ_{q<i} d_iq ĝ_q + Σ_{q>i} d_iq g_q) / s_i,
        d_iq = decay^|i-q|,  s_i = 1 + Σ_{q≠i} d_iq,

    ``ĝ_q`` the rows already overwritten; built by forward substitution.
    Masked (padding) chunks get identity rows and enter no sum."""
    m = torch.as_tensor(chunk_mask, dtype=torch.float32).cpu()
    N = m.shape[0]
    pos = torch.arange(N)
    dist = (pos[:, None] - pos[None, :]).abs().to(torch.float32)
    D = torch.tensor(decay, dtype=torch.float32) ** dist
    D = D * m[None, :] * m[:, None]
    D = D - torch.diag(torch.diag(D))  # off-diagonal decay weights only
    s = 1.0 + D.sum(dim=1)
    eye = torch.eye(N, dtype=torch.float32)
    L = eye.clone()
    for i in range(N):
        below = (pos < i).to(torch.float32)
        # q < i contribute their mixed rows L[q], q > i their raw e_q
        row = (eye[i] + (D[i] * below) @ L + D[i] * (1.0 - below)) / s[i]
        L[i] = row if m[i] > 0 else eye[i]
    return L


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class ConsistencyEngine(DynamicEvalEngine):
    """The NSTI engine's plan, augmentation and stitching with per-chunk
    parameters, Adafactor and mixed gradients."""

    decay_per_distance: float = 0.95

    def _chunk_grad(self, params: Dict[str, torch.Tensor], window: torch.Tensor, w_len: int,
                    max_tokens: int, gen: torch.Generator):
        """One chunk's pseudo-label CTC gradient with its own parameters:
        (gradients in ``params``' order, clean log-probs [T_ds, V], ds_len)."""
        nn = self.num_negatives
        aug = self._augment(window[None].repeat(nn, 1, 1), gen, w_len)
        batch = torch.cat([aug, window[None]], dim=0)  # [nn + 1, F, W]
        lengths = torch.full((nn + 1,), w_len, dtype=torch.int64, device=self.device)
        ds_len = self.out_len_fn(w_len)
        lp = functional_call(self._work, params, (batch, lengths))["final_posteriors"]
        clean_lp = lp[-1].detach()
        labels, lab_len = greedy_labels(clean_lp, ds_len, self.blank_id, max_tokens)
        loss = ctc_loss(
            lp[:nn],
            torch.full((nn,), ds_len, dtype=torch.int64, device=self.device),
            labels[None].repeat(nn, 1),
            lab_len.expand(nn),
            blank_id=self.blank_id,
        ) / (max(ds_len, 1) * nn)
        return torch.autograd.grad(loss, list(params.values())), clean_lp, ds_len

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
        """Adapt on one recording; ``params`` (a state dict, ``None``: the
        engine's own model's) is not modified.  With ``return_params``,
        ``EngineOutput.params`` is a list of state dicts, one per real
        chunk."""
        cfg = self.config
        spec_padded, spec_n, W, N, n_real, starts_np, lengths_np, total_ds = self._plan(
            spec, seq_len, overlap)
        gen = self._generator(rng)
        epochs = max(cfg.epochs, 1)

        t0 = time.time()
        self._load(params)
        base = {k: p.detach() for k, p in self._work.named_parameters()}
        names = list(base)
        copies: List[Dict[str, torch.Tensor]] = [
            {k: p.clone().requires_grad_(True) for k, p in base.items()} for _ in range(n_real)]
        opts = [Adafactor(list(c.values()), lr=self.lr) for c in copies]
        # padding chunks are the last N - n_real: their rows and columns
        # leave the real block untouched
        mask = torch.as_tensor(lengths_np > 0, dtype=torch.float32)
        Wn = sequential_mix_matrix(mask, self.decay_per_distance)[:n_real, :n_real]
        Wn = Wn.to(self.device)
        grad_buf = {k: torch.empty((n_real,) + p.shape, dtype=p.dtype, device=self.device)
                    for k, p in base.items()}
        spec_dev = torch.as_tensor(spec_padded, device=self.device).to(self.transfer_dtype)
        max_tokens = max(8, int(self.out_len_fn(W) * self.max_label_frames_ratio))
        windows = [spec_dev[:, int(starts_np[i]) : int(starts_np[i]) + W].float()
                   for i in range(n_real)]

        clean = []
        for _ in range(epochs):
            clean = []
            for j in range(n_real):
                grads, clean_lp, ds_len = self._chunk_grad(
                    copies[j], windows[j], int(lengths_np[j]), max_tokens, gen)
                for k, g in zip(names, grads):
                    grad_buf[k][j].copy_(g)
                clean.append((clean_lp, ds_len))
            with torch.no_grad(), _no_tf32():
                for k in names:
                    G = grad_buf[k]
                    mixed = (Wn @ G.reshape(n_real, -1)).reshape(G.shape)
                    for j in range(n_real):
                        copies[j][k].grad = mixed[j]
            for opt in opts:
                opt.step()

        acc = torch.zeros(total_ds, self.n_classes, device=self.device)
        counts = torch.zeros(total_ds, device=self.device)
        for j in range(n_real):
            start_ds = int(starts_np[j]) // self.ds
            if cfg.online:
                lp, ds_len = clean[j]
            else:
                with torch.no_grad():
                    w_len = int(lengths_np[j])
                    lengths = torch.full((1,), w_len, dtype=torch.int64, device=self.device)
                    lp = functional_call(self._work, copies[j], (windows[j][None], lengths))
                    lp, ds_len = lp["final_posteriors"][0], self.out_len_fn(w_len)
            self._accumulate(acc, counts, lp, start_ds, ds_len)
        log_avg, counts = self._finish(acc, counts)

        adapted = None
        if return_params:
            adapted = [{k: p.detach() for k, p in c.items()} for c in copies]
        _sync(self.device)
        elapsed = time.time() - t0
        if cfg.print_runtimes:
            print(f"Spectrogram length: {spec_n}")
            print(f"Runtime: {elapsed}")
        return EngineOutput(log_avg, counts, adapted, elapsed, self.blank_id)
