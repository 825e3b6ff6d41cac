"""Plain NSTI (noisy student test-time adaptation) over one recording.

The method as published (robflynnyh/dynamic-asr-eval, online mode): the
recording is cut into windows of ``seq_len`` frames every ``seq_len -
overlap`` frames; per window, in order, the model's log-probs of the clean
window give greedy pseudo-labels (argmax, repeats collapsed, blanks
dropped), the CTC loss of the augmented copies against them, divided by the
window's subsampled length and the number of copies, takes one MADGRAD
step, and the clean log-probs of that step are stitched: each output frame
is the log of the mean probability over the windows that cover it.  Every
recording starts from the same weights and a fresh optimizer.

:func:`adapt` runs it in float32 (or with ``quant``, the precision
control).  Its pseudo-labels come from its own argmax, or, where
``teacher_ids`` gives a window's frame-wise ids, from those: the judge
follows the program's labels, so that one label flipped by rounding does not
send the two adaptations apart, and reads at each window the gap by which
the program's ids lie below its own best log-prob.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.conformer import Quant, forward, subsampled_length, trainable


# The engine settings this reference implements: one online pass (each
# window adapted once, in order, and stitched from that step's forward).
ENGINE = {"seq_len", "overlap", "epochs", "online", "lr", "num_negatives"}
ENGINE_FIXED = {"epochs": 1, "online": True}


def check_engine(engine: Dict) -> None:
    """Refuses a mix whose engine settings this reference does not
    implement, naming them: judged against it, such a run could only come
    out not correct."""
    bad = sorted(set(engine) - ENGINE) + [f"{k}={engine.get(k)!r} (implemented: {v!r})"
                                          for k, v in ENGINE_FIXED.items() if engine.get(k) != v]
    missing = sorted(ENGINE - set(engine))
    if bad or missing:
        raise ValueError(f"the plain NSTI reference does not implement the engine settings "
                         f"{bad}{'; missing ' + str(missing) if missing else ''}")


def plan(n_frames: int, seq_len: int, overlap: int) -> List[Tuple[int, int]]:
    """(start, length) of each window: one window of the whole recording
    when it fits; else a window every ``seq_len - overlap`` frames, stopping
    one window after the first that comes out shorter than the one before."""
    if n_frames <= seq_len:
        return [(0, n_frames)]
    out: List[Tuple[int, int]] = []
    shorter = False
    for start in range(0, n_frames, seq_len - overlap):
        if shorter:
            break
        length = min(seq_len, n_frames - start)
        shorter = bool(out) and length < out[-1][1]
        out.append((start, length))
    return out


def collapse(ids: torch.Tensor, blank: int, limit: int) -> torch.Tensor:
    """Greedy CTC labels of frame-wise ids: repeats merged, blanks dropped,
    at most ``limit``."""
    prev = torch.cat([ids.new_full((1,), -1), ids[:-1]])
    return ids[(ids != prev) & (ids != blank)][:limit]


class MADGRAD:
    """Defazio & Jelassi (2021), momentum dual averaging:
    λ_k = lr √(k+1); s += λ_k g; ν += λ_k g²; z = x0 - s / (ν^(1/3) + ε);
    x = (1 - c) x + c z with c = 1 - momentum."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, momentum: float = 0.9,
                 eps: float = 1e-6):
        self.params, self.lr, self.c, self.eps, self.k = list(params), lr, 1.0 - momentum, eps, 0
        self.s = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.x0 = [p.detach().clone() for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        lam = self.lr * math.sqrt(self.k + 1.0)
        for p, s, nu, x0 in zip(self.params, self.s, self.nu, self.x0):
            if p.grad is None:
                continue
            s.add_(lam * p.grad)
            nu.add_(lam * p.grad * p.grad)
            p.mul_(1.0 - self.c).add_(self.c * (x0 - s / (nu.pow(1.0 / 3.0) + self.eps)))
        self.k += 1


def adapt(weights: Dict[str, torch.Tensor], m: Dict, spec: torch.Tensor,
          masks: torch.Tensor, engine: Dict, teacher_ids: Optional[List[torch.Tensor]] = None,
          quant: Quant = None, on_window: Optional[Callable] = None):
    """One recording through NSTI.  ``spec`` [F, n] float32 on the device;
    ``masks`` [windows, F] bool, the frequency bands blanked in window w's
    augmented copy (filled with the copy's mean); ``engine`` the traffic's
    engine settings (seq_len, overlap, lr, num_negatives).  ``on_window(w,
    lp, ids)`` sees each window's clean log-probs [T', V] (valid frames) and
    the ids its labels came from.  Returns (stitched log-probs [T_out, V],
    coverage [T_out], the frame-wise argmax ids of each window's clean
    log-probs)."""
    check_engine(engine)
    f, V = m["subsampling_factor"], m["vocab_size"] + 1
    blank, W, nn = m["vocab_size"], engine["seq_len"], engine["num_negatives"]
    Fdim, n = spec.shape
    windows = plan(n, W, engine["overlap"])
    W = min(W, n)
    P = {k: v.detach().clone().requires_grad_(trainable(k)) for k, v in weights.items()}
    opt = MADGRAD([v for k, v in P.items() if trainable(k)], lr=engine["lr"])
    T_out = subsampled_length(windows[-1][0] + W, f)
    acc = torch.zeros(T_out, V, device=spec.device)
    cover = torch.zeros(T_out, device=spec.device)
    own_ids = []
    for w, (start, length) in enumerate(windows):
        clean = torch.zeros(Fdim, W, device=spec.device)
        clean[:, :length] = spec[:, start:start + length]
        noisy = torch.where(masks[w][:, None], clean.mean(), clean)
        batch = torch.stack([noisy] * nn + [clean])
        lp = forward(P, m, batch, [length] * (nn + 1), quant)
        t = subsampled_length(length, f)
        clean_lp = lp[-1, :t].detach()
        ids = clean_lp.argmax(-1)
        own_ids.append(ids)
        teacher = ids if teacher_ids is None else teacher_ids[w][:t]
        labels = collapse(teacher, blank, subsampled_length(W, f))
        targets = labels if len(labels) else labels.new_zeros(1)  # an empty label: all blank
        loss = F.ctc_loss(lp[:nn].transpose(0, 1), targets[None].expand(nn, -1),
                          [t] * nn, [len(labels)] * nn, blank=blank, reduction="sum",
                          zero_infinity=True) / (max(t, 1) * nn)
        for p in P.values():
            p.grad = None
        loss.backward()
        opt.step()
        if on_window is not None:
            on_window(w, clean_lp, teacher)
        s = start // f
        acc[s:s + t] += torch.exp(clean_lp)
        cover[s:s + t] += 1.0
        del lp, loss
    stitched = torch.log(torch.clamp(acc / torch.clamp(cover[:, None], min=1.0), min=1e-12))
    return stitched, cover, own_ids
