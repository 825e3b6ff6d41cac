"""Random weights from the seed, made on the device in one draw.

Kernels are lecun-normal (std 1/√fan_in), biases and the relative-position
biases N(0, 0.02²), norm scales 1 + N(0, 0.02²) and offsets N(0, 0.02²),
batch-norm running means N(0, 0.1²) and variances U(0.5, 2).  Then the CTC
head's blank bias is raised until about ``emit_share`` of the frames of a
standard-normal input emit a token (:func:`set_blank_bias`): with random
weights every frame would emit, and the pseudo-labels would be as long as
the windows, which no trained model gives.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.conformer import forward, param_shapes

SMALL = {"bias": 0.02, "norm_bias": 0.02, "small": 0.02, "norm_scale": 0.02,
         "running_mean": 0.1}


def make(m: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = param_shapes(m)
    total = sum(math.prod(s) for _, s, _ in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in shapes:
        n = math.prod(shape)
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        if kind == "kernel":
            out[name] = z / math.sqrt(n // shape[0])
        elif kind == "norm_scale":
            out[name] = 1.0 + SMALL[kind] * z
        elif kind == "running_var":
            out[name] = 0.5 + 1.5 * u
        else:
            out[name] = SMALL[kind] * z
    return out


@torch.no_grad()
def set_blank_bias(P: Dict[str, torch.Tensor], m: Dict, emit_share: float, seed: int,
                   frames: int = 4096, rounds: int = 3) -> float:
    """Raise the blank's bias so that the blank wins all but about
    ``emit_share`` of the frames of a standard-normal input of ``frames``
    frames, by the reference forward in float32; returns the bias added."""
    blank = m["vocab_size"]
    gen = torch.Generator(device=P["decoder.bias"].device).manual_seed(int(seed))
    x = torch.randn(1, m["feat_in"], frames, generator=gen, device=gen.device)
    added = 0.0
    for _ in range(rounds):
        lp = forward(P, m, x, [frames])[0]
        margin = lp[:, :blank].max(-1).values - lp[:, blank]
        step = float(torch.quantile(margin, 1.0 - emit_share))
        P["decoder.bias"][blank] += step
        added += step
    return added
