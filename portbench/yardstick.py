"""The benchmark's arithmetic: operation counts, bounds, peaks, statistics.

Frozen here so that a change to the program cannot move the yardstick.
Counts follow the model's equations at the shapes of each call; the peaks
are NVIDIA's published H100 SXM figures (dense, without sparsity): 989
TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
FRAME_SECONDS = 0.01  # one spectrogram frame


def ceil_chain(T: int, stages: int = 3) -> List[int]:
    """Rows after each stride-2 stage (⌈T/2⌉, ⌈T/4⌉, ...)."""
    out = []
    for _ in range(stages):
        T = -(-T // 2)
        out.append(T)
    return out


def conformer_forward_flops(m: Dict, T_in: int, batch: int = 1) -> float:
    """Multiply-add FLOPs (2 per product) of one forward on [batch, F,
    T_in]: subsampling taps and pointwise products, the out projection; per
    block two FFs, the qkv / out projections, scores and attention·V over
    the T'² pairs, with relative positions the ``linear_pos`` projection of
    the 2T' - 1 embeddings and the position scores of the T'² pairs, the
    conv module's pointwise and depthwise products; the CTC head, and with
    self-conditioning the head and re-embedding after every block but the
    last."""
    d, V, L = m["d_model"], m["vocab_size"] + 1, m["n_layers"]
    C, E, K = m["subsampling_conv_channels"], m.get("expansion_factor", 4), m["conv_kernel_size"]
    stages = int(round(math.log2(m["subsampling_factor"])))
    rows = ceil_chain(T_in, stages)
    cols = ceil_chain(m["feat_in"], stages)
    T = rows[-1]
    fl = 2 * 9 * rows[0] * cols[0] * C
    for t, f in zip(rows[1:], cols[1:]):
        fl += 2 * 9 * t * f * C + 2 * t * f * C * C
    fl += 2 * T * cols[-1] * C * d
    ff = 2 * (2 * T * d * E * d)
    attn = 2 * T * d * 3 * d + 2 * 2 * T * T * d + 2 * T * d * d
    if m.get("position_encoding") == "rel_pos":
        attn += 2 * T * T * d
    conv = 2 * T * d * 2 * d + 2 * K * T * d + 2 * T * d * d
    fl += L * (2 * ff + attn + conv)
    sc = (L - 1) if m.get("self_conditioning", True) and L > 1 else 0
    fl += sc * 2 * (2 * T * d * V) + 2 * T * d * V
    fl *= batch
    if m.get("position_encoding") == "rel_pos":  # once a forward, whatever the batch
        fl += L * 2 * (2 * T - 1) * d * d
    return float(fl)


def window_flops(m: Dict, length: int, num_negatives: int = 1) -> float:
    """One adapted window of ``length`` valid frames: the forward of the
    augmented copies and the clean copy, the backward (2× forward: input and
    weight gradients) of the augmented copies; nothing recomputed."""
    return (conformer_forward_flops(m, length, num_negatives + 1)
            + 2.0 * conformer_forward_flops(m, length, num_negatives))


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time of a call: its operations at the peak or its bytes at
    the memory bandwidth, the larger."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def attention_work(batch: int, T: int, heads: int, head_dim: int, valid: Sequence[int],
                   esize: int = 2) -> Dict[str, Tuple[float, float]]:
    """(flops, bytes) of one flash-attention forward and backward on
    [batch, T, heads, head_dim] whose rows have ``valid`` frames: the valid
    query-key pairs only (scores and P·V forward; S recomputed, dV, dP, dQ,
    dK backward), each tensor read or written once, the log-sum-exp in f32
    and one int32 segment id a row."""
    pairs = sum(n * n for n in valid) * heads
    tensor = batch * T * heads * head_dim * esize
    lse = batch * heads * T * 4
    seg = batch * T * 4
    return {"fwd": (4 * head_dim * pairs, 4 * tensor + lse + seg),
            "bwd": (10 * head_dim * pairs, 8 * tensor + lse + seg)}


def subsample_work(batch: int, T: int, F: int, C: int, esize: int = 2
                   ) -> Dict[str, Tuple[float, float]]:
    """(flops, bytes) of the fused ×8 subsampling forward and of its backward
    without the input gradient: stage 0's 9 taps, both depthwise convs and
    both pointwise products; the backward recomputes the forward and adds
    the weight gradients of all, the input gradients of all but stage 0.
    Input and output once, f32 weights once (twice backward: read and
    gradient)."""
    T0, T1, T2 = ceil_chain(T)
    M0, M1, M2 = batch * T0 * F // 2, batch * T1 * F // 4, batch * T2 * F // 8
    stage0, dw, pw = 18 * M0 * C, 18 * (M1 + M2) * C, 2 * (M1 + M2) * C * C
    weights = (32 * C + 2 * C * C) * 4
    x_bytes, out_bytes = batch * T * F * esize, M2 * C * esize
    fwd = stage0 + dw + pw
    return {"fwd": (fwd, x_bytes + out_bytes + weights),
            "bwd": (fwd + 2 * pw + 2 * dw + stage0, x_bytes + out_bytes + 2 * weights)}


def p95(values: Sequence[float]) -> float:
    """The nearest-rank 95th percentile: the smallest value with at least
    95 % of the samples at or below it."""
    xs = sorted(values)
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by (start, end) intervals, overlaps once."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def rtfx(frames: Sequence[int], wall_s: float) -> float:
    """Audio seconds of every record run over the wall seconds from the
    first record's start to the last record's end."""
    return sum(frames) * FRAME_SECONDS / wall_s
