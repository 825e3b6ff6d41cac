"""Analytic FLOP accounting and MFU estimation.

Counterpart of the JAX package's ``perf.py``, with the same counts:
matmul/conv multiply-adds (×2 FLOPs) for one forward pass of the conformer
(:class:`..models.conformer.SCConformer`) from its config and input length,
mirroring the module structure (subsampling taps, FF ×2, MHSA with the T²d
attention term, conv module, the self-conditioning head and re-embed of
each inner layer), for the engines' steps, and for one incremental step of
the transformer LM.  Backward ≈ 2× forward (each matmul contributes dX and
dW products).  The bf16 dense peaks are the NVIDIA H100 SXM's (989 TFLOP/s,
the figure the kernel bounds of ``chip_smoke.py`` use) beside the TPUs' of
the JAX package.  :func:`profile_kernels` reads one call's device time by
kernel on the card (``chip_smoke.py``, ``kernels/attention_variants.py``).
"""

from __future__ import annotations

import math
from typing import Optional


def conformer_forward_flops(cfg, T_in: int, batch: int = 1) -> float:
    """Matmul+conv FLOPs for one forward of SCConformer on ``[batch, F, T_in]``."""
    d = cfg.d_model
    V1 = cfg.n_classes  # vocab + blank
    L = cfg.n_layers
    F = cfg.feat_in
    C = cfg.subsampling_conv_channels
    exp = cfg.expansion_factor
    K = cfg.conv_kernel_size
    n_stages = int(round(math.log2(cfg.subsampling_factor)))
    T_ds = T_in
    for _ in range(n_stages):
        T_ds = -(-T_ds // 2)

    fl = 0.0
    # subsampling: stage 0 full 3x3 s2 conv (9 taps × C), then depthwise+pointwise
    t, f = -(-T_in // 2), -(-F // 2)
    fl += 2 * 9 * t * f * C  # stage-0 taps (1 input channel)
    for _ in range(n_stages - 1):
        t, f = -(-t // 2), -(-f // 2)
        fl += 2 * 9 * t * f * C  # depthwise taps
        fl += 2 * t * f * C * C  # 1x1 pointwise
    fl += 2 * T_ds * (f * C) * d  # out dense

    # per conformer block
    ff = 2 * (2 * T_ds * d * (exp * d))  # two matmuls per FF
    attn = (
        2 * T_ds * d * (3 * d)  # qkv
        + 2 * T_ds * T_ds * d  # scores
        + 2 * T_ds * T_ds * d  # attn @ V
        + 2 * T_ds * d * d  # out proj
    )
    if getattr(cfg, "pos_encoding", "rotary") == "relpos":
        attn += 2 * T_ds * d * d  # rel-pos projection
        attn += 2 * T_ds * T_ds * d  # matrix-bd term
    conv = (
        2 * T_ds * d * (2 * d)  # pw1 (GLU)
        + 2 * K * T_ds * d  # depthwise shifts
        + 2 * T_ds * d * d  # pw2
    )
    fl += L * (2 * ff + attn + conv)

    # self-conditioning: head + re-embed on every inner layer, head on final
    sc_layers = (L - 1) if cfg.self_conditioning else 0
    fl += sc_layers * (2 * T_ds * d * V1 + 2 * T_ds * V1 * d)
    fl += 2 * T_ds * d * V1  # final head
    return float(fl) * batch


def training_step_flops(cfg, T_in: int, batch: int,
                        grad_batch: Optional[int] = None) -> float:
    """FLOPs actually executed for one adaptation step: forward on ``batch``
    windows plus backward (≈2× forward) on the ``grad_batch`` that carries
    gradients.  In the NSTI engine the clean copy is detached
    (tta/runner.py ``_adapt_step``), so grad_batch = num_negatives = batch
    - 1: counting bwd over the full batch would overstate MFU by ~1.5×."""
    gb = (batch - 1) if grad_batch is None else grad_batch
    return (conformer_forward_flops(cfg, T_in, batch)
            + 2.0 * conformer_forward_flops(cfg, T_in, max(gb, 0)))


def awmc_step_flops(cfg, T_in: int, epochs: int = 1) -> float:
    """FLOPs for one AWMC chunk (tta/awmc.py chunk_step): anchor decode +
    final clean forward (2 forwards, no grad), plus per epoch a leader decode
    and a student forward (2 forwards) with backward (≈2×) on the student's
    single augmented copy."""
    fwd_batch = 2 + 2 * epochs
    return (conformer_forward_flops(cfg, T_in, batch=fwd_batch)
            + 2.0 * conformer_forward_flops(cfg, T_in, batch=epochs))


def transformer_lm_step_flops(lm_cfg, batch: int, cache_len: Optional[int] = None) -> float:
    """Matmul FLOPs for ONE incremental LM step (1 new token per stream) of
    ``lm/transformer_lm.py``'s decoder with a ring-buffer KV cache: qkv/out
    projections + 2-matmul FF per layer on the single position, plus
    attention reads over the cache, plus the output head."""
    d = lm_cfg.d_model
    L = lm_cfg.n_layers
    ff = getattr(lm_cfg, "expansion_factor", 4) * d
    C = cache_len if cache_len is not None else lm_cfg.max_cache_length
    per_layer = (
        2 * d * (3 * d)      # qkv projection (1 token)
        + 2 * C * d          # scores vs cache
        + 2 * C * d          # attn @ V
        + 2 * d * d          # out projection
        + 2 * 2 * d * ff     # feed-forward (two matmuls)
    )
    head = 2 * d * lm_cfg.vocab_size
    embed = 0.0  # table lookup, no matmul
    return float(batch) * (L * per_layer + head + embed)


# bf16 peak dense-matmul throughput per device, FLOP/s, keyed by a lowercase
# part of the device's name.  Sources: NVIDIA's H100 SXM datasheet (989T
# dense; "NVIDIA H100 80GB HBM3" is what torch.cuda.get_device_name gives
# for it), public TPU spec sheets (v4 275T, v5e 197T, v5p 459T, v6e 918T).
_PEAK_BF16 = {
    "h100 80gb hbm3": 989e12,
    "v4": 275e12,
    "v5 lite": 197e12,
    "v5litepod": 197e12,
    "v5e": 197e12,
    "v5p": 459e12,
    "v6e": 918e12,
    "v6 lite": 918e12,
}


def device_peak_flops(device_kind: str) -> Optional[float]:
    """Best-effort bf16 peak for a device name (``torch.cuda.get_device_name``
    or a TPU kind); None if unknown."""
    k = (device_kind or "").lower()
    for name, peak in _PEAK_BF16.items():
        if name in k:
            return peak
    return None


def mfu(total_flops: float, elapsed_s: float, device_kind: str) -> Optional[float]:
    peak = device_peak_flops(device_kind)
    if not peak or elapsed_s <= 0:
        return None
    return total_flops / (elapsed_s * peak)


def kernel_name(key: str) -> str:
    """A profiler key without ``void``, the namespace and the parameters."""
    name = key.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0]


def profile_kernels(fn):
    """[[kernel name, launches, device ms], ...] of one call of ``fn`` (after
    one warm-up call) under torch.profiler, slowest first, or "not
    measured"."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append([kernel_name(evt.key), evt.count, dev_us / 1e3])
    return sorted(rows, key=lambda r: -r[2]) or "not measured"
