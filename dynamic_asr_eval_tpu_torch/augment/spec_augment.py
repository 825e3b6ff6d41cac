"""Spectrogram augmentations of the TTA student copies, drawn from an
explicit ``torch.Generator``.

Counterpart of the JAX package's ``augment/spec_augment.py``, with the same
order (SpecAugment → frame shuffle → noise → cutout) and the same draws
(widths, starts, proportional time-mask widths, cutout rectangles whose count
scales with ``actual_len / seq_len``, per-rectangle means taken on the input).
The random numbers differ from JAX's: tests inject masks or use the zero-mask
config, which is the identity on both sides.
"""

from __future__ import annotations

from typing import Optional

import torch

from dynamic_asr_eval_tpu_torch.config import CutoutConfig, FrameShuffleConfig, SpecAugmentConfig


def _randint(g: torch.Generator, low: int, high: int, n: int) -> torch.Tensor:
    return torch.randint(low, high, (n,), generator=g, device=g.device)


def _band_mask(g, size: int, max_width, n_masks: int, widths=None) -> torch.Tensor:
    """bool [size] with ``n_masks`` random bands set."""
    if widths is None:
        widths = _randint(g, 0, max(int(max_width), 1), n_masks)
    starts = _randint(g, 0, max(size - 1, 1), n_masks)
    idx = torch.arange(size, device=g.device)[None, :]
    return ((idx >= starts[:, None]) & (idx < (starts + widths)[:, None])).any(dim=0)


def spec_augment(spec: torch.Tensor, g: torch.Generator, config: SpecAugmentConfig) -> torch.Tensor:
    if spec.dim() == 3:
        return torch.stack([spec_augment(s, g, config) for s in spec])
    F, T = spec.shape
    fill = torch.zeros((), dtype=spec.dtype, device=spec.device) if config.zero_masking else spec.mean()
    out = spec
    if config.n_freq_masks > 0:
        fmask = _band_mask(g, F, config.freq_mask_param, config.n_freq_masks)
        out = torch.where(fmask[:, None], fill, out)
    if config.n_time_masks > 0:
        if config.time_mask_param and config.time_mask_param > 0:
            tmask = _band_mask(g, T, config.time_mask_param, config.n_time_masks)
        else:
            props = config.min_p + (config.max_p - config.min_p) * torch.rand(
                config.n_time_masks, generator=g, device=g.device)
            widths = (props * T / config.n_time_masks).to(torch.int64)
            tmask = _band_mask(g, T, None, config.n_time_masks, widths=widths)
        out = torch.where(tmask[None, :], fill, out)
    return out


def replace_with_frame(spec: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """Every frame replaced by one frame drawn at random ([F, T]; [B, F, T]
    draws one frame per item)."""
    if spec.dim() == 3:
        return torch.stack([replace_with_frame(s, g) for s in spec])
    idx = int(_randint(g, 0, spec.shape[-1], 1))
    return spec[:, idx : idx + 1].expand(spec.shape)


def frame_shuffle(spec: torch.Tensor, g: torch.Generator, config: FrameShuffleConfig) -> torch.Tensor:
    if not (config.time_dimension or config.freq_dimension):
        return spec
    if spec.dim() == 3:
        return torch.stack([frame_shuffle(s, g, config) for s in spec])
    out = spec
    if config.time_dimension:
        out = out[:, torch.randperm(out.shape[-1], generator=g, device=g.device)]
    if config.freq_dimension:
        out = out[torch.randperm(out.shape[-2], generator=g, device=g.device), :]
    return out


def add_random_noise(spec: torch.Tensor, g: torch.Generator, noise_factor: float) -> torch.Tensor:
    if noise_factor == 0.0:
        return spec
    noise = torch.randn(spec.shape, generator=g, device=g.device, dtype=spec.dtype)
    return spec + noise * spec.std() * noise_factor


def cutout(spec: torch.Tensor, g: torch.Generator, config: CutoutConfig,
           actual_len: Optional[int] = None) -> torch.Tensor:
    if config.num_rectangles == 0:
        return spec
    if spec.dim() == 3:
        return torch.stack([cutout(s, g, config, actual_len) for s in spec])
    F, T = spec.shape
    n = config.num_rectangles
    L = T if actual_len is None else int(actual_len)
    n_active = int(n * (L / config.seq_len))
    widths = _randint(g, 1, max(config.max_width, 2), n)
    heights = _randint(g, 1, max(config.max_height, 2), n)
    xs = _randint(g, 0, T, n)
    ys = _randint(g, 0, F, n)
    dev = spec.device
    active = torch.arange(n, device=dev) < n_active
    tt = torch.arange(T, device=dev)[None, None, :]
    ff = torch.arange(F, device=dev)[None, :, None]
    rect = (
        (tt >= xs[:, None, None])
        & (tt < torch.clamp(xs + widths, max=T)[:, None, None])
        & (ff >= ys[:, None, None])
        & (ff < torch.clamp(ys + heights, max=F)[:, None, None])
        & active[:, None, None]
    )  # [n, F, T]
    if config.cutout_val == "zero":
        fills = torch.zeros(n, dtype=spec.dtype, device=dev)
    elif config.cutout_val == "mean_recording":
        fills = spec.mean().expand(n)
    elif config.cutout_val == "mean":
        denom = torch.clamp(rect.sum((1, 2)), min=1)
        fills = (spec[None] * rect).sum((1, 2)) / denom
    else:
        raise ValueError(f"unknown cutout value mode {config.cutout_val}")
    out = spec
    for i in range(n):  # later rectangles overwrite earlier ones
        out = torch.where(rect[i], fills[i], out)
    return out


def apply_augmentation_pipeline(
    spec: torch.Tensor,  # [B, F, T] augmented copies only
    g: torch.Generator,
    spec_augment_config: SpecAugmentConfig,
    frame_shuffle_config: FrameShuffleConfig,
    cutout_config: CutoutConfig,
    random_noise: float = 0.0,
    actual_len: Optional[int] = None,
) -> torch.Tensor:
    out = spec_augment(spec, g, spec_augment_config)
    out = frame_shuffle(out, g, frame_shuffle_config)
    out = add_random_noise(out, g, random_noise)
    return cutout(out, g, cutout_config, actual_len)
