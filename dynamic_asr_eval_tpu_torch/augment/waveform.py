"""Waveform-domain augmentations under an explicit ``torch.Generator``.

Counterpart of the JAX package's ``augment/waveform.py`` (the reference's
WavAugment chain for wav2vec2 TTA: time dropout ×100, additive noise at a
random SNR, reverb):

- :func:`time_dropout`: ``n_boxes`` random boxes, each narrower than
  ``max_seconds``, zeroed;
- :func:`additive_noise`: white noise at a uniform-random SNR in
  [``snr_db_min``, ``snr_db_max``] dB;
- :func:`simple_reverb`: ``y = (x + Σ_k g^k · delay(x, k·d)) / (1 + g)``,
  deterministic;
- :func:`wav_augment_pipeline`: the three in that order.

Every function takes a [T] wave or a [B, T] batch; a batch takes one
independent draw per row, as JAX's ``vmap`` over split keys does.  The
draws themselves cannot match JAX's: the tests hold these by their
properties (and the reverb exactly).
"""

from __future__ import annotations

import torch


def _rows(wave: torch.Tensor) -> torch.Tensor:
    return wave[None] if wave.dim() == 1 else wave


def time_dropout(
    wave: torch.Tensor,  # [T] or [B, T]
    generator: torch.Generator,
    n_boxes: int = 100,
    max_seconds: float = 0.3,
    sample_rate: int = 16000,
) -> torch.Tensor:
    x = _rows(wave)
    B, T = x.shape
    max_w = max(int(max_seconds * sample_rate), 1)
    dev = x.device
    widths = torch.randint(0, max_w, (B, n_boxes), generator=generator, device=dev)
    starts = torch.randint(0, max(T - 1, 1), (B, n_boxes), generator=generator, device=dev)
    # covered where more boxes have started than ended
    edges = torch.zeros((B, T + 1), dtype=torch.int32, device=dev)
    ones = torch.ones((B, n_boxes), dtype=torch.int32, device=dev)
    edges.scatter_add_(1, starts, ones)
    edges.scatter_add_(1, torch.clamp(starts + widths, max=T), -ones)
    covered = torch.cumsum(edges, dim=1)[:, :T] > 0
    out = torch.where(covered, torch.zeros((), dtype=x.dtype, device=dev), x)
    return out.reshape(wave.shape)


def additive_noise(
    wave: torch.Tensor,  # [T] or [B, T]
    generator: torch.Generator,
    snr_db_min: float = 10.0,
    snr_db_max: float = 30.0,
) -> torch.Tensor:
    x = _rows(wave)
    B, T = x.shape
    snr_db = snr_db_min + (snr_db_max - snr_db_min) * torch.rand(
        (B, 1), generator=generator, device=x.device, dtype=x.dtype)
    sig_pow = torch.mean(x * x, dim=1, keepdim=True) + 1e-12
    noise_pow = sig_pow / (10.0 ** (snr_db / 10.0))
    noise = torch.randn((B, T), generator=generator, device=x.device, dtype=x.dtype)
    return (x + noise * torch.sqrt(noise_pow)).reshape(wave.shape)


def _int_pow(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x ** k`` by binary exponentiation, in x's dtype: the products of
    XLA's ``integer_pow``, so that the taps round as JAX's do."""
    acc, base = None, x
    while k:
        if k & 1:
            acc = base if acc is None else acc * base
        k >>= 1
        if k:
            base = base * base
    return acc


def simple_reverb(
    wave: torch.Tensor,  # [..., T]
    reverberance: float = 0.5,
    delay_ms: float = 40.0,
    sample_rate: int = 16000,
    n_taps: int = 6,
) -> torch.Tensor:
    """Feedback-comb style tail: y = x + Σ_k g^k · delay(x, k·d), over 1 + g."""
    d = max(int(delay_ms / 1000.0 * sample_rate), 1)
    g = torch.tensor(min(max(reverberance, 0.0), 0.95), dtype=wave.dtype, device=wave.device)
    T = wave.shape[-1]
    out = wave
    for k in range(1, n_taps + 1):
        shift = k * d
        delayed = torch.zeros_like(wave)
        if shift < T:
            delayed[..., shift:] = wave[..., : T - shift]
        out = out + _int_pow(g, k) * delayed
    return out / (1.0 + g)


def wav_augment_pipeline(
    wave: torch.Tensor,  # [T] or [B, T]
    generator: torch.Generator,
    n_time_dropout: int = 100,
    max_dropout_seconds: float = 0.3,
    noise: bool = True,
    reverb: bool = True,
    sample_rate: int = 16000,
) -> torch.Tensor:
    """The reference chain: time dropout ×N → additive noise → reverb (at
    the reverb's own default rate, as in JAX)."""
    out = time_dropout(wave, generator, n_time_dropout, max_dropout_seconds, sample_rate)
    if noise:
        out = additive_noise(out, generator)
    if reverb:
        out = simple_reverb(out)
    return out
