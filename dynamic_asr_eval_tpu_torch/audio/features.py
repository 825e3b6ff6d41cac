"""Log-mel featurization: frame → Hann window → rFFT power → HTK mel
filterbank → log → per-feature normalization over time.

Counterpart of the JAX package's ``audio/features.py`` (16 kHz, 25 ms window,
10 ms hop, 80 mels, reflect padding of n_fft/2 at both ends), with
:func:`make_featurizer` (a closure on a device) and
:func:`zero_out_spectrogram` for TEDLIUM's ignored segments.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from dynamic_asr_eval_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FeaturizerConfig:
    sample_rate: int = 16000
    n_fft: int = 512
    win_length: int = 400
    hop_length: int = 160
    n_mels: int = 80
    fmin: float = 0.0
    fmax: Optional[float] = None  # defaults to sample_rate / 2
    log_offset: float = 1e-5
    normalize: bool = True  # per-feature mean/std over time


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(config: FeaturizerConfig) -> np.ndarray:
    """[n_mels, n_fft//2 + 1] triangular HTK-mel filterbank."""
    fmax = config.fmax or config.sample_rate / 2
    n_bins = config.n_fft // 2 + 1
    fft_freqs = np.linspace(0, config.sample_rate / 2, n_bins)
    mel_pts = np.linspace(hz_to_mel(config.fmin), hz_to_mel(fmax), config.n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fb = np.zeros((config.n_mels, n_bins), dtype=np.float32)
    for i in range(config.n_mels):
        lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    return fb


def log_mel(audio: torch.Tensor, config: FeaturizerConfig = FeaturizerConfig()) -> torch.Tensor:
    """waveform [n] (float tensor, any device) → log-mel [n_mels, T] in the
    waveform's dtype."""
    pad = config.n_fft // 2
    x = torch.nn.functional.pad(audio[None, None], (pad, pad), mode="reflect")[0, 0]
    frames = x.unfold(0, config.n_fft, config.hop_length)  # [T, n_fft]
    window = torch.from_numpy(np.hanning(config.win_length + 1)[:-1].astype(np.float32))
    wpad = (config.n_fft - config.win_length) // 2
    window = torch.nn.functional.pad(
        window, (wpad, config.n_fft - config.win_length - wpad)).to(audio.device, audio.dtype)
    spec = torch.fft.rfft(frames * window, n=config.n_fft, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.from_numpy(mel_filterbank(config)).to(audio.device, audio.dtype)
    out = torch.log(power @ fb.T + config.log_offset).T  # [mels, T]
    if config.normalize:
        mean = out.mean(dim=1, keepdim=True)
        std = out.std(dim=1, keepdim=True, unbiased=False)
        out = (out - mean) / (std + 1e-8)
    return out


def log_mel_spectrogram(
    audio: np.ndarray, config: FeaturizerConfig = FeaturizerConfig()
) -> np.ndarray:
    """waveform [n] → log-mel spec [1, n_mels, T] f32 (reference layout), on
    the host.  Computed in f64: PyTorch's f32 CPU rFFT alone drifts ~6e-4
    from an exact result on the normalized output."""
    out = log_mel(torch.as_tensor(np.asarray(audio, np.float64)), config)
    return out.numpy().astype(np.float32)[None]


def make_featurizer(config: FeaturizerConfig = FeaturizerConfig(),
                    device: Optional[Union[str, torch.device]] = None):
    """A featurizer closure: waveform [n] (array or tensor) → log-mel
    [n_mels, T] f32 tensor on ``device`` (``cuda`` unless ``cpu`` is asked
    for), computed in f64 as :func:`log_mel_spectrogram` computes it."""
    dev = resolve_device(device)

    def featurize(audio) -> torch.Tensor:
        x = torch.as_tensor(audio).to(device=dev, dtype=torch.float64)
        return log_mel(x, config).float()

    return featurize


def zero_out_spectrogram(spec: np.ndarray, regions_seconds,
                         config: FeaturizerConfig = FeaturizerConfig()) -> np.ndarray:
    """A copy of ``spec`` ([1, F, T] or [F, T]) with the frames covering each
    (start_s, end_s) region set to 0: floor of the start, ceil of the end."""
    spec = np.array(spec, copy=True)
    fps = config.sample_rate / config.hop_length
    T = spec.shape[-1]
    for start_s, end_s in regions_seconds:
        a = int(np.floor(start_s * fps))
        b = int(np.ceil(end_s * fps))
        spec[..., max(a, 0) : min(b, T)] = 0.0
    return spec
