"""Audio decode on the host, to float32 mono in [-1, 1].

Counterpart of the JAX package's ``audio/io.py``:

- WAV through the standard library's ``wave`` (PCM widths 1, 2 and 4 bytes,
  channels averaged);
- anything else (mp3, sph, a WAV ``wave`` cannot read) through the
  ``ffmpeg`` binary, which raises when it is absent;
- resampling with ``scipy.signal.resample_poly``;
- :func:`audio_duration_seconds` from the WAV header or ``ffprobe``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import wave
from math import gcd
from typing import Optional, Tuple

import numpy as np


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        sr, n, ch, width = w.getframerate(), w.getnframes(), w.getnchannels(), w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def load_via_ffmpeg(path: str, target_sr: int = 16000) -> Tuple[np.ndarray, int]:
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(f"ffmpeg not available to decode {path!r}; provide WAV input instead")
    cmd = ["ffmpeg", "-v", "error", "-i", path, "-f", "s16le", "-acodec", "pcm_s16le",
           "-ac", "1", "-ar", str(target_sr), "-"]
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    return np.frombuffer(out, dtype="<i2").astype(np.float32) / 32768.0, target_sr


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return x
    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(x, target_sr // g, orig_sr // g).astype(np.float32)


def load_audio(path: str, target_sr: int = 16000) -> np.ndarray:
    """Decode a file to float32 mono at ``target_sr``."""
    if os.path.splitext(path)[1].lower() == ".wav":
        try:
            x, sr = load_wav(path)
        except (wave.Error, EOFError, ValueError):  # float, A-law, 24-bit, ...
            x, sr = load_via_ffmpeg(path, target_sr)
    else:
        x, sr = load_via_ffmpeg(path, target_sr)
    return resample(x, sr, target_sr)


def audio_duration_seconds(path: str) -> Optional[float]:
    """Duration from the WAV header, else ``ffprobe``; None when neither can
    tell."""
    if os.path.splitext(path)[1].lower() == ".wav":
        try:
            with wave.open(path, "rb") as w:
                return w.getnframes() / w.getframerate()
        except (wave.Error, EOFError):
            pass
    if shutil.which("ffprobe"):
        try:
            out = subprocess.run(
                ["ffprobe", "-v", "error", "-show_entries", "format=duration",
                 "-of", "default=noprint_wrappers=1:nokey=1", path],
                capture_output=True, check=True).stdout
            return float(out.strip())
        except (subprocess.CalledProcessError, ValueError):
            return None
    return None
