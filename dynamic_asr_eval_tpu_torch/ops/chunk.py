"""Overlapping-window plan of long spectrograms.

Counterpart of the JAX package's ``ops/chunk.py``: a spectrogram that fits
one window is one full-length chunk; otherwise windows start every
``seq_len - overlap`` frames and the plan stops one window after the first
window that came out shorter than its predecessor.  ``pad_num_chunks`` rounds
the window count up to 8 buckets per power-of-two octave, and
:func:`chunk_spectrogram` cuts the windows themselves (numpy in, numpy out).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def chunk_starts_and_lengths(spec_n: int, seq_len: int, overlap: int) -> Tuple[List[int], List[int]]:
    if spec_n <= seq_len:
        return [0], [spec_n]
    stride = seq_len - overlap
    if stride <= 0:
        raise ValueError(f"overlap ({overlap}) must be < seq_len ({seq_len})")
    starts, lengths = [], []
    last_ulen = None
    kill_next = False
    for start in range(0, spec_n, stride):
        u_len = min(seq_len, spec_n - start)
        if kill_next:
            break
        if last_ulen is not None and u_len < last_ulen:
            kill_next = True
        last_ulen = u_len
        starts.append(start)
        lengths.append(u_len)
    return starts, lengths


def num_chunks(spec_n: int, seq_len: int, overlap: int) -> int:
    return len(chunk_starts_and_lengths(spec_n, seq_len, overlap)[0])


def pad_num_chunks(n: int, min_bucket: int = 4) -> int:
    """Round the window count up to a bucket (≥ ``min_bucket``) of
    granularity ``2**(⌊log2 n⌋-3)``."""
    n = max(int(n), max(min_bucket, 1))
    step = 1 << max(0, n.bit_length() - 4)
    return -(-n // step) * step


def chunk_spectrogram(
    spec: np.ndarray,  # [C, T] or [1, C, T]
    seq_len: int,
    overlap: int,
    pad_to_bucket: bool = True,
    min_bucket: int = 4,
):
    """Slice a spectrogram into stacked, zero-padded windows.

    Returns ``(windows [N, C, W], lengths [N] int32, starts [N] int32,
    n_real)`` where ``W = min(seq_len, T)`` if one window suffices, else
    ``seq_len``; with ``pad_to_bucket`` N is :func:`pad_num_chunks` of the
    window count and windows ``n_real..N-1`` are zeros of length 0 whose start
    repeats the last real start.
    """
    spec = np.asarray(spec)
    if spec.ndim == 3:
        spec = spec[0]
    C, T = spec.shape
    starts, lengths = chunk_starts_and_lengths(T, seq_len, overlap)
    n_real = len(starts)
    W = seq_len if T > seq_len else T
    N = pad_num_chunks(n_real, min_bucket) if pad_to_bucket else n_real
    windows = np.zeros((N, C, W), dtype=spec.dtype)
    for i, (s, L) in enumerate(zip(starts, lengths)):
        windows[i, :, :L] = spec[:, s : s + L]
    out_lengths = np.zeros((N,), dtype=np.int32)
    out_lengths[:n_real] = lengths
    out_starts = np.full((N,), starts[-1], dtype=np.int32)
    out_starts[:n_real] = starts
    return windows, out_lengths, out_starts, n_real
