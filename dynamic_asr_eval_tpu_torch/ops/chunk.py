"""Overlapping-window plan of long spectrograms.

Counterpart of the JAX package's ``ops/chunk.py``: a spectrogram that fits
one window is one full-length chunk; otherwise windows start every
``seq_len - overlap`` frames and the plan stops one window after the first
window that came out shorter than its predecessor.  ``pad_num_chunks`` rounds
the window count up to 8 buckets per power-of-two octave.
"""

from __future__ import annotations

from typing import List, Tuple


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
