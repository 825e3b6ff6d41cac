"""The one traffic generator: a mix file of parameters → records from a seed.

A mix (``traffic/<name>.json``) holds only data:

- ``records``: how many distinct records to make; the window runs them in
  turn and starts over when they run out;
- ``min_frames`` / ``max_frames``: the range of record lengths (10 ms
  frames).  Lengths follow the van der Corput sequence over the range, the
  same for every seed: a record's audio per adapted window depends on its
  length (a 6-minute talk gives 33 s a window, an 18-minute one 23 s), so
  lengths drawn from the seed made the work, and RTFx, differ from seed to
  seed; any run of consecutive records covers the range evenly;
- ``features``: spectrogram bins; spectrograms are standard normal;
- ``freq_masks`` / ``freq_mask_width``: frequency bands blanked in each
  window's augmented copy (width below ``freq_mask_width``, start below
  ``features - 1``), filled with the copy's mean;
- ``words_per_second``: the length of each record's reference text, words
  drawn uniformly from the tokenizer's pieces;
- ``engine``: the NSTI settings (``seq_len``, ``overlap``, ``epochs``,
  ``online``, ``lr``, ``num_negatives``).

Everything random comes from the seed alone: the same seed gives the same
spectrograms, masks and texts.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from portbench.reference.nsti import plan


def load(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def substream(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *keys]))


def radical_inverse(i: int) -> float:
    """The i-th van der Corput number in base 2."""
    x, scale = 0.0, 0.5
    while i:
        x += (i & 1) * scale
        i >>= 1
        scale /= 2
    return x


def lengths(mix: Dict) -> List[int]:
    lo, hi = mix["min_frames"], mix["max_frames"]
    return [lo + int(radical_inverse(i + 1) * (hi - lo)) for i in range(mix["records"])]


def window_masks(mix: Dict, seed: int, record: int, n_windows: int) -> np.ndarray:
    """bool [n_windows, features]: the bands blanked in each window."""
    rng = substream(seed, 1, record)
    F = mix["features"]
    out = np.zeros((n_windows, F), bool)
    for w in range(n_windows):
        widths = rng.integers(0, mix["freq_mask_width"], mix["freq_masks"])
        starts = rng.integers(0, F - 1, mix["freq_masks"])
        for s, width in zip(starts, widths):
            out[w, s:s + width] = True
    return out


def make_records(mix: Dict, seed: int, pieces: List[str], device) -> List[Dict]:
    """Each record: ``frames``, ``spec`` (numpy [F, frames] float32, as a
    driver hands it over), ``masks`` (bool [windows, F] on ``device``),
    and ``text``.  The spectrograms are drawn on ``device`` in one
    call and moved to the host once."""
    ns = lengths(mix)
    F = mix["features"]
    gen = torch.Generator(device=device).manual_seed(int(substream(seed, 2).integers(2 ** 62)))
    flat = torch.randn(F, sum(ns), generator=gen, device=device).cpu().numpy()
    eng = mix["engine"]
    rng = substream(seed, 3)
    out, at = [], 0
    for i, n in enumerate(ns):
        n_win = len(plan(n, eng["seq_len"], eng["overlap"]))
        words = rng.integers(0, len(pieces), max(1, round(n / 100 * mix["words_per_second"])))
        out.append({
            "frames": n, "spec": flat[:, at:at + n],
            "masks": torch.as_tensor(window_masks(mix, seed, i, n_win), device=device),
            "text": " ".join(pieces[w].lstrip("▁") for w in words),
        })
        at += n
    return out


def pieces(vocab: int) -> List[str]:
    """``vocab`` distinct word pieces: "▁" and a bijective base-26 word."""
    out = []
    for i in range(vocab):
        word, j = "", i
        while j >= 0:
            word = chr(ord("a") + j % 26) + word
            j = j // 26 - 1
        out.append("▁" + word)
    return out
