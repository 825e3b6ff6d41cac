"""Dataset adapters: ``get_dataset(name, split) -> [records]``, each record
``{'id', 'text', 'audio', 'process_fn'}`` with ``process_fn(rec) -> (spec
[1, 80, T], normalized gold text)``.

Counterpart of the JAX package's ``data/adapters.py``; the synthetic corpora
only (the real corpora are in ROADMAP queue 1).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from dynamic_asr_eval_tpu_torch.audio.features import FeaturizerConfig, log_mel_spectrogram
from dynamic_asr_eval_tpu_torch.text.normalizer import normalize

_FEAT = FeaturizerConfig()
_TEXTS = [
    "the quick brown fox jumps over the lazy dog",
    "speech recognition systems adapt at test time",
    "long context models stitch overlapping windows",
]


def _synthetic(split: str, paths=None, n_records: int = 3, seconds: float = 4.0) -> List[Dict]:
    """Generated sine + noise recordings with known texts."""

    def process_fn(rec):
        rng = np.random.default_rng(rec["seed"])
        n = int(seconds * _FEAT.sample_rate)
        t = np.arange(n) / _FEAT.sample_rate
        wave = 0.1 * np.sin(2 * np.pi * (200 + 50 * rec["seed"]) * t)
        wave += 0.01 * rng.standard_normal(n)
        return log_mel_spectrogram(wave.astype(np.float32), _FEAT), normalize(rec["text"])

    return [
        {"id": f"synthetic_{i}", "text": _TEXTS[i % len(_TEXTS)], "audio": None,
         "seed": i, "process_fn": process_fn}
        for i in range(n_records)
    ]


def _synthetic_spec(split: str, paths=None) -> List[Dict]:
    """Spectrogram-level synthetic corpus: per-record frame counts from
    ``DAE_SYNTH_SPEC_FRAMES`` (comma list, default ``3000,6000``); standard
    normal spectrograms generated directly from the record's seed."""
    frames = [int(x) for x in os.environ.get(
        "DAE_SYNTH_SPEC_FRAMES", "3000,6000").split(",")]

    def process_fn(rec):
        rng = np.random.default_rng(rec["seed"])
        spec = rng.standard_normal((1, 80, rec["frames"]), dtype=np.float32)
        return spec, normalize(rec["text"])

    return [
        {"id": f"synthetic_spec_{i}_{t}", "text": _TEXTS[i % len(_TEXTS)],
         "audio": None, "seed": i, "frames": t, "process_fn": process_fn}
        for i, t in enumerate(frames)
    ]


datasets_functions = {
    "synthetic": _synthetic,
    "synthetic_spec": _synthetic_spec,
}


def get_dataset(name: str, split: str, paths: Optional[object] = None) -> List[Dict]:
    if name not in datasets_functions:
        raise NotImplementedError(
            f"dataset {name!r} is not ported (have {sorted(datasets_functions)}; "
            "the real corpora are in ROADMAP queue 1)")
    return datasets_functions[name](split, paths=paths)
