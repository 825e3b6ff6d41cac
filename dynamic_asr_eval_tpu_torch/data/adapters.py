"""Dataset adapters: ``get_dataset(name, split, paths=None) -> [records]``,
each record ``{'id', 'text', 'audio', 'process_fn'}`` with ``process_fn(rec)
-> (spec [1, 80, T], normalized gold text)``.

Counterpart of the JAX package's ``data/adapters.py``:

- Earnings-22: an mp3 directory and one JSON of transcripts; tags stripped
  from the transcript (:func:`preprocess_earnings_transcript`);
- TEDLIUM: sph + stm pairs; ``ignore_time_segment_in_scoring`` regions
  zeroed in the spectrogram; apostrophes re-joined
  (:func:`proc_stm_and_timings`, :func:`fetch_utterances`);
- CHiME-6: every ``S*_U01.CH*.wav`` channel of a scene featurized without
  normalization, trimmed to the first and last word times of the JSON,
  averaged, then normalized per frequency row
  (:func:`combine_and_load_audio`);
- Rev16: an id-list file → mp3 and txt transcripts;
- ``synthetic`` (sine + noise recordings) and ``synthetic_spec`` (standard
  normal spectrograms of ``DAE_SYNTH_SPEC_FRAMES`` frames).

Paths follow the ``paths.yaml`` schema (``paths_template.yaml``); ``paths``
may be handed in as a dict, in which case no yaml is read.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

import numpy as np

from dynamic_asr_eval_tpu_torch.audio.features import (
    FeaturizerConfig,
    log_mel_spectrogram,
    zero_out_spectrogram,
)
from dynamic_asr_eval_tpu_torch.audio.io import load_audio
from dynamic_asr_eval_tpu_torch.config import DotDict, load_paths
from dynamic_asr_eval_tpu_torch.text.normalizer import normalize

_FEAT = FeaturizerConfig()
_TEXTS = [
    "the quick brown fox jumps over the lazy dog",
    "speech recognition systems adapt at test time",
    "long context models stitch overlapping windows",
]


def _paths(paths) -> DotDict:
    if not paths:
        return load_paths()
    return paths if isinstance(paths, DotDict) else DotDict(paths)


def _spec_from_path(path: str) -> np.ndarray:
    return log_mel_spectrogram(load_audio(path, _FEAT.sample_rate), _FEAT)


# ---------------------------------------------------------------------------
# Earnings-22
# ---------------------------------------------------------------------------


def preprocess_earnings_transcript(text: str) -> str:
    text = text.lower()
    for tag in ("<silence>", "<inaudible>", "<laugh>", "<noise>",
                "<affirmative>", "<crosstalk>", "…"):
        text = text.replace(tag, "")
    text = text.replace(",", "").replace("-", " ").replace(".", "").replace("?", "")
    text = re.sub(" +", " ", text)
    return normalize(text)


def _earnings22(split: str, paths=None) -> List[Dict]:
    paths = _paths(paths)
    audio_path = paths.get_path(f"datasets.earnings.{split}")
    text_path = paths.get_path("datasets.earnings.text")
    if not audio_path or not text_path:
        raise FileNotFoundError("paths.yaml missing datasets.earnings entries")
    with open(text_path, "r") as f:
        all_text = json.load(f)

    def process_fn(rec):
        return _spec_from_path(rec["audio"]), preprocess_earnings_transcript(rec["text"])

    out = []
    for fname in sorted(os.listdir(audio_path)):
        if fname.endswith(".mp3"):
            meeting = fname[: -len(".mp3")]
            out.append({"id": meeting, "text": all_text[meeting],
                        "audio": os.path.join(audio_path, fname), "process_fn": process_fn})
    return out


# ---------------------------------------------------------------------------
# TEDLIUM
# ---------------------------------------------------------------------------


def _stm_lines(stm_path: str):
    """(start, end, text) of each STM line with at least six fields."""
    with open(stm_path, "r") as f:
        lines = f.read().split("\n")
    for line in lines:
        sline = line.split(" ")
        if len(sline) >= 6:
            yield sline[3], sline[4], " ".join(sline[6:])


def _join_apostrophes(text: str) -> str:
    return re.sub(r" +", r" ", re.sub(r" '([a-z])", r"'\1", text))


def proc_stm_and_timings(stm_path: str):
    """An STM file → (joined text, kept timings, ignored timings)."""
    all_text = ""
    timings, remove_timings = [], []
    for start, end, text in _stm_lines(stm_path):
        if text == "ignore_time_segment_in_scoring":
            remove_timings.append((float(start), float(end)))
            continue
        all_text += text + " "
        timings.append((float(start), float(end)))
    return _join_apostrophes(all_text.strip()), timings, remove_timings


def fetch_utterances(stm_path: str, spec: np.ndarray):
    """Utterance segmentation over an existing spectrogram → (utterances,
    joined text)."""
    fps = _FEAT.sample_rate / _FEAT.hop_length
    utterances = []
    for start, end, text in _stm_lines(stm_path):
        if text == "ignore_time_segment_in_scoring":
            continue
        sf, ef = int(float(start) * fps), int(float(end) * fps)
        utterances.append({"start": float(start), "end": float(end), "text": text,
                           "start_frame": sf, "end_frame": ef,
                           "spectrogram": spec[..., sf:ef]})
    return utterances, _join_apostrophes(" ".join(u["text"] for u in utterances))


def _tedlium(split: str, paths=None) -> List[Dict]:
    data_path = _paths(paths).get_path(f"datasets.tedlium.{split}")
    if not data_path:
        raise FileNotFoundError("paths.yaml missing datasets.tedlium entries")
    sph_dir, stm_dir = os.path.join(data_path, "sph"), os.path.join(data_path, "stm")
    audio_files = sorted(os.path.join(sph_dir, f) for f in os.listdir(sph_dir) if f.endswith(".sph"))
    text_files = sorted(os.path.join(stm_dir, f) for f in os.listdir(stm_dir) if f.endswith(".stm"))
    if len(audio_files) != len(text_files):
        raise ValueError(f"TEDLIUM {split}: {len(audio_files)} sph files, {len(text_files)} stm")

    def process_fn(rec):
        gold, _, remove_timings = proc_stm_and_timings(rec["text"])
        spec = zero_out_spectrogram(_spec_from_path(rec["audio"]), remove_timings, _FEAT)
        return spec, normalize(gold)

    return [{"id": a, "text": t, "audio": a, "process_fn": process_fn}
            for a, t in zip(audio_files, text_files)]


# ---------------------------------------------------------------------------
# CHiME-6
# ---------------------------------------------------------------------------


def _hms_to_seconds(s: str) -> float:
    h, m, sec = s.split(":")
    return int(h) * 3600 + int(m) * 60 + float(sec)


def combine_and_load_audio(audio_files: List[str], stime: float, etime: float) -> np.ndarray:
    """Per-channel unnormalized spectrograms of the U01 array, trimmed to
    [stime, etime), averaged, then normalized per frequency row."""
    fps = _FEAT.sample_rate / _FEAT.hop_length
    waves = [load_audio(p, _FEAT.sample_rate) for p in audio_files]
    max_len = max(w.shape[-1] for w in waves)
    waves = [np.pad(w, (0, max_len - w.shape[-1])) for w in waves]
    cfg = FeaturizerConfig(normalize=False)
    sf, ef = int(stime * fps), int(etime * fps)
    spec = np.stack([log_mel_spectrogram(w, cfg)[..., sf:ef] for w in waves], axis=0).mean(axis=0)
    return (spec - spec.mean(-1, keepdims=True)) / (spec.std(-1, keepdims=True) + 1e-8)


def _chime6(split: str, paths=None) -> List[Dict]:
    base = _paths(paths).get_path(f"datasets.chime6.{split}")
    if not base:
        raise FileNotFoundError("paths.yaml missing datasets.chime6 entries")
    text_dir = base["text"] if isinstance(base, dict) else os.path.join(base, "transcriptions")
    audio_dir = base["audio"] if isinstance(base, dict) else os.path.join(base, "audio")

    text_files, stimes, etimes = {}, {}, {}
    for fname in os.listdir(text_dir):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(text_dir, fname), "r") as f:
            j = json.load(f)
        scene = fname[: -len(".json")]
        text_files[scene] = " ".join(el["words"] for el in j)
        stimes[scene] = _hms_to_seconds(j[0]["start_time"])
        etimes[scene] = _hms_to_seconds(j[-1]["end_time"])

    audio_names = [f for f in os.listdir(audio_dir) if re.match(r"S\d+_U01\.CH\d+\.wav", f)]
    scenes = sorted({f.split("_")[0] for f in audio_names})
    audio_files = {s: sorted(os.path.join(audio_dir, f) for f in audio_names
                             if f.startswith(s + "_")) for s in scenes}
    if set(audio_files) != set(text_files):
        raise ValueError(f"CHiME-6 {split}: audio scenes {sorted(audio_files)} != "
                         f"transcript scenes {sorted(text_files)}")

    def process_fn(rec):
        return (combine_and_load_audio(rec["audio"], rec["stimes"], rec["etimes"]),
                normalize(rec["text"]))

    return [{"id": s, "text": text_files[s], "audio": audio_files[s], "stimes": stimes[s],
             "etimes": etimes[s], "process_fn": process_fn} for s in scenes]


# ---------------------------------------------------------------------------
# Rev16
# ---------------------------------------------------------------------------


def _rev16(split: str, paths=None) -> List[Dict]:
    paths = _paths(paths)
    base, ids_file = paths.get_path("datasets.rev16.path"), paths.get_path("datasets.rev16.ids")
    if not base or not ids_file:
        raise FileNotFoundError("paths.yaml missing datasets.rev16 entries")
    with open(ids_file, "r") as f:
        ids = [el.strip() for el in f.read().strip().split(" ") if el.strip()]

    def process_fn(rec):
        return _spec_from_path(rec["audio"]), normalize(rec["text"])

    out = []
    for i in ids:
        with open(os.path.join(base, "transcripts", i + ".txt"), "r") as f:
            text = f.read().strip()
        out.append({"id": i, "text": text, "audio": os.path.join(base, "audio", i + ".mp3"),
                    "process_fn": process_fn})
    return out


# ---------------------------------------------------------------------------
# synthetic
# ---------------------------------------------------------------------------


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
    "earnings22": _earnings22,
    "tedlium": _tedlium,
    "chime6": _chime6,
    "rev16": _rev16,
    "synthetic": _synthetic,
    "synthetic_spec": _synthetic_spec,
}


def get_dataset(name: str, split: str, paths: Optional[object] = None) -> List[Dict]:
    if name not in datasets_functions:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(datasets_functions)}")
    return datasets_functions[name](split, paths=paths)
