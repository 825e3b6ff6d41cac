"""The port's audio decode, ``paths.yaml`` loader and real-corpus adapters
against the JAX package's, on fabricated inputs.

- ``audio/io.py``: 8-, 16- and 32-bit, stereo and resampled WAVs decode to
  the same samples; durations agree.
- Earnings-22, TEDLIUM, CHiME-6 and Rev16 on tiny fabricated directories:
  the same records, gold texts and spectrograms within 1e-5.  Both adapters
  featurize with the port's log-mel here, so the comparison holds what the
  adapters do (decode, trim, average, zero, normalize): the JAX featurizer
  runs in f32, the port's in f64, and they differ by up to ~2e-5 on these
  recordings (tests/test_torch_ops.py holds them at 1e-4).  Earnings-22,
  TEDLIUM and Rev16 name mp3 / sph files, which need ffmpeg: there
  ``load_audio`` is replaced, on both sides, by one function that makes a
  recording from the file's name.  CHiME-6 reads real multi-channel WAVs.
- ``get_dataset(..., paths=...)`` reads no yaml (PyYAML is not installed
  where the port runs).
"""

import json
import os
import subprocess
import sys
import wave
import zlib

import numpy as np
import pytest
import torch

import dynamic_asr_eval_tpu.data.adapters as jax_adapters
from dynamic_asr_eval_tpu.audio import features as jax_features
from dynamic_asr_eval_tpu.audio import io as jax_io
from dynamic_asr_eval_tpu.config import DotDict as JaxDotDict
from dynamic_asr_eval_tpu.config import load_paths as jax_load_paths
from dynamic_asr_eval_tpu_torch.audio import features, io
from dynamic_asr_eval_tpu_torch.config import DotDict, load_paths
from dynamic_asr_eval_tpu_torch.data import adapters

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC_TOL = 1e-5


def _signal(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (0.2 * np.sin(2 * np.pi * (180 + 40 * seed) * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _write_wav(path, x, sr=16000, width=2):
    """x [n] or [n, channels] in [-1, 1] as PCM of ``width`` bytes."""
    x = np.asarray(x, np.float64)
    channels = 1 if x.ndim == 1 else x.shape[1]
    if width == 1:
        raw = np.clip(np.round(x * 127 + 128), 0, 255).astype(np.uint8)
    else:
        top = 2 ** (8 * width - 1) - 1
        raw = np.round(np.clip(x, -1, 1) * top).astype({2: "<i2", 4: "<i4"}[width])
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(raw.tobytes())


# ---------------------------------------------------------------------------
# audio/io.py, zero_out_spectrogram
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width,channels,sr", [(1, 1, 16000), (2, 1, 16000), (4, 1, 16000),
                                               (2, 2, 16000), (2, 1, 8000), (4, 2, 44100)])
def test_load_audio_matches_jax(tmp_path, width, channels, sr):
    n = sr * 3 // 4
    x = _signal(n, 1) if channels == 1 else np.stack([_signal(n, c) for c in range(channels)], 1)
    path = str(tmp_path / "a.wav")
    _write_wav(path, x, sr, width)
    ours, theirs = io.load_audio(path, 16000), jax_io.load_audio(path, 16000)
    assert ours.dtype == theirs.dtype == np.float32
    assert ours.shape == theirs.shape == (n * 16000 // sr,)
    np.testing.assert_array_equal(ours, theirs)
    assert io.audio_duration_seconds(path) == jax_io.audio_duration_seconds(path) == n / sr


def test_a_format_wave_cannot_read_needs_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setattr(io.shutil, "which", lambda name: None)
    path = tmp_path / "a.mp3"
    path.write_bytes(b"\xff\xfb" + bytes(64))
    with pytest.raises(RuntimeError, match="ffmpeg"):
        io.load_audio(str(path))
    assert io.audio_duration_seconds(str(path)) is None


def test_zero_out_spectrogram_matches_jax():
    spec = np.random.default_rng(0).standard_normal((1, 80, 500)).astype(np.float32)
    regions = [(0.103, 0.5), (2.0, 2.011), (4.9, 9.0), (-1.0, 0.02)]
    ours = features.zero_out_spectrogram(spec, regions)
    np.testing.assert_array_equal(ours, jax_features.zero_out_spectrogram(spec, regions))
    assert not np.shares_memory(ours, spec) and (ours == 0).any()


# ---------------------------------------------------------------------------
# paths
# ---------------------------------------------------------------------------


def test_load_paths_and_dotdict_match_jax(tmp_path, monkeypatch):
    path = tmp_path / "paths.yaml"
    path.write_text("datasets:\n  rev16:\n    path: /data/rev16\n    ids: /data/ids.txt\n"
                    "  tedlium:\n    test: /data/ted\n")
    ours, theirs = load_paths(str(path)), jax_load_paths(str(path))
    assert ours == theirs and isinstance(ours, DotDict)
    assert ours.datasets.rev16.path == theirs.datasets.rev16.path
    for dotted in ("datasets.tedlium.test", "datasets.tedlium.dev", "datasets.nothing.x"):
        assert ours.get_path(dotted) == theirs.get_path(dotted)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DAE_PATHS_YAML", "")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    path.unlink()
    assert load_paths() == DotDict()


# ---------------------------------------------------------------------------
# the real corpora on fabricated directories
# ---------------------------------------------------------------------------


def _fake_load_audio(path, target_sr=16000):
    """A recording made from the file's name (1.5 s)."""
    return _signal(24000, zlib.crc32(os.path.basename(path).encode()) % 7)


def _earnings(tmp):
    audio = tmp / "earnings" / "test"
    audio.mkdir(parents=True)
    texts = {"meeting_a": "Good morning, <laugh> everyone... Q3 was up 12-15%? Yes.",
             "meeting_b": "<noise> We'll see; the colour of revenue… <crosstalk> grew."}
    for name in texts:
        (audio / f"{name}.mp3").write_bytes(b"")
    (audio / "notes.txt").write_text("not audio")
    (tmp / "earnings.json").write_text(json.dumps(texts))
    return {"datasets": {"earnings": {"test": str(audio), "text": str(tmp / "earnings.json")}}}


def _tedlium(tmp):
    base = tmp / "ted" / "test"
    for sub in ("sph", "stm"):
        (base / sub).mkdir(parents=True)
    stm = {"talk_a": ["talk_a 1 spk 0.00 0.60 <o,f0,male> hello world i 'm here",
                      "talk_a 1 spk 0.60 0.95 <o,f0,male> ignore_time_segment_in_scoring",
                      "talk_a 1 spk 0.95 1.40 <o,f0,male> it 's  a test",
                      ";; a comment line"],
           "talk_b": ["talk_b 1 spk 0.10 1.20 <o,f0,female> the colour of money"]}
    for name, lines in stm.items():
        (base / "sph" / f"{name}.sph").write_bytes(b"")
        (base / "stm" / f"{name}.stm").write_text("\n".join(lines) + "\n")
    return {"datasets": {"tedlium": {"test": str(base)}}}


def _chime6(tmp):
    text, audio = tmp / "chime" / "text", tmp / "chime" / "audio"
    text.mkdir(parents=True)
    audio.mkdir(parents=True)
    for scene, n_ch, words in (("S01", 2, ["hello there", "how are you"]),
                               ("S02", 1, ["fine thanks"])):
        for ch in range(1, n_ch + 1):
            _write_wav(audio / f"{scene}_U01.CH{ch}.wav", _signal(24000 + 800 * ch, ch + 3))
        _write_wav(audio / f"{scene}_U02.CH1.wav", _signal(8000, 9))  # another array
        segs = [{"words": w, "start_time": f"0:00:0{i}.{2 + i}0", "end_time": f"0:00:0{i + 1}.10"}
                for i, w in enumerate(words)]
        (text / f"{scene}.json").write_text(json.dumps(segs))
    return {"datasets": {"chime6": {"test": {"text": str(text), "audio": str(audio)}}}}


def _rev16(tmp):
    base = tmp / "rev16"
    for sub in ("audio", "transcripts"):
        (base / sub).mkdir(parents=True)
    for i, text in (("3", "Welcome back to the show.\n"), ("17", "  It's a 10 o'clock start  ")):
        (base / "audio" / f"{i}.mp3").write_bytes(b"")
        (base / "transcripts" / f"{i}.txt").write_text(text)
    (tmp / "ids.txt").write_text("3 17 ")
    return {"datasets": {"rev16": {"path": str(base), "ids": str(tmp / "ids.txt")}}}


CORPORA = {"earnings22": _earnings, "tedlium": _tedlium, "chime6": _chime6, "rev16": _rev16}


@pytest.mark.parametrize("name", list(CORPORA))
def test_real_corpus_adapter_matches_jax(tmp_path, monkeypatch, name):
    paths = CORPORA[name](tmp_path)
    if name != "chime6":
        monkeypatch.setattr(adapters, "load_audio", _fake_load_audio)
        monkeypatch.setattr(jax_adapters, "load_audio", _fake_load_audio)
    monkeypatch.setattr(jax_adapters, "log_mel_spectrogram", features.log_mel_spectrogram)
    ours = adapters.get_dataset(name, "test", paths=paths)
    theirs = jax_adapters.get_dataset(name, "test", paths=JaxDotDict(paths))
    assert len(ours) == len(theirs) >= 2
    for a, b in zip(ours, theirs):
        assert {k: v for k, v in a.items() if k != "process_fn"} == \
            {k: v for k, v in b.items() if k != "process_fn"}
        spec, gold = a["process_fn"](a)
        ref_spec, ref_gold = b["process_fn"](b)
        assert gold == ref_gold and gold
        assert spec.shape == ref_spec.shape and spec.shape[-2] == 80
        np.testing.assert_allclose(spec, ref_spec, rtol=0, atol=SPEC_TOL)


def test_transcript_helpers_match_jax(tmp_path):
    for text in ("Um, <silence> the Q4... numbers-were GOOD? <inaudible>", "A  -  b…c"):
        assert (adapters.preprocess_earnings_transcript(text)
                == jax_adapters.preprocess_earnings_transcript(text))
    stm = _tedlium(tmp_path)["datasets"]["tedlium"]["test"] + "/stm/talk_a.stm"
    assert adapters.proc_stm_and_timings(stm) == jax_adapters.proc_stm_and_timings(stm)
    spec = np.random.default_rng(3).standard_normal((1, 80, 200)).astype(np.float32)
    (ours, text), (theirs, ref_text) = (adapters.fetch_utterances(stm, spec),
                                        jax_adapters.fetch_utterances(stm, spec))
    assert text == ref_text and len(ours) == len(theirs) == 2
    for u, v in zip(ours, theirs):
        assert {k: x for k, x in u.items() if k != "spectrogram"} == \
            {k: x for k, x in v.items() if k != "spectrogram"}
        np.testing.assert_array_equal(u["spectrogram"], v["spectrogram"])
    for hms in ("0:00:01.25", "1:02:03.5"):
        assert adapters._hms_to_seconds(hms) == jax_adapters._hms_to_seconds(hms)


_NO_YAML = """
import sys
from dynamic_asr_eval_tpu_torch.data import get_dataset
recs = get_dataset("rev16", "test", paths={paths!r})
print(len(recs), "yaml" in sys.modules)
"""


def test_get_dataset_with_paths_reads_no_yaml(tmp_path):
    paths = _rev16(tmp_path)
    proc = subprocess.run([sys.executable, "-c", _NO_YAML.format(paths=paths)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["2", "False"]


def test_unknown_dataset_raises():
    with pytest.raises(KeyError, match="unknown dataset"):
        adapters.get_dataset("librispeech", "test")
