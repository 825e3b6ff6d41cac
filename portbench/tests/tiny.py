"""A tiny copy of the benchmark for CPU tests: every configuration under
``portbench/configs`` (those no cell of ``BENCHMARK.json`` runs get a cell
``<name>.nsti.talks`` here) cut to 2 layers of width 32, a 3-record mix of
500-900 frames with 256-frame windows every 64 frames, written under a
directory the test owns."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TINY = dict(feat_in=16, n_layers=2, d_model=32, n_heads=2, head_dim=16, vocab_size=40,
            subsampling_conv_channels=8, conv_kernel_size=5)


def write(out: Path, **model) -> Path:
    """The tiny benchmark under ``out``; returns its BENCHMARK.json."""
    (out / "configs").mkdir(parents=True, exist_ok=True)
    (out / "traffic").mkdir(exist_ok=True)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {c["name"] for c in bench["configs"]}
    for path in sorted((ROOT / "portbench/configs").glob("*.json")):
        if path.stem not in listed:
            bench["configs"].append({"name": path.stem, "file": f"portbench/configs/{path.name}"})
            bench["workloads"].append({"name": f"{path.stem}.nsti.talks", "config": path.stem,
                                       "traffic": "talks", "chips": 1})
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["model"].update(TINY, **model)
        c["file"] = f"configs/{c['name']}.json"
        (out / c["file"]).write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "portbench/traffic/talks.json").read_text())
    mix.update(records=3, min_frames=500, max_frames=900, features=16, freq_masks=2,
               freq_mask_width=4)
    mix["engine"].update(seq_len=256, overlap=192)
    (out / "traffic" / "talks.json").write_text(json.dumps(mix))
    path = out / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path
