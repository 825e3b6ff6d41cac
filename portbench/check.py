"""The comparison that decides ``correct``.

A checked record is judged by the plain reference (``portbench.reference``,
float32, TF32 off), which adapts on the record itself from the same weights,
spectrogram and masks and follows the program's pseudo-labels: the argmax
ids of the program's clean log-probs at each window, which the benchmark
reads where the program produces them.  The numbers compared:

- ``windows_missing``: windows of the record's plan for which the program
  produced no clean log-probs, or produced more (limit 0);
- ``label_gap``: the widest gap, over every window and valid frame, by
  which the log-prob of the program's id lies below the reference's best
  (nats): the program's forward at each step, and its adaptation so far;
- ``stitch_gap``: the same gap on the stitched output, for the program's
  stitched argmax, the tokens of the transcript;
- ``stitch_tv``: the largest total variation distance, over valid frames,
  between the program's stitched distribution and the reference's: the
  adapted weights' effect on every class, not only the argmax.  Logged, and
  compared only where a configuration's ``limits`` name it: on some records
  the first adapted window's bf16 step alone moves it past the float8
  control's reading (PERF.md, section 4);
- ``coverage_mismatch``: frames whose window count differs (limit 0);
- ``text_mismatch``: 1 where the program's transcript is not its stitched
  argmax collapsed and spelled by the vocabulary (limit 0).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference.conformer import Quant
from portbench.reference.nsti import adapt, collapse, plan

NUMBERS = ("windows_missing", "label_gap", "stitch_gap", "stitch_tv", "coverage_mismatch",
           "text_mismatch")


def spell(ids: List[int], pieces: List[str]) -> str:
    return "".join(pieces[i] for i in ids).replace("▁", " ").strip()


def transcript(stitched: torch.Tensor, cover: torch.Tensor, blank: int, pieces: List[str]) -> str:
    """Greedy transcript of stitched log-probs: the argmax over the covered
    frames, collapsed, at most half as many tokens as output frames."""
    n = int((cover > 0).sum())
    ids = collapse(stitched[:n].argmax(-1), blank, max(8, stitched.shape[0] // 2))
    return spell(ids.tolist(), pieces)


@torch.no_grad()
def judge(weights: Dict[str, torch.Tensor], m: Dict, engine: Dict, spec: torch.Tensor,
          masks: torch.Tensor, program: Dict, pieces: List[str]) -> Dict[str, float]:
    """Numbers of one record.  ``program``: ``ids`` (per window, the argmax
    ids of its clean log-probs), ``logits`` / ``counts`` (stitched), ``text``."""
    windows = plan(spec.shape[1], engine["seq_len"], engine["overlap"])
    out = dict.fromkeys(NUMBERS, 0.0)
    out["windows_missing"] = float(abs(len(windows) - len(program["ids"])))
    if out["windows_missing"]:
        return {k: (v if k == "windows_missing" else float("inf")) for k, v in out.items()}
    gaps = []

    def on_window(w, lp, teacher):
        gaps.append(float((lp.max(-1).values - lp.gather(1, teacher[:, None].long())[:, 0]).max()))

    with torch.enable_grad():
        stitched, cover, _ = adapt(weights, m, spec, masks, engine, teacher_ids=program["ids"],
                                   on_window=on_window)
    T = stitched.shape[0]
    lp, counts = program["logits"].float(), program["counts"].float()
    extra = int((counts[T:] > 0).sum()) if counts.shape[0] > T else 0
    counts = torch.nn.functional.pad(counts[:T], (0, max(0, T - counts.shape[0])))
    out["coverage_mismatch"] = float(int((counts != cover).sum()) + extra)
    valid = cover > 0
    lp, ref = lp[:T][valid], stitched[valid]
    ids = lp.argmax(-1)
    out["label_gap"] = max(gaps, key=lambda g: float("inf") if g != g else g)  # NaN wins
    out["stitch_gap"] = float((ref.max(-1).values - ref.gather(1, ids[:, None])[:, 0]).max())
    out["stitch_tv"] = float(0.5 * (lp.exp() - ref.exp()).abs().sum(-1).max())
    want = transcript(program["logits"].float(), program["counts"], m["vocab_size"], pieces)
    out["text_mismatch"] = float(program["text"] != want)
    return out


def control(weights: Dict[str, torch.Tensor], m: Dict, engine: Dict, spec: torch.Tensor,
            masks: torch.Tensor, pieces: List[str], quant: Quant) -> Dict:
    """The reference in the program's place, computed with ``quant``: its
    outputs in the form :func:`judge` reads."""
    stitched, cover, ids = adapt(weights, m, spec, masks, engine, quant=quant)
    return {"ids": ids, "logits": stitched.detach(), "counts": cover,
            "text": transcript(stitched.detach(), cover, m["vocab_size"], pieces)}


def worst(per_record: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in per_record) for k in NUMBERS}


# A configuration compares the numbers its ``limits`` name: those that
# separate its sound runs from its precision control (PERF.md, section 4).

def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= limit for k, limit in limits.items())


def lines(numbers: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f"{k} {numbers[k]!r} limit {limit!r}" for k, limit in limits.items()]


def as_entries(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    return {k: {"value": numbers[k], "limit": limit} for k, limit in limits.items()}

