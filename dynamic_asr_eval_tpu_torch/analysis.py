"""Results analysis: aggregate driver pickles, plot, emit LaTeX.

Counterpart of the JAX package's ``analysis.py`` (its own copy: the port
imports nothing of the JAX package): the protocol drivers write result
pickles; these helpers fold them into averaged WER summaries (JSON), bar
charts and protocol diagrams (``matplotlib``, imported inside the plot
functions only), LaTeX tables, and an audit of long gaps in STM timings.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
from typing import Dict, List, Optional, Sequence


def load_pickles(pattern: str) -> List[Dict]:
    out = []
    for path in sorted(glob.glob(pattern)):
        with open(path, "rb") as f:
            out.append({"_path": path, **pickle.load(f)})
    return out


def aggregate_per_recording(pattern: str) -> Dict:
    """Fold per-recording driver pickles (run.py schema) into mean WER +
    error-type rates across repeats (``results/crossdataset/aggregate.py``
    style)."""
    runs = load_pickles(pattern)
    if not runs:
        return {"n_runs": 0}
    keys = ("wer", "ins_rate", "del_rate", "sub_rate")
    agg = {k: sum(r[k] for r in runs if k in r) / len(runs) for k in keys}
    agg["n_runs"] = len(runs)
    agg["words"] = runs[0].get("words")
    return agg


def aggregate_cross_dataset(pattern: str) -> Dict:
    """Cross-dataset pickles → mean a_to_b / a_to_a_loo + baselines."""
    runs = load_pickles(pattern)
    out = {"runs": []}
    for r in runs:
        mean_ab = (sum(x["wer"] for x in r.get("a_to_b", [])) /
                   max(len(r.get("a_to_b", [])), 1))
        mean_loo = (sum(x["wer"] for x in r.get("a_to_a_loo", [])) /
                    max(len(r.get("a_to_a_loo", [])), 1))
        out["runs"].append({
            "path": r["_path"],
            "baselines": r.get("baselines", {}),
            "a_to_b": mean_ab,
            "a_to_a_loo": mean_loo,
        })
    return out


def aggregate_gender(pattern: str) -> Dict:
    runs = load_pickles(pattern)
    out = {"runs": []}
    for r in runs:
        row = {"path": r["_path"], "baselines": r.get("baselines", {})}
        for k in ("m_to_m", "m_to_f", "f_to_f", "f_to_m"):
            vals = [x["wer"] for x in r.get(k, [])]
            row[k] = sum(vals) / len(vals) if vals else None
        out["runs"].append(row)
    return out


def aggregate_half_concat(pattern: str) -> Dict:
    runs = load_pickles(pattern)
    out = {"runs": []}
    for r in runs:
        folds = [f["wer"] for f in r.get("folds", [])]
        out["runs"].append({
            "path": r["_path"],
            "baseline": (r.get("baseline") or {}).get("wer"),
            "mean_fold_wer": sum(folds) / len(folds) if folds else None,
        })
    return out


def write_json(summary: Dict, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(summary, f, indent=2, default=str)


def plot_wer_bars(labels: Sequence[str], wers: Sequence[float], out_path: str,
                  title: str = "WER", baseline: Optional[float] = None):
    """Simple WER bar figure (plot_*.py parity)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(max(4, len(labels) * 0.8), 3.2))
    ax.bar(range(len(labels)), wers)
    if baseline is not None:
        ax.axhline(baseline, linestyle="--", linewidth=1, label="baseline")
        ax.legend()
    ax.set_xticks(range(len(labels)))
    ax.set_xticklabels(labels, rotation=45, ha="right")
    ax.set_ylabel("WER")
    ax.set_title(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_protocol_scheme(protocol: str, out_path: str, n_chunks: int = 5):
    """Protocol scheme diagram (``results/within_loo/plot_within_loo_scheme.py``
    parity, L6 figure scripts).  Drawn as a pass×chunk role grid: each row is
    one adaptation pass, each cell shows what happens to that chunk in that
    pass (adapt / infer / held out), with a bottom row for the per-position
    probability average that feeds the final decode.

    ``protocol``: ``"within_loo"`` (pass i adapts on chunk i, infers the
    rest) or ``"half_concat"`` (two folds: adapt on one half, infer the
    other)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.patches as mpatches
    import matplotlib.pyplot as plt

    C_ADAPT, C_INFER, C_AVG = "#b5543c", "#3c6fb5", "#5d8a52"
    if protocol == "within_loo":
        passes = [["adapt" if c == p else "infer" for c in range(n_chunks)]
                  for p in range(n_chunks)]
        title = "Within-recording leave-one-out adaptation"
    elif protocol == "half_concat":
        n_chunks = 2
        passes = [["adapt", "infer"], ["infer", "adapt"]]
        title = "Half-concat fold adaptation"
    else:
        raise ValueError(f"unknown protocol {protocol!r}")

    n_rows = len(passes)
    fig, ax = plt.subplots(figsize=(1.3 * n_chunks + 2.5, 0.62 * (n_rows + 3)))
    ax.set_axis_off()

    def cell(x, y, color, label, text_color="white"):
        ax.add_patch(plt.Rectangle((x, y), 0.92, 0.7, facecolor=color,
                                   edgecolor="#333333", linewidth=0.6))
        ax.text(x + 0.46, y + 0.35, label, ha="center", va="center",
                fontsize=8, color=text_color)

    top = n_rows + 2.0
    for c in range(n_chunks):
        cell(c, top, "#d8d8d8", f"chunk {c + 1}", "#222222")
    ax.text(-0.15, top + 0.35, "recording", ha="right", va="center", fontsize=9)

    for p, roles in enumerate(passes):
        y = n_rows - p
        ax.text(-0.15, y + 0.35, f"pass {p + 1}", ha="right", va="center",
                fontsize=8)
        for c, role in enumerate(roles):
            cell(c, y, C_ADAPT if role == "adapt" else C_INFER, role)

    for c in range(n_chunks):
        cell(c, -0.6, C_AVG, "avg")
    ax.text(-0.15, -0.25, "stitched p̄", ha="right", va="center", fontsize=9)
    ax.annotate("", xy=(n_chunks / 2, -0.7), xytext=(n_chunks / 2, 0.85),
                arrowprops=dict(arrowstyle="-|>", color="#555555"))
    ax.text(n_chunks / 2, -1.15, "beam-search decode → hypothesis",
            ha="center", va="center", fontsize=9)

    ax.legend(handles=[mpatches.Patch(color=C_ADAPT, label="adapt (NSTI)"),
                       mpatches.Patch(color=C_INFER, label="infer (adapted weights)"),
                       mpatches.Patch(color=C_AVG, label="per-position average")],
              loc="upper left", bbox_to_anchor=(1.0, 1.0), frameon=False,
              fontsize=8)
    ax.set_xlim(-1.6, n_chunks + 2.6)
    ax.set_ylim(-1.5, top + 1.1)
    ax.set_title(title, fontsize=10)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def to_latex_table(rows: Sequence[Dict], columns: Sequence[str],
                   caption: str = "", fmt: str = "%.4f") -> str:
    """LaTeX tabular emitter (``summarize_epoch1_to_latex.py`` parity)."""
    header = " & ".join(columns) + r" \\"
    lines = [r"\begin{table}[h]", r"\centering",
             r"\begin{tabular}{" + "l" * len(columns) + "}", r"\toprule",
             header, r"\midrule"]
    for row in rows:
        cells = []
        for c in columns:
            v = row.get(c, "")
            cells.append(fmt % v if isinstance(v, float) else str(v))
        lines.append(" & ".join(cells) + r" \\")
    lines += [r"\bottomrule", r"\end{tabular}"]
    if caption:
        lines.append(r"\caption{" + caption + "}")
    lines.append(r"\end{table}")
    return "\n".join(lines)


def audit_transcript_gaps(records: Sequence[Dict], min_gap_seconds: float = 10.0,
                          frames_per_second: float = 100.0) -> List[Dict]:
    """Flag recordings whose STM timing coverage has long gaps
    (``results/gender_eval_tedlium/audit_tedlium_transcript_gaps.py`` parity).
    Records need a 'timings' list of (start, end) seconds."""
    findings = []
    for rec in records:
        timings = sorted(rec.get("timings", []))
        prev_end = 0.0
        for start, end in timings:
            if start - prev_end >= min_gap_seconds:
                findings.append({
                    "id": rec.get("id"),
                    "gap_start": prev_end,
                    "gap_end": start,
                    "gap_seconds": start - prev_end,
                })
            prev_end = max(prev_end, end)
    return findings
