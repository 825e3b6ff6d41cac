"""Word / character error rate with insertion/deletion/substitution detail.

Counterpart of the JAX package's ``text/wer.py`` (pure-Python path only):
corpus-wide edit counts over the total number of reference words; ties prefer
substitution, then deletion, then insertion.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def _edit_ops(hyp: Sequence, ref: Sequence) -> Tuple[int, int, int]:
    """(insertions, deletions, substitutions) of the minimal-cost alignment
    transforming ``ref`` into ``hyp``."""
    H, R = len(hyp), len(ref)
    if R == 0:
        return H, 0, 0
    if H == 0:
        return 0, R, 0
    # prev[j] = (cost, ins, del, sub) for hyp[:i-1] vs ref[:j]
    prev = [(j, 0, j, 0) for j in range(R + 1)]
    for i in range(1, H + 1):
        cur = [(i, i, 0, 0)]
        h = hyp[i - 1]
        for j in range(1, R + 1):
            match = h == ref[j - 1]
            sub = prev[j - 1][0] + (0 if match else 1)
            dele = cur[j - 1][0] + 1
            ins = prev[j][0] + 1
            if sub <= dele and sub <= ins:
                c, a, d, s = prev[j - 1]
                cur.append((sub, a, d, s + (0 if match else 1)))
            elif dele <= ins:
                c, a, d, s = cur[j - 1]
                cur.append((dele, a, d + 1, s))
            else:
                c, a, d, s = prev[j]
                cur.append((ins, a + 1, d, s))
        prev = cur
    _, ins, dels, subs = prev[R]
    return ins, dels, subs


def word_error_rate_detail(
    hypotheses: List[str],
    references: List[str],
    use_cer: bool = False,
) -> Tuple[float, int, float, float, float]:
    """``(wer, words, ins_rate, del_rate, sub_rate)`` over a corpus."""
    if len(hypotheses) != len(references):
        raise ValueError(
            f"hypotheses ({len(hypotheses)}) and references ({len(references)}) "
            "must have the same length"
        )
    total_words = total_ins = total_del = total_sub = 0
    for h, r in zip(hypotheses, references):
        hs = list(h) if use_cer else h.split()
        rs = list(r) if use_cer else r.split()
        total_words += len(rs)
        i, d, s = _edit_ops(hs, rs)
        total_ins += i
        total_del += d
        total_sub += s
    if total_words == 0:
        wer = float("inf") if (total_ins + total_del + total_sub) else 0.0
        return wer, 0, float("nan"), float("nan"), float("nan")
    denom = float(total_words)
    wer = (total_ins + total_del + total_sub) / denom
    return wer, total_words, total_ins / denom, total_del / denom, total_sub / denom


def cer(hypotheses: List[str], references: List[str]) -> float:
    """Corpus character error rate."""
    return word_error_rate_detail(hypotheses, references, use_cer=True)[0]
