"""Corpus BLEU at sacreBLEU's defaults, for one hypothesis and one reference.

:func:`bleu` gives ``sacrebleu.corpus_bleu([hyp], [[ref]]).score``: the
``13a`` tokenisation (mteval-v13a's), no lowercasing, n-gram orders 1–4
with clipped counts, the brevity penalty against the reference's length,
``exp`` smoothing (an order with no match counts 1 / (2^k · total), k the
number of such orders so far), a score of 0 when no n-gram matches, and the
geometric mean over all four orders (no effective order).  The port keeps
its own copy: ``sacrebleu`` is not a dependency.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import List, Tuple

MAX_ORDER = 4

_13A_RULES = [
    # language-dependent part (assuming Western languages)
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    # period and comma unless preceded by a digit
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
    # period and comma unless followed by a digit
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
    # dash when preceded by a digit
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),
]


def tokenize_13a(line: str) -> str:
    """mteval-v13a's tokenisation, as sacreBLEU's ``13a`` tokenizer applies
    it (to the line with its trailing whitespace stripped)."""
    line = line.rstrip()
    line = line.replace("<skipped>", "").replace("-\n", "").replace("\n", " ")
    if "&" in line:
        line = (line.replace("&quot;", '"').replace("&amp;", "&")
                .replace("&lt;", "<").replace("&gt;", ">"))
    line = f" {line} "
    for pattern, repl in _13A_RULES:
        line = pattern.sub(repl, line)
    return " ".join(line.split())


def _ngrams(line: str) -> Tuple[Counter, int]:
    tokens = line.split()
    grams = Counter(tuple(tokens[i:i + n]) for n in range(1, MAX_ORDER + 1)
                    for i in range(len(tokens) - n + 1))
    return grams, len(tokens)


def bleu(hypothesis: str, reference: str) -> float:
    """BLEU (0–100) of one hypothesis against one reference."""
    hyp, sys_len = _ngrams(tokenize_13a(hypothesis))
    ref, ref_len = _ngrams(tokenize_13a(reference))
    correct: List[int] = [0] * MAX_ORDER
    total: List[int] = [0] * MAX_ORDER
    for gram, count in hyp.items():
        total[len(gram) - 1] += count
        if gram in ref:
            correct[len(gram) - 1] += min(count, ref[gram])
    bp = 1.0
    if sys_len < ref_len:
        bp = math.exp(1 - ref_len / sys_len) if sys_len > 0 else 0.0
    if not any(correct):
        return 0.0
    precisions = [0.0] * MAX_ORDER
    smooth = 1.0
    for n in range(MAX_ORDER):
        if total[n] == 0:
            break
        if correct[n] == 0:
            smooth *= 2
            precisions[n] = 100.0 / (smooth * total[n])
        else:
            precisions[n] = 100.0 * correct[n] / total[n]
    logs = [math.log(p) if p != 0.0 else -9999999999 for p in precisions]
    return bp * math.exp(sum(logs) / MAX_ORDER)
