"""Word / character error rate with insertion/deletion/substitution detail.

Counterpart of the JAX package's ``text/wer.py``: corpus-wide edit counts
over the total number of reference words; ties prefer substitution, then
deletion, then insertion.  The alignment runs in C (``native/levenshtein.cc``,
built by :mod:`..nativelib`, tokens interned to int32 ids here); a failed
build raises.  :func:`_edit_ops` is the pure-Python DP the native path is
held against.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np

from dynamic_asr_eval_tpu_torch.nativelib import NATIVE_DIR, NativeLibrary

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _bind(lib: ctypes.CDLL) -> None:
    lib.lev_edit_ops.restype = ctypes.c_int64
    lib.lev_edit_ops.argtypes = [_I32P, ctypes.c_int64, _I32P, ctypes.c_int64, _I64P]
    lib.lev_edit_ops_batch.restype = None
    lib.lev_edit_ops_batch.argtypes = [_I32P, _I64P, _I32P, _I64P, ctypes.c_int64, _I64P]


LIBRARY = NativeLibrary(NATIVE_DIR / "levenshtein.cc", _bind)


def _edit_ops(hyp: Sequence, ref: Sequence) -> Tuple[int, int, int]:
    """(insertions, deletions, substitutions) of the minimal-cost alignment
    transforming ``ref`` into ``hyp``: the plain reference of the native
    path."""
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


def _intern(seqs: List[Sequence], table: dict) -> Tuple[np.ndarray, np.ndarray]:
    """Token sequences → packed int32 ids and per-sequence lengths."""
    lens = np.array([len(s) for s in seqs], np.int64)
    flat = np.fromiter((table.setdefault(tok, len(table)) for s in seqs for tok in s),
                       np.int32, count=int(lens.sum()))
    return flat, lens


def _native_counts(hyp_seqs: List[Sequence], ref_seqs: List[Sequence]) -> np.ndarray:
    """``(ins, del, sub, ref_tokens)`` summed over the pairs, in C."""
    table: dict = {}
    hflat, hlens = _intern(hyp_seqs, table)
    rflat, rlens = _intern(ref_seqs, table)
    out = np.zeros(4, np.int64)
    LIBRARY.load().lev_edit_ops_batch(
        hflat.ctypes.data_as(_I32P), hlens.ctypes.data_as(_I64P),
        rflat.ctypes.data_as(_I32P), rlens.ctypes.data_as(_I64P),
        len(hyp_seqs), out.ctypes.data_as(_I64P))
    return out


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
    split = list if use_cer else str.split
    total_ins, total_del, total_sub, total_words = (int(v) for v in _native_counts(
        [split(h) for h in hypotheses], [split(r) for r in references]))
    if total_words == 0:
        wer = float("inf") if (total_ins + total_del + total_sub) else 0.0
        return wer, 0, float("nan"), float("nan"), float("nan")
    denom = float(total_words)
    wer = (total_ins + total_del + total_sub) / denom
    return wer, total_words, total_ins / denom, total_del / denom, total_sub / denom


def wer_counts(hypothesis: str, reference: str) -> np.ndarray:
    """Per-pair ``(ins, del, sub, ref_words)``: summed over records they give
    :func:`word_error_rate_detail`'s counts."""
    h, r = hypothesis.split(), reference.split()
    table: dict = {}
    (hflat, _), (rflat, _) = _intern([h], table), _intern([r], table)
    ops = np.zeros(3, np.int64)
    LIBRARY.load().lev_edit_ops(hflat.ctypes.data_as(_I32P), len(h),
                                rflat.ctypes.data_as(_I32P), len(r), ops.ctypes.data_as(_I64P))
    return np.array([*ops, len(r)], np.int64)


def cer(hypotheses: List[str], references: List[str]) -> float:
    """Corpus character error rate."""
    return word_error_rate_detail(hypotheses, references, use_cer=True)[0]
