"""ctypes binding of the native ARPA reader (``native/arpa_reader.cc``).

Counterpart of the JAX package's ``lm/arpa_native.py``: the library is built
with ``g++`` at first use into ``build/native/`` (linked with ``-lz`` for
gzipped files) by :mod:`..nativelib`, which raises on a failed build.

Layout of :func:`parse_arpa`'s result: an interned vocabulary (token strings,
id = order of first appearance, which for a well-formed ARPA file is unigram
order) and, per n-gram order ``k``, ``(ids [n, k] int32, logp10 [n] f32,
backoff10 [n] f32)``, log10 values as the file stores them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np

from dynamic_asr_eval_tpu_torch import nativelib

# 64-bit LCG over (token id + 1): h = h * MUL + id + 1, from h = INC
HASH_MUL = 6364136223846793005
HASH_INC = 1442695040888963407


def _bind(lib: ctypes.CDLL) -> None:
    lib.arpa_parse.restype = ctypes.c_void_p
    lib.arpa_parse.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.arpa_error.restype = ctypes.c_char_p
    lib.arpa_error.argtypes = [ctypes.c_void_p]
    lib.arpa_order.restype = ctypes.c_int
    lib.arpa_order.argtypes = [ctypes.c_void_p]
    lib.arpa_num_rows.restype = ctypes.c_int64
    lib.arpa_num_rows.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.arpa_vocab_size.restype = ctypes.c_int64
    lib.arpa_vocab_size.argtypes = [ctypes.c_void_p]
    lib.arpa_vocab_bytes.restype = ctypes.c_int64
    lib.arpa_vocab_bytes.argtypes = [ctypes.c_void_p]
    lib.arpa_copy_vocab.restype = None
    lib.arpa_copy_vocab.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.arpa_copy_rows.restype = None
    lib.arpa_copy_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.arpa_free.restype = None
    lib.arpa_free.argtypes = [ctypes.c_void_p]


LIBRARY = nativelib.NativeLibrary(nativelib.NATIVE_DIR / "arpa_reader.cc", _bind, libs=("z",))


def available() -> bool:
    """True when the reader can be built here (a C++ compiler exists); the
    build itself raises if it fails."""
    return nativelib.compiler() is not None


def parse_arpa(
    path: str, max_order: Optional[int] = None
) -> Tuple[List[str], Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]]]:
    """Parse an ARPA file (plain or .gz).  Returns ``(vocab, tables)`` with
    ``tables[k] = (ids [n, k] int32, logp10 [n] f32, backoff10 [n] f32)``.
    Raises ``FileNotFoundError`` on an unreadable file."""
    lib = LIBRARY.load()
    h = lib.arpa_parse(path.encode(), int(max_order or 0))
    if not h:
        raise RuntimeError("arpa_parse returned NULL")
    try:
        err = lib.arpa_error(h)
        if err:
            raise FileNotFoundError(f"{path}: {err.decode()}")
        nv, nb = lib.arpa_vocab_size(h), lib.arpa_vocab_bytes(h)
        vocab: List[str] = []
        if nv:
            buf = ctypes.create_string_buffer(int(nb) + 1)
            lib.arpa_copy_vocab(h, buf)
            vocab = buf.raw[: int(nb)].decode("utf-8", errors="replace").split("\n")
        tables = {}
        for k in range(1, lib.arpa_order(h) + 1):
            n = int(lib.arpa_num_rows(h, k))
            if n == 0:
                continue
            ids = np.empty((n, k), np.int32)
            lp = np.empty((n,), np.float32)
            bo = np.empty((n,), np.float32)
            lib.arpa_copy_rows(h, k, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                               lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               bo.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            tables[k] = (ids, lp, bo)
        return vocab, tables
    finally:
        lib.arpa_free(h)


def hash_rows(ids: np.ndarray) -> np.ndarray:
    """The LCG hash of each id row of ``[n, k]``, uint64 (equal to
    ``ngram._hash_ctx`` of the row)."""
    with np.errstate(over="ignore"):
        h = np.full((ids.shape[0],), HASH_INC, np.uint64)
        for j in range(ids.shape[1]):
            h = h * np.uint64(HASH_MUL) + (ids[:, j].astype(np.uint64) + np.uint64(1))
    return h
