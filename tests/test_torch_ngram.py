"""The port's n-gram LM (``lm/ngram.py``, ``lm/arpa_native.py``) against the
JAX package's: hashes bit for bit (the port's one wrapping int64 against
JAX's uint32 pairs, every token id up to 4095 and long chains that carry),
the native reader's rows, the tables of both loaders, and ``score_next``
within 1e-6 on a random 4-gram ARPA file."""

import gzip
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dynamic_asr_eval_tpu.lm import arpa_native as jax_native
from dynamic_asr_eval_tpu.lm.ngram import NGramLM as JaxNGramLM
from dynamic_asr_eval_tpu.lm.ngram import _hash_ctx as jax_hash_ctx
from dynamic_asr_eval_tpu.lm.ngram import load_arpa as jax_load_arpa
from dynamic_asr_eval_tpu.ops.beam_search import _roll_hash as jax_roll_hash
from dynamic_asr_eval_tpu_torch.lm import arpa_native
from dynamic_asr_eval_tpu_torch.lm.ngram import NGramLM, _hash_ctx, load_arpa, roll_hash

torch.set_num_threads(1)

TOY = """\
\\data\\
ngram 1=5
ngram 2=4
ngram 3=2

\\1-grams:
-1.0\t<s>\t-0.30103
-1.2\tthe\t-0.2
-1.5\tcat\t-0.1
-1.7\tsat\t-0.15
-2.0\t</s>

\\2-grams:
-0.5\t<s> the\t-0.05
-0.4\tthe cat\t-0.02
-0.6\tcat sat\t-0.01
-0.9\tsat </s>

\\3-grams:
-0.2\t<s> the cat
-0.3\tthe cat sat

\\end\\
"""
TOY_IDS = {"<s>": 0, "the": 1, "cat": 2, "sat": 3, "</s>": 4}


def random_arpa(path, pieces=tuple(f"p{i}" for i in range(40)), order=4,
                counts=(0, 150, 150, 120), seed=0):
    """A token-level ARPA file over ``pieces`` (every one a unigram) with
    random log10 probabilities and backoffs (the highest order has none);
    returns ``{piece: index}``."""
    rng = np.random.default_rng(seed)
    pieces = list(pieces)
    grams = {1: [(p,) for p in pieces]}
    for k in range(2, order + 1):
        grams[k] = sorted({tuple(rng.choice(pieces, k)) for _ in range(counts[k - 1])})
    lines = ["\\data\\"] + [f"ngram {k}={len(grams[k])}" for k in grams]
    for k in grams:
        lines += ["", f"\\{k}-grams:"]
        for g in grams[k]:
            row = f"{rng.uniform(-3, -0.2):.5f}\t{' '.join(g)}"
            lines.append(row + (f"\t{rng.uniform(-1, 0):.5f}" if k < order else ""))
    lines += ["", "\\end\\", ""]
    path.write_text("\n".join(lines))
    return {p: i for i, p in enumerate(pieces)}


@pytest.fixture(scope="module")
def arpa_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("arpa")
    toy, gz = d / "toy.arpa", d / "toy.arpa.gz"
    toy.write_text(TOY)
    with gzip.open(gz, "wt") as f:
        f.write(TOY)
    rand = d / "random.arpa"
    ids = random_arpa(rand)
    return {"toy": str(toy), "gz": str(gz), "random": str(rand), "random_ids": ids}


# ---------------------------------------------------------------------------
# hashes
# ---------------------------------------------------------------------------


def test_hash_ctx_equals_jax_for_every_token_id():
    for t in range(4096):
        assert _hash_ctx([t]) == jax_hash_ctx([t])
    rng = np.random.default_rng(0)
    for n in range(1, 9):
        seq = rng.integers(0, 4096, n).tolist()
        assert _hash_ctx(seq) == jax_hash_ctx(seq)


@pytest.mark.parametrize("length", [1, 2, 3, 6])
def test_roll_hash_is_bit_equal_to_jax_uint32_pairs(length):
    """Every token id 0..4095 (and -1, the context padding) at the end of
    random prefixes: the int64 bits equal JAX's (hi, lo) halves, which
    exercises the carry out of the low half on many rows."""
    rng = np.random.default_rng(length)
    toks = np.concatenate([np.arange(-1, 4096), rng.integers(0, 4096, 3000)])
    prefix = rng.integers(-1, 4096, (toks.size, length - 1))
    h = torch.full((toks.size,), arpa_native.HASH_INC, dtype=torch.int64)
    hi = jnp.full((toks.size,), np.uint32(arpa_native.HASH_INC >> 32))
    lo = jnp.full((toks.size,), np.uint32(arpa_native.HASH_INC & 0xFFFFFFFF))
    cols = list(prefix.T) + [toks]
    carries = 0
    for col in cols:
        h = roll_hash(h, torch.from_numpy(col))
        lo_before = np.asarray(lo)
        hi, lo = jax_roll_hash(hi, lo, jnp.asarray(col, jnp.int32))
        carries += int(np.sum(np.asarray(lo) < lo_before))
    ours = h.numpy().view(np.uint64)
    theirs = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)
    np.testing.assert_array_equal(ours, theirs)
    assert carries > 0


def test_hash_rows_equals_jax():
    ids = np.random.default_rng(1).integers(0, 5000, size=(256, 4)).astype(np.int64)
    np.testing.assert_array_equal(arpa_native.hash_rows(ids), jax_native.hash_rows(ids))
    for row in ids[:16]:
        assert int(arpa_native.hash_rows(row[None])[0]) == _hash_ctx(row.tolist())


# ---------------------------------------------------------------------------
# the native reader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["toy", "gz", "random"])
def test_parse_arpa_equals_jax(arpa_files, which):
    v1, t1 = arpa_native.parse_arpa(arpa_files[which])
    v2, t2 = jax_native.parse_arpa(arpa_files[which])
    assert v1 == v2 and set(t1) == set(t2)
    for k in t1:
        for a, b in zip(t1[k], t2[k]):
            np.testing.assert_array_equal(a, b)


def test_parse_arpa_max_order_and_missing_file(arpa_files):
    _, tables = arpa_native.parse_arpa(arpa_files["toy"], max_order=2)
    assert set(tables) == {1, 2}
    with pytest.raises(FileNotFoundError):
        arpa_native.parse_arpa("/nonexistent/nope.arpa")


def test_load_arpa_raises_when_the_reader_cannot_be_built(arpa_files, tmp_path, monkeypatch):
    """The default reader is the native one: without a compiler (and nothing
    built yet) the load raises instead of parsing in Python."""
    from dynamic_asr_eval_tpu_torch import nativelib

    lib = nativelib.NativeLibrary(arpa_native.LIBRARY.source, arpa_native._bind, libs=("z",),
                                  build_dir=tmp_path)
    monkeypatch.setattr(arpa_native, "LIBRARY", lib)
    monkeypatch.setattr(nativelib, "compiler", lambda: None)
    ids = arpa_files["random_ids"]
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        load_arpa(arpa_files["random"], ids, len(ids), device="cpu")
    assert load_arpa(arpa_files["random"], ids, len(ids), use_native=False,
                     device="cpu").reader == "python"


# ---------------------------------------------------------------------------
# tables and scores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_native", [True, False])
def test_tables_equal_jax(arpa_files, use_native):
    ids = arpa_files["random_ids"]
    ours = load_arpa(arpa_files["random"], ids, len(ids), use_native=use_native, device="cpu")
    theirs = jax_load_arpa(arpa_files["random"], ids, len(ids), use_native=use_native)
    assert ours.order == theirs.order == 4
    assert ours.reader == ("native" if use_native else "python")
    for k in range(1, 5):
        keys = ours.keys[k].numpy().view(np.uint64)
        jkeys = ((np.asarray(theirs.keys_hi[k]).astype(np.uint64) << np.uint64(32))
                 | np.asarray(theirs.keys_lo[k]).astype(np.uint64))
        order = np.argsort(jkeys, kind="stable")  # JAX sorts unsigned, the port signed
        by_key = {int(kk): (lp, bo) for kk, lp, bo in zip(
            jkeys[order], np.asarray(theirs.logp[k])[order], np.asarray(theirs.backoff[k])[order])}
        assert set(keys.tolist()) == set(by_key)
        for kk, lp, bo in zip(keys.tolist(), ours.logp[k].numpy(), ours.backoff[k].numpy()):
            assert (lp, bo) == by_key[kk]


def test_native_and_python_loaders_agree(arpa_files):
    ids = arpa_files["random_ids"]
    a = load_arpa(arpa_files["random"], ids, len(ids), use_native=True, device="cpu")
    b = load_arpa(arpa_files["random"], ids, len(ids), use_native=False, device="cpu")
    for k in range(1, 5):
        assert torch.equal(a.keys[k], b.keys[k])
        np.testing.assert_allclose(a.logp[k].numpy(), b.logp[k].numpy(), rtol=1e-6)
        np.testing.assert_allclose(a.backoff[k].numpy(), b.backoff[k].numpy(), rtol=1e-6)


@pytest.mark.parametrize("use_native", [True, False])
def test_score_next_within_1e6_of_jax(arpa_files, use_native):
    ids = arpa_files["random_ids"]
    V = len(ids)
    ours = load_arpa(arpa_files["random"], ids, V, use_native=use_native, device="cpu")
    theirs = jax_load_arpa(arpa_files["random"], ids, V, use_native=use_native)
    rng = np.random.default_rng(3)
    # contexts of every length 0..3, from seen n-grams (backoff chains hit) and random ids
    _, raw = arpa_native.parse_arpa(arpa_files["random"])
    seen = raw[4][0][:, :3].astype(np.int64)[:24]
    ctx = np.concatenate([seen, rng.integers(0, V, (24, 3))])
    lens = np.concatenate([np.full(24, 3), rng.integers(0, 4, 24)])
    ctx = np.where(np.arange(3)[None] >= 3 - lens[:, None], ctx, -1)
    got = ours.score_next(torch.from_numpy(ctx), torch.from_numpy(lens)).numpy()
    want = np.asarray(theirs.score_next(jnp.asarray(ctx, jnp.int32), jnp.asarray(lens, jnp.int32)))
    assert got.shape == (48, V)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got > -19).mean() > 0.99  # the tokens are in the tables, not unknown


def test_toy_scores_match_jax_and_the_arpa_values(arpa_files):
    ours = load_arpa(arpa_files["gz"], TOY_IDS, 5, device="cpu")
    theirs = jax_load_arpa(arpa_files["toy"], TOY_IDS, 5)
    ctx, lens = np.array([[0, 1], [-1, 2]]), np.array([2, 1])  # "<s> the", "cat"
    got = ours.score_next(torch.from_numpy(ctx), torch.from_numpy(lens)).numpy()
    want = np.asarray(theirs.score_next(jnp.asarray(ctx, jnp.int32), jnp.asarray(lens, jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[0, 2] == pytest.approx(-0.2 * math.log(10), abs=1e-5)  # seen trigram
    assert got[1, 1] == pytest.approx((-1.2 - 0.1) * math.log(10), abs=1e-5)  # backoff


def _tables(V, keys_extra=()):
    keys = np.array([_hash_ctx([v]) for v in range(V)] + list(keys_extra), np.uint64)
    logp = np.arange(keys.size, dtype=np.float32) * -0.1 - 0.1
    return {1: (keys, logp, np.zeros_like(logp))}


def test_a_long_run_of_equal_high_halves_is_found():
    """Twenty keys sharing their high 32 bits (a probe of 8 in the JAX
    package's scheme would need widening): the exact 64-bit search finds
    the last of them, as JAX does."""
    hi = np.uint64(0xDEADBEEF) << np.uint64(32)
    run = [int(hi | np.uint64(lo)) for lo in range(100, 120)]
    tables = _tables(5, run)
    ours, theirs = NGramLM(1, tables, 40, device="cpu"), JaxNGramLM(1, tables, 40)
    q = np.uint64(run[-1])
    found, lp, _ = ours._lookup(1, torch.from_numpy(np.array([q]).view(np.int64)))
    jfound, jlp, _ = theirs._lookup(1, jnp.asarray([np.uint32(q >> np.uint64(32))]),
                                   jnp.asarray([np.uint32(q & np.uint64(0xFFFFFFFF))]))
    assert bool(found[0]) and bool(jfound[0])
    assert float(lp[0]) == float(jlp[0])


def test_duplicate_keys_resolve_to_the_first_in_file_order():
    keys = np.array([_hash_ctx([1]), _hash_ctx([2]), _hash_ctx([1])], np.uint64)
    tables = {1: (keys, np.array([-1.0, -2.0, -3.0], np.float32), np.zeros(3, np.float32))}
    ours, theirs = NGramLM(1, tables, 3, device="cpu"), JaxNGramLM(1, tables, 3)
    got = ours.score_next(torch.full((1, 1), -1), torch.zeros(1, dtype=torch.int64)).numpy()
    want = np.asarray(theirs.score_next(jnp.full((1, 1), -1, jnp.int32), jnp.zeros(1, jnp.int32)))
    np.testing.assert_array_equal(got, want)
    assert got[0, 1] == -1.0


def test_empty_context_uses_unigrams_and_unknown_ids_get_unk():
    lm = NGramLM(1, _tables(4), 6, device="cpu")
    got = lm.score_next(torch.full((1, 1), -1), torch.zeros(1, dtype=torch.int64))[0]
    np.testing.assert_allclose(got[:4].numpy(), [-0.1, -0.2, -0.3, -0.4], rtol=1e-6)
    assert got[4:].tolist() == [-20.0, -20.0]


def test_dropping_most_ngrams_warns(arpa_files):
    few = {"<s>": 0, "the": 1, "cat": 2, "</s>": 4}
    with pytest.warns(UserWarning, match="WORD-level"):
        ours = load_arpa(arpa_files["toy"], few, 5, warn_drop_fraction=0.1, device="cpu")
    with pytest.warns(UserWarning):
        theirs = jax_load_arpa(arpa_files["toy"], few, 5, warn_drop_fraction=0.1)
    for k in theirs.logp:
        assert ours.keys[k].numel() == theirs.keys_hi[k].shape[0]


def test_tables_sit_on_the_asked_device_and_count_their_bytes(arpa_files):
    lm = load_arpa(arpa_files["toy"], TOY_IDS, 5, device="cpu")
    assert all(t.device.type == "cpu" for t in lm.keys.values())
    assert lm.table_bytes() == (5 + 4 + 2) * (8 + 4 + 4)
