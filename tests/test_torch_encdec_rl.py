"""The port's encoder-decoder TTA (``tta/encdec_rl.py``, ``tta/filters.py``,
``text/bleu.py``) against the JAX package's, on shared weights.

- ``calc_rewards``: equal to JAX's (whose BLEU is sacrebleu's) within 1e-9
  on generated strings; the port's BLEU alone against
  ``sacrebleu.corpus_bleu`` on text with punctuation, digits and entities;
- ``should_skip_teacher``: the same verdict and reason on cases that trip
  each of the eight filters, and on one that trips none;
- the engine, JAX's updates through ``.lower().compile()`` (tests/conftest.py:
  XLA:CPU can return wrong gradients from the jit fast path), zero-mask SpecAugment on both
  sides (the identity), MADGRAD: ``teacher_ce`` over chunks whose CTC is
  feasible and one whose teacher transcript cannot align to its frames;
  ``teacher_ce`` with the teacher-forced filters skipping chunks (``grpo``
  and ``maxrl``: tests/test_torch_encdec_rl_policy.py).  Transcripts and printed skips equal, adapted weights within 2e-5,
  the decoder's ``pos_enc`` unchanged bit for bit on both sides.

On an infeasible chunk JAX's CTC (a −1e30 floor) gives the port's value,
1e30, and a path-count gradient that overflows at a few hundred frames
(ROADMAP, known behaviours); the port gives no gradient there.  That chunk
is held against JAX with JAX's CTC gradient stopped for such a sample, and
the difference itself is pinned below.
"""

import contextlib
import copy
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

import dynamic_asr_eval_tpu.tta.encdec_rl as jax_rl
import dynamic_asr_eval_tpu.tta.filters as jax_filters
from dynamic_asr_eval_tpu.config import SpecAugmentConfig as JaxSpecAugmentConfig
from dynamic_asr_eval_tpu.config import TTAConfig as JaxTTAConfig
from dynamic_asr_eval_tpu.models.encdec import EncDecConformer as JaxEncDec
from dynamic_asr_eval_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from dynamic_asr_eval_tpu_torch.config import TTAConfig
from dynamic_asr_eval_tpu_torch.models.convert import encdec_params_to_jax
from dynamic_asr_eval_tpu_torch.models.encdec import init_encdec
from dynamic_asr_eval_tpu_torch.ops.ctc import IMPOSSIBLE_LOSS
from dynamic_asr_eval_tpu_torch.ops.ctc import ctc_loss as port_ctc_loss
from dynamic_asr_eval_tpu_torch.text.bleu import bleu
from dynamic_asr_eval_tpu_torch.tta import encdec_rl as port_rl
from dynamic_asr_eval_tpu_torch.tta import filters as port_filters
from test_torch_encdec import CFG, JCFG, jax_variables

torch.set_num_threads(1)

PARAM_TOL = 2e-5
LR = 1e-3
MAX_GENERATE = 8
SEQ = 32  # frames a chunk: T_ds 8
WORDS = ["the", "cat", "sat", "on", "a", "mat", "dog", "ran", "x"]


class IdTokenizer:
    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


# --- rewards and filters ---------------------------------------------------


@settings(max_examples=150, deadline=None)
@given(ref=st.lists(st.sampled_from(WORDS), max_size=10).map(" ".join),
       hyps=st.lists(st.lists(st.sampled_from(WORDS + [" "]), max_size=10).map(" ".join),
                     min_size=1, max_size=4))
def test_calc_rewards_matches_jax(ref, hyps):
    got, want = port_rl.calc_rewards(ref, hyps), jax_rl.calc_rewards(ref, hyps)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert math.isclose(a, b, rel_tol=0, abs_tol=1e-9), (ref, hyps, got, want)


@settings(max_examples=200, deadline=None)
@given(hyp=st.text(alphabet="ab c.,-&;0123", max_size=24),
       ref=st.text(alphabet="ab c.,-&;0123", max_size=24))
def test_bleu_matches_sacrebleu(hyp, ref):
    import sacrebleu

    assert math.isclose(bleu(hyp, ref), sacrebleu.corpus_bleu([hyp], [[ref]]).score,
                        rel_tol=0, abs_tol=1e-9)


# (config overrides, should_skip_teacher arguments): one case per filter,
# and one that trips none
FILTER_CASES = {
    "max_length": (dict(max_length=True), ([1] * 30, "a", 160)),
    "token_repeat": (dict(max_consecutive_token_repeat_enabled=True), ([4, 4, 4, 4, 2], "a", 999)),
    "token_ngram": (dict(repeated_token_ngrams_enabled=True), ([1, 2, 3, 1, 2, 3, 9], "a", 999)),
    "decode_agreement": (dict(decode_agreement_enabled=True),
                         ([1], "the cat sat", 999, "a dog ran far")),
    "low_confidence_prob": (dict(low_confidence_enabled=True), ([1], "a", 999, None, 0.2, 1.0)),
    "low_confidence_entropy": (dict(low_confidence_enabled=True),
                               ([1], "a", 999, None, 0.9, 3.7)),
    "repeated_words": (dict(repeated_words_enabled=True), ([1], "so so so so so no", 999)),
    "ctc_agreement": (dict(ctc_agreement_enabled=True),
                      ([1], "the cat sat on it", 999, None, None, None, "dogs ran far")),
    "none_trips": (dict(max_length=True, max_consecutive_token_repeat_enabled=True,
                        repeated_token_ngrams_enabled=True, decode_agreement_enabled=True,
                        low_confidence_enabled=True, repeated_words_enabled=True,
                        ctc_agreement_enabled=True),
                   ([1, 2, 3], "the cat sat", 999, "the cat sat", 0.9, 0.5, "the cat sat")),
}


@pytest.mark.parametrize("case", sorted(FILTER_CASES))
def test_should_skip_teacher_matches_jax(case):
    overrides, args = FILTER_CASES[case]
    got = port_filters.should_skip_teacher(port_filters.TeacherFilterConfig(**overrides), *args)
    want = jax_filters.should_skip_teacher(jax_filters.TeacherFilterConfig(**overrides), *args)
    assert got == want
    assert got[0] == (case != "none_trips")


def test_teacher_filter_config_from_args_matches_jax():
    import argparse

    from dynamic_asr_eval_tpu_torch.evals.enc_dec_dynamic_eval_test import add_teacher_filter_args

    args = add_teacher_filter_args(argparse.ArgumentParser()).parse_args(
        ["--teacher_filter_max_length", "--teacher_repeated_token_ngram_sizes", "2", "4",
         "--teacher_filter_ctc_agreement", "--teacher_ctc_agreement_min_similarity", "0.7"])
    assert len(vars(args)) == 17
    got = port_filters.TeacherFilterConfig.from_args(args)
    assert vars(got) == vars(jax_filters.TeacherFilterConfig.from_args(args))
    assert got.needs_teacher_forced_pass and not got.needs_agreement_decode


def test_impossible_ctc_alignment_costs_what_jax_gives_without_a_gradient():
    """Four labels (two of them a repeat) over 3 frames: JAX and the port
    both cost 1e30; JAX's floor gives a gradient, the port none."""
    lp = np.log(np.full((1, 3, 5), 0.2, np.float32))
    labels, lens = np.array([[1, 2, 2, 3]]), np.array([4])
    jv, jg = jax.value_and_grad(lambda x: jax_ctc_loss(
        x, jnp.array([3]), jnp.asarray(labels), jnp.asarray(lens), blank_id=4))(jnp.asarray(lp))
    x = torch.tensor(lp, requires_grad=True)
    pv = port_ctc_loss(x, torch.tensor([3]), torch.from_numpy(labels), torch.from_numpy(lens),
                       blank_id=4)
    pv.backward()
    assert np.float32(pv.item()) == np.float32(jv) == np.float32(IMPOSSIBLE_LOSS)
    assert float(np.abs(np.asarray(jg)).max()) > 0 and float(x.grad.abs().max()) == 0


# --- the engine ------------------------------------------------------------


def spec(seed, frames):
    return np.random.default_rng(seed).standard_normal((16, frames)).astype(np.float32)


def port_engine(model, mode, filters=None):
    return port_rl.EncDecDynamicEvalEngine(
        model, CFG, TTAConfig(epochs=1, optim_args={"lr": LR}), filter_config=filters,
        training_mode=mode, max_generate=MAX_GENERATE, device="cpu")


def jax_engine(mode, filters=None):
    return jax_rl.EncDecDynamicEvalEngine(
        JaxEncDec(JCFG), None, JCFG,
        JaxTTAConfig(epochs=1, optim_args={"lr": LR}, spec_augment=JaxSpecAugmentConfig()),
        filter_config=filters, training_mode=mode, max_generate=MAX_GENERATE)


def assert_same_adaptation(port_state, pristine, jax_params, variables):
    got = jax.tree_util.tree_leaves_with_path(encdec_params_to_jax(port_state)["params"])
    want = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jax_params)))
    err = max(float(np.abs(leaf - want[path]).max()) for path, leaf in got)
    assert err < PARAM_TOL, err
    moved = max(float((port_state[k] - v).abs().max()) for k, v in pristine.items())
    assert moved > 10 * PARAM_TOL, moved
    assert torch.equal(port_state["pos_enc.weight"], pristine["pos_enc.weight"])
    np.testing.assert_array_equal(
        np.asarray(jax_params["language_model_decoder"]["pos_enc"]["embedding"]),
        np.asarray(variables["params"]["language_model_decoder"]["pos_enc"]["embedding"]))


@contextlib.contextmanager
def feasibility_log(monkeypatch):
    """Each CTC term of the port's updates: True where its alignment is
    feasible; JAX's CTC gradient stopped where it is not (the port's
    semantics; module docstring)."""
    log = []

    def port_ctc(*args, **kwargs):
        value = port_ctc_loss(*args, **kwargs)
        log.append(value.item() < IMPOSSIBLE_LOSS)
        return value

    def jax_ctc(*args, **kwargs):
        value = jax_ctc_loss(*args, **kwargs)
        return jnp.where(value >= IMPOSSIBLE_LOSS, jax.lax.stop_gradient(value), value)

    monkeypatch.setattr(port_rl, "ctc_loss", port_ctc)
    monkeypatch.setattr(jax_rl, "ctc_loss", jax_ctc)
    yield log


def compiled_updates(monkeypatch):
    """JAX's update functions (value_and_grad and the optimizer step) go
    through ``.lower().compile()`` rather than the jit fast path
    (tests/conftest.py: XLA:CPU in this image can return wrong gradients
    from large executables dispatched by jit; the compiled path and eager
    agree with torch), one executable per argument shape; its generation
    runs as it is."""
    build, jit = jax_rl.EncDecDynamicEvalEngine._get_update_fn, jax.jit

    def aot(fn):
        jitted, executables = jit(fn), {}

        def call(*args):
            key = str([(np.shape(x), np.result_type(x)) for x in jax.tree.leaves(args)])
            if key not in executables:
                executables[key] = jitted.lower(*args).compile()
            return executables[key](*args)
        return call

    def compiled(self, kind):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax, "jit", aot)
            return build(self, kind)

    monkeypatch.setattr(jax_rl.EncDecDynamicEvalEngine, "_get_update_fn", compiled)


def run_both(mode, recording, monkeypatch, seed=3, filters=None):
    """({"port" / "jax": (transcript, adapted weights, seconds), "port_printed"
    / "jax_printed": printed lines}, pristine state, JAX variables)."""
    compiled_updates(monkeypatch)
    model = init_encdec(CFG, seed=seed).eval()
    variables = jax_variables(model)
    pristine = copy.deepcopy(model.state_dict())
    out = {}
    for side in ("jax", "port"):
        with contextlib.redirect_stdout(_Lines()) as lines:
            if side == "jax":
                jf = None if filters is None else jax_filters.TeacherFilterConfig(**filters)
                out[side] = jax_engine(mode, jf)(variables, recording, SEQ, IdTokenizer(),
                                                 return_params=True)
            else:
                pf = None if filters is None else port_filters.TeacherFilterConfig(**filters)
                out[side] = port_engine(model, mode, pf)(None, recording, SEQ, IdTokenizer(),
                                                         return_params=True)
        out[side + "_printed"] = lines.lines
    return out, pristine, variables


class _Lines:
    def __init__(self):
        self.lines, self._buf = [], ""

    def write(self, s):
        self._buf += s
        *done, self._buf = self._buf.split("\n")
        self.lines += done

    def flush(self):
        pass


def test_teacher_ce_engine_matches_jax_with_an_infeasible_chunk(monkeypatch):
    """A chunk of 32 frames (T_ds 8) and a last one of 8 (T_ds 2), where a
    teacher of up to 7 tokens cannot align; on this recording the first
    chunk's teacher aligns (the check below says so)."""
    recording = spec(4, SEQ + 8)
    with feasibility_log(monkeypatch) as feasible:
        out, pristine, variables = run_both("teacher_ce", recording, monkeypatch)
    assert True in feasible and False in feasible, feasible
    (transcript, adapted, _), (jt, jparams, _) = out["port"], out["jax"]
    assert transcript == jt and transcript
    assert_same_adaptation(adapted, pristine, jparams, variables)


def test_teacher_ce_engine_skips_what_jax_skips(monkeypatch):
    """The teacher-forced filters (confidence, CTC agreement) at thresholds
    that veto some chunks: the same ``Skipping teacher update`` lines, the
    same adaptation of the others."""
    filters = dict(low_confidence_enabled=True, min_mean_max_prob=0.175, max_mean_entropy=9.0,
                   ctc_agreement_enabled=True, ctc_agreement_min_similarity=0.0,
                   repeated_words_enabled=True, max_consecutive_word_repeat=4)
    with feasibility_log(monkeypatch):
        out, pristine, variables = run_both("teacher_ce", spec(2, 4 * SEQ), monkeypatch, filters=filters)
    skips = [line for line in out["port_printed"] if line.startswith("Skipping teacher update")]
    assert skips == [line for line in out["jax_printed"]
                     if line.startswith("Skipping teacher update")]
    assert 0 < len(skips) < 4, out["port_printed"]
    (transcript, adapted, _), (jt, jparams, _) = out["port"], out["jax"]
    assert transcript == jt
    assert_same_adaptation(adapted, pristine, jparams, variables)
