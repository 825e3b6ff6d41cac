"""The port's NSTI engine against the JAX package's ``DynamicEvalEngine``.

Tiny config (as in test_torch_conformer.py), shared weights via
``params_from_jax``, a 700-frame recording in 256-frame windows with 128
overlap (5 windows, the last one ragged at 188 frames), 2 epochs,
augmentation off (the zero-mask config, the identity on both sides), online
and offline (offline shuffles the window order from the same numpy generator
on both sides).  The parity tests run with ``subsampling_impl="conv"`` and
with ``"pallas"`` (the JAX side runs its fused Pallas kernel in interpret
mode; the last, 188-frame window exercises its unmasked ragged edge on both
sides).  Bars: stitched log-probs within 1e-4; adapted parameters, through
``convert_lcasr_checkpoint``, within 2e-5 (they move by ~2e-2 over the run).
With ``lm_tta_beams=3`` and the same n-gram tables on both sides, the
pseudo-labels of every window are equal too (the LM-fused beam search,
online, "conv").

The JAX CTC recursion is ``lax.scan(..., unroll=16)``; XLA:CPU takes ~40 s
to compile its gradient unrolled and under a second rolled.  The JAX engines
here run with ``unroll`` dropped (the same operations in the same order,
one step per loop iteration); the JAX CTC's trace cache is emptied before
and after, so no other test sees the rolled trace.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dynamic_asr_eval_tpu.ops.ctc as jax_ctc
from dynamic_asr_eval_tpu.config import TTAConfig as JaxTTAConfig
from dynamic_asr_eval_tpu.models import ConformerConfig as JaxConfig
from dynamic_asr_eval_tpu.models import init_conformer as jax_init
from dynamic_asr_eval_tpu.models.convert import convert_lcasr_checkpoint
from dynamic_asr_eval_tpu.tta import DynamicEvalEngine as JaxEngine
from dynamic_asr_eval_tpu_torch.config import TTAConfig
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, SCConformer, params_from_jax
from dynamic_asr_eval_tpu_torch.tta import DynamicEvalEngine

torch.set_num_threads(1)

TINY = dict(feat_in=32, n_layers=2, d_model=64, n_heads=2, head_dim=32, vocab_size=30,
            subsampling_factor=8, subsampling_conv_channels=16, conv_kernel_size=5,
            attention_impl="pallas_flash")
SEQ, OVERLAP, LR, EPOCHS = 256, 128, 1e-3, 2


def _tta(online):
    return dict(seq_len=SEQ, overlap=OVERLAP, epochs=EPOCHS, online=online,
                shuffle=not online, lm_tta_beams=0, optim_args={"lr": LR})


@contextlib.contextmanager
def rolled_scans():
    scan = jax.lax.scan
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.lax, "scan", lambda *a, unroll=1, **kw: scan(*a, **kw))
    jax_ctc.ctc_loss.clear_cache()
    try:
        yield
    finally:
        mp.undo()
        jax_ctc.ctc_loss.clear_cache()


def _setup(impl):
    cfg = dict(TINY, subsampling_impl=impl)
    jcfg = JaxConfig(compute_dtype=jnp.float32, **cfg)
    model, variables = jax_init(jcfg, jax.random.PRNGKey(0), example_T=256)
    state = params_from_jax(jax.tree.map(np.asarray, variables["params"]))
    port = SCConformer(ConformerConfig(compute_dtype="float32", **cfg))
    port.load_state_dict(state)
    spec = np.random.default_rng(1).standard_normal((TINY["feat_in"], 700)).astype(np.float32)
    return {"jax": (jcfg, model, variables), "state": state, "port_model": port, "spec": spec}


@pytest.fixture(scope="module")
def shared():
    return _setup("conv")


@pytest.fixture(scope="module", params=["conv", "pallas"])
def runs(request):
    shared = _setup(request.param)
    jcfg, model, variables = shared["jax"]
    state, port, spec = shared["state"], shared["port_model"], shared["spec"]
    out = {}
    for mode, online in (("online", True), ("offline", False)):
        with rolled_scans():
            j = JaxEngine(model, jcfg.blank_id, 8, JaxTTAConfig(**_tta(online)))(
                variables, spec, return_params=True, shuffle_rng=np.random.default_rng(5))
        p = DynamicEvalEngine(port, jcfg.blank_id, 8, TTAConfig(**_tta(online)), device="cpu")(
            state, spec, return_params=True, shuffle_rng=np.random.default_rng(5))
        out[mode] = (j, p)
    out["initial"] = variables["params"]
    return out


@pytest.mark.parametrize("mode", ["online", "offline"])
def test_stitched_log_probs_match(runs, mode):
    j, p = runs[mode]
    a, b = j.numpy_logits(), p.numpy_logits()
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(p.counts.numpy(), np.asarray(j.counts))


@pytest.mark.parametrize("mode", ["online", "offline"])
def test_adapted_parameters_match(runs, mode):
    j, p = runs[mode]
    back, unmatched = convert_lcasr_checkpoint({k: v.numpy() for k, v in p.params.items()})
    assert unmatched == []
    ref = dict(jax.tree_util.tree_leaves_with_path(j.params))
    init = dict(jax.tree_util.tree_leaves_with_path(runs["initial"]))
    moved = 0.0
    for path, leaf in jax.tree_util.tree_leaves_with_path(back["params"]):
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(ref[path]), rtol=0, atol=2e-5)
        moved = max(moved, float(np.abs(np.asarray(ref[path]) - np.asarray(init[path])).max()))
    assert moved > 1e-3  # the bar is meaningful: adaptation moved the weights


@pytest.mark.parametrize("mode", ["online", "offline"])
def test_greedy_ids_match(runs, mode):
    j, p = runs[mode]
    np.testing.assert_array_equal(p.greedy_ids(), j.greedy_ids())


def test_callers_weights_are_not_modified(shared):
    runs = shared
    state = runs["state"]
    before = {k: v.clone() for k, v in state.items()}
    eng = DynamicEvalEngine(runs["port_model"], TINY["vocab_size"], 8,
                            TTAConfig(**_tta(True)), device="cpu")
    out = eng(state, runs["spec"], return_params=True)
    for k in state:
        assert torch.equal(state[k], before[k]), k
    assert any(not torch.equal(out.params[k], before[k]) for k in state)


def test_augment_fn_hook_receives_each_adapted_window(shared):
    runs = shared
    seen = []

    def augment(batch, gen, actual_len):
        seen.append((tuple(batch.shape), int(actual_len)))
        return batch

    eng = DynamicEvalEngine(runs["port_model"], TINY["vocab_size"], 8,
                            TTAConfig(**_tta(True)), augment_fn=augment, device="cpu")
    eng(runs["state"], runs["spec"])
    assert seen == [((1, TINY["feat_in"], SEQ), n) for n in (256, 256, 256, 256, 188)] * EPOCHS


def test_epochs_zero_is_plain_chunked_inference(shared):
    runs = shared
    eng = DynamicEvalEngine(runs["port_model"], TINY["vocab_size"], 8,
                            TTAConfig(seq_len=SEQ, overlap=OVERLAP, epochs=0), device="cpu")
    a = eng(runs["state"], runs["spec"]).numpy_logits()
    eng1 = DynamicEvalEngine(runs["port_model"], TINY["vocab_size"], 8,
                             TTAConfig(seq_len=SEQ, overlap=OVERLAP, epochs=0),
                             infer_batch=1, device="cpu")
    np.testing.assert_allclose(eng1(runs["state"], runs["spec"]).numpy_logits(), a,
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# lm_tta_beams: LM-fused pseudo-labels from an n-gram LM
# ---------------------------------------------------------------------------

LM_BEAM_KWARGS = {"alpha": 0.45, "beta": 1.53, "prune_less_than_val": 3.17,
                  "top_am_threshold": -6.0}


def _lm_tables(vocab, seed=3):
    from dynamic_asr_eval_tpu_torch.lm.ngram import _hash_ctx

    rng = np.random.default_rng(seed)
    tables = {1: (np.array([_hash_ctx([v]) for v in range(vocab)], np.uint64),
                  rng.uniform(-4, -1, vocab).astype(np.float32),
                  rng.uniform(-1, 0, vocab).astype(np.float32))}
    for k in (2, 3):
        grams = sorted({tuple(rng.integers(0, vocab, k).tolist()) for _ in range(150)})
        tables[k] = (np.array([_hash_ctx(g) for g in grams], np.uint64),
                     rng.uniform(-2, 0, len(grams)).astype(np.float32),
                     (rng.uniform(-1, 0, len(grams)) if k == 2
                      else np.zeros(len(grams))).astype(np.float32))
    return tables


def _recording(engine, record):
    """Wrap the engine's ``_pseudo_labels`` so that each window's labels
    reach ``record``: JAX's through an ordered debug callback, the port's
    beside its greedy labels of the same window."""
    from dynamic_asr_eval_tpu_torch.ops.ctc import greedy_labels

    inner = engine._pseudo_labels
    if isinstance(engine, JaxEngine):
        def wrapped(clean_lp, ds_len, max_tokens):
            labels, lab_len = inner(clean_lp, ds_len, max_tokens)
            jax.debug.callback(lambda l, n: record.append(np.asarray(l)[: int(n)].tolist()),
                               labels, lab_len, ordered=True)
            return labels, lab_len
    else:
        def wrapped(clean_lp, ds_len, max_tokens):
            labels, lab_len = inner(clean_lp, ds_len, max_tokens)
            greedy, n = greedy_labels(clean_lp, ds_len, engine.blank_id, max_tokens)
            record.append((labels[: int(lab_len)].tolist(), greedy[: int(n)].tolist()))
            return labels, lab_len
    engine._pseudo_labels = wrapped


@pytest.fixture(scope="module")
def lm_runs():
    from dynamic_asr_eval_tpu.lm.ngram import NGramLM as JaxNGramLM
    from dynamic_asr_eval_tpu.ops.beam_search import NGramAdapter as JaxNGramAdapter
    from dynamic_asr_eval_tpu_torch.lm.ngram import NGramLM
    from dynamic_asr_eval_tpu_torch.ops.beam_search import NGramAdapter

    shared = _setup("conv")
    jcfg, model, variables = shared["jax"]
    tables = _lm_tables(TINY["vocab_size"])
    tta = dict(_tta(True), lm_tta_beams=3)
    jax_labels, port_labels = [], []
    j_engine = JaxEngine(model, jcfg.blank_id, 8, JaxTTAConfig(**tta),
                         lm_adapter=JaxNGramAdapter(JaxNGramLM(3, tables, TINY["vocab_size"]),
                                                    bos_id=0),
                         lm_beam_kwargs=LM_BEAM_KWARGS)
    _recording(j_engine, jax_labels)
    with rolled_scans():
        j = j_engine(variables, shared["spec"], return_params=True)
        jax.effects_barrier()
    p_engine = DynamicEvalEngine(
        shared["port_model"], jcfg.blank_id, 8, TTAConfig(**tta),
        lm_adapter=NGramAdapter(NGramLM(3, tables, TINY["vocab_size"], device="cpu"), bos_id=0),
        lm_beam_kwargs=LM_BEAM_KWARGS, device="cpu")
    _recording(p_engine, port_labels)
    p = p_engine(shared["state"], shared["spec"], return_params=True)
    return j, p, jax_labels, port_labels, variables["params"]


def test_lm_pseudo_labels_equal_jax_in_every_window(lm_runs):
    _, _, jax_labels, port_labels, _ = lm_runs
    assert len(port_labels) == EPOCHS * 5
    assert [beam for beam, _ in port_labels] == jax_labels
    # the LM mattered: in some window the beam's labels are not the greedy ones
    assert any(beam != greedy for beam, greedy in port_labels)


def test_lm_pseudo_labels_stitched_log_probs_match(lm_runs):
    j, p, *_ = lm_runs
    np.testing.assert_allclose(p.numpy_logits(), j.numpy_logits(), rtol=0, atol=1e-4)


def test_lm_pseudo_labels_adapted_parameters_match(lm_runs):
    j, p, _, _, initial = lm_runs
    back, _ = convert_lcasr_checkpoint({k: v.numpy() for k, v in p.params.items()})
    ref = dict(jax.tree_util.tree_leaves_with_path(j.params))
    init = dict(jax.tree_util.tree_leaves_with_path(initial))
    moved = 0.0
    for path, leaf in jax.tree_util.tree_leaves_with_path(back["params"]):
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(ref[path]), rtol=0, atol=2e-5)
        moved = max(moved, float(np.abs(np.asarray(ref[path]) - np.asarray(init[path])).max()))
    assert moved > 1e-3
