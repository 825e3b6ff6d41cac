"""The port's AWMC engine against the JAX package's ``AWMCEngine``.

Tiny f32 config (as tests/test_torch_engine.py), shared weights via
``params_from_jax``, a 534-frame recording in 256-frame windows with 128
overlap (4 windows, the last one ragged at 150 frames).  The JAX engine
calls its augmentation pipeline directly, so masks cannot be injected:
augmentation is off on both sides (the zero-mask config, the identity).
Cases: epochs 1 and 2, the leader's num-updates cap on and off, and a
blank-biased head whose label banks are empty (the banks weigh 0, so the
weights stay put).  Bars: stitched log-probs within 1e-4, adapted weights
(through ``convert_lcasr_checkpoint``) within 2e-5, greedy ids equal.  The
JAX engine runs jitted with the CTC scan's ``unroll`` dropped, as in
tests/test_torch_engine.py.
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
from dynamic_asr_eval_tpu.optim.ema import ema_init as jax_ema_init
from dynamic_asr_eval_tpu.optim.ema import ema_update as jax_ema_update
from dynamic_asr_eval_tpu.tta import AWMCEngine as JaxAWMC
from dynamic_asr_eval_tpu_torch.config import TTAConfig
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, SCConformer, params_from_jax
from dynamic_asr_eval_tpu_torch.optim import ema_init, ema_params, ema_update
from dynamic_asr_eval_tpu_torch.tta import AWMCEngine

torch.set_num_threads(1)

TINY = dict(feat_in=32, n_layers=2, d_model=64, n_heads=2, head_dim=32, vocab_size=30,
            subsampling_factor=8, subsampling_conv_channels=16, conv_kernel_size=5,
            attention_impl="pallas_flash")
SEQ, OVERLAP, LR, FRAMES = 256, 128, 1e-3, 534
WINDOW_LENGTHS = (256, 256, 256, 150)
CASES = {"epochs1": (1, True, False), "epochs2": (2, True, False),
         "epochs1_flat_decay": (1, False, False), "epochs2_flat_decay": (2, False, False),
         "empty_banks": (1, True, True)}


def _tta(epochs, use_num_updates):
    return dict(seq_len=SEQ, overlap=OVERLAP, epochs=epochs, online=True, shuffle=False,
                lm_tta_beams=0, optim_args={"lr": LR}, ema_use_num_updates=use_num_updates,
                ema_decay=0.9)


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


def _setup(blank_bias=False):
    jcfg = JaxConfig(compute_dtype=jnp.float32, **TINY)
    model, variables = jax_init(jcfg, jax.random.PRNGKey(0), example_T=256)
    if blank_bias:  # every frame's argmax is the blank: empty label banks
        params = jax.tree.map(np.asarray, variables["params"])
        params["decoder"]["bias"] = params["decoder"]["bias"].copy()
        params["decoder"]["bias"][jcfg.blank_id] = 50.0
        variables = {"params": jax.tree.map(jnp.asarray, params)}
    state = params_from_jax(jax.tree.map(np.asarray, variables["params"]))
    port = SCConformer(ConformerConfig(compute_dtype="float32", **TINY))
    port.load_state_dict(state)
    spec = np.random.default_rng(1).standard_normal((TINY["feat_in"], FRAMES)).astype(np.float32)
    return jcfg, model, variables, state, port, spec


@pytest.fixture(scope="module")
def shared():
    return _setup()


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    epochs, use_nu, empty = CASES[request.param]
    jcfg, model, variables, state, port, spec = _setup(blank_bias=empty)
    with rolled_scans():
        j = JaxAWMC(model, jcfg.blank_id, 8, JaxTTAConfig(**_tta(epochs, use_nu)))(
            variables, spec, return_params=True)
    p = AWMCEngine(port, jcfg.blank_id, 8, TTAConfig(**_tta(epochs, use_nu)), device="cpu")(
        state, spec, return_params=True)
    return {"jax": j, "port": p, "initial": variables["params"], "empty": empty}


def test_stitched_log_probs_match(case):
    a, b = case["jax"].numpy_logits(), case["port"].numpy_logits()
    assert a.shape == b.shape == (-(-FRAMES // 8), TINY["vocab_size"] + 1)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(case["port"].counts.numpy(), np.asarray(case["jax"].counts))


def test_adapted_parameters_match(case):
    back, unmatched = convert_lcasr_checkpoint(
        {k: v.numpy() for k, v in case["port"].params.items()})
    assert unmatched == []
    ref = dict(jax.tree_util.tree_leaves_with_path(case["jax"].params))
    init = dict(jax.tree_util.tree_leaves_with_path(case["initial"]))
    moved = 0.0
    for path, leaf in jax.tree_util.tree_leaves_with_path(back["params"]):
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(ref[path]), rtol=0, atol=2e-5)
        moved = max(moved, float(np.abs(np.asarray(ref[path]) - np.asarray(init[path])).max()))
    if case["empty"]:
        assert moved == 0.0  # both banks empty: weighted out, no step moves the weights
    else:
        assert moved > 1e-3  # the bar is meaningful: adaptation moved the weights


def test_greedy_ids_match(case):
    np.testing.assert_array_equal(case["port"].greedy_ids(), case["jax"].greedy_ids())


@pytest.mark.parametrize("decay", [0.999, 0.5, 1.0])
def test_ema_update_matches_jax(decay):
    rng = np.random.default_rng(2)
    start = {"a": rng.standard_normal((3, 4)).astype(np.float32),
             "b": rng.standard_normal(5).astype(np.float32)}
    new = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in start.items()}
           for _ in range(3)]
    ours = ema_init({k: torch.from_numpy(v) for k, v in start.items()}, decay)
    theirs = jax_ema_init({k: jnp.asarray(v) for k, v in start.items()}, decay)
    for p in new:
        ours = ema_update(ours, {k: torch.from_numpy(v) for k, v in p.items()})
        theirs = jax_ema_update(theirs, {k: jnp.asarray(v) for k, v in p.items()})
    for k in start:
        np.testing.assert_allclose(ema_params(ours)[k].numpy(), np.asarray(theirs.params[k]),
                                   rtol=0, atol=1e-6)
    if decay >= 1.0:
        assert all(np.array_equal(ema_params(ours)[k].numpy(), v) for k, v in start.items())


def _engine(shared, epochs=1, **kwargs):
    jcfg, _, _, _, port, _ = shared
    return AWMCEngine(port, jcfg.blank_id, 8, TTAConfig(**_tta(epochs, True)), device="cpu",
                      **kwargs)


def test_callers_weights_are_not_modified(shared):
    state, spec = shared[3], shared[5]
    before = {k: v.clone() for k, v in state.items()}
    out = _engine(shared)(state, spec, return_params=True)
    assert all(torch.equal(state[k], before[k]) for k in state)
    assert any(not torch.equal(out.params[k], before[k]) for k in state)


@pytest.mark.parametrize("epochs", [1, 2])
def test_each_window_runs_its_forwards_and_augmentations(shared, epochs):
    """Per window: the anchor's and the clean forward once, the leader's and
    the student's each epoch (the launch counts chip_smoke.py requires), and
    one batch-1 augmentation per epoch."""
    seen, calls = [], []

    def augment(batch, gen, actual_len):
        seen.append((tuple(batch.shape), int(actual_len)))
        return batch

    engine = _engine(shared, epochs, augment_fn=augment)
    for m in (engine._anchor, engine._leader, engine._work):
        m.register_forward_hook(lambda mod, args, out, m=m: calls.append(m))
    engine(shared[3], shared[5])
    assert seen == [((1, TINY["feat_in"], SEQ), n) for n in WINDOW_LENGTHS for _ in range(epochs)]
    assert len(calls) == (2 + 2 * epochs) * len(WINDOW_LENGTHS)
    per_window = ([engine._anchor] + [engine._leader, engine._work] * epochs + [engine._work])
    assert calls == per_window * len(WINDOW_LENGTHS)


def test_epochs_zero_adapts_one_epoch(shared):
    """``max(epochs, 1)``, as in the JAX engine."""
    state, spec = shared[3], shared[5]
    zero = AWMCEngine(shared[4], TINY["vocab_size"], 8, TTAConfig(**dict(_tta(1, True), epochs=0)),
                      device="cpu")(state, spec)
    one = _engine(shared)(state, spec)
    np.testing.assert_array_equal(zero.numpy_logits(), one.numpy_logits())
