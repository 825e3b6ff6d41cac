"""The port's utterance engine against the JAX package's
``UtteranceTTAEngine``.

Tiny f32 conformer (as in tests/test_torch_engine.py), shared weights
through ``params_from_jax``, seeded numpy utterances, augmentation off (no
``augment_fn``: the augmented copy is the clean utterance on both sides),
lr 1e-3.  Each case runs both engines and holds the per-utterance log-probs
within 1e-4 (on the valid frames both return) and the adapted weights,
through ``convert_lcasr_checkpoint``, within 2e-5.  The cases cover both
loss normalizations, an active clip, gradient accumulation 1 and 2, online
and final collection, ``epochs=0``, shuffle, external pseudo-labels and
``soft_dtw_weight=0.1``; the last two inject the same fixed perturbation
as the augmentation on both sides (``augment_fn``), so that the augmented
and clean posteriors differ.

With ``"pallas_flash"`` the port's padding queries attend only padding
keys, while JAX on the CPU (below T_ds 128) runs its XLA attention, where
they attend valid keys.  The CTC term reads only valid frames, so ragged
utterances are fine there; the soft-DTW term runs over the whole padded
window, so its cases use utterances that fill their bucket (256 and 512
frames).  The JAX engines run with ``lax.scan``'s ``unroll`` dropped (the
same operations), as in tests/test_torch_engine.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamic_asr_eval_tpu.config import TTAConfig as JaxTTAConfig
from dynamic_asr_eval_tpu.models import ConformerConfig as JaxConfig
from dynamic_asr_eval_tpu.models import init_conformer as jax_init
from dynamic_asr_eval_tpu.models.convert import convert_lcasr_checkpoint
from dynamic_asr_eval_tpu.tta.utterance import UtteranceTTAEngine as JaxEngine
from dynamic_asr_eval_tpu_torch.config import TTAConfig
from dynamic_asr_eval_tpu_torch.kernels import softdtw
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, SCConformer, params_from_jax
from dynamic_asr_eval_tpu_torch.tta import utterance
from dynamic_asr_eval_tpu_torch.tta.utterance import UtteranceTTAEngine, _bucket
from test_torch_engine import rolled_scans

torch.set_num_threads(1)

TINY = dict(feat_in=32, n_layers=2, d_model=64, n_heads=2, head_dim=32, vocab_size=30,
            subsampling_factor=8, subsampling_conv_channels=16, conv_kernel_size=5,
            attention_impl="pallas_flash", subsampling_impl="conv")
LR = 1e-3
RAGGED = (200, 256, 300)  # buckets 256, 256, 512
WHOLE = (256, 512, 256)  # utterances that fill their bucket


def pseudo_ids(length):
    return [(3 + length) % 29 + 1, 5, 7, 5]


def noise(W):
    """The injected augmentation's fixed perturbation of a [1, F, W] batch."""
    return 0.5 * np.random.default_rng(W).standard_normal((1, TINY["feat_in"], W)).astype(
        np.float32)


def jax_aug(batch, key, length):
    return batch + noise(batch.shape[-1])


def port_aug(batch, generator, length):
    return batch + torch.from_numpy(noise(batch.shape[-1]))


# name: (utterance lengths, engine options, TTAConfig fields)
CASES = {
    "frames": (RAGGED, {}, {}),
    "ctc_mean_clip_acc2": (RAGGED, dict(loss_norm="ctc_mean", clip_norm=1e-2,
                                        accumulate_gradients=2), {}),
    "final_shuffle": (RAGGED, dict(prob_collection="final"), dict(epochs=2, shuffle=True)),
    "epochs0": (RAGGED, {}, dict(epochs=0)),
    "pseudo_labels": (RAGGED, dict(pseudo_label_fn=True), {}),
    "whole_augmented": (WHOLE, dict(augment_fn=True), {}),
    "soft_dtw": (WHOLE, dict(soft_dtw_weight=0.1, augment_fn=True), {}),
}


def _setup():
    jcfg = JaxConfig(compute_dtype=jnp.float32, **TINY)
    model, variables = jax_init(jcfg, jax.random.PRNGKey(0), example_T=256)
    state = params_from_jax(jax.tree.map(np.asarray, variables["params"]))
    port = SCConformer(ConformerConfig(compute_dtype="float32", **TINY))
    port.load_state_dict(state)
    return jcfg, model, variables, state, port


def utterances(lengths, seed=1):
    rng = np.random.default_rng(seed)
    return [{"spectrogram": rng.standard_normal((TINY["feat_in"], n)).astype(np.float32)}
            for n in lengths]


@pytest.fixture(scope="module")
def shared():
    return _setup()


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request, shared):
    jcfg, model, variables, state, port = shared
    lengths, opts, tta = CASES[request.param]
    utts = utterances(lengths)
    tta = dict(dict(epochs=1, shuffle=False, optim_args={"lr": LR}), **tta)
    opts = dict(opts)
    if opts.pop("pseudo_label_fn", False):  # an external decoder's labels
        jax_opts = dict(opts, pseudo_label_fn=lambda variables, utterance, length:
                        pseudo_ids(length))
        port_opts = dict(opts, pseudo_label_fn=lambda params, utterance, length:
                         pseudo_ids(length))
    else:
        jax_opts = port_opts = opts
    if opts.pop("augment_fn", False):
        jax_opts, port_opts = dict(jax_opts, augment_fn=jax_aug), dict(port_opts, augment_fn=port_aug)
    with rolled_scans():
        j_outs, j_params, _ = JaxEngine(model, jcfg.blank_id, 8, JaxTTAConfig(**tta), **jax_opts)(
            variables, utts, return_params=True)
    p_outs, p_params, _ = UtteranceTTAEngine(port, jcfg.blank_id, 8, TTAConfig(**tta),
                                             device="cpu", **port_opts)(
        state, utts, return_params=True)
    return dict(name=request.param, lengths=lengths, jax=(j_outs, j_params),
                port=(p_outs, p_params), initial=variables["params"])


def test_log_probs_match(run):
    (j_outs, _), (p_outs, _) = run["jax"], run["port"]
    assert len(p_outs) == len(j_outs) == len(run["lengths"])
    for n, a, b in zip(run["lengths"], j_outs, p_outs):
        assert b.shape == np.asarray(a).shape == (-(-n // 8), TINY["vocab_size"] + 1)
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-4)


def test_adapted_weights_match(run):
    (_, j_params), (_, p_params) = run["jax"], run["port"]
    back, unmatched = convert_lcasr_checkpoint({k: v.numpy() for k, v in p_params.items()})
    assert unmatched == []
    ref = dict(jax.tree_util.tree_leaves_with_path(j_params))
    init = dict(jax.tree_util.tree_leaves_with_path(run["initial"]))
    moved = 0.0
    for path, leaf in jax.tree_util.tree_leaves_with_path(back["params"]):
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(ref[path]), rtol=0, atol=2e-5)
        moved = max(moved, float(np.abs(np.asarray(ref[path]) - np.asarray(init[path])).max()))
    if run["name"] == "epochs0":
        assert moved == 0.0
    else:
        assert moved > 2e-4  # ten times the bar: adaptation moved the weights


def test_external_labels_reach_both_engines(shared):
    """``pseudo_label_fn`` is called once per visit with the padded
    utterance and its length on both sides; the port hands it the working
    weights of that visit (the pristine ones at the first)."""
    *_, state, port = shared
    lengths, opts, _ = CASES["pseudo_labels"]
    calls = []

    def port_fn(params, utterance, length):
        calls.append((length, utterance.shape, {k: v.clone() for k, v in params.items()}))
        return pseudo_ids(length)

    UtteranceTTAEngine(port, TINY["vocab_size"], 8,
                       TTAConfig(epochs=1, shuffle=False, optim_args={"lr": LR}),
                       pseudo_label_fn=port_fn, device="cpu")(state, utterances(lengths))
    assert [(n, s) for n, s, _ in calls] == [(n, (TINY["feat_in"], _bucket(n))) for n in lengths]
    assert all(torch.equal(calls[0][2][k], state[k]) for k in state)
    assert any(not torch.equal(calls[1][2][k], state[k]) for k in state)


def test_soft_dtw_term_moves_the_weights(shared):
    """The soft-DTW case adapts to other weights than the same run without
    it (``whole_augmented``), by far more than the parity bar."""
    *_, state, port = shared
    utts = utterances(WHOLE)
    adapted = {}
    for w in (0.0, 0.1):
        _, adapted[w], _ = UtteranceTTAEngine(
            port, TINY["vocab_size"], 8, TTAConfig(epochs=1, shuffle=False, optim_args={"lr": LR}),
            soft_dtw_weight=w, augment_fn=port_aug, device="cpu")(state, utts, return_params=True)
    diff = max((adapted[0.1][k] - adapted[0.0][k]).abs().max().item() for k in state)
    assert diff > 5 * 2e-5  # the term moves them by ~2.3e-4 at this size


def test_soft_dtw_runs_through_the_kernel_entry_on_f32(shared, monkeypatch):
    """The engine calls ``kernels.softdtw.soft_dtw`` with ``use_pallas=True``
    on an f32 D of [num_negatives, W_ds, W_ds] (the bucket's downsampled
    length) once per utterance; the kernels' entry refuses another dtype
    rather than casting."""
    *_, state, port = shared
    seen = []
    real = softdtw.soft_dtw

    def spy(D, gamma=1.0, bandwidth=0, use_pallas=False):
        seen.append((tuple(D.shape), D.dtype, use_pallas, gamma, bandwidth))
        return real(D, gamma, bandwidth, use_pallas)

    monkeypatch.setattr(utterance.softdtw, "soft_dtw", spy)
    UtteranceTTAEngine(port, TINY["vocab_size"], 8,
                       TTAConfig(epochs=1, shuffle=False, optim_args={"lr": LR}),
                       soft_dtw_weight=0.1, soft_dtw_gamma=0.5, device="cpu")(
        state, utterances(RAGGED))
    assert seen == [((1, _bucket(n) // 8, _bucket(n) // 8), torch.float32, True, 0.5, 0)
                    for n in RAGGED]
    with pytest.raises(TypeError, match="float32"):
        real(torch.zeros(1, 4, 4, dtype=torch.bfloat16), 1.0, 0, True)


def test_callers_weights_are_not_modified(shared):
    *_, state, port = shared
    before = {k: v.clone() for k, v in state.items()}
    UtteranceTTAEngine(port, TINY["vocab_size"], 8,
                       TTAConfig(epochs=1, shuffle=False, optim_args={"lr": LR}),
                       device="cpu")(state, utterances(RAGGED[:1]))
    assert all(torch.equal(state[k], before[k]) for k in state)
    assert all(torch.equal(port.state_dict()[k], before[k]) for k in state)


@pytest.mark.parametrize("kw", [dict(prob_collection="mean"), dict(loss_norm="sum")])
def test_rejects_unknown_modes(shared, kw):
    *_, port = shared
    with pytest.raises(ValueError):
        UtteranceTTAEngine(port, TINY["vocab_size"], 8, TTAConfig(), device="cpu", **kw)


@pytest.mark.parametrize("n,bucket", [(1, 256), (256, 256), (257, 512), (4096, 4096),
                                      (4097, 8192)])
def test_bucket_is_the_jax_bucket(n, bucket):
    from dynamic_asr_eval_tpu.tta.utterance import _bucket as jax_bucket

    assert _bucket(n) == jax_bucket(n) == bucket
