"""The port's plain ops against their JAX counterparts.

- ``ctc_loss``: value and gradient over random draws, with zero-length labels,
  ``input_length < T`` and an impossible alignment; fp32, 1e-4.
- ``greedy_labels``: exactly equal, ties included (first maximum).
- ``chunk_starts_and_lengths`` / ``pad_num_chunks``: exactly equal.
- ``stitch_chunk_probs`` / ``trim_stitched``: within fp32 rounding (1e-6);
  ``greedy_decode``: the same text.
- MADGRAD: 5 steps on identical gradients, within 1e-6.
- freeze policies: the same trainable set, by name.
- log-mel: within 1e-4.
The JAX CTC runs under ``jax.disable_jit()`` (tests/conftest.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dynamic_asr_eval_tpu.audio.features import log_mel_spectrogram as jax_log_mel
from dynamic_asr_eval_tpu.models import ConformerConfig as JaxConfig
from dynamic_asr_eval_tpu.models import init_conformer as jax_init
from dynamic_asr_eval_tpu.models.convert import DEFAULT_RULES, convert_state_dict
from dynamic_asr_eval_tpu.ops.chunk import chunk_starts_and_lengths as jax_chunks
from dynamic_asr_eval_tpu.ops.chunk import pad_num_chunks as jax_pad
from dynamic_asr_eval_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from dynamic_asr_eval_tpu.ops.ctc import greedy_labels as jax_greedy_labels
from dynamic_asr_eval_tpu.ops.ctc import greedy_decode as jax_greedy_decode
from dynamic_asr_eval_tpu.ops.stitch import stitch_chunk_probs as jax_stitch
from dynamic_asr_eval_tpu.ops.stitch import trim_stitched as jax_trim
from dynamic_asr_eval_tpu.text import CharTokenizer
from dynamic_asr_eval_tpu.optim.madgrad import madgrad as jax_madgrad
from dynamic_asr_eval_tpu.optim.masks import param_labels as jax_param_labels
from dynamic_asr_eval_tpu_torch.audio.features import log_mel_spectrogram
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, SCConformer
from dynamic_asr_eval_tpu_torch.ops import (
    chunk_starts_and_lengths,
    ctc_loss,
    greedy_decode,
    greedy_labels,
    pad_num_chunks,
    stitch_chunk_probs,
    trim_stitched,
)
from dynamic_asr_eval_tpu_torch.optim import MADGRAD, param_labels

torch.set_num_threads(1)


def _ctc_case(seed):
    rng = np.random.default_rng(seed)
    B, T, V, U = 3, int(rng.integers(6, 14)), 7, 4
    blank = int(rng.integers(0, V))
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    labels = rng.integers(0, V - 1, (B, U)).astype(np.int32)
    labels[labels >= blank] += 1  # never the blank
    label_lengths = np.array([0, int(rng.integers(1, U + 1)), U], np.int32)
    input_lengths = np.array([T, T - 1, T - int(rng.integers(0, 3))], np.int32)
    weights = rng.uniform(0.5, 1.5, B).astype(np.float32)
    return logits, input_lengths, labels, label_lengths, blank, weights


@pytest.mark.parametrize("seed", range(4))
def test_ctc_loss_value_and_gradient(seed):
    """Gradients are taken w.r.t. the logits before the log-softmax:
    PyTorch's CTC backward folds the softmax in, so its gradient w.r.t. the
    log-probs themselves is only meaningful through a log-softmax, which is
    how the model uses it."""
    logits, il, lab, ll, blank, w = _ctc_case(seed)

    def f(z):
        return jax_ctc_loss(jax.nn.log_softmax(z, axis=-1), jnp.asarray(il), jnp.asarray(lab),
                            jnp.asarray(ll), blank_id=blank, sample_weights=jnp.asarray(w))

    with jax.disable_jit():
        ref, ref_g = jax.value_and_grad(f)(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    loss = ctc_loss(torch.log_softmax(x, -1), torch.from_numpy(il), torch.from_numpy(lab),
                    torch.from_numpy(ll), blank_id=blank, sample_weights=torch.from_numpy(w))
    (g,) = torch.autograd.grad(loss, x)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), rtol=0, atol=1e-4)


def test_ctc_zero_length_label_is_minus_sum_log_blank():
    lp = np.log(np.full((1, 5, 4), 0.25, np.float32))
    loss = ctc_loss(torch.from_numpy(lp), torch.tensor([5]), torch.zeros(1, 3, dtype=torch.int32),
                    torch.tensor([0]), blank_id=3)
    np.testing.assert_allclose(loss.item(), -5 * np.log(0.25), rtol=1e-6)


def test_ctc_impossible_alignment_is_finite_like_jax():
    lp = np.log(np.full((1, 3, 4), 0.25, np.float32))
    lab = np.array([[1, 1, 2]], np.int32)  # needs 4 frames (a blank between the 1s)
    with jax.disable_jit():
        ref = float(jax_ctc_loss(jnp.asarray(lp), jnp.array([3]), jnp.asarray(lab),
                                 jnp.array([3]), blank_id=3))
    x = torch.tensor(lp, requires_grad=True)
    loss = ctc_loss(x, torch.tensor([3]), torch.from_numpy(lab), torch.tensor([3]), blank_id=3)
    (g,) = torch.autograd.grad(loss, x)
    assert ref > 1e29 and loss.item() == pytest.approx(1e30)
    assert torch.all(g == 0)


@pytest.mark.parametrize("seed", range(3))
def test_greedy_labels_exactly_equal(seed):
    rng = np.random.default_rng(seed)
    T, V = 40, 6
    lp = rng.integers(0, 3, (T, V)).astype(np.float32)  # many ties
    for length in (0, 17, T):
        for max_tokens in (4, 40):
            a, n = jax_greedy_labels(jnp.asarray(lp), length, V - 1, max_tokens)
            b, m = greedy_labels(torch.from_numpy(lp), length, V - 1, max_tokens)
            assert int(n) == int(m)
            np.testing.assert_array_equal(np.asarray(a)[: int(n)], b.numpy()[: int(m)])


def test_chunk_plan_and_buckets_exactly_equal():
    rng = np.random.default_rng(0)
    for _ in range(300):
        seq = int(rng.integers(8, 400))
        overlap = int(rng.integers(0, seq))
        n = int(rng.integers(1, 3000))
        assert chunk_starts_and_lengths(n, seq, overlap) == jax_chunks(n, seq, overlap)
    for n in range(0, 600):
        assert pad_num_chunks(n) == jax_pad(n)


def test_stitching_within_fp32_rounding():
    rng = np.random.default_rng(0)
    N, T_ds, V, total = 5, 12, 9, 50
    probs = rng.uniform(0, 1, (N, T_ds, V)).astype(np.float32)
    ds = np.array([12, 12, 12, 7, 0], np.int32)
    starts = np.array([0, 8, 16, 24, 24], np.int32)
    ref_lp, ref_c = jax_stitch(jnp.asarray(probs), jnp.asarray(ds), jnp.asarray(starts), total)
    lp, c = stitch_chunk_probs(torch.from_numpy(probs), torch.from_numpy(ds),
                               torch.from_numpy(starts), total)
    np.testing.assert_array_equal(c.numpy(), np.asarray(ref_c))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(trim_stitched(lp, c), jax_trim(ref_lp, ref_c), rtol=0, atol=1e-6)


@pytest.mark.parametrize("length", [None, 17])
def test_greedy_decode_gives_the_same_text(length):
    lp = np.random.default_rng(1).standard_normal((1, 40, 29)).astype(np.float32)
    tok = CharTokenizer()
    assert (greedy_decode(torch.from_numpy(lp), tok, input_length=length)
            == jax_greedy_decode(lp, tok, input_length=length))


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_madgrad_five_steps(wd):
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(5)]
    opt = jax_madgrad(1e-2, momentum=0.9, weight_decay=wd)
    params = jax.tree.map(jnp.asarray, p0)
    state = opt.init(params)
    for g in grads:
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    topt = MADGRAD(list(tp.values()), lr=1e-2, momentum=0.9, weight_decay=wd)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(params[k]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("policy", ["bitfit", "freeze_subsampling", "last_block_and_head",
                                    "subsampling_only"])
def test_freeze_policies_select_the_same_parameters(policy):
    tiny = dict(feat_in=16, n_layers=2, d_model=32, n_heads=2, head_dim=16, vocab_size=10,
                subsampling_factor=8, subsampling_conv_channels=4, conv_kernel_size=3)
    _, variables = jax_init(JaxConfig(**tiny), jax.random.PRNGKey(0), example_T=64)
    jax_labels = jax_param_labels(variables["params"], n_layers=2, **{policy: True})
    by_path = {"/".join(str(p.key) for p in path): v
               for path, v in jax.tree_util.tree_leaves_with_path(jax_labels)}
    names = [n for n, _ in SCConformer(ConformerConfig(**tiny)).named_parameters()]
    ours = param_labels(names, n_layers=2, **{policy: True})
    # map each lcasr name to its flax path with the JAX package's own rules
    shapes = {n: tuple(p.shape) for n, p in SCConformer(ConformerConfig(**tiny)).named_parameters()}
    for name in names:
        tree, unmatched = convert_state_dict({name: np.zeros(shapes[name])}, DEFAULT_RULES)
        assert unmatched == []
        leaf_path = jax.tree_util.tree_leaves_with_path(tree)[0][0]
        path = "/".join(str(p.key) for p in leaf_path)
        assert ours[name] == by_path[path], (name, path)
    assert len(ours) == len(by_path)


def test_log_mel_matches():
    rng = np.random.default_rng(0)
    t = np.arange(32000) / 16000
    wave = (0.1 * np.sin(2 * np.pi * 300 * t) + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
    np.testing.assert_allclose(log_mel_spectrogram(wave), jax_log_mel(wave), rtol=0, atol=1e-4)
