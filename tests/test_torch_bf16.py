"""The port's bf16 path, the flagship's dtype, against the JAX package's.

Tiny config with bf16 compute, bf16 attention logits and a bf16 CTC head,
one set of weights.  JAX runs its bf16 ``"xla"`` attention and ``"conv"``
subsampling (and the same model in f32 as the reference); the port runs each
of its paths: ``"xla"``, ``"pallas_flash"`` attention, and ``"pallas_flash"``
with ``"pallas"`` subsampling (on the CPU the kernels' plain versions, which
round where the kernels round).  Lengths are multiples of 8, where the
``"pallas"`` subsampling's unmasked semantics equal ``"conv"``'s.

Bars: the un-adapted forward within 0.06 of JAX's bf16 on valid frames; the
parameter gradients of one CTC loss, against JAX's f32 gradients, within
JAX's own bf16-vs-f32 relative error (L2 over all parameters).  Equal
transcripts after adaptation are not the bar: on random weights JAX's bf16
run does not reproduce its own f32 transcript either.  The JAX side runs
under ``jax.disable_jit()`` (tests/conftest.py explains why).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamic_asr_eval_tpu.models import ConformerConfig as JaxConfig
from dynamic_asr_eval_tpu.models import init_conformer as jax_init
from dynamic_asr_eval_tpu.models.convert import convert_lcasr_checkpoint
from dynamic_asr_eval_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, SCConformer, params_from_jax
from dynamic_asr_eval_tpu_torch.ops.ctc import ctc_loss

torch.set_num_threads(1)

TINY = dict(feat_in=32, n_layers=2, d_model=64, n_heads=2, head_dim=32, vocab_size=30,
            subsampling_factor=8, subsampling_conv_channels=16, conv_kernel_size=5,
            attention_logits_in_compute_dtype=True, head_in_compute_dtype=True)
LENGTHS = np.array([256, 200])
PATHS = {"xla": dict(attention_impl="xla", subsampling_impl="conv"),
         "pallas_flash": dict(attention_impl="pallas_flash", subsampling_impl="conv"),
         "pallas": dict(attention_impl="pallas_flash", subsampling_impl="pallas")}
FORWARD_BAR = 0.06


@pytest.fixture(scope="module")
def reference():
    """JAX's bf16 and f32 models on the same weights: outputs on valid
    frames and the CTC gradients."""
    cfg = dict(TINY, **PATHS["xla"])
    jbf = JaxConfig(compute_dtype=jnp.bfloat16, **cfg)
    jf32 = JaxConfig(compute_dtype=jnp.float32, **cfg)
    model_bf, variables = jax_init(jbf, jax.random.PRNGKey(2), example_T=256)
    model_32, _ = jax_init(jf32, jax.random.PRNGKey(2), example_T=256)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, TINY["feat_in"], int(LENGTHS.max()))).astype(np.float32)
    labels = rng.integers(0, TINY["vocab_size"], (2, 6)).astype(np.int32)
    label_lengths = np.array([6, 4], np.int32)

    def run(model):
        def loss_fn(p):
            out = model.apply({"params": p}, jnp.asarray(x), length=jnp.asarray(LENGTHS))
            loss = jax_ctc_loss(out["final_posteriors"], out["length"], jnp.asarray(labels),
                                jnp.asarray(label_lengths), blank_id=TINY["vocab_size"])
            return loss, out

        with jax.disable_jit():
            (_, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
        return np.asarray(out["final_posteriors"], np.float32), np.asarray(out["length"]), grads

    lp_bf, ds, grads_bf = run(model_bf)
    _, _, grads_32 = run(model_32)
    return {"params": jax.tree.map(np.asarray, variables["params"]), "x": x, "labels": labels,
            "label_lengths": label_lengths, "lp_bf": lp_bf, "ds": ds, "grads_bf": grads_bf,
            "grads_32": grads_32}


def rel_err(grads, ref):
    """L2 over all parameters of ``grads - ref``, over L2 of ``ref``."""
    ref = dict(jax.tree_util.tree_leaves_with_path(ref))
    num = den = 0.0
    for path, g in jax.tree_util.tree_leaves_with_path(grads):
        r = np.asarray(ref[path], np.float64)
        num += float(np.sum((np.asarray(g, np.float64) - r) ** 2))
        den += float(np.sum(r ** 2))
    return (num / den) ** 0.5


@pytest.fixture(scope="module", params=list(PATHS))
def port_run(request, reference):
    model = SCConformer(ConformerConfig(compute_dtype="bfloat16", **TINY, **PATHS[request.param]))
    model.load_state_dict(params_from_jax(reference["params"]), strict=True)
    out = model(torch.from_numpy(reference["x"]), torch.from_numpy(LENGTHS))
    loss = ctc_loss(out["final_posteriors"], out["length"], torch.from_numpy(reference["labels"]),
                    torch.from_numpy(reference["label_lengths"]), blank_id=TINY["vocab_size"])
    loss.backward()
    grads, unmatched = convert_lcasr_checkpoint(
        {n: p.grad.float().numpy() for n, p in model.named_parameters()})
    assert unmatched == []
    return out, grads["params"]


def test_bf16_forward_within_bar_of_jax_on_valid_frames(reference, port_run):
    out, _ = port_run
    np.testing.assert_array_equal(out["length"].numpy(), reference["ds"])
    lp = out["final_posteriors"].detach().float().numpy()
    err = max(float(np.abs(lp[b, :n] - reference["lp_bf"][b, :n]).max())
              for b, n in enumerate(reference["ds"]))
    assert err <= FORWARD_BAR, err


def test_bf16_gradients_within_jax_own_bf16_error(reference, port_run):
    _, grads = port_run
    jax_err = rel_err(reference["grads_bf"], reference["grads_32"])
    port_err = rel_err(grads, reference["grads_32"])
    assert 0 < jax_err < 0.1  # bf16 moved JAX's gradients, by a bf16-sized amount
    assert port_err <= jax_err, (port_err, jax_err)
