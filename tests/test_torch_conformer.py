"""The port's conformer against the JAX package's on one set of weights.

Tiny config (feat 32, 2 layers, d 64, 2 × 32 heads, vocab 30, ×8 subsampling
with 16 channels, kernel 5, fp32, ``attention_impl="pallas_flash"`` on both
sides; at T_ds < 128 the JAX side takes its plain-XLA attention).  Weights
cross with ``params_from_jax``; ``convert_lcasr_checkpoint`` of the port's
state dict must give the JAX params back exactly.  Lengths are not multiples
of 8.  Each test runs with ``subsampling_impl="conv"`` and with ``"pallas"``
(the JAX side runs its fused Pallas kernel in interpret mode; both sides keep
its unmasked semantics at these ragged lengths).  Bars: ``final_posteriors``
within 1e-4 on valid frames; the parameter gradients of one CTC loss within
1e-4 of each leaf's max-abs.  The JAX side runs under ``jax.disable_jit()``
(tests/conftest.py explains why).
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
from dynamic_asr_eval_tpu_torch.models.conformer import init_conformer
from dynamic_asr_eval_tpu_torch.ops.ctc import ctc_loss

torch.set_num_threads(1)

TINY = dict(feat_in=32, n_layers=2, d_model=64, n_heads=2, head_dim=32, vocab_size=30,
            subsampling_factor=8, subsampling_conv_channels=16, conv_kernel_size=5,
            attention_impl="pallas_flash")
LENGTHS = np.array([203, 150])
T_IN = 203


@pytest.fixture(scope="module", params=["conv", "pallas"])
def shared(request):
    cfg = dict(TINY, subsampling_impl=request.param)
    jcfg = JaxConfig(compute_dtype=jnp.float32, **cfg)
    model, variables = jax_init(jcfg, jax.random.PRNGKey(0), example_T=256)
    params_np = jax.tree.map(np.asarray, variables["params"])
    port = SCConformer(ConformerConfig(compute_dtype="float32", **cfg))
    port.load_state_dict(params_from_jax(params_np), strict=True)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, TINY["feat_in"], T_IN)).astype(np.float32)
    labels = rng.integers(0, TINY["vocab_size"], (2, 6)).astype(np.int32)
    label_lengths = np.array([6, 4], np.int32)
    return model, variables, port, x, labels, label_lengths


def test_state_dict_round_trips_through_the_jax_converter(shared):
    _, variables, port, *_ = shared
    back, unmatched = convert_lcasr_checkpoint(
        {k: v.numpy() for k, v in port.state_dict().items()})
    assert unmatched == []
    flat_a = jax.tree_util.tree_leaves_with_path(back["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat_b[path]))


def test_final_posteriors_match_on_valid_frames(shared):
    model, variables, port, x, *_ = shared
    with jax.disable_jit():
        ref = model.apply(variables, jnp.asarray(x), length=jnp.asarray(LENGTHS))
    out = port(torch.from_numpy(x), torch.from_numpy(LENGTHS))
    ds = np.asarray(ref["length"])
    np.testing.assert_array_equal(out["length"].numpy(), ds)
    lp = out["final_posteriors"].detach().numpy()
    ref_lp = np.asarray(ref["final_posteriors"])
    assert lp.shape == ref_lp.shape
    for b in range(2):
        np.testing.assert_allclose(lp[b, : ds[b]], ref_lp[b, : ds[b]], rtol=0, atol=1e-4)


def test_ctc_parameter_gradients_match(shared):
    model, variables, port, x, labels, label_lengths = shared
    blank = TINY["vocab_size"]

    def jax_loss(p):
        out = model.apply({"params": p}, jnp.asarray(x), length=jnp.asarray(LENGTHS))
        return jax_ctc_loss(out["final_posteriors"], out["length"], jnp.asarray(labels),
                            jnp.asarray(label_lengths), blank_id=blank)

    with jax.disable_jit():
        ref_loss, ref_grads = jax.value_and_grad(jax_loss)(variables["params"])

    port.zero_grad()
    out = port(torch.from_numpy(x), torch.from_numpy(LENGTHS))
    loss = ctc_loss(out["final_posteriors"], out["length"], torch.from_numpy(labels),
                    torch.from_numpy(label_lengths), blank_id=blank)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)

    grads, unmatched = convert_lcasr_checkpoint(
        {n: p.grad.numpy() for n, p in port.named_parameters()})
    assert unmatched == []
    ref = dict(jax.tree_util.tree_leaves_with_path(ref_grads))
    got = jax.tree_util.tree_leaves_with_path(grads["params"])
    assert len(got) == len(ref)
    for path, g in got:
        r = np.asarray(ref[path])
        scale = max(float(np.abs(r).max()), 1e-12)
        err = float(np.abs(np.asarray(g) - r).max())
        assert err <= 1e-4 * scale, (jax.tree_util.keystr(path), err, scale)


def test_one_layer_self_conditioned_model_loads_strictly_and_matches_jax():
    """JAX creates ``self_condition_reembed`` only where one block feeds
    another, so a one-layer self-conditioned model has none; the port's
    builds the same parameters and loads JAX's strictly.  A reference
    checkpoint of it infers ``self_conditioning`` False, which changes
    nothing at one layer."""
    from dynamic_asr_eval_tpu_torch.models.checkpoint import infer_conformer_dims

    cfg = dict(TINY, n_layers=1, self_conditioning=True)
    jcfg = JaxConfig(compute_dtype=jnp.float32, **cfg)
    model, variables = jax_init(jcfg, jax.random.PRNGKey(1), example_T=256)
    assert "self_condition_reembed" not in variables["params"]
    port = SCConformer(ConformerConfig(compute_dtype="float32", **cfg))
    assert port.self_condition_reembed is None
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, variables["params"])),
                         strict=True)
    x = np.random.default_rng(2).standard_normal((2, TINY["feat_in"], T_IN)).astype(np.float32)
    with jax.disable_jit():
        ref = model.apply(variables, jnp.asarray(x), length=jnp.asarray(LENGTHS))
    with torch.no_grad():
        lp = port(torch.from_numpy(x), torch.from_numpy(LENGTHS))["final_posteriors"].numpy()
    ref_lp = np.asarray(ref["final_posteriors"])
    for b, n in enumerate(np.asarray(ref["length"])):
        np.testing.assert_allclose(lp[b, :n], ref_lp[b, :n], rtol=0, atol=1e-4)
    assert infer_conformer_dims(port.state_dict())["self_conditioning"] is False


def test_seeded_init_is_reproducible_and_layer_norms_start_at_identity():
    cfg = ConformerConfig(compute_dtype="float32", **TINY)
    a, b = init_conformer(cfg, seed=3), init_conformer(cfg, seed=3)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    assert torch.all(a.layers[0].norm_out.weight == 1)
    assert not torch.equal(a.decoder.weight, init_conformer(cfg, seed=4).decoder.weight)


@pytest.mark.parametrize("field,value", [("subsampling", "striding"),
                                         ("seq_shard_axes", ("dp", "sp")),
                                         ("attention_impl", "ring")])
def test_unported_options_raise(field, value):
    """What the port still refuses (the options it ported, rel_pos, batch
    renorm and the "hybrid" lowering among them, are held against JAX in
    tests/test_torch_conformer_options.py).  ``seq_shard_axes`` is ported
    (sequence parallelism, held against JAX in
    tests/test_torch_sequence_parallel.py): outside ``use_mesh`` it is a
    no-op, as JAX's sharding constraint is outside a mesh."""
    cfg = ConformerConfig(compute_dtype="float32", **{**TINY, field: value})
    if field == "seq_shard_axes":
        plain = init_conformer(ConformerConfig(compute_dtype="float32", **TINY), seed=0)
        model = SCConformer(cfg)
        model.load_state_dict(plain.state_dict(), strict=True)
        x = torch.randn(2, TINY["feat_in"], 96, generator=torch.Generator().manual_seed(0))
        length = torch.tensor([96, 70])
        with torch.no_grad():
            assert torch.equal(model(x, length)["final_posteriors"],
                               plain(x, length)["final_posteriors"])
        with pytest.raises(ValueError, match="seq_shard_axes"):
            SCConformer(ConformerConfig(compute_dtype="float32", **{**TINY, field: ("sp",)}))
        return
    with pytest.raises(NotImplementedError):
        SCConformer(cfg)
