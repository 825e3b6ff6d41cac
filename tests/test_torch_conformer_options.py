"""The port's conformer options against the JAX package's model.

Tiny config (feat 32, 2 layers, d 64, 2 × 32 heads, vocab 30, ×8 subsampling
with 16 channels, kernel 5, fp32), weights from the JAX init with every
zero- or one-initialised leaf (biases, scales, ``pos_bias_u`` / ``_v``)
drawn from a numpy seed, and non-trivial running statistics (mean ~ N(0,
0.1), var ~ U(0.5, 2)); they cross with ``params_from_jax``.  Lengths [203,
150] (not multiples of 8).  Bars: ``final_posteriors`` within 1e-4 on valid
frames for every option (batch renorm and batch norm in eval mode,
``rel_pos`` on both attention settings, ``input_xscale``, ``bias_in_attn``,
``subsampling_norm_out`` on ``"conv"`` and ``"pallas"``, the ``"xla"`` /
``"hybrid"`` / ``"conv_tapbwd"`` lowerings, ``"pallas"`` where JAX's
dispatch falls through to the masked path, and the NeMo combination); batch
renorm on batch statistics: output within 1e-5 and the updated running
statistics within 1e-6 of JAX's mutated ``batch_stats``.  The relative
shift against a gather, the embedding layout against JAX's, the port's
``rel_pos`` attention against ``tests/torch_oracles.py``'s NeMo attention
(1e-5).  Dropout in the config changes nothing where the model is called as
the engines call it.  The freeze policies on a batch-renorm ``rel_pos``
model pick JAX's label tree, mapped by name.  The JAX side runs under
``jax.disable_jit()`` (tests/conftest.py explains why).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from dynamic_asr_eval_tpu.models import ConformerConfig as JaxConfig
from dynamic_asr_eval_tpu.models import init_conformer as jax_init
from dynamic_asr_eval_tpu.models.conformer import rel_shift as jax_rel_shift
from dynamic_asr_eval_tpu.models.conformer import relpos_encoding as jax_relpos_encoding
from dynamic_asr_eval_tpu.optim.masks import param_labels as jax_param_labels
from dynamic_asr_eval_tpu_torch.config import TTAConfig
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, SCConformer, params_from_jax
from dynamic_asr_eval_tpu_torch.models.conformer import (
    BatchRenorm,
    init_conformer,
    rel_shift,
    relpos_encoding,
)
from dynamic_asr_eval_tpu_torch.optim.masks import param_labels
from dynamic_asr_eval_tpu_torch.tta import DynamicEvalEngine
from torch_oracles import _NeMoRelPosAttention

torch.set_num_threads(1)

TINY = dict(feat_in=32, n_layers=2, d_model=64, n_heads=2, head_dim=32, vocab_size=30,
            subsampling_factor=8, subsampling_conv_channels=16, conv_kernel_size=5)
NEMO = dict(position_encoding="rel_pos", input_xscale=True, bias_in_attn=True, bias_in_ff=True,
            default_norm="batch_norm", subsampling_act="relu", self_conditioning=False,
            decoder_norm=False, use_rotary=False)
LENGTHS = np.array([203, 150])
T_IN = 203


def _randomise(variables, seed=0):
    """Every bias, scale and relative-position bias drawn from a numpy seed;
    running statistics mean ~ N(0, 0.1), var ~ U(0.5, 2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("bias", "scale", "pos_bias_u", "pos_bias_v") or name.endswith("_bias"):
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        if name == "mean":
            return 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jax.tree.map(np.asarray, dict(variables)))


def _pair(seed=0, **options):
    cfg = dict(TINY, **options)
    jcfg = JaxConfig(compute_dtype=jnp.float32, **cfg)
    model, variables = jax_init(jcfg, jax.random.PRNGKey(seed), example_T=256)
    variables = _randomise(variables, seed)
    port = SCConformer(ConformerConfig(compute_dtype="float32", **cfg))
    port.load_state_dict(params_from_jax(variables), strict=True)
    return model, variables, port


def _inputs(feat_in=TINY["feat_in"], seed=0):
    return np.random.default_rng(seed).standard_normal((2, feat_in, T_IN)).astype(np.float32)


def _assert_valid_frames(port_out, ref, atol=1e-4):
    ds = np.asarray(ref["length"])
    np.testing.assert_array_equal(port_out["length"].numpy(), ds)
    lp = port_out["final_posteriors"].detach().numpy()
    ref_lp = np.asarray(ref["final_posteriors"])
    assert lp.shape == ref_lp.shape
    for b in range(len(ds)):
        np.testing.assert_allclose(lp[b, : ds[b]], ref_lp[b, : ds[b]], rtol=0, atol=atol)


OPTIONS = {
    "batch_renorm": dict(default_norm="batch_renorm"),
    "batch_norm": dict(default_norm="batch_norm"),
    "rel_pos": dict(position_encoding="rel_pos", use_rotary=False),
    "rel_pos_over_pallas_flash": dict(position_encoding="rel_pos", attention_impl="pallas_flash"),
    "input_xscale": dict(input_xscale=True),
    "bias_in_attn": dict(bias_in_attn=True),
    "norm_out_conv": dict(subsampling_norm_out=True),
    "norm_out_pallas": dict(subsampling_norm_out=True, subsampling_impl="pallas"),
    "lowering_xla": dict(subsampling_impl="xla"),
    "lowering_hybrid": dict(subsampling_impl="hybrid"),
    "lowering_conv_tapbwd": dict(subsampling_impl="conv_tapbwd"),
    "pallas_factor_4": dict(subsampling_impl="pallas", subsampling_factor=4),
    "pallas_feat_36": dict(subsampling_impl="pallas", feat_in=36),
    "nemo": NEMO,
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_matches_jax_on_valid_frames(option):
    options = OPTIONS[option]
    model, variables, port = _pair(**options)
    x = _inputs(options.get("feat_in", TINY["feat_in"]))
    with jax.disable_jit():
        ref = model.apply(variables, jnp.asarray(x), length=jnp.asarray(LENGTHS))
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(LENGTHS))
    _assert_valid_frames(out, ref)


def test_the_fused_dispatch_takes_the_masked_path_where_jax_does():
    """JAX's fused kernel runs only at factor 8 with feat_in % 8 == 0; the
    port's dispatch is the same."""
    for options, fused in ((dict(subsampling_impl="pallas"), True),
                           (OPTIONS["pallas_factor_4"], False),
                           (OPTIONS["pallas_feat_36"], False),
                           (dict(subsampling_impl="hybrid"), False)):
        cfg = ConformerConfig(compute_dtype="float32", **{**TINY, **options})
        assert SCConformer(cfg).subsampling.uses_fused_kernel(cfg.feat_in) is fused, options


def test_batch_renorm_on_batch_statistics_matches_jax():
    model, variables, port = _pair(default_norm="batch_renorm")
    x = _inputs(seed=3)
    with jax.disable_jit():
        ref, mutated = model.apply(variables, jnp.asarray(x), length=jnp.asarray(LENGTHS),
                                   use_running_average=False, mutable=["batch_stats"])
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(LENGTHS), use_running_average=False)
    _assert_valid_frames(out, ref, atol=1e-5)
    moved = 0.0
    for n in range(TINY["n_layers"]):
        stats = mutated["batch_stats"][f"layer_{n}"]["conv"]["norm"]["BatchRenorm_0"]
        norm = port.layers[n].conv.norm_mid
        for buf, key in ((norm.running_mean, "mean"), (norm.running_var, "var")):
            np.testing.assert_allclose(buf.numpy(), np.asarray(stats[key]), rtol=0, atol=1e-6)
        old = variables["batch_stats"][f"layer_{n}"]["conv"]["norm"]["BatchRenorm_0"]["mean"]
        moved = max(moved, float(np.abs(norm.running_mean.numpy() - old).max()))
    assert moved > 0


def test_batch_renorm_gradients_skip_the_clipped_factors():
    """r and d are constants of the backward (JAX's ``stop_gradient``): the
    input gradient equals one through (x - mean) / std · r + d with r and d
    taken as numbers."""
    torch.manual_seed(0)
    norm = BatchRenorm(4)
    norm.running_var.fill_(4.0)
    x = torch.randn(2, 5, 4, requires_grad=True)
    g = torch.autograd.grad(norm(x, use_running_average=False).sum(), x)[0]
    xd = x.detach().requires_grad_(True)
    mean = xd.mean((0, 1))
    std = torch.sqrt(((xd - mean) ** 2).mean((0, 1)) + 1e-5)
    r = torch.clamp(std.detach() / torch.sqrt(torch.tensor(4.0 + 1e-5)), 1 / 3, 3)
    ref = torch.autograd.grad(((xd - mean) / std * r).sum(), xd)[0]
    torch.testing.assert_close(g, ref, rtol=0, atol=1e-6)


def test_rel_shift_is_a_gather():
    B, H, T = 2, 3, 7
    x = np.random.default_rng(0).standard_normal((B, H, T, 2 * T - 1)).astype(np.float32)
    i, j = np.arange(T)[:, None], np.arange(T)[None, :]
    expect = x[:, :, np.arange(T)[:, None], j - i + T - 1]
    np.testing.assert_array_equal(rel_shift(torch.from_numpy(x)).numpy(), expect)
    np.testing.assert_array_equal(np.asarray(jax_rel_shift(jnp.asarray(x))), expect)


def test_relpos_encoding_layout():
    """Index 0 is relative distance T-1, the centre is distance 0 (sin 0,
    cos 1), the same table as JAX's."""
    T, d = 5, 8
    pe = relpos_encoding(d, T).numpy()
    assert pe.shape == (2 * T - 1, d)
    np.testing.assert_allclose(pe[T - 1, 0::2], 0.0, atol=1e-7)
    np.testing.assert_allclose(pe[T - 1, 1::2], 1.0, atol=1e-7)
    np.testing.assert_allclose(pe, np.asarray(jax_relpos_encoding(d, T)), rtol=0, atol=1e-6)


def test_rel_pos_attention_matches_the_nemo_oracle():
    """The port's ``rel_pos`` MHSA (unit pre-norm, all frames valid) against
    NeMo's ``RelPositionMultiHeadAttention`` re-derived in
    tests/torch_oracles.py, on the oracle's weights."""
    torch.manual_seed(0)
    d, H, D, T = 64, 2, 32, 40
    oracle = _NeMoRelPosAttention(d, H, D)
    with torch.no_grad():
        oracle.pos_bias_u.normal_(0, 0.1)
        oracle.pos_bias_v.normal_(0, 0.1)
    cfg = ConformerConfig(compute_dtype="float32",
                          **{**TINY, "position_encoding": "rel_pos", "bias_in_attn": True})
    attn = SCConformer(cfg).layers[0].attn
    with torch.no_grad():
        attn.qkv.weight.copy_(torch.cat([oracle.linear_q.weight, oracle.linear_k.weight,
                                         oracle.linear_v.weight]))
        attn.qkv.bias.copy_(torch.cat([oracle.linear_q.bias, oracle.linear_k.bias,
                                       oracle.linear_v.bias]))
        attn.out.load_state_dict(oracle.linear_out.state_dict())
        attn.linear_pos.load_state_dict(oracle.linear_pos.state_dict())
        attn.pos_bias_u.copy_(oracle.pos_bias_u)
        attn.pos_bias_v.copy_(oracle.pos_bias_v)
        x = torch.randn(2, T, d)
        mask = torch.ones(2, T, dtype=torch.bool)
        got = attn(x, mask, None, None)
        pe = relpos_encoding(d, T)[None]
        want = oracle(F.layer_norm(x, (d,), eps=1e-5), pe)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_dropout_changes_nothing_as_the_engines_call_the_model():
    """Dropout > 0 in the config: the model called as the engines call it
    (no ``deterministic=False``) gives the dropout-free output, and so does
    an NSTI run; with ``deterministic=False`` and a generator it drops."""
    rates = dict(dropout_ff=0.1, dropout_attn=0.2, dropout_conv=0.3)
    base = ConformerConfig(compute_dtype="float32", **TINY)
    plain = init_conformer(base, seed=1)
    dropped = SCConformer(dataclasses.replace(base, **rates))
    dropped.load_state_dict(plain.state_dict())
    x, lengths = torch.from_numpy(_inputs(seed=5)), torch.from_numpy(LENGTHS)
    with torch.no_grad():
        want = plain(x, lengths)["final_posteriors"]
        dropped.train()
        assert torch.equal(dropped(x, lengths)["final_posteriors"], want)
        noisy = dropped(x, lengths, deterministic=False,
                        generator=torch.Generator().manual_seed(0))["final_posteriors"]
        assert not torch.allclose(noisy, want)
        with pytest.raises(ValueError, match="Generator"):
            dropped(x, lengths, deterministic=False)
    tta = TTAConfig(seq_len=128, overlap=64, epochs=1, online=True, shuffle=False,
                    optim_args={"lr": 1e-3})
    spec = np.random.default_rng(2).standard_normal((TINY["feat_in"], 300)).astype(np.float32)
    outs = [DynamicEvalEngine(m, base.blank_id, 8, tta, device="cpu")(None, spec).numpy_logits()
            for m in (plain, dropped)]
    np.testing.assert_array_equal(outs[0], outs[1])


POLICIES = {"bitfit": dict(bitfit=True), "freeze_subsampling": dict(freeze_subsampling=True),
            "last_block_and_head": dict(last_block_and_head=True, n_layers=TINY["n_layers"]),
            "subsampling_only": dict(subsampling_only=True)}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_freeze_policies_pick_jax_labels_on_a_batch_renorm_rel_pos_model(policy):
    """JAX's label tree over a batch-renorm ``rel_pos`` model with every
    bias on, mapped to the port's names through ``params_from_jax`` (leaf i
    carried as the value i)."""
    options = dict(NEMO, default_norm="batch_renorm", subsampling_norm_out=True)
    cfg = dict(TINY, **options)
    _, variables = jax_init(JaxConfig(compute_dtype=jnp.float32, **cfg),
                            jax.random.PRNGKey(0), example_T=256)
    params = jax.tree.map(np.asarray, variables["params"])
    leaves, treedef = jax.tree_util.tree_flatten(params)
    index = jax.tree_util.tree_unflatten(
        treedef, [np.full(leaf.shape, i, np.float32) for i, leaf in enumerate(leaves)])
    jax_labels = jax.tree_util.tree_leaves(jax_param_labels(params, **POLICIES[policy]))
    port = SCConformer(ConformerConfig(compute_dtype="float32", **cfg))
    names = [n for n, _ in port.named_parameters()]
    by_name = {n: int(t.reshape(-1)[0]) for n, t in params_from_jax(index).items()}
    assert sorted(by_name) == sorted(names)
    labels = param_labels(names, **POLICIES[policy])
    assert {n: labels[n] for n in names} == {n: jax_labels[by_name[n]] for n in names}
    if policy == "bitfit":
        train = {n for n in names if labels[n] == "train"}
        assert "layers.0.attn.qkv.bias" in train and "layers.0.conv.norm_mid.bias" in train
        assert "layers.0.attn.pos_bias_u" not in train
    if policy == "freeze_subsampling":
        assert labels["subsampling.norm_out.weight"] == "freeze"
