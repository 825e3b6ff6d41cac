"""NeMo checkpoints, batch-stats DAE1 files and model surgery in the port,
against the JAX package (after tests/test_nemo_convert.py).

The NeMo state dict is synthesised with NeMo's names and shapes
(``tests/test_nemo_convert.py::synthetic_nemo_state_dict``, its running
statistics made non-trivial: mean ~ N(0, 0.1), var ~ U(0.5, 2)) on the tiny
NeMo config there (feat 16, 2 layers, d 32, 2 × 16 heads, vocab 28, ×8 with
8 channels, ``rel_pos``, ``input_xscale``, biases, ``batch_norm``), f32.
Bars: the converted port model gives JAX's converted model's log-probs
within 1e-4 on valid frames, and the NeMo oracle's (tests/torch_oracles.py)
within 1e-4 on a full-length batch; DAE1 files of a ``batch_stats`` model
are byte-identical between the packages (the JAX file written from the
variables with flax's sorted keys, as its init and loader give them) and
load in both to equal weights; surgery equals JAX's.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dynamic_asr_eval_tpu.models.checkpoint as jax_ckpt
import dynamic_asr_eval_tpu.models.nemo_convert as jax_nemo
import dynamic_asr_eval_tpu.models.surgery as jax_surgery
from dynamic_asr_eval_tpu.models import SCConformer as JaxSCConformer
from dynamic_asr_eval_tpu_torch.models import (
    ConformerConfig,
    SCConformer,
    params_from_jax,
    variables_to_jax,
)
from dynamic_asr_eval_tpu_torch.models import checkpoint as ckpt
from dynamic_asr_eval_tpu_torch.models import nemo_convert, surgery

sys.path.insert(0, os.path.dirname(__file__))
from test_nemo_convert import synthetic_nemo_state_dict, tiny_nemo_cfg  # noqa: E402
from torch_oracles import TorchNeMoConformer  # noqa: E402

torch.set_num_threads(1)

LENGTHS = np.array([203, 150])


def _port_config(jcfg):
    import dataclasses

    return ConformerConfig.from_dict({**dataclasses.asdict(jcfg), "compute_dtype": "float32"})


def _nemo_state(cfg, seed=0):
    F_ds = -(-cfg.feat_in // cfg.subsampling_factor)
    sd = synthetic_nemo_state_dict(cfg, F_ds)
    rng = np.random.default_rng(seed)
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = 0.1 * rng.standard_normal(sd[k].shape).astype(np.float32)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 2.0, sd[k].shape).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def converted():
    jcfg = tiny_nemo_cfg()
    sd = _nemo_state(jcfg)
    variables = jax_nemo.convert_nemo_state_dict(sd, jcfg)
    cfg = _port_config(jcfg)
    state = nemo_convert.convert_nemo_state_dict(sd, cfg)
    model = SCConformer(cfg)
    model.load_state_dict(state, strict=True)
    return jcfg, variables, cfg, model, sd


def test_conversion_is_shape_complete(converted):
    *_, model, sd = converted
    state = nemo_convert.convert_nemo_state_dict(sd, model.config)
    template = model.state_dict()
    assert state.keys() == template.keys()
    assert all(state[k].shape == template[k].shape for k in state)


def test_port_conversion_equals_jax_conversion(converted):
    jcfg, variables, cfg, model, _ = converted
    ref = params_from_jax(jax.tree.map(np.asarray, dict(variables)))
    state = model.state_dict()
    assert state.keys() == ref.keys()
    assert all(torch.equal(state[k], ref[k]) for k in ref)


def test_converted_model_matches_jax_on_valid_frames(converted):
    jcfg, variables, _, model, _ = converted
    x = np.random.default_rng(1).standard_normal((2, jcfg.feat_in, 203)).astype(np.float32)
    with jax.disable_jit():
        ref = JaxSCConformer(jcfg).apply(variables, jnp.asarray(x), length=jnp.asarray(LENGTHS))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(LENGTHS))
    ds = np.asarray(ref["length"])
    np.testing.assert_array_equal(out["length"].numpy(), ds)
    for b in range(2):
        np.testing.assert_allclose(out["final_posteriors"][b, : ds[b]].numpy(),
                                   np.asarray(ref["final_posteriors"])[b, : ds[b]],
                                   rtol=0, atol=1e-4)


def test_converted_model_matches_the_nemo_oracle():
    """The oracle's own state dict (eval-mode batch norms with moved
    statistics) through the port's converter; T a multiple of 8, no
    padding, where the two subsampling semantics agree."""
    torch.manual_seed(0)
    jcfg = tiny_nemo_cfg(conv_kernel_size=9)
    oracle = TorchNeMoConformer(feat_in=jcfg.feat_in, n_layers=jcfg.n_layers,
                                d_model=jcfg.d_model, n_heads=jcfg.n_heads,
                                head_dim=jcfg.head_dim, vocab_size=jcfg.vocab_size,
                                subsampling_conv_channels=jcfg.subsampling_conv_channels,
                                conv_kernel_size=9).eval()
    with torch.no_grad():
        for layer in oracle.encoder.layers:
            layer.self_attn.pos_bias_u.normal_(0, 0.1)
            layer.self_attn.pos_bias_v.normal_(0, 0.1)
            layer.conv.batch_norm.running_mean.normal_(0, 0.1)
            layer.conv.batch_norm.running_var.uniform_(0.5, 2.0)
        x = torch.randn(2, jcfg.feat_in, 128)
        want = oracle(x)["final_posteriors"]
    model, _ = nemo_convert.load_from_old_state_dict(oracle.state_dict(),
                                                     config=_port_config(jcfg))
    with torch.no_grad():
        got = model(x)["final_posteriors"]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_load_from_old_state_dict_torch_pickle_with_ddp_prefixes(converted, tmp_path):
    jcfg, _, cfg, model, sd = converted
    path = str(tmp_path / "old.pt")
    torch.save({"model": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}}, path)
    loaded, state = nemo_convert.load_from_old_state_dict(path, config=cfg)
    assert all(torch.equal(state[k], v) for k, v in model.state_dict().items())
    _, jvars = jax_nemo.load_from_old_state_dict(path, config=jcfg)
    ref = params_from_jax(jax.tree.map(np.asarray, dict(jvars)))
    assert all(torch.equal(state[k], ref[k]) for k in ref)


def test_presets_equal_jax():
    import dataclasses

    assert nemo_convert.NEMO_PRESETS.keys() == jax_nemo.NEMO_PRESETS.keys()
    for name, cfg in nemo_convert.NEMO_PRESETS.items():
        ours = dataclasses.asdict(cfg)
        theirs = dataclasses.asdict(jax_nemo.NEMO_PRESETS[name])
        assert ours.pop("compute_dtype") == torch.bfloat16
        assert jnp.dtype(theirs.pop("compute_dtype")) == jnp.bfloat16
        assert ours == theirs
    cfg = nemo_convert.load_default_instance()
    assert (cfg.pos_encoding, cfg.subsampling_factor, cfg.n_layers) == ("rel_pos", 8, 17)
    SCConformer(cfg)  # every option of the preset is ported


def test_batch_stats_dae1_files_are_byte_identical_and_load_in_both(converted, tmp_path):
    jcfg, variables, cfg, model, _ = converted
    jpath, ppath = str(tmp_path / "jax.dae"), str(tmp_path / "port.dae")
    jax_ckpt.save_checkpoint(jpath, jax.tree.map(jnp.asarray, dict(variables)), jcfg)
    ckpt.save_checkpoint(ppath, model, cfg)
    with open(jpath, "rb") as a, open(ppath, "rb") as b:
        assert a.read() == b.read()
    _, state, loaded_cfg = ckpt.load_checkpoint(jpath)
    assert loaded_cfg == cfg
    assert all(torch.equal(state[k], v) for k, v in model.state_dict().items())
    _, jvars, _ = jax_ckpt.load_checkpoint(ppath)
    assert set(jvars) == {"params", "batch_stats"}
    ref = params_from_jax(jax.tree.map(np.asarray, dict(jvars)))
    assert all(torch.equal(ref[k], v) for k, v in model.state_dict().items())


def test_reference_pt_with_running_statistics_loads(tmp_path):
    """An lcasr-named port model with batch-renorm mid-norms and moved
    running statistics, as a reference pickle with DDP prefixes and a config
    that names no norm: both packages load it as batch renorm with the same
    weights and statistics."""
    from dynamic_asr_eval_tpu_torch.models import init_conformer

    cfg = ConformerConfig(feat_in=16, n_layers=2, d_model=32, n_heads=2, head_dim=16,
                          vocab_size=28, subsampling_conv_channels=8, conv_kernel_size=5,
                          default_norm="batch_renorm", compute_dtype="float32")
    model = init_conformer(cfg, seed=4)
    with torch.no_grad():
        for layer in model.layers:
            layer.conv.norm_mid.running_mean.normal_(0, 0.1)
            layer.conv.norm_mid.running_var.uniform_(0.5, 2.0)
    state = {f"module.{k}": v for k, v in model.state_dict().items()}
    path = str(tmp_path / "ref.pt")
    torch.save({"model": state, "config": {"model": {"n_heads": cfg.n_heads}}}, path)
    _, ours, cfg_p = ckpt.load_any_checkpoint(path, compute_dtype="float32")
    _, theirs, cfg_j = jax_ckpt.load_any_checkpoint(path, compute_dtype=jnp.float32)
    assert cfg_p.default_norm == cfg_j.default_norm == "batch_renorm"
    assert ours.keys() == model.state_dict().keys()
    assert all(torch.equal(ours[k], v) for k, v in model.state_dict().items())
    ref = params_from_jax(jax.tree.map(np.asarray, dict(theirs)))
    assert ref.keys() == ours.keys() and all(torch.equal(ours[k], ref[k]) for k in ref)


def test_surgery_equals_jax(converted):
    *_, model, sd = converted
    prefix = "encoder.layers.0.conv.batch_norm"
    ours = surgery.convert_torch_batchnorm_state(prefix, {k: torch.from_numpy(v)
                                                          for k, v in sd.items()})
    theirs = jax_surgery.convert_torch_batchnorm_state(prefix, sd)
    assert ours.keys() == theirs.keys()
    brn, jbrn = surgery.batchnorm_to_batchrenorm(ours), jax_surgery.batchnorm_to_batchrenorm(theirs)
    for coll in ("params", "batch_stats"):
        assert brn[coll].keys() == jbrn[coll].keys()
        for k in brn[coll]:
            np.testing.assert_array_equal(brn[coll][k].numpy(), np.asarray(jbrn[coll][k]))
    assert brn["batch_stats"]["var"].dtype == torch.float32
    names = [n for n, _ in model.named_parameters()]
    labels = surgery.nvidia_freeze_labels(names)
    index = {}
    jvars = variables_to_jax(model.state_dict())
    leaves, treedef = jax.tree_util.tree_flatten(jvars["params"])
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(l.shape, i, np.float32) for i, l in enumerate(leaves)])
    for n, t in params_from_jax(tagged).items():
        index[n] = int(t.reshape(-1)[0])
    jlabels = jax.tree_util.tree_leaves(jax_surgery.nvidia_freeze_labels(jvars["params"]))
    assert labels == {n: jlabels[index[n]] for n in names}
    assert labels["subsampling.conv_in.weight"] == labels["decoder.bias"] == "freeze"
    assert labels["layers.1.attn.pos_bias_u"] == "train"

