"""The port's checkpoints against the JAX package's ``models/checkpoint.py``.

- DAE1 files cross both ways: a file the JAX package writes loads in the
  port, and one the port writes loads in JAX, each with the same config
  (kernel selections included) and the same forward on valid frames (f32,
  1e-4); for the same weights the two packages write the same bytes.
- The port's MessagePack codec (no flax, no msgpack) and
  ``flax.serialization`` decode each other's bytes to equal arrays; flax's
  chunked leaves and complex values are refused.
- Reference torch pickles: the cases of
  ``tests/test_checkpoint_load.py::TestLoadReferenceCheckpoint``, mirrored:
  the port's state dict equals ``params_from_jax`` of what the JAX loader
  gives for the same file, batch-renorm mid-norms and their running
  statistics included.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

import dynamic_asr_eval_tpu.models.checkpoint as jax_ckpt
from dynamic_asr_eval_tpu.models import ConformerConfig as JaxConfig
from dynamic_asr_eval_tpu.models import init_conformer as jax_init
from dynamic_asr_eval_tpu_torch.models import (
    ConformerConfig,
    init_conformer,
    msgpack_codec,
    params_from_jax,
    params_to_jax,
)
from dynamic_asr_eval_tpu_torch.models import checkpoint as ckpt

sys.path.insert(0, os.path.dirname(__file__))
from torch_oracles import TorchSCConformer  # noqa: E402

torch.set_num_threads(1)

TINY = dict(feat_in=32, n_layers=2, d_model=64, n_heads=2, head_dim=32, vocab_size=30,
            subsampling_factor=8, subsampling_conv_channels=16, conv_kernel_size=5)
IMPLS = [("xla", "conv"), ("pallas_flash", "pallas")]
# tests/test_checkpoint_load.py's reference dims
DIMS = dict(feat_in=16, n_layers=2, d_model=32, n_heads=2, head_dim=16, vocab_size=32,
            subsampling_factor=8, subsampling_conv_channels=8, conv_kernel_size=9)


def _inputs(feat_in, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, feat_in, 256)).astype(np.float32), np.array([256, 200])


def _jax_forward(model, variables, x, lengths):
    out = model.apply(variables, jnp.asarray(x), length=jnp.asarray(lengths))
    return np.asarray(out["final_posteriors"]), np.asarray(out["length"])


def _port_forward(model, x, lengths):
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(lengths))
    return out["final_posteriors"].numpy(), out["length"].numpy()


def _assert_same_valid_frames(a, b, lengths, atol=1e-4):
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(a[i, :n], b[i, :n], rtol=0, atol=atol)


def _jax_model(impls, **extra):
    attn, sub = impls
    cfg = JaxConfig(compute_dtype=jnp.float32, attention_impl=attn, subsampling_impl=sub,
                    **TINY, **extra)
    model, variables = jax_init(cfg, jax.random.PRNGKey(0), example_T=256)
    return cfg, model, variables


def _port_config(impls):
    attn, sub = impls
    return ConformerConfig(compute_dtype="float32", attention_impl=attn, subsampling_impl=sub,
                           **TINY)


def _same_config(port_cfg, jax_cfg):
    ours, theirs = dataclasses.asdict(port_cfg), dataclasses.asdict(jax_cfg)
    assert ours.keys() == theirs.keys()
    for k in ours:
        if k == "compute_dtype":
            assert str(ours[k]).replace("torch.", "") == jnp.dtype(theirs[k]).name
        else:
            assert ours[k] == theirs[k], k


# ---------------------------------------------------------------------------
# DAE1 files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impls", IMPLS, ids=["-".join(i) for i in IMPLS])
def test_a_jax_dae1_file_loads_in_the_port(tmp_path, impls):
    cfg, model, variables = _jax_model(impls)
    path = str(tmp_path / "jax.dae")
    jax_ckpt.save_checkpoint(path, variables, cfg, extra={"step": 3})
    port, params, port_cfg = ckpt.load_any_checkpoint(path)
    _same_config(port_cfg, cfg)
    assert (port_cfg.attention_impl, port_cfg.subsampling_impl) == impls
    ref = params_from_jax(jax.tree.map(np.asarray, variables["params"]))
    assert params.keys() == ref.keys()
    assert all(torch.equal(params[k], ref[k]) for k in ref)
    x, lengths = _inputs(TINY["feat_in"])
    (a, la), (b, lb) = _jax_forward(model, variables, x, lengths), _port_forward(port, x, lengths)
    np.testing.assert_array_equal(la, lb)
    _assert_same_valid_frames(b, a, la)


@pytest.mark.parametrize("impls", IMPLS, ids=["-".join(i) for i in IMPLS])
def test_a_port_dae1_file_loads_in_jax(tmp_path, impls):
    cfg = _port_config(impls)
    port = init_conformer(cfg, seed=3)
    path = str(tmp_path / "port.dae")
    ckpt.save_checkpoint(path, port, cfg)
    model, variables, jax_cfg = jax_ckpt.load_checkpoint(path)
    _same_config(cfg, jax_cfg)
    x, lengths = _inputs(TINY["feat_in"], seed=1)
    (a, la), (b, lb) = _jax_forward(model, variables, x, lengths), _port_forward(port, x, lengths)
    np.testing.assert_array_equal(la, lb)
    _assert_same_valid_frames(b, a, la)


def test_both_packages_write_the_same_bytes(tmp_path):
    cfg, _, variables = _jax_model(IMPLS[1])
    jax_ckpt.save_checkpoint(str(tmp_path / "jax.dae"), variables, cfg)
    state = params_from_jax(jax.tree.map(np.asarray, variables["params"]))
    # the port's module order, not the flax tree's sorted order
    state = {k: state[k] for k in init_conformer(_port_config(IMPLS[1])).state_dict()}
    ckpt.save_checkpoint(str(tmp_path / "port.dae"), state, _port_config(IMPLS[1]))
    assert (tmp_path / "port.dae").read_bytes() == (tmp_path / "jax.dae").read_bytes()


@pytest.mark.parametrize("option", ["seq_shard_axes", "subsampling"])
def test_options_not_ported_raise(tmp_path, option):
    """A DAE1 header naming an option the port does not run (rel_pos and
    batch renorm load: tests/test_torch_nemo.py).  ``seq_shard_axes`` is
    ported (sequence parallelism, tests/test_torch_sequence_parallel.py): a
    header naming it loads with the setting kept and JAX's weights."""
    extra = ({"seq_shard_axes": ("dp", "sp")} if option == "seq_shard_axes"
             else {"subsampling": "striding"})
    cfg, _, variables = _jax_model(IMPLS[0], **extra)
    path = str(tmp_path / f"{option}.dae")
    jax_ckpt.save_checkpoint(path, variables, cfg)
    if option == "seq_shard_axes":
        model, _, loaded = ckpt.load_any_checkpoint(path)
        assert tuple(loaded.seq_shard_axes) == ("dp", "sp")
        want = params_from_jax(jax.tree.map(np.asarray, variables["params"]))
        assert set(model.state_dict()) == set(want)
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[k]), k
        return
    with pytest.raises(NotImplementedError):
        ckpt.load_any_checkpoint(path)


def test_a_batch_stats_collection_raises(tmp_path):
    """Running statistics the layer-norm model has no place for."""
    cfg = _port_config(IMPLS[0])
    params = params_to_jax(init_conformer(cfg).state_dict())
    stats = {"layer_0": {"conv": {"mean": np.zeros(4, np.float32)}}}
    path = tmp_path / "stats.dae"
    ckpt.save_checkpoint(str(path), init_conformer(cfg), cfg)
    raw = path.read_bytes()
    head = 8 + int.from_bytes(raw[4:8], "little")
    path.write_bytes(raw[:head] + msgpack_codec.packb({"params": params, "batch_stats": stats}))
    with pytest.raises(KeyError, match="batch_stats"):
        ckpt.load_checkpoint(str(path))


def test_a_file_without_the_magic_is_refused(tmp_path):
    path = tmp_path / "bad.dae"
    path.write_bytes(b"NOPE" + bytes(16))
    with pytest.raises(ValueError, match="bad magic"):
        ckpt.load_checkpoint(str(path))


# ---------------------------------------------------------------------------
# the MessagePack codec against flax.serialization
# ---------------------------------------------------------------------------


def _tree():
    rng = np.random.default_rng(0)
    return {
        "params": {
            "dense": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                      "bias": rng.standard_normal(4).astype(np.float16)},
            "ids": np.arange(7, dtype=np.int64), "mask": rng.random(5) < 0.5,
            "bytes": rng.integers(0, 255, (2, 2, 2), dtype=np.uint8),
            "empty": np.zeros((0, 3), np.float32), "scalar": np.float32(2.5),
            **{f"wide_{i}": np.full((i,), i, np.int32) for i in range(18)},
        },
        "step": 12345678901, "neg": -40000, "lr": 1e-3, "name": "x" * 40, "flag": True,
        "nothing": None, "blob": b"\x00\x01" * 200,
    }


def _assert_trees_equal(a, b):
    assert type(a) is type(b) or isinstance(a, (np.ndarray, np.generic)), (type(a), type(b))
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (np.ndarray, np.generic)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b


@pytest.mark.parametrize("writer", ["port", "flax"])
def test_codec_and_flax_decode_each_others_bytes(writer):
    tree = _tree()
    data = (msgpack_codec.packb(tree) if writer == "port"
            else serialization.msgpack_serialize(tree))
    _assert_trees_equal(msgpack_codec.unpackb(data), serialization.msgpack_restore(data))
    _assert_trees_equal(msgpack_codec.unpackb(data), tree)
    # flax's tree_map writes maps with sorted keys
    assert msgpack_codec.packb(ckpt._sorted_tree(tree)) == serialization.msgpack_serialize(tree)


def test_codec_widens_bfloat16_leaves_exactly():
    x = jnp.asarray([1.5, -2.25, 3.0e-3], jnp.bfloat16)
    got = msgpack_codec.unpackb(serialization.msgpack_serialize({"w": x}))["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(x, np.float32))


def test_codec_refuses_flax_chunked_leaves(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 16)
    data = serialization.msgpack_serialize({"w": np.ones(64, np.float32)})
    with pytest.raises(NotImplementedError, match="chunked"):
        msgpack_codec.unpackb(data)
    monkeypatch.setattr(msgpack_codec, "MAX_LEAF_BYTES", 16)
    with pytest.raises(NotImplementedError, match="chunked"):
        msgpack_codec.packb({"w": np.ones(64, np.float32)})


@pytest.mark.parametrize("value", [np.ones(3, np.complex64), 1 + 2j])
def test_codec_refuses_complex_values(value):
    with pytest.raises(NotImplementedError, match="complex"):
        msgpack_codec.unpackb(serialization.msgpack_serialize({"c": value}))
    with pytest.raises(NotImplementedError, match="complex"):
        msgpack_codec.packb({"c": value})


# ---------------------------------------------------------------------------
# reference torch pickles (tests/test_checkpoint_load.py, mirrored)
# ---------------------------------------------------------------------------


def _torch_ckpt(tmp_path, state, config, name="ref.pt"):
    path = str(tmp_path / name)
    torch.save({"model": state, "config": config}, path)
    return path


def _ref_yaml_config(**overrides):
    model = dict(DIMS)
    model.update(dropout_ff=0.0, flash_attn=False, subsampling="dw_striding",
                 subsampling_act="silu", encoder_mode="conformer", default_norm="layer_norm",
                 use_rotary=True, rotary_base_freq=1_500_000, self_conditioning=True,
                 decoder_norm=True)
    model.update(overrides)
    return {"model": model, "model_class": "SCConformerXL", "training": {"dtype": "float32"}}


def _both(path, **kwargs):
    """(port (model, params, config), JAX (model, variables, config)) for one
    file, both f32."""
    ours = ckpt.load_reference_torch_checkpoint(path, compute_dtype="float32", **kwargs)
    theirs = jax_ckpt.load_reference_torch_checkpoint(path, compute_dtype=jnp.float32, **kwargs)
    return ours, theirs


def _assert_port_equals_jax(ours, theirs, skip=()):
    (_, params, cfg), (_, variables, jcfg) = ours, theirs
    _same_config(cfg, jcfg)
    ref = params_from_jax(jax.tree.map(np.asarray, variables["params"]))
    assert params.keys() == ref.keys()
    for k in ref:
        if k not in skip:
            assert torch.equal(params[k], ref[k]), k


def test_reference_with_config_matches_the_jax_loader(tmp_path):
    torch.manual_seed(0)
    tm = TorchSCConformer(**DIMS).eval()
    path = _torch_ckpt(tmp_path, tm.state_dict(), _ref_yaml_config())
    ours, theirs = _both(path)
    _assert_port_equals_jax(ours, theirs)
    assert all(torch.equal(ours[1][k], v) for k, v in tm.state_dict().items())
    x, lengths = _inputs(DIMS["feat_in"], seed=2)
    (a, la), (b, lb) = _jax_forward(theirs[0], theirs[1], x, lengths), _port_forward(ours[0], x, lengths)
    _assert_same_valid_frames(b, a, la)


def test_reference_config_free_shape_inference(tmp_path):
    torch.manual_seed(1)
    tm = TorchSCConformer(**DIMS).eval()
    path = str(tmp_path / "bare.pt")
    torch.save(tm.state_dict(), path)
    ours = ckpt.load_any_checkpoint(path, compute_dtype="float32")
    theirs = jax_ckpt.load_any_checkpoint(path, compute_dtype=jnp.float32)
    _assert_port_equals_jax(ours, theirs)
    cfg = ours[2]
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.conv_kernel_size) == (
        DIMS["n_layers"], DIMS["d_model"], DIMS["vocab_size"], DIMS["conv_kernel_size"])
    assert cfg.n_heads * cfg.head_dim == DIMS["n_heads"] * DIMS["head_dim"]


def test_reference_ddp_prefixes(tmp_path):
    torch.manual_seed(2)
    tm = TorchSCConformer(**DIMS).eval()
    state = {f"module.{k}": v for k, v in tm.state_dict().items()}
    ours, theirs = _both(_torch_ckpt(tmp_path, state, _ref_yaml_config()), verbose=False)
    _assert_port_equals_jax(ours, theirs)


def test_reference_batch_renorm_detection_raises_in_the_port(tmp_path):
    """Mid-norms with running statistics under a config that says
    layer_norm: both packages detect batch renorm, load the statistics and
    drop ``num_batches_tracked``, and give the same forward."""
    torch.manual_seed(2)
    tm = TorchSCConformer(default_norm="batch_renorm", **DIMS).eval()
    with torch.no_grad():
        for layer in tm.layers:
            layer.conv.norm_mid.running_mean.normal_(0, 0.1)
            layer.conv.norm_mid.running_var.uniform_(0.5, 2.0)
    state = {f"module.{k}": v for k, v in tm.state_dict().items()}
    state.update({f"module.layers.{n}.conv.norm_mid.num_batches_tracked": torch.tensor(7)
                  for n in range(DIMS["n_layers"])})
    path = _torch_ckpt(tmp_path, state, _ref_yaml_config(default_norm="layer_norm"))
    ours, theirs = _both(path, verbose=False)
    assert ours[2].default_norm == theirs[2].default_norm == "batch_renorm"
    _same_config(ours[2], theirs[2])
    ref = params_from_jax(jax.tree.map(np.asarray, dict(theirs[1])))
    assert ours[1].keys() == ref.keys()
    assert all(torch.equal(ours[1][k], ref[k]) for k in ref)
    assert torch.equal(ours[1]["layers.1.conv.norm_mid.running_var"],
                       tm.layers[1].conv.norm_mid.running_var)
    x, lengths = _inputs(DIMS["feat_in"], seed=2)
    (a, la), (b, _) = _jax_forward(theirs[0], theirs[1], x, lengths), _port_forward(ours[0], x,
                                                                                     lengths)
    _assert_same_valid_frames(b, a, la)


def test_reference_omegaconf_pickled_config(tmp_path):
    ckpt._install_omegaconf_stub()
    import omegaconf.dictconfig as ocd
    import omegaconf.nodes as ocn

    def node(v):
        n = ocn.ValueNode.__new__(ocn.ValueNode)
        n.__dict__["_val"] = v
        return n

    def dconf(d):
        c = ocd.DictConfig.__new__(ocd.DictConfig)
        c.__dict__["_content"] = d
        c.__dict__["_metadata"] = None
        return c

    cfg_obj = dconf({"model": dconf({k: node(v) for k, v in DIMS.items()}),
                     "model_class": node("SCConformerXL")})
    torch.manual_seed(3)
    tm = TorchSCConformer(**DIMS).eval()
    ours, theirs = _both(_torch_ckpt(tmp_path, tm.state_dict(), cfg_obj, "oc.pt"), verbose=False)
    _assert_port_equals_jax(ours, theirs)
    assert (ours[2].n_heads, ours[2].head_dim) == (DIMS["n_heads"], DIMS["head_dim"])


def test_reference_strict_false_keeps_init_for_missing(tmp_path):
    torch.manual_seed(4)
    tm = TorchSCConformer(**DIMS).eval()
    state = dict(tm.state_dict())
    dropped = [k for k in state if k.startswith("layers.0.norm_out")]
    for k in dropped:
        del state[k]
    assert dropped
    path = _torch_ckpt(tmp_path, state, _ref_yaml_config(), "partial.pt")
    ours, theirs = _both(path, verbose=False)
    _assert_port_equals_jax(ours, theirs, skip=dropped)
    fresh = init_conformer(ours[2], seed=0).state_dict()
    assert all(torch.equal(ours[1][k], fresh[k]) for k in dropped)


def test_reference_shape_mismatch_raises(tmp_path):
    torch.manual_seed(5)
    tm = TorchSCConformer(**DIMS).eval()
    state = dict(tm.state_dict())
    state["decoder.weight"] = torch.zeros(7, DIMS["d_model"])
    path = _torch_ckpt(tmp_path, state, _ref_yaml_config(), "bad.pt")
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.load_reference_torch_checkpoint(path, compute_dtype="float32", verbose=False)


def test_reference_extra_keys_are_dropped(tmp_path, capsys):
    torch.manual_seed(6)
    tm = TorchSCConformer(**DIMS).eval()
    state = dict(tm.state_dict(), **{"unused.weight": torch.ones(3)})
    ours, theirs = _both(_torch_ckpt(tmp_path, state, _ref_yaml_config(), "extra.pt"))
    _assert_port_equals_jax(ours, theirs)
    assert "unused.weight" in capsys.readouterr().err


def test_infer_dims_and_merge_match_jax():
    torch.manual_seed(6)
    state = TorchSCConformer(**DIMS).eval().state_dict()
    dims = ckpt.infer_conformer_dims(state)
    assert dims == jax_ckpt.infer_conformer_dims({k: v.numpy() for k, v in state.items()})
    for model_cfg in ({}, {"n_heads": 4}, {"head_dim": 8, "feat_in": 15},
                      {"n_heads": 3, "head_dim": 16, "feat_in": 999}):
        assert ckpt._merge_reference_config(model_cfg, dims) == \
            jax_ckpt._merge_reference_config(model_cfg, dict(dims))
