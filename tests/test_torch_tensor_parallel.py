"""Tensor parallelism on ``torch.distributed``: two gloo ranks on the CPU
against the JAX package (GSPMD on a mesh of virtual CPU devices) and
against the serial port.

Two rank processes are spawned once for the module (``torchrun``'s
environment set by hand); each loads the same one-layer f32 conformer (the
port's seeded weights, which JAX gets through ``variables_to_jax``; no
dropout) and, on ``make_mesh(tp=2)``:

- reports ``conformer_param_sharding`` and whether ``gather_params`` of
  ``shard_params`` gives the weights back;
- runs the NSTI engine (online, 1 epoch, the zero-mask augmentation
  config) on a 700-frame recording (5 windows of 256, overlap 128) with
  the engine's working copy sharded, returning the stitched log-probs, the
  greedy ids and the gathered adapted weights; and ``batched`` on two
  recordings (the collectives' vmap rules) with the tp engine;
- runs ``run.cli`` with ``--dp --tp 2``, with ``--dp_records --tp 2`` and
  with ``--awmc --dp --tp 2`` (world size 2: dp 1 x tp 2).

The JAX engines run with ``lax.scan``'s ``unroll`` dropped
(tests/test_torch_engine.py says why).  Bars: JAX's own for its sharded
engine (5e-4, ``tests/test_parallel.py:551``); against JAX's unsharded
engine the port's (stitched log-probs 1e-4, adapted weights 2e-5, greedy
ids equal); the drivers' transcripts and WER equal to the serial driver's.
"""

import json
import os
import pathlib
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamic_asr_eval_tpu.config import TTAConfig as JaxTTAConfig
from dynamic_asr_eval_tpu.models import ConformerConfig as JaxConfig
from dynamic_asr_eval_tpu.models import SCConformer as JaxConformer
from dynamic_asr_eval_tpu.models.convert import convert_lcasr_checkpoint
from dynamic_asr_eval_tpu.parallel import conformer_param_sharding as jax_param_sharding
from dynamic_asr_eval_tpu.parallel import make_mesh as jax_make_mesh
from dynamic_asr_eval_tpu.parallel import shard_params as jax_shard_params
from dynamic_asr_eval_tpu.tta import DynamicEvalEngine as JaxEngine
from dynamic_asr_eval_tpu_torch.evals import run
from dynamic_asr_eval_tpu_torch.models import (
    ConformerConfig, SCConformer, init_conformer, variables_to_jax)
from dynamic_asr_eval_tpu_torch.models.convert import jax_path
from dynamic_asr_eval_tpu_torch.parallel import Shard, conformer_param_sharding
from test_torch_engine import rolled_scans

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(feat_in=32, n_layers=1, d_model=64, n_heads=2, head_dim=32, vocab_size=28,
            subsampling_factor=8, subsampling_conv_channels=16, conv_kernel_size=5,
            attention_impl="xla")
TTA = dict(seq_len=256, overlap=128, epochs=1, online=True, shuffle=False, lm_tta_beams=0,
           optim_args={"lr": 1e-3})
FRAMES = 700
DRIVER_ARGV = ["-d", "synthetic", "--quiet", "--device", "cpu"]
# every parameter kind a conformer has, for the sharding map
SHARDING_MODEL = dict(TINY, position_encoding="rel_pos", bias_in_attn=True, bias_in_ff=True,
                      default_norm="batch_renorm")

_RANK = """
import json, os, pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
from dynamic_asr_eval_tpu_torch.config import TTAConfig
from dynamic_asr_eval_tpu_torch.evals import run
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, SCConformer, init_conformer
from dynamic_asr_eval_tpu_torch.parallel import (
    conformer_param_sharding, gather_params, init_process_group, make_mesh, shard_params)
from dynamic_asr_eval_tpu_torch.tta import DynamicEvalEngine

work = sys.argv[1]
setup = json.load(open(os.path.join(work, "setup.json")))
rank = int(os.environ["RANK"])
init_process_group("cpu")
mesh = make_mesh(tp=2)
cfg = ConformerConfig(compute_dtype="float32", **setup["model"])
state = torch.load(os.path.join(work, "weights.pt"))
spec = np.load(os.path.join(work, "spec.npy"))

wide = init_conformer(ConformerConfig(compute_dtype="float32", **setup["sharding_model"]), seed=3)
sharding = {k: None if s is None else list(s)
            for k, s in conformer_param_sharding(wide, mesh).items()}
full = {k: v.clone() for k, v in wide.state_dict().items()}
shard_params(wide, mesh)
back = gather_params(wide, mesh)
roundtrip = set(back) == set(full) and all(torch.equal(back[k], full[k]) for k in full)
local_shapes = {k: list(v.shape) for k, v in wide.state_dict().items()}

model = SCConformer(cfg)
model.load_state_dict(state)
engine = DynamicEvalEngine(model, cfg.blank_id, cfg.subsampling_factor,
                           TTAConfig(**setup["tta"]), mesh=mesh, device="cpu")
out = engine(state, spec, return_params=True)
batched = engine.batched(state, [spec, spec[:, :400]], rngs=[0, 1], return_params=True)
serial_second = engine(state, spec[:, :400], rng=1)
result = {"sharding": sharding, "roundtrip": roundtrip, "local_shapes": local_shapes,
          "logits": out.numpy_logits(), "counts": out.counts.numpy(), "ids": out.greedy_ids(),
          "params": {k: v.numpy() for k, v in out.params.items()},
          "batched": [o.numpy_logits() for o in batched],
          "batched_params": {k: v.numpy() for k, v in batched[0].params.items()},
          "serial_second": serial_second.numpy_logits()}
for flag in ("--dp", "--dp_records", "--awmc --dp"):
    path = os.path.join(work, f"driver{flag.replace(' ', '')}_rank{rank}.pkl")
    wer = run.cli(setup["driver_argv"] + flag.split() + ["--tp", "2", "-s", path],
                  model_config=ConformerConfig(**setup["driver_model"]))
    result[flag] = wer
with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(result, f)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def driver_model():
    """The drivers' model on the synthetic dataset's 80 features."""
    return dict(TINY, feat_in=80, subsampling_factor=4, subsampling_conv_channels=8,
                compute_dtype="float32")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    work = tmp_path_factory.mktemp("tensor_parallel")
    jcfg = JaxConfig(compute_dtype=jnp.float32, **TINY)
    model = JaxConformer(jcfg)
    state = init_conformer(ConformerConfig(compute_dtype="float32", **TINY), seed=0).state_dict()
    variables = variables_to_jax(state)
    spec = np.random.default_rng(1).standard_normal((TINY["feat_in"], FRAMES)).astype(np.float32)
    torch.save(state, work / "weights.pt")
    np.save(work / "spec.npy", spec)
    (work / "setup.json").write_text(json.dumps(
        {"model": TINY, "tta": TTA, "sharding_model": SHARDING_MODEL,
         "driver_argv": DRIVER_ARGV, "driver_model": driver_model()}))
    script = work / "rank.py"
    script.write_text(_RANK)
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, str(script), str(work)], cwd=work,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]  # they run while JAX compiles
    return work, jcfg, model, variables, state, spec, procs


@pytest.fixture(scope="module")
def ranks(setup):
    work, procs = setup[0], setup[-1]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    results = []
    for r in range(2):
        with open(work / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def jax_runs(setup):
    """JAX's engine unsharded, and on ``make_mesh(tp=2)`` with
    ``shard_params`` (dp 4 x tp 2 over the 8 virtual devices)."""
    _, jcfg, model, variables, _, spec, _ = setup
    tta = JaxTTAConfig(**TTA)
    with rolled_scans():
        plain = JaxEngine(model, jcfg.blank_id, 8, tta)(variables, spec, return_params=True)
        mesh = jax_make_mesh(tp=2)
        placed, _ = jax_shard_params(variables["params"], mesh)
        sharded = JaxEngine(model, jcfg.blank_id, 8, tta, mesh=mesh)(
            {**variables, "params": placed}, spec)
    return plain, sharded


def test_tp_engine_matches_jax_sharded_engine_at_its_bar(ranks, jax_runs):
    _, sharded = jax_runs
    want = np.asarray(sharded.logits)[np.asarray(sharded.counts) > 0]
    for out in ranks:
        np.testing.assert_allclose(out["logits"], want, rtol=5e-4, atol=5e-4)
        np.testing.assert_array_equal(out["counts"], np.asarray(sharded.counts))


def test_tp_engine_matches_jax_unsharded_engine(ranks, jax_runs):
    plain, _ = jax_runs
    for out in ranks:
        np.testing.assert_allclose(out["logits"], plain.numpy_logits(), rtol=0, atol=1e-4)
        np.testing.assert_array_equal(out["ids"], plain.greedy_ids())


def test_tp_engine_gathered_weights_match_jax(ranks, jax_runs, setup):
    plain, _ = jax_runs
    initial = setup[3]["params"]
    ref = dict(jax.tree_util.tree_leaves_with_path(plain.params))
    init = dict(jax.tree_util.tree_leaves_with_path(initial))
    for out in ranks:
        back, unmatched = convert_lcasr_checkpoint(out["params"])
        assert unmatched == []
        moved = 0.0
        for path, leaf in jax.tree_util.tree_leaves_with_path(back["params"]):
            np.testing.assert_allclose(np.asarray(leaf), np.asarray(ref[path]), rtol=0, atol=2e-5)
            moved = max(moved, float(np.abs(np.asarray(ref[path]) - np.asarray(init[path])).max()))
        assert moved > 1e-3  # adaptation moved the weights: the bar means something


def test_tp_records_batching_matches_the_tp_engine(ranks):
    """``batched`` with sharded per-record weights (the collectives under
    vmap) gives each record what the tp engine gives it alone."""
    for out in ranks:
        np.testing.assert_allclose(out["batched"][0], out["logits"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(out["batched"][1], out["serial_second"], rtol=0, atol=1e-5)
        for k, v in out["batched_params"].items():
            np.testing.assert_allclose(v, out["params"][k], rtol=0, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def serial_driver(setup):
    """The serial driver's WER and pickle, with the NSTI engine and with
    ``--awmc``."""
    work, out = setup[0], {}
    for engine in ("", "--awmc"):
        wer = run.cli(DRIVER_ARGV + engine.split() + ["-s", str(work / f"serial{engine}.pkl")],
                      model_config=ConformerConfig(**driver_model()))
        with open(work / f"serial{engine}_1.pkl", "rb") as f:
            out[engine] = wer, pickle.load(f)
    return out


@pytest.mark.parametrize("flag", ["--dp", "--dp_records", "--awmc --dp"])
def test_driver_with_tp_2_matches_the_serial_driver(ranks, setup, serial_driver, flag):
    work, name = setup[0], flag.replace(" ", "")
    wer, serial = serial_driver["--awmc" if "--awmc" in flag else ""]
    assert any(serial["model_output"])
    for r, out in enumerate(ranks):
        assert out[flag] == wer, r
    with open(work / f"driver{name}_rank0_1.pkl", "rb") as f:
        lead = pickle.load(f)
    assert lead["model_output"] == serial["model_output"]
    assert lead["wer"] == serial["wer"]
    assert not (work / f"driver{name}_rank1_1.pkl").exists()  # rank 0 alone pickles


def test_gather_of_shard_is_the_identity(ranks):
    for out in ranks:
        assert out["roundtrip"]
    a, b = ranks
    assert a["local_shapes"] == b["local_shapes"]
    assert a["local_shapes"]["layers.0.attn.qkv.weight"] == [3 * 32, 64]  # one head of 2
    assert a["local_shapes"]["layers.0.conv.pw1.weight"] == [64, 64, 1]  # 2 x 32 GLU pairs


class _TpMesh:
    """A mesh of dp 1 x tp ``n``: all ``conformer_param_sharding`` reads."""

    mesh_dim_names = ("dp", "tp")

    def __init__(self, n):
        self.n = n

    def size(self, dim):
        return (1, self.n)[dim]


# where the port splits and JAX's GSPMD rules replicate: a split layer's
# bias, the depthwise kernel and bias, the mid norm, rel_pos's projections
_CHANNEL_FOLLOWERS = ("in_proj.bias", "qkv.bias", "pw1.bias", "dw.weight", "dw.bias",
                      "norm_mid.", "linear_pos.weight", "pos_bias_u", "pos_bias_v")


@pytest.mark.parametrize("tp", [2, 4])
def test_param_sharding_follows_jax_rules(tp, ranks):
    """Split or replicated, name by name, against JAX's
    ``conformer_param_sharding`` on ``make_mesh(tp=tp)``: the same except
    where the port slices what GSPMD needs not (the channel followers) and,
    at tp 4 on 2 heads, attention (JAX splits ``qkv``'s 3·H·D columns, the
    port splits only whole heads)."""
    port = SCConformer(ConformerConfig(compute_dtype="float32", **SHARDING_MODEL))
    variables = variables_to_jax(port.state_dict())
    jax_specs = {
        "/".join(str(getattr(p, "key", p)) for p in path): leaf.spec
        for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax_param_sharding(variables["params"], jax_make_mesh(tp=tp)),
            is_leaf=lambda x: hasattr(x, "spec"))}
    mine = conformer_param_sharding(port, _TpMesh(tp))
    if tp == 2:  # the ranks' own map on the real mesh
        assert {k: None if s is None else Shard(*s)
                for k, s in ranks[0]["sharding"].items()} == mine
    heads_split = SHARDING_MODEL["n_heads"] % tp == 0
    for name, _ in port.named_parameters():
        path = jax_path(name).replace("norm/LayerNorm_0", "norm/BatchRenorm_0")
        jax_split = any(a is not None for a in jax_specs[path])
        follower = any(f in name for f in _CHANNEL_FOLLOWERS)
        if ".attn." in name and not heads_split:
            want = False
        else:
            want = jax_split or (follower and name.startswith("layers."))
        assert (mine[name] is not None) == want, (name, mine[name], jax_split)
    for name, _ in port.named_buffers():  # the batch-renorm running statistics
        assert mine[name] == Shard(0), name
