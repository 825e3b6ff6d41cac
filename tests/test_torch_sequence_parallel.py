"""Sequence parallelism (``seq_shard_axes`` under ``use_mesh``), alone and
with tensor parallelism, on gloo ranks on the CPU, against the JAX
package's unsharded model; and the query-block attention's plain versions
against the rows of JAX's Pallas attention.

Two jobs of rank processes are spawned once for the module (``torchrun``'s
environment set by hand) and run while JAX computes its references:

- 2 ranks on a ``('dp', 'sp')`` mesh of 1 x 2: the forward of an f32
  conformer on a batch of 2 x 200 frames (lengths 200 and 131: T_ds 25,
  odd, and a ragged row) with rotary attention ``"xla"`` (2 layers:
  self-conditioning between the blocks) and ``"pallas_flash"`` (the plain
  version on the CPU), ``rel_pos``, and batch renorm on batch statistics
  (1 layer each); then one NSTI step (the engine, online, one 256-frame
  window, ``"pallas_flash"``) of a one-layer model;
- 4 ranks on a ``('dp', 'tp', 'sp')`` mesh of 1 x 2 x 2: the same NSTI step
  with the engine's working copy sharded over tp, as JAX's
  ``tests/test_parallel.py:149`` takes a step on its dp x tp x sp mesh, at
  dp 1.

The weights are the port's seeded ones with every bias, norm scale and
running statistic drawn from a numpy seed, handed to JAX through
``variables_to_jax`` (JAX's compiles are the file's cost).  Bars: log-probs
within 1e-4 of JAX's on valid frames (batch renorm's running statistics
within 1e-6); the step's stitched log-probs within 1e-4 and its weights
within 2e-5 of JAX's unsharded step.  The JAX engine runs with
``lax.scan``'s ``unroll`` dropped (tests/test_torch_engine.py says why); the
augmentation is the zero-mask config.
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
from jax.experimental.pallas import tpu as pltpu

from dynamic_asr_eval_tpu.config import TTAConfig as JaxTTAConfig
from dynamic_asr_eval_tpu.kernels.attention import flash_attention as jax_flash_attention
from dynamic_asr_eval_tpu.models import ConformerConfig as JaxConfig
from dynamic_asr_eval_tpu.models import SCConformer as JaxConformer
from dynamic_asr_eval_tpu.models.convert import convert_lcasr_checkpoint
from dynamic_asr_eval_tpu.tta import DynamicEvalEngine as JaxEngine
from dynamic_asr_eval_tpu_torch.kernels import attention as A
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, init_conformer, variables_to_jax
from test_torch_engine import rolled_scans

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
BASE = dict(feat_in=32, n_layers=2, d_model=64, n_heads=2, head_dim=32, vocab_size=28,
            subsampling_factor=8, subsampling_conv_channels=16, conv_kernel_size=5,
            attention_impl="xla")
FORWARDS = {
    "rotary_xla": {},
    "rotary_pallas_flash": dict(attention_impl="pallas_flash", n_layers=1),
    "rel_pos": dict(position_encoding="rel_pos", use_rotary=False, n_layers=1),
    "batch_renorm_batch_stats": dict(default_norm="batch_renorm", n_layers=1),
}
LENGTHS = [200, 131]  # T_ds 25 (odd) and 17 (ragged)
STEP_MODEL = dict(BASE, n_layers=1, attention_impl="pallas_flash")
STEP_TTA = dict(seq_len=256, overlap=128, epochs=1, online=True, shuffle=False, lm_tta_beams=0,
                optim_args={"lr": 5e-3})
STEP_FRAMES = 256  # one window: T_ds 32, 16 a rank (8 with tp x sp)

_RANK = """
import json, os, pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
from torch.distributed.device_mesh import DeviceMesh
from dynamic_asr_eval_tpu_torch.config import TTAConfig
from dynamic_asr_eval_tpu_torch.kernels import attention as A
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, SCConformer
from dynamic_asr_eval_tpu_torch.parallel import init_process_group, use_mesh
from dynamic_asr_eval_tpu_torch.tta import DynamicEvalEngine

work = sys.argv[1]
setup = json.load(open(os.path.join(work, "setup.json")))
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
init_process_group("cpu")
if world == 2:
    mesh = DeviceMesh("cpu", torch.arange(2).reshape(1, 2), mesh_dim_names=("dp", "sp"))
else:
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(1, 2, 2), mesh_dim_names=("dp", "tp", "sp"))
result = {}
calls = []
inner = A.attention_reference
A.attention_reference = lambda q, k, v, mask, q_offset=0: (
    calls.append((q.shape[1], k.shape[1], q_offset)) or inner(q, k, v, mask, q_offset))


def model(options, n):
    cfg = ConformerConfig(compute_dtype="float32", seq_shard_axes=("dp", "sp"), **options)
    m = SCConformer(cfg)
    m.load_state_dict(torch.load(os.path.join(work, f"{n}.pt")))
    return m


if world == 2:
    x = torch.from_numpy(np.load(os.path.join(work, "x.npy")))
    length = torch.tensor(setup["lengths"])
    for name, options in setup["forwards"].items():
        m = model(options, name)
        ura = options.get("default_norm") is None
        with use_mesh(mesh), torch.no_grad():
            out = m(x, length, use_running_average=ura)
        result[name] = {"lp": out["final_posteriors"].numpy(),
                        "hidden": list(out["a_hidden"].shape),
                        "buffers": {k: v.numpy() for k, v in m.named_buffers()}}
    result["query_blocks"] = sorted(set(calls))
step = model(setup["step_model"], "step")
engine = DynamicEvalEngine(step, step.config.blank_id, 8, TTAConfig(**setup["step_tta"]),
                           mesh=mesh if world == 4 else None, device="cpu")
spec = np.load(os.path.join(work, "spec.npy"))
with use_mesh(mesh):
    out = engine(None, spec, return_params=True)
result["step"] = {"logits": out.numpy_logits(), "params": {k: v.numpy() for k, v in out.params.items()}}
with open(os.path.join(work, f"w{world}_rank{rank}.pkl"), "wb") as f:
    pickle.dump(result, f)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_pair(options, seed):
    """(JAX config, JAX model, its variables, the port's state dict): the
    port's seeded weights, biases, norm scales, relative-position biases and
    running statistics drawn from a numpy seed."""
    state = init_conformer(ConformerConfig(compute_dtype="float32", **options), seed=seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in state.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, t.shape).astype(np.float32)))
            elif name.endswith(("bias", "running_mean", "pos_bias_u", "pos_bias_v")) or (
                    "norm" in name and name.endswith("weight")):
                t.add_(torch.from_numpy(0.1 * rng.standard_normal(t.shape).astype(np.float32)))
    state = {k: v.clone() for k, v in state.state_dict().items()}
    jcfg = JaxConfig(compute_dtype=jnp.float32, **options)
    return jcfg, JaxConformer(jcfg), variables_to_jax(state), state


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    work = tmp_path_factory.mktemp("sequence_parallel")
    models = {}
    for i, (name, options) in enumerate(FORWARDS.items()):
        models[name] = _jax_pair(dict(BASE, **options), i)
    models["step"] = _jax_pair(STEP_MODEL, 9)
    for name, (*_, state) in models.items():
        torch.save(state, work / f"{name}.pt")
    x = np.random.default_rng(0).standard_normal((2, BASE["feat_in"], max(LENGTHS)))
    spec = np.random.default_rng(1).standard_normal((BASE["feat_in"], STEP_FRAMES))
    np.save(work / "x.npy", x.astype(np.float32))
    np.save(work / "spec.npy", spec.astype(np.float32))
    (work / "setup.json").write_text(json.dumps(
        {"forwards": {n: dict(BASE, **o) for n, o in FORWARDS.items()}, "lengths": LENGTHS,
         "step_model": STEP_MODEL, "step_tta": STEP_TTA}))
    script = work / "rank.py"
    script.write_text(_RANK)
    procs = []
    for world in (2, 4):  # they run while JAX computes
        env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=str(_free_port()),
                   PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
        procs += [(world, r, subprocess.Popen(
            [sys.executable, str(script), str(work)], cwd=work,
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)) for r in range(world)]
    return work, models, x.astype(np.float32), spec.astype(np.float32), procs


@pytest.fixture(scope="module")
def ranks(setup):
    """{world size: [each rank's results]}."""
    work, procs = setup[0], setup[-1]
    for world, r, p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, (world, r, err)
    out = {}
    for world, r, _ in procs:
        with open(work / f"w{world}_rank{r}.pkl", "rb") as f:
            out.setdefault(world, []).append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def jax_forwards(setup):
    _, models, x, _, _ = setup
    out = {}
    for name in FORWARDS:
        _, model, variables, _ = models[name]
        ura = name != "batch_renorm_batch_stats"
        with jax.disable_jit():
            ref, mutated = model.apply(variables, jnp.asarray(x), length=jnp.asarray(LENGTHS),
                                       use_running_average=ura, mutable=["batch_stats"])
        out[name] = (np.asarray(ref["final_posteriors"]), np.asarray(ref["length"]), mutated)
    return out


@pytest.fixture(scope="module")
def jax_step(setup):
    _, models, _, spec, _ = setup
    jcfg, model, variables, _ = models["step"]
    with rolled_scans():
        return JaxEngine(model, jcfg.blank_id, 8, JaxTTAConfig(**STEP_TTA))(
            variables, spec, return_params=True)


@pytest.mark.parametrize("name", list(FORWARDS))
def test_sequence_sharded_forward_matches_jax(ranks, jax_forwards, name):
    ref, ds, mutated = jax_forwards[name]
    assert ds.tolist() == [25, 17]
    for out in ranks[2]:
        lp = out[name]["lp"]
        assert lp.shape == ref.shape and out[name]["hidden"] == [2, 25, BASE["d_model"]]
        for b, n in enumerate(ds):
            np.testing.assert_allclose(lp[b, :n], ref[b, :n], rtol=0, atol=1e-4)
        if name == "batch_renorm_batch_stats":  # the statistics moved as JAX's did
            for n in range(FORWARDS[name]["n_layers"]):
                stats = mutated["batch_stats"][f"layer_{n}"]["conv"]["norm"]["BatchRenorm_0"]
                for buf, key in (("running_mean", "mean"), ("running_var", "var")):
                    np.testing.assert_allclose(out[name]["buffers"][f"layers.{n}.conv.norm_mid.{buf}"],
                                               np.asarray(stats[key]), rtol=0, atol=1e-6)


def test_the_sharded_forward_runs_query_blocks(ranks):
    """Each rank's attention took its 13 of the 26 padded rows against all
    26 keys."""
    for r, out in enumerate(ranks[2]):
        assert out["query_blocks"] == [(13, 26, 13 * r)], r


def _assert_step_matches(out, want):
    np.testing.assert_allclose(out["logits"], want.numpy_logits(), rtol=0, atol=1e-4)
    back, unmatched = convert_lcasr_checkpoint(out["params"])
    assert unmatched == []
    ref = dict(jax.tree_util.tree_leaves_with_path(want.params))
    for path, leaf in jax.tree_util.tree_leaves_with_path(back["params"]):
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(ref[path]), rtol=0, atol=2e-5)


def test_sequence_sharded_step_matches_jax(ranks, jax_step, setup):
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(
        jax.tree.leaves(jax_step.params), jax.tree.leaves(setup[1]["step"][2]["params"])))
    assert moved > 1e-3  # the step moved the weights: the bar means something
    for out in ranks[2]:
        _assert_step_matches(out["step"], jax_step)


def test_tensor_and_sequence_sharded_step_matches_jax(ranks, jax_step):
    """dp 1 x tp 2 x sp 2: the engine's working copy split over tp, the
    window's time axis over sp; the gathered weights as JAX's unsharded
    step's."""
    for out in ranks[4]:
        _assert_step_matches(out["step"], jax_step)


QB = (2, 128, 2, 64)  # B, T, H, D: four query blocks of 32 rows


@pytest.fixture(scope="module")
def query_block_case():
    rng = np.random.default_rng(4)
    B, T, H, D = QB
    q, k, v, g = (rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(4))
    mask = np.arange(T)[None, :] < np.asarray([128, 75])[:, None]
    mp = pytest.MonkeyPatch()
    mp.setenv("DAE_STRICT_FLASH_ATTENTION", "1")
    try:
        with pltpu.force_tpu_interpret_mode():
            out, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c, jnp.asarray(mask)),
                               *(jnp.asarray(a) for a in (q, k, v)))
            grads = vjp(jnp.asarray(g))
    finally:
        mp.undo()
    return (q, k, v, g, mask), np.asarray(out), [np.asarray(x) for x in grads]


@pytest.mark.parametrize("block", range(4))
def test_query_block_reference_matches_jax_rows(query_block_case, block):
    """attention_reference{,_bwd} on rows [32 b, 32 b + 32) against all 128
    keys: out and dq the rows of JAX's Pallas attention (the file
    tests/test_torch_attention.py's bars: 2e-5, 1e-4)."""
    (q, k, v, g, mask), out, (dq, _, _) = query_block_case
    n = QB[1] // 4
    rows = slice(block * n, (block + 1) * n)
    qt, kt, vt, gt = (torch.from_numpy(a) for a in (q[:, rows], k, v, g[:, rows]))
    m = torch.from_numpy(mask)
    got, lse = A.attention_reference(qt, kt, vt, m, block * n)
    np.testing.assert_allclose(got.numpy(), out[:, rows], rtol=0, atol=2e-5)
    got_dq, _, _ = A.attention_reference_bwd(qt, kt, vt, m, got, lse, gt, block * n)
    np.testing.assert_allclose(got_dq.numpy(), dq[:, rows], rtol=0, atol=1e-4)


def test_query_blocks_key_gradients_sum_to_the_whole(query_block_case):
    """The four blocks' dk and dv summed: the whole call's within 1e-5, and
    JAX's within its gradients' bar."""
    (q, k, v, g, mask), _, (_, dk, dv) = query_block_case
    qt, kt, vt, gt, m = (torch.from_numpy(a) for a in (q, k, v, g, mask))
    whole_out, whole_lse = A.attention_reference(qt, kt, vt, m)
    _, whole_dk, whole_dv = A.attention_reference_bwd(qt, kt, vt, m, whole_out, whole_lse, gt)
    n = QB[1] // 4
    sums = [torch.zeros_like(kt), torch.zeros_like(vt)]
    for b in range(4):
        rows = slice(b * n, (b + 1) * n)
        out, lse = A.flash_attention_fwd(qt[:, rows], kt, vt, m, b * n)
        _, bdk, bdv = A.flash_attention_bwd(qt[:, rows], kt, vt, m, out, lse, gt[:, rows], b * n)
        assert bdk.shape == kt.shape and bdv.shape == vt.shape
        sums[0] += bdk
        sums[1] += bdv
    for got, whole, jax_ref in ((sums[0], whole_dk, dk), (sums[1], whole_dv, dv)):
        torch.testing.assert_close(got, whole, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), jax_ref, rtol=0, atol=1e-4)


def test_query_block_outside_the_keys_is_refused():
    q = torch.zeros(1, 8, 1, 8)
    kv = torch.zeros(1, 16, 1, 8)
    with pytest.raises(ValueError, match="not inside"):
        A.flash_attention(q, kv, kv, torch.ones(1, 16, dtype=torch.bool), 9)
