"""Data parallelism on ``torch.distributed``: two gloo ranks on the CPU
against the JAX package on a 2-device mesh of virtual CPU devices.

Two rank processes are spawned once for the module (``torchrun``'s
environment: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``);
each builds the same tiny fp32 conformer (one layer, no self-conditioning:
JAX's compiles are the file's cost) from the port's seeded weights, which
JAX gets through ``variables_to_jax``, and runs, on the CPU:

- ``run_records_dp`` on 3 records (a group of 2 and a padded group of 1,
  both in one window bucket, so JAX compiles once), offline with
  ``shuffle`` (each rank draws its group's window orders
  record-major), against JAX's ``run_records_dp`` on ``make_mesh(n_devices=
  2)``: equal transcripts, golds and WER, on both ranks;
- ``--dp`` offline inference (``infer_batch`` 3, rounded up to 4 and split
  over the ranks) against JAX's engine with ``mesh=`` dp 2: within 1e-5;
- ``reduce_wer_counts`` against JAX's: equal integers;
- ``make_mesh``, ``batch_sharding`` and ``replicate`` on the two ranks.

The JAX engines run with ``lax.scan``'s ``unroll`` dropped
(tests/test_torch_engine.py says why).  The augmentation is off (the
zero-mask config): the two packages draw different random numbers.
"""

import argparse
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
from dynamic_asr_eval_tpu.evals import common as jax_common
from dynamic_asr_eval_tpu.models import ConformerConfig as JaxConfig
from dynamic_asr_eval_tpu.models import SCConformer as JaxConformer
from dynamic_asr_eval_tpu.parallel import make_mesh as jax_make_mesh
from dynamic_asr_eval_tpu.parallel import reduce_wer_counts as jax_reduce_wer_counts
from dynamic_asr_eval_tpu.text import CharTokenizer as JaxCharTokenizer
from dynamic_asr_eval_tpu.tta import DynamicEvalEngine as JaxEngine
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, init_conformer, variables_to_jax
from test_torch_engine import rolled_scans

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(feat_in=32, n_layers=1, self_conditioning=False, d_model=64, n_heads=2, head_dim=32,
            vocab_size=28,
            subsampling_factor=8, subsampling_conv_channels=16, conv_kernel_size=5,
            attention_impl="xla")
FRAMES = (700, 512, 640)
GOLDS = ["the cat sat on the mat", "a dog ran", "hello world"]
RECORDS_TTA = dict(seq_len=256, overlap=128, epochs=1, online=False, shuffle=True,
                   lm_tta_beams=0, optim_args={"lr": 3e-2})
DP_TTA = dict(seq_len=256, overlap=128, epochs=0, online=False, shuffle=False, lm_tta_beams=0)
COUNTS = np.array([[1, 2, 3, 9], [0, 0, 4, 7], [5, 1, 0, 3]], np.int64)
REPEAT_SEED = 0

_RANK = """
import argparse, json, os, pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
from dynamic_asr_eval_tpu_torch.config import TTAConfig
from dynamic_asr_eval_tpu_torch.evals.common import run_records_dp
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, SCConformer
from dynamic_asr_eval_tpu_torch.parallel import (
    axis_rank, axis_size, batch_sharding, init_process_group, make_mesh, reduce_wer_counts,
    replicate)
from dynamic_asr_eval_tpu_torch.text import load_tokenizer
from dynamic_asr_eval_tpu_torch.tta import DynamicEvalEngine

work = sys.argv[1]
setup = json.load(open(os.path.join(work, "setup.json")))
data = np.load(os.path.join(work, "data.npz"))
rank = int(os.environ["RANK"])
assert init_process_group("cpu").type == "cpu"
mesh = make_mesh()
cfg = ConformerConfig(compute_dtype="float32", **setup["model"])
model = SCConformer(cfg)
model.load_state_dict(torch.load(os.path.join(work, "weights.pt")))
specs = [data[f"spec{i}"] for i in range(len(setup["golds"]))]
records = [{"id": f"r{i}", "process_fn": lambda rec, i=i: (specs[i], setup["golds"][i])}
           for i in range(len(specs))]
tok = load_tokenizer(None)
engine = DynamicEvalEngine(model, cfg.blank_id, cfg.subsampling_factor,
                           TTAConfig(**setup["records_tta"]), mesh=mesh, device="cpu")
args = argparse.Namespace(seq_len=-1, overlap=-1, beams=1)
wer, detail = run_records_dp(engine, None, records, tok, args, setup["repeat_seed"],
                             np.random.default_rng(setup["repeat_seed"]),
                             iter(range(len(records))), verbose=False)
dp = DynamicEvalEngine(model, cfg.blank_id, cfg.subsampling_factor, TTAConfig(**setup["dp_tta"]),
                       infer_batch=3, mesh=mesh, device="cpu")
logits = dp(None, specs[0]).numpy_logits()
shared = replicate({"x": torch.full((3,), float(rank + 1))}, mesh)["x"]
out = {"wer": wer, "detail": detail, "logits": logits,
       "counts": reduce_wer_counts(np.asarray(setup["counts"]), mesh),
       "mesh": (axis_size(mesh, "dp"), axis_size(mesh, "tp"), axis_rank(mesh)),
       "shard": batch_sharding(mesh)(torch.arange(6)).tolist(), "replicated": shared.tolist()}
with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(out, f)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel")
    jcfg = JaxConfig(compute_dtype=jnp.float32, **TINY)
    port = init_conformer(ConformerConfig(compute_dtype="float32", **TINY), seed=0)
    variables = jax.tree.map(jnp.asarray, variables_to_jax(port.state_dict()))
    model = JaxConformer(jcfg)
    rng = np.random.default_rng(1)
    specs = [rng.standard_normal((TINY["feat_in"], n)).astype(np.float32) for n in FRAMES]
    torch.save(port.state_dict(), work / "weights.pt")
    np.savez(work / "data.npz", **{f"spec{i}": s for i, s in enumerate(specs)})
    (work / "setup.json").write_text(json.dumps(
        {"model": TINY, "golds": GOLDS, "records_tta": RECORDS_TTA, "dp_tta": DP_TTA,
         "counts": COUNTS.tolist(), "repeat_seed": REPEAT_SEED}))
    procs = _spawn_ranks(work)  # they run while JAX compiles
    return work, jcfg, model, variables, specs, procs


def _spawn_ranks(work):
    script = work / "rank.py"
    script.write_text(_RANK)
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen([sys.executable, str(script), str(work)], cwd=REPO,
                             env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]


@pytest.fixture(scope="module")
def ranks(setup):
    """Both ranks' results, from one spawn of two processes."""
    work, procs = setup[0], setup[-1]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    results = []
    for r in range(2):
        with open(work / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh(n_devices=2)


def _records(specs):
    return [{"id": f"r{i}", "process_fn": lambda rec, i=i: (specs[i], GOLDS[i])}
            for i in range(len(specs))]


def test_run_records_dp_matches_jax_on_two_ranks(setup, jax_mesh, request):
    _, jcfg, model, variables, specs, _ = setup
    engine = JaxEngine(model, jcfg.blank_id, 8, JaxTTAConfig(**RECORDS_TTA), mesh=jax_mesh)
    args = argparse.Namespace(seq_len=-1, overlap=-1, beams=1)
    with rolled_scans():
        wer, detail = jax_common.run_records_dp(
            engine, variables, _records(specs), JaxCharTokenizer(), args,
            jax.random.PRNGKey(REPEAT_SEED), np.random.default_rng(REPEAT_SEED),
            iter(range(len(specs))), verbose=False)
    assert any(detail["model_output"])  # the model emitted something to compare
    for r, out in enumerate(request.getfixturevalue("ranks")):  # ran meanwhile
        assert out["detail"]["model_output"] == detail["model_output"], r
        assert out["detail"]["gold"] == detail["gold"] == GOLDS, r
        assert out["wer"] == out["detail"]["wer"] == wer, r
        assert len(out["detail"]["elapsed_times"]) == len(GOLDS)


def test_dp_offline_inference_matches_jax_mesh_engine(setup, ranks, jax_mesh):
    _, jcfg, model, variables, specs, _ = setup
    engine = JaxEngine(model, jcfg.blank_id, 8, JaxTTAConfig(**DP_TTA), infer_batch=3,
                       mesh=jax_mesh)
    with rolled_scans():
        want = engine(variables, specs[0]).numpy_logits()
    for out in ranks:
        np.testing.assert_allclose(out["logits"], want, rtol=0, atol=1e-5)


def test_reduce_wer_counts_matches_jax(ranks, jax_mesh):
    want = jax_reduce_wer_counts(COUNTS, jax_mesh)
    assert want.tolist() == COUNTS.sum(0).tolist()
    for out in ranks:
        assert out["counts"].tolist() == want.tolist()


def test_mesh_sharding_and_replication_on_two_ranks(ranks):
    assert [out["mesh"] for out in ranks] == [(2, 1, 0), (2, 1, 1)]
    assert [out["shard"] for out in ranks] == [[0, 1, 2], [3, 4, 5]]
    assert [out["replicated"] for out in ranks] == [[1.0] * 3] * 2


def test_tensor_parallelism_is_refused_naming_its_roadmap_item():
    """Tensor parallelism is ported (tests/test_torch_tensor_parallel.py):
    ``init_data_parallel`` takes ``--tp 2``, and at a world of 1 the tp mesh
    is refused as JAX's ``make_mesh`` refuses it."""
    from dynamic_asr_eval_tpu_torch.evals.common import init_data_parallel
    from dynamic_asr_eval_tpu_torch.parallel import make_mesh

    assert init_data_parallel(argparse.Namespace(tp=2, device="cpu")).type == "cpu"
    with pytest.raises(ValueError, match="not divisible by tp"):
        make_mesh(tp=2)
