"""The port's protocol drivers (in-dataset, cross-dataset, half-concat,
whole-concat and gender transfer, with and without a speaker manifest)
against the JAX package's, on ``-d synthetic`` with the JAX driver's
weights handed across, and the half-concat helpers (``split_records``,
``concatenate_specs``) and the manifest reader against JAX's.

Both sides run the same CLI (one online epoch, seq 256 / overlap 128,
augmentation off, greedy decode, normalizer, corpus WER, result pickle) on a
tiny f32 conformer with ``attention_impl="pallas_flash"``: the JAX driver's
model is injected through its module's ``load_model_and_tokenizer``
(nothing in the JAX package is edited), and the port receives the same flax
params through the drivers' ``jax_params`` hook.  Transcripts, WERs (every
baseline, fold and per-recording list) and pickle keys must be identical,
the scenarios of tests/test_drivers.py::TestProtocolDrivers and
TestGenderTransferDriver.  The JAX
drivers run with ``lax.scan``'s ``unroll`` dropped (same operations), as in
tests/test_torch_driver.py.
"""

import contextlib
import json
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dynamic_asr_eval_tpu.evals.run_cross_dataset_eval as jax_cross
import dynamic_asr_eval_tpu.evals.run_cross_speaker_gender_tedlium as jax_gender
import dynamic_asr_eval_tpu.evals.run_half_concat_eval as jax_half
import dynamic_asr_eval_tpu.evals.run_in_dataset_eval as jax_in
import dynamic_asr_eval_tpu.evals.run_whole_concat_eval as jax_whole
import dynamic_asr_eval_tpu.ops.ctc as jax_ctc
from dynamic_asr_eval_tpu.models import ConformerConfig as JaxConfig
from dynamic_asr_eval_tpu.models import init_conformer as jax_init
from dynamic_asr_eval_tpu.text import CharTokenizer as JaxCharTokenizer
from dynamic_asr_eval_tpu_torch.evals import (
    run_cross_dataset_eval,
    run_cross_speaker_gender_tedlium,
    run_half_concat_eval,
    run_in_dataset_eval,
    run_whole_concat_eval,
)
from dynamic_asr_eval_tpu_torch.models import ConformerConfig

torch.set_num_threads(1)

TINY = dict(feat_in=80, n_layers=2, d_model=64, n_heads=2, head_dim=32, vocab_size=28,
            subsampling_factor=8, subsampling_conv_channels=16, conv_kernel_size=5,
            attention_impl="pallas_flash")
KWARGS = ["-kwargs", "epochs=1", "online=true", "seq_len=256", "overlap=128",
          "lm_tta_beams=0", "optim_lr=1e-3"]
DETAIL_KEYS = ("wer", "words", "ins_rate", "del_rate", "sub_rate", "model_output", "gold")


@contextlib.contextmanager
def rolled_scans():
    scan = jax.lax.scan
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.lax, "scan", lambda *a, unroll=1, **kw: scan(*a, **kw))
    jax_ctc.ctc_loss.clear_cache()
    try:
        yield
    finally:
        mp.undo()
        jax_ctc.ctc_loss.clear_cache()


def jax_tiny(seed):
    """(model, variables, config) of the tiny f32 JAX conformer."""
    jcfg = JaxConfig(compute_dtype=jnp.float32, **TINY)
    model, variables = jax_init(jcfg, jax.random.PRNGKey(seed), example_T=256)
    return model, variables, jcfg


def run_both(jax_module, port_module, argv, seed=9, kwargs=KWARGS):
    """``(JAX driver's return, port driver's return)`` of one CLI, the JAX
    model injected into ``jax_module`` and its params handed to the port.
    Seed 9's model still emits a varied transcript after adaptation (most
    seeds collapse to one repeated letter at lr 1e-3), so a flipped frame
    would show."""
    model, variables, jcfg = jax_tiny(seed)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_module, "load_model_and_tokenizer",
               lambda args: (model, variables, JaxCharTokenizer(), jcfg))
    try:
        with rolled_scans():
            jax_out = jax_module.cli(argv("jax") + kwargs)
    finally:
        mp.undo()
    port_out = port_module.cli(argv("port") + ["--device", "cpu"] + kwargs,
                               model_config=ConformerConfig(compute_dtype="float32", **TINY),
                               jax_params=jax.tree.map(np.asarray, variables["params"]))
    return jax_out, port_out


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def assert_same_detail(port, ref):
    for key in DETAIL_KEYS:
        assert port[key] == ref[key], key


PROTOCOLS = {
    # name: JAX module, port module, suffix of the pickle written for -s X.pkl
    "in_dataset": (jax_in, run_in_dataset_eval, "_1.pkl"),
    "cross_dataset": (jax_cross, run_cross_dataset_eval, ".pkl"),
    "half_concat": (jax_half, run_half_concat_eval, ".pkl"),
    "whole_concat": (jax_whole, run_whole_concat_eval, ".pkl"),
}


@pytest.fixture(scope="module", params=sorted(PROTOCOLS))
def protocol(request, tmp_path_factory):
    name = request.param
    jax_module, port_module, suffix = PROTOCOLS[name]
    tmp = tmp_path_factory.mktemp(name)
    data = ["-da", "synthetic", "-db", "synthetic"] if name == "cross_dataset" else ["-d",
                                                                                     "synthetic"]
    jax_out, port_out = run_both(
        jax_module, port_module,
        lambda side: data + ["--quiet", "-s", str(tmp / f"{side}.pkl")])
    return name, (jax_out, load(tmp / f"jax{suffix}")), (port_out, load(tmp / f"port{suffix}"))


def test_protocol_returns_identical(protocol):
    """The drivers' return values: the WER (in-dataset, whole-concat), the
    mean fold WER (half-concat), the whole results dict (cross-dataset)."""
    name, (jax_out, _), (port_out, _) = protocol
    if name == "cross_dataset":
        assert {k: port_out[k] for k in ("a_to_b", "a_to_a_loo", "baselines")} == \
            {k: jax_out[k] for k in ("a_to_b", "a_to_a_loo", "baselines")}
        assert len(port_out["a_to_b"]) == 3 and len(port_out["a_to_a_loo"]) == 3
    else:
        assert port_out == jax_out and np.isfinite(port_out)


def test_protocol_transcripts_and_wer_identical(protocol):
    name, (_, j), (_, p) = protocol
    if name == "half_concat":
        assert_same_detail(p["baseline"], j["baseline"])
        assert len(p["folds"]) == 2
        for pf, jf in zip(p["folds"], j["folds"]):
            assert (pf["fold"], pf["wer"]) == (jf["fold"], jf["wer"])
            assert_same_detail(pf["detail"], jf["detail"])
    elif name == "cross_dataset":
        for key in ("a_to_b", "a_to_a_loo", "baselines"):
            assert p[key] == j[key], key
    else:
        assert_same_detail(p, j)
        assert any(p["model_output"])


def test_protocol_pickle_schema(protocol):
    name, (_, j), (_, p) = protocol
    assert set(p) == set(j)
    assert set(p["args_dict"]) - set(j["args_dict"]) == {"device"}
    if name == "in_dataset":
        assert p["repeat"] == "1/1" and len(p["model_output"]) == 2
    if name == "half_concat":
        assert [set(f) for f in p["folds"]] == [set(f) for f in j["folds"]]


MANIFEST = {"female": [{"talk_id": "synthetic_0"}, {"talk_id": "synthetic_2"}],
            "male": [{"talk_id": "synthetic_1"}]}


@pytest.fixture(scope="module", params=["manifest", "no_manifest"])
def gender(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"gender_{request.param}")
    flags = ["-d", "synthetic", "--quiet"]
    if request.param == "manifest":
        (tmp / "speakers.json").write_text(json.dumps(MANIFEST))
        flags += ["--speaker_manifest", str(tmp / "speakers.json")]
    jax_out, port_out = run_both(jax_gender, run_cross_speaker_gender_tedlium,
                                 lambda side: flags + ["-s", str(tmp / f"{side}.pkl")])
    return request.param, jax_out, port_out, load(tmp / "jax.pkl"), load(tmp / "port.pkl")


def test_gender_tables_identical(gender):
    """Baselines and the four transfer tables (adapt_on ids and WERs): with
    the manifest, 2 female and 1 male speaker (m_to_m empty); without it,
    records 0 and 2 as male and 1 as female."""
    kind, jax_out, port_out, _, _ = gender
    keys = ("baselines", "m_to_m", "m_to_f", "f_to_f", "f_to_m")
    assert {k: port_out[k] for k in keys} == {k: jax_out[k] for k in keys}
    sizes = [len(port_out[k]) for k in keys[1:]]
    assert sizes == ([0, 1, 2, 2] if kind == "manifest" else [2, 2, 0, 1])
    assert all(np.isfinite(v) for v in port_out["baselines"].values())


def test_gender_pickle_schema(gender):
    _, _, port_out, j, p = gender
    assert set(p) == set(j) and p["baselines"] == port_out["baselines"]
    assert set(p["args_dict"]) - set(j["args_dict"]) == {"device"}


def test_speaker_manifest_matches_jax(tmp_path):
    path = tmp_path / "m.json"
    path.write_text(json.dumps(MANIFEST))
    assert (run_cross_speaker_gender_tedlium.load_speaker_manifest(str(path))
            == jax_gender.load_speaker_manifest(str(path)))


@pytest.mark.parametrize("n", [2, 3, 4, 7])
@pytest.mark.parametrize("fold", [0, 1])
def test_split_records_matches_jax(n, fold):
    records = [{"id": f"r{i}"} for i in range(n)]
    assert run_half_concat_eval.split_records(records, fold) == jax_half.split_records(
        records, fold)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_concatenate_specs_matches_jax(seed):
    """[F, T] and [1, F, T] spectrograms of different lengths, mixed."""
    rng = np.random.default_rng(seed)
    specs = [rng.standard_normal((80, int(t))).astype(np.float32)
             for t in rng.integers(5, 60, size=3)]
    specs[1] = specs[1][None]
    got = run_half_concat_eval.concatenate_specs(specs)
    want = np.asarray(jax_half.concatenate_specs(specs))
    assert got.shape == want.shape == (80, sum(s.shape[-1] for s in specs))
    np.testing.assert_array_equal(got, want)


def test_adapt_on_concat_leaves_the_pristine_weights_and_returns_no_logits():
    """The adapt-only pass returns moved weights and no stitched output; the
    state dict it started from is unchanged."""
    from dynamic_asr_eval_tpu_torch.config import TTAConfig
    from dynamic_asr_eval_tpu_torch.data import get_dataset
    from dynamic_asr_eval_tpu_torch.models import init_conformer
    from dynamic_asr_eval_tpu_torch.tta import DynamicEvalEngine

    cfg = ConformerConfig(compute_dtype="float32", **TINY)
    model = init_conformer(cfg, seed=3)
    params = {k: v.clone() for k, v in model.state_dict().items()}
    engine = DynamicEvalEngine(model, cfg.blank_id, cfg.subsampling_factor,
                               TTAConfig(epochs=1, online=True, lm_tta_beams=0,
                                         optim_args={"lr": 1e-3}), device="cpu")
    outputs = []

    def spy(*args, **kwargs):
        outputs.append(engine(*args, **kwargs))
        return outputs[-1]

    adapted = run_half_concat_eval.adapt_on_concat(
        spy, params, get_dataset("synthetic", "test")[:2], 256, 128)
    (out,) = outputs
    assert out.logits is None and out.counts is None
    assert all(torch.equal(params[k], v) for k, v in model.state_dict().items())
    assert max((adapted[k] - params[k]).abs().max().item() for k in params) > 0
