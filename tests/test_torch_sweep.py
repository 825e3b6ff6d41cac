"""The port's sweep tooling against the JAX package's: the TPE sampler
(``evals/hpo.py``), the offline sweep runner (``evals/run_sweep.py``),
``evals/eval_for_each_cpt.py`` and ``analysis.py``.

- ``TPESampler``: the same suggestions, exactly, for the same seed and
  history, over the scenarios of tests/test_hpo.py (float, int and
  categorical schemas; maximize too).
- ``run_sweep``, offline: ``grid``, ``random`` and ``bayes`` sweeps with the
  run function stubbed on both sides write the same results JSONL; the real
  per-recording driver on the tiny model gives the same WER per trial (the
  scenario of tests/test_drivers.py::TestSweep); the wandb agent path with
  an injected ``wandb`` module; the encoder-decoder run scripts reach their
  drivers as in JAX's sweep (tests/test_torch_encdec_sweep.py runs them).
- ``eval_for_each_cpt``: two reference ``.pt`` checkpoints in a folder, each
  package loading them itself: the same WER per checkpoint.
- ``analysis``: the aggregates, the LaTeX table and the transcript-gap audit
  equal JAX's on the same pickles; the plots run where matplotlib imports.
"""

import argparse
import json
import math
import random
import sys
import types

import numpy as np
import pytest
import torch

import jax

import dynamic_asr_eval_tpu.analysis as jax_analysis
import dynamic_asr_eval_tpu.evals.eval_for_each_cpt as jax_each
import dynamic_asr_eval_tpu.evals.run as jax_run
import dynamic_asr_eval_tpu.evals.run_sweep as jax_sweep
from dynamic_asr_eval_tpu.evals.hpo import TPESampler as JaxTPE
from dynamic_asr_eval_tpu.text import CharTokenizer as JaxCharTokenizer
from dynamic_asr_eval_tpu_torch import analysis
from dynamic_asr_eval_tpu_torch.evals import eval_for_each_cpt, run, run_sweep
from dynamic_asr_eval_tpu_torch.evals.hpo import TPESampler
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, init_conformer
from test_torch_protocols import KWARGS, TINY, jax_tiny, rolled_scans

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# TPESampler
# ---------------------------------------------------------------------------

QUAD_SPACE = {"x": {"min": -5.0, "max": 5.0}, "y": {"min": -5.0, "max": 5.0}}
SCHEMA_SPACE = {
    "epochs": {"min": 1, "max": 5},
    "lr": {"min": 1e-6, "max": 1e-4},
    "bitfit": {"values": [True, False]},
    "cutout_value": {"values": ["mean", "zero"]},
}


def _quadratic(sampler_cls, seed, maximize=False):
    tpe = sampler_cls(QUAD_SPACE, seed=seed, maximize=maximize)
    out = []
    for _ in range(40):
        cfg = tpe.suggest()
        tpe.observe(cfg, (cfg["x"] - 1.7) ** 2 + (cfg["y"] + 0.3) ** 2)
        out.append(cfg)
    return out


def _schema(sampler_cls):
    tpe = sampler_cls(SCHEMA_SPACE, seed=3)
    out = []
    for i in range(20):
        cfg = tpe.suggest()
        assert isinstance(cfg["epochs"], int) and 1 <= cfg["epochs"] <= 5
        tpe.observe(cfg, float(i % 7))
        out.append(cfg)
    return out


def _categorical(sampler_cls):
    tpe = sampler_cls({"choice": {"values": ["a", "b", "c", "d"]}}, seed=0, n_startup=8)
    rng = random.Random(1)
    out = []
    for _ in range(40):
        cfg = tpe.suggest()
        tpe.observe(cfg, 0.1 if cfg["choice"] == "b" else 1.0 + rng.random())
        out.append(cfg)
    return out + [tpe.suggest() for _ in range(30)]


HPO_SCENARIOS = {
    "quadratic": lambda cls: [_quadratic(cls, seed) for seed in range(5)],
    "quadratic_maximize": lambda cls: _quadratic(cls, 2, maximize=True),
    "schema_types": _schema,
    "good_category": _categorical,
}


@pytest.mark.parametrize("scenario", sorted(HPO_SCENARIOS))
def test_tpe_suggestions_identical_to_jax(scenario):
    got = HPO_SCENARIOS[scenario](TPESampler)
    assert got == HPO_SCENARIOS[scenario](JaxTPE)
    flat = got if isinstance(got[0], dict) else [c for run_ in got for c in run_]
    assert len({json.dumps(c, sort_keys=True) for c in flat}) > 1  # the sampler explored


# ---------------------------------------------------------------------------
# run_sweep
# ---------------------------------------------------------------------------

SWEEPS = {
    "grid": "method: grid\nmetric: {name: WER, goal: minimize}\nparameters:\n"
            "  optim_lr: {values: [9.0e-5, 3.0e-5]}\n  epochs: {min: 1, max: 3}\n",
    "random": "method: random\nmetric: {name: WER, goal: maximize}\nparameters:\n"
              "  optim_lr: {min: 1e-5, max: 1e-4}\n  bitfit: {values: [true, false]}\n",
    "bayes": "method: bayes\nmetric: {name: WER, goal: minimize}\nparameters:\n"
             "  optim_lr: {min: -10.0, max: 10.0}\n",
}


def _objective(args):
    return float((args.optim_lr - 3.0) ** 2 + 0.01 * getattr(args, "epochs", 1)
                 + 0.5 * bool(getattr(args, "bitfit", False)))


def _jsonl(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("method", sorted(SWEEPS))
def test_offline_sweep_matches_jax_with_a_stubbed_run(method, tmp_path, monkeypatch):
    """The same overrides in the same order, the same best, and every run on
    the dev split."""
    cfg = tmp_path / "sweep.yaml"
    cfg.write_text(SWEEPS[method])
    splits = []

    def jax_stub(args):
        splits.append(args.split)
        return _objective(args)

    def port_stub(args, model_config=None, jax_params=None):
        splits.append(args.split)
        return _objective(args)

    monkeypatch.setattr(jax_run, "main", jax_stub)
    monkeypatch.setattr(run, "main", port_stub)
    argv = ["-sc", str(cfg), "--no_wandb", "--count", "12", "--quiet", "-d", "synthetic"]
    jax_best = jax_sweep.cli(argv + ["--out", str(tmp_path / "jax.jsonl")])
    port_best = run_sweep.cli(argv + ["--out", str(tmp_path / "port.jsonl")])
    got, want = _jsonl(tmp_path / "port.jsonl"), _jsonl(tmp_path / "jax.jsonl")
    assert got == want and port_best == jax_best
    assert len(got) == {"grid": 10, "random": 12, "bayes": 12}[method]
    assert set(splits) == {"dev"}


def test_offline_sweep_of_the_real_driver_matches_jax(tmp_path, monkeypatch):
    """tests/test_drivers.py::TestSweep on the tiny model: two learning
    rates through the per-recording driver, the same WER per trial."""
    cfg = tmp_path / "sweep.yaml"
    cfg.write_text("method: grid\nmetric: {name: WER, goal: minimize}\nparameters:\n"
                   "  optim_lr: {values: [1.0e-3, 3.0e-4]}\n")
    model, variables, jcfg = jax_tiny(9)
    monkeypatch.setattr(jax_run, "load_model_and_tokenizer",
                        lambda args: (model, variables, JaxCharTokenizer(), jcfg))
    argv = ["-sc", str(cfg), "--no_wandb", "--quiet", "-d", "synthetic"]
    kwargs = [k for k in KWARGS if not k.startswith("optim_lr")]
    with rolled_scans():
        jax_best = jax_sweep.cli(argv + ["--out", str(tmp_path / "jax.jsonl")] + kwargs)
    port_best = run_sweep.cli(argv + ["--device", "cpu", "--out", str(tmp_path / "port.jsonl")]
                              + kwargs,
                              model_config=ConformerConfig(compute_dtype="float32", **TINY),
                              jax_params=jax.tree.map(np.asarray, variables["params"]))
    got, want = _jsonl(tmp_path / "port.jsonl"), _jsonl(tmp_path / "jax.jsonl")
    assert got == want and port_best == jax_best
    assert [r["overrides"]["optim_lr"] for r in got] == [1e-3, 3e-4]
    assert all(math.isfinite(r["WER"]) for r in got)


@pytest.mark.parametrize("script", run_sweep.ENC_DEC_SCRIPTS)
def test_enc_dec_run_scripts_dispatch_as_in_jax(script, tmp_path, monkeypatch):
    """Each encoder-decoder ``-run_script`` reaches its driver's ``main`` with
    the same arguments as in JAX's sweep (the joint-beam script pinned to
    ``mode="joint"``, the sweep's ``--training_mode`` / ``--breaks`` /
    ``-mode`` carried, the dev split), the drivers stubbed on both sides;
    tests/test_torch_encdec_sweep.py runs the real drivers."""
    import dynamic_asr_eval_tpu.evals.enc_dec_dynamic_eval_test as jax_ed_tta
    import dynamic_asr_eval_tpu.evals.enc_dec_inference_test as jax_ed_inf
    from dynamic_asr_eval_tpu_torch.evals import enc_dec_dynamic_eval_test as ed_tta
    from dynamic_asr_eval_tpu_torch.evals import enc_dec_inference_test as ed_inf

    seen = {"jax": [], "port": []}

    def stub(side, driver):
        def main(args, **kwargs):
            seen[side].append((driver, args.mode, args.training_mode, args.breaks, args.split,
                               args.optim_lr))
            return _objective(args)
        return main

    for side, tta, inf in (("jax", jax_ed_tta, jax_ed_inf), ("port", ed_tta, ed_inf)):
        monkeypatch.setattr(tta, "main", stub(side, "tta"))
        monkeypatch.setattr(inf, "main", stub(side, "inference"))
    cfg = tmp_path / "sweep.yaml"
    cfg.write_text(SWEEPS["grid"])
    argv = ["-sc", str(cfg), "--no_wandb", "-run_script", script, "--training_mode",
            "teacher_ce", "--breaks", "--quiet"]
    jax_best = jax_sweep.cli(argv + ["--out", str(tmp_path / "jax.jsonl")])
    port_best = run_sweep.cli(argv + ["--device", "cpu", "--out", str(tmp_path / "port.jsonl")])
    assert _jsonl(tmp_path / "port.jsonl") == _jsonl(tmp_path / "jax.jsonl")
    assert port_best == jax_best and seen["port"] == seen["jax"] and len(seen["port"]) == 10
    driver = "tta" if script == "enc_dec_dynamic_eval_test" else "inference"
    mode = "joint" if script == "enc_dec_ctc_beam_inference_test" else "default"
    assert {s[:5] for s in seen["port"]} == {(driver, mode, "teacher_ce", True, "dev")}


def test_sweep_wandb_agent_path(tmp_path, monkeypatch):
    """With ``wandb`` importable (an injected module) and no ``--no_wandb``:
    the YAML goes to ``wandb.sweep``, each agent run takes its overrides
    from ``wandb.config``, runs on the dev split and logs its WER, as in
    tests/test_hpo.py::test_sweep_wandb_agent_path."""
    import yaml

    sweep = {"method": "bayes", "metric": {"name": "WER", "goal": "minimize"},
             "project": "dae_test", "parameters": {"optim_lr": {"values": [1e-5, 9e-5]}}}
    cfg_path = tmp_path / "sweep.yaml"
    cfg_path.write_text(yaml.safe_dump(sweep))
    seen = []

    def fake_run(run_args, model_config=None, jax_params=None):
        seen.append(run_args)
        return 0.5 - 0.1 * len(seen)

    monkeypatch.setattr(run, "main", fake_run)
    state = {"sweep": None, "inits": 0, "logged": []}
    cfgs = [{"optim_lr": 1e-5}, {"optim_lr": 9e-5}]
    fake = types.ModuleType("wandb")

    def fake_agent(sweep_id, function, count):
        assert sweep_id == "sweep-id-1"
        for i in range(count):
            fake.config = cfgs[i % len(cfgs)]
            function()

    fake.sweep = lambda s, project=None: state.update(sweep=(s, project)) or "sweep-id-1"
    fake.agent = fake_agent
    fake.init = lambda *a, **k: state.__setitem__("inits", state["inits"] + 1)
    fake.log = lambda d: state["logged"].append(d)
    monkeypatch.setitem(sys.modules, "wandb", fake)

    args = run_sweep.parse_args(["-sc", str(cfg_path), "--count", "2", "--device", "cpu"])
    assert run_sweep.main(args) is None
    assert state["sweep"] == (sweep, "dae_test") and state["inits"] == 2
    assert [a.optim_lr for a in seen] == [1e-5, 9e-5]
    assert all(a.split == "dev" for a in seen)
    assert [d["WER"] for d in state["logged"]] == [0.4, 0.3]


@pytest.mark.parametrize("method", ["grid", "random"])
def test_expand_parameters_matches_jax(method):
    params = {"a": {"values": ["1e-5", 2]}, "b": {"min": 0.0, "max": 1.0},
              "c": {"values": [True, False, None]}}
    assert (run_sweep.expand_parameters(run_sweep.coerce_parameters(params), method, 7, seed=4)
            == jax_sweep.expand_parameters(jax_sweep.coerce_parameters(params), method, 7,
                                           seed=4))


# ---------------------------------------------------------------------------
# eval_for_each_cpt
# ---------------------------------------------------------------------------

REF_DIMS = {k: v for k, v in TINY.items() if k != "attention_impl"}


def test_eval_for_each_cpt_matches_jax(tmp_path):
    """Two reference ``.pt`` checkpoints (and a file that is none), each
    read by each package itself: the same names, in sorted order, with the
    same WER."""
    for seed, name in ((6, "b_step2.pt"), (5, "a_step1.pt")):
        state = init_conformer(ConformerConfig(compute_dtype="float32", **REF_DIMS),
                               seed=seed).state_dict()
        torch.save({"model": state, "config": {"model": dict(REF_DIMS, compute_dtype="float32")}},
                   str(tmp_path / name))
    (tmp_path / "notes.txt").write_text("not a checkpoint")
    argv = ["-cf", str(tmp_path), "-d", "synthetic", "--quiet"]
    with rolled_scans():
        want = jax_each.cli(argv + KWARGS)
    got = eval_for_each_cpt.cli(argv + ["--device", "cpu"] + KWARGS)
    assert got == want
    assert [name for name, _ in got] == ["a_step1.pt", "b_step2.pt"]
    assert all(math.isfinite(wer) for _, wer in got)


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------


def _write(path, obj):
    import pickle

    with open(path, "wb") as f:
        pickle.dump(obj, f)


@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    """The drivers' pickle schemas, filled from a seed."""
    tmp = tmp_path_factory.mktemp("pickles")
    rng = np.random.default_rng(0)
    for i in range(3):
        _write(tmp / f"run_{i}.pkl", {"wer": float(rng.random()), "words": 120,
                                      "ins_rate": float(rng.random()) / 10,
                                      "del_rate": float(rng.random()) / 10,
                                      "sub_rate": float(rng.random()) / 10})
        _write(tmp / f"cross_{i}.pkl", {
            "baselines": {"a": float(rng.random()), "b": float(rng.random())},
            "a_to_b": [{"adapt_on": f"r{k}", "wer": float(rng.random())} for k in range(3)],
            "a_to_a_loo": [{"adapt_on": f"r{k}", "wer": float(rng.random())} for k in range(i)]})
        _write(tmp / f"gender_{i}.pkl", {
            "baselines": {"male": 0.3, "female": 0.4},
            **{k: [{"adapt_on": "t", "wer": float(rng.random())} for _ in range(i)]
               for k in ("m_to_m", "m_to_f", "f_to_f", "f_to_m")}})
        _write(tmp / f"half_{i}.pkl", {
            "baseline": {"wer": float(rng.random())},
            "folds": [{"fold": f, "wer": float(rng.random()), "detail": {}} for f in (0, 1)]})
    return tmp


@pytest.mark.parametrize("what,pattern", [
    ("aggregate_per_recording", "run_*.pkl"), ("aggregate_per_recording", "none_*.pkl"),
    ("aggregate_cross_dataset", "cross_*.pkl"), ("aggregate_gender", "gender_*.pkl"),
    ("aggregate_half_concat", "half_*.pkl"), ("load_pickles", "*.pkl")])
def test_aggregates_match_jax(pickles, what, pattern):
    got = getattr(analysis, what)(str(pickles / pattern))
    assert got == getattr(jax_analysis, what)(str(pickles / pattern))
    assert got


def test_write_json_and_latex_table_match_jax(pickles, tmp_path):
    summary = analysis.aggregate_cross_dataset(str(pickles / "cross_*.pkl"))
    analysis.write_json(summary, str(tmp_path / "port" / "s.json"))
    jax_analysis.write_json(summary, str(tmp_path / "jax" / "s.json"))
    assert (tmp_path / "port" / "s.json").read_text() == (tmp_path / "jax" / "s.json").read_text()
    rows = [{"name": r["path"].rsplit("/", 1)[-1], "a_to_b": r["a_to_b"], "n": 3}
            for r in summary["runs"]]
    cols = ["name", "a_to_b", "n", "missing"]
    got = analysis.to_latex_table(rows, cols, caption="cross")
    assert got == jax_analysis.to_latex_table(rows, cols, caption="cross")
    assert got.count(r"\\") == len(rows) + 1


def test_audit_transcript_gaps_matches_jax():
    records = [{"id": "a", "timings": [(0.0, 4.0), (20.0, 25.0), (26.0, 30.0), (45.5, 50.0)]},
               {"id": "b", "timings": [(12.0, 13.0)]}, {"id": "c"}]
    for min_gap in (1.0, 10.0, 15.5):
        got = analysis.audit_transcript_gaps(records, min_gap_seconds=min_gap)
        assert got == jax_analysis.audit_transcript_gaps(records, min_gap_seconds=min_gap)
    assert [f["id"] for f in analysis.audit_transcript_gaps(records)] == ["a", "a", "b"]


@pytest.mark.parametrize("protocol", ["within_loo", "half_concat", "bars"])
def test_plots_run_where_matplotlib_imports(protocol, tmp_path):
    pytest.importorskip("matplotlib")
    path = str(tmp_path / f"{protocol}.png")
    if protocol == "bars":
        out = analysis.plot_wer_bars(["a", "b", "c"], [0.3, 0.2, 0.25], path, baseline=0.28)
    else:
        out = analysis.plot_protocol_scheme(protocol, path, n_chunks=4)
    assert out == path and (tmp_path / f"{protocol}.png").stat().st_size > 1000
    with pytest.raises(ValueError, match="unknown protocol"):
        analysis.plot_protocol_scheme("nope", path)


def test_sweep_args_carry_what_the_driver_reads():
    """The sweep's namespace carries what the per-recording driver reads."""
    args = run_sweep.parse_args(["-sc", "x.yaml", "--device", "cpu", "-kwargs", "epochs=2"])
    assert isinstance(args, argparse.Namespace) and args.base_args is args
    assert (args.epochs, args.device, args.split, args.run_script) == (2, "cpu", "test", "main")
