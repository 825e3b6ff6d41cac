"""The harness: cells, mixes and metrics found by name in files of their
own; the refusal without a card; and whole runs on the CPU at a tiny size
with the timed path broken underneath, each of which ``correct`` has to
catch, beside the sound run and the precision control."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

import dynamic_asr_eval_tpu_torch.evals.common as common
import dynamic_asr_eval_tpu_torch.optim.madgrad as madgrad
import dynamic_asr_eval_tpu_torch.tta.runner as runner
from portbench import check, harness
from portbench.tests import tiny

SEED = 2 ** 31 + 77  # past 32 signed bits: seeds of any size are taken


def cell(tmp_path, name="scconformer_xl.nsti.talks", **model):
    bench = tiny.write(tmp_path, **model)
    return harness.load_cell(name, bench, tmp_path / "traffic")


def quiet_run(c, trace=False):
    return harness.run_cell(c, SEED, 0.5, trace, "cpu", log=lambda s: None)


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    bench_path = tiny.write(tmp_path)
    bench = json.loads(bench_path.read_text())
    cfg = json.loads((tmp_path / "configs/scconformer_xl.json").read_text())
    cfg["model"]["n_layers"] = 1
    (tmp_path / "configs/one_layer.json").write_text(json.dumps(cfg))
    mix = json.loads((tmp_path / "traffic/talks.json").read_text())
    mix.update(records=2, min_frames=300, max_frames=400)
    (tmp_path / "traffic/short_talks.json").write_text(json.dumps(mix))
    metrics = tmp_path / "metrics"
    shutil.copytree(harness.HERE / "metrics", metrics)
    (metrics / "frames_run.py").write_text(
        "def read(run):\n    return float(sum(r.frames for r in run.records))\n")
    bench["configs"].append({"name": "one_layer", "source": "test", "file": "configs/one_layer.json",
                             "reduced": ["n_layers"], "why": "test"})
    bench["workloads"].append({"name": "one_layer.short", "config": "one_layer",
                               "traffic": "short_talks", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "frames_run", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "driver", "moves": "rtfx",
                               "workloads": ["one_layer.short"]})
    bench_path.write_text(json.dumps(bench))
    c = harness.load_cell("one_layer.short", bench_path, tmp_path / "traffic", metrics)
    assert c.cfg["model"]["n_layers"] == 1 and c.mix["max_frames"] == 400
    assert [m["name"] for m in c.per_layer] == [m["name"] for m in bench["per_layer"]
                                                if "one_layer.short" in m.get("workloads", [])]
    result = quiet_run(c, trace=True)
    assert result["correct"]
    assert result["metrics"]["frames_run"]["value"] >= 300


@pytest.mark.parametrize("engine", [{"epochs": 2}, {"epochs": 0}, {"online": False},
                                    {"infer_batch": 4}])
def test_a_mix_the_reference_does_not_implement_is_refused_by_name(tmp_path, engine):
    bench_path = tiny.write(tmp_path)
    mix = json.loads((tmp_path / "traffic/talks.json").read_text())
    mix["engine"].update(engine)
    (tmp_path / "traffic/talks.json").write_text(json.dumps(mix))
    with pytest.raises(ValueError, match=next(iter(engine))):
        harness.load_cell("scconformer_xl.nsti.talks", bench_path, tmp_path / "traffic")


def test_idle_share_divides_the_traced_busy_time_by_the_same_record_untraced():
    from portbench.tracing import Trace

    reader = harness.reader(harness.HERE / "metrics", "idle_share")
    profiled = harness.Record(3, 1000, [1000], 9.0, 1.0, True, untraced_wall_s=4.0)
    other = harness.Record(2, 1000, [1000], 1.0, 1.0, False)
    trace = Trace([("k", 0, int(1e9), 1), ("k", int(0.5e9), int(3e9), 2)], {}, [])
    run = harness.Run({}, [other, profiled], trace, profiled)
    assert reader(run) == pytest.approx(100.0 * (1 - 3.0 / 4.0))
    profiled.untraced_wall_s = None
    assert reader(run) is None


def test_refuses_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, str(tiny.ROOT / "portbench/run.py"), "--workload",
                          "scconformer_xl.nsti.talks", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                              "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.parametrize("name", ["scconformer_xl.nsti.talks",
                                  "fastconformer_ctc_large.nsti.talks"])
def test_a_sound_run_is_correct(tmp_path, name):
    result = quiet_run(cell(tmp_path, name))
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-3:] == ["host", "checks", "_check_lines"]
    assert set(result["metrics"]) == {"rtfx", "mfu", "setup_s"}
    assert result["host"]["wall_s"] > 0 and result["host"]["probe_ms_after"] > 0


def no_step(monkeypatch):
    monkeypatch.setattr(madgrad.MADGRAD, "step", lambda self, closure=None: None)


def half_unadapted(monkeypatch):
    """Every other window's step left out of the adaptation."""
    adapt = runner.DynamicEvalEngine._adapt_step
    calls = [0]

    class Idle:
        def zero_grad(self, set_to_none=True):
            pass

        def step(self):
            pass

    def step(self, opt, *a, **k):
        calls[0] += 1
        return adapt(self, opt if calls[0] % 2 else Idle(), *a, **k)

    monkeypatch.setattr(runner.DynamicEvalEngine, "_adapt_step", step)


def token_altered_in_the_transcript(monkeypatch):
    decode = common.decode_output
    monkeypatch.setattr(common, "decode_output", lambda out, tok, *a, **k: "a " + decode(out, tok))


def token_altered_in_the_stitch(monkeypatch):
    finish = runner.DynamicEvalEngine._finish

    def altered(acc, counts):
        lp, c = finish(acc, counts)
        lp = lp.clone()
        lp[3] = lp[3].roll(1)
        return lp, c

    monkeypatch.setattr(runner.DynamicEvalEngine, "_finish", staticmethod(altered))


@pytest.mark.parametrize("fault", [no_step, half_unadapted, token_altered_in_the_transcript,
                                   token_altered_in_the_stitch])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    c = cell(tmp_path)
    fault(monkeypatch)
    assert not quiet_run(c)["correct"]


@pytest.mark.parametrize("name", ["scconformer_xl.nsti.talks",
                                  "fastconformer_ctc_large.nsti.talks"])
def test_the_float8_control_reads_far_above_the_program(tmp_path, name):
    """At this size the limits, set from the cell's own size, do not apply;
    the control still has to read at least three times what the program
    does on the same records."""
    c = cell(tmp_path, name)
    sound = quiet_run(c)["checks"]
    per = harness.control_numbers(c, SEED, "cpu", records=[0, 1, 2])
    worst = check.worst(per)
    assert any(worst[k] >= 3 * max(sound[k]["value"], 1e-3)
               for k in ("label_gap", "stitch_gap", "stitch_tv") if k in sound)


CELLS = [w["name"] for w in json.loads((tiny.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_float8_control_is_not_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    c = harness.load_cell(name)
    per = harness.control_numbers(c, SEED, "cuda", records=[0])
    assert not check.verdict(check.worst(per), c.cfg["limits"])


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_a_run_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, str(tiny.ROOT / "portbench/run.py"), "--workload", name,
                          "--seed", str(SEED), "--seconds", "5"], capture_output=True, text=True,
                         timeout=900, cwd=tiny.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
