"""The span recorder (``dynamic_asr_eval_tpu_torch/spans.py``) and the NSTI
engine's spans, on the CPU at the tiny size of ``test_torch_engine.py``.

Off, the recorder makes nothing; on, each call of ``DynamicEvalEngine`` gives
one ``engine.record`` root whose ``windows`` is the plan's count (the
engine's own and the benchmark's plain reference's), each adapted window
its phases in order, and the outputs stay bit for bit those of a run with
the recorder off.  The spans' clock is ``torch.profiler``'s: a span around a
``record_function`` range brackets it in the profiler's trace.
"""

import json

import numpy as np
import pytest
import torch

from dynamic_asr_eval_tpu_torch import spans
from dynamic_asr_eval_tpu_torch.config import TTAConfig
from dynamic_asr_eval_tpu_torch.evals.common import PROFILE_SPANS, PROFILE_TRACE, profile_to
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, SCConformer
from dynamic_asr_eval_tpu_torch.tta import DynamicEvalEngine
from portbench.reference.nsti import plan

torch.set_num_threads(1)

TINY = dict(feat_in=32, n_layers=2, d_model=64, n_heads=2, head_dim=32, vocab_size=30,
            subsampling_factor=8, subsampling_conv_channels=16, conv_kernel_size=5,
            attention_impl="pallas_flash", compute_dtype="float32")
SEQ, OVERLAP = 256, 128
FRAMES = (700, 200, 1000)  # 5, 1 and 8 windows
WINDOW = ("engine.augment", "engine.forward", "engine.labels", "engine.loss", "engine.backward",
          "engine.optimizer", "engine.stitch")
MODES = {"online-1": (True, 1), "online-2": (True, 2), "offline-2": (False, 2)}


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return SCConformer(ConformerConfig(**TINY))


def engine_of(model, online=True, epochs=1):
    cfg = TTAConfig(seq_len=SEQ, overlap=OVERLAP, epochs=epochs, online=online,
                    shuffle=not online, lm_tta_beams=0, optim_args={"lr": 1e-3})
    return DynamicEvalEngine(model, model.config.vocab_size, 8, cfg, device="cpu")


def specs():
    rng = np.random.default_rng(1)
    return [rng.standard_normal((TINY["feat_in"], n)).astype(np.float32) for n in FRAMES]


def run_records(engine, on: bool):
    """Every record of ``specs()`` through one engine; returns the outputs
    and, recorder on, the spans of all of them."""
    if on:
        spans.start()
    try:
        outs = [engine(None, s, return_params=True, rng=k,
                       shuffle_rng=np.random.default_rng(k)) for k, s in enumerate(specs())]
    finally:
        got = spans.stop() if on else None
    return outs, got


@pytest.fixture(scope="module", params=list(MODES))
def recorded(request, model):
    online, epochs = MODES[request.param]
    eng = engine_of(model, online, epochs)
    on, got = run_records(eng, True)
    off, _ = run_records(eng, False)
    return {"online": online, "epochs": epochs, "engine": eng, "on": on, "off": off,
            "spans": got}


def children(got, parent):
    return [s for s in got if s.parent == parent.id]


def roots(got):
    return [s for s in got if s.parent is None]


def test_off_the_recorder_makes_no_span_and_shares_one_object(model, monkeypatch):
    assert spans.span("engine.record", windows=0) is spans.span("engine.window") is spans.OFF

    def made(*a, **k):
        raise AssertionError("a span was made with the recorder off")

    monkeypatch.setattr(spans, "Span", made)
    out = engine_of(model)(None, specs()[0], rng=0)
    assert torch.isfinite(out.logits).all()
    spans.start()
    assert spans.stop() == []


def test_one_root_per_record_counts_the_planned_windows(recorded):
    got, eng, epochs = recorded["spans"], recorded["engine"], recorded["epochs"]
    records = roots(got)
    assert [r.name for r in records] == ["engine.record"] * len(FRAMES)
    for r, n in zip(records, FRAMES):
        assert r.attrs["frames"] == n and r.attrs["epochs"] == epochs
        assert r.attrs["windows"] == eng.window_count(n, SEQ, OVERLAP) * epochs
        assert r.attrs["windows"] == len(plan(n, SEQ, OVERLAP)) * epochs
        assert r.attrs["windows"] == sum(s.name == "engine.window" for s in children(got, r))


def test_each_window_has_its_phases_in_order_inside_it(recorded):
    got = recorded["spans"]
    want = WINDOW if recorded["online"] else WINDOW[:-1]
    windows = [s for s in got if s.name == "engine.window"]
    assert windows
    for w in windows:
        kids = children(got, w)
        assert tuple(k.name for k in kids) == want
        assert w.start_ns <= kids[0].start_ns
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
        assert kids[-1].end_ns <= w.end_ns
        assert {"epoch", "index", "valid_frames"} <= set(w.attrs)


def test_records_children_and_the_shared_root_id(recorded):
    got, online = recorded["spans"], recorded["online"]
    by_id = {s.id: s for s in got}
    for s in got:
        root = s if s.parent is None else by_id[s.root]
        assert root.name == "engine.record" and root.parent is None
        if s.parent is not None:
            parent = by_id[s.parent]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
            assert s.root == parent.root
    for r, out in zip(roots(got), recorded["on"]):
        names = [k.name for k in children(got, r)]
        n = r.attrs["windows"]
        tail = ["engine.drain"] if online else ["engine.infer", "engine.drain"]
        assert names == ["engine.plan", "engine.load"] + ["engine.window"] * n + tail
        # elapsed runs from the plan's end to the drain's end
        plan_span = children(got, r)[0]
        plan_s = (plan_span.end_ns - plan_span.start_ns) / 1e9
        assert (r.end_ns - r.start_ns) / 1e9 == pytest.approx(plan_s + out.elapsed, abs=5e-3)


def test_the_recorder_on_changes_no_output(recorded):
    for on, off in zip(recorded["on"], recorded["off"]):
        assert torch.equal(on.logits, off.logits) and torch.equal(on.counts, off.counts)
        assert on.params.keys() == off.params.keys()
        assert all(torch.equal(on.params[k], off.params[k]) for k in on.params)


def test_spans_share_the_profilers_clock():
    """Stamped with ``time.time_ns()``, a span brackets a ``record_function``
    range opened and closed inside it, as the profiler stamps that range."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        spans.start()
        try:
            with spans.span("outer"):
                with torch.profiler.record_function("spans_clock_probe"):
                    torch.ones(4096).cumsum(0)
        finally:
            (outer,) = spans.stop()
    (probe,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "spans_clock_probe"]
    start, end = probe.start_ns(), probe.start_ns() + probe.duration_ns()
    assert 0 <= start - outer.start_ns < 5_000_000
    assert 0 <= outer.end_ns - end < 5_000_000


def test_profile_to_writes_the_spans_beside_the_trace(model, tmp_path):
    with profile_to(str(tmp_path)):
        engine_of(model)(None, specs()[1], rng=0)
    assert spans.span("after") is spans.OFF
    assert (tmp_path / PROFILE_TRACE).exists()
    got = json.loads((tmp_path / PROFILE_SPANS).read_text())
    assert got[0]["name"] == "engine.record" and got[0]["attrs"]["windows"] == 1
    assert [s["name"] for s in got if s["parent"] == got[0]["id"]] == [
        "engine.plan", "engine.load", "engine.window", "engine.drain"]
    assert all(s["root"] == got[0]["id"] and s["start_ns"] <= s["end_ns"] for s in got)
    assert got[0]["start_ns"] > 1e18  # epoch nanoseconds
