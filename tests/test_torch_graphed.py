"""The adapt step's graphed forward and backward (``tta/graphed.py``) on the
CPU, at the tiny size of ``test_torch_engine.py``.

On the CPU the default backend never engages: every window runs eager and
the output is bit for bit that of the engine with the dispatch taken away.
A stand-in backend that supports the CPU (:class:`EagerGraphs`: a
"replay" runs the captured forward again into static buffers, and its
backward through ``torch.autograd.grad``) drives the dispatch itself: the
key and sighting rule (a key seen twice in one pass over a record's
windows; records of one window each never capture), one live graph at a
time, a capture that raises, the calls that must stay eager (``_infer``,
``_entropy_delta``, ``batched``), the hooks on the model, a weight that
moves, and outputs bit for bit those of the eager engine.  The graphs themselves are held on the card by
``test_torch_graphed_gpu.py``.
"""

import contextlib
import copy
import gc
import weakref

import numpy as np
import pytest
import torch

from dynamic_asr_eval_tpu_torch import spans
from dynamic_asr_eval_tpu_torch.config import TTAConfig
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, SCConformer
from dynamic_asr_eval_tpu_torch.tta import DynamicEvalEngine
from dynamic_asr_eval_tpu_torch.tta.graphed import GraphedForward

torch.set_num_threads(1)

TINY = dict(feat_in=32, n_layers=2, d_model=64, n_heads=2, head_dim=32, vocab_size=30,
            subsampling_factor=8, subsampling_conv_channels=16, conv_kernel_size=5,
            attention_impl="pallas_flash", compute_dtype="float32")
SEQ, OVERLAP = 256, 128
FRAMES = (700, 200, 1000)  # 5 windows of 256, 1 of its own 200, 7 of 256


class EagerGraph:
    """A stand-in for a captured pair over static buffers: each replay runs
    the captured forward again on the static inputs and writes the static
    outputs; its backward writes the static gradients."""

    def __init__(self, forward, batch, lengths, params):
        self.forward, self.params = forward, params
        self.inputs = (batch.detach().clone(), lengths.detach().clone())
        with torch.enable_grad():
            out = forward(*self.inputs)
        self.outputs = {k: v.detach().clone() for k, v in out.items()}
        self.grad_output = torch.zeros_like(out["final_posteriors"])
        self.grads = [torch.zeros_like(p) for p in params]

    def replay_forward(self, batch, lengths):
        self.inputs[0].copy_(batch)
        self.inputs[1].copy_(lengths)
        with torch.enable_grad():
            self._out = self.forward(*self.inputs)
        for k, v in self._out.items():
            self.outputs[k].copy_(v.detach())

    def replay_backward(self, grad):
        self.grad_output.copy_(grad)
        grads = torch.autograd.grad(self._out["final_posteriors"], self.params,
                                    self.grad_output, allow_unused=True)
        del self._out
        return tuple(None if g is None else s.copy_(g) for g, s in zip(grads, self.grads))


class EagerGraphs:
    """A backend that supports the CPU; ``captured`` lists each capture's
    batch shape, ``fail`` makes every capture raise."""

    def __init__(self, fail=False):
        self.captured, self.fail, self._made = [], fail, []

    def supports(self, device):
        return True

    def capture(self, forward, batch, lengths, params):
        self.captured.append(tuple(batch.shape))
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        graph = EagerGraph(forward, batch, lengths, params)
        self._made.append(weakref.ref(graph))
        return graph

    def live(self):
        """The captured graphs that something still holds."""
        gc.collect()
        return sum(ref() is not None for ref in self._made)


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return SCConformer(ConformerConfig(**TINY))


def engine_of(model, backend=None, online=True, epochs=1, **options):
    cfg = TTAConfig(seq_len=SEQ, overlap=OVERLAP, epochs=epochs, online=online,
                    shuffle=not online, lm_tta_beams=0, optim_args={"lr": 1e-3}, **options)
    eng = DynamicEvalEngine(model, model.config.vocab_size, 8, cfg, device="cpu")
    if backend is not None:
        eng.graphs = GraphedForward(backend)
    return eng


def specs():
    rng = np.random.default_rng(1)
    return [rng.standard_normal((TINY["feat_in"], n)).astype(np.float32) for n in FRAMES]


def spec_of(frames):
    """A record of ``frames`` frames: one of ``specs()`` where it has that
    length, else drawn from its own seed."""
    if frames in FRAMES:
        return specs()[FRAMES.index(frames)]
    return np.random.default_rng(frames).standard_normal((TINY["feat_in"], frames)).astype(
        np.float32)


def run(engine, frames=FRAMES, seq_len=-1, overlap=-1):
    """The records of ``frames``, recorder on: (outputs, spans)."""
    spans.start()
    try:
        outs = [engine(None, spec_of(n), seq_len, overlap, return_params=True, rng=k,
                       shuffle_rng=np.random.default_rng(k)) for k, n in enumerate(frames)]
    finally:
        got = spans.stop()
    return outs, got


def graphed_flags(got):
    """Per record, the ``graphed`` attribute of each of its windows."""
    records = [s for s in got if s.parent is None]
    return [[s.attrs["graphed"] for s in got if s.name == "engine.window" and s.root == r.id]
            for r in records]


def assert_same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x.logits, y.logits) and torch.equal(x.counts, y.counts)
        assert x.params.keys() == y.params.keys()
        assert all(torch.equal(x.params[k], y.params[k]) for k in x.params)


@contextlib.contextmanager
def no_dispatch():
    """The engine as it was before the dispatch: the model's own forward in
    every call."""
    mp = pytest.MonkeyPatch()
    mp.setattr(GraphedForward, "step", lambda self, *a, **k: contextlib.nullcontext())
    try:
        yield
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def eager(model):
    with no_dispatch():
        return run(engine_of(model))


def test_on_the_cpu_the_default_backend_never_engages(model, eager):
    eng = engine_of(model)
    assert not eng.graphs.engages(eng._work, torch.zeros(2, 32, 256))
    outs, got = run(eng)
    assert graphed_flags(got) == [[False] * 5, [False], [False] * 7]
    records = [s for s in got if s.parent is None]
    assert [(r.attrs["graph_replays"], r.attrs["graph_captures"]) for r in records] == [(0, 0)] * 3
    assert (eng.graphs.captures, eng.graphs.replays, eng.graphs.failures) == (0, 0, 0)
    assert "forward" not in vars(eng._work)
    assert_same(outs, eager[0])


def test_a_key_is_captured_on_its_second_sighting_and_replayed(model, eager):
    backend = EagerGraphs()
    eng = engine_of(model, backend)
    outs, got = run(eng)
    # the 256-frame key: seen in window 1, captured in window 2, replayed
    # in the third record; the 200-frame record's one window runs eager and
    # leaves the live graph in place
    assert graphed_flags(got) == [[False] + [True] * 4, [False], [True] * 7]
    assert backend.captured == [(2, 32, 256)]
    records = [s for s in got if s.parent is None]
    assert [(r.attrs["graph_replays"], r.attrs["graph_captures"]) for r in records] == [
        (4, 1), (0, 0), (7, 0)]
    assert (eng.graphs.captures, eng.graphs.replays, eng.graphs.failures) == (1, 11, 0)
    assert_same(outs, eager[0])


def test_a_new_shape_is_a_new_key_and_replaces_the_live_graph(model):
    backend = EagerGraphs()
    eng = engine_of(model, backend)
    _, got = run(eng, (700, 700, 700))
    _, got2 = run(eng, (700,), seq_len=512, overlap=256)  # two windows of 512
    assert graphed_flags(got) + graphed_flags(got2) == [
        [False] + [True] * 4, [True] * 5, [True] * 5, [False, True]]
    assert backend.captured == [(2, 32, 256), (2, 32, 512)]
    assert (eng.graphs.captures, eng.graphs.replays) == (2, 15)
    assert backend.live() == 1


@pytest.mark.parametrize("epochs", [1, 2])
def test_records_of_one_window_never_capture(model, epochs):
    """Records shorter than the window length, each its own window shape,
    two of them of equal length: one window a pass, so no key is seen twice
    within a pass, whatever the epochs."""
    backend = EagerGraphs()
    eng = engine_of(model, backend, epochs=epochs)
    _, got = run(eng, (200, 150, 200, 220))
    assert graphed_flags(got) == [[False] * epochs] * 4
    assert backend.captured == [] and backend.live() == 0
    assert (eng.graphs.captures, eng.graphs.replays, eng.graphs.failures) == (0, 0, 0)


def test_a_capture_that_raises_leaves_the_key_eager(model, eager):
    backend = EagerGraphs(fail=True)
    eng = engine_of(model, backend)
    with pytest.warns(UserWarning, match="stays eager.*not permitted"):
        outs, got = run(eng)
    assert graphed_flags(got) == [[False] * 5, [False], [False] * 7]
    assert backend.captured == [(2, 32, 256)]  # tried once, never again
    assert (eng.graphs.captures, eng.graphs.replays, eng.graphs.failures) == (0, 0, 1)
    assert_same(outs, eager[0])


def test_a_moved_weight_is_captured_again(model):
    backend = EagerGraphs()
    eng = engine_of(model, backend)
    run(eng, (700,))
    p = next(eng._work.parameters())
    p.data = p.data.clone()  # the same values at a new address
    _, got = run(eng, (700,))
    # the live graph reads the old address: not replayed, captured anew
    assert graphed_flags(got) == [[False] + [True] * 4]
    assert backend.captured == [(2, 32, 256)] * 2
    assert eng.graphs.captures == 2 and backend.live() == 1


class Dispatches:
    """Counts the calls that reach the dispatch, with their grad mode."""

    def __init__(self, monkeypatch):
        self.calls = []
        forward = GraphedForward._forward

        def spy(this, module, eager, *args, **kwargs):
            self.calls.append(torch.is_grad_enabled())
            return forward(this, module, eager, *args, **kwargs)

        monkeypatch.setattr(GraphedForward, "_forward", spy)


def test_offline_inference_and_the_entropy_pass_stay_eager(model, monkeypatch):
    spy = Dispatches(monkeypatch)
    forwards = []
    eng = engine_of(model, EagerGraphs(), online=False, epochs=1, entropy_augmentation=True)
    eng._work.register_forward_pre_hook(lambda m, a: forwards.append(torch.is_grad_enabled()))
    _, got = run(eng, (700,))
    # 5 adapt steps, each after its entropy pass; then _infer's 2 batches
    assert len(forwards) == 5 * 2 + 2 and forwards[-2:] == [False, False]
    assert spy.calls == [True] * 5
    assert graphed_flags(got) == [[False] + [True] * 4]
    assert eng.graphs.replays == 4


def test_batched_never_dispatches(model, monkeypatch):
    spy = Dispatches(monkeypatch)
    eng = engine_of(model, EagerGraphs(), epochs=1)
    outs = eng.batched(None, specs()[:2], rng=0)
    assert len(outs) == 2 and all(torch.isfinite(o.logits).all() for o in outs)
    assert spy.calls == [] and eng.graphs.replays == eng.graphs.captures == 0


def test_no_grad_calls_stay_eager(model):
    eng = engine_of(model, EagerGraphs())
    batch = torch.zeros(2, 32, 256)
    with torch.no_grad():
        assert not eng.graphs.engages(eng._work, batch)
    assert eng.graphs.engages(eng._work, batch)
    assert not eng.graphs.engages(eng._work, batch, mesh=object())
    assert not eng.graphs.engages(eng._work, batch.requires_grad_(True))


def test_a_hook_below_the_model_keeps_it_eager(model):
    eng = engine_of(model, EagerGraphs())
    handle = eng._work.layers[0].register_forward_hook(lambda m, a, o: None)
    assert not eng.graphs.engages(eng._work, torch.zeros(2, 32, 256))
    _, got = run(eng, (700,))
    assert graphed_flags(got) == [[False] * 5]
    handle.remove()
    assert eng.graphs.engages(eng._work, torch.zeros(2, 32, 256))


def hooked(model, backend):
    """An engine built from a copy of ``model`` whose hooks, registered
    before the engine as the benchmark registers them, note each call and
    the argmax ids of its clean copy."""
    m = copy.deepcopy(model)
    seen = {"pre": 0, "ids": []}

    def pre(module, args):
        seen["pre"] += 1

    def post(module, args, out):
        seen["ids"].append(out["final_posteriors"][-1].argmax(-1))

    m.register_forward_pre_hook(pre)
    m.register_forward_hook(post)
    return engine_of(m, backend), seen


def test_hooks_on_the_model_fire_once_a_window_with_its_output(model):
    eng, seen = hooked(model, EagerGraphs())
    with no_dispatch():
        ref, ref_seen = hooked(model, None)
        run(ref)
    _, got = run(eng)
    assert graphed_flags(got) == [[False] + [True] * 4, [False], [True] * 7]
    assert seen["pre"] == ref_seen["pre"] == 13
    assert len(seen["ids"]) == len(ref_seen["ids"]) == 13
    assert all(torch.equal(a, b) for a, b in zip(seen["ids"], ref_seen["ids"]))
    assert len({tuple(i.tolist()) for i in seen["ids"]}) > 1  # each window its own


def test_gradients_accumulate_as_eager_without_a_reset(model):
    """Two steps' gradients summed in ``.grad``: the first step's, an alias
    of the graph's buffers, moves off them before the second replay."""
    m, ref = copy.deepcopy(model), copy.deepcopy(model)
    graphs = GraphedForward(EagerGraphs())
    rng = torch.Generator().manual_seed(3)
    lengths = torch.tensor([256, 256])
    for k in range(4):  # seen, captured, replayed, replayed
        x = torch.randn(2, 32, 256, generator=rng)
        if k == 1:  # the capture's step sets .grad to an alias; no reset after
            m.zero_grad(set_to_none=True)
            ref.zero_grad(set_to_none=True)
        with graphs.step(m, x):
            out = m(x, lengths)
        out["final_posteriors"][0].sum().backward()
        ref(x, lengths)["final_posteriors"][0].sum().backward()
    assert graphs.replays == 3
    for p, q in zip(m.parameters(), ref.parameters()):
        assert torch.equal(p.grad, q.grad)
