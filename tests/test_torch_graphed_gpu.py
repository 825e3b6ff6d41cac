"""The adapt step's CUDA graphs (``tta/graphed.py``) against the eager path,
on the card.  Marked ``gpu``: it skips where there is no CUDA device.  It
imports no JAX, so on a machine with a card and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_graphed_gpu.py

The engine runs the flagship's widths (d 768, 6 heads x 128, x8 fused
subsampling with 256 channels, bf16 through the hand-written attention and
subsampling kernels) at 2 layers, in 4096-frame windows every 2048 frames,
over three records whose last windows differ in valid length, with other
weights loaded for each record.  The graphed engine and one that never
engages give the same stitched log-probs, adapted weights and hooks' argmax
ids, bit for bit; the graphed one captures its one key once, and the
kernels' counters count its eager, warm-up and capture passes and no
replay.  Both sides run cuDNN's deterministic algorithms and the CTC loss
on the CPU: aten's CUDA CTC backward accumulates with atomics (PyTorch lists
it among its nondeterministic operations), so two runs on the card may part
after a step; the eager side run twice shows the comparison repeats.  A
small module whose forward reads a device value on the host shows a capture
that raises on the card: the key stays eager, the next calls run, and the
default CUDA generator still draws.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dynamic_asr_eval_tpu_torch import spans
from dynamic_asr_eval_tpu_torch.config import TTAConfig
from dynamic_asr_eval_tpu_torch.device import deterministic_cudnn
from dynamic_asr_eval_tpu_torch.kernels import attention as A
from dynamic_asr_eval_tpu_torch.kernels import subsample as S
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, SCConformer, init_conformer
from dynamic_asr_eval_tpu_torch.ops.ctc import ctc_loss
from dynamic_asr_eval_tpu_torch.tta import DynamicEvalEngine
from dynamic_asr_eval_tpu_torch.tta import runner
from dynamic_asr_eval_tpu_torch.tta.graphed import CudaGraphs, GraphedForward

CFG = dict(feat_in=80, n_layers=2, d_model=768, n_heads=6, head_dim=128, vocab_size=1023,
           subsampling_factor=8, subsampling_conv_channels=256, conv_kernel_size=9,
           rotary_base_freq=1500000.0, compute_dtype="bfloat16", attention_impl="pallas_flash",
           subsampling_impl="pallas", attention_logits_in_compute_dtype=True,
           head_in_compute_dtype=True)
SEQ, OVERLAP = 4096, 2048
FRAMES = (9000, 10500, 12300)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the Hopper kernels)")
    return torch.device("cuda")


class Never(CudaGraphs):
    """The eager side: a backend that supports no device."""

    def supports(self, device):
        return False


def engine(cuda, backend):
    """An engine over a model whose hooks, registered before the engine as
    the benchmark registers them, note the argmax ids of each call's clean
    copy."""
    cfg = ConformerConfig(**CFG)
    model = SCConformer(cfg).to(cuda)
    ids = []
    model.register_forward_hook(lambda m, a, out: ids.append(out["final_posteriors"][-1].argmax(-1)))
    tta = TTAConfig(seq_len=SEQ, overlap=OVERLAP, epochs=1, online=True, shuffle=False,
                    lm_tta_beams=0, optim_args={"lr": 3e-4})
    eng = DynamicEvalEngine(model, cfg.blank_id, 8, tta, transfer_dtype=torch.bfloat16,
                            device=cuda)
    eng.graphs = GraphedForward(backend)
    return eng, ids


def run(eng, weights, specs):
    A.reset_counters()
    S.reset_counters()
    spans.start()
    try:
        with deterministic_cudnn():
            outs = [eng(w, s, return_params=True, rng=1000 + k)
                    for k, (w, s) in enumerate(zip(weights, specs))]
        torch.cuda.synchronize()
    finally:
        got = spans.stop()
    launches = {"attention": (A.fwd_launches, A.bwd_launches),
                "subsample": (S.fwd_launches, S.bwd_launches, S.gx_launches)}
    return outs, got, launches


def cpu_ctc_loss(log_probs, input_lengths, labels, label_lengths, blank_id=None):
    """The engine's CTC loss computed on the CPU, whose backward repeats bit
    for bit; its gradient comes back to the card through the copy."""
    return ctc_loss(log_probs.cpu(), input_lengths.cpu(), labels.cpu(), label_lengths.cpu(),
                    blank_id=blank_id).to(log_probs.device)


@pytest.fixture(scope="module")
def both(cuda):
    cfg = ConformerConfig(**CFG)
    weights = [{k: v.to(cuda) for k, v in init_conformer(cfg, seed=s).state_dict().items()}
               for s in (1, 2, 3)]
    rng = np.random.default_rng(7)
    specs = [rng.standard_normal((CFG["feat_in"], n)).astype(np.float32) for n in FRAMES]
    mp = pytest.MonkeyPatch()
    mp.setattr(runner, "ctc_loss", cpu_ctc_loss)
    out = {}
    try:
        for side, backend in (("graphed", CudaGraphs()), ("eager", Never()), ("eager2", Never())):
            eng, ids = engine(cuda, backend)
            outs, got, launches = run(eng, weights, specs)
            out[side] = {"engine": eng, "ids": ids, "outs": outs, "spans": got,
                         "launches": launches}
        yield out
    finally:
        mp.undo()


@pytest.mark.gpu
def test_the_last_windows_differ_in_valid_length(both):
    got = both["graphed"]["spans"]
    last = [[s.attrs["valid_frames"] for s in got if s.name == "engine.window"
             and s.root == r.id][-1] for r in got if r.parent is None]
    assert len(set(last)) == 3, last


def assert_same_outputs(a, b):
    for g, e in zip(a, b):
        assert torch.equal(g.logits, e.logits) and torch.equal(g.counts, e.counts)
        assert g.params.keys() == e.params.keys()
        for k in g.params:
            assert torch.equal(g.params[k], e.params[k]), k


@pytest.mark.gpu
def test_the_eager_path_repeats_bit_for_bit(both):
    assert_same_outputs(both["eager"]["outs"], both["eager2"]["outs"])


@pytest.mark.gpu
def test_stitched_log_probs_and_adapted_weights_are_bit_for_bit(both):
    assert_same_outputs(both["graphed"]["outs"], both["eager"]["outs"])


@pytest.mark.gpu
def test_hooks_see_every_window_with_the_same_ids(both):
    g, e = both["graphed"]["ids"], both["eager"]["ids"]
    windows = sum(s.name == "engine.window" for s in both["graphed"]["spans"])
    assert len(g) == len(e) == windows
    assert all(torch.equal(a, b) for a, b in zip(g, e))


@pytest.mark.gpu
def test_one_capture_for_the_one_key_then_every_window_replays(both):
    graphs = both["graphed"]["engine"].graphs
    got = both["graphed"]["spans"]
    flags = [s.attrs["graphed"] for s in got if s.name == "engine.window"]
    assert flags == [False] + [True] * (len(flags) - 1)
    assert (graphs.captures, graphs.replays, graphs.failures) == (1, len(flags) - 1, 0)
    records = [r for r in got if r.parent is None]
    assert [r.attrs["graph_captures"] for r in records] == [1, 0, 0]
    eager = both["eager"]["engine"].graphs
    assert (eager.captures, eager.replays) == (0, 0)


@pytest.mark.gpu
def test_the_kernels_count_every_pass_they_launch_and_no_replay(both):
    windows = sum(s.name == "engine.window" for s in both["graphed"]["spans"])
    graphs = both["graphed"]["engine"].graphs
    # each window's eager pass; a capture's warm-up and capture passes
    passes = windows - graphs.replays + 2 * graphs.captures
    assert both["eager"]["launches"] == {"attention": (2 * windows, 2 * windows),
                                         "subsample": (windows, windows, 0)}
    assert both["graphed"]["launches"] == {"attention": (2 * passes, 2 * passes),
                                           "subsample": (passes, passes, 0)}


@pytest.mark.gpu
def test_new_weights_take_effect(both):
    outs = both["graphed"]["outs"]
    # the records' weights differ, and each record's adapted weights start
    # from its own: no graph reads a record's weights into the next
    assert not torch.equal(outs[1].params["decoder.weight"], outs[2].params["decoder.weight"])
    spec = np.random.default_rng(8).standard_normal((CFG["feat_in"], 5000)).astype(np.float32)
    again, _, _ = run(both["graphed"]["engine"], [outs[0].params], [spec])
    ref, _, _ = run(both["eager"]["engine"], [outs[0].params], [spec])
    assert torch.equal(again[0].logits, ref[0].logits)
    assert all(torch.equal(again[0].params[k], ref[0].params[k]) for k in ref[0].params)


class Head(torch.nn.Module):
    """A model-shaped module: ``final_posteriors`` from a linear map;
    ``host_read`` makes its forward read a device value on the host."""

    def __init__(self, host_read: bool):
        super().__init__()
        self.proj = torch.nn.Linear(16, 8)
        self.host_read = host_read

    def forward(self, x, length):
        if self.host_read:
            int(length.max())
        lp = F.log_softmax(self.proj(x.transpose(1, 2)), dim=-1)
        return {"final_posteriors": lp, "length": length}


@pytest.mark.gpu
@pytest.mark.parametrize("host_read", [False, True])
def test_a_module_through_the_graphs_and_a_capture_that_raises(cuda, host_read):
    torch.manual_seed(0)
    model = Head(host_read).to(cuda)
    ref = Head(host_read).to(cuda)
    ref.load_state_dict(model.state_dict())
    graphs = GraphedForward()
    for k in range(4):
        x = torch.randn(2, 16, 32, device=cuda)
        lengths = torch.full((2,), 32 - k, device=cuda)
        for m, dispatch in ((model, True), (ref, False)):
            m.zero_grad(set_to_none=True)
            if dispatch:
                with graphs.step(m, x):
                    out = m(x, lengths)
            else:
                out = m(x, lengths)
            (out["final_posteriors"][0] * torch.arange(8, device=cuda)).sum().backward()
        assert torch.equal(model.proj.weight.grad, ref.proj.weight.grad)
        assert torch.equal(model.proj.bias.grad, ref.proj.bias.grad)
    torch.cuda.synchronize()
    if host_read:
        assert (graphs.captures, graphs.replays, graphs.failures) == (0, 0, 1)
    else:
        assert (graphs.captures, graphs.replays, graphs.failures) == (1, 3, 0)
