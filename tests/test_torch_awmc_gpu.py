"""The port's AWMC engine on the card: through the Hopper kernels
(``attention_impl="pallas_flash"``, ``subsampling_impl="pallas"``) against
the same engine on the plain path (``"xla"`` attention, ``"conv"``
subsampling), same weights and recording.  Marked ``gpu``: it skips where
there is no CUDA device.  No JAX is imported, so on a machine with a card
and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_awmc_gpu.py

A small model (2 layers, d 64, feat 80, subsampling ×8 with 16 channels), a
1000-frame recording in 512-frame windows with 256 overlap (3 windows of
512, 512 and 488 frames: multiples of 8, where the fused kernel's unmasked
semantics and the conv path's masks agree).  f32, TF32 off, cuDNN's
deterministic algorithms on both sides (``device.deterministic_cudnn``).
Each window runs the anchor and clean forwards once and the leader and
student forwards and the student's backward each epoch, so the kernels'
launch counts are exact.

Bars.  The un-adapted forward of every window: kernel path within 1e-4 of
the plain path (f32 noise, ~1e-5).  The adapted run: six optimizer steps
carry that noise into the weights (~3e-7 apart) and the adaptation
amplifies it window by window, so the stitched log-probs (magnitude ~10)
drift ~1e-4 apart, while the plain f32 path itself lands ~5e-4 from the
same engine in float64 (the plain path with every ``.float()`` of the port
kept in float64; measured on an H100, see the second test).  So both f32
paths are held against that float64 run: the kernel path no further from it
than twice the plain path's own distance plus 1e-5.  Greedy ids equal and
the adapted weights within 2e-5 of each other, as before.
"""

import contextlib

import numpy as np
import pytest
import torch

from dynamic_asr_eval_tpu_torch.config import TTAConfig
from dynamic_asr_eval_tpu_torch.device import deterministic_cudnn, set_parity_precision
from dynamic_asr_eval_tpu_torch.kernels import attention as A
from dynamic_asr_eval_tpu_torch.kernels import subsample as S
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, init_conformer
from dynamic_asr_eval_tpu_torch.ops.chunk import chunk_starts_and_lengths
from dynamic_asr_eval_tpu_torch.tta import AWMCEngine

SMALL = dict(feat_in=80, n_layers=2, d_model=64, n_heads=2, head_dim=32, vocab_size=30,
             subsampling_factor=8, subsampling_conv_channels=16, conv_kernel_size=5)
N_WINDOWS, EPOCHS = 3, 2
SEQ, OVERLAP, FRAMES = 512, 256, 1000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the Hopper kernels have no CPU mode)")
    set_parity_precision()
    return torch.device("cuda")


@contextlib.contextmanager
def _float64():
    """The port's plain path in float64: every ``.float()`` keeps float64
    (the model casts its LayerNorm statistics, rotary products, logits, head
    and CTC input with it).  Test-only: the anchor of the f32 comparisons."""
    saved = torch.Tensor.float
    torch.Tensor.float = lambda self, *args, **kwargs: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = saved


def _spec():
    return np.random.default_rng(1).standard_normal((80, FRAMES)).astype(np.float32)


def _model(cuda, dtype, attention_impl, subsampling_impl):
    if dtype == torch.float64:  # the anchor: f64 weights, head in f64 too
        cfg = ConformerConfig(compute_dtype=dtype, attention_impl=attention_impl,
                              subsampling_impl=subsampling_impl, head_in_compute_dtype=True,
                              **SMALL)
        return cfg, init_conformer(cfg, seed=0).double().to(cuda)
    cfg = ConformerConfig(compute_dtype=dtype, attention_impl=attention_impl,
                          subsampling_impl=subsampling_impl, **SMALL)
    return cfg, init_conformer(cfg, seed=0).to(cuda)


def _run(cuda, dtype, attention_impl, subsampling_impl, trace=None):
    """The engine on the recording; ``trace`` (a dict) receives the clean
    log-probs of every window and the student's weights after every step."""
    cfg, model = _model(cuda, dtype, attention_impl, subsampling_impl)
    tta = TTAConfig(seq_len=SEQ, overlap=OVERLAP, epochs=EPOCHS, online=True, shuffle=False,
                    lm_tta_beams=0, optim_args={"lr": 1e-3})
    engine = AWMCEngine(model, cfg.blank_id, 8, tta, device=cuda)
    if trace is not None:
        trace.update(windows=[], steps=[])
        step, accumulate = engine._student_step, engine._accumulate

        def traced_step(*args):
            step(*args)
            trace["steps"].append({k: p.detach().double().clone()
                                   for k, p in engine._work.named_parameters()})

        def traced_accumulate(acc, counts, lp, start_ds, ds_len):
            trace["windows"].append(lp[:ds_len].detach().double().clone())
            accumulate(acc, counts, lp, start_ds, ds_len)

        engine._student_step, engine._accumulate = traced_step, traced_accumulate
    A.reset_counters()
    S.reset_counters()
    with deterministic_cudnn(), (_float64() if dtype == torch.float64
                                 else contextlib.nullcontext()):
        out = engine(None, _spec(), return_params=True)
        logits = torch.as_tensor(out.numpy_logits(), dtype=torch.float64)
    torch.cuda.synchronize()
    return out, logits, {name: {r: list(c) for r, c in mod.route_launches.items()}
                         for name, mod in (("attention", A), ("subsample", S))}


@torch.no_grad()
def _unadapted(cuda, attention_impl, subsampling_impl):
    """Log-probs of the pristine f32 model on each window, batch 1."""
    _, model = _model(cuda, torch.float32, attention_impl, subsampling_impl)
    spec = torch.as_tensor(_spec(), device=cuda)
    outs = []
    with deterministic_cudnn():
        for start, n in zip(*chunk_starts_and_lengths(FRAMES, SEQ, OVERLAP)):
            start, n = int(start), int(n)
            lp = model(spec[None, :, start:start + n], torch.tensor([n], device=cuda))
            outs.append(lp["final_posteriors"][0])
    return outs


def _expected_launches(dtype):
    forwards = 2 + 2 * EPOCHS  # anchor and clean once; leader and student each epoch
    per_window = {"attention": (SMALL["n_layers"] * forwards, SMALL["n_layers"] * EPOCHS),
                  "subsample": (forwards, EPOCHS)}
    expect = {}
    for name, (f, b) in per_window.items():
        routes = (A if name == "attention" else S).ROUTES
        expect[name] = {r: [0, 0] for r in routes.values()}
        expect[name][routes[dtype]] = [f * N_WINDOWS, b * N_WINDOWS]
    return expect


def _max_abs(a, b):
    return (a.double() - b.double()).abs().max().item()


@pytest.mark.gpu
def test_f32_kernel_path_matches_the_plain_path(cuda):
    fresh = [_max_abs(a, b) for a, b in zip(_unadapted(cuda, "pallas_flash", "pallas"),
                                            _unadapted(cuda, "xla", "conv"))]
    print(f"un-adapted forward, kernel vs plain path by window: {fresh}")
    assert len(fresh) == N_WINDOWS and max(fresh) <= 1e-4, fresh
    kern, kern_lp, launches = _run(cuda, torch.float32, "pallas_flash", "pallas")
    assert launches == _expected_launches(torch.float32)
    plain, plain_lp, plain_launches = _run(cuda, torch.float32, "xla", "conv")
    assert plain_launches["attention"][A.ROUTES[torch.float32]] == [0, 0]
    _, exact_lp, _ = _run(cuda, torch.float64, "xla", "conv")
    kern_gap, plain_gap = _max_abs(kern_lp, exact_lp), _max_abs(plain_lp, exact_lp)
    print(f"adapted stitched log-probs: kernel-plain {_max_abs(kern_lp, plain_lp):.3e}, "
          f"kernel-f64 {kern_gap:.3e}, plain-f64 {plain_gap:.3e}")
    assert kern_gap <= 2 * plain_gap + 1e-5, (kern_gap, plain_gap)
    np.testing.assert_array_equal(kern.greedy_ids(), plain.greedy_ids())
    for k, v in plain.params.items():
        assert (kern.params[k] - v).abs().max().item() <= 2e-5, k


@pytest.mark.gpu
def test_f32_kernel_path_stays_as_close_to_float64_as_the_plain_path(cuda):
    """Window by window and step by step, the clean log-probs and the
    student's weights: the kernel path (both kernels, and the attention
    kernel alone) no further from the float64 engine than twice the plain
    f32 path plus 1e-5; the plain path repeats bit for bit.  Prints every
    distance (the measurement behind the bars above)."""
    traces = {}
    for name, dtype, attn, sub in (("kernels", torch.float32, "pallas_flash", "pallas"),
                                   ("attention kernel", torch.float32, "pallas_flash", "conv"),
                                   ("plain", torch.float32, "xla", "conv"),
                                   ("plain again", torch.float32, "xla", "conv"),
                                   ("f64", torch.float64, "xla", "conv")):
        traces[name] = {}
        _run(cuda, dtype, attn, sub, trace=traces[name])
    names = list(traces)
    pairs = [(a, b) for i, a in enumerate(names) for b in names[i + 1:]]
    rows = [(f"window {w}: clean log-probs",
             lambda a, b, w=w: _max_abs(traces[a]["windows"][w], traces[b]["windows"][w]))
            for w in range(N_WINDOWS)]
    rows += [(f"window {s // EPOCHS} epoch {s % EPOCHS}: weights",
              lambda a, b, s=s: max(_max_abs(traces[a]["steps"][s][k], traces[b]["steps"][s][k])
                                    for k in traces[a]["steps"][s]))
             for s in range(N_WINDOWS * EPOCHS)]
    for what, gap in rows:
        print(f"{what}: " + ", ".join(f"{a}-{b} {gap(a, b):.3e}" for a, b in pairs))
        assert gap("plain", "plain again") == 0.0, what
        for kernel in ("kernels", "attention kernel"):
            assert gap(kernel, "f64") <= 2 * gap("plain", "f64") + 1e-5, (what, kernel)


@pytest.mark.gpu
def test_bf16_kernel_path_runs_on_the_tensor_cores(cuda):
    out, _, launches = _run(cuda, torch.bfloat16, "pallas_flash", "pallas")
    assert launches == _expected_launches(torch.bfloat16)
    lp = out.numpy_logits()
    assert lp.shape == (-(-FRAMES // 8), SMALL["vocab_size"] + 1)
    assert np.isfinite(lp).all()
