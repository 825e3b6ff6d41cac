"""Drive the PyTorch port on one NVIDIA GPU and check it, phase by phase.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build the hand-written CUDA kernels from the checkout (nvcc, sm_90a);
3. each kernel against its plain PyTorch version on the same inputs, at the
   shapes the main path gives it (flagship [2, 2048, 6, 128] with lengths
   [2048, 1600]; ragged T 1000 with lengths [1000, 777, 1000]), bf16 and f32,
   TF32 off.  Tolerance: |kernel - plain| <= 1e-4 (f32) or 2e-2 (bf16) of
   max |plain|, the plain version computed in f32;
4. kernel, plain and library (SDPA with a boolean mask, a yardstick the port
   never calls) times at the flagship shape, CUDA events after warm-up, and
   the least time the card could take (bound);
5. the main path: the port's NSTI driver (``evals/run.py`` ``main``) on one
   30720-frame ``synthetic_spec`` recording (9 windows of seq 16384 /
   overlap 14336, the last ragged at 14336 frames) at the flagship widths
   with ``attention_impl="pallas_flash"``, bf16, random weights from a seed;
   the launch counters are zeroed just before and read just after;
6. output checks on that run: the engine's stitched log-probs are finite
   with the expected shape and the weights moved; then, on a small input,
   the full-depth model in f32 through the kernel agrees with the plain
   attention path on valid frames (1e-3);
7. where the time goes: the driver's engine, warm, on the same recording:
   engine wall of 3 runs, ms per window and RTFx at the fastest, then one
   run under torch.profiler for device busy time, idle share, device time
   by kernel family and the top kernels (a ``{"profile": ...}`` line).

Prints the card line, a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.  TF32 stays off throughout.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

FWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM dense
PEAK_BYTES = 3.35e12
N_FRAMES = 30720
SEQ, OVERLAP = 16384, 14336
N_WINDOWS = 9  # ops.chunk.chunk_starts_and_lengths(N_FRAMES, SEQ, OVERLAP)
TIMED_RUNS = 3
TOP_KERNELS = 15
FAMILIES = (
    ("flash_attention", ("fwd_kernel", "bwd_dkdv_kernel", "bwd_dq_kernel", "bwd_delta_kernel")),
    ("conv", ("conv", "cudnn", "fprop", "implicit", "wgrad", "dgrad")),
    ("gemm", ("gemm", "xmma", "cutlass", "sm90_", "ampere_", "cublas")),
    ("ctc", ("ctc",)),
    ("norm_softmax", ("layer_norm", "softmax", "LayerNorm")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "Kernel")),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def flagship_config(**overrides):
    from dynamic_asr_eval_tpu_torch.models import ConformerConfig

    kw = dict(feat_in=80, n_layers=6, d_model=768, n_heads=6, head_dim=128, vocab_size=4095,
              subsampling_factor=8, subsampling_conv_channels=256, conv_kernel_size=9,
              rotary_base_freq=1_500_000.0, self_conditioning=True,
              compute_dtype=torch.bfloat16, attention_impl="pallas_flash",
              attention_logits_in_compute_dtype=True, head_in_compute_dtype=True)
    kw.update(overrides)
    return ConformerConfig(**kw)


def attention_inputs(B, T, H, D, lengths, dtype, seed=0):
    """q, k contiguous and v a strided view of one qkv tensor, as the model
    hands them to the kernel."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, T, 3, H, D, generator=g, device="cuda").to(dtype)
    q, k, v = qkv.unbind(2)
    mask = torch.arange(T, device="cuda")[None] < torch.tensor(lengths, device="cuda")[:, None]
    dout = torch.randn(B, T, H, D, generator=g, device="cuda").to(dtype)
    return q.contiguous(), k.contiguous(), v, mask, dout


def check_attention(A, B, T, H, D, lengths, dtype):
    q, k, v, mask, dout = attention_inputs(B, T, H, D, lengths, dtype)
    out, lse = A.flash_attention_fwd(q, k, v, mask)
    grads = A.flash_attention_bwd(q, k, v, mask, out, lse, dout)
    ref_out, ref_lse = A.attention_reference(q.float(), k.float(), v.float(), mask)
    ref_grads = A.attention_reference_bwd(q.float(), k.float(), v.float(), mask,
                                          ref_out, ref_lse, dout.float())
    torch.cuda.synchronize()
    errs = {}
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out,) + tuple(grads),
                          (ref_out,) + tuple(ref_grads)):
        err = (a.float() - b).abs().max().item()
        scale = b.abs().max().item()
        if not err <= FWD_TOL[dtype] * scale:
            raise AssertionError(f"{name} {dtype} T={T}: |err| {err:.3e} > "
                                 f"{FWD_TOL[dtype]} x {scale:.3e}")
        errs[name] = err
    lse_err = (lse - ref_lse).abs().max().item()
    if not lse_err <= 1e-3:
        raise AssertionError(f"lse {dtype} T={T}: |err| {lse_err:.3e}")
    log(f"  {str(dtype):15s} B={B} T={T} lengths={lengths}: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f", lse {lse_err:.2e}")
    return errs


def cuda_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_attention(A, B, T, H, D, lengths, dtype):
    import torch.nn.functional as F

    q, k, v, mask, dout = attention_inputs(B, T, H, D, lengths, dtype, seed=1)
    out, lse = A.flash_attention_fwd(q, k, v, mask)
    ref_out, ref_lse = A.attention_reference(q, k, v, mask)
    same = A._same_segment(mask)  # [B, 1, T, T]
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=same)
    dout_t = dout.transpose(1, 2)
    t = {
        "fwd": cuda_ms(lambda: A.flash_attention_fwd(q, k, v, mask)),
        "bwd": cuda_ms(lambda: A.flash_attention_bwd(q, k, v, mask, out, lse, dout)),
        "fwd_plain": cuda_ms(lambda: A.attention_reference(q, k, v, mask)),
        "bwd_plain": cuda_ms(lambda: A.attention_reference_bwd(q, k, v, mask, ref_out,
                                                               ref_lse, dout)),
        "fwd_library": cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=same)),
        "bwd_library": cuda_ms(lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), dout_t,
                                                           retain_graph=True)),
    }
    # least time for this run's inputs: pairs (i, j) of one segment only
    pairs = sum(n * n + (T - n) * (T - n) for n in lengths) * H
    esize = torch.finfo(dtype).bits // 8
    tensor_bytes = B * T * H * D * esize
    lse_bytes = B * H * T * 4
    work = {
        "fwd": (4 * D * pairs, 4 * tensor_bytes + lse_bytes + B * T * 4),
        "bwd": (10 * D * pairs, 8 * tensor_bytes + lse_bytes + B * T * 4),
    }
    bounds = {}
    for kind, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
        bounds[kind] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return t, bounds


class EngineRecorder:
    """Stands in for the engine that the driver builds: passes each call on
    with ``return_params=True`` and keeps the engine, the call's arguments
    and its output, so that the checks read the driver's own run."""

    def __init__(self):
        self.engine = None
        self.calls = []
        self.outputs = []

    def wrap(self, build_engine):
        def build(*args, **kwargs):
            self.engine = build_engine(*args, **kwargs)
            return self
        return build

    def __call__(self, params, spec, *args, **kwargs):
        out = self.engine(params, spec, *args, return_params=True, **kwargs)
        self.calls.append((params, spec))
        self.outputs.append(out)
        return out


def main_path(A):
    import pickle

    from dynamic_asr_eval_tpu_torch.evals import run

    os.environ["DAE_SYNTH_SPEC_FRAMES"] = str(N_FRAMES)
    cfg = flagship_config()
    recorder = EngineRecorder()
    build_engine = run.build_engine
    with tempfile.TemporaryDirectory() as tmp:
        args = run.parse_args([
            "-d", "synthetic_spec", "--quiet", "-s", os.path.join(tmp, "r.pkl"),
            "-seq", str(SEQ), "-o", str(OVERLAP), "-kwargs", "epochs=1", "online=true",
            "shuffle=false", "optim_lr=9e-5", "spec_augment_n_freq_masks=6",
            "spec_augment_freq_mask_param=34", "seed=0"])
        run.build_engine = recorder.wrap(build_engine)
        try:
            A.reset_counters()
            t0 = time.time()
            wer = run.main(args, model_config=cfg)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = (A.fwd_launches, A.bwd_launches)
        finally:
            run.build_engine = build_engine
        with open(os.path.join(tmp, "r_1.pkl"), "rb") as f:
            detail = pickle.load(f)
    return cfg, wer, wall, launches, detail, recorder


def check_outputs(cfg, recorder):
    """The driver's own run: stitched log-probs finite with the expected
    shape, weights that moved.  Then the full-depth model in f32 on a small
    input: kernel path against the plain attention path."""
    from dynamic_asr_eval_tpu_torch.models import SCConformer

    if len(recorder.outputs) != 1:
        raise AssertionError(f"the driver made {len(recorder.outputs)} engine calls, not 1")
    (out,), ((params, _),) = recorder.outputs, recorder.calls
    lp = out.numpy_logits()
    expect = (-(-N_FRAMES // cfg.subsampling_factor), cfg.n_classes)
    if lp.shape != expect:
        raise AssertionError(f"stitched log-probs {lp.shape} != {expect}")
    if not torch.isfinite(torch.from_numpy(lp)).all():
        raise AssertionError("non-finite stitched log-probs")
    moved = max((out.params[k].float() - params[k].float()).abs().max().item() for k in params)
    if not moved > 0:
        raise AssertionError("adaptation did not move the weights")
    log(f"  driver's engine run: stitched {lp.shape}, finite; max weight change {moved:.3e}")

    f32 = flagship_config(compute_dtype=torch.float32)
    plain = flagship_config(compute_dtype=torch.float32, attention_impl="xla")
    m_kernel = SCConformer(f32).cuda()
    m_kernel.load_state_dict({k: v.float() for k, v in params.items()})
    m_plain = SCConformer(plain).cuda()
    m_plain.load_state_dict(m_kernel.state_dict())
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(2, 80, 4000, generator=g, device="cuda")
    lengths = torch.tensor([4000, 3001], device="cuda")
    with torch.no_grad():
        a = m_kernel(x, lengths)
        b = m_plain(x, lengths)
    err = 0.0
    for i, n in enumerate(a["length"].tolist()):
        err = max(err, (a["final_posteriors"][i, :n] - b["final_posteriors"][i, :n]).abs().max().item())
    if not err <= 1e-3:
        raise AssertionError(f"kernel-path model vs plain path: |err| {err:.3e} > 1e-3")
    log(f"  full-depth f32 model, kernel vs plain attention on valid frames: {err:.2e}")


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def profile_engine(recorder, card):
    """Where the time of one recording goes: the driver's engine, warm, on
    the same recording and weights, timed TIMED_RUNS times, then once under
    torch.profiler.  Device busy time is the sum of kernel times (ranges
    that annotate kernels are left out); the idle share is ``1 - busy /
    wall`` against the fastest timed run."""
    from collections import defaultdict

    engine, ((params, spec),) = recorder.engine, recorder.calls

    def run_once():
        torch.cuda.synchronize()
        t0 = time.time()
        engine(params, spec, SEQ, OVERLAP, rng=0)
        torch.cuda.synchronize()
        return (time.time() - t0) * 1e3

    walls_ms = [run_once() for _ in range(TIMED_RUNS)]
    wall_ms = min(walls_ms)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run_once()
    by_kernel = defaultdict(float)
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if getattr(evt, "is_user_annotation", False) or "#" in evt.key:
            continue  # a range around kernels (Optimizer.step#...), not a kernel
        if dev_us and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.key] += dev_us / 1e3
    busy_ms = sum(by_kernel.values())
    result = {"card": card, "frames": N_FRAMES, "windows": N_WINDOWS,
              "engine_walls_ms": walls_ms, "ms_per_window": wall_ms / N_WINDOWS,
              "rtfx": N_FRAMES / 100.0 / (wall_ms / 1e3)}  # 10 ms hop
    if busy_ms <= 0:
        result.update(device_busy_ms="not measured", idle_share="not measured")
    else:
        fams = defaultdict(float)
        for k, ms in by_kernel.items():
            fams[family(k)] += ms
        result.update(
            device_busy_ms=busy_ms, idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
            families_ms=dict(sorted(fams.items(), key=lambda kv: -kv[1])),
            top_kernels_ms=[[k[:90], ms] for k, ms in
                            sorted(by_kernel.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]])
    for key, val in result.items():
        if key != "top_kernels_ms":
            log(f"  {key}: {val}")
    for name, ms in result.get("top_kernels_ms", []):
        log(f"  {ms:9.3f} ms  {name}")
    print(json.dumps({"profile": result}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                      "dynamic_asr_eval_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    from dynamic_asr_eval_tpu_torch.device import set_parity_precision
    from dynamic_asr_eval_tpu_torch.kernels import attention as A

    set_parity_precision()
    card = card_line()
    log(card)
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        "TF32 off for matmuls and cuDNN in every phase")

    t0 = time.time()
    A.build()
    A._load()
    log(f"[2] kernels built in {time.time() - t0:.2f} s (nvcc {A.build_seconds})")
    for line in A.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  {line.strip()}")

    log("[3] kernels against their plain versions")
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        errs[("flag", dtype)] = check_attention(A, 2, 2048, 6, 128, [2048, 1600], dtype)
        errs[("rag", dtype)] = check_attention(A, 3, 1000, 6, 128, [1000, 777, 1000], dtype)

    log("[4] timing at the flagship shape, bf16")
    times, bounds = time_attention(A, 2, 2048, 6, 128, [2048, 1600], torch.bfloat16)
    for k, v in times.items():
        log(f"  {k}: {v:.4f} ms")
    for k, (ms, by) in bounds.items():
        log(f"  bound {k}: {ms * 1e3:.2f} us ({by})")

    log("[5] main path: evals.run.main, NSTI on a 30720-frame recording, flagship, bf16")
    cfg, wer, wall, (fwd, bwd), detail, recorder = main_path(A)
    n_layers = cfg.n_layers
    if not (fwd >= n_layers * N_WINDOWS and bwd == n_layers * N_WINDOWS):
        raise AssertionError(f"launches fwd {fwd}, bwd {bwd}; expected >= "
                             f"{n_layers * N_WINDOWS} and == {n_layers * N_WINDOWS}")
    if len(detail["model_output"]) != 1 or not math.isfinite(wer):
        raise AssertionError(f"driver result malformed: wer {wer}, {detail.get('model_output')}")
    log(f"  WER {wer}; launches fwd {fwd}, bwd {bwd}; driver wall {wall:.3f} s "
        f"(record {detail['elapsed_times'][0]:.3f} s, first run: includes warm-up)")

    log("[6] output checks")
    check_outputs(cfg, recorder)

    log(f"[7] where the time goes: the driver's engine, warm, on {card}")
    profile_engine(recorder, card)

    src = "dynamic_asr_eval_tpu_torch/kernels/csrc/flash_attention.cu"
    kernels = []
    for kind, launches, err_keys in (("fwd", fwd, ("out",)), ("bwd", bwd, ("dq", "dk", "dv"))):
        e = errs[("flag", torch.bfloat16)]
        kernels.append({
            "name": f"flash_attention_{kind}",
            "route": "cuda",
            "source": src,
            "replaces": "dynamic_asr_eval_tpu/kernels/attention.py:56",
            "launches": launches,
            "max_abs_err": max(e[k] for k in err_keys),
            "ms": times[kind],
            "kernel_ms": times[kind],
            "plain_ms": times[f"{kind}_plain"],
            "bound_ms": bounds[kind][0],
            "bound_us": bounds[kind][0] * 1e3,
            "bound_by": bounds[kind][1],
            "library_ms": times[f"{kind}_library"],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
