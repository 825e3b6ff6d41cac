"""Drive the PyTorch port on one NVIDIA GPU and check it, phase by phase.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build the hand-written CUDA kernels from the checkout (five sources, one
   nvcc each, all started together, sm_90a) and print each kernel's
   registers and spills;
3. each kernel against its plain PyTorch version on the same inputs, TF32
   off, the plain version computed in f32.  Tolerance: |kernel - plain| <=
   1e-4 (f32) or 2e-2 (bf16) of max |plain|:
   - flash attention at the flagship [2, 2048, 6, 128] with lengths
     [2048, 1600] and ragged T 1000 with lengths [1000, 777, 1000], bf16
     (the tensor-core kernels) and f32 (the CUDA-core kernels), and in bf16
     with a random, non-prefix 0/1 mask at the flagship shape and at T 37
     (one key tile); every backward runs twice and must repeat bit for bit
     (no atomics), and each dtype must take its route; the bf16 kernels are
     also held against the plain version on the bf16 tensors, which rounds
     where the kernels round (``check_rounding``: 1 bf16 ulp of max, and at
     most 5 % of elements differing in dq, dk, dv, and in out at T 37);
   - fused subsampling, forward and backward (gx and all 10 weight
     gradients), at the flagship window [2, 16384, 80] with C 256 and ragged
     [3, 1001, 80], bf16 (the tensor-core kernels) and f32 (the CUDA-core
     kernels); the backward runs twice and must repeat bit for bit (no
     atomics), and each dtype must take its route; the bf16 kernels are also
     held against the plain version on the bf16 tensors
     (``check_subsample_rounding``: every output within 2 bf16 ulps of its
     max, at most 2 % of out's and 15 % of gx's elements differing);
   - soft-DTW R and E (f32, 1e-4 relative on R, 1e-4 of max |E| on E, each
     E from the same R) at the
     ``benchmark()`` defaults (4, 256, 256), at (2, 1500, 700) with bandwidth
     100 and at (1, 2048, 2048);
4. kernel, plain and library times (CUDA events after warm-up) at the
   flagship or benchmark shape, and the least time the card could take
   (bound).  Attention and subsampling are timed on both routes: bf16
   (tensor cores, the main path) and f32 (CUDA cores, the parity route).
   Library: SDPA with a boolean mask in the same dtype for attention; for
   the fused subsampling, the cuDNN stack the ``"conv"`` path runs (four
   ``F.conv2d`` calls with their activations, forward, and backward through
   autograd) in the same dtype; none for soft-DTW.  The port never calls a
   library yardstick.  Then one bf16 subsampling forward and one backward
   under torch.profiler, broken down by kernel (a
   ``{"subsample_breakdown": ...}`` line);
5. the main path: the port's NSTI driver (``evals/run.py`` ``main``) on one
   30720-frame ``synthetic_spec`` recording (9 windows of seq 16384 /
   overlap 14336, the last ragged at 14336 frames) at the flagship widths
   with ``attention_impl="pallas_flash"`` and ``subsampling_impl="conv"``,
   bf16, random weights from a seed; the launch counters are zeroed just
   before and read just after, and every attention launch must have taken
   the bf16 tensor-core route;
6. output checks on that run: the engine's stitched log-probs are finite
   with the expected shape and the weights moved; then, on a small input,
   the full-depth model in f32 through the attention kernel agrees with the
   plain attention path on valid frames (1e-3), and so do its weight
   gradients (1e-3 of each gradient's max |value|, or of 1 % of the largest
   where that is more): this run's launches of the f32 route are its
   ``parity_launches`` in the kernels line (its ``launches``, the main
   path's, are 0);
7. where the time goes: the driver's engine, warm, on the same recording:
   engine wall of 3 runs, ms per window and RTFx at the fastest, then one
   run under torch.profiler for device busy time, idle share, device time
   by kernel family and the top kernels (a ``{"profile": ...}`` line);
5b-7b. the same for ``subsampling_impl="pallas"`` (the fused subsampling
   kernels on the path; every subsampling launch must have taken the bf16
   route too); 6b also holds the full-depth f32 model through the f32
   subsampling kernels against the same model on the plain subsampling
   version (output and weight gradients) and against the ``"conv"`` model
   (output), on lengths [4000, 3000] (multiples of 8, where the two
   semantics agree), within 1e-3 on valid frames: this run's f32-route
   launches are ``fused_subsample_f32``'s ``parity_launches``;
8. soft-DTW's own path: ``benchmark(use_pallas=True)`` on the card, value
   and gradient of ``SoftDTW`` through both kernels, its launch counters
   zeroed just before and read just after.

Prints the card line, a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.  TF32 stays off throughout.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

FWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16 kernels against the plain version that rounds as they do (phase 3
# prints both numbers); a plain version that does not round fails the share
# (tests/test_torch_chip_smoke.py)
BF16_ULPS = 1.0
BF16_DIFF_SHARE = 0.05
# the bf16 subsampling kernels against the rounding plain version: bf16 ulps
# of max |plain| for every output, share of differing elements for out and gx
SUB_BF16_ULPS = 2.0
SUB_DIFF_SHARE = {"out": 0.02, "gx": 0.15}
ATTENTION_KEY_TILE = 64  # keys per tile of the bf16 forward kernel
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM dense
PEAK_BYTES = 3.35e12
F32_FLOPS = 67e12  # outside the tensor cores
N_FRAMES = 30720
SEQ, OVERLAP = 16384, 14336
N_WINDOWS = 9  # ops.chunk.chunk_starts_and_lengths(N_FRAMES, SEQ, OVERLAP)
TIMED_RUNS = 3
TOP_KERNELS = 15
SUB_FLAGSHIP = (2, 16384, 80, 256)  # B, T, F, C of one adapted window
SUB_RAGGED = (3, 1001, 80, 256)
SDTW_BENCH = (4, 256, 256)  # kernels.softdtw.benchmark defaults, D 64, gamma 1
SDTW_CASES = ((SDTW_BENCH, 0), ((2, 1500, 700), 100), ((1, 2048, 2048), 0))
FAMILIES = (
    ("flash_attention", ("tc_attention_", "fwd_kernel", "bwd_dkdv_kernel", "bwd_dq_kernel",
                         "bwd_delta_kernel")),
    ("fused_subsample", ("::tc_pw_kernel<", "::tc_wgrad_kernel(", "::weights_kernel(",
                         "::pw_kernel<", "::wgrad_kernel<", "::dw_bwd_kernel<", "::gx_kernel",
                         "namespace)::reduce_kernel(")),
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


def bound(flops, nbytes, peak_flops):
    """(least ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_close(what, pairs, tol):
    """pairs of (name, kernel output, plain output in f32) → {name: max |err|}."""
    errs = {}
    for name, a, b in pairs:
        err = (a.float() - b).abs().max().item()
        scale = b.abs().max().item()
        if not err <= tol * scale:
            raise AssertionError(f"{what} {name}: |err| {err:.3e} > {tol} x {scale:.3e}")
        errs[name] = err
    return errs


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def attention_inputs(B, T, H, D, lengths, dtype, seed=0):
    """q, k contiguous and v a strided view of one qkv tensor, as the model
    hands them to the kernel.  ``lengths`` None: a random 0/1 mask."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, T, 3, H, D, generator=g, device="cuda").to(dtype)
    q, k, v = qkv.unbind(2)
    if lengths is None:
        mask = torch.rand(B, T, generator=g, device="cuda") < 0.5
    else:
        mask = torch.arange(T, device="cuda")[None] < torch.tensor(lengths, device="cuda")[:, None]
    dout = torch.randn(B, T, H, D, generator=g, device="cuda").to(dtype)
    return q.contiguous(), k.contiguous(), v, mask, dout


def check_attention(A, B, T, H, D, lengths, dtype):
    q, k, v, mask, dout = attention_inputs(B, T, H, D, lengths, dtype)
    A.reset_counters()
    out, lse = A.flash_attention_fwd(q, k, v, mask)
    grads = A.flash_attention_bwd(q, k, v, mask, out, lse, dout)
    again = A.flash_attention_bwd(q, k, v, mask, out, lse, dout)
    route = A.ROUTES[dtype]
    if A.route_launches[route] != [1, 2]:
        raise AssertionError(f"attention {dtype}: launches by route {A.route_launches}, "
                             f"expected {route} only")
    ref_out, ref_lse = A.attention_reference(q.float(), k.float(), v.float(), mask)
    ref_grads = A.attention_reference_bwd(q.float(), k.float(), v.float(), mask,
                                          ref_out, ref_lse, dout.float())
    torch.cuda.synchronize()
    what = f"attention {dtype} T={T} lengths={lengths or 'random 0/1 mask'}"
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"{what}: the backward does not repeat bit for bit")
    errs = check_close(what, zip(("out", "dq", "dk", "dv"), (out,) + tuple(grads),
                                 (ref_out,) + tuple(ref_grads)), FWD_TOL[dtype])
    lse_err = (lse - ref_lse).abs().max().item()
    if not lse_err <= 1e-3:
        raise AssertionError(f"{what}: lse |err| {lse_err:.3e}")
    log(f"  {what} ({route}): " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f", lse {lse_err:.2e}; backward repeats bit for bit")
    if dtype == torch.bfloat16:
        check_rounding(A, what, T, q, k, v, mask, dout, out, lse, grads)
    return errs


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at |x|: 2^(floor(log2 |x|) - 7)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def check_rounding(A, what, T, q, k, v, mask, dout, out, lse, grads):
    """The bf16 kernels against the plain version on the same bf16 tensors,
    which rounds where JAX's Pallas kernel rounds (P before P·V and dV, dS
    before dQ and dK); the plain backward gets the kernel's own out and lse.
    Every output within BF16_ULPS bf16 ulps of its max |plain|; the share of
    elements that differ at all within BF16_DIFF_SHARE for dq, dk, dv, and for
    out where T fits one key tile (past one tile the kernel rounds P against
    each tile's running max, the plain version against the row's max)."""
    r_out, _ = A.attention_reference(q, k, v, mask)
    r_grads = A.attention_reference_bwd(q, k, v, mask, out, lse, dout)
    torch.cuda.synchronize()
    report = []
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out,) + tuple(grads),
                          (r_out,) + tuple(r_grads)):
        ulps = (a.float() - b.float()).abs().max().item() / bf16_ulp(b.float().abs().max().item())
        share = (a != b).float().mean().item()
        held = name != "out" or T <= ATTENTION_KEY_TILE
        if not (ulps <= BF16_ULPS and (share <= BF16_DIFF_SHARE or not held)):
            raise AssertionError(f"{what} against the rounding plain version: {name} "
                                 f"{ulps} ulps of max, {share:.4f} of elements differ")
        report.append(f"{name} {ulps} ulp, {share:.4f} differ" + ("" if held else " (not held)"))
    log(f"    against the plain version rounding as the kernel: {', '.join(report)}")


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
    bounds = {
        "fwd": bound(4 * D * pairs, 4 * tensor_bytes + lse_bytes + B * T * 4, PEAK_FLOPS[dtype]),
        "bwd": bound(10 * D * pairs, 8 * tensor_bytes + lse_bytes + B * T * 4, PEAK_FLOPS[dtype]),
    }
    return t, bounds


# ---------------------------------------------------------------------------
# fused subsampling
# ---------------------------------------------------------------------------


def subsample_inputs(S, B, T, F, C, dtype, seed=0):
    """x [B, T, F], the 10 f32 weights in the JAX layouts, g at the output."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, T, F, generator=g, device="cuda").to(dtype)
    shapes = {"k9": (9, C), "dw1": (9, C), "dw2": (9, C), "pw1": (C, C), "pw2": (C, C)}
    ws = []
    for name in S.WEIGHT_NAMES:
        scale = 1 / 3 if name in ("k9", "dw1", "dw2") else (C ** -0.5 if name.startswith("pw") else 0.1)
        ws.append(torch.randn(shapes.get(name, (C,)), generator=g, device="cuda") * scale)
    gout = torch.randn(B, S.ceil_chain(T)[2], F // 8, C, generator=g, device="cuda").to(dtype)
    return x, ws, gout


def check_subsample(S, shape, dtype):
    x, ws, gout = subsample_inputs(S, *shape, dtype)
    S.reset_counters()
    out = S.fused_subsample_fwd(x, ws)
    gx, gws = S.fused_subsample_bwd(x, ws, gout)
    gx2, gws2 = S.fused_subsample_bwd(x, ws, gout)
    route = S.ROUTES[dtype]
    if S.route_launches[route] != [1, 2]:
        raise AssertionError(f"fused subsampling {dtype}: launches by route {S.route_launches}, "
                             f"expected {route} only")
    ref = S.fused_subsample_reference(x.float(), *ws)
    ref_gx, ref_gws = S.fused_subsample_reference_bwd(x.float(), ws, gout.float(), "silu", True)
    torch.cuda.synchronize()
    what = f"fused subsampling {dtype} {shape}"
    if not (torch.equal(gx, gx2) and all(torch.equal(a, b) for a, b in zip(gws, gws2))):
        raise AssertionError(f"{what}: the backward does not repeat bit for bit")
    errs = check_close(what, zip(("out", "gx") + S.WEIGHT_NAMES, [out, gx] + gws,
                                 [ref, ref_gx] + ref_gws), FWD_TOL[dtype])
    log(f"  {what} ({route}): out {errs['out']:.2e}, gx {errs['gx']:.2e}, "
        f"weights {max(errs[n] for n in S.WEIGHT_NAMES):.2e}; backward repeats bit for bit")
    if dtype == torch.bfloat16:
        check_subsample_rounding(S, what, x, ws, gout, out, gx, gws)
    return errs


def check_subsample_rounding(S, what, x, ws, gout, out, gx, gws):
    """The bf16 kernels against the plain version on the same bf16 tensors,
    which rounds where the TPU kernel (and so the kernels) round.  Every
    output within SUB_BF16_ULPS bf16 ulps of its max |plain|; the share of
    elements that differ at all within SUB_DIFF_SHARE for out and gx (the
    weight gradients are f32 sums taken in another order, so all of their
    elements differ a little)."""
    r_out = S.fused_subsample_reference(x, *ws)
    r_gx, r_gws = S.fused_subsample_reference_bwd(x, ws, gout, "silu", True)
    torch.cuda.synchronize()
    report, worst = [], 0.0
    for name, a, b in zip(("out", "gx") + S.WEIGHT_NAMES, [out, gx] + gws, [r_out, r_gx] + r_gws):
        ulps = (a.float() - b.float()).abs().max().item() / bf16_ulp(b.float().abs().max().item())
        worst = max(worst, ulps)
        if name in ("out", "gx"):
            share = (a != b.to(a.dtype)).float().mean().item()
            if not share <= SUB_DIFF_SHARE[name]:
                raise AssertionError(f"{what} against the rounding plain version: {name} {share:.4f} "
                                     f"of elements differ")
            report.append(f"{name} {ulps:.2f} ulp, {share:.4f} differ")
        if not ulps <= SUB_BF16_ULPS:
            raise AssertionError(f"{what} against the rounding plain version: {name} {ulps} ulps "
                                 f"of max")
    log(f"    against the plain version rounding as the kernels: {', '.join(report)}, "
        f"weights <= {worst:.2f} ulp")


def conv_weights(S, ws, dtype):
    """The fused kernel's weights as the ``"conv"`` path's conv2d weights."""
    k9, b0, dw1, bdw1, pw1, bpw1, dw2, bdw2, pw2, bpw2 = ws
    C = k9.shape[1]
    out = [k9.t().reshape(C, 1, 3, 3), b0]
    for dw, bdw, pw, bpw in ((dw1, bdw1, pw1, bpw1), (dw2, bdw2, pw2, bpw2)):
        out += [dw.t().reshape(C, 1, 3, 3), bdw, pw.t()[:, :, None, None], bpw]
    return [w.to(dtype).detach().requires_grad_(True) for w in out]


def conv_stack(x, w):
    """The cuDNN stack of the ``"conv"`` path, without its masks: x [B, T, F]
    → [B, C, T/8, F/8]."""
    import torch.nn.functional as F

    C = w[0].shape[0]
    h = F.silu(F.conv2d(x[:, None], w[0], w[1], stride=2, padding=1))
    for i in (2, 6):
        h = F.conv2d(h, w[i], w[i + 1], stride=2, padding=1, groups=C)
        h = F.silu(F.conv2d(h, w[i + 2], w[i + 3]))
    return h


def subsample_work(B, T, F, C, dtype):
    """(flops, bytes) of the forward and of the backward on the main path
    (no gx): stage 0, both depthwise convs and both pointwise products; the
    backward recomputes the forward and adds the input and weight gradients
    of each."""
    from dynamic_asr_eval_tpu_torch.kernels.subsample import ceil_chain

    T0, T1, T2 = ceil_chain(T)
    M0, M1, M2 = B * T0 * F // 2, B * T1 * F // 4, B * T2 * F // 8
    stage0, dw, pw = 18 * M0 * C, 18 * (M1 + M2) * C, 2 * (M1 + M2) * C * C
    esize = torch.finfo(dtype).bits // 8
    weights = (32 * C + 2 * C * C) * 4
    x_bytes, out_bytes = B * T * F * esize, M2 * C * esize
    fwd = stage0 + dw + pw
    return {"fwd": (fwd, x_bytes + out_bytes + weights),
            "bwd": (fwd + 2 * pw + 2 * dw + stage0, x_bytes + out_bytes + 2 * weights)}


def time_subsample(S, dtype=torch.bfloat16):
    x, ws, gout = subsample_inputs(S, *SUB_FLAGSHIP, dtype, seed=1)
    lw = conv_weights(S, ws, dtype)
    lib_out = conv_stack(x, lw)
    g_nchw = gout.permute(0, 3, 1, 2).contiguous()
    t = {
        "fwd": cuda_ms(lambda: S.fused_subsample_fwd(x, ws)),
        "bwd": cuda_ms(lambda: S.fused_subsample_bwd(x, ws, gout, need_gx=False)),
        "fwd_plain": cuda_ms(lambda: S.fused_subsample_reference(x, *ws), iters=5),
        "bwd_plain": cuda_ms(lambda: S.fused_subsample_reference_bwd(x, ws, gout, "silu", False), iters=5),
        "fwd_library": cuda_ms(lambda: conv_stack(x, lw)),
        "bwd_library": cuda_ms(lambda: torch.autograd.grad(lib_out, lw, g_nchw, retain_graph=True)),
        "fwd_bwd_library": cuda_ms(lambda: torch.autograd.grad(conv_stack(x, lw), lw, g_nchw)),
    }
    bounds = {k: bound(f, b, PEAK_FLOPS[dtype])
              for k, (f, b) in subsample_work(*SUB_FLAGSHIP, dtype).items()}
    return t, bounds


def kernel_name(key: str) -> str:
    """A profiler key without ``void``, the namespace and the parameters."""
    name = key.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0]


def subsample_breakdown(S, card):
    """One forward and one backward call of the bf16 route at the flagship
    window (no gx, as on the main path) under torch.profiler: device ms and
    launches of each kernel inside them (a ``{"subsample_breakdown": ...}``
    line)."""
    x, ws, gout = subsample_inputs(S, *SUB_FLAGSHIP, torch.bfloat16, seed=1)
    result = {"card": card, "shape": SUB_FLAGSHIP}
    for kind, fn in (("fwd", lambda: S.fused_subsample_fwd(x, ws)),
                     ("bwd", lambda: S.fused_subsample_bwd(x, ws, gout, need_gx=False))):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = []
        for evt in prof.key_averages():
            dev_us = getattr(evt, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(evt, "self_cuda_time_total", 0.0)
            if dev_us and evt.device_type == torch.autograd.DeviceType.CUDA:
                rows.append([kernel_name(evt.key), evt.count, dev_us / 1e3])
        result[kind] = sorted(rows, key=lambda r: -r[2]) or "not measured"
    for kind in ("fwd", "bwd"):
        log(f"  fused subsampling bf16 {kind} by kernel: " + (
            ", ".join(f"{n} x{c} {ms:.4f} ms" for n, c, ms in result[kind])
            if isinstance(result[kind], list) else result[kind]))
    print(json.dumps({"subsample_breakdown": result}))


# ---------------------------------------------------------------------------
# soft-DTW
# ---------------------------------------------------------------------------


def softdtw_inputs(D, shape, bandwidth, seed=0):
    """Squared distances of standard-normal 64-dim features, band applied."""
    B, N, M = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, N, 64, generator=g, device="cuda")
    y = torch.randn(B, M, 64, generator=g, device="cuda")
    return D._apply_band(D.pairwise_sq_dist(x, y), bandwidth)


def check_softdtw(D, shape, bandwidth, gamma=1.0):
    Db = softdtw_inputs(D, shape, bandwidth)
    R = D.softdtw_R(Db, gamma)
    E = D.softdtw_E(Db, R, gamma)
    ref_R = D.forward_R_reference(Db, gamma)
    ref_E = D.backward_E_reference(Db, R, gamma)  # E's inputs: the same D and R
    torch.cuda.synchronize()
    r_err = ((R - ref_R).abs() / ref_R.abs().clamp_min(1.0)).max().item()
    e_err = (E - ref_E).abs().max().item()
    e_scale = ref_E.abs().max().item()
    if not (r_err <= 1e-4 and torch.isfinite(E).all() and e_err <= 1e-4 * e_scale):
        raise AssertionError(f"soft-DTW {shape} bandwidth {bandwidth}: R rel err {r_err:.3e}, "
                             f"E err {e_err:.3e} of max {e_scale:.3e}")
    log(f"  soft-DTW {shape} bandwidth {bandwidth}: R rel {r_err:.2e}, E {e_err:.2e} "
        f"(max |E| {e_scale:.3e}, loss {R[0, shape[1], shape[2]].item():.6g})")
    return {"R": r_err * max(1.0, ref_R.abs().max().item()), "E": e_err}


def softdtw_work(B, N, M):
    """(ops, bytes): ~15 f32 operations a cell forward (3 divisions, 3 exp,
    a log, max, adds), ~17 backward; D read and R written once forward; D
    and R read and E written once backward."""
    cells, padded = B * N * M, B * (N + 2) * (M + 2)
    return {"fwd": (15 * cells, 4 * (cells + padded)),
            "bwd": (17 * cells, 4 * (2 * cells + padded))}


def time_softdtw(D, gamma=1.0):
    Db = softdtw_inputs(D, SDTW_BENCH, 0, seed=1)
    R = D.softdtw_R(Db, gamma)
    t = {
        "fwd": cuda_ms(lambda: D.softdtw_R(Db, gamma)),
        "bwd": cuda_ms(lambda: D.softdtw_E(Db, R, gamma)),
        "fwd_plain": cuda_ms(lambda: D.forward_R_reference(Db, gamma), iters=3, warmup=1),
        "bwd_plain": cuda_ms(lambda: D.backward_E_reference(Db, R, gamma), iters=3, warmup=1),
    }
    bounds = {k: bound(f, b, F32_FLOPS) for k, (f, b) in softdtw_work(*SDTW_BENCH).items()}
    return t, bounds


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


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


def main_path(cfg, kernel_modules):
    """The driver on the flagship recording; returns (wer, wall, {module:
    (fwd, bwd) launches}, {module: {route: (fwd, bwd)}}, result detail,
    recorder)."""
    import pickle

    from dynamic_asr_eval_tpu_torch.evals import run

    os.environ["DAE_SYNTH_SPEC_FRAMES"] = str(N_FRAMES)
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
            for mod in kernel_modules.values():
                mod.reset_counters()
            t0 = time.time()
            wer = run.main(args, model_config=cfg)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = {k: (m.fwd_launches, m.bwd_launches) for k, m in kernel_modules.items()}
            routes = {k: {r: tuple(c) for r, c in m.route_launches.items()}
                      for k, m in kernel_modules.items()}
        finally:
            run.build_engine = build_engine
        with open(os.path.join(tmp, "r_1.pkl"), "rb") as f:
            detail = pickle.load(f)
    return wer, wall, launches, routes, detail, recorder


def check_launches(launches, expect):
    """expect: {module: per-window (fwd, bwd)}; forward >= and backward ==
    that count times the windows."""
    for name, (fwd_per, bwd_per) in expect.items():
        fwd, bwd = launches[name]
        if not (fwd >= fwd_per * N_WINDOWS and bwd == bwd_per * N_WINDOWS):
            raise AssertionError(f"{name} launches fwd {fwd}, bwd {bwd}; expected >= "
                                 f"{fwd_per * N_WINDOWS} and == {bwd_per * N_WINDOWS}")


def check_driver_output(cfg, wer, detail, recorder):
    """The driver's own run: stitched log-probs finite with the expected
    shape, weights that moved."""
    if len(detail["model_output"]) != 1 or not math.isfinite(wer):
        raise AssertionError(f"driver result malformed: wer {wer}, {detail.get('model_output')}")
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
    return params


def valid_frame_err(a, b):
    err = 0.0
    for i, n in enumerate(a["length"].tolist()):
        err = max(err, (a["final_posteriors"][i, :n] - b["final_posteriors"][i, :n]).abs().max().item())
    return err


def f32_model(params, **overrides):
    from dynamic_asr_eval_tpu_torch.models import SCConformer

    model = SCConformer(flagship_config(compute_dtype=torch.float32, **overrides)).cuda()
    model.load_state_dict({k: v.float() for k, v in params.items()})
    return model


def model_run(model, x, lengths):
    """The model's output and the weight gradients of its valid frames'
    summed log-probs."""
    out = model(x, lengths)
    logp = out["final_posteriors"]
    valid = torch.arange(logp.shape[1], device="cuda")[None] < out["length"][:, None]
    loss = (logp * valid[..., None]).sum()
    names, weights = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, weights, allow_unused=True)
    return out, {n: g for n, g in zip(names, grads) if g is not None}


def grad_err(grads_a, grads_b):
    """Largest difference of two gradient sets, each weight against its own
    max |value| (or 1 % of the largest where that is more)."""
    top = {n: g.abs().max().item() for n, g in grads_b.items()}
    floor = 1e-2 * max(top.values())  # a weight whose gradient is ~0 on both paths
    return max((grads_a[n] - grads_b[n]).abs().max().item() / max(top[n], floor) for n in grads_b)


def check_attention_model(params, A):
    """The full-depth model in f32 on a small input: kernel path against the
    plain attention path, output on valid frames and weight gradients of the
    valid frames' summed log-probs.  Returns the f32 route's (fwd, bwd)
    launches in the kernel-path run (its parity launches)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(2, 80, 4000, generator=g, device="cuda")
    lengths = torch.tensor([4000, 3001], device="cuda")
    A.reset_counters()
    a, grads_a = model_run(f32_model(params), x, lengths)
    torch.cuda.synchronize()
    launches = tuple(A.route_launches["cuda_core"])
    b, grads_b = model_run(f32_model(params, attention_impl="xla"), x, lengths)
    err = valid_frame_err(a, b)
    gerr = grad_err(grads_a, grads_b)
    if not (err <= 1e-3 and gerr <= 1e-3 and launches[0] > 0 and launches[1] > 0):
        raise AssertionError(f"kernel-path model vs plain path: output |err| {err:.3e}, weight "
                             f"gradients {gerr:.3e} of max (> 1e-3?), f32 launches {launches}")
    log(f"  full-depth f32 model, kernel vs plain attention on valid frames: {err:.2e}; weight "
        f"gradients {gerr:.2e} of max; f32 (cuda_core) launches fwd {launches[0]}, "
        f"bwd {launches[1]}")
    return launches


def check_subsample_model(params, S):
    """The full-depth f32 model with ``"pallas"`` subsampling: through the
    kernels (the f32 route), against the same model on the plain subsampling
    version (output on valid frames and weight gradients of the valid frames'
    summed log-probs) and against the ``"conv"`` model (output), at lengths
    that are multiples of 8.  Returns the f32 route's (fwd, bwd) launches
    (its parity launches)."""
    import dynamic_asr_eval_tpu_torch.models.conformer as conformer

    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(2, 80, 4000, generator=g, device="cuda")
    lengths = torch.tensor([4000, 3000], device="cuda")
    model = f32_model(params, subsampling_impl="pallas")
    S.reset_counters()
    a, grads_a = model_run(model, x, lengths)
    torch.cuda.synchronize()
    launches = tuple(S.route_launches["cuda_core"])
    kernel_entry = conformer.fused_subsample
    conformer.fused_subsample = S.fused_subsample_reference
    try:
        b, grads_b = model_run(model, x, lengths)
    finally:
        conformer.fused_subsample = kernel_entry
    with torch.no_grad():
        c = f32_model(params)(x, lengths)
    err_plain, err_conv = valid_frame_err(a, b), valid_frame_err(a, c)
    gerr = grad_err(grads_a, grads_b)
    if not (err_plain <= 1e-3 and err_conv <= 1e-3 and gerr <= 1e-3 and launches == (1, 1)):
        raise AssertionError(f"pallas model: vs plain subsampling {err_plain:.3e} (weight gradients "
                             f"{gerr:.3e} of max), vs conv model {err_conv:.3e} (> 1e-3?); f32 "
                             f"launches {launches}")
    log(f"  full-depth f32 model, subsampling kernels vs plain version {err_plain:.2e} (weight "
        f"gradients {gerr:.2e} of max), vs the conv model {err_conv:.2e} on valid frames; f32 "
        f"(cuda_core) launches fwd {launches[0]}, bwd {launches[1]}")
    return launches


def ptxas_report(build_log: str):
    """(mangled kernel name, registers, spill-store bytes) for each entry in
    nvcc's ``-Xptxas -v`` output."""
    rows, name, spills = [], None, 0
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name, spills = line.split("'")[1], 0
        elif "spill stores" in line and name is not None:
            spills = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif "registers" in line and name is not None:
            rows.append((name, int(re.search(r"Used (\d+) registers", line).group(1)), spills))
            name = None
    return rows


def demangle(names):
    """The kernels' names without their parameters, by ``cu++filt -p`` (it
    ships beside nvcc)."""
    from dynamic_asr_eval_tpu_torch.kernels._build import nvcc

    tool = os.path.join(os.path.dirname(nvcc()), "cu++filt")
    out = subprocess.run([tool, "-p"], input="\n".join(names), capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.splitlines()


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def profile_engine(recorder, card, path):
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
    result = {"path": path, "card": card, "frames": N_FRAMES, "windows": N_WINDOWS,
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


def drive(label, cfg, kernel_modules, expect, card, check_model):
    log(f"[5{label}] main path: evals.run.main, NSTI on a {N_FRAMES}-frame recording, flagship, "
        f"bf16, subsampling_impl={cfg.subsampling_impl!r}")
    wer, wall, launches, routes, detail, recorder = main_path(cfg, kernel_modules)
    check_launches(launches, expect)
    for name, by_route in routes.items():
        if by_route != {"tensor_core": launches[name], "cuda_core": (0, 0)}:
            raise AssertionError(f"{name} launches by route {by_route}: not all on the bf16 "
                                 f"tensor-core kernels")
    log(f"  WER {wer}; launches {launches}; by route {routes}; evals.run wall {wall:.3f} s "
        f"(record {detail['elapsed_times'][0]:.3f} s, first run: includes warm-up)")
    log(f"[6{label}] output checks")
    params = check_driver_output(cfg, wer, detail, recorder)
    model_launches = check_model(params)
    log(f"[7{label}] where the time goes: the driver's engine, warm, on {card}")
    profile_engine(recorder, card, f"subsampling_{cfg.subsampling_impl}")
    return launches, routes, model_launches


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
    from dynamic_asr_eval_tpu_torch.kernels import softdtw as D
    from dynamic_asr_eval_tpu_torch.kernels import subsample as S

    set_parity_precision()
    card = card_line()
    log(card)
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        "TF32 off for matmuls and cuDNN in every phase")

    t0 = time.time()
    libraries = list(A.LIBRARIES.values()) + list(S.LIBRARIES.values()) + [D.LIBRARY]
    with ThreadPoolExecutor(len(libraries)) as pool:
        for fut in [pool.submit(lib.load) for lib in libraries]:
            fut.result()
    log(f"[2] kernels built in {time.time() - t0:.2f} s")
    for lib in libraries:
        log(f"  {lib.source.name}: nvcc {lib.build_seconds} s")
        rows = ptxas_report(lib.build_log)
        for name, (_, regs, spills) in zip(demangle([r[0] for r in rows]), rows):
            log(f"    {name}: {regs} registers, {spills} bytes spill stores")

    log("[3] kernels against their plain versions")
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        errs[("attn", dtype)] = check_attention(A, 2, 2048, 6, 128, [2048, 1600], dtype)
        check_attention(A, 3, 1000, 6, 128, [1000, 777, 1000], dtype)
    check_attention(A, 2, 2048, 6, 128, None, torch.bfloat16)
    check_attention(A, 2, 37, 6, 128, [37, 20], torch.bfloat16)
    for dtype in (torch.bfloat16, torch.float32):
        errs[("sub", dtype)] = check_subsample(S, SUB_FLAGSHIP, dtype)
        check_subsample(S, SUB_RAGGED, dtype)
    for shape, bandwidth in SDTW_CASES:
        e = check_softdtw(D, shape, bandwidth)
        if shape == SDTW_BENCH:
            errs["sdtw"] = e

    log("[4] timing at the flagship (attention and subsampling: bf16 and f32) and "
        "benchmark (soft-DTW: f32) shapes")
    times = {}
    for name, (t, bnd) in (
            ("flash_attention", time_attention(A, 2, 2048, 6, 128, [2048, 1600], torch.bfloat16)),
            ("flash_attention_f32",
             time_attention(A, 2, 2048, 6, 128, [2048, 1600], torch.float32)),
            ("fused_subsample", time_subsample(S)),
            ("fused_subsample_f32", time_subsample(S, torch.float32)),
            ("softdtw", time_softdtw(D))):
        times[name] = (t, bnd)
        for k, v in t.items():
            log(f"  {name} {k}: {v:.4f} ms")
        for k, (ms, by) in bnd.items():
            log(f"  {name} bound {k}: {ms * 1e3:.2f} us ({by})")
    subsample_breakdown(S, card)

    attn_per_window = (flagship_config().n_layers, flagship_config().n_layers)
    _, routes, parity_launches = drive("", flagship_config(), {"attention": A},
                                       {"attention": attn_per_window}, card,
                                       lambda params: check_attention_model(params, A))
    _, pallas_routes, sub_parity_launches = drive("b", flagship_config(subsampling_impl="pallas"),
                                  {"attention": A, "subsample": S},
                                  {"attention": attn_per_window, "subsample": (1, 1)}, card,
                                  lambda params: check_subsample_model(params, S))

    log("[8] soft-DTW's own path: kernels.softdtw.benchmark(use_pallas=True)")
    D.reset_counters()
    bench = D.benchmark(use_pallas=True)
    sdtw_launches = (D.fwd_launches, D.bwd_launches)
    if not (sdtw_launches[0] > 0 and sdtw_launches[1] > 0 and math.isfinite(bench["loss"])):
        raise AssertionError(f"soft-DTW benchmark: {bench}, launches {sdtw_launches}")
    plain = D.benchmark(use_pallas=False)
    if not math.isclose(bench["loss"], plain["loss"], rel_tol=1e-4):
        raise AssertionError(f"soft-DTW benchmark loss {bench['loss']} != plain {plain['loss']}")
    log(f"  kernels: {bench['seconds_per_iter'] * 1e3:.3f} ms per iteration, loss {bench['loss']:.6g}, "
        f"launches fwd {sdtw_launches[0]}, bwd {sdtw_launches[1]}; plain version "
        f"{plain['seconds_per_iter'] * 1e3:.3f} ms per iteration")

    sources = {"flash_attention": "flash_attention_bf16.cu",
               "flash_attention_f32": "flash_attention.cu",
               "fused_subsample": "fused_subsample_bf16.cu",
               "fused_subsample_f32": "fused_subsample.cu", "softdtw": "softdtw.cu"}
    replaces = {
        ("flash_attention", "fwd"): "dynamic_asr_eval_tpu/kernels/attention.py:56",
        ("flash_attention", "bwd"): "dynamic_asr_eval_tpu/kernels/attention.py:56",
        ("flash_attention_f32", "fwd"): "dynamic_asr_eval_tpu/kernels/attention.py:56",
        ("flash_attention_f32", "bwd"): "dynamic_asr_eval_tpu/kernels/attention.py:56",
        ("fused_subsample", "fwd"): "dynamic_asr_eval_tpu/kernels/subsample.py:278",
        ("fused_subsample", "bwd"): "dynamic_asr_eval_tpu/kernels/subsample.py:438",
        ("fused_subsample_f32", "fwd"): "dynamic_asr_eval_tpu/kernels/subsample.py:278",
        ("fused_subsample_f32", "bwd"): "dynamic_asr_eval_tpu/kernels/subsample.py:438",
        ("softdtw", "fwd"): "dynamic_asr_eval_tpu/kernels/softdtw.py:129",
        ("softdtw", "bwd"): "dynamic_asr_eval_tpu/kernels/softdtw.py:92",
    }
    # launches on the main path (by route: attention in the "conv" run,
    # subsampling in the "pallas" run; soft-DTW: its own path); the f32 routes
    # are the parity routes and run 0 times there, their counts in the f32
    # model runs of phases 6 and 6b go under "parity_launches"
    launches = {"flash_attention": routes["attention"]["tensor_core"],
                "flash_attention_f32": routes["attention"]["cuda_core"],
                "fused_subsample": pallas_routes["subsample"]["tensor_core"],
                "fused_subsample_f32": pallas_routes["subsample"]["cuda_core"],
                "softdtw": sdtw_launches}
    parity = {"flash_attention_f32": parity_launches, "fused_subsample_f32": sub_parity_launches}
    err_keys = {
        ("flash_attention", "fwd"): (errs[("attn", torch.bfloat16)], ("out",)),
        ("flash_attention", "bwd"): (errs[("attn", torch.bfloat16)], ("dq", "dk", "dv")),
        ("flash_attention_f32", "fwd"): (errs[("attn", torch.float32)], ("out",)),
        ("flash_attention_f32", "bwd"): (errs[("attn", torch.float32)], ("dq", "dk", "dv")),
        ("fused_subsample", "fwd"): (errs[("sub", torch.bfloat16)], ("out",)),
        ("fused_subsample", "bwd"): (errs[("sub", torch.bfloat16)], ("gx",) + S.WEIGHT_NAMES),
        ("fused_subsample_f32", "fwd"): (errs[("sub", torch.float32)], ("out",)),
        ("fused_subsample_f32", "bwd"): (errs[("sub", torch.float32)], ("gx",) + S.WEIGHT_NAMES),
        ("softdtw", "fwd"): (errs["sdtw"], ("R",)),
        ("softdtw", "bwd"): (errs["sdtw"], ("E",)),
    }
    kernels = []
    for name in ("flash_attention", "flash_attention_f32", "fused_subsample", "fused_subsample_f32",
                 "softdtw"):
        t, bnd = times[name]
        for i, kind in enumerate(("fwd", "bwd")):
            e, keys = err_keys[(name, kind)]
            extra = {"parity_launches": parity[name][i]} if name in parity else {}
            kernels.append({
                "name": f"{name}_{kind}",
                "route": "cuda",
                "source": f"dynamic_asr_eval_tpu_torch/kernels/csrc/{sources[name]}",
                "replaces": replaces[(name, kind)],
                "launches": launches[name][i],
                "max_abs_err": max(e[k] for k in keys),
                "ms": t[kind],
                "kernel_ms": t[kind],
                "plain_ms": t[f"{kind}_plain"],
                "bound_ms": bnd[kind][0],
                "bound_us": bnd[kind][0] * 1e3,
                "bound_by": bnd[kind][1],
                "library_ms": t.get(f"{kind}_library"),
                **extra,
            })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
