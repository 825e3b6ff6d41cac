"""Drive the PyTorch port on one NVIDIA GPU and check it, phase by phase.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build the hand-written CUDA kernels from the checkout (five sources, one
   nvcc each, all started together, sm_90a) and print each kernel's
   registers and spills (the f32 attention's ``tf32x3_attention_*`` and
   the f32 subsampling's ``tc_pw_kernel`` / ``tc_wgrad_kernel`` among them);
3. each kernel against its plain PyTorch version on the same inputs, TF32
   off, the plain version computed in f32.  Tolerance: |kernel - plain| <=
   1e-4 (f32) or 2e-2 (bf16) of max |plain|:
   - flash attention at the flagship [2, 2048, 6, 128] with lengths
     [2048, 1600] and ragged T 1000 with lengths [1000, 777, 1000], bf16
     (the tensor-core kernels) and f32 (the ``"tf32x3"`` route: tensor-core
     kernels taking each product as three TF32 products), f32 also at head
     dim 30 (zero-padded by the wrapper), and in bf16 with a random,
     non-prefix 0/1 mask at the flagship shape and at T 37 (one key tile);
     every backward runs twice and must repeat bit for bit (no atomics), and
     each dtype must take its route; the bf16 kernels are
     also held against the plain version on the bf16 tensors, which rounds
     where the kernels round (``check_rounding``: 1 bf16 ulp of max, and at
     most 5 % of elements differing in dq, dk, dv, and in out at T 37);
   - fused subsampling, forward and backward (gx and all 10 weight
     gradients), at the flagship window [2, 16384, 80] with C 256 and ragged
     [3, 1001, 80], bf16 (the tensor-core kernels) and f32 (the ``"tf32x3"``
     route: each pointwise product as three TF32 products on the tensor
     cores); the backward runs twice and must repeat bit for bit (no
     atomics), and each dtype must take its route; the bf16 kernels are also
     held against the plain version on the bf16 tensors
     (``check_subsample_rounding``: every output within 2 bf16 ulps of its
     max, at most 2 % of out's and 15 % of gx's elements differing);
   - both bf16 kernels at AWMC's batch-1 shapes, with the same checks:
     attention [1, 2048, 6, 128] with length 2048 and 1792 (the ragged last
     window), subsampling [1, 16384, 80];
   - both bf16 kernels at the protocol drivers' evaluation-engine batch of
     4 windows (phases 16-16c), with the same checks: attention [4, 2048,
     6, 128] with lengths [2048, 2048, 2048, 1792] (a recording's last
     window) and [2048, 2048, 2048, 1100], subsampling [4, 16384, 80];
   - soft-DTW R and E (f32, 1e-4 relative on R, 1e-4 of max |E| on E, each
     E from the same R) at the
     ``benchmark()`` defaults (4, 256, 256), at (2, 1500, 700) with bandwidth
     100, at the utterance engine's shapes (1, 64, 64) and (1, 512, 512) and
     at (1, 2048, 2048); each kernel runs twice and must repeat bit for bit;
4. kernel, plain and library times (CUDA events after warm-up) at the
   flagship or benchmark shape, and the least time the card could take
   (bound).  Attention and subsampling are timed on both routes: bf16
   (tensor cores, the main path) and f32 (the parity route: 3xTF32 on the
   tensor cores, bounded by three TF32 products at 495 TFLOP/s, for the
   subsampling its pointwise products only and the rest at 67 TFLOP/s, and,
   as ``bound_cuda_core_ms``, by the same work all at 67 TFLOP/s on the CUDA
   cores).
   Library: SDPA with a boolean mask in the same dtype for attention (the
   kernels SDPA runs in f32 named from a profile); for
   the fused subsampling, the cuDNN stack the ``"conv"`` path runs (four
   ``F.conv2d`` calls with their activations, forward, and backward through
   autograd) in the same dtype; none for soft-DTW.  Soft-DTW is also timed
   at (1, 64, 64), (1, 512, 512) and (1, 2048, 2048), and its chain floor
   printed: (N + M - 1) steps at the latency of one step's dependent chain,
   the kernels' own step run alone by one warp and timed in SM cycles at the
   clock it ran at, beside the kernels' own time a step on a single strip of
   32 rows (one warp, 4096 columns), which is not a bound (a
   ``{"softdtw_chain": ...}`` line).
   The port never calls a
   library yardstick.  Then one subsampling forward and one backward of
   each route (bf16 and f32) under torch.profiler, broken down by kernel (a
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
   where that is more), cuDNN deterministic on both sides: this run's
   launches of the f32 route (``"tf32x3"``) are its ``parity_launches`` in
   the kernels line (its ``launches``, the main path's, are 0);
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
5c. the f32 path: ``evals/run.py`` ``main`` on phase 5's recording at the
   flagship widths in f32 with ``attention_impl="pallas_flash"`` and
   ``"conv"`` subsampling (so the f32 attention kernels, route
   ``"tf32x3"``, are the only kernels on the path), again with ``"xla"``
   attention, and a third time with ``"pallas_flash"`` and ``"pallas"``
   subsampling (the f32 subsampling kernels, route ``"tf32x3"``, too),
   cuDNN deterministic in all three: attention launches exactly 6 / 6 per
   window and subsampling launches exactly 1 / 1 per window, all on that
   route (``f32_path_launches`` in the kernels line); stitched log-probs of
   the other runs within 1e-3 of max |log-prob| of the first, equal greedy
   ids (the windows are multiples of 8, where the two subsampling semantics
   agree); each engine's warm walls (cuDNN's own algorithms), ms per window
   and RTFx (a ``{"f32_path": ...}`` line);
8. soft-DTW's own path: ``benchmark(use_pallas=True)`` on the card, value
   and gradient of ``SoftDTW`` through both kernels, its launch counters
   zeroed just before and read just after;
9. checkpoints at flagship width: the seed-0 flagship weights (bf16,
   ``"pallas_flash"``, ``"pallas"``) saved as a DAE1 file and reloaded by
   ``load_any_checkpoint`` (state dict bit for bit, config field for
   field); the same weights as a reference ``{"model", "config"}`` torch
   pickle, reloaded (the same tensors; its config names no kernel);
10. the AWMC main path: ``evals/run_dynamic_eval_full.py`` ``main`` with
   ``--awmc --checkpoint`` the DAE1 file, on phase 5's recording (online, 1
   epoch, lr 9e-5); the launch counters are zeroed just before and read just
   after: every attention and subsampling launch on the bf16 route, and per
   adapted window exactly 24 attention forwards and 6 backwards, 4
   subsampling forwards and 1 backward (anchor, leader, student, clean);
   the run's stitched log-probs finite with the expected shape, the
   student's weights moved, its WER a number.  10b (parity): the full-depth
   f32 AWMC engine on a 2-window recording (3000 frames at seq 2048 /
   overlap 1024: 2048 and 1976 frames, multiples of 8) through the f32
   kernels (attention and subsampling ``"tf32x3"``), against
   the same engine with ``"xla"`` attention and ``"conv"`` subsampling,
   cuDNN deterministic on both sides: stitched log-probs within 1e-3 of max
   |log-prob|, equal greedy ids; its f32-route launches are
   ``awmc_parity_launches``;
11. where AWMC's time goes: phase 7's profile of the driver's warm AWMC
   engine (a ``{"profile": ...}`` line with ``"path": "awmc"``);
12. the native host libraries: ``native/levenshtein.cc`` and
   ``native/arpa_reader.cc`` built with ``g++`` (build seconds printed; a
   failed build, zlib's header missing included, fails the phase), and the
   native WER against the pure-Python DP on one 10k-word pair: equal counts,
   both timed;
13. the ``-lm`` path: ``evals/run.py`` ``main`` on phase 5b's recording and
   configuration with ``--tokenizer`` a 4095-piece vocabulary and ``-lm`` a
   token-level 4-gram ARPA file over it (both written from a seed: every
   unigram, ~2e5 / 5e5 / 5e5 higher-order n-grams, each extending a
   lower-order one), ``--beams 20`` and ``lm_tta_beams=3``: LM-fused
   pseudo-labels in every window and the final beam decode on the card.  The
   launch counters are zeroed just before and read just after: 6 / 6
   attention and 1 / 1 subsampling launches per window, all on the bf16
   route.  Checks: the n-gram tables on ``cuda``, read by the native reader;
   the transcript non-empty; the beam on the card gives the CPU's tokens on
   the first 512 collapsed frames of the record's stitched output (same
   function, same tables).  Prints ARPA load seconds and table bytes, the
   frames the collapse kept, the pseudo-label beam's ms per window, the
   final decode's seconds, the record's wall and the adaptation's ms per
   window beside phase 5b's (a ``{"lm_path": ...}`` line);
14. the transformer-LM ``-lm`` path: a seeded LM at the published lming
   shape (6 x 512, 8 heads, expansion 4, cache 128) over phase 13's
   vocabulary, written as a DLM1 file and as a lming torch pickle, both read
   back bit for bit; ``evals/run.py`` ``main -lm <DLM1> --beams 20 -kwargs
   lm_tta_beams=3`` on a 3-window recording (18432 frames: the recording is
   cut, not the widths), flagship, ``"pallas"`` subsampling.  Launches
   exactly 6 / 6 attention and 1 / 1 subsampling per window, all bf16; the
   LM on ``cuda`` in f32 (the drivers pass no compute dtype); a non-empty
   transcript; the card's beam equal to the CPU's (the pickle's LM) on the
   first 512 collapsed frames, scores within 1e-4 relative.  A ``{"tlm_path":
   ...}`` line: load seconds, LM parameters and cache bytes, pseudo-label
   beam ms per window and per frame, final decode ms per kept frame, record
   wall;
15. the consistency path: ``evals/run_dynamic_eval_full.py`` ``main
   --consistency --checkpoint`` phase 9's DAE1 file, offline, 1 epoch, on
   phase 5's recording: per chunk exactly 12 attention forwards and 6
   backwards, 2 subsampling forwards and 1 backward (the adaptation's batch
   and the re-inference), all bf16; every chunk's weights moved, finite
   WER, peak device memory printed.  15b: its profile (a ``{"profile":
   ...}`` line with ``"path": "consistency"``).  15c (parity): a 2-layer f32
   consistency engine at flagship widths, offline, 2 epochs, on phase 10b's
   2-window recording, through the f32 kernels (both ``"tf32x3"``)
   against the plain path, cuDNN deterministic on both sides (stitched
   log-probs within 1e-3 of max |log-prob|, equal greedy ids); its f32-route
   launches are ``consistency_parity_launches``;
16. the protocol drivers at the flagship widths, bf16, ``"pallas"``
   subsampling, with the launch scripts' settings (offline, shuffled
   windows, 1 epoch, lr 9e-5, 6 frequency masks of width < 34, no time
   masks), each driven twice through its ``main`` (first and warm), the
   launch counters zeroed just before each run and read just after: per
   run exactly one attention launch per layer and one subsampling launch
   per forward (a window's [augmented, clean] batch, or ``infer_batch``
   windows of the evaluation engine) and per backward, as the plans
   (``half_concat_plan``, ``loo_plan``, ``seq_plan``) derive them from the
   engine's code, all bf16, none of soft-DTW.  16: ``run_half_concat_eval``
   ``-ao 14336`` on four 30720-frame recordings: each fold adapt-only on a
   61440-frame concatenation (24 windows; no stitched log-probs, weights
   moved from the pristine ones, which stay bit for bit), then 2 records of
   9 windows evaluated with that fold's weights; the baseline evaluates all
   4; a pickle with 2 folds and a baseline, finite WERs.  16b:
   ``run_within_recording_loo_eval`` on one 131072-frame recording at
   ``--loo_seq_len 65536 --loo_overlap 57344``: 10 chunks, 4 adaptations
   (chunks 0, 1, 8, 9) and 6 windowed inferences; ``loo_eval`` took the
   ``"loo"`` mode, its stitch covers every downsampled frame, finite.  16c:
   ``run_seq_eval`` on one 49152-frame recording at ``--nsti_seq_len 32768
   --nsti_overlap 28672``: 6 outer chunks (the stop rule adds a sixth of
   28672 frames) of 10, 10, 10, 10, 10 and 8 windows; the second-level
   stitch has the recording's downsampled length, finite.  Each prints a
   ``{"protocols": ...}`` line: plan, windows adapted and evaluated, walls
   (first, warm), engine seconds, the adapting engine's re-inference
   seconds (timed apart), ms per adapted window (adaptation alone: the
   adapting engine's seconds less its re-inference), launches, card.

Prints the card line, a ``{"kernels": [...]}`` line (each kernel's
``launches`` on the NSTI path, ``awmc_launches`` on the AWMC path,
``lm_launches`` on the ``-lm`` path, ``tlm_launches`` on the transformer-LM
path, ``consistency_launches`` on the consistency path and
``protocol_launches`` over the first runs of phases 16-16c, each read from
its own runs; ``f32_path_launches`` for the f32 attention and subsampling,
from phase 5c), and last
``{"ok": true, "device": {...}}``.  TF32 stays off throughout for PyTorch's
matmuls and convolutions; cuDNN's deterministic algorithms are on only
inside the parity comparisons (phases 6, 6b, 5c, 10b, 15c), so the timed
phases keep cuDNN's own choice.
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
TF32_FLOPS = 495e12  # dense, on the tensor cores: the f32 attention's three products each
ODD_HEAD_DIM = 30  # phase 3's f32 attention at a head dim the wrapper pads
N_FRAMES = 30720
SEQ, OVERLAP = 16384, 14336
N_WINDOWS = 9  # ops.chunk.chunk_starts_and_lengths(N_FRAMES, SEQ, OVERLAP)
TIMED_RUNS = 3
TOP_KERNELS = 15
SUB_FLAGSHIP = (2, 16384, 80, 256)  # B, T, F, C of one adapted window
SUB_RAGGED = (3, 1001, 80, 256)
SDTW_BENCH = (4, 256, 256)  # kernels.softdtw.benchmark defaults, D 64, gamma 1
SDTW_UTTERANCE = ((1, 64, 64), (1, 512, 512), (1, 2048, 2048))  # B = 1, T_ds 64 to ~2k
SDTW_CASES = ((SDTW_BENCH, 0), ((2, 1500, 700), 100), ((1, 64, 64), 0), ((1, 512, 512), 0),
              ((1, 2048, 2048), 0))
SDTW_STRIP = (1, 32, 4096)  # one strip: the kernels' own time a step
AWMC_PARITY = (3000, 2048, 1024)  # frames, seq, overlap: windows of 2048 and 1976
RUN_KWARGS = ["-kwargs", "epochs=1", "online=true", "shuffle=false", "optim_lr=9e-5",
              "spec_augment_n_freq_masks=6", "spec_augment_freq_mask_param=34", "seed=0"]
WER_WORDS = 10_000  # phase 12's long pair, timed on the native path
WER_COUNTS = (442, 371, 1136)  # its (ins, del, sub) by the Python DP (text/wer.py::_edit_ops)
WER_DP_WORDS = 2_000  # phase 12's pair on both paths
LM_VOCAB = 4095  # the flagship's vocabulary (+ blank)
LM_COUNTS = (200_000, 500_000, 500_000)  # drawn bigrams, trigrams, 4-grams (before dedup)
LM_BEAMS, LM_TTA_BEAMS = 20, 3
LM_CHECK_FRAMES = 512  # phases 13 and 14: card-against-CPU decode
TLM_FRAMES, TLM_WINDOWS = 18432, 3  # phase 14's recording: 16384, 16384, 14336 frames
TLM_HEADS = 8  # the published lming shape: 6 x 512, 8 heads, expansion 4, cache 128
TLM_RTOL = 1e-4  # phase 14's card-against-CPU beam scores
CONSISTENCY_PARITY_LAYERS = 2  # phase 15's f32 engine: flagship widths, depth cut
# phases 16-16c: the protocol drivers with the launch scripts' settings
# (launch_scripts/tune_half_concat_eval.sh, tune_within_loo.sh, eval_seq2.sh:
# offline, shuffled windows, 1 epoch)
PROTOCOL_KWARGS = ["-kwargs", "epochs=1", "optim_lr=9e-5", "spec_augment_n_freq_masks=6",
                   "spec_augment_freq_mask_param=34", "spec_augment_n_time_masks=0", "seed=0"]
HALF_RECORDS = 4  # phase 16: four recordings of N_FRAMES frames
LOO_FRAMES, LOO_SEQ, LOO_OVERLAP = 131072, 65536, 57344  # phase 16b: 10 chunks
SEQ_FRAMES, NSTI_SEQ, NSTI_OVERLAP = 49152, 32768, 28672  # phase 16c: 6 outer chunks
# the flagship's fields in a reference checkpoint's config (no kernel named)
REFERENCE_FIELDS = ("feat_in", "n_layers", "d_model", "n_heads", "head_dim", "vocab_size",
                    "subsampling_factor", "subsampling_conv_channels", "conv_kernel_size",
                    "rotary_base_freq", "self_conditioning")
FAMILIES = (
    ("flash_attention", ("tc_attention_", "tf32x3_attention_")),
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
    work = {"fwd": (4 * D * pairs, 4 * tensor_bytes + lse_bytes + B * T * 4),
            "bwd": (10 * D * pairs, 8 * tensor_bytes + lse_bytes + B * T * 4)}
    if dtype == torch.float32:
        # the f32 kernels take each product as three TF32 products on the
        # tensor cores; the same work on the CUDA cores is bounded too
        bounds = {k: bound(3 * f, b, TF32_FLOPS) for k, (f, b) in work.items()}
        bounds.update({f"{k}_cuda_core": bound(f, b, F32_FLOPS) for k, (f, b) in work.items()})
    else:
        bounds = {k: bound(f, b, PEAK_FLOPS[dtype]) for k, (f, b) in work.items()}
    return t, bounds


def sdpa_kernels(A, dtype):
    """The kernels SDPA (phase 4's yardstick) runs at the flagship shape in
    ``dtype``, forward and backward, from the profile."""
    import torch.nn.functional as F

    from dynamic_asr_eval_tpu_torch.perf import profile_kernels

    q, k, v, mask, dout = attention_inputs(2, 2048, 6, 128, [2048, 1600], dtype, seed=1)
    same = A._same_segment(mask)
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=same)
    result = {
        "fwd": profile_kernels(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=same)),
        "bwd": profile_kernels(lambda: torch.autograd.grad(out, (qs, ks, vs), dout.transpose(1, 2),
                                                           retain_graph=True))}
    for kind, rows in result.items():
        log(f"  SDPA {dtype} {kind} by kernel: " + (
            ", ".join(f"{n} x{c} {ms:.4f} ms" for n, c, ms in rows)
            if isinstance(rows, list) else rows))
    return result


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
    """(flops, bytes, pointwise-product flops) of the forward and of the
    backward on the main path (no gx): stage 0, both depthwise convs and both
    pointwise products; the backward recomputes the forward and adds the
    input and weight gradients of each."""
    from dynamic_asr_eval_tpu_torch.kernels.subsample import ceil_chain

    T0, T1, T2 = ceil_chain(T)
    M0, M1, M2 = B * T0 * F // 2, B * T1 * F // 4, B * T2 * F // 8
    stage0, dw, pw = 18 * M0 * C, 18 * (M1 + M2) * C, 2 * (M1 + M2) * C * C
    esize = torch.finfo(dtype).bits // 8
    weights = (32 * C + 2 * C * C) * 4
    x_bytes, out_bytes = B * T * F * esize, M2 * C * esize
    fwd = stage0 + dw + pw
    return {"fwd": (fwd, x_bytes + out_bytes + weights, pw),
            "bwd": (fwd + 2 * pw + 2 * dw + stage0, x_bytes + out_bytes + 2 * weights, 3 * pw)}


def tf32x3_bound(flops, products, nbytes):
    """(least ms, "operations" or "bytes") of work whose ``products`` flops
    run as three TF32 products on the tensor cores and the rest on the CUDA
    cores in f32."""
    t_ops = (3 * products / TF32_FLOPS + (flops - products) / F32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


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
    work = subsample_work(*SUB_FLAGSHIP, dtype)
    if dtype == torch.float32:
        # the f32 kernels take each pointwise product as three TF32 products
        # on the tensor cores; the same work all on the CUDA cores is bounded too
        bounds = {k: tf32x3_bound(f, p, b) for k, (f, b, p) in work.items()}
        bounds.update({f"{k}_cuda_core": bound(f, b, F32_FLOPS) for k, (f, b, _) in work.items()})
    else:
        bounds = {k: bound(f, b, PEAK_FLOPS[dtype]) for k, (f, b, _) in work.items()}
    return t, bounds


def subsample_breakdown(S, card):
    """One forward and one backward call of each route (bf16 and f32) at the
    flagship window (no gx, as on the main path) under torch.profiler: device
    ms and launches of each kernel inside them (a ``{"subsample_breakdown":
    ...}`` line, keyed by route)."""
    from dynamic_asr_eval_tpu_torch.perf import profile_kernels

    result = {"card": card, "shape": SUB_FLAGSHIP}
    for dtype in (torch.bfloat16, torch.float32):
        x, ws, gout = subsample_inputs(S, *SUB_FLAGSHIP, dtype, seed=1)
        route = S.ROUTES[dtype]
        result[route] = {
            "fwd": profile_kernels(lambda: S.fused_subsample_fwd(x, ws)),
            "bwd": profile_kernels(lambda: S.fused_subsample_bwd(x, ws, gout, need_gx=False))}
        for kind, rows in result[route].items():
            log(f"  fused subsampling {dtype} ({route}) {kind} by kernel: " + (
                ", ".join(f"{n} x{c} {ms:.4f} ms" for n, c, ms in rows)
                if isinstance(rows, list) else rows))
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
    R2, E2 = D.softdtw_R(Db, gamma), D.softdtw_E(Db, R, gamma)
    ref_R = D.forward_R_reference(Db, gamma)
    ref_E = D.backward_E_reference(Db, R, gamma)  # E's inputs: the same D and R
    torch.cuda.synchronize()
    what = f"soft-DTW {shape} bandwidth {bandwidth}"
    if not (torch.equal(R, R2) and torch.equal(E, E2)):
        raise AssertionError(f"{what}: the kernels do not repeat bit for bit")
    r_err = ((R - ref_R).abs() / ref_R.abs().clamp_min(1.0)).max().item()
    e_err = (E - ref_E).abs().max().item()
    e_scale = ref_E.abs().max().item()
    if not (r_err <= 1e-4 and torch.isfinite(E).all() and e_err <= 1e-4 * e_scale):
        raise AssertionError(f"{what}: R rel err {r_err:.3e}, E err {e_err:.3e} of max "
                             f"{e_scale:.3e}")
    log(f"  {what}: R rel {r_err:.2e}, E {e_err:.2e} (max |E| {e_scale:.3e}, loss "
        f"{R[0, shape[1], shape[2]].item():.6g}); both repeat bit for bit")
    return {"R": (R - ref_R).abs().max().item(), "E": e_err}


def softdtw_work(B, N, M):
    """(ops, bytes): ~15 f32 operations a cell forward (3 divisions, 3 exp,
    a log, max, adds), ~17 backward; D read and R written once forward; D
    and R read and E written once backward."""
    cells, padded = B * N * M, B * (N + 2) * (M + 2)
    return {"fwd": (15 * cells, 4 * (cells + padded)),
            "bwd": (17 * cells, 4 * (2 * cells + padded))}


def softdtw_kernel_ms(D, shape, gamma=1.0, iters=20):
    """(forward ms, whole backward call ms) of the kernels at ``shape``."""
    Db = softdtw_inputs(D, shape, 0, seed=1)
    R = D.softdtw_R(Db, gamma)
    return (cuda_ms(lambda: D.softdtw_R(Db, gamma), iters=iters),
            cuda_ms(lambda: D.softdtw_E(Db, R, gamma), iters=iters))


def softdtw_constant(D, name):
    """A ``constexpr int`` of the kernels' source."""
    return int(re.search(rf"constexpr int {name} = (\d+);", D.SOURCE.read_text()).group(1))


def softdtw_chain(D, card, shapes):
    """The chain floor of each shape: its N + M - 1 steps at the latency of
    one step's dependent chain (``kernels.softdtw.chain_step``: the kernels'
    own step run alone by one warp, in SM cycles, at the clock it ran at).
    Beside it, and not a bound, the kernels' own time a step on a single
    strip (SDTW_STRIP: one warp, no strip above to wait on), which adds what
    a step carries besides its chain: loads, stores and ring traffic."""
    D.chain_step()  # the card's clock up
    chain = {k: D.chain_step(backward=k == "bwd") for k in ("fwd", "bwd")}
    floors = {f"{s}": {k: (s[1] + s[2] - 1) * v["ns"] * 1e-6 for k, v in chain.items()}
              for s in shapes}
    # the steps the kernels take on the strip: a panel of P columns takes
    # P + 31 (lane 31 starts 31 steps after lane 0), rounded up to whole chunks
    B, N, M = SDTW_STRIP
    panel, chunk = (softdtw_constant(D, name) for name in ("PANEL", "CHUNK"))
    P = min(panel, M)
    steps = -(-M // P) * -(-(P + 31) // chunk) * chunk
    fwd_ms, bwd_ms = softdtw_kernel_ms(D, SDTW_STRIP, iters=200)
    strip_ns = {"fwd": fwd_ms / steps * 1e6, "bwd": bwd_ms / steps * 1e6}
    result = {"card": card, "chain_step": chain, "floor_ms": floors,
              "single_strip": {"shape": SDTW_STRIP, "steps": steps, "fwd_ms": fwd_ms,
                               "bwd_ms": bwd_ms, "step_ns": strip_ns}}
    log(f"  soft-DTW chain: one step {chain['fwd']['cycles']:.1f} / {chain['bwd']['cycles']:.1f} "
        f"cycles forward / backward at {chain['fwd']['mhz']:.0f} / {chain['bwd']['mhz']:.0f} MHz "
        f"({chain['fwd']['ns']:.2f} / {chain['bwd']['ns']:.2f} ns); the kernels on a single "
        f"strip {SDTW_STRIP}: {strip_ns['fwd']:.2f} / {strip_ns['bwd']:.2f} ns a step")
    print(json.dumps({"softdtw_chain": result}))
    return floors


def time_softdtw(D, card, gamma=1.0):
    for shape in SDTW_UTTERANCE:
        fwd_ms, bwd_ms = softdtw_kernel_ms(D, shape, gamma)
        log(f"  softdtw at {shape}: fwd {fwd_ms:.4f} ms, bwd {bwd_ms:.4f} ms")
    floors = softdtw_chain(D, card, SDTW_UTTERANCE + (SDTW_BENCH,))
    Db = softdtw_inputs(D, SDTW_BENCH, 0, seed=1)
    R = D.softdtw_R(Db, gamma)
    t = {
        "fwd": cuda_ms(lambda: D.softdtw_R(Db, gamma)),
        "bwd": cuda_ms(lambda: D.softdtw_E(Db, R, gamma)),
        "fwd_plain": cuda_ms(lambda: D.forward_R_reference(Db, gamma), iters=3, warmup=1),
        "bwd_plain": cuda_ms(lambda: D.backward_E_reference(Db, R, gamma), iters=3, warmup=1),
    }
    bounds = {k: bound(f, b, F32_FLOPS) for k, (f, b) in softdtw_work(*SDTW_BENCH).items()}
    bounds.update({f"{k}_chain": (v, "chain") for k, v in floors[f"{SDTW_BENCH}"].items()})
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


def main_path(cfg, kernel_modules, driver=None, flags=(), kwargs=(), frames=N_FRAMES):
    """A driver (default ``evals.run``) on a ``frames``-frame recording (the
    flagship one by default), its ``main`` given ``cfg`` (None: the
    configuration comes from ``flags``, e.g. ``--checkpoint``) and
    ``kwargs`` added to ``RUN_KWARGS``; returns (wer, wall, {module: (fwd,
    bwd) launches}, {module: {route: (fwd, bwd)}}, result detail,
    recorder)."""
    import pickle

    if driver is None:
        from dynamic_asr_eval_tpu_torch.evals import run as driver

    os.environ["DAE_SYNTH_SPEC_FRAMES"] = str(frames)
    recorder = EngineRecorder()
    build_engine = driver.build_engine
    with tempfile.TemporaryDirectory() as tmp:
        args = driver.parse_args([
            "-d", "synthetic_spec", "--quiet", "-s", os.path.join(tmp, "r.pkl"),
            "-seq", str(SEQ), "-o", str(OVERLAP), *flags, *RUN_KWARGS, *kwargs])
        driver.build_engine = recorder.wrap(build_engine)
        try:
            for mod in kernel_modules.values():
                mod.reset_counters()
            t0 = time.time()
            wer = driver.main(args, model_config=cfg)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = {k: (m.fwd_launches, m.bwd_launches) for k, m in kernel_modules.items()}
            routes = {k: {r: tuple(c) for r, c in m.route_launches.items()}
                      for k, m in kernel_modules.items() if hasattr(m, "route_launches")}
        finally:
            driver.build_engine = build_engine
        with open(os.path.join(tmp, "r_1.pkl"), "rb") as f:
            detail = pickle.load(f)
    return wer, wall, launches, routes, detail, recorder


def check_launches(launches, expect, windows=N_WINDOWS, exact=False):
    """expect: {module: per-window (fwd, bwd)}; forward >= (``exact``: ==)
    and backward == that count times the windows."""
    for name, (fwd_per, bwd_per) in expect.items():
        fwd, bwd = launches[name]
        if not ((fwd == fwd_per * windows if exact else fwd >= fwd_per * windows)
                and bwd == bwd_per * windows):
            raise AssertionError(f"{name} launches fwd {fwd}, bwd {bwd}; expected "
                                 f"{'==' if exact else '>='} {fwd_per * windows} and == "
                                 f"{bwd_per * windows}")


def bf16_only(by_route, expect) -> bool:
    """All of ``expect`` launches on the bf16 route (``"tensor_core"``), none
    on any other."""
    return "tensor_core" in by_route and all(
        tuple(c) == (tuple(expect) if r == "tensor_core" else (0, 0)) for r, c in by_route.items())


def check_routes(what, launches, routes):
    """Every launch of each routed module on the bf16 tensor-core kernels."""
    for name, by_route in routes.items():
        if not bf16_only(by_route, launches[name]):
            raise AssertionError(f"{what}: {name} launches by route {by_route}: not all on the "
                                 f"bf16 tensor-core kernels")


def weight_change(adapted, params):
    """Largest change of any weight; ``adapted`` is a state dict or, from
    the consistency engine, one per chunk (the smallest chunk's largest)."""
    if isinstance(adapted, list):
        return min(weight_change(chunk, params) for chunk in adapted)
    return max((adapted[k].float() - params[k].float()).abs().max().item() for k in params)


def check_driver_output(cfg, wer, detail, recorder, frames=N_FRAMES):
    """The driver's own run: stitched log-probs finite with the expected
    shape, weights that moved (every chunk's, for the consistency engine)."""
    if len(detail["model_output"]) != 1 or not math.isfinite(wer):
        raise AssertionError(f"driver result malformed: wer {wer}, {detail.get('model_output')}")
    if len(recorder.outputs) != 1:
        raise AssertionError(f"the driver made {len(recorder.outputs)} engine calls, not 1")
    (out,), ((params, _),) = recorder.outputs, recorder.calls
    lp = out.numpy_logits()
    expect = (-(-frames // cfg.subsampling_factor), cfg.n_classes)
    if lp.shape != expect:
        raise AssertionError(f"stitched log-probs {lp.shape} != {expect}")
    if not torch.isfinite(torch.from_numpy(lp)).all():
        raise AssertionError("non-finite stitched log-probs")
    moved = weight_change(out.params, params)
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

    model = SCConformer(flagship_config(**{**overrides, "compute_dtype": torch.float32})).cuda()
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
    from dynamic_asr_eval_tpu_torch.device import deterministic_cudnn

    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(2, 80, 4000, generator=g, device="cuda")
    lengths = torch.tensor([4000, 3001], device="cuda")
    route = A.ROUTES[torch.float32]
    A.reset_counters()
    with deterministic_cudnn():
        a, grads_a = model_run(f32_model(params), x, lengths)
        torch.cuda.synchronize()
        launches = tuple(A.route_launches[route])
        b, grads_b = model_run(f32_model(params, attention_impl="xla"), x, lengths)
    err = valid_frame_err(a, b)
    gerr = grad_err(grads_a, grads_b)
    if not (err <= 1e-3 and gerr <= 1e-3 and launches[0] > 0 and launches[1] > 0):
        raise AssertionError(f"kernel-path model vs plain path: output |err| {err:.3e}, weight "
                             f"gradients {gerr:.3e} of max (> 1e-3?), f32 launches {launches}")
    log(f"  full-depth f32 model, kernel vs plain attention on valid frames: {err:.2e}; weight "
        f"gradients {gerr:.2e} of max; f32 ({route}) launches fwd {launches[0]}, "
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
    from dynamic_asr_eval_tpu_torch.device import deterministic_cudnn

    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(2, 80, 4000, generator=g, device="cuda")
    lengths = torch.tensor([4000, 3000], device="cuda")
    model = f32_model(params, subsampling_impl="pallas")
    route = S.ROUTES[torch.float32]
    S.reset_counters()
    with deterministic_cudnn():
        a, grads_a = model_run(model, x, lengths)
        torch.cuda.synchronize()
        launches = tuple(S.route_launches[route])
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
        f"({route}) launches fwd {launches[0]}, bwd {launches[1]}")
    return launches


def check_checkpoints(tmp):
    """Phase 9: the flagship's seed-0 weights through a DAE1 file and a
    reference torch pickle; returns the DAE1 file's path."""
    import dataclasses

    from dynamic_asr_eval_tpu_torch.models import init_conformer
    from dynamic_asr_eval_tpu_torch.models.checkpoint import load_any_checkpoint, save_checkpoint

    cfg = flagship_config(subsampling_impl="pallas")
    state = init_conformer(cfg, seed=0).state_dict()
    dae, ref = os.path.join(tmp, "flagship.dae"), os.path.join(tmp, "flagship.pt")
    t0 = time.time()
    save_checkpoint(dae, state, cfg)
    t1 = time.time()
    _, dae_state, dae_cfg = load_any_checkpoint(dae)
    t2 = time.time()
    model_cfg = {k: getattr(cfg, k) for k in REFERENCE_FIELDS}
    torch.save({"model": state, "config": {"model": model_cfg}}, ref)
    _, ref_state, ref_cfg = load_any_checkpoint(ref)
    for what, loaded in (("DAE1", dae_state), ("reference pickle", ref_state)):
        if loaded.keys() != state.keys() or not all(torch.equal(loaded[k], v)
                                                    for k, v in state.items()):
            raise AssertionError(f"{what} checkpoint: the reloaded state dict differs")
    if dataclasses.asdict(dae_cfg) != dataclasses.asdict(cfg):
        raise AssertionError(f"DAE1 checkpoint: config {dae_cfg} != {cfg}")
    if any(getattr(ref_cfg, k) != v for k, v in model_cfg.items()):
        raise AssertionError(f"reference pickle: config {ref_cfg} lost a field of {model_cfg}")
    log(f"  DAE1 {os.path.getsize(dae) / 1e6:.1f} MB: saved in {t1 - t0:.2f} s, reloaded in "
        f"{t2 - t1:.2f} s, {len(state)} tensors bit for bit, config field for field; reference "
        f"pickle reloaded bit for bit (its config names no kernel: attention "
        f"{ref_cfg.attention_impl!r}, subsampling {ref_cfg.subsampling_impl!r})")
    return dae


def check_awmc_run(cfg, launches, routes, wer, detail, recorder):
    """Phase 10's checks: exact per-window launches, all on the bf16 route;
    the driver's own output."""
    per_window = {"attention": (4 * cfg.n_layers, cfg.n_layers), "subsample": (4, 1)}
    for name, (fwd, bwd) in per_window.items():
        expect = (fwd * N_WINDOWS, bwd * N_WINDOWS)
        if launches[name] != expect:
            raise AssertionError(f"AWMC {name} launches {launches[name]}, expected {expect} "
                                 f"(anchor, leader, student and clean forwards, one backward)")
        if not bf16_only(routes[name], expect):
            raise AssertionError(f"AWMC {name} launches by route {routes[name]}: not all on "
                                 f"the bf16 tensor-core kernels")
    return check_driver_output(cfg, wer, detail, recorder)


def f32_route_launches(what, A, S):
    """{module: (fwd, bwd)} launches of the attention's and the subsampling's
    f32 routes since the counters were zeroed; raises if a bf16 kernel ran."""
    if A.route_launches["tensor_core"] != [0, 0] or S.route_launches["tensor_core"] != [0, 0]:
        raise AssertionError(f"{what} launched a bf16 kernel")
    return {"attention": tuple(A.route_launches[A.ROUTES[torch.float32]]),
            "subsample": tuple(S.route_launches[S.ROUTES[torch.float32]])}


def check_awmc_parity(params, A, S):
    """Phase 10b: the full-depth f32 AWMC engine through the f32 kernels
    against the same engine on the plain path; returns the f32 route's
    launches {module: (fwd, bwd)}."""
    import numpy as np

    from dynamic_asr_eval_tpu_torch.config import TTAConfig
    from dynamic_asr_eval_tpu_torch.device import deterministic_cudnn
    from dynamic_asr_eval_tpu_torch.tta import AWMCEngine

    frames, seq, overlap = AWMC_PARITY
    spec = np.random.default_rng(5).standard_normal((80, frames)).astype(np.float32)
    tta = TTAConfig(seq_len=seq, overlap=overlap, epochs=1, online=True, shuffle=False,
                    lm_tta_beams=0, optim_args={"lr": 9e-5})

    def run(**overrides):
        model = f32_model(params, **overrides)
        out = AWMCEngine(model, model.config.blank_id, 8, tta, device="cuda")(
            None, spec, seq, overlap, rng=0)
        torch.cuda.synchronize()
        return out

    A.reset_counters()
    S.reset_counters()
    with deterministic_cudnn():
        a = run(subsampling_impl="pallas")
        launches = f32_route_launches("the f32 AWMC engine", A, S)
        b = run(attention_impl="xla")
    lp_a, lp_b = a.numpy_logits(), b.numpy_logits()
    err, scale = float(np.abs(lp_a - lp_b).max()), float(np.abs(lp_b).max())
    same_ids = np.array_equal(a.greedy_ids(), b.greedy_ids())
    if not (lp_a.shape == lp_b.shape and err <= 1e-3 * scale and same_ids
            and min(min(v) for v in launches.values()) > 0):
        raise AssertionError(f"f32 AWMC, kernels vs plain path: {err:.3e} (max |log-prob| "
                             f"{scale:.3e}), greedy ids equal {same_ids}, f32 launches {launches}")
    log(f"  full-depth f32 AWMC engine, kernels vs plain path on {lp_a.shape[0]} frames: "
        f"{err:.2e} (max |log-prob| {scale:.3e}); greedy ids equal; f32 launches {launches} "
        f"(attention {A.ROUTES[torch.float32]}, subsampling {S.ROUTES[torch.float32]})")
    return launches


def check_consistency_run(cfg, launches, routes, wer, detail, recorder):
    """Phase 15's checks: per chunk, one forward (augmented and clean in one
    batch) and one backward each epoch, then the offline re-inference's
    forward; all on the bf16 route; the driver's own output, every chunk's
    weights moved."""
    epochs = max(recorder.engine.config.epochs, 1)
    per_chunk = {"attention": ((epochs + 1) * cfg.n_layers, epochs * cfg.n_layers),
                 "subsample": (epochs + 1, epochs)}
    for name, (fwd, bwd) in per_chunk.items():
        expect = (fwd * N_WINDOWS, bwd * N_WINDOWS)
        if launches[name] != expect:
            raise AssertionError(f"consistency {name} launches {launches[name]}, expected "
                                 f"{expect} (per chunk and epoch one forward and one backward, "
                                 f"then the re-inference)")
    check_routes("consistency path", launches, routes)
    if len(recorder.outputs[0].params) != N_WINDOWS:
        raise AssertionError(f"{len(recorder.outputs[0].params)} chunks' weights returned, "
                             f"not {N_WINDOWS}")
    return check_driver_output(cfg, wer, detail, recorder)


def check_consistency_parity(A, S):
    """Phase 15, parity: a CONSISTENCY_PARITY_LAYERS-layer f32 consistency
    engine at flagship widths (seeded weights), offline, 2 epochs, through
    the f32 kernels against the same engine on the plain path; returns the
    f32 route's launches {module: (fwd, bwd)}."""
    import numpy as np

    from dynamic_asr_eval_tpu_torch.config import TTAConfig
    from dynamic_asr_eval_tpu_torch.device import deterministic_cudnn
    from dynamic_asr_eval_tpu_torch.models import init_conformer
    from dynamic_asr_eval_tpu_torch.tta import ConsistencyEngine

    frames, seq, overlap = AWMC_PARITY
    spec = np.random.default_rng(7).standard_normal((80, frames)).astype(np.float32)
    tta = TTAConfig(seq_len=seq, overlap=overlap, epochs=2, online=False, shuffle=False,
                    lm_tta_beams=0, optim_args={"lr": 9e-5})
    state = init_conformer(flagship_config(n_layers=CONSISTENCY_PARITY_LAYERS), seed=6).state_dict()

    def run(**overrides):
        model = f32_model(state, n_layers=CONSISTENCY_PARITY_LAYERS, **overrides)
        out = ConsistencyEngine(model, model.config.blank_id, 8, tta, device="cuda")(
            None, spec, seq, overlap, rng=0)
        torch.cuda.synchronize()
        return out

    A.reset_counters()
    S.reset_counters()
    with deterministic_cudnn():
        a = run(subsampling_impl="pallas")
        launches = f32_route_launches("the f32 consistency engine", A, S)
        b = run(attention_impl="xla")
    lp_a, lp_b = a.numpy_logits(), b.numpy_logits()
    err, scale = float(np.abs(lp_a - lp_b).max()), float(np.abs(lp_b).max())
    same_ids = np.array_equal(a.greedy_ids(), b.greedy_ids())
    if not (lp_a.shape == lp_b.shape and err <= 1e-3 * scale and same_ids
            and min(min(v) for v in launches.values()) > 0):
        raise AssertionError(f"f32 consistency, kernels vs plain path: {err:.3e} (max |log-prob| "
                             f"{scale:.3e}), greedy ids equal {same_ids}, f32 launches {launches}")
    log(f"  {CONSISTENCY_PARITY_LAYERS}-layer f32 consistency engine at flagship widths, kernels "
        f"vs plain path on {lp_a.shape[0]} frames: {err:.2e} (max |log-prob| {scale:.3e}); greedy "
        f"ids equal; f32 launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# the protocol drivers (phases 16, 16b, 16c)
# ---------------------------------------------------------------------------


def n_windows(frames, seq=SEQ, overlap=OVERLAP) -> int:
    from dynamic_asr_eval_tpu_torch.ops.chunk import chunk_starts_and_lengths

    return len(chunk_starts_and_lengths(frames, seq, overlap)[0])


def n_forwards(windows, infer_batch) -> int:
    """The evaluation engine's forwards over ``windows``: ``infer_batch``
    windows a forward."""
    return -(-windows // infer_batch)


def engine_plan(frames, infer_batch, adapt_only=False):
    """(windows adapted, forwards) of one offline NSTI engine call with
    ``epochs=1``: one forward and one backward of the [augmented, clean]
    batch per window, then, unless ``adapt_only``, the re-inference of
    every window with the adapted weights."""
    windows = n_windows(frames)
    infer = 0 if adapt_only else n_forwards(windows, infer_batch)
    return windows, windows + infer


def half_concat_plan(frames, n_records, infer_batch):
    """Phase 16: the baseline evaluates every record; each fold adapts only
    on the concatenation of its half, then evaluates the other half."""
    per_record = n_windows(frames)
    plan = {"records": n_records, "adapted": 0, "evaluated": n_records * per_record,
            "forwards": n_records * n_forwards(per_record, infer_batch), "adapt_calls": 2,
            "eval_calls": 2 * n_records}
    for fold in (0, 1):
        n_adapt = n_records // 2 if fold == 0 else n_records - n_records // 2
        adapted, fwd = engine_plan(frames * n_adapt, infer_batch, adapt_only=True)
        plan["adapted"] += adapted
        plan["forwards"] += fwd + (n_records - n_adapt) * n_forwards(per_record, infer_batch)
        plan["evaluated"] += (n_records - n_adapt) * per_record
    return plan


def loo_plan(frames, loo_seq, loo_overlap, infer_batch):
    """Phase 16b: one adaptation per chunk that has an audio-disjoint
    partner, then windowed inference of each of its partners.  Offline, the
    adapting engine also re-infers its own chunk, whose output the driver
    drops (``discarded``: those windows)."""
    from dynamic_asr_eval_tpu_torch.ops.chunk import chunk_starts_and_lengths

    starts, lens = chunk_starts_and_lengths(frames, loo_seq, loo_overlap)
    valid = {i: [j for j in range(len(starts)) if starts[j] >= starts[i] + lens[i]
                 or starts[i] >= starts[j] + lens[j]] for i in range(len(starts))}
    usable = [i for i in valid if valid[i]]
    plan = {"n_chunks": len(starts), "usable": usable,
            "pairs": sum(len(v) for v in valid.values()), "adapted": 0, "evaluated": 0,
            "discarded": 0, "forwards": 0, "adapt_calls": len(usable),
            "eval_calls": sum(len(v) for v in valid.values())}
    for i in usable:
        adapted, fwd = engine_plan(lens[i], infer_batch)
        plan["adapted"] += adapted
        plan["forwards"] += fwd
        plan["discarded"] += adapted
        for j in valid[i]:
            plan["evaluated"] += n_windows(lens[j])
            plan["forwards"] += n_forwards(n_windows(lens[j]), infer_batch)
    return plan


def seq_plan(frames, nsti_seq, nsti_overlap, infer_batch):
    """Phase 16c: the full NSTI engine on each outer chunk."""
    from dynamic_asr_eval_tpu_torch.ops.chunk import chunk_starts_and_lengths

    _, lens = chunk_starts_and_lengths(frames, nsti_seq, nsti_overlap)
    plan = {"n_chunks": len(lens), "inner_windows": [n_windows(L) for L in lens], "adapted": 0,
            "evaluated": 0, "forwards": 0, "adapt_calls": len(lens), "eval_calls": 0}
    for L in lens:
        adapted, fwd = engine_plan(L, infer_batch)
        plan["adapted"] += adapted
        plan["forwards"] += fwd
        plan["evaluated"] += adapted  # the re-inference gives the output
    return plan


def plan_launches(plan, n_layers):
    """{module: (fwd, bwd)}: one attention launch per layer and one
    subsampling launch per forward (a batch of windows) or backward."""
    return {"attention": (n_layers * plan["forwards"], n_layers * plan["adapted"]),
            "subsample": (plan["forwards"], plan["adapted"])}


def check_protocol_launches(what, launches, routes, expect):
    """Exactly ``expect`` launches of each module, all on the bf16 route."""
    for name, want in expect.items():
        if tuple(launches[name]) != tuple(want):
            raise AssertionError(f"{what}: {name} launches {launches[name]}, expected {want}")
        if name in routes and not bf16_only(routes[name], want):
            raise AssertionError(f"{what}: {name} launches by route {routes[name]}: not all on "
                                 f"the bf16 tensor-core kernels")


class CallLog:
    """Stands in for an engine that a protocol driver builds: passes each
    call on unchanged, synchronizes the card around it and keeps (params,
    frames, keyword arguments, output, seconds); every other attribute is
    the engine's.  The engine's windowed inference (an adapting engine's
    offline re-inference) is timed apart, into ``infer_seconds``."""

    def __init__(self, engine, run):
        self.engine, self.run, self.calls, self.infer_seconds = engine, run, [], []
        infer = engine._infer

        def timed_infer(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.time()
            out = infer(*args, **kwargs)
            torch.cuda.synchronize()
            self.infer_seconds.append(time.time() - t0)
            return out
        engine._infer = timed_infer

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def __call__(self, params, spec, *args, **kwargs):
        if self.run.pristine is None:  # the driver's weights, before any call
            self.run.params = params
            self.run.pristine = {k: v.clone() for k, v in params.items()}
        torch.cuda.synchronize()
        t0 = time.time()
        out = self.engine(params, spec, *args, **kwargs)
        torch.cuda.synchronize()
        self.calls.append((params, spec.shape[-1], kwargs, out, time.time() - t0))
        return out


class ProtocolRun:
    """One run of a protocol driver's ``main`` with its engines logged and
    its ``core`` function's (``loo_eval``, ``seq_eval_one``) results kept."""

    def __init__(self, driver, core=None):
        self.driver, self.core = driver, core
        self.adapt = self.eval = None
        self.pristine = self.params = None
        self.core_results = []

    def patches(self):
        d = self.driver

        def wrap_build(build, slot):
            def built(*args, **kwargs):
                log = CallLog(build(*args, **kwargs), self)
                setattr(self, slot, log)
                return log
            return built

        out = {"build_engine": wrap_build(d.build_engine, "adapt")}
        if hasattr(d, "build_eval_engine"):
            out["build_eval_engine"] = wrap_build(d.build_eval_engine, "eval")
        if self.core is not None:
            core = getattr(d, self.core)

            def kept(*args, **kwargs):
                result = core(*args, **kwargs)
                self.core_results.append(result)
                return result
            out[self.core] = kept
        return out

    def __call__(self, cfg, frames, flags, kernel_modules, pickle_name):
        """Returns (the driver's return, wall seconds, {module: (fwd, bwd)},
        {module: {route: (fwd, bwd)}}, the result pickle); the counters are
        zeroed just before ``main`` and read just after."""
        import pickle

        os.environ["DAE_SYNTH_SPEC_FRAMES"] = ",".join(str(f) for f in frames)
        patches = self.patches()
        saved = {name: getattr(self.driver, name) for name in patches}
        with tempfile.TemporaryDirectory() as tmp:
            args = self.driver.parse_args([
                "-d", "synthetic_spec", "--quiet", "-s", os.path.join(tmp, "r.pkl"),
                "-seq", str(SEQ), "-o", str(OVERLAP), *flags, *PROTOCOL_KWARGS])
            for name, fn in patches.items():
                setattr(self.driver, name, fn)
            try:
                for mod in kernel_modules.values():
                    mod.reset_counters()
                t0 = time.time()
                result = self.driver.main(args, model_config=cfg)
                torch.cuda.synchronize()
                wall = time.time() - t0
                launches = {k: (m.fwd_launches, m.bwd_launches)
                            for k, m in kernel_modules.items()}
                routes = {k: {r: tuple(c) for r, c in m.route_launches.items()}
                          for k, m in kernel_modules.items() if hasattr(m, "route_launches")}
            finally:
                for name, fn in saved.items():
                    setattr(self.driver, name, fn)
            with open(os.path.join(tmp, pickle_name), "rb") as f:
                detail = pickle.load(f)
        return result, wall, launches, routes, detail

    def check_pristine(self, what):
        """The driver's weights are bit for bit what they were before its
        first engine call."""
        if not all(torch.equal(self.params[k], v) for k, v in self.pristine.items()):
            raise AssertionError(f"{what}: the pristine weights changed")

    def check_calls(self, what, plan):
        n = (len(self.adapt.calls), len(self.eval.calls) if self.eval else 0)
        if n != (plan["adapt_calls"], plan["eval_calls"]):
            raise AssertionError(f"{what}: {n[0]} adaptations and {n[1]} evaluations, expected "
                                 f"{plan['adapt_calls']} and {plan['eval_calls']}")


def finite_wers(what, wers):
    if not all(math.isfinite(w) for w in wers):
        raise AssertionError(f"{what}: WER not finite: {wers}")


def check_half_concat(run, result, detail, plan):
    """Phase 16: adapt-only folds (no stitched log-probs, weights moved,
    pristine weights unchanged), each fold's evaluations with that fold's
    weights, a pickle with 2 folds and a baseline, finite WERs."""
    run.check_calls("half-concat", plan)
    run.check_pristine("half-concat")
    folds = []
    for params, _, kwargs, out, _ in run.adapt.calls:
        if not (kwargs.get("adapt_only") and out.logits is None and out.counts is None):
            raise AssertionError(f"half-concat: an adaptation was not adapt-only: {kwargs}")
        moved = weight_change(out.params, run.pristine)
        if params is not run.params or not moved > 0:
            raise AssertionError(f"half-concat: a fold did not adapt from the pristine weights "
                                 f"(max change {moved})")
        folds.append(out.params)
    n = plan["records"]  # fold 0 adapts on the first n // 2 records and evaluates the rest
    want = [run.params] * n + [folds[0]] * (n - n // 2) + [folds[1]] * (n // 2)
    if [p is w for (p, *_), w in zip(run.eval.calls, want)] != [True] * len(want):
        raise AssertionError("half-concat: an evaluation ran with the wrong weights")
    if len(detail["folds"]) != 2 or detail["baseline"] is None:
        raise AssertionError(f"half-concat pickle: {sorted(detail)}, {len(detail['folds'])} folds")
    finite_wers("half-concat", [result, detail["baseline"]["wer"]]
                + [f["wer"] for f in detail["folds"]])
    return [weight_change(f, run.pristine) for f in folds]


def check_stitched(what, logits, frames, cfg):
    """Stitched log-probs of the whole recording: one row per downsampled
    frame (no gap dropped), finite."""
    expect = (-(-frames // cfg.subsampling_factor), cfg.n_classes)
    if logits.shape != expect or not torch.isfinite(torch.from_numpy(logits)).all():
        raise AssertionError(f"{what}: stitched log-probs {logits.shape} (expected {expect}), "
                             f"finite {bool(torch.isfinite(torch.from_numpy(logits)).all())}")


def check_loo(run, result, detail, plan, frames, cfg):
    """Phase 16b: ``loo_eval`` took the ``"loo"`` mode over every chunk, and
    its stitched coverage has no gap."""
    run.check_calls("LOO", plan)
    run.check_pristine("LOO")
    ((logits, meta),) = run.core_results
    if meta != {"n_chunks": plan["n_chunks"], "mode": "loo"}:
        raise AssertionError(f"LOO: loo_eval returned {meta}")
    check_stitched("LOO", logits, frames, cfg)
    finite_wers("LOO", [result, detail["wer"]])


def check_seq(run, result, detail, frames, cfg):
    """Phase 16c: the second-level stitch has the recording's downsampled
    length and finite values."""
    run.check_pristine("sequence scaling")
    (logits,) = run.core_results
    check_stitched("sequence scaling", logits, frames, cfg)
    finite_wers("sequence scaling", [result, detail["wer"]])


def protocol_phase(label, driver, card, kernel_modules, cfg, frames, flags, pickle_name, plan_fn,
                   check, core=None):
    """Runs a protocol driver twice (first and warm), zeroing and reading the
    launch counters around each run; checks each run's launches (exact, all
    bf16) and the first run's output; prints a ``{"protocols": ...}`` line
    and returns the first run's launches and routes."""
    name = driver.__name__.rsplit(".", 1)[-1]
    runs = []
    for attempt in ("first", "warm"):
        run = ProtocolRun(driver, core)
        result, wall, launches, routes, detail = run(cfg, frames, flags, kernel_modules,
                                                     pickle_name)
        plan = plan_fn(run.adapt.infer_batch)
        check_protocol_launches(f"{name} ({attempt})", launches, routes,
                                {**plan_launches(plan, cfg.n_layers), "softdtw": (0, 0)})
        extra = check(run, result, detail, plan) if attempt == "first" else None
        runs.append((run, wall, launches, routes, result, extra))
    (first, first_wall, launches, routes, result, extra), (warm, warm_wall, *_) = runs
    adapt_s = [sum(c[-1] for c in r.adapt.calls) for r in (first, warm)]
    reinfer_s = [sum(r.adapt.infer_seconds) for r in (first, warm)]
    eval_s = [sum(c[-1] for c in r.eval.calls) if r.eval else 0.0 for r in (first, warm)]
    # adaptation only: the adapting engine's seconds less its re-inference
    per_window = [(a - i) * 1e3 / plan["adapted"] for a, i in zip(adapt_s, reinfer_s)]
    line = {"phase": label, "driver": name, "card": card, "frames": frames,
            "plan": plan, "windows_adapted": plan["adapted"],
            "windows_evaluated": plan["evaluated"], "forwards": plan["forwards"],
            "wall_s": {"first": first_wall, "warm": warm_wall},
            "adapt_engine_s": {"first": adapt_s[0], "warm": adapt_s[1]},
            "adapt_engine_reinfer_s": {"first": reinfer_s[0], "warm": reinfer_s[1]},
            "eval_engine_s": {"first": eval_s[0], "warm": eval_s[1]},
            "ms_per_adapted_window": {"first": per_window[0], "warm": per_window[1]},
            "wer": result, "launches": launches}
    if extra is not None:
        line["fold_weight_change"] = extra
    log(f"  {name}: {plan['adapted']} windows adapted, {plan['evaluated']} evaluated, "
        f"{plan['forwards']} forwards; wall first {first_wall:.3f} s, warm {warm_wall:.3f} s; "
        f"adaptation alone {per_window[1]:.2f} ms a window (warm; the adapting engine's "
        f"re-inference {reinfer_s[1]:.3f} s apart); launches {launches}, all bf16")
    print(json.dumps({"protocols": line}))
    return launches, routes


def protocol_phases(card, A, S, D):
    """Phases 16, 16b and 16c at the flagship widths, bf16, ``"pallas"``
    subsampling; returns each phase's first-run (launches, routes)."""
    from dynamic_asr_eval_tpu_torch.evals import (
        run_half_concat_eval,
        run_seq_eval,
        run_within_recording_loo_eval,
    )

    modules = {"attention": A, "subsample": S, "softdtw": D}
    cfg = flagship_config(subsampling_impl="pallas")
    log(f"[16] half-concat: evals.run_half_concat_eval.main -ao {OVERLAP} on {HALF_RECORDS} "
        f"{N_FRAMES}-frame recordings, flagship, bf16, subsampling_impl='pallas', offline, "
        f"on {card}")
    half = protocol_phase(
        "16", run_half_concat_eval, card, modules, cfg, [N_FRAMES] * HALF_RECORDS,
        ["-ao", str(OVERLAP)], "r.pkl", lambda ib: half_concat_plan(N_FRAMES, HALF_RECORDS, ib),
        check_half_concat)
    log(f"[16b] within-recording LOO: evals.run_within_recording_loo_eval.main --loo_seq_len "
        f"{LOO_SEQ} --loo_overlap {LOO_OVERLAP} on a {LOO_FRAMES}-frame recording, flagship, "
        f"bf16, offline, on {card}")
    loo = protocol_phase(
        "16b", run_within_recording_loo_eval, card, modules, cfg, [LOO_FRAMES],
        ["--loo_seq_len", str(LOO_SEQ), "--loo_overlap", str(LOO_OVERLAP)], "r_1.pkl",
        lambda ib: loo_plan(LOO_FRAMES, LOO_SEQ, LOO_OVERLAP, ib),
        lambda run, result, detail, plan: check_loo(run, result, detail, plan, LOO_FRAMES, cfg),
        core="loo_eval")
    log(f"[16c] sequence scaling: evals.run_seq_eval.main --nsti_seq_len {NSTI_SEQ} "
        f"--nsti_overlap {NSTI_OVERLAP} on a {SEQ_FRAMES}-frame recording, flagship, bf16, "
        f"offline, on {card}")
    seq = protocol_phase(
        "16c", run_seq_eval, card, modules, cfg, [SEQ_FRAMES],
        ["--nsti_seq_len", str(NSTI_SEQ), "--nsti_overlap", str(NSTI_OVERLAP)], "r_1.pkl",
        lambda ib: seq_plan(SEQ_FRAMES, NSTI_SEQ, NSTI_OVERLAP, ib),
        lambda run, result, detail, plan: check_seq(run, result, detail, SEQ_FRAMES, cfg),
        core="seq_eval_one")
    return half, loo, seq


# ---------------------------------------------------------------------------
# the native host libraries and the -lm path
# ---------------------------------------------------------------------------


class Timed:
    """Stands in for ``fn``: synchronizes the card before and after each call
    and keeps each call's seconds."""

    def __init__(self, fn):
        self.fn = fn
        self.seconds = []

    def __call__(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.time()
        out = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.seconds.append(time.time() - t0)
        return out


def wer_pair(n_words, seed=0):
    """A reference of ``n_words`` words from a 5000-word vocabulary and a
    hypothesis with ~10 % substitutions, 5 % deletions and 5 % insertions."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ref = [f"w{i}" for i in rng.integers(0, 5000, n_words)]
    hyp = []
    for word, u in zip(ref, rng.random(n_words)):
        if u < 0.10:
            hyp.append(f"w{rng.integers(0, 5000)}")
        elif u < 0.15:
            continue
        else:
            hyp.append(word)
            if u > 0.95:
                hyp.append(f"w{rng.integers(0, 5000)}")
    return " ".join(hyp), " ".join(ref)


def check_native_libraries(card):
    """Phase 12: both native libraries built (g++ seconds of this process);
    the native WER on a long pair against the Python DP's stored counts, and
    against the Python DP itself, both timed, on a shorter pair."""
    from dynamic_asr_eval_tpu_torch.lm import arpa_native
    from dynamic_asr_eval_tpu_torch.text import wer

    builds = {}
    for lib in (wer.LIBRARY, arpa_native.LIBRARY):
        lib.load()
        builds[lib.source.name] = lib.build_seconds
        log(f"  {lib.source.name}: " + ("built before this phase" if lib.build_seconds is None
                                        else f"g++ {lib.build_seconds:.2f} s"))
    hyp, ref = wer_pair(WER_WORDS)
    t0 = time.time()
    native = tuple(int(x) for x in wer.wer_counts(hyp, ref)[:3])
    native_s = time.time() - t0
    if native != WER_COUNTS:
        raise AssertionError(f"native WER counts {native} != the Python DP's {WER_COUNTS}")
    hyp, ref = wer_pair(WER_DP_WORDS)
    t0 = time.time()
    short = tuple(int(x) for x in wer.wer_counts(hyp, ref)[:3])
    t1 = time.time()
    plain = wer._edit_ops(hyp.split(), ref.split())
    t2 = time.time()
    if short != plain:
        raise AssertionError(f"native WER counts {short} != the Python DP's {plain}")
    result = {"card": card, "g++_seconds": builds, "words": WER_WORDS, "ins_del_sub": native,
              "native_s": native_s, "dp_words": WER_DP_WORDS, "dp_ins_del_sub": short,
              "dp_native_s": t1 - t0, "python_dp_s": t2 - t1}
    log(f"  {WER_WORDS}-word pair, native (ins, del, sub) {native}, as the Python DP gives: "
        f"{native_s:.4f} s; {WER_DP_WORDS}-word pair, {short} on both paths: native "
        f"{t1 - t0:.4f} s, Python DP {t2 - t1:.2f} s ({card})")
    print(json.dumps({"native_wer": result}))


def synthetic_pieces(n):
    """``n`` distinct word-start pieces: "▁" and a bijective base-26 letter
    string (a, b, ..., z, aa, ab, ...)."""
    pieces = []
    for i in range(n):
        word, j = "", i
        while j >= 0:
            word = chr(ord("a") + j % 26) + word
            j = j // 26 - 1
        pieces.append("\u2581" + word)
    return pieces


def write_vocab(directory, vocab=LM_VOCAB):
    """The vocabulary file of ``vocab`` synthetic pieces (the tokenizer of
    phases 13 and 14); returns its path."""
    path = os.path.join(directory, "synthetic.vocab")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(synthetic_pieces(vocab)) + "\n")
    return path


def write_synthetic_lm(directory, seed=0, vocab=LM_VOCAB, counts=LM_COUNTS):
    """A vocabulary file of ``vocab`` pieces and a token-level ARPA file
    over them: every unigram, and per higher order ``counts[k]`` draws of a
    lower-order n-gram extended by a random piece (duplicates dropped), with
    random log10 probabilities and backoffs.  Returns (vocab path, ARPA path,
    n-grams per order)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pieces = np.array(synthetic_pieces(vocab), dtype=object)
    vocab_path = write_vocab(directory, vocab)
    grams = [np.arange(vocab)[:, None]]
    for n in counts:
        prev = grams[-1]
        rows = np.concatenate([prev[rng.integers(0, len(prev), n)],
                               rng.integers(0, vocab, (n, 1))], axis=1)
        grams.append(np.unique(rows, axis=0))
    arpa_path = os.path.join(directory, "synthetic.arpa")
    with open(arpa_path, "w", encoding="utf-8") as f:
        f.write("\\data\\\n" + "".join(f"ngram {k + 1}={len(g)}\n" for k, g in enumerate(grams)))
        for k, g in enumerate(grams):
            logp = rng.uniform(-4.0, -0.5, len(g))
            words = [" ".join(row) for row in pieces[g]]
            if k + 1 < len(grams):
                backoff = rng.uniform(-1.0, 0.0, len(g))
                body = [f"{a:.4f}\t{w}\t{b:.4f}" for a, w, b in zip(logp, words, backoff)]
            else:
                body = [f"{a:.4f}\t{w}" for a, w in zip(logp, words)]
            f.write(f"\n\\{k + 1}-grams:\n" + "\n".join(body) + "\n")
        f.write("\n\\end\\\n")
    return vocab_path, arpa_path, [len(g) for g in grams]


def check_live_beams(what, got, want, rel=1e-5):
    """Two searches' live beams (score above -1e29): same order, tokens and
    lengths, scores within ``rel``; returns the largest relative difference."""
    (gt, gl, gs), (wt, wl, ws) = ([x.cpu() for x in r] for r in (got, want))
    live = ws > -1e29
    if not (torch.equal(gs > -1e29, live) and torch.equal(gl[live], wl[live])
            and all(torch.equal(gt[b, : gl[b]], wt[b, : wl[b]]) for b in torch.nonzero(live)[:, 0])):
        raise AssertionError(f"{what}: the live beams differ in tokens, lengths or order")
    diff = ((gs[live] - ws[live]).abs() / ws[live].abs().clamp_min(1e-30)).max().item()
    if not diff <= rel:
        raise AssertionError(f"{what}: beam scores differ by {diff:.3e} relative (> {rel})")
    return diff


def lm_path(tmp, card, kernel_modules, pallas_profile, expect):
    """Phase 13: ``evals.run.main -lm`` at flagship width; returns the
    kernels' launches ({module: (fwd, bwd)}) and, for the modules with
    routes, the launches by route."""
    import argparse

    import dynamic_asr_eval_tpu_torch.evals.common as common
    import dynamic_asr_eval_tpu_torch.tta.runner as runner
    from dynamic_asr_eval_tpu_torch.lm.loader import load_lm_adapter
    from dynamic_asr_eval_tpu_torch.ops.beam_search import (
        beam_search_device,
        collapse_blank_frames_device,
    )
    from dynamic_asr_eval_tpu_torch.ops.chunk import chunk_starts_and_lengths
    from dynamic_asr_eval_tpu_torch.text import load_tokenizer

    t0 = time.time()
    vocab_path, arpa_path, counts = write_synthetic_lm(tmp)
    arpa_mb = os.path.getsize(arpa_path) / 1e6
    log(f"  synthetic LM: {LM_VOCAB} pieces; n-grams by order {counts}; {arpa_mb:.1f} MB of ARPA "
        f"written in {time.time() - t0:.2f} s")
    cfg = flagship_config(subsampling_impl="pallas")
    timers = {"load": Timed(common.load_lm_adapter), "beam": Timed(runner.beam_search_device),
              "decode": Timed(common.decode_output)}
    originals = common.load_lm_adapter, runner.beam_search_device, common.decode_output
    common.load_lm_adapter, runner.beam_search_device, common.decode_output = (
        timers["load"], timers["beam"], timers["decode"])
    try:
        wer, wall, launches, routes, detail, recorder = main_path(
            cfg, kernel_modules,
            flags=("--tokenizer", vocab_path, "-lm", arpa_path, "--beams", str(LM_BEAMS)),
            kwargs=(f"lm_tta_beams={LM_TTA_BEAMS}",))
    finally:
        common.load_lm_adapter, runner.beam_search_device, common.decode_output = originals
    check_launches(launches, expect)
    check_routes("-lm path", launches, routes)
    check_driver_output(cfg, wer, detail, recorder)
    engine, (out,) = recorder.engine, recorder.outputs
    adapter = engine.lm_adapter
    if adapter is None or engine.config.lm_tta_beams != LM_TTA_BEAMS:
        raise AssertionError("the NSTI engine runs without LM-fused pseudo-labels")
    devices = {t.device.type for t in adapter.lm.keys.values()}
    if adapter.lm.reader != "native" or devices != {"cuda"}:
        raise AssertionError(f"n-gram tables read by the {adapter.lm.reader} parser, on "
                             f"{devices}, the engine on {engine.device}")
    if len(timers["beam"].seconds) != N_WINDOWS or len(timers["decode"].seconds) != 1:
        raise AssertionError(f"{len(timers['beam'].seconds)} pseudo-label beams and "
                             f"{len(timers['decode'].seconds)} final decodes, expected "
                             f"{N_WINDOWS} and 1")
    hyp = detail["model_output"][0]
    if not hyp.strip():
        raise AssertionError("the -lm decode gave an empty transcript")
    log(f"  WER {wer}; launches {launches}; by route {routes}; evals.run wall {wall:.3f} s; "
        f"transcript of {len(hyp.split())} words; n-gram tables on {engine.device}, read by the "
        f"native reader")

    log(f"  the card's beam against the CPU's on the first {LM_CHECK_FRAMES} collapsed frames")
    kw = dict(common.lm_kwargs(argparse.Namespace()), beam_width=LM_BEAMS)
    n_valid = (out.counts > 0).sum()
    lp_c, n_kept = collapse_blank_frames_device(out.logits, threshold=0.99, valid_frames=n_valid)
    lp = lp_c[: min(int(n_kept), LM_CHECK_FRAMES)]
    gpu_timer = Timed(beam_search_device)
    got = gpu_timer(lp, adapter, **kw)
    cpu_adapter = load_lm_adapter(arpa_path, load_tokenizer(vocab_path), device="cpu")
    t0 = time.time()
    want = beam_search_device(lp.cpu(), cpu_adapter, **kw)
    cpu_s = time.time() - t0
    diff = check_live_beams("-lm decode, card against CPU", got, want)
    log(f"  equal live beams ({int((want[2] > -1e29).sum())}, best of "
        f"{int(want[1][0])} tokens); scores within {diff:.2e} relative; card "
        f"{gpu_timer.seconds[0]:.3f} s, CPU {cpu_s:.3f} s")

    _, lengths = chunk_starts_and_lengths(N_FRAMES, SEQ, OVERLAP)
    label_frames = sum(-(-int(n) // cfg.subsampling_factor) for n in lengths)
    beam_s = sum(timers["beam"].seconds)
    result = {
        "card": card, "arpa_ngrams_by_order": counts, "arpa_mb": arpa_mb,
        "arpa_load_s": timers["load"].seconds[0], "table_bytes": adapter.lm.table_bytes(),
        "frames_stitched": int(n_valid), "frames_kept_by_collapse": int(n_kept),
        "pseudo_label_beam_ms_per_window": beam_s / N_WINDOWS * 1e3,
        "pseudo_label_beam_ms_by_window": [t * 1e3 for t in timers["beam"].seconds],
        "pseudo_label_beam_ms_per_frame": beam_s / label_frames * 1e3,
        "final_decode_s": timers["decode"].seconds[0],
        "final_decode_ms_per_kept_frame": timers["decode"].seconds[0] / int(n_kept) * 1e3,
        "record_wall_s": detail["elapsed_times"][0],
        "adapt_ms_per_window": out.elapsed / N_WINDOWS * 1e3,
        "adapt_ms_per_window_without_beam": (out.elapsed - beam_s) / N_WINDOWS * 1e3,
        "phase_5b_ms_per_window": pallas_profile["ms_per_window"],
        "check_frames": int(lp.shape[0]), "check_card_s": gpu_timer.seconds[0],
        "check_cpu_s": cpu_s, "check_max_rel_score_diff": diff, "wer": wer,
    }
    for key, val in result.items():
        if key != "pseudo_label_beam_ms_by_window":
            log(f"  {key}: {val}")
    print(json.dumps({"lm_path": result}))
    return launches, routes


def write_transformer_lm(directory, vocab, seed=0):
    """Phase 14's LM: seeded weights at the published lming shape over
    ``vocab`` pieces, written as a DLM1 file and as a lming torch pickle
    (DDP prefixes, its config naming the head count); both files are read
    back and must give the weights bit for bit.  Returns (DLM1 path, pickle
    path, config, parameter count, seconds to write and read both)."""
    from dynamic_asr_eval_tpu_torch.lm.loader import (
        load_lm_checkpoint,
        load_lm_torch_checkpoint,
        save_lm_checkpoint,
    )
    from dynamic_asr_eval_tpu_torch.lm.transformer_lm import TransformerLMConfig, init_lm

    t0 = time.time()
    cfg = TransformerLMConfig(vocab_size=vocab, n_heads=TLM_HEADS)
    state = init_lm(cfg, seed=seed).state_dict()
    dlm, pt = os.path.join(directory, "tlm.dlm"), os.path.join(directory, "tlm.pt")
    save_lm_checkpoint(dlm, state, cfg)
    torch.save({"model": {f"module.{k}": v for k, v in state.items()},
                "config": {"model": {"n_heads": TLM_HEADS}}}, pt)
    (from_dlm, dlm_cfg), (from_pt, pt_cfg) = (
        load_lm_checkpoint(dlm), load_lm_torch_checkpoint(pt, verbose=False))
    for what, model in (("DLM1", from_dlm), ("torch pickle", from_pt)):
        loaded = model.state_dict()
        if loaded.keys() != state.keys() or not all(torch.equal(loaded[k], v)
                                                    for k, v in state.items()):
            raise AssertionError(f"transformer LM {what}: the reloaded weights differ")
    if dlm_cfg != cfg or pt_cfg != cfg:
        raise AssertionError(f"transformer LM configs {dlm_cfg}, {pt_cfg} != {cfg}")
    return dlm, pt, cfg, sum(v.numel() for v in state.values()), time.time() - t0


def tlm_path(tmp, card, kernel_modules, expect):
    """Phase 14: ``evals.run.main -lm <DLM1>`` at flagship width on a
    TLM_WINDOWS-window recording; returns the kernels' launches ({module:
    (fwd, bwd)}) and, for the modules with routes, the launches by route."""
    import argparse

    import dynamic_asr_eval_tpu_torch.evals.common as common
    import dynamic_asr_eval_tpu_torch.tta.runner as runner
    from dynamic_asr_eval_tpu_torch.lm.loader import load_lm_adapter
    from dynamic_asr_eval_tpu_torch.ops.beam_search import (
        TransformerLMAdapter,
        beam_search_device,
        collapse_blank_frames_device,
    )
    from dynamic_asr_eval_tpu_torch.ops.chunk import chunk_starts_and_lengths
    from dynamic_asr_eval_tpu_torch.text import load_tokenizer

    vocab_path = write_vocab(tmp)
    tokenizer = load_tokenizer(vocab_path)
    dlm, pt, lm_cfg, n_params, files_s = write_transformer_lm(tmp, tokenizer.vocab_size())
    log(f"  transformer LM {lm_cfg.n_layers} x {lm_cfg.d_model}, {lm_cfg.n_heads} heads, cache "
        f"{lm_cfg.max_cache_length}, vocabulary {lm_cfg.vocab_size}: {n_params} parameters; "
        f"DLM1 {os.path.getsize(dlm) / 1e6:.1f} MB and torch pickle written and read back bit for "
        f"bit in {files_s:.2f} s")
    cfg = flagship_config(subsampling_impl="pallas")
    timers = {"load": Timed(common.load_lm_adapter), "beam": Timed(runner.beam_search_device),
              "decode": Timed(common.decode_output)}
    originals = common.load_lm_adapter, runner.beam_search_device, common.decode_output
    common.load_lm_adapter, runner.beam_search_device, common.decode_output = (
        timers["load"], timers["beam"], timers["decode"])
    try:
        wer, wall, launches, routes, detail, recorder = main_path(
            cfg, kernel_modules,
            flags=("--tokenizer", vocab_path, "-lm", dlm, "--beams", str(LM_BEAMS)),
            kwargs=(f"lm_tta_beams={LM_TTA_BEAMS}",), frames=TLM_FRAMES)
    finally:
        common.load_lm_adapter, runner.beam_search_device, common.decode_output = originals
    check_launches(launches, expect, windows=TLM_WINDOWS, exact=True)
    check_routes("transformer-LM path", launches, routes)
    check_driver_output(cfg, wer, detail, recorder, frames=TLM_FRAMES)
    engine, (out,) = recorder.engine, recorder.outputs
    adapter = engine.lm_adapter
    if not isinstance(adapter, TransformerLMAdapter) or engine.config.lm_tta_beams != LM_TTA_BEAMS:
        raise AssertionError(f"the NSTI engine runs with {type(adapter).__name__} and "
                             f"lm_tta_beams={engine.config.lm_tta_beams}, not the transformer LM")
    if adapter.device.type != "cuda" or adapter.config.compute_dtype != torch.float32:
        raise AssertionError(f"the LM on {adapter.device} in {adapter.config.compute_dtype}")
    if len(timers["beam"].seconds) != TLM_WINDOWS or len(timers["decode"].seconds) != 1:
        raise AssertionError(f"{len(timers['beam'].seconds)} pseudo-label beams and "
                             f"{len(timers['decode'].seconds)} final decodes, expected "
                             f"{TLM_WINDOWS} and 1")
    hyp = detail["model_output"][0]
    if not hyp.strip():
        raise AssertionError("the transformer-LM decode gave an empty transcript")
    log(f"  WER {wer}; launches {launches}; by route {routes}; evals.run wall {wall:.3f} s; "
        f"transcript of {len(hyp.split())} words; the LM on {adapter.device}, f32")

    log(f"  the card's beam against the CPU's on the first {LM_CHECK_FRAMES} collapsed frames")
    kw = dict(common.lm_kwargs(argparse.Namespace()), beam_width=LM_BEAMS)
    n_valid = (out.counts > 0).sum()
    lp_c, n_kept = collapse_blank_frames_device(out.logits, threshold=0.99, valid_frames=n_valid)
    lp = lp_c[: min(int(n_kept), LM_CHECK_FRAMES)]
    gpu_timer = Timed(beam_search_device)
    advances = []  # frames on which the LM advanced in the card's search
    adapter.advance = lambda *a, advance=adapter.advance: advances.append(1) or advance(*a)
    try:
        got = gpu_timer(lp, adapter, **kw)
    finally:
        del adapter.advance
    cpu_adapter = load_lm_adapter(pt, tokenizer, device="cpu")  # the pickle of the same weights
    t0 = time.time()
    want = beam_search_device(lp.cpu(), cpu_adapter, **kw)
    cpu_s = time.time() - t0
    diff = check_live_beams("transformer-LM decode, card against CPU", got, want, rel=TLM_RTOL)
    if not advances:
        raise AssertionError("the LM never advanced in the compared searches")
    log(f"  equal live beams ({int((want[2] > -1e29).sum())}, best of {int(want[1][0])} tokens); "
        f"scores within {diff:.2e} relative; the LM advanced on {len(advances)} of "
        f"{lp.shape[0]} frames; card {gpu_timer.seconds[0]:.3f} s, CPU {cpu_s:.3f} s")

    _, lengths = chunk_starts_and_lengths(TLM_FRAMES, SEQ, OVERLAP)
    label_frames = sum(-(-int(n) // cfg.subsampling_factor) for n in lengths)
    beam_s = sum(timers["beam"].seconds)
    L, H, N, D = lm_cfg.n_layers, lm_cfg.n_heads, lm_cfg.max_cache_length, lm_cfg.head_dim
    result = {
        "card": card, "lm_shape": [L, lm_cfg.d_model, H, N, lm_cfg.vocab_size],
        "lm_params": n_params, "lm_param_bytes": n_params * 4,
        "cache_bytes_per_beam": 2 * L * H * N * D * 4,
        "cache_bytes_b20": 2 * L * LM_BEAMS * H * N * D * 4,
        "lm_load_s": timers["load"].seconds[0], "lm_files_s": files_s,
        "windows": TLM_WINDOWS, "frames_stitched": int(n_valid),
        "frames_kept_by_collapse": int(n_kept),
        "pseudo_label_beam_ms_per_window": beam_s / TLM_WINDOWS * 1e3,
        "pseudo_label_beam_ms_by_window": [t * 1e3 for t in timers["beam"].seconds],
        "pseudo_label_beam_ms_per_frame": beam_s / label_frames * 1e3,
        "final_decode_s": timers["decode"].seconds[0],
        "final_decode_ms_per_kept_frame": timers["decode"].seconds[0] / int(n_kept) * 1e3,
        "record_wall_s": detail["elapsed_times"][0],
        "adapt_ms_per_window_without_beam": (out.elapsed - beam_s) / TLM_WINDOWS * 1e3,
        "check_frames": int(lp.shape[0]), "check_card_s": gpu_timer.seconds[0],
        "check_cpu_s": cpu_s, "check_max_rel_score_diff": diff,
        "check_lm_advances": len(advances), "transcript_words": len(hyp.split()), "wer": wer,
    }
    for key, val in result.items():
        if key != "pseudo_label_beam_ms_by_window":
            log(f"  {key}: {val}")
    print(json.dumps({"tlm_path": result}))
    return launches, routes


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


def warm_run_ms(recorder) -> float:
    """One run of the driver's engine on its recording and weights (warm
    after the driver's own run), in ms of wall time."""
    engine, ((params, spec),) = recorder.engine, recorder.calls
    torch.cuda.synchronize()
    t0 = time.time()
    engine(params, spec, SEQ, OVERLAP, rng=0)
    torch.cuda.synchronize()
    return (time.time() - t0) * 1e3


# phase 5c's driver runs: (attention_impl, subsampling_impl), f32
F32_RUNS = {"pallas_flash": ("pallas_flash", "conv"), "xla": ("xla", "conv"),
            "pallas_subsampling": ("pallas_flash", "pallas")}


def f32_path(card, A, S):
    """Phase 5c: the flagship NSTI in f32 through ``evals.run.main``, three
    driver runs, cuDNN deterministic in each: ``"pallas_flash"`` (the f32
    attention kernels, ``"conv"`` subsampling), ``"xla"`` (plain attention,
    ``"conv"``) and ``"pallas_subsampling"`` (the f32 attention kernels and
    the f32 subsampling kernels, ``"pallas"``).  Launches exactly n_layers
    attention forwards and backwards per window on the f32 route in both
    kernel runs, exactly 1 / 1 subsampling launches per window on it in the
    third, none in ``"xla"``; the stitched log-probs of the other two runs
    within 1e-3 of max |log-prob| of ``"pallas_flash"``'s, equal greedy ids
    (the windows are multiples of 8, where the fused kernels' unmasked
    semantics and ``"conv"``'s masks agree); then each engine's warm walls
    (cuDNN's own algorithms).  Returns the f32-route (fwd, bwd) launches by
    kernel: the attention's of ``"pallas_flash"``, the subsampling's of
    ``"pallas_subsampling"``."""
    import numpy as np

    from dynamic_asr_eval_tpu_torch.device import deterministic_cudnn

    runs, route = {}, A.ROUTES[torch.float32]
    for name, (attention, subsampling) in F32_RUNS.items():
        cfg = flagship_config(compute_dtype=torch.float32, attention_impl=attention,
                              subsampling_impl=subsampling)
        modules = {"attention": A} if subsampling == "conv" else {"attention": A, "subsample": S}
        with deterministic_cudnn():
            wer, wall, launches, routes, detail, recorder = main_path(cfg, modules)
        check_driver_output(cfg, wer, detail, recorder)
        runs[name] = (recorder, routes, wall)
    per_window = (cfg.n_layers * N_WINDOWS, cfg.n_layers * N_WINDOWS)
    want = {r: (per_window if r == route else (0, 0)) for r in A.ROUTES.values()}
    kernel_routes, plain_routes = runs["pallas_flash"][1], runs["xla"][1]
    fused_routes = runs["pallas_subsampling"][1]
    if (kernel_routes["attention"] != want or fused_routes["attention"] != want
            or any(c != (0, 0) for c in plain_routes["attention"].values())):
        raise AssertionError(f"f32 path: attention launches by route {kernel_routes['attention']}"
                             f" and {fused_routes['attention']} (expected {want}), on the xla "
                             f"path {plain_routes['attention']}")
    sub_route = S.ROUTES[torch.float32]
    sub_want = {r: ((N_WINDOWS, N_WINDOWS) if r == sub_route else (0, 0))
                for r in S.ROUTES.values()}
    if fused_routes.get("subsample") != sub_want:
        raise AssertionError(f"f32 path: subsampling launches by route "
                             f"{fused_routes.get('subsample')} (expected {sub_want})")
    base = runs["pallas_flash"][0].outputs[0]
    lp_base = base.numpy_logits()
    scale = float(np.abs(lp_base).max())
    errs = {}
    for name in ("xla", "pallas_subsampling"):
        other = runs[name][0].outputs[0]
        lp = other.numpy_logits()
        same_ids = lp.shape == lp_base.shape and np.array_equal(other.greedy_ids(),
                                                                 base.greedy_ids())
        errs[name] = float(np.abs(lp - lp_base).max()) if lp.shape == lp_base.shape else math.inf
        if not (errs[name] <= 1e-3 * scale and same_ids):
            raise AssertionError(f"f32 path, {name} vs the kernel attention run: "
                                 f"{errs[name]:.3e} (max |log-prob| {scale:.3e}), greedy ids "
                                 f"equal {same_ids}")
    log(f"  attention launches {kernel_routes['attention']} ({route}: {cfg.n_layers} / "
        f"{cfg.n_layers} per window), subsampling launches {fused_routes['subsample']} "
        f"({sub_route}: 1 / 1 per window); stitched log-probs against the pallas_flash run: xla "
        f"{errs['xla']:.2e}, pallas_subsampling {errs['pallas_subsampling']:.2e} (max "
        f"|log-prob| {scale:.3e}); greedy ids equal")
    result = {"card": card, "frames": N_FRAMES, "windows": N_WINDOWS, "route": route,
              "launches": kernel_routes["attention"][route],
              "subsample_route": sub_route,
              "subsample_launches": fused_routes["subsample"][sub_route],
              "max_abs_err": errs["xla"], "pallas_subsampling_max_abs_err":
                  errs["pallas_subsampling"], "max_abs_log_prob": scale}
    for name, (recorder, _, wall) in runs.items():
        walls = [warm_run_ms(recorder) for _ in range(TIMED_RUNS)]
        result[name] = {"driver_wall_s": wall, "engine_walls_ms": walls,
                        "ms_per_window": min(walls) / N_WINDOWS,
                        "rtfx": N_FRAMES / 100.0 / (min(walls) / 1e3)}
        log(f"  {name}: engine walls {walls} ms, {min(walls) / N_WINDOWS:.2f} ms per window, "
            f"RTFx {result[name]['rtfx']:.2f}")
    print(json.dumps({"f32_path": result}))
    return {"flash_attention_f32": kernel_routes["attention"][route],
            "fused_subsample_f32": fused_routes["subsample"][sub_route]}


def profile_engine(recorder, card, path):
    """Where the time of one recording goes: the driver's engine, warm, on
    the same recording and weights, timed TIMED_RUNS times, then once under
    torch.profiler.  Device busy time is the sum of kernel times (ranges
    that annotate kernels are left out); the idle share is ``1 - busy /
    wall`` against the fastest timed run."""
    from collections import defaultdict

    walls_ms = [warm_run_ms(recorder) for _ in range(TIMED_RUNS)]
    wall_ms = min(walls_ms)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        warm_run_ms(recorder)
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
    return result


def drive(label, cfg, kernel_modules, expect, card, check_model):
    log(f"[5{label}] main path: evals.run.main, NSTI on a {N_FRAMES}-frame recording, flagship, "
        f"bf16, subsampling_impl={cfg.subsampling_impl!r}")
    wer, wall, launches, routes, detail, recorder = main_path(cfg, kernel_modules)
    check_launches(launches, expect)
    check_routes("NSTI", launches, routes)
    log(f"  WER {wer}; launches {launches}; by route {routes}; evals.run wall {wall:.3f} s "
        f"(record {detail['elapsed_times'][0]:.3f} s, first run: includes warm-up)")
    log(f"[6{label}] output checks")
    params = check_driver_output(cfg, wer, detail, recorder)
    model_launches = check_model(params)
    log(f"[7{label}] where the time goes: the driver's engine, warm, on {card}")
    profile = profile_engine(recorder, card, f"subsampling_{cfg.subsampling_impl}")
    return launches, routes, model_launches, profile


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
    check_attention(A, 2, 300, 2, ODD_HEAD_DIM, [300, 177], torch.float32)
    check_attention(A, 2, 2048, 6, 128, None, torch.bfloat16)
    check_attention(A, 2, 37, 6, 128, [37, 20], torch.bfloat16)
    for length in (2048, 1792):  # AWMC's batch-1 windows
        check_attention(A, 1, 2048, 6, 128, [length], torch.bfloat16)
    # the protocol drivers' evaluation engine: forwards of infer_batch 4
    # windows, the last of a recording 14336 frames, and a ragged batch
    for lengths in ([2048, 2048, 2048, 1792], [2048, 2048, 2048, 1100]):
        check_attention(A, 4, 2048, 6, 128, lengths, torch.bfloat16)
    for dtype in (torch.bfloat16, torch.float32):
        errs[("sub", dtype)] = check_subsample(S, SUB_FLAGSHIP, dtype)
        check_subsample(S, SUB_RAGGED, dtype)
    for batch in (1, 4):  # AWMC's windows; the evaluation engine's batches
        check_subsample(S, (batch,) + SUB_FLAGSHIP[1:], torch.bfloat16)
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
            ("softdtw", time_softdtw(D, card))):
        times[name] = (t, bnd)
        for k, v in t.items():
            log(f"  {name} {k}: {v:.4f} ms")
        for k, (ms, by) in bnd.items():
            log(f"  {name} bound {k}: {ms * 1e3:.2f} us ({by})")
    library_kernels = sdpa_kernels(A, torch.float32)
    subsample_breakdown(S, card)

    attn_per_window = (flagship_config().n_layers, flagship_config().n_layers)
    _, routes, parity_launches, _ = drive("", flagship_config(), {"attention": A},
                                          {"attention": attn_per_window}, card,
                                          lambda params: check_attention_model(params, A))
    _, pallas_routes, sub_parity_launches, pallas_profile = drive(
        "b", flagship_config(subsampling_impl="pallas"), {"attention": A, "subsample": S},
        {"attention": attn_per_window, "subsample": (1, 1)}, card,
        lambda params: check_subsample_model(params, S))
    log(f"[5c] the f32 path: evals.run.main, NSTI on the {N_FRAMES}-frame recording, flagship, "
        f"f32: the f32 attention kernels with subsampling_impl='conv', xla attention with 'conv', "
        f"and the f32 attention and subsampling kernels ('pallas'), on {card}")
    f32_path_launches = f32_path(card, A, S)

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

    from dynamic_asr_eval_tpu_torch.evals import run_dynamic_eval_full

    with tempfile.TemporaryDirectory() as tmp:
        log("[9] checkpoints at flagship width: DAE1 and a reference torch pickle")
        dae = check_checkpoints(tmp)
        log(f"[10] AWMC main path: evals.run_dynamic_eval_full.main --awmc --checkpoint (DAE1), "
            f"{N_FRAMES}-frame recording, flagship, bf16")
        awmc_modules = {"attention": A, "subsample": S, "softdtw": D}
        wer, wall, launches, awmc_routes, detail, recorder = main_path(
            None, awmc_modules, run_dynamic_eval_full, ("--awmc", "--checkpoint", dae))
        cfg = recorder.engine.model.config
        log(f"  WER {wer}; launches {launches}; by route {awmc_routes}; driver wall {wall:.3f} s "
            f"(record {detail['elapsed_times'][0]:.3f} s, first run: includes warm-up)")
        params = check_awmc_run(cfg, launches, awmc_routes, wer, detail, recorder)
        log("[10b] AWMC parity: full-depth f32 engine, kernels against the plain path")
        awmc_parity_routes = check_awmc_parity(params, A, S)
        log(f"[11] where AWMC's time goes: the driver's engine, warm, on {card}")
        profile_engine(recorder, card, "awmc")
        del recorder

        log("[12] native host libraries: g++ builds, and the native WER against the Python DP")
        check_native_libraries(card)
        log(f"[13] the -lm path: evals.run.main, NSTI with lm_tta_beams={LM_TTA_BEAMS} and a "
            f"{LM_BEAMS}-beam final decode, on the {N_FRAMES}-frame recording, flagship, bf16, "
            f"subsampling_impl='pallas', on {card}")
        lm_counts, lm_routes = lm_path(tmp, card, {"attention": A, "subsample": S, "softdtw": D},
                                       pallas_profile,
                                       {"attention": attn_per_window, "subsample": (1, 1)})
        log(f"[14] the transformer-LM path: evals.run.main -lm <DLM1>, NSTI with lm_tta_beams="
            f"{LM_TTA_BEAMS} and a {LM_BEAMS}-beam final decode, on a {TLM_FRAMES}-frame "
            f"recording ({TLM_WINDOWS} windows), flagship, bf16, subsampling_impl='pallas', "
            f"on {card}")
        tlm_counts, tlm_routes = tlm_path(tmp, card, {"attention": A, "subsample": S, "softdtw": D},
                                          {"attention": attn_per_window, "subsample": (1, 1)})
        log(f"[15] the consistency path: evals.run_dynamic_eval_full.main --consistency "
            f"--checkpoint (DAE1), offline, {N_FRAMES}-frame recording, flagship, bf16")
        torch.cuda.reset_peak_memory_stats()
        wer, wall, cons_counts, cons_routes, detail, recorder = main_path(
            None, awmc_modules, run_dynamic_eval_full, ("--consistency", "--checkpoint", dae),
            kwargs=("online=false",))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        cfg = recorder.engine.model.config
        log(f"  WER {wer}; launches {cons_counts}; by route {cons_routes}; driver wall {wall:.3f} "
            f"s (record {detail['elapsed_times'][0]:.3f} s, first run: includes warm-up); peak "
            f"device memory {peak_gb:.2f} GB")
        check_consistency_run(cfg, cons_counts, cons_routes, wer, detail, recorder)
        log(f"  every chunk's weights moved; {N_WINDOWS} chunks' weights returned")
        log(f"[15b] where the consistency engine's time goes: the driver's engine, warm, on {card}")
        profile_engine(recorder, card, "consistency")
        del recorder
        log("[15c] consistency parity: f32 engine at flagship widths, kernels against the plain "
            "path")
        cons_parity_routes = check_consistency_parity(A, S)

    protocol_runs = protocol_phases(card, A, S, D)

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
    # launches on the NSTI path (by route: attention in the "conv" run,
    # subsampling in the "pallas" run; soft-DTW: its own path), on the AWMC
    # path (phase 10), the -lm path (phase 13), the transformer-LM path
    # (phase 14) and the consistency path (phase 15); the f32 routes are the
    # parity routes and run 0 times there, their counts in the f32 runs of
    # phases 6 and 6b go under "parity_launches", of phase 10b under
    # "awmc_parity_launches", of phase 15c under "consistency_parity_launches",
    # the f32 kernels' in phase 5c under "f32_path_launches"
    def by_kernel(routes_, counts_):
        return {"flash_attention": routes_["attention"]["tensor_core"],
                "flash_attention_f32": routes_["attention"][A.ROUTES[torch.float32]],
                "fused_subsample": routes_["subsample"]["tensor_core"],
                "fused_subsample_f32": routes_["subsample"][S.ROUTES[torch.float32]],
                "softdtw": counts_["softdtw"]}

    nsti_launches = by_kernel({"attention": routes["attention"],
                               "subsample": pallas_routes["subsample"]}, {"softdtw": sdtw_launches})
    parity = {"flash_attention_f32": parity_launches, "fused_subsample_f32": sub_parity_launches}
    awmc_launches = by_kernel(awmc_routes, launches)
    lm_launches = by_kernel(lm_routes, lm_counts)
    tlm_launches = by_kernel(tlm_routes, tlm_counts)
    consistency_launches = by_kernel(cons_routes, cons_counts)
    protocol_launches = {}  # phases 16, 16b and 16c together
    for counts_, routes_ in protocol_runs:
        for name, counts in by_kernel(routes_, counts_).items():
            protocol_launches[name] = tuple(
                a + b for a, b in zip(protocol_launches.get(name, (0, 0)), counts))
    awmc_parity = {"flash_attention_f32": awmc_parity_routes["attention"],
                   "fused_subsample_f32": awmc_parity_routes["subsample"]}
    consistency_parity = {"flash_attention_f32": cons_parity_routes["attention"],
                          "fused_subsample_f32": cons_parity_routes["subsample"]}
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
            extra = ({"parity_launches": parity[name][i],
                      "awmc_parity_launches": awmc_parity[name][i],
                      "consistency_parity_launches": consistency_parity[name][i]}
                     if name in parity else {})
            if name in f32_path_launches:
                extra.update(f32_path_launches=f32_path_launches[name][i],
                             bound_cuda_core_ms=bnd[f"{kind}_cuda_core"][0])
            if name == "flash_attention_f32":
                extra.update(library_kernels=library_kernels[kind])
            if name == "softdtw":
                extra.update(chain_floor_ms=bnd[f"{kind}_chain"][0])
            kernels.append({
                "name": f"{name}_{kind}",
                "route": "cuda",
                "source": f"dynamic_asr_eval_tpu_torch/kernels/csrc/{sources[name]}",
                "replaces": replaces[(name, kind)],
                "launches": nsti_launches[name][i],
                "awmc_launches": awmc_launches[name][i],
                "lm_launches": lm_launches[name][i],
                "tlm_launches": tlm_launches[name][i],
                "consistency_launches": consistency_launches[name][i],
                "protocol_launches": protocol_launches[name][i],
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
