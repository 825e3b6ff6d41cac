"""Time variants of an f32 kernel source side by side on one card.

    python -m dynamic_asr_eval_tpu_torch.kernels.attention_variants \\
        [--module attention|subsample|softdtw] [--steps 16 32] [--parent DIR] \\
        [--sources NAME=PATH ...] [--unchecked NAME=PATH ...] [--shape N ...]

Builds the module's f32 source as it stands (``csrc/flash_attention.cu`` for
``--module attention``, the default; ``csrc/fused_subsample.cu`` for
``--module subsample``; ``csrc/softdtw.cu`` for ``--module softdtw``) and,
with ``--parent``, the same file from another
checkout (an earlier design of the f32 route), and any other sources named
with ``--sources``; for attention also, for each value of ``--steps``, a copy
with its step constant ``BN`` (rows of the other side per step) replaced.
The copies go under ``build/variants/``, one ``nvcc`` each, all started
together.  Each is bound with the module's ``_bind``, held against the plain
version at the module's shape, or at ``--shape`` (f32, TF32 off, 1e-4 of
max |plain|):

- attention: q/k/v [B, T, H, D] = [2, 2048, 6, 128], every sequence but the
  last whole and the last 25/32 of it (lengths [2048, 1600]); out, dq, dk,
  dv;
- subsample: x [B, T, F] = [2, 16384, 80], C 256; out, gx and the 10 weight
  gradients (the timed backward takes no gx, as on the drivers' path);
- softdtw: D [B, N, M] = [4, 256, 256], the squared distances of
  standard-normal 64-dim features, γ 1; R (relative, as chip_smoke.py holds
  it) and E (of max |E|), every variant's backward given the plain version's
  R; no yardstick (no PyTorch call computes soft-DTW);

and timed forward and backward with CUDA events after warm-up, in turns
(every variant, then every variant in reverse order), beside the PyTorch
yardstick on the same inputs (SDPA in f32; the ``"conv"`` path's cuDNN stack
in f32).  Sources named with ``--unchecked`` are timed with their errors
reported but not held to the bar: copies that drop one phase of a kernel
(the products, a tile build) to find where its time goes.  For the
subsampling each variant's forward and backward is also
broken down by kernel under torch.profiler.  Prints the card line, the
ptxas report of each build and one JSON line.  A design-time measurement:
the port never calls it.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from dynamic_asr_eval_tpu_torch.kernels import attention as A
from dynamic_asr_eval_tpu_torch.kernels import softdtw as SD
from dynamic_asr_eval_tpu_torch.kernels import subsample as S
from dynamic_asr_eval_tpu_torch.kernels._build import BUILD_DIR, CudaLibrary
from dynamic_asr_eval_tpu_torch.perf import profile_kernels

VARIANT_DIR = BUILD_DIR.parent / "variants"
SOURCES = {"attention": "flash_attention.cu", "subsample": "fused_subsample.cu",
           "softdtw": "softdtw.cu"}


def variant_sources(module, steps, parent, others=()):
    """{name: source path}: the checkout's source, one copy per step
    (attention), the parent's source, then ``others`` ("name=path" each)."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    here = A.CSRC / SOURCES[module]
    text = here.read_text()
    sources = {"current": here}
    for bn in steps:
        if module != "attention":
            raise ValueError("--steps replaces the attention source's BN only")
        new, n = re.subn(r"constexpr int BN = \d+;", f"constexpr int BN = {bn};", text)
        if n != 1:
            raise ValueError("the source has no single `constexpr int BN = ...;` line")
        path = VARIANT_DIR / f"flash_attention_bn{bn}.cu"
        path.write_text(new)
        sources[f"bn{bn}"] = path
    if parent:
        path = VARIANT_DIR / f"{Path(SOURCES[module]).stem}_parent.cu"
        shutil.copyfile(Path(parent) / "dynamic_asr_eval_tpu_torch/kernels/csrc" / SOURCES[module],
                        path)
        sources["parent"] = path
    for item in others:
        name, path = item.split("=", 1)
        sources[name] = Path(path)
    return sources


def events_ms(fn, iters=20, warmup=3):
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


def rel_errs(names, got, want):
    return {n: ((a - b).abs().max() / b.abs().max()).item() for n, a, b in zip(names, got, want)}


class AttentionCase:
    """The f32 flash attention's entry points at the flagship shape."""

    bind = staticmethod(A._bind)
    SHAPE = (2, 2048, 6, 128)  # B, T, H, D

    def __init__(self, shape=None):
        g = torch.Generator(device="cuda").manual_seed(1)
        self.shape = tuple(shape or self.SHAPE)
        B, T, H, D = self.shape
        self.lengths = [T] * (B - 1) + [T * 25 // 32]
        qkv = torch.randn(B, T, 3, H, D, generator=g, device="cuda")
        self.q, self.k, self.v = (x.contiguous() for x in qkv.unbind(2))
        self.mask = (torch.arange(T, device="cuda")[None]
                     < torch.tensor(self.lengths, device="cuda")[:, None])
        self.seg = self.mask.to(torch.int32).contiguous()
        self.dout = torch.randn(B, T, H, D, generator=g, device="cuda")
        ref_out, ref_lse = A.attention_reference(self.q, self.k, self.v, self.mask)
        self.ref = [ref_out] + list(A.attention_reference_bwd(self.q, self.k, self.v, self.mask,
                                                              ref_out, ref_lse, self.dout))

    def _call(self, lib, which, *tensors):
        B, T, H, D = self.q.shape
        q, k, v = self.q, self.k, self.v
        code = getattr(lib.load(), f"dae_flash_attention_{which}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], self.seg.data_ptr(), *(t.data_ptr() for t in tensors), B, H, T, D,
            1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
        lib.check(code, f"flash attention {which}")

    def outputs(self, lib):
        """(fwd, bwd) callables on this variant's own output buffers, and its
        errors against the plain version."""
        B, T, H, _ = self.shape
        out, lse = torch.empty_like(self.q), torch.empty(B, H, T, device="cuda")
        delta, grads = torch.empty(B, H, T, device="cuda"), [torch.empty_like(self.q) for _ in range(3)]
        fwd = lambda: self._call(lib, "fwd", out, lse)  # noqa: E731
        bwd = lambda: self._call(lib, "bwd", out, self.dout, lse, delta, *grads)  # noqa: E731
        fwd()
        bwd()
        torch.cuda.synchronize()
        return fwd, bwd, rel_errs(("out", "dq", "dk", "dv"), [out] + grads, self.ref)

    def report(self, calls):
        return {"lengths": self.lengths}

    def library(self):
        same = A._same_segment(self.mask)
        qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (self.q, self.k, self.v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        out = sdpa(qs, ks, vs, attn_mask=same)
        return "sdpa_f32_ms", {
            "fwd": lambda: sdpa(qs, ks, vs, attn_mask=same),
            "bwd": lambda: torch.autograd.grad(out, (qs, ks, vs), self.dout.transpose(1, 2),
                                               retain_graph=True)}


class SubsampleCase:
    """The f32 fused subsampling's entry points at the flagship window."""

    bind = staticmethod(S._bind)
    SHAPE = (2, 16384, 80, 256)  # B, T, F, C

    def __init__(self, shape=None):
        g = torch.Generator(device="cuda").manual_seed(1)
        self.shape = tuple(shape or self.SHAPE)
        B, T, F, C = self.shape
        self.x = torch.randn(B, T, F, generator=g, device="cuda")
        shapes = {"k9": (9, C), "dw1": (9, C), "dw2": (9, C), "pw1": (C, C), "pw2": (C, C)}
        self.ws = []
        for name in S.WEIGHT_NAMES:
            scale = (1 / 3 if name in ("k9", "dw1", "dw2")
                     else (C ** -0.5 if name.startswith("pw") else 0.1))
            self.ws.append(torch.randn(shapes.get(name, (C,)), generator=g, device="cuda") * scale)
        self.g = torch.randn(B, S.ceil_chain(T)[2], F // 8, C, generator=g, device="cuda")
        self.w = S._pack(self.ws)
        ref_gx, ref_gws = S.fused_subsample_reference_bwd(self.x, self.ws, self.g, "silu", True)
        self.ref = [S.fused_subsample_reference(self.x, *self.ws), ref_gx] + ref_gws

    def outputs(self, lib):
        B, T, F, C = self.shape
        so = lib.load()
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty(self.ref[0].shape, device="cuda")  # the plain version's is a permuted view
        fwork = torch.empty(so.dae_fused_subsample_workspace(0, 0, B, T, F, C), dtype=torch.uint8,
                            device="cuda")
        bwork = torch.empty(so.dae_fused_subsample_workspace(0, 1, B, T, F, C), dtype=torch.uint8,
                            device="cuda")
        gw, gx = torch.empty_like(self.w), torch.empty_like(self.x)

        def fwd():
            lib.check(so.dae_fused_subsample_fwd(0, 0, self.x.data_ptr(), B, T, F, C,
                                                 self.w.data_ptr(), out.data_ptr(),
                                                 fwork.data_ptr(), stream), "subsampling fwd")

        def bwd(with_gx=False):
            lib.check(so.dae_fused_subsample_bwd(0, 0, self.x.data_ptr(), self.g.data_ptr(), B, T,
                                                 F, C, self.w.data_ptr(),
                                                 gx.data_ptr() if with_gx else None,
                                                 gw.data_ptr(), bwork.data_ptr(), stream),
                      "subsampling bwd")

        fwd()
        bwd(True)
        torch.cuda.synchronize()
        grads = [t.view(w.shape) for t, w in zip(torch.split(gw, [w.numel() for w in self.ws]),
                                                  self.ws)]
        errs = rel_errs(("out", "gx") + S.WEIGHT_NAMES, [out, gx] + grads, self.ref)
        return fwd, bwd, errs

    def report(self, calls):
        """Each variant's forward and backward by kernel."""
        return {"by_kernel": {name: {"fwd": profile_kernels(fwd), "bwd": profile_kernels(bwd)}
                              for name, (fwd, bwd, _) in calls.items()}}

    def library(self):
        """The ``"conv"`` path's cuDNN stack (no masks), f32."""
        F_ = torch.nn.functional
        C = self.shape[3]
        k9, b0, dw1, bdw1, pw1, bpw1, dw2, bdw2, pw2, bpw2 = self.ws
        w = [k9.t().reshape(C, 1, 3, 3), b0]
        for dw, bdw, pw, bpw in ((dw1, bdw1, pw1, bpw1), (dw2, bdw2, pw2, bpw2)):
            w += [dw.t().reshape(C, 1, 3, 3), bdw, pw.t()[:, :, None, None], bpw]
        w = [t.detach().requires_grad_(True) for t in w]

        def stack():
            h = F_.silu(F_.conv2d(self.x[:, None], w[0], w[1], stride=2, padding=1))
            for i in (2, 6):
                h = F_.conv2d(h, w[i], w[i + 1], stride=2, padding=1, groups=C)
                h = F_.silu(F_.conv2d(h, w[i + 2], w[i + 3]))
            return h

        out = stack()
        g = self.g.permute(0, 3, 1, 2).contiguous()
        return "cudnn_f32_ms", {"fwd": stack,
                                "bwd": lambda: torch.autograd.grad(out, w, g, retain_graph=True)}


class SoftdtwCase:
    """The soft-DTW kernels' entry points at the benchmark's shape."""

    bind = staticmethod(SD._bind)
    SHAPE = (4, 256, 256)  # B, N, M: kernels.softdtw.benchmark's defaults

    def __init__(self, shape=None):
        self.shape = tuple(shape or self.SHAPE)
        B, N, M = self.shape
        g = torch.Generator(device="cuda").manual_seed(1)
        x = torch.randn(B, N, 64, generator=g, device="cuda")
        y = torch.randn(B, M, 64, generator=g, device="cuda")
        self.D = SD.pairwise_sq_dist(x, y).contiguous()
        self.R = SD.forward_R_reference(self.D, 1.0)
        self.E = SD.backward_E_reference(self.D, self.R, 1.0)

    def outputs(self, lib):
        B, N, M = self.D.shape
        so = lib.load()
        stream = torch.cuda.current_stream().cuda_stream
        R, E = torch.empty_like(self.R), torch.empty_like(self.D)

        def fwd():
            lib.check(so.dae_softdtw_fwd(self.D.data_ptr(), R.data_ptr(), B, N, M, 1.0, stream),
                      "soft-DTW forward")

        def bwd():
            lib.check(so.dae_softdtw_bwd(self.D.data_ptr(), self.R.data_ptr(), E.data_ptr(), B, N,
                                         M, 1.0, stream), "soft-DTW backward")

        fwd()
        bwd()
        torch.cuda.synchronize()
        errs = {"R": ((R - self.R).abs() / self.R.abs().clamp_min(1.0)).max().item(),
                "E": ((E - self.E).abs().max() / self.E.abs().max()).item()}
        return fwd, bwd, errs

    def report(self, calls):
        return {}

    def library(self):
        return "library_ms", {}


CASES = {"attention": AttentionCase, "subsample": SubsampleCase, "softdtw": SoftdtwCase}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--module", choices=sorted(SOURCES), default="attention")
    ap.add_argument("--steps", type=int, nargs="*", default=[])
    ap.add_argument("--parent", default=None, help="another checkout's root")
    ap.add_argument("--sources", nargs="*", default=[], help="more variants, name=path each")
    ap.add_argument("--unchecked", nargs="*", default=[],
                    help="variants timed but not held to the plain version, name=path each")
    ap.add_argument("--shape", type=int, nargs="+", default=None,
                    help="the case's shape in place of the module's (B T H D, B T F C, B N M)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    case = CASES[args.module](args.shape)
    libs = {name: CudaLibrary(path, case.bind) for name, path in
            variant_sources(args.module, args.steps, args.parent,
                            args.sources + args.unchecked).items()}
    unchecked = {item.split("=", 1)[0] for item in args.unchecked}
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(lib.load) for lib in libs.values()]:
            fut.result()
    for name, lib in libs.items():
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {name}: {line.strip()}")

    calls = {}
    for name, lib in libs.items():
        fwd, bwd, errs = case.outputs(lib)
        if name not in unchecked and not max(errs.values()) <= 1e-4:
            raise AssertionError(f"{name}: {errs} of max |plain|")
        calls[name] = (fwd, bwd, errs)
        print(f"  {name}: max error {max(errs.values()):.2e} of max |plain|", flush=True)

    times = {name: {"fwd": [], "bwd": []} for name in libs}
    order = list(libs)
    for name in order + order[::-1]:
        fwd, bwd, _ = calls[name]
        times[name]["fwd"].append(events_ms(fwd))
        times[name]["bwd"].append(events_ms(bwd))
    key, library = case.library()
    result = {"card": card, "module": args.module, "shape": case.shape,
              "variants": {name: {"fwd_ms": times[name]["fwd"], "bwd_ms": times[name]["bwd"],
                                  "max_rel_err": calls[name][2], "checked": name not in unchecked}
                           for name in libs},
              key: {kind: events_ms(fn) for kind, fn in library.items()}, **case.report(calls)}
    print(json.dumps({f"{args.module}_variants": result}))


if __name__ == "__main__":
    main()
