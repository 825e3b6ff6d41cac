"""Time variants of the f32 attention source side by side on one card.

    python -m dynamic_asr_eval_tpu_torch.kernels.attention_variants \\
        [--steps 16 32] [--parent DIR] [--sources NAME=PATH ...]

Builds ``csrc/flash_attention.cu`` as it stands and, for each value of
``--steps``, a copy with its step constant ``BN`` (rows of the other side
per step) replaced; with ``--parent``, also the same file from another
checkout (an earlier design of the f32 route), and any other sources named
with ``--sources``.  The copies go under
``build/variants/``, one ``nvcc`` each, all started together.  Each is bound
with the attention module's ``_bind``, held against the plain version at the
flagship shape ([2, 2048, 6, 128], lengths [2048, 1600], f32, TF32 off:
1e-4 of max |plain|), and timed forward and backward with CUDA events after
warm-up, in turns (every variant, then every variant in reverse order),
beside SDPA in f32 on the same inputs.  Prints the card line, the ptxas
report of each build and one JSON line.  A design-time measurement: the
port never calls it.
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
from dynamic_asr_eval_tpu_torch.kernels._build import BUILD_DIR, CudaLibrary

VARIANT_DIR = BUILD_DIR.parent / "variants"
SHAPE, LENGTHS = (2, 2048, 6, 128), [2048, 1600]


def variant_sources(steps, parent, others=()):
    """{name: source path}: the checkout's source, one copy per step, the
    parent's source, then ``others`` ("name=path" each)."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    here = A.CSRC / "flash_attention.cu"
    text = here.read_text()
    sources = {"current": here}
    for bn in steps:
        new, n = re.subn(r"constexpr int BN = \d+;", f"constexpr int BN = {bn};", text)
        if n != 1:
            raise ValueError("the source has no single `constexpr int BN = ...;` line")
        path = VARIANT_DIR / f"flash_attention_bn{bn}.cu"
        path.write_text(new)
        sources[f"bn{bn}"] = path
    if parent:
        path = VARIANT_DIR / "flash_attention_parent.cu"
        shutil.copyfile(Path(parent) / "dynamic_asr_eval_tpu_torch/kernels/csrc/flash_attention.cu",
                        path)
        sources["parent"] = path
    for item in others:
        name, path = item.split("=", 1)
        sources[name] = Path(path)
    return sources


def call(lib, which, q, k, v, seg, *tensors):
    B, T, H, D = q.shape
    code = getattr(lib.load(), f"dae_flash_attention_{which}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], seg.data_ptr(), *(t.data_ptr() for t in tensors), B, H, T, D,
        1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
    lib.check(code, f"flash attention {which}")


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, nargs="*", default=[])
    ap.add_argument("--parent", default=None, help="another checkout's root")
    ap.add_argument("--sources", nargs="*", default=[], help="more variants, name=path each")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = {name: CudaLibrary(path, A._bind)
            for name, path in variant_sources(args.steps, args.parent, args.sources).items()}
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(lib.load) for lib in libs.values()]:
            fut.result()
    for name, lib in libs.items():
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {name}: {line.strip()}")

    g = torch.Generator(device="cuda").manual_seed(1)
    B, T, H, D = SHAPE
    qkv = torch.randn(B, T, 3, H, D, generator=g, device="cuda")
    q, k, v = (x.contiguous() for x in qkv.unbind(2))
    mask = torch.arange(T, device="cuda")[None] < torch.tensor(LENGTHS, device="cuda")[:, None]
    seg = mask.to(torch.int32).contiguous()
    dout = torch.randn(B, T, H, D, generator=g, device="cuda")
    ref_out, ref_lse = A.attention_reference(q, k, v, mask)
    ref_grads = A.attention_reference_bwd(q, k, v, mask, ref_out, ref_lse, dout)

    outs = {}
    for name, lib in libs.items():
        out, lse = torch.empty_like(q), torch.empty(B, H, T, device="cuda")
        delta, grads = torch.empty(B, H, T, device="cuda"), [torch.empty_like(q) for _ in range(3)]
        call(lib, "fwd", q, k, v, seg, out, lse)
        call(lib, "bwd", q, k, v, seg, out, dout, lse, delta, *grads)
        torch.cuda.synchronize()
        errs = {n: ((a - b).abs().max() / b.abs().max()).item()
                for n, a, b in zip(("out", "dq", "dk", "dv"), [out] + grads,
                                   [ref_out] + list(ref_grads))}
        if not max(errs.values()) <= 1e-4:
            raise AssertionError(f"{name}: {errs} of max |plain|")
        outs[name] = (out, lse, delta, grads, errs)

    times = {name: {"fwd": [], "bwd": []} for name in libs}
    order = list(libs)
    for name in order + order[::-1]:
        lib, (out, lse, delta, grads, _) = libs[name], outs[name]
        times[name]["fwd"].append(events_ms(lambda: call(lib, "fwd", q, k, v, seg, out, lse)))
        times[name]["bwd"].append(events_ms(
            lambda: call(lib, "bwd", q, k, v, seg, out, dout, lse, delta, *grads)))
    same = A._same_segment(mask)
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=same)
    library = {"fwd": events_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                   qs, ks, vs, attn_mask=same)),
               "bwd": events_ms(lambda: torch.autograd.grad(sdpa, (qs, ks, vs),
                                                            dout.transpose(1, 2),
                                                            retain_graph=True))}
    result = {"card": card, "shape": SHAPE, "lengths": LENGTHS,
              "variants": {name: {"fwd_ms": times[name]["fwd"], "bwd_ms": times[name]["bwd"],
                                  "max_rel_err": outs[name][4]} for name in libs},
              "sdpa_f32_ms": library}
    print(json.dumps({"attention_variants": result}))


if __name__ == "__main__":
    main()
