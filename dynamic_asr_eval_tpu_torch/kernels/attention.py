"""Masked self-attention for the conformer: a hand-written Hopper kernel.

Counterpart of the JAX package's ``kernels/attention.py:56``
(``flash_attention``), which delegates to JAX's Pallas TPU flash-attention
kernels (``_flash_attention_impl`` forward, ``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq`` backward) with ``SegmentIds(q=mask, kv=mask)``.

- :func:`flash_attention` is the entry point the model calls.  It is a
  ``torch.autograd.Function``: on a CUDA tensor the forward and the backward
  launch the kernels of ``csrc/flash_attention.cu`` (built with ``nvcc`` for
  ``sm_90a`` at first use, bound with ``ctypes``); on a CPU tensor they run
  the plain versions below.  There is no fallback from the kernel to anything
  else: a CUDA tensor goes through the kernel or the call raises.
- :func:`attention_reference` / :func:`attention_reference_bwd` are the plain
  PyTorch versions (einsum + masked softmax), with the same segment
  semantics: key j counts for query i only if ``mask[i] == mask[j]``, so a
  padding query attends padding keys only, as the TPU kernel does.
- ``fwd_launches`` / ``bwd_launches`` count kernel launches (the plain path
  and the comparisons do not count), so a run can show that it went through
  the kernel.

Bound on the H100 and what the design does about it: see the header of
``csrc/flash_attention.cu`` (compute bound at the flagship shape; this first
kernel uses CUDA-core FMAs, so the tensor-core peak is far off).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from dynamic_asr_eval_tpu_torch.kernels._build import CudaLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# launch counters: +1 per forward kernel launch and per backward launch
# (one backward launch runs the Delta, dK/dV and dQ kernels)
fwd_launches = 0
bwd_launches = 0


def reset_counters() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = 0
    bwd_launches = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path, and the reference on the card)
# ---------------------------------------------------------------------------


def _same_segment(mask: torch.Tensor) -> torch.Tensor:
    seg = mask.to(torch.int32)
    return (seg[:, :, None] == seg[:, None, :])[:, None]  # [B, 1, T, S]


def attention_reference(q, k, v, mask):
    """q, k, v [B, T, H, D], mask [B, T] bool → (out [B, T, H, D] in q's
    dtype, lse [B, H, T] f32).  Computed in f32."""
    D = q.shape[-1]
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / math.sqrt(D)
    logits = logits.masked_fill(~_same_segment(mask), float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    attn = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhts,bshd->bthd", attn, v.float())
    return out.to(q.dtype), lse


def attention_reference_bwd(q, k, v, mask, out, lse, dout):
    """Plain backward with the kernel's algorithm: P recomputed from the
    log-sum-exp, Delta = rowsum(dO * O).  Returns (dq, dk, dv) in q's dtype."""
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = dout.float()
    s = torch.einsum("bthd,bshd->bhts", qf, kf) * scale
    p = torch.exp(s - lse[..., None]).masked_fill(~_same_segment(mask), 0.0)
    delta = (dof * out.float()).sum(-1).transpose(1, 2)  # [B, H, T]
    dv = torch.einsum("bhts,bthd->bshd", p, dof)
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhts,bshd->bthd", ds, kf) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------


def _bind(lib) -> None:
    vp, ll, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.dae_flash_attention_fwd.restype = i32
    lib.dae_flash_attention_fwd.argtypes = (
        [i32, vp, vp, vp] + [ll] * 9 + [vp, vp, vp] + [i32] * 4 + [f32, vp])
    lib.dae_flash_attention_bwd.restype = i32
    lib.dae_flash_attention_bwd.argtypes = (
        [i32, vp, vp, vp] + [ll] * 9 + [vp] * 8 + [i32] * 4 + [f32, vp])


LIBRARY = CudaLibrary(SOURCE, _bind)


def __getattr__(name):
    """``build_seconds`` and ``build_log`` of this process's build."""
    if name in ("build_seconds", "build_log"):
        return getattr(LIBRARY, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def build() -> Path:
    """Compile ``csrc/flash_attention.cu`` (see :mod:`._build`).  Raises on
    failure."""
    return LIBRARY.build()


def _validate(q, k, v, mask):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share a [B, T, H, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, D = q.shape
    if tuple(mask.shape) != (B, T):
        raise ValueError(f"mask must be [B, T] = {(B, T)}, got {tuple(mask.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention takes float32 or bfloat16 q/k/v, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    devices = {t.device for t in (q, k, v, mask)}
    if len(devices) != 1:
        raise ValueError(f"q, k, v and mask must share a device, got {devices}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a contiguous last (head) dimension")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {MAX_HEAD_DIM} is not supported")


def _kernel_fwd(q, k, v, seg):
    global fwd_launches
    lib = LIBRARY.load()
    B, T, H, D = q.shape
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.dae_flash_attention_fwd(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        seg.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, H, T, D, 1.0 / math.sqrt(D), stream)
    LIBRARY.check(code, "flash attention forward")
    fwd_launches += 1
    return out, lse


def _kernel_bwd(q, k, v, seg, out, lse, dout):
    global bwd_launches
    lib = LIBRARY.load()
    B, T, H, D = q.shape
    dout = dout.contiguous()
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    dq = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.dae_flash_attention_bwd(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        seg.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, T, D, 1.0 / math.sqrt(D), stream)
    LIBRARY.check(code, "flash attention backward")
    bwd_launches += 1
    return dq, dk, dv


def flash_attention_fwd(q, k, v, mask):
    """Forward only: (out, lse).  Kernel on CUDA, plain version on CPU."""
    _validate(q, k, v, mask)
    if q.device.type == "cuda":
        seg = mask.to(torch.int32).contiguous()
        return _kernel_fwd(q, k, v, seg)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, mask)
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


def flash_attention_bwd(q, k, v, mask, out, lse, dout):
    """Backward: (dq, dk, dv).  Kernel on CUDA, plain version on CPU."""
    _validate(q, k, v, mask)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q ({tuple(q.shape)}, {q.dtype}, {q.device}), "
                             f"got {tuple(t.shape)}, {t.dtype}, {t.device}")
    if lse.shape != (q.shape[0], q.shape[2], q.shape[1]) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [B, H, T], got {lse.dtype} {tuple(lse.shape)}")
    if q.device.type == "cuda":
        seg = mask.to(torch.int32).contiguous()
        return _kernel_bwd(q, k, v, seg, out.contiguous(), lse.contiguous(), dout)
    if q.device.type == "cpu":
        return attention_reference_bwd(q, k, v, mask, out, lse, dout)
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


class FlashAttentionFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask):
        out, lse = flash_attention_fwd(q, k, v, mask)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, mask, out, lse, dout)
        return dq, dk, dv, None


def flash_attention(q, k, v, mask):
    """q, k, v [B, T, H, D], mask [B, T] valid-frame mask → [B, T, H, D]."""
    return FlashAttentionFunction.apply(q, k, v, mask)
