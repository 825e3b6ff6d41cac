"""Masked self-attention for the conformer: hand-written Hopper kernels.

Counterpart of the JAX package's ``kernels/attention.py:56``
(``flash_attention``), which delegates to JAX's Pallas TPU flash-attention
kernels (``_flash_attention_impl`` forward, ``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq`` backward) with ``SegmentIds(q=mask, kv=mask)``.

- :func:`flash_attention` is the entry point the model calls.  It is a
  ``torch.autograd.Function``: on a CUDA tensor the forward and the backward
  launch a kernel, chosen by dtype (the route); on a CPU tensor they run the
  plain versions below.  There is no fallback from a kernel to anything
  else: a CUDA tensor goes through its route's kernel or the call raises.
  Under ``torch.func.vmap`` (the records-batched engine) its ``vmap`` rule
  folds the mapped axis into the batch: one launch each way for the whole
  group, every row what its own launch gives.
- A query block (sequence parallelism): q [B, Tq, H, D] may hold only rows
  ``[q_offset, q_offset + Tq)`` of the sequence that k, v [B, Tk, H, D] and
  the mask [B, Tk] cover.  The forward gives those rows; the backward their
  dq and their share of dk, dv over all Tk keys, which summed over the
  blocks is the whole call's.  ``Tq == Tk`` with ``q_offset`` 0 is the whole
  sequence, the call every unsharded path makes.
- Routes (``ROUTES``):
  - bf16 → ``"tensor_core"``: ``csrc/flash_attention_bf16.cu``, every product
    on the tensor cores (``mma.sync`` m16n8k16, bf16 in, f32 sums).  The
    main path: the flagship runs in bf16.  D must be a multiple of 8 and at
    most 128 (16-byte rows for the asynchronous copies), else ``ValueError``.
  - f32 → ``"tf32x3"``: ``csrc/flash_attention.cu``, every product on the
    tensor cores as three TF32 products of split operands (``mma.sync``
    m16n8k8, f32 sums): f32 accuracy, the parity route.  Any D up to 128: a
    head dim that is not a multiple of 4 is zero-padded in a copy (the
    kernel's rows are whole 16-byte chunks) and the outputs are sliced.
  Both are built with ``nvcc`` for ``sm_90a`` at first use and bound with
  ``ctypes``.
- :func:`attention_reference` / :func:`attention_reference_bwd` are the plain
  PyTorch versions (einsum + masked softmax), with the same segment
  semantics: key j counts for query i only if ``mask[i] == mask[j]``, so a
  padding query attends padding keys only, as the TPU kernel does.  They
  round where the TPU kernel rounds (a no-op in f32): P to the value dtype
  before P·V (unnormalised, against the row max), and in the backward P
  before dV and dS (scale included) before dQ and dK.
- ``fwd_launches`` / ``bwd_launches`` count kernel launches of either route,
  ``route_launches[route]`` = [forward, backward] per route (the plain path
  and the comparisons do not count), so a run can show which kernels it went
  through.

Bound on the H100 and what each design does about it: see the headers of the
two sources (compute bound at the flagship shape).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch
import torch.nn.functional as F

from dynamic_asr_eval_tpu_torch.kernels._build import CudaLibrary

CSRC = Path(__file__).resolve().parent / "csrc"
MAX_HEAD_DIM = 128
ROUTES = {torch.bfloat16: "tensor_core", torch.float32: "tf32x3"}

# launch counters: +1 per forward kernel launch and per backward launch
# (one backward launch runs the Delta, dK/dV and dQ kernels)
fwd_launches = 0
bwd_launches = 0
route_launches = {route: [0, 0] for route in ROUTES.values()}


def reset_counters() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = 0
    bwd_launches = 0
    for counts in route_launches.values():
        counts[:] = [0, 0]


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path, and the reference on the card)
# ---------------------------------------------------------------------------


def _same_segment(mask: torch.Tensor, q_offset: int = 0, Tq=None) -> torch.Tensor:
    """[B, 1, Tq, Tk]: query row ``q_offset + i`` and key j share a segment
    (mask [B, Tk]; all rows by default)."""
    seg = mask.to(torch.int32)
    qseg = seg[:, q_offset : q_offset + (seg.shape[1] if Tq is None else Tq)]
    return (qseg[:, :, None] == seg[:, None, :])[:, None]


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x (f32) rounded to ``dtype`` and back: where the TPU kernel casts an
    operand before a product."""
    return x.to(dtype).float()


def attention_reference(q, k, v, mask, q_offset: int = 0):
    """q [B, Tq, H, D] (rows ``q_offset ..`` of the sequence), k, v [B, Tk,
    H, D], mask [B, Tk] bool → (out [B, Tq, H, D] in q's dtype, lse [B, H,
    Tq] f32).  Computed in f32; P = exp(s - max s) is rounded to v's dtype
    before P·V and the row sum taken in f32."""
    D = q.shape[-1]
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / math.sqrt(D)
    logits = logits.masked_fill(~_same_segment(mask, q_offset, q.shape[1]), float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhts,bshd->bthd", _round(p, v.dtype), v.float())
    out = out / p.sum(-1).transpose(1, 2)[..., None]
    return out.to(q.dtype), lse


def attention_reference_bwd(q, k, v, mask, out, lse, dout, q_offset: int = 0):
    """Plain backward with the kernel's algorithm: P recomputed from the
    log-sum-exp, Delta = rowsum(dO * O), P rounded before dV and dS (scale
    included) before dQ and dK.  Returns (dq [B, Tq, H, D], dk, dv [B, Tk,
    H, D]) in q's dtype: for a query block, dk and dv are its share."""
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = dout.float()
    s = torch.einsum("bthd,bshd->bhts", qf, kf) * scale
    same = _same_segment(mask, q_offset, q.shape[1])
    p = torch.exp(s - lse[..., None]).masked_fill(~same, 0.0)
    delta = (dof * out.float()).sum(-1).transpose(1, 2)  # [B, H, T]
    dv = torch.einsum("bhts,bthd->bshd", _round(p, dout.dtype), dof)
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    ds = _round(p * (dp - delta[..., None]) * scale, q.dtype)
    dq = torch.einsum("bhts,bshd->bthd", ds, kf)
    dk = torch.einsum("bhts,bthd->bshd", ds, qf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------


def _bind(lib) -> None:
    """Both sources export ``dae_flash_attention_fwd`` / ``_bwd`` with one
    signature (pointers typed by their route's dtype)."""
    vp, ll, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    fwd, bwd = lib.dae_flash_attention_fwd, lib.dae_flash_attention_bwd
    fwd.restype = bwd.restype = i32
    # ..., B, H, Tq, Tk, q_offset, D, scale, stream
    fwd.argtypes = [vp, vp, vp] + [ll] * 9 + [vp, vp, vp] + [i32] * 6 + [f32, vp]
    bwd.argtypes = [vp, vp, vp] + [ll] * 9 + [vp] * 8 + [i32] * 6 + [f32, vp]


LIBRARIES = {
    "tf32x3": CudaLibrary(CSRC / "flash_attention.cu", _bind),
    "tensor_core": CudaLibrary(CSRC / "flash_attention_bf16.cu", _bind),
}


def _validate(q, k, v, mask, q_offset=0):
    if (q.dim() != 4 or k.dim() != 4 or v.shape != k.shape
            or (q.shape[0], *q.shape[2:]) != (k.shape[0], *k.shape[2:])):
        raise ValueError(f"q [B, Tq, H, D] and k, v [B, Tk, H, D] must agree, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if tuple(mask.shape) != (B, Tk):
        raise ValueError(f"mask must be [B, Tk] = {(B, Tk)}, got {tuple(mask.shape)}")
    if not (0 <= q_offset and q_offset + Tq <= Tk):
        raise ValueError(f"query rows [{q_offset}, {q_offset + Tq}) are not inside the "
                         f"{Tk} keys")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in ROUTES:
        raise TypeError(f"flash attention takes float32 or bfloat16 q/k/v, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    devices = {t.device for t in (q, k, v, mask)}
    if len(devices) != 1:
        raise ValueError(f"q, k, v and mask must share a device, got {devices}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a contiguous last (head) dimension")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {MAX_HEAD_DIM} is not supported")
    if q.device.type == "cuda" and ROUTES[q.dtype] == "tensor_core" and D % 8:
        raise ValueError(f"the bf16 tensor-core kernels need a head dim that is a "
                         f"multiple of 8 (16-byte rows), got {D}")


def _aligned(x):
    """x itself if its rows start on 16 bytes, as the kernels' asynchronous
    copies need; else a contiguous copy (a head dim of whole 16-byte chunks
    makes its strides multiples of 16 bytes)."""
    step = 16 // x.element_size()
    if x.data_ptr() % 16 == 0 and all(s % step == 0 for s in x.stride()[:3]):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _kernel_head_dim(x) -> int:
    """The head dim the kernels see: x's, rounded up to whole 16-byte chunks
    (only the f32 route takes a head dim that needs it)."""
    step = 16 // x.element_size()
    return -(-x.shape[-1] // step) * step


def _padded(xs, Dk):
    """Each x [B, T, H, D] with its head dim zero-padded to Dk (a copy), or
    as it is when D == Dk."""
    return [x if x.shape[-1] == Dk else F.pad(x, (0, Dk - x.shape[-1])) for x in xs]


def _launch(q, k, v, seg, q_offset, which, scale, *tensors):
    """Call ``dae_flash_attention_<which>`` of q's route; returns the route."""
    route = ROUTES[q.dtype]
    library = LIBRARIES[route]
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    B, Tq, H, D = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = getattr(library.load(), f"dae_flash_attention_{which}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        seg.data_ptr(), *(t.data_ptr() for t in tensors),
        B, H, Tq, k.shape[1], q_offset, D, scale, stream)
    library.check(code, f"flash attention {which} ({route})")
    return route


def _kernel_fwd(q, k, v, seg, q_offset=0):
    global fwd_launches
    B, Tq, H, D = q.shape
    Dk = _kernel_head_dim(q)
    q, k, v = _padded((q, k, v), Dk)
    out = torch.empty((B, Tq, H, Dk), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    route = _launch(q, k, v, seg, q_offset, "fwd", 1.0 / math.sqrt(D), out, lse)
    fwd_launches += 1
    route_launches[route][0] += 1
    return (out if Dk == D else out[..., :D].contiguous()), lse


def _kernel_bwd(q, k, v, seg, out, lse, dout, q_offset=0):
    global bwd_launches
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    Dk = _kernel_head_dim(q)
    q, k, v, out, dout = _padded((q, k, v, out, dout), Dk)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    grads = [torch.empty((B, T, H, Dk), dtype=q.dtype, device=q.device) for T in (Tq, Tk, Tk)]
    route = _launch(q, k, v, seg, q_offset, "bwd", 1.0 / math.sqrt(D), out, _aligned(dout), lse,
                    delta, *grads)
    bwd_launches += 1
    route_launches[route][1] += 1
    return tuple(g if Dk == D else g[..., :D].contiguous() for g in grads)


def flash_attention_fwd(q, k, v, mask, q_offset: int = 0):
    """Forward only: (out, lse).  Kernel on CUDA, plain version on CPU."""
    _validate(q, k, v, mask, q_offset)
    if q.device.type == "cuda":
        seg = mask.to(torch.int32).contiguous()
        return _kernel_fwd(q, k, v, seg, q_offset)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, mask, q_offset)
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


def flash_attention_bwd(q, k, v, mask, out, lse, dout, q_offset: int = 0):
    """Backward: (dq, dk, dv).  Kernel on CUDA, plain version on CPU."""
    _validate(q, k, v, mask, q_offset)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q ({tuple(q.shape)}, {q.dtype}, {q.device}), "
                             f"got {tuple(t.shape)}, {t.dtype}, {t.device}")
    if lse.shape != (q.shape[0], q.shape[2], q.shape[1]) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [B, H, Tq], got {lse.dtype} {tuple(lse.shape)}")
    if q.device.type == "cuda":
        seg = mask.to(torch.int32).contiguous()
        return _kernel_bwd(q, k, v, seg, out.contiguous(), lse.contiguous(), dout.contiguous(),
                           q_offset)
    if q.device.type == "cpu":
        return attention_reference_bwd(q, k, v, mask, out, lse, dout, q_offset)
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


class FlashAttentionFunction(torch.autograd.Function):
    """(out, lse); lse is not differentiable.  In the ``forward`` /
    ``setup_context`` form ``torch.func`` needs, with a ``vmap`` rule that
    folds the mapped axis into the batch: one launch for the whole group,
    each row's result what its own launch gives."""

    @staticmethod
    def forward(q, k, v, mask, q_offset=0):
        return flash_attention_fwd(q, k, v, mask, q_offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, mask, q_offset = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.q_offset = q_offset

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, mask, out, lse, dout, ctx.q_offset)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, mask, q_offset=0):
        R = info.batch_size

        def fold(x, dim):  # [.., R at dim, ..] -> [R * B, ...]
            x = x.movedim(dim, 0) if dim is not None else x.expand(R, *x.shape)
            return x.reshape(R * x.shape[1], *x.shape[2:])

        folded = (fold(x, d) for x, d in zip((q, k, v, mask), in_dims))
        out, lse = FlashAttentionFunction.apply(*folded, q_offset)
        return (out.view(R, -1, *out.shape[1:]), lse.view(R, -1, *lse.shape[1:])), (0, 0)


def flash_attention(q, k, v, mask, q_offset: int = 0):
    """q [B, Tq, H, D] (rows ``q_offset ..`` of the sequence; all of it by
    default), k, v [B, Tk, H, D], mask [B, Tk] valid-frame mask → [B, Tq, H,
    D].  Under ``torch.func.vmap`` the mapped axis joins the batch (one
    launch)."""
    return FlashAttentionFunction.apply(q, k, v, mask, q_offset)[0]
