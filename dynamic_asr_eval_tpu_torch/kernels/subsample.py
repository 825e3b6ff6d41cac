"""Fused ×8 dw-striding subsampling stack: a hand-written Hopper kernel.

Counterpart of the JAX package's ``kernels/subsample.py`` (``fused_subsample``,
a ``jax.custom_vjp`` whose forward ``_fwd_pallas`` and backward ``_bwd_pallas``
are Pallas TPU kernels)::

    x [B, T, F] ──3×3 s2 conv (1→C) + bias ── act ──►
      twice: 3×3 s2 depthwise + bias → 1×1 pointwise + bias → act
      ──► [B, ⌈T/8⌉, F/8, C]

Padding (1, 1) at every stride-2 conv and no masks between stages: the TPU
kernel's semantics, which differ from the masked ``"conv"`` path on a window
whose valid length is not a multiple of 8.

- :func:`fused_subsample` is the entry point.  It is a
  ``torch.autograd.Function``: on CUDA tensors the forward and the backward
  launch a kernel, chosen by dtype (the route); on CPU tensors they run the
  plain version and autograd through it.  A CUDA tensor goes through its
  route's kernel or the call raises: there is no fallback.
- Routes (``ROUTES``):
  - bf16 → ``"tensor_core"``: ``csrc/fused_subsample_bf16.cu``, both
    pointwise products, forward and backward, on the tensor cores
    (``mma.sync`` m16n8k16, bf16 in, f32 sums).  The main path: the flagship
    runs in bf16.
  - f32 → ``"cuda_core"``: ``csrc/fused_subsample.cu``, CUDA-core FMAs in
    f32, the parity route (TF32 tensor cores could not hold its bars).
  Both export the same C entry points (``dae_fused_subsample_fwd``,
  ``_bwd``, ``_workspace``), are built with ``nvcc`` for ``sm_90a`` at first
  use and bound with ``ctypes``.  Any B, T, F % 8 == 0 and C <= 256.
- :func:`fused_subsample_reference` is the plain PyTorch version
  (``F.conv2d``), rounding to the compute dtype where the TPU kernel does.
- ``fwd_launches`` / ``bwd_launches`` count kernel launches of either route,
  ``route_launches[route]`` = [forward, backward] per route (the plain path
  does not count).

Bound on the H100 and what each design does about it: see the headers of the
two sources.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from dynamic_asr_eval_tpu_torch.kernels._build import CudaLibrary

CSRC = Path(__file__).resolve().parent / "csrc"
MAX_CHANNELS = 256  # a block keeps all C output channels of its positions
ROUTES = {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODES = {"silu": 0, "relu": 1, "gelu": 2}
_ACTS = {"silu": F.silu, "relu": F.relu,
         "gelu": lambda z: F.gelu(z, approximate="tanh")}  # jax.nn.gelu's default
WEIGHT_NAMES = ("k9", "b0", "dw1", "bdw1", "pw1", "bpw1", "dw2", "bdw2", "pw2", "bpw2")

# launch counters: +1 per forward and per backward kernel launch (each runs
# several kernels, one after another)
fwd_launches = 0
bwd_launches = 0
route_launches = {route: [0, 0] for route in ROUTES.values()}


def reset_counters() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = 0
    bwd_launches = 0
    for counts in route_launches.values():
        counts[:] = [0, 0]


def ceil_chain(T: int):
    """Rows after each stride-2 stage: (⌈T/2⌉, ⌈T/4⌉, ⌈T/8⌉) by repeated ⌈·/2⌉."""
    T0 = -(-T // 2)
    T1 = -(-T0 // 2)
    return T0, T1, -(-T1 // 2)


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU path, and the reference on the card)
# ---------------------------------------------------------------------------


def fused_subsample_reference(x, k9, b0, dw1, bdw1, pw1, bpw1, dw2, bdw2, pw2, bpw2,
                              act_name="silu"):
    """x [B, T, F] → [B, ⌈T/8⌉, F/8, C] in x's dtype.  Sums in f32, rounded
    to x's dtype where the TPU kernel rounds: after stage 0, after each
    depthwise conv, after each pointwise product and after its bias, after
    each activation (run in f32).  The depthwise and pointwise weights and
    biases are rounded to x's dtype, k9 and b0 stay f32.  (The TPU kernel
    also sums the depthwise taps in the compute dtype; here they are summed
    in f32 and rounded once.)"""
    dt = x.dtype
    act = _ACTS[act_name]
    C = k9.shape[1]

    def conv3(h, w9, b, groups):  # 3×3, stride 2, padding (1, 1), f32
        return F.conv2d(h, w9.t().reshape(C, 1, 3, 3), b, stride=2, padding=1, groups=groups)

    def cast(w):
        return w.to(dt).float()

    z = conv3(x.float()[:, None], k9.float(), b0.float(), 1).to(dt)
    s = act(z.float()).to(dt)
    for w9, bw, pw, bp in ((dw1, bdw1, pw1, bpw1), (dw2, bdw2, pw2, bpw2)):
        d = conv3(s.float(), cast(w9), cast(bw), C).to(dt)
        z = F.conv2d(d.float(), cast(pw).t()[:, :, None, None]).to(dt) + bp.to(dt)[:, None, None]
        s = act(z.float()).to(dt)
    return s.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------


def _bind(lib) -> None:
    """Both sources export the same three entry points with one signature."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dae_fused_subsample_workspace.restype = i64
    lib.dae_fused_subsample_workspace.argtypes = [i32] * 6
    lib.dae_fused_subsample_fwd.restype = i32
    lib.dae_fused_subsample_fwd.argtypes = [i32, i32, vp] + [i32] * 4 + [vp] * 4
    lib.dae_fused_subsample_bwd.restype = i32
    lib.dae_fused_subsample_bwd.argtypes = [i32, i32, vp, vp] + [i32] * 4 + [vp] * 5


LIBRARIES = {
    "cuda_core": CudaLibrary(CSRC / "fused_subsample.cu", _bind),
    "tensor_core": CudaLibrary(CSRC / "fused_subsample_bf16.cu", _bind),
}


def _validate(x, weights, act_name):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, F], got {tuple(x.shape)}")
    B, T, Fd = x.shape
    if Fd % 8:
        raise ValueError(f"feat dim {Fd} must be divisible by 8")
    if x.dtype not in ROUTES:
        raise TypeError(f"fused subsampling takes float32 or bfloat16 x, got {x.dtype}")
    if act_name not in _ACT_CODES:
        raise ValueError(f"unknown activation {act_name!r}")
    C = weights[0].shape[-1]
    shapes = {"k9": (9, C), "dw1": (9, C), "dw2": (9, C), "pw1": (C, C), "pw2": (C, C)}
    for name, w in zip(WEIGHT_NAMES, weights):
        want = shapes.get(name, (C,))
        if tuple(w.shape) != want:
            raise ValueError(f"{name} must be {list(want)}, got {list(w.shape)}")
        if not w.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {w.dtype}")
    devices = {t.device for t in (x, *weights)}
    if len(devices) != 1:
        raise ValueError(f"x and the weights must share a device, got {devices}")
    if x.device.type == "cuda" and C > MAX_CHANNELS:
        raise ValueError(f"the kernel takes at most {MAX_CHANNELS} channels, got {C}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused subsampling runs on cuda or cpu, not {x.device}")


def _pack(weights):
    return torch.cat([w.float().reshape(-1) for w in weights])


def _workspace(lib, x, C, which):
    """The scratch of the forward (``which`` 0) or the backward (1)."""
    B, T, Fd = x.shape
    nbytes = lib.dae_fused_subsample_workspace(_DTYPE_CODES[x.dtype], which, B, T, Fd, C)
    if nbytes < 0:
        raise ValueError(f"the kernel does not take x {tuple(x.shape)} with {C} channels")
    return torch.empty(nbytes, dtype=torch.uint8, device=x.device)


def _kernel_fwd(x, weights, act_name):
    global fwd_launches
    route = ROUTES[x.dtype]
    library = LIBRARIES[route]
    lib = library.load()
    B, T, Fd = x.shape
    C = weights[0].shape[1]
    x = x.contiguous()
    w = _pack(weights)
    out = torch.empty((B, ceil_chain(T)[2], Fd // 8, C), dtype=x.dtype, device=x.device)
    work = _workspace(lib, x, C, 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.dae_fused_subsample_fwd(_DTYPE_CODES[x.dtype], _ACT_CODES[act_name], x.data_ptr(),
                                       B, T, Fd, C, w.data_ptr(), out.data_ptr(), work.data_ptr(),
                                       stream)
    library.check(code, f"fused subsampling forward ({route})")
    fwd_launches += 1
    route_launches[route][0] += 1
    return out


def _kernel_bwd(x, weights, g, act_name, need_gx):
    """(gx or None, [10 weight gradients in f32])."""
    global bwd_launches
    route = ROUTES[x.dtype]
    library = LIBRARIES[route]
    lib = library.load()
    B, T, Fd = x.shape
    C = weights[0].shape[1]
    x = x.contiguous()
    g = g.to(x.dtype).contiguous()
    w = _pack(weights)
    work = _workspace(lib, x, C, 1)
    gw = torch.empty_like(w)
    gx = torch.empty_like(x) if need_gx else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.dae_fused_subsample_bwd(_DTYPE_CODES[x.dtype], _ACT_CODES[act_name], x.data_ptr(),
                                       g.data_ptr(), B, T, Fd, C, w.data_ptr(),
                                       gx.data_ptr() if need_gx else None, gw.data_ptr(),
                                       work.data_ptr(), stream)
    library.check(code, f"fused subsampling backward ({route})")
    bwd_launches += 1
    route_launches[route][1] += 1
    grads = list(torch.split(gw, [wt.numel() for wt in weights]))
    return gx, [gr.view(wt.shape) for gr, wt in zip(grads, weights)]


def fused_subsample_reference_bwd(x, weights, g, act_name, need_gx):
    """Autograd through the plain forward: (gx or None, weight gradients in
    f32)."""
    with torch.enable_grad():
        xs = x.detach().requires_grad_(need_gx)
        ws = [w.detach().float().requires_grad_(True) for w in weights]
        out = fused_subsample_reference(xs, *ws, act_name=act_name)
        grads = torch.autograd.grad(out, ([xs] if need_gx else []) + ws, g.to(out.dtype))
    if need_gx:
        return grads[0], list(grads[1:])
    return None, list(grads)


def fused_subsample_fwd(x, weights, act_name="silu"):
    """Forward only.  Kernel on CUDA, plain version on CPU."""
    _validate(x, weights, act_name)
    if x.device.type == "cuda":
        return _kernel_fwd(x, weights, act_name)
    return fused_subsample_reference(x, *weights, act_name=act_name)


def fused_subsample_bwd(x, weights, g, act_name="silu", need_gx=True):
    """Backward: (gx or None, the 10 weight gradients in f32).  Kernel on
    CUDA, autograd through the plain version on CPU."""
    _validate(x, weights, act_name)
    if x.device.type == "cuda":
        return _kernel_bwd(x, weights, g, act_name, need_gx)
    return fused_subsample_reference_bwd(x, weights, g, act_name, need_gx)


class FusedSubsampleFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, act_name, x, *weights):
        ctx.act_name = act_name
        ctx.save_for_backward(x, *weights)
        return fused_subsample_fwd(x, weights, act_name)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        gx, gws = fused_subsample_bwd(x, weights, g, ctx.act_name, ctx.needs_input_grad[1])
        return (None, gx, *gws)


def fused_subsample(x, k9, b0, dw1, bdw1, pw1, bpw1, dw2, bdw2, pw2, bpw2, act_name="silu"):
    """Fused ×8 dw-striding subsampling: x [B, T, F] (f32 or bf16, F % 8 ==
    0) → [B, ⌈T/8⌉, F/8, C] in x's dtype.  Weights in the JAX layouts: k9,
    dw1, dw2 [9, C] ((dt, df) row-major), pw1, pw2 [C_in, C_out], biases
    [C].  Weight gradients come back in f32."""
    return FusedSubsampleFunction.apply(act_name, x, k9, b0, dw1, bdw1, pw1, bpw1,
                                        dw2, bdw2, pw2, bpw2)
