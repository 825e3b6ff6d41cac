"""Soft-DTW: differentiable dynamic time warping, with hand-written Hopper
kernels for both directions.

Counterpart of the JAX package's ``kernels/softdtw.py``:

- :func:`soft_dtw` ``(D [B, N, M], gamma, bandwidth, use_pallas)`` is a
  ``torch.autograd.Function``.  With ``use_pallas=True`` on a CUDA tensor the
  forward launches the R kernel of ``csrc/softdtw.cu`` (the counterpart of the
  Pallas ``_softdtw_pallas_fwd``) and the backward the E kernel (the
  counterpart of ``_backward_E``, a ``lax.scan`` in JAX).  With
  ``use_pallas=False``, or on the CPU, both directions run the plain
  anti-diagonal versions below, as JAX runs XLA without a kernel.
- :func:`forward_R_reference` / :func:`backward_E_reference`: the plain
  versions, one vectorised update per anti-diagonal.
- The Sakoe-Chiba band stays outside the kernels (:func:`_apply_band`), and
  :func:`pairwise_sq_dist` is one batched matmul, as in JAX.
- ``fwd_launches`` / ``bwd_launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from dynamic_asr_eval_tpu_torch.device import resolve_device
from dynamic_asr_eval_tpu_torch.kernels._build import CudaLibrary

INF = 1e10
SOURCE = Path(__file__).resolve().parent / "csrc" / "softdtw.cu"

# launch counters: +1 per R (forward) and per E (backward) kernel launch
fwd_launches = 0
bwd_launches = 0


def reset_counters() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = 0
    bwd_launches = 0


def pairwise_sq_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x [B, N, D], y [B, M, D] → squared euclidean distances [B, N, M]
    (one batched matmul plus rank-1 corrections)."""
    xx = (x * x).sum(-1)[:, :, None]
    yy = (y * y).sum(-1)[:, None, :]
    xy = torch.matmul(x, y.transpose(1, 2))
    return torch.clamp(xx + yy - 2.0 * xy, min=0.0)


def _band_mask(N: int, M: int, bandwidth: int, device=None) -> Optional[torch.Tensor]:
    """[N, M] True outside the band |i - j| <= bandwidth; None for no band."""
    if bandwidth <= 0:
        return None
    i = torch.arange(N, device=device)[:, None]
    j = torch.arange(M, device=device)[None, :]
    return (i - j).abs() > bandwidth


def _apply_band(D: torch.Tensor, bandwidth: int) -> torch.Tensor:
    mask = _band_mask(D.shape[-2], D.shape[-1], bandwidth, D.device)
    if mask is None:
        return D
    return torch.where(mask[None], torch.full((), INF, dtype=D.dtype, device=D.device), D)


def _softmin3(a, b, c, gamma):
    """-γ·log(e^{-a/γ} + e^{-b/γ} + e^{-c/γ}), numerically stable."""
    z = torch.stack([-a / gamma, -b / gamma, -c / gamma])
    zmax = z.max(dim=0).values
    return -gamma * (zmax + torch.log(torch.exp(z - zmax).sum(dim=0)))


def _diagonal(k: int, N: int, M: int, device):
    """0-based rows i of anti-diagonal k (cells with i + j == k)."""
    return torch.arange(max(0, k - M + 1), min(N - 1, k) + 1, device=device)


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path, use_pallas=False, and the reference)
# ---------------------------------------------------------------------------


def forward_R_reference(D: torch.Tensor, gamma: float) -> torch.Tensor:
    """D [B, N, M] → R [B, N+2, M+2] (padded; R[:, 1..N, 1..M] are the
    soft-DTW cumulative costs, R[:, 0, 0] = 0, other borders INF)."""
    B, N, M = D.shape
    R = torch.full((B, N + 2, M + 2), INF, dtype=D.dtype, device=D.device)
    R[:, 0, 0] = 0.0
    for k in range(N + M - 1):
        i = _diagonal(k, N, M, D.device)
        j = k - i
        R[:, i + 1, j + 1] = D[:, i, j] + _softmin3(R[:, i, j + 1], R[:, i + 1, j], R[:, i, j],
                                                    gamma)
    return R


def backward_E_reference(D: torch.Tensor, R: torch.Tensor, gamma: float) -> torch.Tensor:
    """Cuturi-Blondel backward: E [B, N, M] = ∂R[N, M]/∂D.

    Each weight is exp of ``(R[nb] - R[cell] - D[nb]) / γ``, which is <= 0 in
    exact arithmetic (softmin <= min); it is clamped at 0.  JAX's
    ``_backward_E`` does not clamp: next to a band, R - D of a cell outside
    it is a difference of two INF-sized f32 values, a multiple of 1024, whose
    exp overflows, and 0 · inf makes NaN gradients inside the band.
    Elsewhere the clamp changes nothing."""
    B, N, M = D.shape
    D_ = torch.zeros((B, N + 2, M + 2), dtype=D.dtype, device=D.device)
    D_[:, 1:N + 1, 1:M + 1] = D
    R_ = R.clone()
    R_[:, :, M + 1] = -INF
    R_[:, N + 1, :] = -INF
    R_[:, N + 1, M + 1] = R[:, N, M]
    E = torch.zeros((B, N + 2, M + 2), dtype=D.dtype, device=D.device)
    E[:, N + 1, M + 1] = 1.0

    def weight(di, dj, r, i, j):
        return torch.exp(torch.clamp((R_[:, i + di, j + dj] - r - D_[:, i + di, j + dj]) / gamma,
                                     max=0.0))

    for k in range(N + M - 2, -1, -1):
        i = _diagonal(k, N, M, D.device) + 1
        j = k - i + 2
        r = R_[:, i, j]
        E[:, i, j] = (E[:, i + 1, j] * weight(1, 0, r, i, j) + E[:, i, j + 1] * weight(0, 1, r, i, j)
                      + E[:, i + 1, j + 1] * weight(1, 1, r, i, j))
    return E[:, 1:N + 1, 1:M + 1]


# ---------------------------------------------------------------------------
# build, bind and launch
# ---------------------------------------------------------------------------


def _bind(lib) -> None:
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dae_softdtw_fwd.restype = i32
    lib.dae_softdtw_fwd.argtypes = [vp, vp, i32, i32, i32, f32, vp]
    lib.dae_softdtw_bwd.restype = i32
    lib.dae_softdtw_bwd.argtypes = [vp, vp, vp, i32, i32, i32, f32, vp]


LIBRARY = CudaLibrary(SOURCE, _bind)


def _kernel_fwd(D: torch.Tensor, gamma: float) -> torch.Tensor:
    global fwd_launches
    lib = LIBRARY.load()
    B, N, M = D.shape
    D = D.contiguous()
    R = torch.empty((B, N + 2, M + 2), dtype=torch.float32, device=D.device)
    code = lib.dae_softdtw_fwd(D.data_ptr(), R.data_ptr(), B, N, M, gamma,
                               torch.cuda.current_stream(D.device).cuda_stream)
    LIBRARY.check(code, "soft-DTW forward")
    fwd_launches += 1
    return R


def _kernel_bwd(D: torch.Tensor, R: torch.Tensor, gamma: float) -> torch.Tensor:
    global bwd_launches
    lib = LIBRARY.load()
    B, N, M = D.shape
    D, R = D.contiguous(), R.contiguous()
    E = torch.empty((B, N, M), dtype=torch.float32, device=D.device)
    code = lib.dae_softdtw_bwd(D.data_ptr(), R.data_ptr(), E.data_ptr(), B, N, M, gamma,
                               torch.cuda.current_stream(D.device).cuda_stream)
    LIBRARY.check(code, "soft-DTW backward")
    bwd_launches += 1
    return E


def _validate(D: torch.Tensor, gamma: float, use_pallas: bool) -> None:
    if D.dim() != 3 or min(D.shape) < 1:
        raise ValueError(f"D must be a non-empty [B, N, M], got {tuple(D.shape)}")
    if not gamma > 0:
        raise ValueError(f"gamma must be positive, got {gamma}")
    if use_pallas and D.dtype != torch.float32:
        raise TypeError(f"the soft-DTW kernels take float32 D, got {D.dtype}")
    if not D.is_floating_point():
        raise TypeError(f"D must be floating point, got {D.dtype}")
    if D.device.type not in ("cuda", "cpu"):
        raise ValueError(f"soft-DTW runs on cuda or cpu, not {D.device}")


def softdtw_R(D: torch.Tensor, gamma: float) -> torch.Tensor:
    """D [B, N, M] f32 (band applied) → R [B, N+2, M+2].  Kernel on CUDA,
    plain version on CPU."""
    _validate(D, gamma, True)
    if D.device.type == "cuda":
        return _kernel_fwd(D, float(gamma))
    return forward_R_reference(D, gamma)


def softdtw_E(D: torch.Tensor, R: torch.Tensor, gamma: float) -> torch.Tensor:
    """D [B, N, M] f32 and its R → E [B, N, M].  Kernel on CUDA, plain
    version on CPU."""
    _validate(D, gamma, True)
    B, N, M = D.shape
    if tuple(R.shape) != (B, N + 2, M + 2) or R.dtype != torch.float32 or R.device != D.device:
        raise ValueError(f"R must be float32 [B, N+2, M+2] on {D.device}, got "
                         f"{R.dtype} {tuple(R.shape)} on {R.device}")
    if D.device.type == "cuda":
        return _kernel_bwd(D, R, float(gamma))
    return backward_E_reference(D, R, gamma)


class SoftDTWFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, D, gamma, bandwidth, use_pallas):
        gamma, bandwidth = float(gamma), int(bandwidth)
        _validate(D, gamma, use_pallas)
        Db = _apply_band(D, bandwidth)
        R = softdtw_R(Db, gamma) if use_pallas else forward_R_reference(Db, gamma)
        ctx.save_for_backward(Db, R)
        ctx.gamma, ctx.bandwidth, ctx.use_pallas = gamma, bandwidth, use_pallas
        N, M = D.shape[-2:]
        return R[:, N, M].clone()

    @staticmethod
    def backward(ctx, g):
        Db, R = ctx.saved_tensors
        if ctx.use_pallas:
            E = softdtw_E(Db, R, ctx.gamma)
        else:
            E = backward_E_reference(Db, R, ctx.gamma)
        mask = _band_mask(Db.shape[-2], Db.shape[-1], ctx.bandwidth, Db.device)
        if mask is not None:
            E = E.masked_fill(mask[None], 0.0)
        return g[:, None, None] * E, None, None, None


def soft_dtw(D: torch.Tensor, gamma: float = 1.0, bandwidth: int = 0,
             use_pallas: bool = False) -> torch.Tensor:
    """D [B, N, M] distance matrix → soft-DTW loss [B]."""
    return SoftDTWFunction.apply(D, gamma, bandwidth, use_pallas)


class SoftDTW:
    """Module-style wrapper, ``SoftDTW(gamma, normalize, bandwidth,
    use_pallas)`` called on ``(x [B, N, D], y [B, M, D])`` feature
    sequences."""

    def __init__(self, gamma: float = 1.0, normalize: bool = False,
                 bandwidth: int = 0, use_pallas: bool = False):
        self.gamma = float(gamma)
        self.normalize = normalize
        self.bandwidth = int(bandwidth)
        self.use_pallas = use_pallas

    def _sdtw(self, a, b):
        return soft_dtw(pairwise_sq_dist(a, b), self.gamma, self.bandwidth, self.use_pallas)

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.normalize:
            # D(x, y) - (D(x, x) + D(y, y)) / 2
            return self._sdtw(x, y) - 0.5 * (self._sdtw(x, x) + self._sdtw(y, y))
        return self._sdtw(x, y)


def benchmark(B=4, N=256, M=256, D=64, gamma=1.0, use_pallas=False, iters=5, device=None):
    """Seconds per iteration of value and gradient (with respect to x) of
    ``sum(SoftDTW(gamma)(x, y))`` on standard-normal features from numpy seed
    0.  Runs on ``cuda`` unless ``device`` says otherwise."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((B, N, D)), dtype=torch.float32, device=dev)
    y = torch.tensor(rng.standard_normal((B, M, D)), dtype=torch.float32, device=dev)
    sdtw = SoftDTW(gamma, use_pallas=use_pallas)

    def step():
        xs = x.detach().requires_grad_(True)
        loss = sdtw(xs, y).sum()
        (grad,) = torch.autograd.grad(loss, xs)
        return loss.detach(), grad

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = step()
    sync()
    t0 = time.time()
    for _ in range(iters):
        out = step()
    sync()
    return {"seconds_per_iter": (time.time() - t0) / iters, "loss": float(out[0])}
