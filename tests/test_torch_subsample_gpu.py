"""The Hopper fused-subsampling kernels against their plain PyTorch version,
on the card.  Marked ``gpu``: they skip where there is no CUDA device.  No
JAX is imported, so on a machine with a card and no JAX they run as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_*_gpu.py

Two routes: bf16 through the tensor-core kernels of
``csrc/fused_subsample_bf16.cu``, f32 through the CUDA-core kernels of
``csrc/fused_subsample.cu``.  Tolerances: |kernel - plain| <= 1e-4 (f32) or
2e-2 (bf16) of max |plain|, the plain version computed in f32 from the same
inputs with TF32 off.  The bf16 kernels are also held against the plain
version on the bf16 tensors, which rounds where the kernels round: every
output within 2 bf16 ulps of its max |plain|, and at most 2 % of out's and
15 % of gx's elements differing (the weight gradients are f32 sums taken in
another order).  The backward repeats bit for bit (no atomics).
"""

import math

import pytest
import torch

from dynamic_asr_eval_tpu_torch.device import set_parity_precision
from dynamic_asr_eval_tpu_torch.kernels import subsample as S

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BF16_ULPS = 2.0
DIFF_SHARE = {"out": 0.02, "gx": 0.15}
NAMES = ("out", "gx") + S.WEIGHT_NAMES


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the Hopper kernel has no CPU mode)")
    set_parity_precision()
    return torch.device("cuda")


def _inputs(cuda, B, T, F, C, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(B, T, F, generator=g, device=cuda).to(dtype)
    shapes = {"k9": (9, C), "dw1": (9, C), "dw2": (9, C), "pw1": (C, C), "pw2": (C, C)}
    ws = []
    for name in S.WEIGHT_NAMES:
        scale = 1 / 3 if name in ("k9", "dw1", "dw2") else (C ** -0.5 if name.startswith("pw") else 0.1)
        ws.append(torch.randn(shapes.get(name, (C,)), generator=g, device=cuda) * scale)
    T2 = S.ceil_chain(T)[2]
    gout = torch.randn(B, T2, F // 8, C, generator=g, device=cuda).to(dtype)
    return x, ws, gout


def _err(a, b):
    return (a.float() - b).abs().max().item(), b.abs().max().item()


def _bf16_ulp(x):
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _hold_rounding(x, ws, gout, act, got):
    """The bf16 kernels' outputs (out, gx, weight gradients) against the
    plain version on the same bf16 tensors."""
    ref = [S.fused_subsample_reference(x, *ws, act_name=act)]
    ref_gx, ref_gws = S.fused_subsample_reference_bwd(x, ws, gout, act, True)
    for name, a, b in zip(NAMES, got, ref + [ref_gx] + ref_gws):
        ulps = (a.float() - b.float()).abs().max().item() / _bf16_ulp(b.float().abs().max().item())
        assert ulps <= BF16_ULPS, (name, ulps)
        if name in DIFF_SHARE:
            share = (a != b.to(a.dtype)).float().mean().item()
            assert share <= DIFF_SHARE[name], (name, share)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,F,C", [(2, 16384, 80, 256), (3, 1001, 80, 256), (2, 37, 16, 40)])
def test_kernels_match_plain_version(cuda, dtype, B, T, F, C):
    x, ws, gout = _inputs(cuda, B, T, F, C, dtype)
    out = S.fused_subsample_fwd(x, ws, "silu")
    gx, gws = S.fused_subsample_bwd(x, ws, gout, "silu", True)
    ref = S.fused_subsample_reference(x.float(), *ws)
    ref_gx, ref_gws = S.fused_subsample_reference_bwd(x.float(), ws, gout.float(), "silu", True)
    torch.cuda.synchronize()
    for name, a, b in zip(NAMES, [out, gx] + gws, [ref, ref_gx] + ref_gws):
        err, scale = _err(a, b)
        assert err <= TOL[dtype] * scale, (name, err, scale)
    assert all(g.dtype == torch.float32 for g in gws)
    if dtype == torch.bfloat16:
        _hold_rounding(x, ws, gout, "silu", [out, gx] + gws)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_repeats_bit_for_bit(cuda, dtype):
    x, ws, gout = _inputs(cuda, 2, 515, 80, 256, dtype, seed=1)
    a = S.fused_subsample_bwd(x, ws, gout, "silu", True)
    b = S.fused_subsample_bwd(x, ws, gout, "silu", True)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and all(torch.equal(p, q) for p, q in zip(a[1], b[1]))


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_other_activations_match_plain_version(cuda, act):
    x, ws, gout = _inputs(cuda, 1, 300, 32, 64, torch.float32, seed=2)
    out = S.fused_subsample_fwd(x, ws, act)
    gx, gws = S.fused_subsample_bwd(x, ws, gout, act, True)
    ref = S.fused_subsample_reference(x, *ws, act_name=act)
    ref_gx, ref_gws = S.fused_subsample_reference_bwd(x, ws, gout, act, True)
    for a, b in zip([out, gx] + gws, [ref, ref_gx] + ref_gws):
        err, scale = _err(a, b)
        assert err <= 1e-4 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_other_activations_on_the_bf16_route(cuda, act):
    """ReLU and GELU through the tensor-core kernels, against the plain
    version rounding as they do (in f32 ReLU's kink moves with every
    rounding, so the f32 comparison is left to SiLU)."""
    x, ws, gout = _inputs(cuda, 2, 300, 80, 256, torch.bfloat16, seed=3)
    out = S.fused_subsample_fwd(x, ws, act)
    gx, gws = S.fused_subsample_bwd(x, ws, gout, act, True)
    torch.cuda.synchronize()
    _hold_rounding(x, ws, gout, act, [out, gx] + gws)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_each_dtype_takes_its_route(cuda, dtype):
    x, ws, gout = _inputs(cuda, 1, 200, 80, 64, dtype)
    S.reset_counters()
    S.fused_subsample_fwd(x, ws)
    S.fused_subsample_bwd(x, ws, gout, need_gx=False)
    torch.cuda.synchronize()
    route = S.ROUTES[dtype]
    assert route == {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}[dtype]
    assert S.route_launches == {r: ([1, 1] if r == route else [0, 0]) for r in S.route_launches}


@pytest.mark.gpu
def test_autograd_function_launches_each_kernel_once(cuda):
    x, ws, gout = _inputs(cuda, 1, 200, 80, 64, torch.bfloat16)
    ws = [w.requires_grad_(True) for w in ws]
    S.reset_counters()
    out = S.fused_subsample(x, *ws)
    grads = torch.autograd.grad(out, ws, gout)
    torch.cuda.synchronize()
    assert (S.fwd_launches, S.bwd_launches) == (1, 1)
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bad", ["feat", "dtype", "channels"])
def test_cuda_input_the_kernel_does_not_take_raises(cuda, bad, dtype):
    x, ws, _ = _inputs(cuda, 1, 64, 16, 16, dtype)
    if bad == "feat":
        x = torch.zeros(1, 64, 12, device=cuda, dtype=dtype)
    elif bad == "dtype":
        x = x.half()
    else:
        x, ws, _ = _inputs(cuda, 1, 64, 16, 264, dtype)
    with pytest.raises((TypeError, ValueError)):
        S.fused_subsample(x, *ws)
