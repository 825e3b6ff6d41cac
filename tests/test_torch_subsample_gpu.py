"""The Hopper fused-subsampling kernels against their plain PyTorch version,
on the card.  Marked ``gpu``: they skip where there is no CUDA device.  No
JAX is imported, so on a machine with a card and no JAX they run as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_*_gpu.py

Tolerances: |kernel - plain| <= 1e-4 (f32) or 2e-2 (bf16) of max |plain|,
the plain version computed in f32 from the same inputs with TF32 off; the
backward repeats bit for bit (no atomics).
"""

import pytest
import torch

from dynamic_asr_eval_tpu_torch.device import set_parity_precision
from dynamic_asr_eval_tpu_torch.kernels import subsample as S

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,F,C", [(3, 1001, 80, 256), (2, 37, 16, 40)])
def test_kernels_match_plain_version(cuda, dtype, B, T, F, C):
    x, ws, gout = _inputs(cuda, B, T, F, C, dtype)
    out = S.fused_subsample_fwd(x, ws, "silu")
    gx, gws = S.fused_subsample_bwd(x, ws, gout, "silu", True)
    ref = S.fused_subsample_reference(x.float(), *ws)
    ref_gx, ref_gws = S.fused_subsample_reference_bwd(x.float(), ws, gout.float(), "silu", True)
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "gx") + S.WEIGHT_NAMES, [out, gx] + gws,
                          [ref, ref_gx] + ref_gws):
        err, scale = _err(a, b)
        assert err <= TOL[dtype] * scale, (name, err, scale)
    assert all(g.dtype == torch.float32 for g in gws)


@pytest.mark.gpu
def test_backward_repeats_bit_for_bit(cuda):
    x, ws, gout = _inputs(cuda, 2, 515, 80, 256, torch.bfloat16, seed=1)
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
@pytest.mark.parametrize("bad", ["feat", "dtype", "channels"])
def test_cuda_input_the_kernel_does_not_take_raises(cuda, bad):
    x, ws, _ = _inputs(cuda, 1, 64, 16, 16, torch.float32)
    if bad == "feat":
        x = torch.zeros(1, 64, 12, device=cuda)
    elif bad == "dtype":
        x = x.half()
    else:
        x, ws, _ = _inputs(cuda, 1, 64, 16, 264, torch.float32)
    with pytest.raises((TypeError, ValueError)):
        S.fused_subsample(x, *ws)
