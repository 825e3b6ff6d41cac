"""The Hopper flash-attention kernels against their plain PyTorch version, on
the card.  Marked ``gpu``: it skips where there is no CUDA device.  It
imports no JAX, so on a machine with a card and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_attention_gpu.py

bf16 runs the tensor-core kernels (``csrc/flash_attention_bf16.cu``), f32 the
3xTF32 tensor-core kernels (``csrc/flash_attention.cu``, any head dim up to
128: one that is not a multiple of 4 is zero-padded by the wrapper).  Tolerances: |kernel -
plain| <= 1e-4 (f32) or 2e-2 (bf16) of max |plain|, the plain version
computed in f32 from the same inputs with TF32 off; bf16 also against the
plain version on the bf16 tensors, which rounds where the kernels round
(``chip_smoke.check_rounding``: 1 bf16 ulp of max, at most 5 % of elements
differing).
"""

import pytest
import torch

import chip_smoke
from dynamic_asr_eval_tpu_torch.device import set_parity_precision
from dynamic_asr_eval_tpu_torch.kernels import attention as A

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the Hopper kernel has no CPU mode)")
    set_parity_precision()
    return torch.device("cuda")


def _prefix(cuda, T, lengths):
    return torch.arange(T, device=cuda)[None] < torch.tensor(lengths, device=cuda)[:, None]


def _inputs(cuda, T, H, D, lengths, dtype, mask=None):
    """q, k contiguous and v a strided view of one qkv tensor, as the model
    hands them over."""
    g = torch.Generator(device=cuda).manual_seed(0)
    B = len(lengths) if mask is None else mask.shape[0]
    qkv = torch.randn(B, T, 3, H, D, generator=g, device=cuda).to(dtype)
    q, k, v = qkv.unbind(2)
    if mask is None:
        mask = _prefix(cuda, T, lengths)
    dout = torch.randn(B, T, H, D, generator=g, device=cuda).to(dtype)
    return q.contiguous(), k.contiguous(), v, mask, dout


def _check(q, k, v, mask, dout):
    out, lse = A.flash_attention_fwd(q, k, v, mask)
    grads = A.flash_attention_bwd(q, k, v, mask, out, lse, dout)
    ref_out, ref_lse = A.attention_reference(q.float(), k.float(), v.float(), mask)
    ref_grads = A.attention_reference_bwd(q.float(), k.float(), v.float(), mask,
                                          ref_out, ref_lse, dout.float())
    torch.cuda.synchronize()
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    for a, b in zip((out,) + tuple(grads), (ref_out,) + tuple(ref_grads)):
        assert (a.float() - b).abs().max().item() <= TOL[q.dtype] * b.abs().max().item()
    if q.dtype == torch.bfloat16:
        chip_smoke.check_rounding(A, "attention", q.shape[1], q, k, v, mask, dout, out, lse, grads)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("T,lengths", [(37, [37, 20]), (300, [300, 177]), (2048, [2048, 1600])])
def test_kernel_matches_plain_version(cuda, dtype, D, T, lengths):
    _check(*_inputs(cuda, T, 2, D, lengths, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("D", [30, 3, 100])
def test_f32_kernel_takes_any_head_dim(cuda, D):
    """Head dims that are not a multiple of 4 (padded to whole 16-byte rows in
    a copy) or fill a 128-wide tile only in part."""
    _check(*_inputs(cuda, 300, 2, D, [300, 177], torch.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("length", [2048, 1792])
def test_batch_one_flagship_shapes(cuda, length):
    """AWMC's shapes: one window at a time, q/k/v [1, 2048, 6, 128] bf16,
    a full window and the ragged last one (1792 valid frames)."""
    _check(*_inputs(cuda, 2048, 6, 128, [length], torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["random", "empty_row", "window"])
def test_tensor_core_kernels_with_masks_that_defeat_tile_skipping(cuda, kind, dtype):
    """A random 0/1 mask puts both segment ids in almost every tile (nothing
    may be skipped); a batch row with no valid frame is one padding segment;
    valid frames [64, 100) give a mixed tile between tiles of padding, whose
    pairs must stay masked."""
    T = 300
    t = torch.arange(T, device=cuda)[None]
    if kind == "random":
        g = torch.Generator(device=cuda).manual_seed(1)
        mask = torch.rand(2, T, generator=g, device=cuda) < 0.5
    elif kind == "empty_row":
        mask = _prefix(cuda, T, [T, 0])
    else:
        mask = ((t >= 64) & (t < 100)).expand(2, T)
    _check(*_inputs(cuda, T, 2, 64, None, dtype, mask=mask))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tensor_core_backward_repeats_bit_for_bit(cuda, dtype):
    q, k, v, mask, dout = _inputs(cuda, 2048, 6, 128, [2048, 1600], dtype)
    out, lse = A.flash_attention_fwd(q, k, v, mask)
    first = A.flash_attention_bwd(q, k, v, mask, out, lse, dout)
    second = A.flash_attention_bwd(q, k, v, mask, out, lse, dout)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_autograd_function_launches_the_kernels_once_each(cuda):
    q, k, v, mask, dout = _inputs(cuda, 130, 2, 64, [130, 65], torch.bfloat16)
    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    A.reset_counters()
    out = A.flash_attention(q, k, v, mask)
    torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (A.fwd_launches, A.bwd_launches) == (1, 1)


@pytest.mark.gpu
def test_each_dtype_takes_its_route(cuda):
    for dtype, route in ((torch.bfloat16, "tensor_core"), (torch.float32, "tf32x3")):
        q, k, v, mask, dout = _inputs(cuda, 130, 2, 64, [130, 65], dtype)
        q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
        A.reset_counters()
        torch.autograd.grad(A.flash_attention(q, k, v, mask), (q, k, v), dout)
        torch.cuda.synchronize()
        other = "tf32x3" if route == "tensor_core" else "tensor_core"
        assert A.route_launches == {route: [1, 1], other: [0, 0]}


@pytest.mark.gpu
def test_cuda_tensor_of_another_type_raises(cuda):
    q = torch.zeros(1, 8, 2, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        A.flash_attention(q, q, q, torch.ones(1, 8, dtype=torch.bool, device=cuda))


@pytest.mark.gpu
def test_bf16_head_dim_not_a_multiple_of_8_raises(cuda):
    q = torch.zeros(1, 8, 2, 36, device=cuda, dtype=torch.bfloat16)
    A.reset_counters()
    with pytest.raises(ValueError):
        A.flash_attention(q, q, q, torch.ones(1, 8, dtype=torch.bool, device=cuda))
    assert A.route_launches == {"tensor_core": [0, 0], "tf32x3": [0, 0]}
