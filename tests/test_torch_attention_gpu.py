"""The Hopper flash-attention kernel against its plain PyTorch version, on
the card.  Marked ``gpu``: it skips where there is no CUDA device.  It
imports no JAX, so on a machine with a card and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_attention_gpu.py

Tolerances: |kernel - plain| <= 1e-4 (f32) or 2e-2 (bf16) of max |plain|,
the plain version computed in f32 from the same inputs with TF32 off.
"""

import pytest
import torch

from dynamic_asr_eval_tpu_torch.device import set_parity_precision
from dynamic_asr_eval_tpu_torch.kernels import attention as A

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the Hopper kernel has no CPU mode)")
    set_parity_precision()
    return torch.device("cuda")


def _inputs(cuda, T, H, D, lengths, dtype):
    """q, k contiguous and v a strided view of one qkv tensor, as the model
    hands them over."""
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(len(lengths), T, 3, H, D, generator=g, device=cuda).to(dtype)
    q, k, v = qkv.unbind(2)
    mask = torch.arange(T, device=cuda)[None] < torch.tensor(lengths, device=cuda)[:, None]
    dout = torch.randn(len(lengths), T, H, D, generator=g, device=cuda).to(dtype)
    return q.contiguous(), k.contiguous(), v, mask, dout


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,H,D,lengths", [(300, 2, 128, [300, 177]), (37, 2, 32, [37, 20])])
def test_kernel_matches_plain_version(cuda, dtype, T, H, D, lengths):
    q, k, v, mask, dout = _inputs(cuda, T, H, D, lengths, dtype)
    out, lse = A.flash_attention_fwd(q, k, v, mask)
    grads = A.flash_attention_bwd(q, k, v, mask, out, lse, dout)
    ref_out, ref_lse = A.attention_reference(q.float(), k.float(), v.float(), mask)
    ref_grads = A.attention_reference_bwd(q.float(), k.float(), v.float(), mask,
                                          ref_out, ref_lse, dout.float())
    torch.cuda.synchronize()
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    for a, b in zip((out,) + tuple(grads), (ref_out,) + tuple(ref_grads)):
        assert (a.float() - b).abs().max().item() <= TOL[dtype] * b.abs().max().item()


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
def test_cuda_tensor_of_another_type_raises(cuda):
    q = torch.zeros(1, 8, 2, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        A.flash_attention(q, q, q, torch.ones(1, 8, dtype=torch.bool, device=cuda))
