"""The Hopper soft-DTW kernels (R forward, E backward) against their plain
PyTorch versions, on the card.  Marked ``gpu``: they skip where there is no
CUDA device.  No JAX is imported, so on a machine with a card they run as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_*_gpu.py

Tolerance: 1e-4 relative on R (its cells are sums of the same order) and
1e-4 of max |E| on E, in f32, each kernel given the same inputs as its plain
version (E from the kernel's R: E moves by R's rounding over gamma).
"""

import pytest
import torch

from dynamic_asr_eval_tpu_torch.kernels import softdtw as S


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the Hopper kernel has no CPU mode)")
    return torch.device("cuda")


def _D(cuda, B, N, M, bandwidth, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return S._apply_band(torch.rand(B, N, M, generator=g, device=cuda) * 2, bandwidth)


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M,gamma,bandwidth", [(2, 300, 200, 1.0, 0), (3, 150, 140, 0.1, 30),
                                                   (1, 7, 600, 0.5, 0)])
def test_kernels_match_plain_versions(cuda, B, N, M, gamma, bandwidth):
    D = _D(cuda, B, N, M, bandwidth)
    R = S.softdtw_R(D, gamma)
    E = S.softdtw_E(D, R, gamma)
    ref_R = S.forward_R_reference(D, gamma)
    ref_E = S.backward_E_reference(D, R, gamma)  # the same inputs as the E kernel
    torch.cuda.synchronize()
    assert ((R - ref_R).abs() / ref_R.abs().clamp_min(1.0)).max().item() <= 1e-4
    assert torch.isfinite(E).all()
    assert (E - ref_E).abs().max().item() <= 1e-4 * ref_E.abs().max().item()


@pytest.mark.gpu
def test_autograd_function_launches_each_kernel_once(cuda):
    D = _D(cuda, 2, 64, 50, 0).requires_grad_(True)
    S.reset_counters()
    loss = S.soft_dtw(D, 1.0, 0, use_pallas=True)
    (grad,) = torch.autograd.grad(loss.sum(), D)
    torch.cuda.synchronize()
    assert (S.fwd_launches, S.bwd_launches) == (1, 1)
    ref = S.soft_dtw(D.detach().requires_grad_(True), 1.0, 0, use_pallas=False)
    assert torch.allclose(loss, ref, rtol=1e-5)
    assert torch.isfinite(grad).all()


@pytest.mark.gpu
def test_cuda_tensor_of_another_type_raises(cuda):
    with pytest.raises(TypeError):
        S.soft_dtw(torch.zeros(1, 8, 8, device=cuda, dtype=torch.float16), 1.0, 0, use_pallas=True)
