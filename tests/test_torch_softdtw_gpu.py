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
@pytest.mark.parametrize("B,N,M,gamma,bandwidth", [
    (2, 300, 200, 1.0, 0), (3, 150, 140, 0.1, 30), (1, 7, 600, 0.5, 0),
    # the utterance engine's shapes (B 1, T_ds 64 to ~2k), several panels of
    # the kernels at 2048, a single row and a single column, and a small γ
    (1, 64, 64, 1.0, 0), (1, 512, 512, 1.0, 0), (1, 2048, 2048, 1.0, 0),
    (1, 2048, 2048, 1.0, 100), (1, 1, 300, 1.0, 0), (1, 33, 1, 1.0, 0), (2, 100, 90, 0.01, 0)])
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


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M", [(1, 512, 512), (3, 150, 700)])
def test_kernels_repeat_bit_for_bit(cuda, B, N, M):
    D = _D(cuda, B, N, M, 0, seed=2)
    R = S.softdtw_R(D, 1.0)
    E = S.softdtw_E(D, R, 1.0)
    assert torch.equal(S.softdtw_R(D, 1.0), R)
    assert torch.equal(S.softdtw_E(D, R, 1.0), E)


@pytest.mark.gpu
def test_chain_step_times_the_dependent_chain(cuda):
    before = (S.fwd_launches, S.bwd_launches)
    fwd, bwd = S.chain_step(), S.chain_step(backward=True)
    assert (S.fwd_launches, S.bwd_launches) == before  # it computes no soft-DTW
    # forward: a shuffle, a select, adds, two ex2, an FMA and a lg2 on the
    # chain; backward: a shuffle, a select and an FMA
    assert 10 < bwd["cycles"] < fwd["cycles"] < 1000
    assert all(500 < x["mhz"] < 2500 for x in (fwd, bwd))
    assert fwd["ns"] == pytest.approx(fwd["cycles"] / fwd["mhz"] * 1e3)
