"""The utterance engine's soft-DTW term through the Hopper kernels, on the
card.  Marked ``gpu``: it skips where there is no CUDA device.  No JAX is
imported; on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_*_gpu.py

A tiny f32 conformer adapts with ``soft_dtw_weight=0.1`` on utterances of
256 and 512 frames (W_ds 32 and 64), a fixed perturbation as its
``augment_fn`` so that the augmented and the clean posteriors differ:
exactly one R (forward) and one E (backward) kernel launch per utterance.
The D of the engine's first forward, taken where the engine hands it to
``kernels.softdtw.soft_dtw``, is asymmetric, and gives the same value and
D-gradient through the kernels as through the plain version: 1e-4 relative
on the value, 1e-4 of max |E| on the gradient.
"""

import numpy as np
import pytest
import torch

from dynamic_asr_eval_tpu_torch.config import TTAConfig
from dynamic_asr_eval_tpu_torch.kernels import softdtw
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, init_conformer
from dynamic_asr_eval_tpu_torch.tta import utterance
from dynamic_asr_eval_tpu_torch.tta.utterance import UtteranceTTAEngine

LENGTHS = (256, 512, 256)


def perturb(batch, generator, length):
    """A fixed perturbation of the augmented copy, seeded by its width."""
    g = torch.Generator(device=batch.device).manual_seed(batch.shape[-1])
    return batch + 0.5 * torch.randn(batch.shape, generator=g, device=batch.device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the Hopper kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_engine_soft_dtw_goes_through_the_kernels(cuda, monkeypatch):
    cfg = ConformerConfig(feat_in=32, n_layers=2, d_model=64, n_heads=2, head_dim=32,
                          vocab_size=30, subsampling_factor=8, subsampling_conv_channels=16,
                          conv_kernel_size=5, compute_dtype="float32")
    model = init_conformer(cfg, seed=0)
    rng = np.random.default_rng(1)
    utts = [{"spectrogram": rng.standard_normal((32, n)).astype(np.float32)} for n in LENGTHS]
    seen = []
    real = softdtw.soft_dtw

    def spy(D, gamma=1.0, bandwidth=0, use_pallas=False):
        seen.append(D.detach().clone())
        return real(D, gamma, bandwidth, use_pallas)

    monkeypatch.setattr(utterance.softdtw, "soft_dtw", spy)
    engine = UtteranceTTAEngine(model, cfg.blank_id, 8,
                                TTAConfig(epochs=1, shuffle=False, optim_args={"lr": 1e-3}),
                                augment_fn=perturb, soft_dtw_weight=0.1, device=cuda)
    softdtw.reset_counters()
    outs, adapted, _ = engine(None, utts, return_params=True)
    torch.cuda.synchronize()
    assert (softdtw.fwd_launches, softdtw.bwd_launches) == (len(LENGTHS), len(LENGTHS))
    assert [tuple(D.shape) for D in seen] == [(1, n // 8, n // 8) for n in LENGTHS]
    assert all(np.isfinite(o).all() for o in outs)
    state = model.state_dict()
    assert any(not torch.equal(adapted[k].cpu(), state[k]) for k in state)

    D = seen[0]
    assert D.is_cuda and D.dtype == torch.float32
    assert (D - D.transpose(1, 2)).abs().max() > 1e-3 * D.abs().max()
    values, grads = [], []
    for use_pallas in (True, False):
        x = D.clone().requires_grad_(True)
        loss = real(x, 1.0, 0, use_pallas)
        (g,) = torch.autograd.grad(loss.sum(), x)
        values.append(loss.detach())
        grads.append(g)
    torch.cuda.synchronize()
    assert torch.allclose(values[0], values[1], rtol=1e-4, atol=0)
    assert torch.isfinite(grads[0]).all()
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-4 * grads[1].abs().max().item()
