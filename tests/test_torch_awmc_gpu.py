"""The port's AWMC engine on the card: through the Hopper kernels
(``attention_impl="pallas_flash"``, ``subsampling_impl="pallas"``) against
the same engine on the plain path (``"xla"`` attention, ``"conv"``
subsampling), same weights and recording.  Marked ``gpu``: it skips where
there is no CUDA device.  No JAX is imported, so on a machine with a card
and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_awmc_gpu.py

A small model (2 layers, d 64, feat 80, subsampling ×8 with 16 channels), a
1000-frame recording in 512-frame windows with 256 overlap (3 windows of
512, 512 and 488 frames: multiples of 8, where the fused kernel's unmasked
semantics and the conv path's masks agree).  f32, TF32 off: stitched
log-probs within 1e-4 and adapted weights within 2e-5, the bars of the CPU
parity tests.  Each window runs the anchor and clean forwards once and the
leader and student forwards and the student's backward each epoch, so the
kernels' launch counts are exact.
"""

import numpy as np
import pytest
import torch

from dynamic_asr_eval_tpu_torch.config import TTAConfig
from dynamic_asr_eval_tpu_torch.device import set_parity_precision
from dynamic_asr_eval_tpu_torch.kernels import attention as A
from dynamic_asr_eval_tpu_torch.kernels import subsample as S
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, init_conformer
from dynamic_asr_eval_tpu_torch.tta import AWMCEngine

SMALL = dict(feat_in=80, n_layers=2, d_model=64, n_heads=2, head_dim=32, vocab_size=30,
             subsampling_factor=8, subsampling_conv_channels=16, conv_kernel_size=5)
N_WINDOWS, EPOCHS = 3, 2
ROUTE = {torch.float32: "cuda_core", torch.bfloat16: "tensor_core"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the Hopper kernels have no CPU mode)")
    set_parity_precision()
    return torch.device("cuda")


def _run(cuda, dtype, attention_impl, subsampling_impl):
    cfg = ConformerConfig(compute_dtype=dtype, attention_impl=attention_impl,
                          subsampling_impl=subsampling_impl, **SMALL)
    model = init_conformer(cfg, seed=0).to(cuda)
    spec = np.random.default_rng(1).standard_normal((80, 1000)).astype(np.float32)
    tta = TTAConfig(seq_len=512, overlap=256, epochs=EPOCHS, online=True, shuffle=False,
                    lm_tta_beams=0, optim_args={"lr": 1e-3})
    A.reset_counters()
    S.reset_counters()
    out = AWMCEngine(model, cfg.blank_id, 8, tta, device=cuda)(None, spec, return_params=True)
    torch.cuda.synchronize()
    return out, {name: {r: list(c) for r, c in mod.route_launches.items()}
                 for name, mod in (("attention", A), ("subsample", S))}


def _expected_launches(dtype):
    forwards = 2 + 2 * EPOCHS  # anchor and clean once; leader and student each epoch
    per_window = {"attention": (SMALL["n_layers"] * forwards, SMALL["n_layers"] * EPOCHS),
                  "subsample": (forwards, EPOCHS)}
    route = ROUTE[dtype]
    other = "tensor_core" if route == "cuda_core" else "cuda_core"
    return {name: {route: [f * N_WINDOWS, b * N_WINDOWS], other: [0, 0]}
            for name, (f, b) in per_window.items()}


@pytest.mark.gpu
def test_f32_kernel_path_matches_the_plain_path(cuda):
    kern, launches = _run(cuda, torch.float32, "pallas_flash", "pallas")
    assert launches == _expected_launches(torch.float32)
    plain, plain_launches = _run(cuda, torch.float32, "xla", "conv")
    assert plain_launches["attention"]["cuda_core"] == [0, 0]
    np.testing.assert_allclose(kern.numpy_logits(), plain.numpy_logits(), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(kern.greedy_ids(), plain.greedy_ids())
    for k, v in plain.params.items():
        assert (kern.params[k] - v).abs().max().item() <= 2e-5, k


@pytest.mark.gpu
def test_bf16_kernel_path_runs_on_the_tensor_cores(cuda):
    out, launches = _run(cuda, torch.bfloat16, "pallas_flash", "pallas")
    assert launches == _expected_launches(torch.bfloat16)
    lp = out.numpy_logits()
    assert lp.shape == (-(-1000 // 8), SMALL["vocab_size"] + 1)
    assert np.isfinite(lp).all()
