"""The port's FLOP model (``perf.py``) against the JAX package's: the same
counts on the same configurations, and the H100's bf16 peak."""

import jax.numpy as jnp
import pytest
import torch

from dynamic_asr_eval_tpu import perf as jax_perf
from dynamic_asr_eval_tpu.lm.transformer_lm import TransformerLMConfig as JaxLMConfig
from dynamic_asr_eval_tpu.models.conformer import ConformerConfig as JaxConfig
from dynamic_asr_eval_tpu_torch import perf
from dynamic_asr_eval_tpu_torch.lm.transformer_lm import TransformerLMConfig
from dynamic_asr_eval_tpu_torch.models import ConformerConfig

torch.set_num_threads(1)

FLAGSHIP = dict(feat_in=80, n_layers=6, d_model=768, n_heads=6, head_dim=128, vocab_size=4095,
                subsampling_factor=8, subsampling_conv_channels=256, conv_kernel_size=9)
TINY = dict(feat_in=32, n_layers=2, d_model=64, n_heads=2, head_dim=32, vocab_size=30,
            subsampling_factor=4, subsampling_conv_channels=16, conv_kernel_size=5,
            self_conditioning=False)
CONFIGS = {"flagship": FLAGSHIP, "tiny": TINY}


def _pair(name):
    kw = CONFIGS[name]
    return ConformerConfig(compute_dtype="float32", **kw), JaxConfig(compute_dtype=jnp.float32,
                                                                     **kw)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("T", [16384, 14336, 1001])
def test_conformer_flops_equal_jax(name, T):
    ours, theirs = _pair(name)
    for batch in (1, 2):
        assert perf.conformer_forward_flops(ours, T, batch) == jax_perf.conformer_forward_flops(
            theirs, T, batch)
    assert perf.training_step_flops(ours, T, 2) == jax_perf.training_step_flops(theirs, T, 2)
    assert perf.training_step_flops(ours, T, 3, grad_batch=3) == jax_perf.training_step_flops(
        theirs, T, 3, grad_batch=3)
    for epochs in (1, 2):
        assert perf.awmc_step_flops(ours, T, epochs) == jax_perf.awmc_step_flops(theirs, T, epochs)


@pytest.mark.parametrize("cache_len", [None, 17])
def test_transformer_lm_step_flops_equal_jax(cache_len):
    ours = TransformerLMConfig(vocab_size=4095)
    theirs = JaxLMConfig(vocab_size=4095)
    for batch in (1, 20):
        assert perf.transformer_lm_step_flops(ours, batch, cache_len) == \
            jax_perf.transformer_lm_step_flops(theirs, batch, cache_len)
    # the published 512d/8h/6-layer shape at cache 128: ~48 MFLOP a row
    assert 40e6 < perf.transformer_lm_step_flops(ours, 1) < 60e6


def test_device_peaks_and_mfu():
    assert perf.device_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    for kind in ("TPU v5 lite", "TPU v4", "TPU v6e", "unknown accel"):
        assert perf.device_peak_flops(kind) == jax_perf.device_peak_flops(kind)
    assert perf.mfu(989e12, 1.0, "NVIDIA H100 80GB HBM3") == pytest.approx(1.0)
    assert perf.mfu(1.0, 1.0, "unknown") is None and perf.mfu(1.0, 0.0, "TPU v4") is None
