"""The port's spectrogram augmentation against the JAX package's.

Random draws cannot match across frameworks (``torch.Generator`` against
``jax.random`` keys), so the two are held to the same rules on the same
input, over many seeds each: the zero-mask config is the identity; a
frequency or time mask fills whole rows or columns with the spectrogram mean
and masks at most what its width bounds allow; frame shuffle permutes
columns; cutout's rectangle count follows ``actual_len / seq_len`` (no
rectangle at ``actual_len`` 0) and each rectangle stays inside its bounds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamic_asr_eval_tpu.augment import apply_augmentation_pipeline as jax_pipeline
from dynamic_asr_eval_tpu.config import CutoutConfig as JaxCutout
from dynamic_asr_eval_tpu.config import FrameShuffleConfig as JaxShuffle
from dynamic_asr_eval_tpu.config import SpecAugmentConfig as JaxSpecAugment
from dynamic_asr_eval_tpu_torch.augment import apply_augmentation_pipeline
from dynamic_asr_eval_tpu_torch.config import CutoutConfig, FrameShuffleConfig, SpecAugmentConfig

torch.set_num_threads(1)

F, T, SEEDS = 16, 60, range(12)
SPEC = np.random.default_rng(0).standard_normal((1, F, T)).astype(np.float32)


def _both(seed, spec_augment=None, frame_shuffle=None, cutout=None, noise=0.0, actual_len=None):
    """The same configuration through the JAX pipeline and the port's."""
    sa, fs, co = spec_augment or {}, frame_shuffle or {}, cutout or {}
    j = jax_pipeline(jnp.asarray(SPEC), jax.random.PRNGKey(seed), JaxSpecAugment(**sa),
                     JaxShuffle(**fs), JaxCutout(**co), noise,
                     actual_len=None if actual_len is None else jnp.asarray(actual_len))
    g = torch.Generator().manual_seed(seed)
    p = apply_augmentation_pipeline(torch.from_numpy(SPEC), g, SpecAugmentConfig(**sa),
                                    FrameShuffleConfig(**fs), CutoutConfig(**co), noise,
                                    actual_len=actual_len)
    return {"jax": np.asarray(j)[0], "port": p.numpy()[0]}


def test_zero_mask_config_is_the_identity_on_both_sides():
    for side, out in _both(0, actual_len=T // 2).items():
        np.testing.assert_array_equal(out, SPEC[0], err_msg=side)


@pytest.mark.parametrize("axis", ["freq", "time"])
def test_masks_fill_whole_bands_with_the_mean_within_their_bounds(axis):
    n, param = 2, 5
    cfg = ({"n_freq_masks": n, "freq_mask_param": param} if axis == "freq"
           else {"n_time_masks": n, "time_mask_param": -1, "min_p": 0.1, "max_p": 0.3})
    limit = n * (param - 1) if axis == "freq" else n * int(0.3 * T / n)
    seen = {"jax": 0, "port": 0}
    for seed in SEEDS:
        for side, out in _both(seed, spec_augment=cfg).items():
            ref = SPEC[0] if axis == "freq" else SPEC[0].T
            got = out if axis == "freq" else out.T
            changed = np.any(got != ref, axis=1)
            np.testing.assert_array_equal(got[~changed], ref[~changed], err_msg=side)
            np.testing.assert_allclose(got[changed], SPEC.mean(), rtol=1e-6, err_msg=side)
            assert changed.sum() <= limit, (side, seed, int(changed.sum()))
            seen[side] += int(changed.sum())
    assert seen["jax"] > 0 and seen["port"] > 0


def test_frame_shuffle_permutes_columns():
    for seed in SEEDS:
        for side, out in _both(seed, frame_shuffle={"time_dimension": True}).items():
            cols = sorted(map(tuple, out.T))
            assert cols == sorted(map(tuple, SPEC[0].T)), (side, seed)


@pytest.mark.parametrize("actual_len", [0, T // 2, T])
def test_cutout_count_follows_actual_len_and_rectangles_stay_in_bounds(actual_len):
    n, w, h = 4, 6, 3
    cfg = {"seq_len": T, "cutout_val": "zero", "num_rectangles": n, "max_width": w,
           "max_height": h}
    n_active = int(n * actual_len / T)
    for seed in SEEDS:
        for side, out in _both(seed, cutout=cfg, actual_len=actual_len).items():
            zeroed = out != SPEC[0]
            assert np.all(out[zeroed] == 0), side
            assert zeroed.sum() <= n_active * (w - 1) * (h - 1), (side, seed)
            if n_active == 0:
                assert not zeroed.any(), side
