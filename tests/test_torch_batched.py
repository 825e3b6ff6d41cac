"""``DynamicEvalEngine.batched`` (records batching, ``--dp_records``)
against the JAX package's ``batched`` and against the port's own serial
engine.

Tiny fp32 conformer of one layer without self-conditioning (``"xla"``
attention, ``"conv"`` subsampling: JAX's batched program compiles ~40 %
faster than at two layers), the port's seeded weights handed to JAX
(``variables_to_jax``: no JAX init to compile), no mesh.  Against JAX the augmentation is
off (the zero-mask config: the two packages draw different random numbers),
and each case holds the stitched log-probs within 1e-4 and the greedy ids
equal, record by record:

- R = 3 records of 700, 512 and 300 frames (5, 4 and 2 windows of 256 /
  128 in a bucket of 5: the shorter two step through padded windows),
  online and offline;
- ``shuffle`` with 2 offline epochs (the window orders drawn record-major;
  the records' step counts part ways in the second epoch), through the
  offline case's JAX engine (neither option changes JAX's compiled
  program, so the second run reuses it);
- a group whose records all fit one window, at an overlap of 66 that only
  the single-window zeroing makes legal, adapted 2 epochs with
  ``num_negatives=2``, ``freeze_subsampling`` and MADGRAD with weight decay
  and momentum (one compiled JAX program for both cases).

Against the port's serial engine, with SpecAugment, noise and cutout on
(each record's own generator, seeded as its serial run): within 1e-5, on
the kernels' plain versions (``"pallas_flash"``, ``"pallas"``) too.

The JAX engines run with ``lax.scan``'s ``unroll`` dropped
(tests/test_torch_engine.py says why).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamic_asr_eval_tpu.config import TTAConfig as JaxTTAConfig
from dynamic_asr_eval_tpu.models import ConformerConfig as JaxConfig
from dynamic_asr_eval_tpu.models import SCConformer as JaxConformer
from dynamic_asr_eval_tpu.tta import DynamicEvalEngine as JaxEngine
from dynamic_asr_eval_tpu_torch.config import (
    CutoutConfig,
    SpecAugmentConfig,
    TTAConfig,
)
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, init_conformer, variables_to_jax
from dynamic_asr_eval_tpu_torch.tta import DynamicEvalEngine
from test_torch_engine import rolled_scans

torch.set_num_threads(1)

TINY = dict(feat_in=32, n_layers=1, self_conditioning=False, d_model=64, n_heads=2, head_dim=32,
            vocab_size=30,
            subsampling_factor=8, subsampling_conv_channels=16, conv_kernel_size=5,
            attention_impl="xla")
FRAMES = (700, 512, 300)
SEEDS = [3, 4, 5]


def _tta(**kw):
    return dict(dict(seq_len=256, overlap=128, epochs=1, online=True, shuffle=False,
                     lm_tta_beams=0, optim_args={"lr": 1e-3}), **kw)


def _specs(frames, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((TINY["feat_in"], n)).astype(np.float32) for n in frames]


@pytest.fixture(scope="module")
def shared():
    jcfg = JaxConfig(compute_dtype=jnp.float32, **TINY)
    port = init_conformer(ConformerConfig(compute_dtype="float32", **TINY), seed=0)
    variables = jax.tree.map(jnp.asarray, variables_to_jax(port.state_dict()))
    return jcfg, JaxConformer(jcfg), variables, port


@pytest.fixture(scope="module")
def jax_offline(shared):
    jcfg, model, _, _ = shared
    return JaxEngine(model, jcfg.blank_id, 8, JaxTTAConfig(**_tta(online=False)))


def _both(shared, tta, frames=FRAMES, num_negatives=1, jax_engine=None):
    jcfg, model, variables, port = shared
    specs = _specs(frames)
    keys = [jax.random.PRNGKey(s) for s in SEEDS[: len(specs)]]
    if jax_engine is None:
        jax_engine = JaxEngine(model, jcfg.blank_id, 8, JaxTTAConfig(**tta),
                               num_negatives=num_negatives)
    jax_engine.config = JaxTTAConfig(**tta)
    with rolled_scans():
        j = jax_engine.batched(variables, specs, rngs=keys, shuffle_rng=np.random.default_rng(5))
    p = DynamicEvalEngine(port, jcfg.blank_id, 8, TTAConfig(**tta), num_negatives=num_negatives,
                          device="cpu").batched(port.state_dict(), specs, rngs=SEEDS[: len(specs)],
                                                shuffle_rng=np.random.default_rng(5))
    return j, p


def _assert_same(j, p, frames=FRAMES):
    assert len(j) == len(p) == len(frames)
    for r, (jo, po) in enumerate(zip(j, p)):
        assert po.params is None
        n = int(np.sum(np.asarray(jo.counts) > 0))
        assert n == -(-frames[r] // 8), r
        np.testing.assert_array_equal(po.counts.numpy(), np.asarray(jo.counts), err_msg=str(r))
        np.testing.assert_allclose(po.numpy_logits(), jo.numpy_logits(), rtol=0, atol=1e-4,
                                   err_msg=str(r))
        np.testing.assert_array_equal(po.greedy_ids(), jo.greedy_ids(), err_msg=str(r))


@pytest.mark.parametrize("online", [True, False], ids=["online", "offline"])
def test_batched_matches_jax_on_three_unequal_records(shared, jax_offline, online):
    _assert_same(*_both(shared, _tta(online=online), jax_engine=None if online else jax_offline))


def test_batched_shuffle_over_two_epochs_matches_jax(shared, jax_offline):
    _assert_same(*_both(shared, _tta(online=False, shuffle=True, epochs=2),
                        jax_engine=jax_offline))


def test_batched_single_window_group_with_negatives_and_options_matches_jax(shared):
    """Every record within one window: the overlap (66, not a multiple of
    8) is zeroed as JAX zeroes it; two negatives, the subsampling frozen,
    MADGRAD with weight decay and momentum, 2 online epochs."""
    frames = (200, 160)
    tta = _tta(overlap=66, epochs=2, freeze_subsampling=True,
               optim_args={"lr": 1e-3, "weight_decay": 1e-2, "momentum": 0.5})
    _assert_same(*_both(shared, tta, frames=frames, num_negatives=2), frames=frames)


def test_batched_window_plan_refuses_what_jax_refuses(shared):
    jcfg, model, variables, port = shared
    specs = _specs((700, 300))
    for bad in (_tta(overlap=100), _tta(seq_len=250)):
        with pytest.raises(ValueError, match="multiple of the subsampling"):
            JaxEngine(model, jcfg.blank_id, 8, JaxTTAConfig(**bad)).batched(variables, specs)
        with pytest.raises(ValueError, match="multiple of the subsampling"):
            DynamicEvalEngine(port, jcfg.blank_id, 8, TTAConfig(**bad), device="cpu").batched(
                None, specs)


AUGMENT = dict(spec_augment=SpecAugmentConfig(n_freq_masks=2, freq_mask_param=6, n_time_masks=2,
                                              time_mask_param=30),
               random_noise=0.1,
               cutout=CutoutConfig(seq_len=256, num_rectangles=3, max_width=20, max_height=4))


@pytest.mark.parametrize("impls,tta", [
    ({}, _tta(**AUGMENT)),
    ({}, _tta(online=False, shuffle=True, epochs=2, **AUGMENT)),
    ({"attention_impl": "pallas_flash", "subsampling_impl": "pallas"}, _tta(**AUGMENT)),
], ids=["online", "shuffle-2-epochs", "kernels-plain"])
def test_batched_matches_the_serial_engine_with_augmentation_on(shared, impls, tta):
    """Record r's generator is seeded as its serial run's, so its
    augmentation draws are the serial run's; its weights move as alone."""
    port = shared[3]
    model = type(port)(dataclasses.replace(port.config, **impls))
    model.load_state_dict(port.state_dict())
    engine = DynamicEvalEngine(model, port.config.blank_id, 8, TTAConfig(**tta), device="cpu")
    specs = _specs(FRAMES)
    shuffle = np.random.default_rng(9)
    serial = [engine(None, s, rng=seed, shuffle_rng=shuffle) for s, seed in zip(specs, SEEDS)]
    outs = engine.batched(None, specs, rngs=SEEDS, shuffle_rng=np.random.default_rng(9))
    unadapted = DynamicEvalEngine(model, port.config.blank_id, 8,
                                  TTAConfig(**dict(tta, epochs=0)), device="cpu")
    for r, (o, e) in enumerate(zip(outs, serial)):
        n = len(e.counts)  # the serial bucket is the record's own
        np.testing.assert_array_equal(o.counts[:n].numpy(), e.counts.numpy())
        assert not o.counts[n:].any()
        np.testing.assert_allclose(o.numpy_logits(), e.numpy_logits(), rtol=0, atol=1e-5,
                                   err_msg=str(r))
        assert np.abs(o.numpy_logits() - unadapted(None, specs[r]).numpy_logits()).max() > 1e-3
