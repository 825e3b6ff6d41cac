"""Activation rematerialisation, the kernels' ``vmap`` rules, and the two
helpers of the data-parallel slice, on the CPU.

- ``checkpoint_every_n_layers`` (1 and 2) and ``remat_subsampling``: the
  weight gradients and the batch-renorm running statistics (batch
  statistics on, so they move) equal those of the same model without
  rematerialisation, bit for bit; the recomputed blocks call the kernels'
  forwards a second time (their plain versions here, counted by wrapping
  them); against JAX's remat model (``nn.remat`` of the blocks and of the
  subsampling, at one layer, its gradient through ``.lower().compile()``) the gradients
  within 1e-5 of the model's largest |gradient| (the depthwise biases
  before a batch renorm have gradients of ~1e-5 that are rounding noise on
  both sides, with or without remat) and the running statistics within
  1e-6: moved once, as flax moves them.
- ``FlashAttentionFunction`` and ``FusedSubsampleFunction`` under
  ``torch.func.vmap`` at R = 3: outputs and gradients equal to the
  per-record loop bit for bit (with shared subsampling weights, their
  gradients are one sum over all records instead of R sums added: within
  1e-5 of max); the attention folds the records into one call forward and
  one backward, the subsampling with per-record weights calls once per
  record (once with shared weights).
- ``augment.replace_with_frame``: every frame equals one input frame.
- ``audio.make_featurizer``: JAX's featurizer within 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamic_asr_eval_tpu.audio.features import make_featurizer as jax_make_featurizer
from dynamic_asr_eval_tpu.models import ConformerConfig as JaxConfig
from dynamic_asr_eval_tpu.models import SCConformer as JaxConformer
from dynamic_asr_eval_tpu_torch.audio import make_featurizer
from dynamic_asr_eval_tpu_torch.augment import replace_with_frame
from dynamic_asr_eval_tpu_torch.kernels import attention as A
from dynamic_asr_eval_tpu_torch.kernels import subsample as S
from dynamic_asr_eval_tpu_torch.models import (
    ConformerConfig,
    SCConformer,
    init_conformer,
    params_from_jax,
    variables_to_jax,
)

torch.set_num_threads(1)

TINY = dict(feat_in=32, n_layers=3, d_model=64, n_heads=2, head_dim=32, vocab_size=30,
            subsampling_factor=8, subsampling_conv_channels=16, conv_kernel_size=5,
            default_norm="batch_renorm")
KERNELS = dict(attention_impl="pallas_flash", subsampling_impl="pallas")
LENGTHS = np.array([256, 200])


def _inputs(seed=0):
    return np.random.default_rng(seed).standard_normal((2, TINY["feat_in"], 256)).astype(np.float32)


@pytest.fixture(scope="module")
def start():
    """The seeded weights (and initial running statistics) every run starts
    from."""
    return init_conformer(ConformerConfig(compute_dtype="float32", **TINY), seed=0).state_dict()


class _Calls:
    """Counts calls of a kernel wrapper's forward (its plain version here)."""

    def __init__(self, monkeypatch, module, name):
        self.n, inner = 0, getattr(module, name)

        def counted(*a, **kw):
            self.n += 1
            return inner(*a, **kw)

        monkeypatch.setattr(module, name, counted)


def _port_step(state, x, **remat):
    """One forward on batch statistics and the backward of a fixed linear
    function of the log-probs: (weight gradients, running statistics)."""
    port = SCConformer(ConformerConfig(compute_dtype="float32", **TINY, **KERNELS, **remat))
    port.load_state_dict(state)
    lp = port(torch.from_numpy(x), torch.from_numpy(LENGTHS), use_running_average=False)
    w = torch.from_numpy(np.random.default_rng(5).standard_normal(lp["final_posteriors"].shape)
                         .astype(np.float32))
    (lp["final_posteriors"] * w).sum().backward()
    return ({n: p.grad for n, p in port.named_parameters()},
            {n: b for n, b in port.named_buffers()})


@pytest.mark.parametrize("remat,extra_fwd", [
    (dict(checkpoint_every_n_layers=1), (3, 0)),
    (dict(checkpoint_every_n_layers=2), (2, 0)),
    (dict(remat_subsampling=True), (0, 1)),
], ids=["every-1", "every-2", "subsampling"])
def test_remat_gives_the_gradients_and_statistics_of_no_remat(start, monkeypatch, remat,
                                                               extra_fwd):
    x = _inputs()
    grads, stats = _port_step(start, x)
    attn, sub = _Calls(monkeypatch, A, "flash_attention_fwd"), _Calls(monkeypatch, S,
                                                                      "fused_subsample_fwd")
    remat_grads, remat_stats = _port_step(start, x, **remat)
    assert (attn.n, sub.n) == (TINY["n_layers"] + extra_fwd[0], 1 + extra_fwd[1])
    for n, g in grads.items():
        assert torch.equal(remat_grads[n], g), n
    for n, b in stats.items():
        assert torch.equal(remat_stats[n], b), n
        assert not torch.equal(b, start[n]), n  # the statistics did move


def test_remat_gradients_and_statistics_match_jax_remat_model():
    """At one layer without self-conditioning (the JAX gradient's compile
    is this file's cost)."""
    options = dict(n_layers=1, self_conditioning=False, checkpoint_every_n_layers=1,
                   remat_subsampling=True)
    cfg = ConformerConfig(compute_dtype="float32", **{**TINY, **options}, attention_impl="xla")
    port = init_conformer(cfg, seed=0)
    variables = jax.tree.map(jnp.asarray, variables_to_jax(port.state_dict()))
    model = JaxConformer(JaxConfig(compute_dtype=jnp.float32, **{**TINY, **options},
                                   attention_impl="xla"))
    x = _inputs()
    w = np.random.default_rng(5).standard_normal((2, 32, 31)).astype(np.float32)

    def loss(params):
        out, mutated = model.apply({**variables, "params": params}, jnp.asarray(x),
                                   length=jnp.asarray(LENGTHS), use_running_average=False,
                                   mutable=["batch_stats"])
        return jnp.sum(out["final_posteriors"] * w), mutated

    grad = jax.jit(jax.grad(loss, has_aux=True)).lower(variables["params"]).compile()
    jgrads, mutated = grad(variables["params"])
    want = params_from_jax({"params": jax.tree.map(np.asarray, jgrads),
                            "batch_stats": jax.tree.map(np.asarray, mutated["batch_stats"])})
    lp = port(torch.from_numpy(x), torch.from_numpy(LENGTHS), use_running_average=False)
    (lp["final_posteriors"] * torch.from_numpy(w)).sum().backward()
    scale = max(float(want[n].abs().max()) for n, _ in port.named_parameters())
    for n, p in port.named_parameters():
        torch.testing.assert_close(p.grad, want[n], rtol=0, atol=1e-5 * scale, msg=n)
    for n, b in port.named_buffers():
        torch.testing.assert_close(b, want[n], rtol=0, atol=1e-6, msg=n)


def _counting(monkeypatch):
    calls = {}
    for module, names in ((A, ("flash_attention_fwd", "flash_attention_bwd")),
                          (S, ("fused_subsample_fwd", "fused_subsample_bwd"))):
        for name in names:
            inner = getattr(module, name)

            def counted(*a, _inner=inner, _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _inner(*a, **kw)

            monkeypatch.setattr(module, name, counted)
    return calls


def test_attention_under_vmap_is_the_per_record_loop_in_one_call(monkeypatch):
    g = torch.Generator().manual_seed(0)
    R, B, T, H, D = 3, 2, 40, 2, 16
    q, k, v = (torch.randn(R, B, T, H, D, generator=g, requires_grad=True) for _ in range(3))
    mask = torch.arange(T)[None, None] < torch.tensor([[40, 23], [7, 40], [40, 1]])[..., None]
    dout = torch.randn(R, B, T, H, D, generator=g)
    calls = _counting(monkeypatch)
    out = torch.func.vmap(A.flash_attention)(q, k, v, mask)
    out.backward(dout)
    assert calls == {"flash_attention_fwd": 1, "flash_attention_bwd": 1}
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    loop = torch.stack([A.flash_attention(q[r], k[r], v[r], mask[r]) for r in range(R)])
    loop.backward(dout)
    assert calls == {"flash_attention_fwd": 1 + R, "flash_attention_bwd": 1 + R}
    assert torch.equal(out, loop)
    for got, t in zip(grads, (q, k, v)):
        assert torch.equal(got, t.grad)


@pytest.mark.parametrize("per_record", [True, False], ids=["per-record", "shared"])
def test_subsampling_under_vmap_is_the_per_record_loop(monkeypatch, per_record):
    g = torch.Generator().manual_seed(1)
    R, C = 3, 8
    x = torch.randn(R, 2, 48, 16, generator=g, requires_grad=True)
    shapes = [(9, C), (C,), (9, C), (C,), (C, C), (C,), (9, C), (C,), (C, C), (C,)]
    lead = (R,) if per_record else ()
    ws = [(0.3 * torch.randn(lead + s, generator=g)).requires_grad_(True) for s in shapes]
    calls = _counting(monkeypatch)
    in_dims = (0,) + ((0 if per_record else None),) * len(ws)
    out = torch.func.vmap(S.fused_subsample, in_dims=in_dims)(x, *ws)
    gout = torch.randn(out.shape, generator=g)
    out.backward(gout)
    n = R if per_record else 1
    assert calls == {"fused_subsample_fwd": n, "fused_subsample_bwd": n}
    grads = [t.grad.clone() for t in [x] + ws]
    for t in [x] + ws:
        t.grad = None
    loop = torch.stack([S.fused_subsample(x[r], *[w[r] if per_record else w for w in ws])
                        for r in range(R)])
    loop.backward(gout)
    assert torch.equal(out, loop)
    assert torch.equal(grads[0], x.grad)
    for got, t in zip(grads[1:], ws):
        if per_record:
            assert torch.equal(got, t.grad)
        else:
            torch.testing.assert_close(got, t.grad, rtol=0, atol=1e-5 * float(t.grad.abs().max()))


def test_replace_with_frame_repeats_one_input_frame_per_item():
    g = torch.Generator().manual_seed(0)
    spec = torch.randn(3, 8, 50, generator=g)
    out = replace_with_frame(spec, torch.Generator().manual_seed(4))
    assert out.shape == spec.shape
    for b in range(3):
        hits = [t for t in range(50) if torch.equal(spec[b, :, t], out[b, :, 0])]
        assert len(hits) == 1
        assert torch.equal(out[b], spec[b, :, hits[0] : hits[0] + 1].expand(8, 50))
    again = replace_with_frame(spec, torch.Generator().manual_seed(4))
    assert torch.equal(again, out)


def test_make_featurizer_matches_jax():
    audio = np.random.default_rng(0).standard_normal(16000 * 3).astype(np.float32)
    want = np.asarray(jax_make_featurizer()(audio))
    got = make_featurizer(device="cpu")(audio)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
