"""The port's fused subsampling (plain version and its autograd.Function on
CPU tensors) against the JAX package's ``fused_subsample`` running its real
Pallas kernels in interpret mode, and the port's ``DWStridingSubsampling``
against the JAX module.  The Hopper kernels themselves are held against the
plain version on the card by tests/test_torch_subsample_gpu.py and
chip_smoke.py.

Inputs and weights come from numpy seeds.  Tolerances (fp32), the bars of
tests/test_subsample_kernel.py: forward 2e-5; the gradients of all 11 inputs
2e-4.  Module level: 2e-5.  In bf16 the plain version, which rounds where the
TPU kernel rounds, is held at 4 bf16 ulps of max |JAX|: the TPU kernel also
rounds its depthwise sums tap by tap, and XLA:CPU keeps excess precision
inside its ops; over 12 shapes and seeds (C 16 and 32, T 256 to 520) the two
differ by 1 to 3 ulps of max, in 69-76 % of elements, so that share is not
held.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamic_asr_eval_tpu.kernels.subsample import fused_subsample as jax_fused_subsample
from dynamic_asr_eval_tpu.models.conformer import ConformerConfig as JaxConfig
from dynamic_asr_eval_tpu.models.conformer import DWStridingSubsampling as JaxSubsampling
from dynamic_asr_eval_tpu_torch.kernels import subsample as S
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, SCConformer, params_from_jax
from dynamic_asr_eval_tpu_torch.models.conformer import DWStridingSubsampling

torch.set_num_threads(1)

C, FEAT = 16, 16
SHAPES = {"k9": (9, C), "dw1": (9, C), "dw2": (9, C), "pw1": (C, C), "pw2": (C, C)}


def _weights(seed):
    rng = np.random.default_rng(seed)
    out = []
    for name in S.WEIGHT_NAMES:
        shape = SHAPES.get(name, (C,))
        scale = 1 / 3 if name in ("k9", "dw1", "dw2") else (C ** -0.5 if name.startswith("pw") else 0.1)
        out.append((rng.standard_normal(shape) * scale).astype(np.float32))
    return out


def _x(B, T, seed):
    return np.random.default_rng(seed).standard_normal((B, T, FEAT)).astype(np.float32)


@pytest.mark.parametrize("T", [512, 520, 700, 997])
def test_forward_matches_the_pallas_kernel(T):
    x, ws = _x(2, T, T), _weights(T)
    ref = np.asarray(jax_fused_subsample(jnp.asarray(x), *map(jnp.asarray, ws), act_name="silu",
                                         interpret=True))
    got = S.fused_subsample(torch.from_numpy(x), *map(torch.from_numpy, ws)).numpy()
    assert got.shape == ref.shape == (2, -(-T // 8), FEAT // 8, C)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def gradients_at_700():
    x, ws = _x(1, 700, 3), _weights(3)
    wave = np.cos(np.arange(1 * 88 * 2 * C, dtype=np.float32)).reshape(1, 88, 2, C)

    def loss(x, *ps):
        return jnp.sum(jax_fused_subsample(x, *ps, act_name="silu", interpret=True) * wave)

    ref = jax.grad(loss, argnums=tuple(range(11)))(jnp.asarray(x), *map(jnp.asarray, ws))
    inputs = [torch.tensor(a, requires_grad=True) for a in [x] + ws]
    out = S.fused_subsample(*inputs)
    got = torch.autograd.grad((out * torch.from_numpy(wave)).sum(), inputs)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


@pytest.mark.parametrize("i,name", list(enumerate(("x",) + S.WEIGHT_NAMES)))
def test_gradients_match_the_pallas_kernel(gradients_at_700, i, name):
    ref, got = gradients_at_700
    assert got[i].dtype == np.float32
    np.testing.assert_allclose(got[i], ref[i], rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_path_launches_no_kernel(dtype):
    S.reset_counters()
    x = torch.tensor(_x(1, 64, 0)).to(dtype).requires_grad_(True)
    ws = [torch.tensor(w, requires_grad=True) for w in _weights(0)]
    S.fused_subsample(x, *ws).float().sum().backward()
    assert (S.fwd_launches, S.bwd_launches) == (0, 0)
    assert all(counts == [0, 0] for counts in S.route_launches.values())


def test_routes_send_each_dtype_to_its_source():
    assert S.ROUTES == {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}
    assert {r: lib.source.name for r, lib in S.LIBRARIES.items()} == {
        "tensor_core": "fused_subsample_bf16.cu", "cuda_core": "fused_subsample.cu"}
    assert set(S.route_launches) == set(S.ROUTES.values())
    for lib in S.LIBRARIES.values():
        assert lib.source.exists()


def test_both_sources_export_the_same_entry_points():
    """One binding serves both routes: the same three C entry points."""
    import re

    names = {}
    for route, lib in S.LIBRARIES.items():
        text = lib.source.read_text()
        names[route] = sorted(re.findall(r'extern "C" [\w\s*]+?(dae_fused_subsample_\w+)\(', text))
    assert names["tensor_core"] == names["cuda_core"] == [
        "dae_fused_subsample_bwd", "dae_fused_subsample_fwd", "dae_fused_subsample_workspace"]


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("T", [256, 300])
def test_bf16_plain_version_matches_the_pallas_kernel(T):
    """The bf16 route's reference: the plain version on bf16 x against JAX's
    Pallas kernel in interpret mode on the same bf16 x, within 4 bf16 ulps of
    max |JAX| (see the module docstring)."""
    x, ws = _x(2, T, 40 + T), _weights(40 + T)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jax_fused_subsample(xb, *map(jnp.asarray, ws), act_name="silu",
                                         interpret=True).astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).bfloat16()
    got = S.fused_subsample(xt, *map(torch.from_numpy, ws))
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= 4 * _bf16_ulp(np.abs(ref).max()), err


@pytest.mark.parametrize("bad", ["feat", "dtype", "shape", "bias"])
def test_bf16_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(1, 32, FEAT, dtype=torch.bfloat16)
    ws = [torch.zeros(SHAPES.get(n, (C,))) for n in S.WEIGHT_NAMES]
    if bad == "feat":
        x = torch.zeros(1, 32, 20, dtype=torch.bfloat16)
    elif bad == "dtype":
        x = x.to(torch.float64)
    elif bad == "shape":
        ws[8] = torch.zeros(C + 1, C)
    else:
        ws[9] = torch.zeros(C - 1)
    with pytest.raises((TypeError, ValueError)):
        S.fused_subsample(x, *ws)


def test_bf16_wrapper_takes_channels_that_are_not_a_multiple_of_16():
    """C 40, as the GPU tests run it: the kernels pad channels in their
    tiles, so the wrapper does not refuse it."""
    c = 40
    rng = np.random.default_rng(5)
    shapes = {"k9": (9, c), "dw1": (9, c), "dw2": (9, c), "pw1": (c, c), "pw2": (c, c)}
    ws = [torch.from_numpy(rng.standard_normal(shapes.get(n, (c,))).astype(np.float32) * 0.2)
          for n in S.WEIGHT_NAMES]
    x = torch.from_numpy(rng.standard_normal((2, 37, FEAT)).astype(np.float32)).bfloat16()
    out = S.fused_subsample(x, *ws)
    assert out.shape == (2, 5, FEAT // 8, c) and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()


def test_input_gradient_is_skipped_when_not_asked_for():
    ws = [torch.tensor(w, requires_grad=True) for w in _weights(1)]
    x = torch.from_numpy(_x(1, 40, 1))
    S.fused_subsample(x, *ws).sum().backward()
    assert all(w.grad is not None for w in ws) and x.grad is None


@pytest.mark.parametrize("bad", ["feat", "dtype", "device", "shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(1, 32, FEAT)
    ws = [torch.zeros(SHAPES.get(n, (C,))) for n in S.WEIGHT_NAMES]
    if bad == "feat":
        x = torch.zeros(1, 32, 12)
    elif bad == "dtype":
        x = x.half()
    elif bad == "device":
        ws[4] = ws[4].to("meta")
    else:
        ws[4] = torch.zeros(C, C + 1)
    with pytest.raises((TypeError, ValueError)):
        S.fused_subsample(x, *ws)


# ---------------------------------------------------------------------------
# module level: DWStridingSubsampling with subsampling_impl="pallas"
# ---------------------------------------------------------------------------


def _cfg(impl, factor=8, feat=FEAT, act="silu"):
    return dict(feat_in=feat, n_layers=1, d_model=24, n_heads=1, head_dim=8, vocab_size=11,
                subsampling_factor=factor, subsampling_conv_channels=C, conv_kernel_size=5,
                subsampling_impl=impl, subsampling_act=act)


def _modules(impl, factor=8, feat=FEAT, act="silu", T=256):
    """The JAX module and the port's on the same weights, with the port's
    "conv" module beside them."""
    jcfg = JaxConfig(compute_dtype=jnp.float32, **_cfg(impl, factor, feat, act))
    jmod = JaxSubsampling(jcfg)
    x = np.zeros((1, T, feat), np.float32)
    variables = jmod.init(jax.random.PRNGKey(4), jnp.asarray(x))
    state = params_from_jax({"subsampling": jax.tree.map(np.asarray, variables["params"])})
    ports = {}
    for which in (impl, "conv"):
        port = DWStridingSubsampling(ConformerConfig(compute_dtype="float32",
                                                     **_cfg(which, factor, feat, act)))
        port.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()})
        ports[which] = port
    return jmod, variables, ports


def _ragged(T, n, feat=FEAT, seed=6):
    """x [1, T, feat] zero beyond frame n, as the conformer hands it over."""
    x = np.random.default_rng(seed).standard_normal((1, T, feat)).astype(np.float32)
    x[:, n:] = 0.0
    return x


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_pallas_module_keeps_the_unmasked_semantics_on_a_ragged_window(act):
    """Length 188 in a 256-frame window: the port's "pallas" module gives the
    JAX "pallas" module's output, and differs from the masked "conv" path on
    valid frames."""
    jmod, variables, ports = _modules("pallas", act=act)
    x, n = _ragged(256, 188), 188
    length = np.array([n])
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), length=jnp.asarray(length)))
    port = ports["pallas"]
    assert port.uses_fused_kernel(FEAT)
    got = port(torch.from_numpy(x), torch.from_numpy(length)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    conv = ports["conv"](torch.from_numpy(x), torch.from_numpy(length)).detach().numpy()
    valid = -(-n // 8)
    assert np.abs(got[:, :valid] - conv[:, :valid]).max() > 1e-2


@pytest.mark.parametrize("factor,feat", [(4, FEAT), (8, 12)])
def test_pallas_module_takes_the_conv_path_where_jax_does(factor, feat):
    jmod, variables, ports = _modules("pallas", factor, feat)
    x, n = _ragged(256, 173, feat), 173
    length = np.array([n])
    port = ports["pallas"]
    assert not port.uses_fused_kernel(feat)
    got = port(torch.from_numpy(x), torch.from_numpy(length)).detach()
    conv = ports["conv"](torch.from_numpy(x), torch.from_numpy(length)).detach()
    assert torch.equal(got, conv)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), length=jnp.asarray(length)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5)


def test_conv_module_gelu_matches_jax():
    """``subsampling_act="gelu"`` is JAX's tanh approximation on both paths."""
    jmod, variables, ports = _modules("conv", act="gelu")
    x, n = _ragged(256, 200), 200
    length = np.array([n])
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), length=jnp.asarray(length)))
    got = ports["conv"](torch.from_numpy(x), torch.from_numpy(length)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_pallas_and_conv_models_have_the_same_state_dict_keys():
    kw = dict(feat_in=32, n_layers=1, d_model=32, n_heads=2, head_dim=16, vocab_size=10,
              subsampling_conv_channels=8, compute_dtype="float32")
    a = SCConformer(ConformerConfig(subsampling_impl="pallas", **kw)).state_dict()
    b = SCConformer(ConformerConfig(subsampling_impl="conv", **kw)).state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape for k in a)


def test_module_gradients_reach_the_conv_parameters():
    _, _, ports = _modules("pallas")
    port = ports["pallas"]
    x = torch.from_numpy(_ragged(256, 256))
    port(x, torch.tensor([256])).square().sum().backward()
    conv = ports["conv"]
    conv(x, torch.tensor([256])).square().sum().backward()
    for (name, p), (_, q) in zip(port.named_parameters(), conv.named_parameters()):
        np.testing.assert_allclose(p.grad.numpy(), q.grad.numpy(), rtol=0,
                                   atol=2e-5 * max(1.0, q.grad.abs().max().item()), err_msg=name)

