"""The port's soft-DTW (plain versions, and its autograd.Function on CPU
tensors) against the JAX package's ``kernels/softdtw.py``: values and
gradients of ``soft_dtw``, the full R of the Pallas kernel
``_softdtw_pallas_fwd`` in TPU interpret mode, ``SoftDTW(normalize=True)`` and
``pairwise_sq_dist``.  The Hopper kernels are held against the plain versions
on the card by tests/test_torch_softdtw_gpu.py and chip_smoke.py.

Inputs come from numpy seeds; everything is f32.  Tolerances: values and R
1e-5 relative (the same recursion in the same order); gradients 1e-4 of
their max-abs (exp of differences of R).  With a band JAX's gradient can hold
NaNs (INF = 1e10 in f32: at a band edge a difference of two INF-sized values
is a multiple of 1024, its exp overflows, and 0 · inf is NaN); the port clamps
each weight's exponent at 0, its exact bound, so it is finite there and agrees
wherever JAX is.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from dynamic_asr_eval_tpu.kernels import softdtw as J
from dynamic_asr_eval_tpu_torch.kernels import softdtw as S

torch.set_num_threads(1)


def _D(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 2, size=(2,) + shape).astype(np.float32)


@pytest.mark.parametrize("bandwidth", [0, 1])
@pytest.mark.parametrize("gamma", [0.01, 0.5, 1.0])
@pytest.mark.parametrize("shape", [(4, 4), (5, 8), (8, 5)])
def test_values_and_gradients_match_jax(shape, gamma, bandwidth):
    D = _D(shape)
    g = np.array([1.0, -0.5], np.float32)
    ref, vjp = jax.vjp(lambda d: J.soft_dtw(d, gamma, bandwidth), jnp.asarray(D))
    (ref_grad,) = vjp(jnp.asarray(g))
    Dt = torch.tensor(D, requires_grad=True)
    out = S.soft_dtw(Dt, gamma, bandwidth)
    (grad,) = torch.autograd.grad(out, Dt, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5)
    ref_grad, grad = np.asarray(ref_grad), grad.numpy()
    finite = np.isfinite(ref_grad)
    assert np.isfinite(grad).all()
    assert finite.any() and (bandwidth > 0 or finite.all())
    np.testing.assert_allclose(grad[finite], ref_grad[finite], rtol=0,
                               atol=1e-4 * np.abs(ref_grad[finite]).max())


def test_full_R_matches_the_pallas_kernel():
    D = _D((8, 8), seed=8)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(J._softdtw_pallas_fwd(jnp.asarray(D), 1.0))
    got = S.forward_R_reference(torch.from_numpy(D), 1.0).numpy()
    assert got.shape == (2, 10, 10)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("shape", [(6, 9), (9, 6)])
def test_full_R_and_E_match_the_scans(shape):
    D = _D(shape, seed=2)
    ref_R = np.asarray(jax.vmap(lambda d: J._forward_R(d, 0.5))(jnp.asarray(D)))
    ref_E = np.asarray(jax.vmap(lambda d, r: J._backward_E(d, r, 0.5))(jnp.asarray(D),
                                                                       jnp.asarray(ref_R)))
    R = S.forward_R_reference(torch.from_numpy(D), 0.5)
    E = S.backward_E_reference(torch.from_numpy(D), R, 0.5)
    np.testing.assert_allclose(R.numpy(), ref_R, rtol=1e-5)
    np.testing.assert_allclose(E.numpy(), ref_E, rtol=0, atol=1e-4 * np.abs(ref_E).max())


@pytest.mark.parametrize("normalize", [False, True])
def test_module_matches_jax(normalize):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 3)).astype(np.float32)
    y = rng.standard_normal((2, 7, 3)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: J.SoftDTW(0.5, normalize)(a, jnp.asarray(y)), jnp.asarray(x))
    (ref_grad,) = vjp(jnp.ones(2, jnp.float32))
    xt = torch.tensor(x, requires_grad=True)
    out = S.SoftDTW(0.5, normalize)(xt, torch.from_numpy(y))
    (grad,) = torch.autograd.grad(out.sum(), xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(ref_grad)).max())


def test_normalized_self_distance_is_zero():
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 8, 4)).astype(np.float32))
    assert abs(S.SoftDTW(1.0, normalize=True)(x, x).item()) < 1e-3


def test_pairwise_sq_dist_matches_jax_and_numpy():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 3)).astype(np.float32)
    y = rng.standard_normal((2, 6, 3)).astype(np.float32)
    got = S.pairwise_sq_dist(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, np.asarray(J.pairwise_sq_dist(jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-5, atol=1e-5)
    want = ((x[:, :, None, :] - y[:, None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_cpu_path_launches_no_kernel_even_with_use_pallas():
    S.reset_counters()
    D = torch.tensor(_D((5, 5)), requires_grad=True)
    S.soft_dtw(D, 1.0, 0, use_pallas=True).sum().backward()
    assert (S.fwd_launches, S.bwd_launches) == (0, 0)
    assert torch.isfinite(D.grad).all()


@pytest.mark.parametrize("bad", ["dtype", "shape", "gamma"])
def test_soft_dtw_rejects_what_the_kernel_does_not_take(bad):
    D, gamma = torch.zeros(1, 4, 4), 1.0
    if bad == "dtype":
        D = D.half()
    elif bad == "shape":
        D = torch.zeros(4, 4)
    else:
        gamma = 0.0
    with pytest.raises((TypeError, ValueError)):
        S.soft_dtw(D, gamma, 0, use_pallas=True)


def test_benchmark_runs_on_the_cpu_when_asked():
    out = S.benchmark(B=1, N=8, M=9, D=4, iters=1, device="cpu")
    ref = J.benchmark(B=1, N=8, M=9, D=4, iters=1)
    assert out["seconds_per_iter"] > 0
    np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-5)
